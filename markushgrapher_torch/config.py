"""Model configuration: the reference's dataclasses (`markushgrapher_tpu.config`,
which imports no JAX), re-exported so that callers of the port import only
`markushgrapher_torch`."""

from markushgrapher_tpu.config import (MarkushGrapherConfig, SwinConfig,
                                       VTLConfig)

__all__ = ["MarkushGrapherConfig", "SwinConfig", "VTLConfig"]
