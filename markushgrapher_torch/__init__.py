"""PyTorch + CUDA (Hopper) port of the MarkushGrapher serving path.

Mirrors `markushgrapher_tpu`'s module names so each counterpart is easy to
find; the JAX package stays the numerical reference. Host-side modules that
import no JAX (`markushgrapher_tpu.config`, `data.*`, `chem.*`,
`arguments`) are shared, not copied. This package imports `torch` and never
`jax` or `flax`.
"""
