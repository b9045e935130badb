"""Device-resident pixel preprocessing for the two-stage serving pipeline
(port of `markushgrapher_tpu.data.device_pixels`).

One uint8 copy of each page lives on the device; every model input derives
from it there, so a page crosses the host link once for both stages:

- OCR stage input: `ocr_from_uint8` (f32 / 255; the OCR vision tower expects
  [0, 1]).
- MarkushGrapher vtl input: `vtl_from_uint8` ((x - .5) / .5, exactly
  `data.encode.normalize_vtl_image` on the same resize).
- MolScribe Swin input: `ocsr_from_uint8`: a bilinear 512 -> 384 resize,
  then ImageNet normalisation. The host path LANCZOS-resizes the original
  image (`data.encode.normalize_ocsr_image`); serving from the 512 px copy
  trades that for zero extra transfer.

Layouts are the JAX package's: NHWC in, NHWC out. The resize is
`jax.image.resize(..., "bilinear")`, which antialiases when it downsamples
(a triangle filter widened by the scale factor, weights renormalised at the
edges); `F.interpolate(mode="bilinear", antialias=True)` computes the same
filter. They agree to float32 rounding (tests/test_torch_ocr.py holds the
512 -> 384 resize to 1e-5 absolute on [0, 1] pixels).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from markushgrapher_torch.data.encode import (OCSR_MEAN, OCSR_STD, VTL_MEAN,
                                              VTL_STD)


def ocr_from_uint8(pixels: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 3] uint8 -> f32 in [0, 1] (ChemicalOCR vision input)."""
    return pixels.to(torch.float32) / 255.0


def vtl_from_uint8(pixels: torch.Tensor, image_size: int) -> torch.Tensor:
    """[B, H, W, 3] uint8 -> UDOP vtl pixel_values ((x/255 - .5)/.5),
    resized when the OCR-stage resolution differs from `image_size`."""
    x = _maybe_resize(pixels.to(torch.float32) / 255.0, image_size)
    return (x - VTL_MEAN) / VTL_STD


def ocsr_from_uint8(pixels: torch.Tensor, image_size: int) -> torch.Tensor:
    """[B, H, W, 3] uint8 -> MolScribe Swin input (ImageNet-normalised)."""
    x = _maybe_resize(pixels.to(torch.float32) / 255.0, image_size)
    mean = torch.tensor(OCSR_MEAN, device=x.device)
    std = torch.tensor(OCSR_STD, device=x.device)
    return (x - mean) / std


def _maybe_resize(x: torch.Tensor, size: int) -> torch.Tensor:
    if x.shape[1] == size and x.shape[2] == size:
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size),
                      mode="bilinear", align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1).contiguous()
