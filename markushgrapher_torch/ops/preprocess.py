"""Image front end: uint8 pages -> normalised patch vectors. The CUDA kernel
`csrc/normalize_u8.cu`, its wrapper and plain version, and the pool /
patchify around it (port of `markushgrapher_tpu/ops/preprocess.py`).

The card receives uint8 pixels (a quarter of float32's bytes); the kernel
widens and normalises them, `(x / 255 - mean) / std`, and plain torch
reshapes pool and patchify, as the JAX module splits the work between its
Pallas kernel and XLA. A CPU tensor goes to the plain version; a CUDA
tensor goes to the kernel.

Both compute the normalisation in the float32 operations that XLA compiles
the JAX function to: x * f32(1/255) - mean rounded once (a fused
multiply-add), then times f32(1/std). So the kernel, the plain version and
the JAX function agree bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from markushgrapher_torch.ops import _build


def _constants(mean: float, std: float) -> Tuple[float, float, float]:
    """f32(1/255), f32(mean) and f32(1/std), each a float32 value."""
    one = np.float32(1)
    return (float(one / np.float32(255)), float(np.float32(mean)),
            float(one / np.float32(std)))


def plain_normalize_u8(images: torch.Tensor, mean: float = 0.5,
                       std: float = 0.5,
                       out_dtype: torch.dtype = torch.bfloat16
                       ) -> torch.Tensor:
    """Plain version of `normalize_u8`. x * r - mean is exact in float64
    (at most 32 significant bits), so rounding it to float32 rounds the
    fused multiply-add once."""
    r, m, s = _constants(mean, std)
    y = (images.to(torch.float64) * r - m).to(torch.float32)
    return (y * s).to(out_dtype)


def normalize_u8(images: torch.Tensor, mean: float = 0.5, std: float = 0.5,
                 out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """uint8 [B, H, W, C] (any shape) -> the same shape in out_dtype
    (float32 or bf16), `(x / 255 - mean) / std` computed in float32."""
    if images.dtype != torch.uint8:
        raise ValueError(f"normalize_u8: expected uint8, got {images.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"normalize_u8: out_dtype {out_dtype} is neither "
                         "float32 nor bfloat16")
    if images.device.type == "cpu":
        return plain_normalize_u8(images, mean, std, out_dtype)
    x = images.contiguous()
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    _build.require_cuda("normalize_u8", x, out)
    if x.numel() == 0:
        return out
    r, m, s = _constants(mean, std)
    rc = _build.lib().mg_normalize_u8(
        x.data_ptr(), x.numel(), r, m, s, int(out_dtype == torch.bfloat16),
        out.data_ptr(), _build.stream(out))
    _build.check(rc, "normalize_u8")
    _build.LAUNCHES["normalize_u8"] += 1
    return out


def _patchify(x: torch.Tensor, patch: int, pool: int,
              out_dtype: torch.dtype) -> torch.Tensor:
    """float32 [B, H, W, C] -> pooled [B, (H/pool/patch) * (W/pool/patch),
    patch * patch * C] patches in out_dtype. The pool mean sums the window
    in row-major order, then divides, as XLA reduces it."""
    b, h, w, c = x.shape
    oh, ow = h // pool, w // pool
    if pool > 1:
        win = x.reshape(b, oh, pool, ow, pool, c)
        total = win[:, :, 0, :, 0]
        for i in range(pool):
            for j in range(pool):
                if i or j:
                    total = total + win[:, :, i, :, j]
        x = total / float(pool * pool)
    p = patch
    x = x.reshape(b, oh // p, p, ow // p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (oh // p) * (ow // p), p * p * c).to(out_dtype)


def _check_patch(images: torch.Tensor, patch: int, pool: int) -> None:
    _, h, w, _ = images.shape
    if (h // pool) % patch or (w // pool) % patch:
        raise ValueError(f"output size {h // pool}x{w // pool} not "
                         f"divisible by {patch}")


def preprocess_patchify(images: torch.Tensor, patch: int = 16, pool: int = 1,
                        mean: float = 0.5, std: float = 0.5,
                        out_dtype: torch.dtype = torch.bfloat16
                        ) -> torch.Tensor:
    """uint8 [B, H, W, C] -> [B, (H/pool/patch) * (W/pool/patch),
    patch * patch * C] normalised patches: `normalize_u8` in float32, then
    the pool and the patchify in plain torch."""
    _check_patch(images, patch, pool)
    x = normalize_u8(images, mean=mean, std=std, out_dtype=torch.float32)
    return _patchify(x, patch, pool, out_dtype)


def preprocess_patchify_reference(images: torch.Tensor, patch: int = 16,
                                  pool: int = 1, mean: float = 0.5,
                                  std: float = 0.5,
                                  out_dtype: torch.dtype = torch.bfloat16
                                  ) -> torch.Tensor:
    """`preprocess_patchify` with the plain normalisation on any device."""
    _check_patch(images, patch, pool)
    x = plain_normalize_u8(images, mean, std, torch.float32)
    return _patchify(x, patch, pool, out_dtype)
