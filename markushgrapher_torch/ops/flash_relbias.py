"""Encoder attention with the UDOP relative bias computed inside the kernel
(`csrc/flash_relbias.cu`), the in-kernel-bias serving route: no
[B, H, L, L] bias slab is built.

Replaces `markushgrapher_tpu/ops/flash_relbias.py:flash_attention_relbias`
(forward only, T5 convention: no 1/sqrt(d)). Each score adds the 1d bucket
of the key - query distance and the horizontal / vertical buckets of the
scaled bbox-centre distances, looked up in the three [nb, H] tables, and
masked keys score -1e30; softmax in float32. The kernel's buckets come from
the same CPU-built lookup tables as the int8 slab builder's, so they are
those of `relbias.relative_position_bucket`.

The kernel is the BiasRel policy of the Hopper forward core
(`csrc/flash_fwd_sm90.cuh`): the bias is computed at the accumulator's
fragment positions, bit-exact against `relbias.centre_position_bias`
(`kernel_bias_terms` returns the kernel's bias terms for the tests).

A CPU tensor goes to the plain version; a CUDA tensor goes to the kernel.
"""

from __future__ import annotations

import functools

import torch

from markushgrapher_torch.ops import _build
from markushgrapher_torch.ops.relbias import bucket_lut, centre_position_bias

NEG_INF = -1e30


def plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          hx: torch.Tensor, vy: torch.Tensor, mask: torch.Tensor,
          bias_1d: torch.Tensor, bias_h: torch.Tensor, bias_v: torch.Tensor,
          max_dist_1d: int = 128, max_dist_2d: int = 100,
          scaling_2d: int = 100) -> torch.Tensor:
    """q, k, v [B, L, H, D]; hx, vy [B, L] float32 bbox centres; mask
    [B, L]; the three tables [nb, H]. The bias of
    `relbias.centre_position_bias` with masked keys at -1e30, dense float32
    scores and softmax; returns [B, L, H, D] in q.dtype."""
    length, nb = q.shape[1], bias_1d.shape[0]
    bias = centre_position_bias(
        bias_1d.to(torch.float32), bias_h.to(torch.float32),
        bias_v.to(torch.float32), hx.to(torch.float32),
        vy.to(torch.float32), length, nb, max_dist_1d, scaling_2d,
        max_dist_2d)
    bias = torch.where(mask[:, None, None, :] > 0, bias, NEG_INF)
    qf, kf, vf = (t.to(torch.float32).transpose(1, 2) for t in (q, k, v))
    p = torch.softmax(torch.matmul(qf, kf.transpose(-1, -2)) + bias, dim=-1)
    return torch.matmul(p, vf).transpose(1, 2).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _luts(nb: int, max_dist_1d: int, max_dist_2d: int, device: str):
    """The two bucket lookup tables on `device`, built once (each encoder
    layer's call reads the same ones)."""
    return (bucket_lut(nb, max_dist_1d, device),
            bucket_lut(nb, max_dist_2d, device))


def _kernel_args(q, k, v, hx, vy, mask, bias_1d, bias_h, bias_v,
                 max_dist_1d, max_dist_2d):
    """The kernel's operands after the wrapper's checks (raises on shapes
    and types it does not take): q, k, v, hx, vy, mask, tables, lut1,
    lut2."""
    batch, length, heads, d = q.shape
    if d != 64:
        raise ValueError(f"flash_relbias kernel is built for head dim 64, "
                         f"got {d}")
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_relbias kernel takes bf16 q, k, v")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("flash_relbias kernel needs self-attention shapes")
    for name, t in (("hx", hx), ("vy", vy), ("mask", mask)):
        if tuple(t.shape) != (batch, length):
            raise ValueError(f"{name} {tuple(t.shape)} != {(batch, length)}")
    nb = bias_1d.shape[0]
    shapes = [tuple(t.shape) for t in (bias_1d, bias_h, bias_v)]
    if not 0 < nb <= 32 or any(sh != (nb, heads) for sh in shapes):
        raise ValueError(f"tables must be [nb <= 32, {heads}], got {shapes}")
    q, k, v = (t.contiguous() for t in (q, k, v))
    hx, vy = (t.to(torch.float32).contiguous() for t in (hx, vy))
    mask = mask.to(torch.int32).contiguous()
    tables = torch.stack([bias_1d, bias_h, bias_v]).to(
        torch.float32).contiguous()                               # [3, nb, H]
    lut1, lut2 = _luts(nb, max_dist_1d, max_dist_2d, str(q.device))
    return q, k, v, hx, vy, mask, tables, lut1, lut2


def _launch(entry: str, args, max_dist_1d: int, max_dist_2d: int,
            scaling_2d: int, out: torch.Tensor, *extra: torch.Tensor):
    """Launch C entry `entry` on `_kernel_args`' operands into `out` (and
    the `extra` buffers the entry takes after it); raises on its error."""
    q = args[0]
    batch, length, heads, d = q.shape
    nb = args[6].shape[1]
    _build.require_cuda("flash_relbias", *args, out, *extra)
    rc = getattr(_build.lib(), entry)(
        *(t.data_ptr() for t in args), batch, length, heads, d, nb,
        max_dist_1d, max_dist_2d, float(scaling_2d), out.data_ptr(),
        *(t.data_ptr() for t in extra), _build.stream(out))
    _build.check(rc, "flash_relbias")


def flash_attention_relbias(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, hx: torch.Tensor,
                            vy: torch.Tensor, mask: torch.Tensor,
                            bias_1d: torch.Tensor, bias_h: torch.Tensor,
                            bias_v: torch.Tensor, max_dist_1d: int = 128,
                            max_dist_2d: int = 100,
                            scaling_2d: int = 100) -> torch.Tensor:
    """Same contract as `plain`. The kernel takes bf16 q/k/v [B, L, H, 64]
    (self-attention shapes) and at most 32 buckets, and returns bf16. The
    reference's `block_q` / `block_k` tile its TPU grid; this kernel needs
    no tile multiple, so it has neither."""
    if q.device.type == "cpu":
        return plain(q, k, v, hx, vy, mask, bias_1d, bias_h, bias_v,
                     max_dist_1d, max_dist_2d, scaling_2d)
    args = _kernel_args(q, k, v, hx, vy, mask, bias_1d, bias_h, bias_v,
                        max_dist_1d, max_dist_2d)
    out = torch.empty_like(args[0])
    _launch("mg_flash_relbias", args, max_dist_1d, max_dist_2d, scaling_2d,
            out)
    _build.LAUNCHES["flash_relbias"] += 1
    return out


def kernel_bias_terms(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      hx: torch.Tensor, vy: torch.Tensor, mask: torch.Tensor,
                      bias_1d: torch.Tensor, bias_h: torch.Tensor,
                      bias_v: torch.Tensor, max_dist_1d: int = 128,
                      max_dist_2d: int = 100, scaling_2d: int = 100):
    """For tests, on no serving path: the kernel's instance that also
    stores each score's bias term (mask included, the value QK^T is added
    to) as float32 [B, H, L, L]. Returns (out, terms); CUDA tensors only.
    `torch.where(mask > 0, centre_position_bias(...), -1e30)` is the same
    bit for bit."""
    args = _kernel_args(q, k, v, hx, vy, mask, bias_1d, bias_h, bias_v,
                        max_dist_1d, max_dist_2d)
    batch, length, heads, _ = args[0].shape
    out = torch.empty_like(args[0])
    terms = torch.empty((batch, heads, length, length), dtype=torch.float32,
                        device=out.device)
    _launch("mg_flash_relbias_scores", args, max_dist_1d, max_dist_2d,
            scaling_2d, out, terms)
    return out, terms
