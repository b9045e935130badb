"""Encoder attention over the int8 bias slab: the CUDA kernel
`csrc/flash_i8.cu` and its wrapper.

Replaces `markushgrapher_tpu/ops/flash_attention.py:flash_attention_bias_i8`
(forward-only flash attention, T5 convention: no 1/sqrt(d)). Each bias entry
is `int8 * scale_h`, plus -1e30 on masked keys; softmax in float32. The
kernel is bound by CUDA-core float32 math in this first version (see the
source note in the .cu file).

A CPU tensor goes to the plain version; a CUDA tensor goes to the kernel.
"""

from __future__ import annotations

import torch

from markushgrapher_torch.ops import _build

NEG_INF = -1e30


def plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          bias_i8: torch.Tensor, scales: torch.Tensor,
          key_mask: torch.Tensor) -> torch.Tensor:
    """q, k, v [B, L, H, D]; bias_i8 [B, H, L, L]; scales [H]; key_mask
    [B, L]. Float32 scores and softmax; returns [B, L, H, D] in q.dtype."""
    qf, kf, vf = (t.to(torch.float32).transpose(1, 2) for t in (q, k, v))
    s = torch.matmul(qf, kf.transpose(-1, -2))                 # [B,H,Q,K]
    mask_add = torch.where(key_mask[:, None, None, :] > 0, 0.0, NEG_INF)
    s = s + (bias_i8.to(torch.float32) * scales.to(torch.float32)[
        None, :, None, None] + mask_add)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, vf).transpose(1, 2).to(q.dtype)


def flash_attention_bias_i8(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, bias_i8: torch.Tensor,
                            scales: torch.Tensor,
                            key_mask: torch.Tensor) -> torch.Tensor:
    """Same contract as `plain`. The kernel takes bf16 q/k/v with D = 64
    and returns bf16."""
    if q.device.type == "cpu":
        return plain(q, k, v, bias_i8, scales, key_mask)
    batch, length, heads, d = q.shape
    if d != 64:
        raise ValueError(f"flash_i8 kernel is built for head dim 64, got {d}")
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_i8 kernel takes bf16 q, k, v")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("flash_i8 kernel needs self-attention shapes")
    if bias_i8.shape != (batch, heads, length, length):
        raise ValueError(f"bias {tuple(bias_i8.shape)} != "
                         f"{(batch, heads, length, length)}")
    q, k, v, bias_i8 = (t.contiguous() for t in (q, k, v, bias_i8))
    sc = scales.to(torch.float32).contiguous()
    mask = key_mask.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    _build.require_cuda("flash_i8", q, k, v, bias_i8, sc, mask, out)
    rc = _build.lib().mg_flash_i8(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_i8.data_ptr(),
        sc.data_ptr(), mask.data_ptr(), batch, length, heads, d,
        out.data_ptr(), _build.stream(out))
    _build.check(rc, "flash_i8")
    _build.LAUNCHES["flash_i8"] += 1
    return out
