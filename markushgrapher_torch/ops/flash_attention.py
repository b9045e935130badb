"""Encoder attention: over the int8 bias slab (serving, the CUDA kernel
`csrc/flash_i8.cu`) and over a float bias (`csrc/flash_bias.cu` forward,
`csrc/flash_bias_bwd.cu` backward; the trainable op `FlashAttentionBias`).

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


# -- float-bias flash attention: serving forward and the trainable op -------
#
# `csrc/flash_bias.cu` (forward) and `csrc/flash_bias_bwd.cu` (the dK/dV and
# the dQ/d(bias) kernels) replace the stock Pallas TPU flash attention that
# the reference trains with (`markushgrapher_tpu/models/t5.py:376-385`:
# forward, `_flash_attention_bwd_dkv`, `_flash_attention_bwd_dq`) and its
# forward-only float-bias kernel
# (`markushgrapher_tpu/ops/flash_attention.py:flash_attention_bias`). T5
# convention: scale 1. The bias is additive, [B or 1, H, L, L] in bf16 or
# float32, with the key mask already in it. The forward keeps the float32
# log-sum-exp per query row; the backward recomputes P = exp(s - lse) from q,
# k and the bias, and the dq kernel writes dS = P * (dP - di) as d(bias), in
# the bias dtype. di = sum(o * dO) over the head dim is computed here, as the
# stock wrapper does outside its kernels.


def _compute_dtype(q: torch.Tensor) -> torch.dtype:
    return torch.promote_types(q.dtype, torch.float32)


def _scores(q: torch.Tensor, k: torch.Tensor, bias: torch.Tensor,
            ct: torch.dtype) -> torch.Tensor:
    """[B, H, Q, K] = q k^T + bias in `ct` (q, k [B, L, H, D])."""
    qf, kf = (t.to(ct).transpose(1, 2) for t in (q, k))
    return torch.matmul(qf, kf.transpose(-1, -2)) + bias.to(ct)


def plain_bias(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """q, k, v [B, L, H, D]; bias [B or 1, H, L, L] additive, mask included.
    Float32 (float64 for float64 inputs) scores and softmax; returns
    [B, L, H, D] in q.dtype."""
    ct = _compute_dtype(q)
    with torch.autocast(q.device.type, enabled=False):
        p = torch.softmax(_scores(q, k, bias, ct), dim=-1)
        out = torch.matmul(p, v.to(ct).transpose(1, 2))
    return out.transpose(1, 2).to(q.dtype)


def plain_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: torch.Tensor):
    """Plain version of the forward kernel: (out [B, L, H, D] in q.dtype,
    lse [B, H, L] float32, or float64 for float64 inputs)."""
    ct = _compute_dtype(q)
    with torch.autocast(q.device.type, enabled=False):
        s = _scores(q, k, bias, ct)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        out = torch.matmul(p, v.to(ct).transpose(1, 2)) / l
    return out.transpose(1, 2).to(q.dtype), (m + torch.log(l))[..., 0]


def _probs_and_ds(q, k, v, bias, do, lse, di, ct):
    """P = exp(s - lse) and dS = P * (dP - di), both [B, H, Q, K] in ct."""
    p = torch.exp(_scores(q, k, bias, ct) - lse.to(ct)[..., None])
    dp = torch.matmul(do.to(ct).transpose(1, 2),
                      v.to(ct).transpose(1, 2).transpose(-1, -2))
    return p, p * (dp - di.to(ct)[..., None])


def plain_bwd_dkv(q, k, v, bias, do, lse, di):
    """Plain version of the dK/dV kernel: (dk, dv) [B, L, H, D] in k's and
    v's dtypes. lse and di are [B, H, L]."""
    ct = _compute_dtype(q)
    with torch.autocast(q.device.type, enabled=False):
        p, ds = _probs_and_ds(q, k, v, bias, do, lse, di, ct)
        dv = torch.matmul(p.transpose(-1, -2), do.to(ct).transpose(1, 2))
        dk = torch.matmul(ds.transpose(-1, -2), q.to(ct).transpose(1, 2))
    return dk.transpose(1, 2).to(k.dtype), dv.transpose(1, 2).to(v.dtype)


def plain_bwd_dq(q, k, v, bias, do, lse, di):
    """Plain version of the dQ / d(bias) kernel: (dq [B, L, H, D] in
    q.dtype, ds [B, H, L, L] in bias.dtype, over the full batch)."""
    ct = _compute_dtype(q)
    with torch.autocast(q.device.type, enabled=False):
        _, ds = _probs_and_ds(q, k, v, bias, do, lse, di, ct)
        dq = torch.matmul(ds, k.to(ct).transpose(1, 2))
    return dq.transpose(1, 2).to(q.dtype), ds.to(bias.dtype)


def _check_bias_args(name: str, q, k, v, bias) -> None:
    batch, length, heads, d = q.shape
    if d != 64:
        raise ValueError(f"{name} kernel is built for head dim 64, got {d}")
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name} kernel takes bf16 q, k, v")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name} kernel needs self-attention shapes")
    if bias.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name} kernel takes a bf16 or float32 bias")
    if bias.dim() != 4 or bias.shape[0] not in (1, batch) or \
            tuple(bias.shape[1:]) != (heads, length, length):
        raise ValueError(f"bias {tuple(bias.shape)} != "
                         f"{(batch, heads, length, length)} (batch may be 1)")


def flash_bias_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   bias: torch.Tensor):
    """(out, lse) as `plain_fwd`. The kernel takes bf16 q/k/v [B, L, H, 64]
    and a bf16 or float32 bias, returns bf16 out and float32 lse."""
    if q.device.type == "cpu":
        return plain_fwd(q, k, v, bias)
    _check_bias_args("flash_bias", q, k, v, bias)
    batch, length, heads, d = q.shape
    q, k, v, bias = (t.contiguous() for t in (q, k, v, bias))
    out = torch.empty_like(q)
    lse = torch.empty((batch, heads, length), dtype=torch.float32,
                      device=q.device)
    _build.require_cuda("flash_bias", q, k, v, bias, out, lse)
    rc = _build.lib().mg_flash_bias_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        int(bias.dtype == torch.float32), int(bias.shape[0] == batch),
        batch, length, heads, d, out.data_ptr(), lse.data_ptr(),
        _build.stream(out))
    _build.check(rc, "flash_bias")
    _build.LAUNCHES["flash_bias"] += 1
    return out, lse


def _bwd_args(name, q, k, v, bias, do, lse, di):
    _check_bias_args(name, q, k, v, bias)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"{name}: dO must match q ({tuple(do.shape)}, "
                         f"{do.dtype})")
    want = (q.shape[0], q.shape[2], q.shape[1])
    for t in (lse, di):
        if tuple(t.shape) != want or t.dtype != torch.float32:
            raise ValueError(f"{name}: lse / di must be float32 {want}")
    return tuple(t.contiguous() for t in (q, k, v, bias, do, lse, di))


def flash_bias_dkv(q, k, v, bias, do, lse, di):
    """(dk, dv) as `plain_bwd_dkv`; bf16 from the kernel."""
    if q.device.type == "cpu":
        return plain_bwd_dkv(q, k, v, bias, do, lse, di)
    q, k, v, bias, do, lse, di = _bwd_args("flash_bias_dkv", q, k, v, bias,
                                           do, lse, di)
    batch, length, heads, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _build.require_cuda("flash_bias_dkv", q, k, v, bias, do, lse, di, dk, dv)
    rc = _build.lib().mg_flash_bias_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        int(bias.dtype == torch.float32), int(bias.shape[0] == batch),
        do.data_ptr(), lse.data_ptr(), di.data_ptr(), batch, length, heads,
        d, dk.data_ptr(), dv.data_ptr(), _build.stream(dk))
    _build.check(rc, "flash_bias_dkv")
    _build.LAUNCHES["flash_bias_dkv"] += 1
    return dk, dv


def flash_bias_dq(q, k, v, bias, do, lse, di):
    """(dq, ds) as `plain_bwd_dq`: dq bf16, ds [B, H, L, L] in the bias
    dtype."""
    if q.device.type == "cpu":
        return plain_bwd_dq(q, k, v, bias, do, lse, di)
    q, k, v, bias, do, lse, di = _bwd_args("flash_bias_dq", q, k, v, bias,
                                           do, lse, di)
    batch, length, heads, d = q.shape
    dq = torch.empty_like(q)
    ds = torch.empty((batch, heads, length, length), dtype=bias.dtype,
                     device=q.device)
    _build.require_cuda("flash_bias_dq", q, k, v, bias, do, lse, di, dq, ds)
    rc = _build.lib().mg_flash_bias_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        int(bias.dtype == torch.float32), int(bias.shape[0] == batch),
        do.data_ptr(), lse.data_ptr(), di.data_ptr(), batch, length, heads,
        d, dq.data_ptr(), ds.data_ptr(), _build.stream(dq))
    _build.check(rc, "flash_bias_dq")
    _build.LAUNCHES["flash_bias_dq"] += 1
    return dq, ds


def flash_attention_bias(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: torch.Tensor) -> torch.Tensor:
    """Forward-only float-bias flash attention (serving): the contract of
    `plain_bias`, through the forward kernel on a CUDA tensor."""
    if q.device.type == "cpu":
        return plain_bias(q, k, v, bias)
    return flash_bias_fwd(q, k, v, bias)[0]


class FlashAttentionBias(torch.autograd.Function):
    """Trainable flash attention with an additive bias: out, and in backward
    dq, dk, dv and d(bias) (in the bias dtype; summed over the batch when
    the bias has batch 1). The forward saves the float32 log-sum-exp, not
    the [B, H, L, L] probabilities. On CPU tensors every step takes its
    kernel's plain version."""

    @staticmethod
    def forward(ctx, q, k, v, bias):
        out, lse = flash_bias_fwd(q, k, v, bias)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, out, lse = ctx.saved_tensors
        do = do.contiguous()
        ct = _compute_dtype(q)
        di = (out.to(ct) * do.to(ct)).sum(dim=-1).transpose(1, 2)
        di = di.contiguous()
        dk, dv = flash_bias_dkv(q, k, v, bias, do, lse, di)
        dq, ds = flash_bias_dq(q, k, v, bias, do, lse, di)
        if bias.shape[0] == 1 and q.shape[0] > 1:
            ds = ds.sum(dim=0, keepdim=True, dtype=ct).to(bias.dtype)
        return dq, dk, dv, ds


def flash_attention_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: torch.Tensor) -> torch.Tensor:
    """Differentiable `plain_bias` through `FlashAttentionBias`."""
    return FlashAttentionBias.apply(q, k, v, bias)
