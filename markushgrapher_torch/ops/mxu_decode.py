"""int4 decode attention: the CUDA kernel `csrc/decode_int4.cu`, its wrapper,
and the nibble packing of the K/V slabs and rings.

Replaces `markushgrapher_tpu/ops/mxu_decode.py:cross_decode_mxu_int4`
(separate K/V mode; the port keeps no combined k||v ring and needs none of
the TPU kernel's head_map / row_map / block_map options). Every decode-step
attention goes through it: cross over the packed encoder slab and self over
the ring, 2 calls per decoder layer. It is bound by reading the slab (see
the source note in the .cu file).

A CPU tensor goes to the plain version; a CUDA tensor goes to the kernel.
"""

from __future__ import annotations

import torch

from markushgrapher_torch.ops import _build


def pack_int4(vals8: torch.Tensor) -> torch.Tensor:
    """[..., K, HD] int8 in [-7, 7] -> [..., K, HD/2] packed int8.
    Column split: byte j holds element j in the low nibble and element
    j + HD/2 in the high nibble."""
    hd = vals8.shape[-1]
    lo = vals8[..., : hd // 2].to(torch.int32) & 15
    hi = vals8[..., hd // 2:].to(torch.int32) & 15
    return (lo | (hi << 4)).to(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_int4 -> float32 [..., K, HD] values in [-8, 7]."""
    x = packed.to(torch.int32)
    lo = x & 15
    hi = (x >> 4) & 15
    return torch.cat([(lo ^ 8) - 8, (hi ^ 8) - 8], dim=-1).to(torch.float32)


def plain(q: torch.Tensor, kq: torch.Tensor, ks: torch.Tensor,
          vq: torch.Tensor, vs: torch.Tensor,
          bias: torch.Tensor) -> torch.Tensor:
    """q [B, H, D]; kq / vq [B, K, HD/2] packed; ks / vs [B, H, K];
    bias [B or 1, 1 or H, K] f32. Returns [B, H, D] in q.dtype, with the
    TPU kernel's rounding points: q, p * vs and the output in bf16."""
    batch, kv_len, _ = kq.shape
    heads, d = q.shape[1], q.shape[2]
    k = unpack_int4(kq).reshape(batch, kv_len, heads, d)
    v = unpack_int4(vq).reshape(batch, kv_len, heads, d)
    qb = q.to(torch.bfloat16).to(torch.float32)
    s = torch.einsum("bhd,bkhd->bhk", qb, k) * ks.to(torch.float32)
    s = s + bias.to(torch.float32)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    den = p.sum(dim=-1, keepdim=True)
    pv = (p * vs.to(torch.float32)).to(torch.bfloat16).to(torch.float32)
    acc = torch.einsum("bhk,bkhd->bhd", pv, v)
    out = acc / den.clamp(min=1e-30)
    return out.to(torch.bfloat16).to(q.dtype)


def cross_decode_mxu_int4(q: torch.Tensor, kq: torch.Tensor,
                          ks: torch.Tensor, vq: torch.Tensor,
                          vs: torch.Tensor,
                          bias: torch.Tensor) -> torch.Tensor:
    """Same contract as `plain`; the kernel reads bf16 scales."""
    if q.device.type == "cpu":
        return plain(q, kq, ks, vq, vs, bias)
    batch, kv_len, half = kq.shape
    heads, d = q.shape[1], q.shape[2]
    if 2 * half != heads * d or vq.shape != kq.shape:
        raise ValueError(f"packed K/V {tuple(kq.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if ks.shape != (batch, heads, kv_len) or vs.shape != ks.shape:
        raise ValueError(f"scales {tuple(ks.shape)} != "
                         f"{(batch, heads, kv_len)}")
    if (bias.dim() != 3 or bias.shape[0] not in (1, batch)
            or bias.shape[1] not in (1, heads) or bias.shape[2] != kv_len):
        raise ValueError(f"bias {tuple(bias.shape)} does not broadcast to "
                         f"{(batch, heads, kv_len)}")
    if kq.dtype != torch.int8 or vq.dtype != torch.int8:
        raise ValueError("packed K/V must be int8")
    qb = q.to(torch.bfloat16).contiguous()
    kq, vq = kq.contiguous(), vq.contiguous()
    ks, vs = (t.to(torch.bfloat16).contiguous() for t in (ks, vs))
    bias = bias.to(torch.float32).contiguous()
    out_bf16 = q.dtype == torch.bfloat16
    out = torch.empty((batch, heads, d), device=q.device,
                      dtype=torch.bfloat16 if out_bf16 else torch.float32)
    _build.require_cuda("decode_int4", qb, kq, ks, vq, vs, bias, out)
    bias_bstride = bias.shape[1] * kv_len if bias.shape[0] > 1 else 0
    bias_hstride = kv_len if bias.shape[1] > 1 else 0
    rc = _build.lib().mg_decode_int4(
        qb.data_ptr(), kq.data_ptr(), ks.data_ptr(), vq.data_ptr(),
        vs.data_ptr(), bias.data_ptr(), batch, heads, d, kv_len,
        bias_bstride, bias_hstride, int(out_bf16), out.data_ptr(),
        _build.stream(out))
    _build.check(rc, "decode_int4")
    _build.LAUNCHES["decode_int4"] += 1
    return out.to(q.dtype)
