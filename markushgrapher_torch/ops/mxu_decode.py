"""Q=1 decode attention over quantised K/V: the CUDA kernels
`csrc/decode_i8.cu` and `csrc/decode_int4.cu`, their wrappers, their plain
versions, and the nibble packing of the int4 slabs and rings.

Replaces `markushgrapher_tpu/ops/mxu_decode.py`:
  - `cross_decode_mxu` (int8 K/V, f32 scales): every decode-step attention
    under the int8 KV scheme (the reference's default quantised KV);
  - `cross_decode_mxu_int4` (packed int4 K/V, bf16 scales), separate-K/V
    mode: every decode-step attention under the int4 KV scheme.
Both take the TPU kernels' `head_map` option; the `row_map` / `block_map` /
`combined` options are not ported (beam search reorders the rings'
live prefix instead of reading through a row map).

Contract, for both: q [B, R, D] float; K/V [B, K, G*D] (int8) or
[B, K, G*D/2] (packed int4); scales [B, R, K] (one row per query row) or
[B, G, K] (one row per kv column block); bias [B or 1, 1 or R, K] f32.
Query row r attends kv column block head_map[r] (default grouped,
r // (R / G)). Returns [B, R, D] in q's dtype, with the TPU kernels'
rounding points: q in bf16; s = dot * ks + bias in f32; p * vs in bf16;
the output rounded to bf16. No 1/sqrt(d) scaling (T5).

Beam search folds its beams into the query rows: q [B, beams*H, D] with
head_map = tuple(range(H)) * beams reads each sample's shared cross slab
once per step for all of its beams.

A CPU tensor goes to the plain version; a CUDA tensor goes to the kernel.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch

from markushgrapher_torch.ops import _build

# dynamic shared memory of one block: q [D] + 8 warp partials + 256 column
# partials + the K scores, all f32, within the default 48 KB
_SMEM_FLOATS = 48 * 1024 // 4
_THREADS = 256


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


def _row_groups(rows: int, groups: int,
                head_map: Optional[Sequence[int]]) -> torch.Tensor:
    """The kv column block of every query row, [R] int64 (CPU)."""
    if head_map is None:
        if groups <= 0 or rows % groups:
            raise ValueError(f"{rows} query rows do not group over "
                             f"{groups} kv column blocks; pass head_map")
        return torch.arange(rows) // (rows // groups)
    if len(head_map) != rows or min(head_map) < 0 \
            or max(head_map) >= groups:
        raise ValueError(f"head_map {tuple(head_map)} must give each of "
                         f"{rows} query rows a block in [0, {groups})")
    return torch.tensor(head_map, dtype=torch.long)


def _attend(q, k, v, ks, vs, bias, head_map):
    """Shared plain body: k / v float32 [B, K, G, D] values."""
    rows = q.shape[1]
    hm = _row_groups(rows, k.shape[2], head_map).to(q.device)
    k, v = k[:, :, hm], v[:, :, hm]                          # [B, K, R, D]
    if ks.shape[1] != rows:                                  # per kv block
        ks, vs = ks[:, hm], vs[:, hm]
    qb = q.to(torch.bfloat16).to(torch.float32)
    s = torch.einsum("brd,bkrd->brk", qb, k) * ks.to(torch.float32)
    s = s + bias.to(torch.float32)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    den = p.sum(dim=-1, keepdim=True)
    pv = (p * vs.to(torch.float32)).to(torch.bfloat16).to(torch.float32)
    acc = torch.einsum("brk,bkrd->brd", pv, v)
    out = acc / den.clamp(min=1e-30)
    return out.to(torch.bfloat16).to(q.dtype)


def plain_int8(q: torch.Tensor, kq: torch.Tensor, ks: torch.Tensor,
               vq: torch.Tensor, vs: torch.Tensor, bias: torch.Tensor,
               head_map: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Plain version of `cross_decode_mxu` (module docstring contract)."""
    batch, kv_len, hd = kq.shape
    d = q.shape[2]
    k = kq.to(torch.float32).reshape(batch, kv_len, hd // d, d)
    v = vq.to(torch.float32).reshape(batch, kv_len, hd // d, d)
    return _attend(q, k, v, ks, vs, bias, head_map)


def plain_int4(q: torch.Tensor, kq: torch.Tensor, ks: torch.Tensor,
               vq: torch.Tensor, vs: torch.Tensor, bias: torch.Tensor,
               head_map: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Plain version of `cross_decode_mxu_int4` (module docstring
    contract; K/V packed by `pack_int4`)."""
    batch, kv_len, half = kq.shape
    d = q.shape[2]
    k = unpack_int4(kq).reshape(batch, kv_len, 2 * half // d, d)
    v = unpack_int4(vq).reshape(batch, kv_len, 2 * half // d, d)
    return _attend(q, k, v, ks, vs, bias, head_map)


@functools.lru_cache(maxsize=32)
def _head_map_on(head_map: tuple, device: str) -> torch.Tensor:
    """The head map as a small int32 device array, made once per map."""
    return torch.tensor(head_map, dtype=torch.int32, device=device)


def _launch(name: str, per_byte: int, scale_dtype: torch.dtype, q, kq, ks,
            vq, vs, bias, head_map) -> torch.Tensor:
    """Check the operands against the module docstring contract (K/V bytes
    hold `per_byte` values each), launch kernel `name` and count it; raises
    on what the kernel does not take."""
    if q.dim() != 3 or kq.dim() != 3 or vq.shape != kq.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)} and K/V "
                         f"{tuple(kq.shape)} / {tuple(vq.shape)} must be "
                         "[B, R, D] and two equal [B, K, width]")
    batch, kv_len, width = kq.shape
    rows, d = q.shape[1], q.shape[2]
    if q.shape[0] != batch or (width * per_byte) % d:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not match K/V "
                         f"{tuple(kq.shape)} ({per_byte} values a byte)")
    groups = width * per_byte // d
    if per_byte == 2 and width % 4:
        raise ValueError(f"{name}: packed rows of {width} bytes; the kernel "
                         "reads 4-byte words (G*D must be a multiple of 8)")
    if kq.dtype != torch.int8 or vq.dtype != torch.int8:
        raise ValueError(f"{name}: K/V must be int8")
    _row_groups(rows, groups, head_map)                     # validates
    if ks.shape not in ((batch, rows, kv_len), (batch, groups, kv_len)) \
            or vs.shape != ks.shape:
        raise ValueError(f"{name}: scales {tuple(ks.shape)} are neither "
                         f"{(batch, rows, kv_len)} nor "
                         f"{(batch, groups, kv_len)}")
    if (bias.dim() != 3 or bias.shape[0] not in (1, batch)
            or bias.shape[1] not in (1, rows) or bias.shape[2] != kv_len):
        raise ValueError(f"{name}: bias {tuple(bias.shape)} does not "
                         f"broadcast to {(batch, rows, kv_len)}")
    if d % 4 or d > _THREADS or _THREADS % d:
        raise ValueError(f"{name}: head dim {d} must divide {_THREADS} and "
                         "be a multiple of 4")
    if d + _THREADS // 32 + _THREADS + kv_len > _SMEM_FLOATS:
        raise ValueError(f"{name}: {kv_len} keys exceed one block's shared "
                         f"memory (at most "
                         f"{_SMEM_FLOATS - d - _THREADS // 32 - _THREADS})")
    qb = q.to(torch.bfloat16).contiguous()
    kq, vq = kq.contiguous(), vq.contiguous()
    ks, vs = (t.to(scale_dtype).contiguous() for t in (ks, vs))
    bias = bias.to(torch.float32).contiguous()
    hm = (None if head_map is None
          else _head_map_on(tuple(int(h) for h in head_map), str(q.device)))
    out_bf16 = q.dtype == torch.bfloat16
    out = torch.empty((batch, rows, d), device=q.device,
                      dtype=torch.bfloat16 if out_bf16 else torch.float32)
    _build.require_cuda(name, qb, kq, ks, vq, vs, bias, out,
                        *([] if hm is None else [hm]))
    rc = getattr(_build.lib(), f"mg_{name}")(
        qb.data_ptr(), kq.data_ptr(), ks.data_ptr(), vq.data_ptr(),
        vs.data_ptr(), bias.data_ptr(), 0 if hm is None else hm.data_ptr(),
        batch, rows, groups, d, kv_len, ks.shape[1],
        bias.shape[1] * kv_len if bias.shape[0] > 1 else 0,
        kv_len if bias.shape[1] > 1 else 0,
        int(out_bf16), out.data_ptr(), _build.stream(out))
    _build.check(rc, name)
    _build.LAUNCHES[name] += 1
    return out.to(q.dtype)


def cross_decode_mxu(q: torch.Tensor, kq: torch.Tensor, ks: torch.Tensor,
                     vq: torch.Tensor, vs: torch.Tensor, bias: torch.Tensor,
                     head_map: Optional[Sequence[int]] = None
                     ) -> torch.Tensor:
    """int8 K/V [B, K, G*D] with f32 scales; module docstring contract."""
    if q.device.type == "cpu":
        return plain_int8(q, kq, ks, vq, vs, bias, head_map)
    return _launch("decode_i8", 1, torch.float32, q, kq, ks, vq, vs, bias,
                   head_map)


def cross_decode_mxu_int4(q: torch.Tensor, kq: torch.Tensor,
                          ks: torch.Tensor, vq: torch.Tensor,
                          vs: torch.Tensor, bias: torch.Tensor,
                          head_map: Optional[Sequence[int]] = None
                          ) -> torch.Tensor:
    """Packed int4 K/V [B, K, G*D/2] (any G with G*D a multiple of 8; a
    head's nibbles may straddle the column split when G is odd); module
    docstring contract. The kernel reads the scales in bf16."""
    if q.device.type == "cpu":
        return plain_int4(q, kq, ks, vq, vs, bias, head_map)
    return _launch("decode_int4", 2, torch.bfloat16, q, kq, ks, vq, vs, bias,
                   head_map)
