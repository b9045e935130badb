"""Q=1 decode attention over quantised K/V: the CUDA kernels
`csrc/decode_i8.cu`, `csrc/decode_int4.cu` and `csrc/lattice_i4.cu`, their
wrappers, their plain versions, and the nibble packing of the int4 slabs and
rings.

Replaces `markushgrapher_tpu/ops/mxu_decode.py`:
  - `cross_decode_mxu` (int8 K/V, f32 scales): every decode-step attention
    under the int8 KV scheme (the reference's default quantised KV);
  - `cross_decode_mxu_int4` (packed int4 K/V, bf16 scales), separate-K/V
    mode: every decode-step attention under the int4 KV scheme;
  - `lattice_self_int4`: beam self-attention over int4 rings read segment by
    segment through a row map, the dead segments never read
    (`BEAM_LATTICE`);
  - `valid_prefix_blocks`: the options of valid-prefix ring reads
    (`block_skip`).
Both decode functions take the TPU kernels' `head_map` and `row_map`
options. The TPU `block_map` becomes a live-key count: its one producer,
`valid_prefix_blocks`, redirects every ring block past the decode index to
the last live one, whose repeated keys the mask then zeroes, which is the
same as not reading them. The combined k||v ring (`combined=True`) is a
Mosaic layout choice and is not ported: separate K and V rings hold the
same values.

Contract, for both: q [B, R, D] float; K/V [rows, K, G*D] (int8) or
[rows, K, G*D/2] (packed int4); scales [rows, R, K] (one row per query row)
or [rows, G, K] (one row per kv column block); bias [B or 1, 1 or R, K] f32.
Query row r attends kv column block head_map[r] (default grouped,
r // (R / G)). Returns [B, R, D] in q's dtype, with the TPU kernels'
rounding points: q in bf16; s = dot * ks + bias in f32; p * vs in bf16;
the output rounded to bf16. No 1/sqrt(d) scaling (T5). Options:
  - block_k: the softmax runs online over blocks of block_k keys, as the
    TPU kernel's K grid does: running max m, l and acc in f32, p = exp(s -
    m) against the running max after each block, p * vs rounded to bf16,
    acc and l rescaled by exp(m_old - m_new). Without it the keys are one
    block (the TPU kernel's whole-slab tile): p against the global max;
  - row_map (int32 [B, K // block_k], with block_k): key block j of output
    row b is read from physical row row_map[b, j] of the values and scales
    (beam search's copy-on-write rings); without it row b reads row b;
  - live_keys: keys at or past it are not read.

Beam search folds its beams into the query rows: q [B, beams*H, D] with
head_map = tuple(range(H)) * beams reads each sample's shared cross slab
once per step for all of its beams.

A CPU tensor goes to the plain version; a CUDA tensor goes to the kernel.
The kernels trust the row map's entries to lie in [0, rows).
"""

from __future__ import annotations

import functools
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from markushgrapher_torch.ops import _build

# dynamic shared memory of one decode_i8 block: q [D] + 8 warp partials +
# 256 column partials + the live keys' scores + 2 floats per key block, all
# f32, within the default 48 KB
_SMEM_FLOATS = 48 * 1024 // 4
_THREADS = 256
# decode_int4's launch (csrc/decode_int4.cu): a cluster of at most
# I4_CLUSTER CTAs per (sample, slot), a slot being one run of D bytes of the
# packed rows and up to I4_ROWS query rows that read it; each CTA stages its
# keys in at most I4_SMEM bytes of shared memory. The plan aims at I4_CTAS
# CTAs (twice the H100's I4_SMS SMs), all resident at once where they fit
# (I4_SM_SMEM bytes of shared memory a SM, 1 KB of each CTA's reserved, and
# as many CTAs as the registers allow: the tensor-core instances, D 32 or
# 64, keep to 64 a thread, 4 CTAs a SM; the others to 128, 2), splits no
# range below I4_MIN_KEYS keys and, without a block size, cuts ranges in
# multiples of I4_GRAIN keys.
I4_CLUSTER, I4_ROWS, I4_SMEM = 8, 10, 227 * 1024
I4_SMS, I4_SM_SMEM = 132, 228 * 1024
I4_CTAS, I4_MIN_KEYS, I4_GRAIN = 2 * I4_SMS, 64, 32
# the lattice kernel's dynamic shared memory (two segment buffers) may go
# up to what one block of the card can use
_LATTICE_SMEM = 227 * 1024
NEG_INF = -1e30


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


def valid_prefix_blocks(ring_len: int, step: int, block_k: int) -> Dict:
    """Options of valid-prefix ring reads at decode index `step`: the keys
    of blocks past step's block are not read (the mask zeroes them), and
    the softmax runs online over blocks of block_k keys. {} when the ring
    is one block or block_k does not tile it."""
    if block_k <= 0 or ring_len % block_k or ring_len // block_k <= 1:
        return {}
    return dict(block_k=block_k,
                live_keys=min(ring_len, (step // block_k + 1) * block_k))


def _options(name: str, batch: int, kv_len: int, row_map, block_k,
             live_keys) -> Tuple[int, int]:
    """(block size, live keys) of the options; raises on what the contract
    does not take. One block of the live keys without block_k."""
    live = kv_len if live_keys is None else int(live_keys)
    if not 0 < live <= kv_len:
        raise ValueError(f"{name}: live_keys {live} not in [1, {kv_len}]")
    if block_k is None:
        if row_map is not None:
            raise ValueError(f"{name}: row_map needs block_k")
        return live, live
    if block_k <= 0 or kv_len % block_k:
        raise ValueError(f"{name}: block_k {block_k} does not tile "
                         f"{kv_len} keys")
    if row_map is not None and tuple(row_map.shape) != (
            batch, kv_len // block_k):
        raise ValueError(f"{name}: row_map {tuple(row_map.shape)} != "
                         f"{(batch, kv_len // block_k)}")
    return block_k, live


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


def _keys(t: torch.Tensor, row_map, block_k: int, live: int,
          key_axis: int) -> torch.Tensor:
    """The live keys of each output row: t [rows, K, W] values (key_axis 1)
    or [rows, S, K] scales (key_axis 2), each key block read from its
    physical row under a row map."""
    t = t.narrow(key_axis, 0, live)
    if row_map is None:
        return t
    phys = row_map.long().repeat_interleave(block_k, dim=1)[:, :live]
    keys = torch.arange(live, device=t.device)
    if key_axis == 1:
        return t[phys, keys]
    return t.transpose(1, 2)[phys, keys].transpose(1, 2)


def _attend(q, k, v, ks, vs, bias, head_map, block_k: int):
    """Shared plain body over the live keys: k / v float32 [B, n, G, D]
    values, ks / vs [B, R or G, n], bias [B or 1, 1 or R, n]; the online
    softmax over blocks of block_k keys (module docstring)."""
    rows = q.shape[1]
    hm = _row_groups(rows, k.shape[2], head_map).to(q.device)
    k, v = k[:, :, hm], v[:, :, hm]                          # [B, n, R, D]
    if ks.shape[1] != rows:                                  # per kv block
        ks, vs = ks[:, hm], vs[:, hm]
    qb = q.to(torch.bfloat16).to(torch.float32)
    s = torch.einsum("brd,bkrd->brk", qb, k) * ks.to(torch.float32)
    s = s + bias.to(torch.float32)
    n = s.shape[-1]
    m = torch.full(s.shape[:2] + (1,), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for j in range(0, n, block_k):
        sj = s[..., j:j + block_k]
        m_new = torch.maximum(m, sj.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sj - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        pv = (p * vs[..., j:j + block_k].to(torch.float32)).to(
            torch.bfloat16).to(torch.float32)
        acc = acc * alpha + torch.einsum("brk,bkrd->brd", pv,
                                         v[:, j:j + block_k])
        m = m_new
    out = acc / l.clamp(min=1e-30)
    return out.to(torch.bfloat16).to(q.dtype)


def _plain(q, kq, ks, vq, vs, bias, head_map, row_map, block_k, live_keys,
           int4: bool) -> torch.Tensor:
    batch, kv_len, width = kq.shape
    block, live = _options("plain", q.shape[0], kv_len, row_map, block_k,
                           live_keys)
    kq, vq = (_keys(t, row_map, block, live, 1) for t in (kq, vq))
    ks, vs = (_keys(t, row_map, block, live, 2) for t in (ks, vs))
    d = q.shape[2]
    if int4:
        k, v = unpack_int4(kq), unpack_int4(vq)
    else:
        k, v = kq.to(torch.float32), vq.to(torch.float32)
    k = k.reshape(q.shape[0], live, -1, d)
    v = v.reshape(q.shape[0], live, -1, d)
    return _attend(q, k, v, ks, vs, bias[..., :live], head_map, block)


def plain_int8(q: torch.Tensor, kq: torch.Tensor, ks: torch.Tensor,
               vq: torch.Tensor, vs: torch.Tensor, bias: torch.Tensor,
               head_map: Optional[Sequence[int]] = None,
               row_map: Optional[torch.Tensor] = None,
               block_k: Optional[int] = None,
               live_keys: Optional[int] = None) -> torch.Tensor:
    """Plain version of `cross_decode_mxu` (module docstring contract)."""
    return _plain(q, kq, ks, vq, vs, bias, head_map, row_map, block_k,
                  live_keys, False)


def plain_int4(q: torch.Tensor, kq: torch.Tensor, ks: torch.Tensor,
               vq: torch.Tensor, vs: torch.Tensor, bias: torch.Tensor,
               head_map: Optional[Sequence[int]] = None,
               row_map: Optional[torch.Tensor] = None,
               block_k: Optional[int] = None,
               live_keys: Optional[int] = None) -> torch.Tensor:
    """Plain version of `cross_decode_mxu_int4` (module docstring
    contract; K/V packed by `pack_int4`)."""
    return _plain(q, kq, ks, vq, vs, bias, head_map, row_map, block_k,
                  live_keys, True)


def plain_lattice_int4(q: torch.Tensor, kq: torch.Tensor, ks: torch.Tensor,
                       vq: torch.Tensor, vs: torch.Tensor,
                       bias: torch.Tensor, row_map: torch.Tensor,
                       n_live: int, seg: int) -> torch.Tensor:
    """Plain version of `lattice_self_int4`: the online softmax over the
    first n_live segments of seg keys only, each read through the row
    map."""
    return plain_int4(q, kq, ks, vq, vs, bias, row_map=row_map, block_k=seg,
                      live_keys=int(n_live) * seg)


@functools.lru_cache(maxsize=32)
def _head_map_on(head_map: tuple, device: str) -> torch.Tensor:
    """The head map as a small int32 device array, made once per map."""
    return torch.tensor(head_map, dtype=torch.int32, device=device)


def _check_operands(name: str, per_byte: int, q, kq, ks, vq, vs, bias,
                    head_map, row_map) -> Tuple[int, int, int, int]:
    """Check the operands against the module docstring contract (K/V bytes
    hold `per_byte` values each); returns (B, R, G, D)."""
    if q.dim() != 3 or kq.dim() != 3 or vq.shape != kq.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)} and K/V "
                         f"{tuple(kq.shape)} / {tuple(vq.shape)} must be "
                         "[B, R, D] and two equal [rows, K, width]")
    rows_kv, kv_len, width = kq.shape
    batch, rows, d = q.shape
    if (row_map is None and rows_kv != batch) or (width * per_byte) % d:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not match K/V "
                         f"{tuple(kq.shape)} ({per_byte} values a byte)")
    groups = width * per_byte // d
    if per_byte == 2 and width % 4:
        raise ValueError(f"{name}: packed rows of {width} bytes; the kernel "
                         "reads 4-byte words (G*D must be a multiple of 8)")
    if kq.dtype != torch.int8 or vq.dtype != torch.int8:
        raise ValueError(f"{name}: K/V must be int8")
    _row_groups(rows, groups, head_map)                     # validates
    if ks.shape not in ((rows_kv, rows, kv_len), (rows_kv, groups, kv_len)) \
            or vs.shape != ks.shape:
        raise ValueError(f"{name}: scales {tuple(ks.shape)} are neither "
                         f"{(rows_kv, rows, kv_len)} nor "
                         f"{(rows_kv, groups, kv_len)}")
    if (bias.dim() != 3 or bias.shape[0] not in (1, batch)
            or bias.shape[1] not in (1, rows) or bias.shape[2] != kv_len):
        raise ValueError(f"{name}: bias {tuple(bias.shape)} does not "
                         f"broadcast to {(batch, rows, kv_len)}")
    if d % 4 or d > _THREADS or _THREADS % d:
        raise ValueError(f"{name}: head dim {d} must divide {_THREADS} and "
                         "be a multiple of 4")
    return batch, rows, groups, d


def _int4_tensor_cores(d: int) -> bool:
    """decode_int4 runs its products on the tensor cores at head dim 32 or
    64 (every head's runs are whole 16-byte units there)."""
    return d in (32, 64)


def int4_pitch(d: int) -> int:
    """Bytes per staged key row: d on the tensor cores (units swizzled),
    else an odd number of 16-byte units (of words when d is no multiple of
    16)."""
    if _int4_tensor_cores(d):
        return d
    if d % 16 == 0:
        return d if (d // 16) % 2 else d + 16
    return d if (d // 4) % 2 else d + 4


def _up16(x: int) -> int:
    return -(-x // 16) * 16


def int4_scale_rows(per_row: bool, rows: int, groups: int) -> int:
    """Scale rows a decode_int4 CTA stages: one per query row, or one per
    head whose nibbles its bytes hold (two when G is even)."""
    return rows if per_row else (2 if groups % 2 == 0 else 1)


def int4_smem(d: int, rows: int, scale_rows: int, keys: int,
              seg: int) -> int:
    """Dynamic shared memory of one decode_int4 CTA (csrc/decode_int4.cu's
    `layout`): K and V tiles of `keys` rows in whole tiles of 16 (the K
    tile at least the P V partials of the warps or thread groups); q
    (float32 rows, or two bf16 [8 or 16, d] tensor-core operands with rows
    of d + 8) in the same bytes as the cluster's partials of this CTA's
    outputs; the scores, the running maxima and scales of the local blocks
    of `seg` keys (rows of scores and scales 4 longer than the tiles); the
    cluster's maxima and l, warp partials; bf16 K and V scales of
    `scale_rows` rows."""
    kt = -(-keys // 16) * 16
    kp = kt + 4
    nbl = -(-keys // seg)
    tile = kt * int4_pitch(d)
    part = (4 * (_THREADS // 32) * rows * d if _int4_tensor_cores(d)
            else 16 * _THREADS * rows)
    return (_up16(max(tile, part)) + _up16(tile)
            + max(4 * (16 if rows > 8 else 8) * (d + 8),
                  _up16(4 * (rows * d + I4_CLUSTER)))
            + 4 * rows * kp + 2 * _up16(4 * rows * nbl)
            + 2 * _up16(4 * I4_CLUSTER * rows)
            + _up16(4 * (_THREADS // 32) * rows)
            + 2 * _up16(2 * scale_rows * kp))


class Int4Plan(NamedTuple):
    """One decode_int4 launch: `splits` CTAs in each cluster, CTA i taking
    keys [i * chunk, min(live, (i + 1) * chunk)); local key blocks of `seg`
    keys; `rows` query rows a CTA (template); `smem` bytes a CTA."""
    splits: int
    chunk: int
    seg: int
    rows: int
    smem: int

    def ranges(self, live: int) -> List[Tuple[int, int]]:
        return [(i * self.chunk, min(live, (i + 1) * self.chunk))
                for i in range(self.splits)]


def int4_resident(smem: int, d: int) -> int:
    """decode_int4 CTAs of `smem` bytes at head dim d the card holds at
    once."""
    return I4_SMS * min(4 if _int4_tensor_cores(d) else 2,
                        I4_SM_SMEM // (smem + 1024))


@functools.lru_cache(maxsize=1024)
def int4_plan(batch: int, slots: int, rows: int, d: int, live: int,
              block_k: Optional[int] = None,
              scale_rows: int = 1) -> Int4Plan:
    """The host's choice for one decode_int4 call over `batch` samples and
    `slots` slots of at most `rows` query rows (`scale_rows` staged scale
    rows): ranges of whole blocks of block_k when the call has a block size
    (else multiples of I4_GRAIN keys, one block), no empty CTA, and, among
    the counts of CTAs a cluster (at most I4_CLUSTER) whose shared memory
    fits and whose grid has I4_CTAS CTAs (or ranges of I4_MIN_KEYS keys),
    the one whose grid takes the fewest waves of resident CTAs, then the
    fewest CTAs. Raises ValueError where even I4_CLUSTER CTAs do not
    fit. Cached: the decode calls of a step repeat a few shapes."""
    unit = I4_GRAIN if block_k is None else block_k
    units = -(-live // unit)
    plans = []
    for splits in range(1, I4_CLUSTER + 1):
        per = -(-units // splits)
        chunk = per * unit
        keys = min(chunk, live)
        seg = keys if block_k is None else block_k
        smem = int4_smem(d, rows, scale_rows, keys, seg)
        if smem <= I4_SMEM:
            plans.append(Int4Plan(-(-units // per), chunk, seg, rows, smem))
    enough = [p for p in plans if batch * slots * p.splits >= I4_CTAS
              or p.chunk <= max(unit, I4_MIN_KEYS)] or plans[-1:]
    if enough:
        return min(enough, key=lambda p: (
            -(-batch * slots * p.splits // int4_resident(p.smem, d)),
            p.splits))
    raise ValueError(
        f"decode_int4: {live} live keys need more shared memory than a "
        f"cluster of {I4_CLUSTER} CTAs has ({I4_SMEM} bytes each; D {d}, "
        f"{rows} query rows a kv block)")


@functools.lru_cache(maxsize=64)
def int4_slots(rows: int, groups: int,
               head_map: Optional[tuple]) -> Tuple[Tuple[int, tuple], ...]:
    """The inverse of the head map over the packed bytes: (byte column
    block c, the query rows that read it, how many of them read head c) for
    each run of D bytes some row reads, in order. With G even, bytes
    [c*D, c*D + D) hold head c in their low nibbles and head c + G/2 in
    their high ones: the rows of head c, then those of head c + G/2; with
    G odd, head c's rows. At most I4_ROWS rows a slot: more take further
    slots."""
    hm = _row_groups(rows, groups, head_map).tolist()
    paired = groups % 2 == 0
    out = []
    for c in range(groups // 2 if paired else groups):
        low = [r for r in range(rows) if hm[r] == c]
        mine = low + ([r for r in range(rows) if hm[r] == c + groups // 2]
                      if paired else [])
        out += [(c, tuple(mine[i:i + I4_ROWS]),
                 max(0, min(len(low) - i, I4_ROWS)))
                for i in range(0, len(mine), I4_ROWS)]
    return tuple(out)


@functools.lru_cache(maxsize=64)
def _int4_slot_table(rows: int, groups: int, head_map: Optional[tuple],
                     device: str) -> torch.Tensor:
    """int4_slots as the kernel reads it, made once per map: int32
    [slots, 3 + I4_ROWS] of (c, row count, head c's row count, rows padded
    with the first)."""
    flat = []
    for c, mine, low in int4_slots(rows, groups, head_map):
        flat += [c, len(mine), low, *mine] + [mine[0]] * (I4_ROWS -
                                                          len(mine))
    return torch.tensor(flat, dtype=torch.int32,
                        device=device).view(-1, 3 + I4_ROWS)


def int4_call_plan(q, kq, ks, vq, vs, bias, head_map=None, row_map=None,
                   block_k=None, live_keys=None):
    """Check one decode_int4 call's operands (the module docstring
    contract; any device) and plan its launch: (head map tuple or None,
    block size, live keys, Int4Plan). Raises ValueError on what the kernel
    does not take, before any launch."""
    name = "decode_int4"
    batch, rows, groups, d = _check_operands(name, 2, q, kq, ks, vq, vs,
                                             bias, head_map, row_map)
    block, live = _options(name, batch, kq.shape[1], row_map, block_k,
                           live_keys)
    hm = None if head_map is None else tuple(int(h) for h in head_map)
    slots = int4_slots(rows, groups, hm)
    most = max(len(m) for _, m, _ in slots)
    plan = int4_plan(batch, len(slots), most, d, live, block_k,
                     int4_scale_rows(ks.shape[1] == rows, most, groups))
    return hm, block, live, plan


def _launch_int4(q, kq, ks, vq, vs, bias, head_map, row_map, block_k,
                 live_keys) -> torch.Tensor:
    """Launch decode_int4 once (csrc/decode_int4.cu) and count it."""
    name = "decode_int4"
    hm, block, live, plan = int4_call_plan(q, kq, ks, vq, vs, bias, head_map,
                                           row_map, block_k, live_keys)
    batch, rows, d = q.shape
    groups, kv_len = kq.shape[2] * 2 // d, kq.shape[1]
    qb = q.to(torch.bfloat16).contiguous()
    kq, vq = kq.contiguous(), vq.contiguous()
    ks, vs = (t.to(torch.bfloat16).contiguous() for t in (ks, vs))
    bias = bias.to(torch.float32).contiguous()
    slots = _int4_slot_table(rows, groups, hm, str(q.device))
    rm = None if row_map is None else row_map.to(torch.int32).contiguous()
    out_bf16 = q.dtype == torch.bfloat16
    out = torch.empty((batch, rows, d), device=q.device,
                      dtype=torch.bfloat16 if out_bf16 else torch.float32)
    _build.require_cuda(name, qb, kq, ks, vq, vs, bias, out, slots,
                        *(t for t in (rm,) if t is not None))
    rc = _build.lib().mg_decode_int4(
        qb.data_ptr(), kq.data_ptr(), ks.data_ptr(), vq.data_ptr(),
        vs.data_ptr(), bias.data_ptr(), slots.data_ptr(),
        0 if rm is None else rm.data_ptr(), batch, rows, groups, d, kv_len,
        ks.shape[1], bias.shape[1] * kv_len if bias.shape[0] > 1 else 0,
        kv_len if bias.shape[1] > 1 else 0, block, live, slots.shape[0],
        plan.rows, plan.splits, plan.chunk, int(block_k is not None),
        int(out_bf16), out.data_ptr(), _build.stream(out))
    _build.check(rc, name)
    _build.LAUNCHES[name] += 1
    return out.to(q.dtype)


def _launch(name: str, per_byte: int, scale_dtype: torch.dtype, q, kq, ks,
            vq, vs, bias, head_map, row_map, block_k,
            live_keys) -> torch.Tensor:
    """Launch decode kernel `name` (decode_i8; K/V bytes hold `per_byte`
    values each) and count it; raises on what the kernel does not take."""
    batch, rows, groups, d = _check_operands(name, per_byte, q, kq, ks, vq,
                                             vs, bias, head_map, row_map)
    kv_len = kq.shape[1]
    block, live = _options(name, batch, kv_len, row_map, block_k, live_keys)
    n_blocks = -(-live // block)
    if d + _THREADS // 32 + _THREADS + live + 2 * n_blocks > _SMEM_FLOATS:
        raise ValueError(f"{name}: {live} live keys in {n_blocks} blocks "
                         "exceed one block's shared memory")
    qb = q.to(torch.bfloat16).contiguous()
    kq, vq = kq.contiguous(), vq.contiguous()
    ks, vs = (t.to(scale_dtype).contiguous() for t in (ks, vs))
    bias = bias.to(torch.float32).contiguous()
    hm = (None if head_map is None
          else _head_map_on(tuple(int(h) for h in head_map), str(q.device)))
    rm = None if row_map is None else row_map.to(torch.int32).contiguous()
    out_bf16 = q.dtype == torch.bfloat16
    out = torch.empty((batch, rows, d), device=q.device,
                      dtype=torch.bfloat16 if out_bf16 else torch.float32)
    _build.require_cuda(name, qb, kq, ks, vq, vs, bias, out,
                        *(t for t in (hm, rm) if t is not None))
    rc = getattr(_build.lib(), f"mg_{name}")(
        qb.data_ptr(), kq.data_ptr(), ks.data_ptr(), vq.data_ptr(),
        vs.data_ptr(), bias.data_ptr(), 0 if hm is None else hm.data_ptr(),
        0 if rm is None else rm.data_ptr(),
        batch, rows, groups, d, kv_len, ks.shape[1],
        bias.shape[1] * kv_len if bias.shape[0] > 1 else 0,
        kv_len if bias.shape[1] > 1 else 0, block, live,
        int(out_bf16), out.data_ptr(), _build.stream(out))
    _build.check(rc, name)
    _build.LAUNCHES[name] += 1
    return out.to(q.dtype)


def cross_decode_mxu(q: torch.Tensor, kq: torch.Tensor, ks: torch.Tensor,
                     vq: torch.Tensor, vs: torch.Tensor, bias: torch.Tensor,
                     head_map: Optional[Sequence[int]] = None,
                     row_map: Optional[torch.Tensor] = None,
                     block_k: Optional[int] = None,
                     live_keys: Optional[int] = None) -> torch.Tensor:
    """int8 K/V [rows, K, G*D] with f32 scales; module docstring
    contract."""
    if q.device.type == "cpu":
        return plain_int8(q, kq, ks, vq, vs, bias, head_map, row_map,
                          block_k, live_keys)
    return _launch("decode_i8", 1, torch.float32, q, kq, ks, vq, vs, bias,
                   head_map, row_map, block_k, live_keys)


def cross_decode_mxu_int4(q: torch.Tensor, kq: torch.Tensor,
                          ks: torch.Tensor, vq: torch.Tensor,
                          vs: torch.Tensor, bias: torch.Tensor,
                          head_map: Optional[Sequence[int]] = None,
                          row_map: Optional[torch.Tensor] = None,
                          block_k: Optional[int] = None,
                          live_keys: Optional[int] = None) -> torch.Tensor:
    """Packed int4 K/V [rows, K, G*D/2] (any G with G*D a multiple of 8; a
    head's nibbles may straddle the column split when G is odd); module
    docstring contract. The kernel reads the scales in bf16, and takes as
    many live keys as `int4_plan` fits in a cluster's shared memory."""
    if q.device.type == "cpu":
        return plain_int4(q, kq, ks, vq, vs, bias, head_map, row_map,
                          block_k, live_keys)
    return _launch_int4(q, kq, ks, vq, vs, bias, head_map, row_map, block_k,
                        live_keys)


def lattice_smem_bytes(seg: int, d: int) -> int:
    """Dynamic shared memory of one lattice block (csrc/lattice_i4.cu): two
    segment buffers of K and V nibble bytes (rows padded by 16 bytes) and
    bf16 scales, then q, the reductions and the segment's scores in f32."""
    return 2 * (2 * seg * (d + 16) + 2 * seg * 2) + 4 * (
        d + _THREADS // 32 + _THREADS + seg)


def lattice_self_int4(q: torch.Tensor, kq: torch.Tensor, ks: torch.Tensor,
                      vq: torch.Tensor, vs: torch.Tensor, bias: torch.Tensor,
                      row_map: torch.Tensor, n_live: int,
                      seg: int) -> torch.Tensor:
    """Beam self-attention over packed int4 rings [rows, L, G*D/2] with bf16
    scales: segment s (seg keys) of output row b is read from physical row
    row_map[b, s], segments s >= n_live are never read, and the softmax runs
    online across segments (the module docstring's rounding). The same
    function as `cross_decode_mxu_int4(..., row_map=row_map, block_k=seg)`,
    whose dead segments the causal mask zeroes; the kernel takes the query
    rows over the kv blocks in grouped order, G even."""
    if q.device.type == "cpu":
        return plain_lattice_int4(q, kq, ks, vq, vs, bias, row_map, n_live,
                                  seg)
    name = "lattice_self_int4"
    batch, rows, groups, d = _check_operands(name, 2, q, kq, ks, vq, vs,
                                             bias, None, row_map)
    kv_len = kq.shape[1]
    _options(name, batch, kv_len, row_map, seg, None)
    n_live = int(n_live)
    if not 0 < n_live <= kv_len // seg:
        raise ValueError(f"{name}: n_live {n_live} not in "
                         f"[1, {kv_len // seg}]")
    if d % 16 or (groups * d // 2) % d or seg % 2 or kv_len % 2:
        raise ValueError(f"{name}: the kernel copies 16-byte runs of one "
                         "head's nibbles (D a multiple of 16, G even) and "
                         "4-byte runs of scales (seg and L even)")
    smem = lattice_smem_bytes(seg, d)
    if smem > _LATTICE_SMEM:
        raise ValueError(f"{name}: segments of {seg} keys need {smem} bytes "
                         f"of shared memory (at most {_LATTICE_SMEM})")
    qb = q.to(torch.bfloat16).contiguous()
    kq, vq = kq.contiguous(), vq.contiguous()
    ks, vs = (t.to(torch.bfloat16).contiguous() for t in (ks, vs))
    bias = bias.to(torch.float32).contiguous()
    rm = row_map.to(torch.int32).contiguous()
    out_bf16 = q.dtype == torch.bfloat16
    out = torch.empty((batch, rows, d), device=q.device,
                      dtype=torch.bfloat16 if out_bf16 else torch.float32)
    _build.require_cuda(name, qb, kq, ks, vq, vs, bias, rm, out)
    rc = _build.lib().mg_lattice_i4(
        qb.data_ptr(), kq.data_ptr(), ks.data_ptr(), vq.data_ptr(),
        vs.data_ptr(), bias.data_ptr(), rm.data_ptr(), batch, rows, groups,
        d, kv_len, ks.shape[1],
        bias.shape[1] * kv_len if bias.shape[0] > 1 else 0,
        kv_len if bias.shape[1] > 1 else 0, seg, n_live, int(out_bf16),
        out.data_ptr(), _build.stream(out))
    _build.check(rc, name)
    _build.LAUNCHES[name] += 1
    return out.to(q.dtype)
