"""Q=1 decode attention over quantised K/V: the CUDA kernels
`csrc/decode_int4.cu` and `csrc/decode_i8.cu` (two element policies of the
cluster core `csrc/decode_cluster.cuh`), their wrappers, their launch plan,
their plain versions, and the nibble packing of the int4 slabs and rings.

Replaces `markushgrapher_tpu/ops/mxu_decode.py`:
  - `cross_decode_mxu` (int8 K/V, f32 scales): every decode-step attention
    under the int8 KV scheme (the reference's default quantised KV);
  - `cross_decode_mxu_int4` (packed int4 K/V, bf16 scales), separate-K/V
    mode: every decode-step attention under the int4 KV scheme;
  - `lattice_self_int4`: beam self-attention over int4 rings read segment by
    segment through a row map, the dead segments never read
    (`BEAM_LATTICE`); on the card decode_int4's kernel with the row map,
    blocks of one segment and the live segments' keys only;
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
the output rounded to bf16. No 1/sqrt(d) scaling (T5). The plain versions
sum the dot as the kernel does where it takes it on the tensor cores (head
dim 32 or 64, `_scores`), so that both round p * vs alike. Options:
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
from markushgrapher_torch.ops.tensor_core import tc_step

_THREADS = 256
# the cluster core's launch (csrc/decode_cluster.cuh): a cluster of at most
# I4_CLUSTER CTAs per (sample, slot), a slot being one run of D bytes of the
# K/V rows and up to I4_ROWS query rows that read it; each CTA stages its
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


class Elem(NamedTuple):
    """An element policy of the cluster core: the kernel (its C entry
    `mg_<name>` and launch counter), values a byte (2: packed int4, whose
    runs of D bytes hold two heads where G is even; 1: int8, one head a
    run), the scales' dtype, and how `int4_plan` picks the CTAs a cluster
    (`measured`): False, decode_int4's rule (a grid of at least I4_CTAS
    CTAs, resident CTAs as `int4_resident` models them, the fewest CTAs
    among the fewest waves); True, the card's own count of resident
    clusters (its C entry `mg_<name>_clusters`; `int4_resident` off the
    card), a grid of at least I4_SMS CTAs, and the fewest keys a CTA among
    the fewest waves."""
    name: str
    per_byte: int
    scale_dtype: torch.dtype
    measured: bool = False

    @property
    def scale_bytes(self) -> int:
        return self.scale_dtype.itemsize

    def two_heads(self, groups: int) -> bool:
        """Whether a run of D bytes holds two heads (c and c + G/2)."""
        return self.per_byte == 2 and groups % 2 == 0


INT4 = Elem("decode_int4", 2, torch.bfloat16)
INT8 = Elem("decode_i8", 1, torch.float32, measured=True)
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


def _scores(qb: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q . k [B, R, n] float32 of qb [B, R, D] (bf16 values) and k
    [B, n, R, D] (integer values). At head dim 32 or 64, where the kernel
    takes its scores on the tensor cores, summed as it sums them: in steps
    of 16 dims (`ops.tensor_core.tc_step`), so that the plain version's
    p = exp(s - m), and so bf16(p * vs), are the kernel's (a one-ulp move
    of s flips a bf16(p * vs) now and then, and where the output nearly
    cancels, that flip alone can leave TOL). Else a float32 product sum."""
    if not _int4_tensor_cores(qb.shape[-1]):
        return torch.einsum("brd,bkrd->brk", qb, k)
    acc = torch.zeros(k.shape[:3], dtype=torch.float64, device=k.device)
    for d0 in range(0, qb.shape[-1], 16):
        prods = (qb[:, None, :, d0:d0 + 16].to(torch.float64)
                 * k[..., d0:d0 + 16].to(torch.float64))
        acc = tc_step(torch.cat([acc[..., None], prods], dim=-1))
    return acc.to(torch.float32).transpose(1, 2)


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
    s = _scores(qb, k) * ks.to(torch.float32)
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
    """The cluster core runs its products on the tensor cores at head dim
    32 or 64 (every head's runs are whole 16-byte units there)."""
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


def int4_scale_rows(per_row: bool, rows: int, groups: int,
                    elem: Elem = INT4) -> int:
    """Scale rows a cluster-core CTA stages: one per query row, or one per
    head its bytes hold (two for packed int4 with G even)."""
    return rows if per_row else (2 if elem.two_heads(groups) else 1)


def int4_smem(d: int, rows: int, scale_rows: int, keys: int,
              seg: int, scale_bytes: int = 2) -> int:
    """Dynamic shared memory of one cluster-core CTA
    (csrc/decode_cluster.cuh's `layout`): K and V tiles of `keys` rows in
    whole tiles of 16 (the K tile at least the P V partials of the warps or
    thread groups); q (float32 rows, or two bf16 [8 or 16, d] tensor-core
    operands with rows of d + 8) in the same bytes as the cluster's
    partials of this CTA's outputs; the scores, the running maxima and
    scales of the local blocks of `seg` keys (rows of scores and scales 4
    longer than the tiles); the cluster's maxima and l, warp partials; K
    and V scales of `scale_rows` rows, `scale_bytes` a key (bf16 or
    f32)."""
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
            + 2 * _up16(scale_bytes * scale_rows * kp))


class Int4Plan(NamedTuple):
    """One cluster-core launch: `splits` CTAs in each cluster, CTA i taking
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
    """Cluster-core CTAs of `smem` bytes at head dim d the card holds at
    once."""
    return I4_SMS * min(4 if _int4_tensor_cores(d) else 2,
                        I4_SM_SMEM // (smem + 1024))


def _resident_ctas(elem: Elem, on_card: bool, rows: int, d: int,
                   splits: int, smem: int) -> int:
    """Cluster-core CTAs the card holds at once for one plan: the card's
    count of whole clusters where the policy measures it on the card, else
    `int4_resident`'s model."""
    if elem.measured and on_card:
        clusters = getattr(_build.lib(), f"mg_{elem.name}_clusters")(
            rows, d, splits, smem)
        if clusters < 1:
            raise RuntimeError(f"{elem.name}: no cluster of {splits} CTAs "
                               f"of {smem} bytes fits the card")
        return clusters * splits
    return int4_resident(smem, d)


@functools.lru_cache(maxsize=1024)
def int4_plan(batch: int, slots: int, rows: int, d: int, live: int,
              block_k: Optional[int] = None, scale_rows: int = 1,
              elem: Elem = INT4, on_card: bool = False) -> Int4Plan:
    """The host's choice for one cluster-core call over `batch` samples
    and `slots` slots of at most `rows` query rows (`scale_rows` staged
    scale rows of the policy's scale dtype): ranges of whole blocks of
    block_k when the call has a block size (else multiples of I4_GRAIN
    keys, one block), no empty CTA, and, among the counts of CTAs a cluster
    (at most I4_CLUSTER) whose shared memory fits and whose grid has
    enough CTAs (or ranges of I4_MIN_KEYS keys), the one the policy's rule
    (`Elem`) picks: the fewest waves of resident CTAs, then the fewest CTAs
    (decode_int4) or the fewest keys a CTA (decode_i8, whose resident
    clusters `on_card` counts on the current device). Raises ValueError
    where even I4_CLUSTER CTAs do not fit. Cached: the decode calls of a
    step repeat a few shapes."""
    unit = I4_GRAIN if block_k is None else block_k
    units = -(-live // unit)
    plans = []
    for splits in range(1, I4_CLUSTER + 1):
        per = -(-units // splits)
        chunk = per * unit
        keys = min(chunk, live)
        seg = keys if block_k is None else block_k
        smem = int4_smem(d, rows, scale_rows, keys, seg, elem.scale_bytes)
        if smem <= I4_SMEM:
            plans.append(Int4Plan(-(-units // per), chunk, seg, rows, smem))
    grid = I4_SMS if elem.measured else I4_CTAS
    enough = [p for p in plans if batch * slots * p.splits >= grid
              or p.chunk <= max(unit, I4_MIN_KEYS)] or plans[-1:]
    if enough:
        def waves(p: Int4Plan) -> int:
            return -(-batch * slots * p.splits // _resident_ctas(
                elem, on_card, rows, d, p.splits, p.smem))
        return min(enough, key=lambda p: (
            waves(p), p.chunk if elem.measured else p.splits))
    raise ValueError(
        f"{elem.name}: {live} live keys need more shared memory than a "
        f"cluster of {I4_CLUSTER} CTAs has ({I4_SMEM} bytes each; D {d}, "
        f"{rows} query rows a kv block)")


@functools.lru_cache(maxsize=64)
def int4_slots(rows: int, groups: int, head_map: Optional[tuple],
               elem: Elem = INT4) -> Tuple[Tuple[int, tuple], ...]:
    """The inverse of the head map over the K/V bytes: (run of D bytes c,
    the query rows that read it, how many of them read head c) for each run
    some row reads, in order. Packed int4 with G even: bytes [c*D, c*D + D)
    hold head c in their low nibbles and head c + G/2 in their high ones,
    so the rows of head c, then those of head c + G/2; otherwise (int4 with
    G odd, int8) run c is head c's, and its rows read it. At most I4_ROWS
    rows a slot: more take further slots."""
    hm = _row_groups(rows, groups, head_map).tolist()
    paired = elem.two_heads(groups)
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
                     device: str, elem: Elem = INT4) -> torch.Tensor:
    """int4_slots as the kernel reads it, made once per map: int32
    [slots, 3 + I4_ROWS] of (c, row count, head c's row count, rows padded
    with the first)."""
    flat = []
    for c, mine, low in int4_slots(rows, groups, head_map, elem):
        flat += [c, len(mine), low, *mine] + [mine[0]] * (I4_ROWS -
                                                          len(mine))
    return torch.tensor(flat, dtype=torch.int32,
                        device=device).view(-1, 3 + I4_ROWS)


def int4_call_plan(q, kq, ks, vq, vs, bias, head_map=None, row_map=None,
                   block_k=None, live_keys=None, elem: Elem = INT4):
    """Check one cluster-core call's operands (the module docstring
    contract; any device) under the element policy and plan its launch:
    (head map tuple or None, block size, live keys, Int4Plan). Raises
    ValueError on what the kernel does not take, before any launch."""
    batch, rows, groups, d = _check_operands(elem.name, elem.per_byte, q,
                                             kq, ks, vq, vs, bias, head_map,
                                             row_map)
    block, live = _options(elem.name, batch, kq.shape[1], row_map, block_k,
                           live_keys)
    hm = None if head_map is None else tuple(int(h) for h in head_map)
    slots = int4_slots(rows, groups, hm, elem)
    most = max(len(m) for _, m, _ in slots)
    plan = int4_plan(batch, len(slots), most, d, live, block_k,
                     int4_scale_rows(ks.shape[1] == rows, most, groups, elem),
                     elem, q.device.type == "cuda")
    return hm, block, live, plan


def lattice_call_plan(q, kq, ks, vq, vs, bias, row_map, n_live: int,
                      seg: int):
    """Check one lattice_self_int4 call (n_live in [1, L / seg], the row
    map's shape) and plan it: decode_int4's call plan with the row map,
    blocks of one segment and the first n_live segments' keys."""
    name = "lattice_self_int4"
    kv_len = kq.shape[1]
    _options(name, q.shape[0], kv_len, row_map, seg, None)
    if not 0 < int(n_live) <= kv_len // seg:
        raise ValueError(f"{name}: n_live {n_live} not in "
                         f"[1, {kv_len // seg}]")
    return int4_call_plan(q, kq, ks, vq, vs, bias, row_map=row_map,
                          block_k=seg, live_keys=int(n_live) * seg)


def _launch_cluster(q, kq, ks, vq, vs, bias, head_map, row_map, block_k,
                    live_keys, elem: Elem = INT4,
                    counter: Optional[str] = None,
                    planned=None) -> torch.Tensor:
    """Launch the cluster core once under the element policy (its C entry
    `mg_<elem.name>`) and count it under `counter` (default the entry's
    name); `planned`: the call's `int4_call_plan`, where the caller made
    it."""
    hm, block, live, plan = planned or int4_call_plan(
        q, kq, ks, vq, vs, bias, head_map, row_map, block_k, live_keys, elem)
    batch, rows, d = q.shape
    groups, kv_len = kq.shape[2] * elem.per_byte // d, kq.shape[1]
    qb = q.to(torch.bfloat16).contiguous()
    kq, vq = kq.contiguous(), vq.contiguous()
    ks, vs = (t.to(elem.scale_dtype).contiguous() for t in (ks, vs))
    bias = bias.to(torch.float32).contiguous()
    slots = _int4_slot_table(rows, groups, hm, str(q.device), elem)
    rm = None if row_map is None else row_map.to(torch.int32).contiguous()
    out_bf16 = q.dtype == torch.bfloat16
    out = torch.empty((batch, rows, d), device=q.device,
                      dtype=torch.bfloat16 if out_bf16 else torch.float32)
    name = counter or elem.name
    _build.require_cuda(name, qb, kq, ks, vq, vs, bias, out, slots,
                        *(t for t in (rm,) if t is not None))
    rc = getattr(_build.lib(), f"mg_{elem.name}")(
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


def cross_decode_mxu(q: torch.Tensor, kq: torch.Tensor, ks: torch.Tensor,
                     vq: torch.Tensor, vs: torch.Tensor, bias: torch.Tensor,
                     head_map: Optional[Sequence[int]] = None,
                     row_map: Optional[torch.Tensor] = None,
                     block_k: Optional[int] = None,
                     live_keys: Optional[int] = None) -> torch.Tensor:
    """int8 K/V [rows, K, G*D] with f32 scales; module docstring
    contract. The kernel takes as many live keys as `int4_plan` fits in a
    cluster's shared memory."""
    if q.device.type == "cpu":
        return plain_int8(q, kq, ks, vq, vs, bias, head_map, row_map,
                          block_k, live_keys)
    return _launch_cluster(q, kq, ks, vq, vs, bias, head_map, row_map,
                           block_k, live_keys, INT8)


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
    return _launch_cluster(q, kq, ks, vq, vs, bias, head_map, row_map,
                           block_k, live_keys)


def lattice_self_int4(q: torch.Tensor, kq: torch.Tensor, ks: torch.Tensor,
                      vq: torch.Tensor, vs: torch.Tensor, bias: torch.Tensor,
                      row_map: torch.Tensor, n_live: int,
                      seg: int) -> torch.Tensor:
    """Beam self-attention over packed int4 rings [rows, L, G*D/2] with bf16
    scales: segment s (seg keys) of output row b is read from physical row
    row_map[b, s], segments s >= n_live are never read, and the softmax runs
    online across segments (the module docstring's rounding). The same
    function as `cross_decode_mxu_int4(..., row_map=row_map, block_k=seg)`,
    whose dead segments the causal mask zeroes; on the card that kernel
    reads the first n_live * seg keys only, counted as this function's
    launch."""
    if q.device.type == "cpu":
        return plain_lattice_int4(q, kq, ks, vq, vs, bias, row_map, n_live,
                                  seg)
    planned = lattice_call_plan(q, kq, ks, vq, vs, bias, row_map, n_live,
                                seg)
    return _launch_cluster(q, kq, ks, vq, vs, bias, None, row_map, seg,
                           int(n_live) * seg, counter="lattice_self_int4",
                           planned=planned)
