"""The int8 encoder bias slab: the CUDA kernels `csrc/bias_build_i8.cu`,
their launch plan and their wrapper.

Replaces `markushgrapher_tpu/ops/bias_build.py:encoder_position_bias_kernel_i8`.
The TPU kernel turned the table gather into one-hot MXU dots with a hi/lo
bf16 table split (<= 1 LSB off the gather builder); on Hopper a gather from
shared memory is cheap, so the kernel looks the table entries up directly
and is bit-exact against the plain version
`relbias.encoder_position_bias_chunked_i8`. It is bound by the int8 slab
write. Two launches a call: a small kernel quantises the combined table
into a work buffer, with the plain version's scales and division; the slab
kernel copies its head group's table into shared memory and looks every
(b, i, j) up in it (the source's note says how).

A CPU tensor goes to the plain builder; a CUDA tensor goes to the kernel.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from markushgrapher_torch.ops import _build
from markushgrapher_torch.ops.relbias import (bbox_centres, bucket_lut,
                                              encoder_position_bias_chunked_i8)

plain = encoder_position_bias_chunked_i8

# mirrors of csrc/bias_build_i8.cu: threads a slab CTA, keys an item and
# their padded words in shared memory, copies of the 2d LUT
THREADS = 1024
KEYS, PAD_KEYS, BANKS = 16, 20, 32
# the card (H100 SXM): SMs, the shared memory a block may use and an SM has
# (less 1 KB reserved per block), CTAs an SM holds under the kernel's
# __launch_bounds__(THREADS, 1); `resident_model` only stands in for the
# card's count in the tests
SMS, BLOCK_SMEM, SM_SMEM, SM_CTAS = 132, 232448, 233472, 1
TABLE_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def table_words(nb: int) -> int:
    """4-byte words of one head group's quantised table: nb^2 rows of
    nb + 1 words, rounded up to whole 16-byte units."""
    return (nb * nb * (nb + 1) + 3) // 4 * 4


def smem_bytes(length: int, nb: int, max1: int, max2: int,
               packed: bool) -> int:
    """Shared-memory bytes of one slab CTA, `layout` of the .cu file (a head
    group's table, the 1d LUT, the 2d LUT once per bank, the keys' centres
    and positions). Raises ValueError, before any launch, when they exceed
    what a CTA may use."""
    n1, n2 = 2 * max1 + 1, 2 * max2 + 1
    keys = -(-length // KEYS) * PAD_KEYS
    n = table_words(nb) + n1 + (n1 >> 4) + 1 + BANKS * n2
    n = (n + 3) // 4 * 4 + (3 if packed else 2) * keys
    if 4 * n > BLOCK_SMEM:
        raise ValueError(f"bias_build_i8: {4 * n} bytes of shared memory "
                         f"(L={length}, nb={nb}) exceed {BLOCK_SMEM}")
    return 4 * n


def resident_model(smem: int) -> int:
    """CTAs of `smem` bytes an H100 holds at once, by threads, shared
    memory and the launch bounds (the card's own count is
    `resident_on_card`)."""
    return SMS * min(2048 // THREADS, SM_SMEM // (smem + 1024), SM_CTAS)


@functools.lru_cache(maxsize=64)
def resident_on_card(device_index: int, smem: int) -> int:
    """CTAs of `smem` bytes the card holds at once
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    with torch.cuda.device(device_index):
        n = _build.lib().mg_bias_build_i8_resident(smem)
    if n < 1:
        raise RuntimeError(f"bias_build_i8: no CTA of {smem} bytes fits the "
                           f"card (CUDA error {-n})")
    return n


@dataclass(frozen=True)
class BiasPlan:
    smem: int
    groups: int          # head groups of 4, one table each
    ranges: int          # CTAs of each group
    per_cta: int         # items (sample, query row, 16 keys) a range serves

    @property
    def grid(self) -> int:
        return self.groups * self.ranges


def plan(batch: int, heads: int, length: int, nb: int, max1: int, max2: int,
         packed: bool, resident: int) -> BiasPlan:
    """The slab kernel's launch: `resident` CTAs shared out over the head
    groups, each group's CTAs splitting the items into contiguous ranges;
    fewer where the items do not give each thread one. The kernel takes
    `ranges` and `per_cta` as they are."""
    smem = smem_bytes(length, nb, max1, max2, packed)
    groups = (heads + 3) // 4
    items = batch * length * -(-length // KEYS)
    ranges = max(1, min(resident // groups, -(-items // THREADS)))
    return BiasPlan(smem, groups, ranges, -(-items // ranges))


_LUTS: Dict[Tuple[str, int, int], torch.Tensor] = {}


def device_lut(num_buckets: int, max_distance: int,
               device) -> torch.Tensor:
    """`bucket_lut(num_buckets, max_distance, device)`, built once per
    (device, num_buckets, max_distance) and kept on the device."""
    key = (str(torch.device(device)), num_buckets, max_distance)
    if key not in _LUTS:
        _LUTS[key] = bucket_lut(num_buckets, max_distance, device)
    return _LUTS[key]


def kernel_call(bias_1d_table: torch.Tensor, bias_h_table: torch.Tensor,
                bias_v_table: torch.Tensor, bbox: torch.Tensor, seq_len: int,
                num_buckets: int, max_distance_1d: int, rel2d_scaling: int,
                max_distance_2d: int,
                positions: Optional[torch.Tensor] = None
                ) -> Callable[[], Tuple[torch.Tensor, torch.Tensor]]:
    """Checks the CUDA inputs, allocates (bias_i8 [B, H, L, L], scales [H])
    and the table's work buffer, and returns the launch: a function that
    runs the two kernels once into them, counts it, and returns them.
    Inputs in the main path's types (float32 boxes, int32 positions,
    float32 or bf16 tables) make no other device work; others are
    converted first."""
    dev = bbox.device
    batch, length = bbox.shape[0], bbox.shape[1]
    if length != seq_len:
        raise ValueError(f"bbox length {length} != seq_len {seq_len}")
    if bbox.shape[-1] != 4:
        raise ValueError(f"bbox {tuple(bbox.shape)} is not [B, L, 4]")
    heads = bias_1d_table.shape[-1]
    tables = [bias_1d_table, bias_h_table, bias_v_table]
    if any(t.shape != (num_buckets, heads) for t in tables):
        raise ValueError(f"bias tables {[tuple(t.shape) for t in tables]} "
                         f"are not [{num_buckets}, {heads}]")
    if len({t.dtype for t in tables}) > 1 or \
            tables[0].dtype not in TABLE_DTYPES:
        tables = [t.to(torch.float32) for t in tables]
    tables = [t.contiguous() for t in tables]
    if bbox.dtype != torch.float32:
        # the kernel takes (x0 + x2) / 2 in float32; from the centres of
        # another type, boxes (c, c', c, c') give back exactly (c, c')
        hx, vy = bbox_centres(bbox)
        bbox = torch.stack((hx, vy, hx, vy), dim=-1)
    bbox = bbox.contiguous()
    pos = (None if positions is None
           else positions.to(torch.int32).contiguous())
    smem = smem_bytes(length, num_buckets, max_distance_1d,
                      max_distance_2d, pos is not None)   # may refuse
    lut1 = device_lut(num_buckets, max_distance_1d, dev)
    lut2 = device_lut(num_buckets, max_distance_2d, dev)
    out = torch.empty((batch, heads, seq_len, seq_len), dtype=torch.int8,
                      device=dev)
    scales = torch.empty((heads,), dtype=torch.float32, device=dev)
    work = torch.empty(((heads + 3) // 4 * table_words(num_buckets),),
                       dtype=torch.int32, device=dev)
    _build.require_cuda("bias_build_i8", *tables, bbox, lut1, lut2, out,
                        scales, work, *([] if pos is None else [pos]))
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    p = plan(batch, heads, length, num_buckets, max_distance_1d,
             max_distance_2d, pos is not None, resident_on_card(index, smem))
    lib = _build.lib()

    def launch() -> Tuple[torch.Tensor, torch.Tensor]:
        rc = lib.mg_bias_build_i8(
            *(t.data_ptr() for t in tables), TABLE_DTYPES[tables[0].dtype],
            bbox.data_ptr(), None if pos is None else pos.data_ptr(),
            lut1.data_ptr(), lut2.data_ptr(), batch, heads, length,
            num_buckets, max_distance_1d, max_distance_2d,
            float(rel2d_scaling), p.ranges, p.per_cta, p.smem,
            work.data_ptr(), work.numel(), out.data_ptr(), scales.data_ptr(),
            _build.stream(out))
        _build.check(rc, "bias_build_i8")
        _build.LAUNCHES["bias_build_i8"] += 1
        return out, scales

    return launch


def encoder_position_bias_kernel_i8(
        bias_1d_table: torch.Tensor,   # [nb, H]
        bias_h_table: torch.Tensor,
        bias_v_table: torch.Tensor,
        bbox: torch.Tensor,            # [B, L, 4]
        attention_mask: Optional[torch.Tensor],
        seq_len: int, num_buckets: int, max_distance_1d: int,
        rel2d_scaling: int, max_distance_2d: int,
        positions: Optional[torch.Tensor] = None,  # [B, L] original indices
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (bias_i8 [B, H, L, L], scales [H] f32), the contract of
    `relbias.encoder_position_bias_chunked_i8`."""
    if bbox.device.type == "cpu":
        return plain(bias_1d_table, bias_h_table, bias_v_table, bbox,
                     attention_mask, seq_len, num_buckets, max_distance_1d,
                     rel2d_scaling, max_distance_2d, positions=positions)
    return kernel_call(bias_1d_table, bias_h_table, bias_v_table, bbox,
                       seq_len, num_buckets, max_distance_1d, rel2d_scaling,
                       max_distance_2d, positions)()
