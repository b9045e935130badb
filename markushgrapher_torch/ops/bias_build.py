"""int8 encoder bias slab builder: the CUDA kernel `csrc/bias_build_i8.cu`
and its wrapper.

Replaces `markushgrapher_tpu/ops/bias_build.py:encoder_position_bias_kernel_i8`.
The TPU kernel turned the table gather into one-hot MXU dots with a hi/lo
bf16 table split (<= 1 LSB off the gather builder); on Hopper a gather from
shared memory is cheap, so the kernel looks the three table entries up
directly and is bit-exact against the plain builder
`relbias.encoder_position_bias_chunked_i8`. It is bound by the int8 slab
write (see the source note in the .cu file).

A CPU tensor goes to the plain builder; a CUDA tensor goes to the kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from markushgrapher_torch.ops import _build
from markushgrapher_torch.ops.relbias import (bias_scales, bbox_centres,
                                              bucket_lut, combined_table,
                                              encoder_position_bias_chunked_i8)

plain = encoder_position_bias_chunked_i8


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
    dev = bbox.device
    batch, length = bbox.shape[0], bbox.shape[1]
    if length != seq_len:
        raise ValueError(f"bbox length {length} != seq_len {seq_len}")
    heads = bias_1d_table.shape[-1]
    t1, th, tv = (t.to(torch.float32).contiguous()
                  for t in (bias_1d_table, bias_h_table, bias_v_table))
    scales = bias_scales(combined_table(t1, th, tv, num_buckets))
    hx, vy = (c.contiguous() for c in bbox_centres(bbox))
    lut1 = bucket_lut(num_buckets, max_distance_1d, dev)
    lut2 = bucket_lut(num_buckets, max_distance_2d, dev)
    pos = (None if positions is None
           else positions.to(torch.int32).contiguous())
    out = torch.empty((batch, heads, seq_len, seq_len), dtype=torch.int8,
                      device=dev)
    tensors = [t1, th, tv, scales, hx, vy, lut1, lut2, out]
    _build.require_cuda("bias_build_i8", *tensors,
                        *([] if pos is None else [pos]))
    lib = _build.lib()
    rc = lib.mg_bias_build_i8(
        t1.data_ptr(), th.data_ptr(), tv.data_ptr(), scales.data_ptr(),
        hx.data_ptr(), vy.data_ptr(), None if pos is None else pos.data_ptr(), lut1.data_ptr(),
        lut2.data_ptr(), batch, heads, seq_len, num_buckets,
        max_distance_1d, max_distance_2d, float(rel2d_scaling),
        out.data_ptr(), _build.stream(out))
    _build.check(rc, "bias_build_i8")
    _build.LAUNCHES["bias_build_i8"] += 1
    return out, scales
