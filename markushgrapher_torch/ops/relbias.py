"""Relative attention bias: T5 bucketing + UDOP's 1D / horizontal / vertical
layout biases (port of `markushgrapher_tpu.ops.relbias`).

Bucket math runs in float32 in the JAX op order, and `(delta * 100)` is
truncated toward zero, so bucket ids are identical to the reference. The int8
slab builder (`encoder_position_bias_chunked_i8`) maps distances to buckets
through small lookup tables built by `relative_position_bucket` itself: the
table spans +-max_distance and buckets saturate beyond it, so clamping a
distance into the table is exact, and the CUDA builder (ops.bias_build) reads
the same tables.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def relative_position_bucket(relative_position: torch.Tensor,
                             bidirectional: bool = True,
                             num_buckets: int = 32,
                             max_distance: int = 128) -> torch.Tensor:
    """T5 relative-position bucketing (integer positions -> bucket ids)."""
    relative_buckets = torch.zeros_like(relative_position)
    n = -relative_position
    if bidirectional:
        num_buckets //= 2
        relative_buckets = relative_buckets + (n < 0).to(n.dtype) * num_buckets
        n = n.abs()
    else:
        n = n.clamp(min=0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    n_float = n.to(torch.float32).clamp(min=1.0)
    # the divisor is a float32 log, as jnp.log of the weak-typed ratio is
    denom = torch.log(torch.tensor(max_distance / max_exact,
                                   dtype=torch.float32,
                                   device=relative_position.device))
    val_if_large = max_exact + (
        torch.log(n_float / max_exact) / denom * (num_buckets - max_exact)
    ).to(n.dtype)
    val_if_large = val_if_large.clamp(max=num_buckets - 1)
    return relative_buckets + torch.where(is_small, n, val_if_large)


def bucket_1d(seq_len: int, *, bidirectional: bool, num_buckets: int,
              max_distance: int, device=None) -> torch.Tensor:
    """[L, L] bucket ids for the sequence-distance bias."""
    positions = torch.arange(seq_len, dtype=torch.int32, device=device)
    rel = positions[None, :] - positions[:, None]
    return relative_position_bucket(rel, bidirectional, num_buckets,
                                    max_distance)


def bucket_2d(coord: torch.Tensor, *, scaling_factor: int, num_buckets: int,
              max_distance: int) -> torch.Tensor:
    """[B, L, L] bucket ids for the scaled bbox-centre distance bias."""
    rel = coord[:, None, :] - coord[:, :, None]
    rel = (rel * scaling_factor).to(torch.int32)
    return relative_position_bucket(rel, True, num_buckets, max_distance)


def gather_bias(bucket_table: torch.Tensor,
                buckets: torch.Tensor) -> torch.Tensor:
    """Table [num_buckets, H] looked up at [..., L, L] ids -> [..., H, L, L]."""
    return bucket_table[buckets.long()].movedim(-1, -3)


def bbox_centres(bbox: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, L, 4] boxes -> float32 horizontal / vertical centres [B, L]."""
    hx = ((bbox[..., 0] + bbox[..., 2]) / 2.0).to(torch.float32)
    vy = ((bbox[..., 1] + bbox[..., 3]) / 2.0).to(torch.float32)
    return hx, vy


def encoder_position_bias(bias_1d_table, bias_h_table, bias_v_table,
                          bbox: torch.Tensor, seq_len: int, num_buckets: int,
                          max_distance_1d: int, rel2d_scaling: int,
                          max_distance_2d: int,
                          positions: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Aggregated encoder bias [B or 1, H, L, L] = 1d + horizontal + vertical.
    positions: per-row original indices [B, L] for packed encoders."""
    if positions is None:
        b1 = bucket_1d(seq_len, bidirectional=True, num_buckets=num_buckets,
                       max_distance=max_distance_1d, device=bbox.device)
        out = gather_bias(bias_1d_table, b1)[None]
    else:
        rel = positions[:, None, :] - positions[:, :, None]
        b1 = relative_position_bucket(rel, True, num_buckets, max_distance_1d)
        out = gather_bias(bias_1d_table, b1)
    hx, vy = bbox_centres(bbox)
    bh = bucket_2d(hx, scaling_factor=rel2d_scaling, num_buckets=num_buckets,
                   max_distance=max_distance_2d)
    bv = bucket_2d(vy, scaling_factor=rel2d_scaling, num_buckets=num_buckets,
                   max_distance=max_distance_2d)
    return out + gather_bias(bias_h_table, bh) + gather_bias(bias_v_table, bv)


def bucket_lut(num_buckets: int, max_distance: int,
               device=None) -> torch.Tensor:
    """int32 [2*max_distance + 1] bucket of every distance in
    [-max_distance, max_distance] (bidirectional). Built on the CPU, so the
    slab builders on any device see the CPU's float32 log."""
    rel = torch.arange(-max_distance, max_distance + 1, dtype=torch.int32)
    lut = relative_position_bucket(rel, True, num_buckets, max_distance)
    return lut.to(torch.int32).to(device)


def combined_table(t1: torch.Tensor, th: torch.Tensor, tv: torch.Tensor,
                   num_buckets: int) -> torch.Tensor:
    """tc[h, b1 + nb*bh + nb^2*bv] = (t1 + th) + tv, from [nb, H] tables,
    in float32 (the reference's `_combined_table` add order)."""
    nb = num_buckets
    ci = torch.arange(nb ** 3, device=t1.device)
    t1T, thT, tvT = (t.to(torch.float32).T for t in (t1, th, tv))
    return t1T[:, ci % nb] + thT[:, (ci // nb) % nb] + tvT[:, ci // (nb * nb)]


def bias_scales(tc: torch.Tensor) -> torch.Tensor:
    """Per-head int8 scale [H] = max|combined table [H, nb^3]| / 127."""
    return tc.abs().amax(dim=1) / 127.0 + 1e-12


def encoder_position_bias_chunked_i8(
        bias_1d_table, bias_h_table, bias_v_table, bbox: torch.Tensor,
        attention_mask: Optional[torch.Tensor], seq_len: int,
        num_buckets: int, max_distance_1d: int, rel2d_scaling: int,
        max_distance_2d: int, positions: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 encoder bias slab (plain version of ops.bias_build's kernel).

    Returns (bias_i8 [B, H, L, L], scales [H] f32) with
    bias_i8 = round(((t1[b1] + th[bh]) + tv[bv]) / s_h); no mask baked in
    (the flash kernel applies it from `attention_mask`, which is unused
    here)."""
    del attention_mask
    if num_buckets ** 3 > 65536:
        raise ValueError("int8 bias needs the combined table "
                         f"(num_buckets^3 <= 65536, got {num_buckets})")
    dev = bbox.device
    tc = combined_table(bias_1d_table, bias_h_table, bias_v_table,
                        num_buckets)
    scales = bias_scales(tc)
    tc_i8 = torch.round(tc / scales[:, None]).to(torch.int8)     # [H, nb^3]

    lut1 = bucket_lut(num_buckets, max_distance_1d, dev).long()
    lut2 = bucket_lut(num_buckets, max_distance_2d, dev).long()
    if positions is None:
        pos = torch.arange(seq_len, device=dev)
        rel1 = (pos[None, :] - pos[:, None])[None]                # [1, L, L]
    else:
        pos = positions.long()
        rel1 = pos[:, None, :] - pos[:, :, None]                  # [B, L, L]
    b1 = lut1[rel1.clamp(-max_distance_1d, max_distance_1d)
              + max_distance_1d]
    hx, vy = bbox_centres(bbox)

    def b2(c):
        rel = ((c[:, None, :] - c[:, :, None]) * rel2d_scaling).to(
            torch.int32).clamp(-max_distance_2d, max_distance_2d)
        return lut2[rel.long() + max_distance_2d]

    c = b1 + num_buckets * b2(hx) + num_buckets * num_buckets * b2(vy)
    out = tc_i8[:, c]                                             # [H,B,L,L]
    return out.permute(1, 0, 2, 3).contiguous(), scales


def decoder_position_bias(bias_table: torch.Tensor, seq_len: int,
                          num_buckets: int, max_distance: int
                          ) -> torch.Tensor:
    """Causal T5 self-attention bias [1, H, L, L]."""
    b = bucket_1d(seq_len, bidirectional=False, num_buckets=num_buckets,
                  max_distance=max_distance, device=bias_table.device)
    return gather_bias(bias_table, b)[None]


def mask_bias(attention_mask: torch.Tensor,
              dtype=torch.float32) -> torch.Tensor:
    """[B, L] {0,1} mask -> additive [B, 1, 1, L] bias, finfo(dtype).min on
    masked keys."""
    neg = torch.finfo(dtype).min
    zero = torch.zeros((), dtype=dtype, device=attention_mask.device)
    return torch.where(attention_mask[:, None, None, :] > 0, zero,
                       torch.tensor(neg, dtype=dtype,
                                    device=attention_mask.device))
