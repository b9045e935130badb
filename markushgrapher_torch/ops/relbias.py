"""Relative attention bias: T5 bucketing + UDOP's 1D / horizontal / vertical
layout biases (port of `markushgrapher_tpu.ops.relbias`).

Bucket math runs in float32 in the JAX op order, and `(delta * 100)` is
truncated toward zero, so bucket ids are identical to the reference. The
serving slab builders (`encoder_position_bias_chunked_i8`, int8, and
`encoder_position_bias_chunked`, bf16 with the key mask in it) map distances
to buckets through small lookup tables built by `relative_position_bucket`
itself: the table spans +-max_distance and buckets saturate beyond it, so
clamping a distance into the table is exact, and the CUDA kernels
(ops.bias_build, ops.flash_relbias) read the same tables.
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
    hx, vy = bbox_centres(bbox)
    return centre_position_bias(bias_1d_table, bias_h_table, bias_v_table,
                                hx, vy, seq_len, num_buckets,
                                max_distance_1d, rel2d_scaling,
                                max_distance_2d, positions)


def centre_position_bias(bias_1d_table, bias_h_table, bias_v_table,
                         hx: torch.Tensor, vy: torch.Tensor, seq_len: int,
                         num_buckets: int, max_distance_1d: int,
                         rel2d_scaling: int, max_distance_2d: int,
                         positions: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """`encoder_position_bias` from the float32 bbox centres [B, L]."""
    if positions is None:
        b1 = bucket_1d(seq_len, bidirectional=True, num_buckets=num_buckets,
                       max_distance=max_distance_1d, device=hx.device)
        out = gather_bias(bias_1d_table, b1)[None]
    else:
        rel = positions[:, None, :] - positions[:, :, None]
        b1 = relative_position_bucket(rel, True, num_buckets, max_distance_1d)
        out = gather_bias(bias_1d_table, b1)
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
    if nb ** 3 > 65536:
        raise ValueError("the serving slabs need the combined table "
                         f"(num_buckets^3 <= 65536, got {nb})")
    ci = torch.arange(nb ** 3, device=t1.device)
    t1T, thT, tvT = (t.to(torch.float32).T for t in (t1, th, tv))
    return t1T[:, ci % nb] + thT[:, (ci // nb) % nb] + tvT[:, ci // (nb * nb)]


class CombinedIndex:
    """Index b1 + nb*bh + nb^2*bv into `combined_table` of query rows
    [q0, q1) against every key: [1 or B, q1 - q0, L] int64. Buckets come
    from the `bucket_lut` tables (distances clamped into them, which is
    exact); the 2d distance is int((c_k - c_q) * rel2d_scaling) in float32,
    truncated toward zero, as in `bucket_2d`. positions: per-row original
    indices [B, L] for packed encoders."""

    def __init__(self, bbox: torch.Tensor, seq_len: int, num_buckets: int,
                 max_distance_1d: int, rel2d_scaling: int,
                 max_distance_2d: int,
                 positions: Optional[torch.Tensor] = None):
        dev = bbox.device
        self.nb, self.scaling = num_buckets, rel2d_scaling
        self.md1, self.md2 = max_distance_1d, max_distance_2d
        self.lut1 = bucket_lut(num_buckets, max_distance_1d, dev).long()
        self.lut2 = bucket_lut(num_buckets, max_distance_2d, dev).long()
        self.pos = (torch.arange(seq_len, device=dev)[None]
                    if positions is None else positions.long())  # [1|B, L]
        self.hx, self.vy = bbox_centres(bbox)

    def _b2(self, c: torch.Tensor, q0: int, q1: int) -> torch.Tensor:
        rel = ((c[:, None, :] - c[:, q0:q1, None]) * self.scaling).to(
            torch.int32).clamp(-self.md2, self.md2)
        return self.lut2[rel.long() + self.md2]

    def __call__(self, q0: int, q1: int) -> torch.Tensor:
        rel1 = self.pos[:, None, :] - self.pos[:, q0:q1, None]
        b1 = self.lut1[rel1.clamp(-self.md1, self.md1) + self.md1]
        nb = self.nb
        return (b1 + nb * self._b2(self.hx, q0, q1)
                + nb * nb * self._b2(self.vy, q0, q1))


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
    tc = combined_table(bias_1d_table, bias_h_table, bias_v_table,
                        num_buckets)
    scales = bias_scales(tc)
    tc_i8 = torch.round(tc / scales[:, None]).to(torch.int8)     # [H, nb^3]
    index = CombinedIndex(bbox, seq_len, num_buckets, max_distance_1d,
                          rel2d_scaling, max_distance_2d, positions)
    out = tc_i8[:, index(0, seq_len)]                             # [H,B,L,L]
    return out.permute(1, 0, 2, 3).contiguous(), scales


def encoder_position_bias_chunked(
        bias_1d_table, bias_h_table, bias_v_table, bbox: torch.Tensor,
        attention_mask: torch.Tensor, seq_len: int, num_buckets: int,
        max_distance_1d: int, rel2d_scaling: int, max_distance_2d: int,
        chunk: int = 0, out_dtype=torch.bfloat16, mask_value: float = -1e9,
        positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The float serving slab [B, H, L, L] in `out_dtype` (the reference's
    `relbias.encoder_position_bias_chunked`, read by every layer's
    `flash_attention.flash_attention_bias`): ((t1[b1] + th[bh]) + tv[bv])
    in float32, `mask_value` on keys where `attention_mask` is 0, then cast.
    positions: per-row original indices [B, L] for packed encoders.

    Built one query chunk at a time (chunk=0: 256 rows up to batch 16, 64
    above, as the reference sizes it), so the transients stay ~chunk * L per
    row, and written straight into the [B, H, L, L] layout the flash kernel
    streams. Buckets index the combined table, as in
    `encoder_position_bias_chunked_i8`."""
    batch, heads = bbox.shape[0], bias_1d_table.shape[-1]
    if chunk <= 0:
        chunk = 256 if batch <= 16 else 64
    tc = combined_table(bias_1d_table, bias_h_table, bias_v_table,
                        num_buckets)                              # [H, nb^3]
    index = CombinedIndex(bbox, seq_len, num_buckets, max_distance_1d,
                          rel2d_scaling, max_distance_2d, positions)
    keep = (attention_mask > 0)[None, :, None, :]                 # [1,B,1,L]
    out = torch.empty((batch, heads, seq_len, seq_len), dtype=out_dtype,
                      device=bbox.device)
    for q0 in range(0, seq_len, chunk):
        q1 = min(q0 + chunk, seq_len)
        full = torch.where(keep, tc[:, index(q0, q1)], mask_value)
        out[:, :, q0:q1] = full.transpose(0, 1).to(out_dtype)    # [B,H,c,L]
    return out


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


class _TableBias(torch.autograd.Function):
    """((t1[b1] + th[bh]) + tv[bv]) in float32, `mask_value` where `keep` is
    false, cast to `out_dtype`. Backward: each [nb, H] table gradient as a
    float32 product of the masked slab gradient with the one-hot of its
    buckets (the reference's one-hot formulation), not an index scatter: the
    autograd scatter of 19M positions into 32 buckets sorts them and then
    sums each bucket's long run serially."""

    @staticmethod
    def forward(ctx, t1, th, tv, b1, bh, bv, keep, mask_value, out_dtype):
        full = (gather_bias(t1, b1)[None] + gather_bias(th, bh)) \
            + gather_bias(tv, bv)
        ctx.save_for_backward(b1, bh, bv, keep)
        ctx.num_buckets = t1.shape[0]
        # the gathers leave heads minormost in memory: lay the slab out
        # [B, H, L, L] once here, not in every layer's attention call
        return torch.where(keep, full, mask_value).to(
            out_dtype, memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, grad):
        b1, bh, bv, keep = ctx.saved_tensors
        nb = ctx.num_buckets
        with torch.autocast(grad.device.type, enabled=False):
            g = torch.where(keep, grad.to(torch.float32), 0.0)
            g = g.reshape(g.shape[0], g.shape[1], -1)           # [B, H, L*L]

            def table_grad(gh, idx):                            # [H, N], [N]
                onehot = torch.zeros((idx.numel(), nb), device=gh.device)
                onehot.scatter_(1, idx.reshape(-1, 1).long(), 1.0)
                return (gh @ onehot).T                          # [nb, H]

            d1 = table_grad(g.sum(dim=0), b1)
            dh = sum(table_grad(g[b], bh[b]) for b in range(g.shape[0]))
            dv = sum(table_grad(g[b], bv[b]) for b in range(g.shape[0]))
        return d1, dh, dv, None, None, None, None, None, None


def encoder_position_bias_onehot(bias_1d_table, bias_h_table, bias_v_table,
                                 bbox: torch.Tensor,
                                 attention_mask: torch.Tensor, seq_len: int,
                                 num_buckets: int, max_distance_1d: int,
                                 rel2d_scaling: int, max_distance_2d: int,
                                 mask_value: float = -1e9,
                                 out_dtype=torch.bfloat16) -> torch.Tensor:
    """Differentiable encoder bias [B, H, L, L] with the key mask folded in:
    ((t1[b1] + th[bh]) + tv[bv]) in float32, `mask_value` on masked keys,
    then cast to `out_dtype` (the reference's training slab,
    `relbias.encoder_position_bias_onehot`, whose one-hot products give the
    same sums). The sums are built in float32 and cast afterwards, and the
    three [nb, H] table gradients accumulate in float32 (`_TableBias`)."""
    t1, th, tv = (t.to(torch.float32) for t in (bias_1d_table, bias_h_table,
                                                bias_v_table))
    b1 = bucket_1d(seq_len, bidirectional=True, num_buckets=num_buckets,
                   max_distance=max_distance_1d, device=bbox.device)
    hx, vy = bbox_centres(bbox)
    bh = bucket_2d(hx, scaling_factor=rel2d_scaling, num_buckets=num_buckets,
                   max_distance=max_distance_2d)
    bv = bucket_2d(vy, scaling_factor=rel2d_scaling, num_buckets=num_buckets,
                   max_distance=max_distance_2d)
    keep = attention_mask[:, None, None, :] > 0
    return _TableBias.apply(t1, th, tv, b1, bh, bv, keep, mask_value,
                            out_dtype)
