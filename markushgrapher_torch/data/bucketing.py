"""Length-bucketed batching for packed serving / eval (a copy of
`markushgrapher_tpu/data/bucketing.py`).

The packed levers (cross_pack_len / encoder_pack_len) truncate the encoder
to a static length sized by the batch's densest page, so at realistic batch
diversity one dense page forces every sample to the full length. Grouping
samples by their valid encoder-position count into a few static buckets lets
sparse and dense pages each pack to their own length.

Reference analog: none; the reference generates per image (HF generate) and
never batches.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def bucket_pack_lengths(
    counts: Sequence[int],
    n_buckets: int,
    round_to: int = 256,
    margin: int = 64,
    cap: Optional[int] = None,
) -> List[Tuple[int, np.ndarray]]:
    """Partition samples into <= n_buckets static pack lengths.

    counts: per-sample valid encoder-position counts
    (models.markushgrapher.encoder_valid_counts). Each sample's minimum
    viable length is round_up(count + margin, round_to) (the same margin/
    rounding the single-bucket packers use), capped at `cap` (the unpacked
    encoder length). Buckets are chosen by exact DP minimizing the total
    padded positions sum(assigned_len) — the quantity the packed decode's
    HBM traffic scales with.

    Returns [(pack_len, sample_indices)] ascending by pack_len; every
    sample appears in exactly one bucket with counts[i] + margin <=
    pack_len (<= cap when capped — the guard the consumer re-checks).
    """
    counts = np.asarray(counts, np.int64)
    if counts.ndim != 1 or counts.size == 0:
        raise ValueError("counts must be a non-empty 1D array")
    if n_buckets < 1:
        raise ValueError("n_buckets must be >= 1")
    targets = -(-(counts + margin) // round_to) * round_to
    if cap is not None:
        targets = np.minimum(targets, cap)
    uniq = np.unique(targets)                      # ascending
    k = min(n_buckets, len(uniq))
    # population per distinct target
    pop = np.array([(targets == u).sum() for u in uniq], np.int64)
    m = len(uniq)
    # DP over partitions of uniq[0..m) into k contiguous groups; group
    # (i..j] costs uniq[j-1] * pop[i..j) (every sample pads to the group's
    # longest target)
    csum = np.concatenate([[0], np.cumsum(pop)])
    INF = float("inf")
    dp = np.full((k + 1, m + 1), INF)
    choice = np.zeros((k + 1, m + 1), np.int64)
    dp[0, 0] = 0.0
    for b in range(1, k + 1):
        for j in range(1, m + 1):
            for i in range(b - 1, j):
                c = dp[b - 1, i] + uniq[j - 1] * (csum[j] - csum[i])
                if c < dp[b, j]:
                    dp[b, j] = c
                    choice[b, j] = i
    # reconstruct boundaries
    bounds = []
    j = m
    for b in range(k, 0, -1):
        i = int(choice[b, j])
        bounds.append((i, j))
        j = i
    bounds.reverse()
    out: List[Tuple[int, np.ndarray]] = []
    for i, j in bounds:
        if i == j:
            continue
        length = int(uniq[j - 1])
        lo = uniq[i]
        sel = np.nonzero((targets >= lo) & (targets <= length))[0]
        out.append((length, sel))
    return out


def order_and_lengths(
    counts: Sequence[int],
    n_buckets: int,
    round_to: int = 256,
    margin: int = 64,
    cap: Optional[int] = None,
) -> Tuple[np.ndarray, List[Tuple[int, int]]]:
    """Convenience: a single processing order (bucket-major, short first)
    plus [(pack_len, n_samples)] per bucket — what a batched eval loop
    needs to walk buckets with per-bucket compiled programs."""
    buckets = bucket_pack_lengths(counts, n_buckets, round_to, margin, cap)
    order = np.concatenate([idx for _, idx in buckets])
    return order, [(ln, len(idx)) for ln, idx in buckets]
