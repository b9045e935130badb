"""The cluster core's launch plan on the CPU, under both element policies
(decode_int4: packed int4 K/V with bf16 scales; decode_i8: int8 K/V with
f32 scales) and for the lattice: the split of the live keys over a
thread-block cluster (`mxu_decode.int4_plan`), the slots of query rows that
share a run of K/V bytes (`mxu_decode.int4_slots`), the refusal limit the
wrapper raises at, the split softmax the kernel runs, emulated in torch
over the plan's ranges against `plain_int4` / `plain_int8`, and the byte
route by which decode_i8 makes int8 values bf16 operands. The kernels
themselves run on the card (tests/test_torch_kernels_cuda.py)."""

import numpy as np
import pytest
import torch

from markushgrapher_torch.ops import mxu_decode as m

H, D = 16, 64
BEAM = tuple(range(H)) * 5
# (name, B, R, G, d, K, scale rows or None (G), head_map, options): row 4's
# five MG forms (greedy cross b8, beam cross over pack 1280 and over the
# greedy pack's 1792 keys, the beam-5 self ring whole, through a row map,
# up to a valid prefix, both), greedy at b48, greedy int4 under block_skip,
# the OCR ring, and the shapes of the card cases
SHAPES = (
    ("mg_cross_b8", 8, H, H, D, 1792, None, None, {}),
    ("mg_cross_b48", 48, H, H, D, 1792, None, None, {}),
    ("beam_cross_1280", 8, 5 * H, H, D, 1280, None, BEAM, {}),
    ("beam_cross_1792", 8, 5 * H, H, D, 1792, None, BEAM, {}),
    ("self_ring", 40, H, H, D, 512, None, None, {}),
    ("self_row_map", 40, H, H, D, 512, None, None,
     dict(row_map=True, block_k=128)),
    ("self_prefix", 40, H, H, D, 512, None, None,
     dict(block_k=128, live_keys=384)),
    ("self_row_map_prefix", 40, H, H, D, 512, None, None,
     dict(row_map=True, block_k=128, live_keys=384)),
    ("greedy_block_skip", 8, H, H, D, 512, None, None,
     dict(block_k=128, live_keys=256)),
    ("ocr_ring", 8, 15, 5, 64, 640, None, None, {}),
    ("ocr_ring_prefix", 8, 15, 5, 64, 640, None, None,
     dict(block_k=128, live_keys=512)),
    ("head_map_any", 3, 4, 4, 64, 700, None, (0, 0, 2, 3), {}),
    ("beam_per_row_scales", 2, 12, 4, 64, 900, 12, tuple(range(4)) * 3, {}),
    ("masked_rows", 2, 8, 4, 64, 1500, None, None, {}),
    ("live_below_block", 4, 8, 8, 64, 512, None, None,
     dict(row_map=True, block_k=128, live_keys=50)),
    ("live_ragged", 2, 4, 4, 64, 1200, None, None, dict(live_keys=1001)),
    ("live_ragged_blocks", 2, 4, 4, 64, 1024, None, None,
     dict(block_k=64, live_keys=716)),
    ("b1_g1", 1, 4, 1, 64, 3000, None, None, {}),
    ("rows_in_three_slots", 2, 24, 2, 32, 600, None, None, {}),
    ("head_dim_256", 2, 4, 2, 256, 1000, 4, None, {}),
    ("small_heads", 3, 8, 8, 4, 256, None, None, {}),
    ("odd_groups_3x16", 3, 15, 3, 16, 640, None, None, {}),
)


def _operands(B, R, G, d, K, srows, opts, device="meta", elem=m.INT4):
    """Operands of one call as `int4_call_plan` checks them (shapes only on
    the meta device) under the element policy; options with row_map=True
    get a zero row map."""
    kw = dict(opts)
    if kw.pop("row_map", False):
        kw["row_map"] = torch.zeros((B, K // kw["block_k"]),
                                    dtype=torch.int32, device=device)
    q = torch.zeros((B, R, d), dtype=torch.bfloat16, device=device)
    kv = torch.zeros((B, K, G * d // elem.per_byte), dtype=torch.int8,
                     device=device)
    sc = torch.zeros((B, srows or G, K), dtype=elem.scale_dtype,
                     device=device)
    bias = torch.zeros((B, 1, K), dtype=torch.float32, device=device)
    return (q, kv, sc, kv, sc, bias), kw


@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_plan_covers_live_keys_in_one_cluster(shape):
    """The ranges cover [0, live) once, none empty, on block_k boundaries
    (or at live) whenever the call has a block size or a row map; at most
    8 CTAs a cluster; each CTA's shared memory as the kernel lays it out,
    within the card's 227 KB."""
    _, B, R, G, d, K, srows, hm, opts = shape
    args, kw = _operands(B, R, G, d, K, srows, opts)
    hmap, block, live, plan = m.int4_call_plan(*args, head_map=hm, **kw)
    ranges = plan.ranges(live)
    assert 1 <= plan.splits <= m.I4_CLUSTER == 8
    assert ranges[0][0] == 0 and ranges[-1][1] == live
    assert all(a < b for a, b in ranges)
    assert all(ranges[i][1] == ranges[i + 1][0]
               for i in range(len(ranges) - 1))
    if "block_k" in kw:
        assert block == kw["block_k"] == plan.seg
        assert all(a % block == 0 for a, _ in ranges)
        assert all(b % block == 0 or b == live for _, b in ranges)
    else:
        assert block == live and plan.chunk % m.I4_GRAIN == 0
    slots = m.int4_slots(R, G, hmap)
    assert plan.rows == max(len(rows) for _, rows, _ in slots) <= m.I4_ROWS
    keys = min(plan.chunk, live)
    srows = m.int4_scale_rows((srows or G) == R, plan.rows, G)
    assert plan.smem == m.int4_smem(d, plan.rows, srows, keys,
                                    plan.seg) <= m.I4_SMEM


def test_plan_grid_covers_the_card():
    """Row 4's greedy cross at b8 (8 samples x 8 byte column blocks, two
    query rows each) takes clusters of 5 ranges of 384 keys: 320 CTAs, at
    least twice the H100's 132 SMs and all resident at once; the OCR ring's
    40 (sample, head) pairs take 7 ranges of 96 keys. At b48 no count is
    resident at once (2 is the fewest whose 896 keys a CTA fit); 4 ranges
    of 448 keys take the fewest waves, 4 of 396 CTAs."""
    cross = m.int4_plan(8, 8, 2, 64, 1792, None, 2)
    assert cross[:2] == (5, 384)
    assert 8 * 8 * cross.splits >= m.I4_CTAS == 2 * 132
    assert 8 * 8 * cross.splits <= m.int4_resident(cross.smem, 64)
    assert m.int4_plan(8, 5, 3, 64, 640)[:2] == (7, 96)
    big = m.int4_plan(48, 8, 2, 64, 1792, None, 2)
    assert big[:2] == (4, 448) and m.int4_resident(big.smem, 64) == 396
    assert m.int4_smem(64, 2, 2, 1792, 1792) > m.I4_SMEM
    assert 48 * 8 * 2 > m.int4_resident(
        m.int4_smem(64, 2, 2, 896, 896), 64)


def _longest(B, R, G, d, srows, opts):
    """The longest live count int4_call_plan accepts at this shape."""
    lo, hi = 1, 20480         # a multiple of every block size used
    args, kw = _operands(B, R, G, d, hi, srows, opts)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        try:
            m.int4_call_plan(*args, live_keys=mid, **kw)
            lo = mid
        except ValueError:
            hi = mid
    return lo


@pytest.mark.parametrize("B,R,G,d,srows,opts", [
    (1, 2, 2, 64, None, {}),
    (8, 80, 16, 64, None, {}),
    (2, 12, 4, 64, 12, {}),
    (2, 4, 2, 256, None, {}),
    (4, 8, 8, 64, None, dict(block_k=128)),
])
def test_refusal_is_the_wrappers(B, R, G, d, srows, opts):
    """At the longest live count the plan fits, the wrapper passes its
    checks and stops only at the CPU tensors; one key more and it refuses
    for shared memory, before any launch. Both limits are the plan's."""
    from markushgrapher_torch.ops import _build

    top = _longest(B, R, G, d, srows, opts)
    unit = opts.get("block_k", m.I4_GRAIN)
    assert top % unit == 0 and top >= 8 * unit
    slots = m.int4_slots(R, G, None)
    rows = max(len(r) for _, r, _ in slots)
    sr = m.int4_scale_rows((srows or G) == R, rows, G)
    m.int4_plan(B, len(slots), rows, d, top, opts.get("block_k"), sr)
    with pytest.raises(ValueError, match="shared memory"):
        m.int4_plan(B, len(slots), rows, d, top + 1, opts.get("block_k"), sr)
    K = -(-(top + 1) // unit) * unit
    args, kw = _operands(B, R, G, d, K, srows, opts, device="cpu")
    _build.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        m._launch_cluster(*args, None, None, kw.get("block_k"), top)
    with pytest.raises(ValueError, match="shared memory"):
        m._launch_cluster(*args, None, None, kw.get("block_k"), top + 1)
    assert _build.LAUNCHES["decode_int4"] == 0


@pytest.mark.parametrize("rows,groups,head_map,want", [
    (16, 16, None, [(c, (c, c + 8), 1) for c in range(8)]),
    (15, 5, None, [(g, (3 * g, 3 * g + 1, 3 * g + 2), 3) for g in range(5)]),
    (80, 16, BEAM, [(c, tuple(range(c, 80, 16)) + tuple(range(c + 8, 80, 16)),
                     5) for c in range(8)]),
    (4, 4, (0, 0, 2, 3), [(0, (0, 1, 2), 2), (1, (3,), 0)]),
    (16, 1, None, [(0, tuple(range(10)), 10), (0, tuple(range(10, 16)), 6)]),
    (5, 2, (1, 0, 1, 1, 0), [(0, (1, 4, 0, 2, 3), 2)]),
    (12, 2, None, [(0, tuple(range(10)), 6), (0, (10, 11), 0)]),
    (9, 3, (0, 2, 2, 0, 1, 1, 2, 0, 0), [(0, (0, 3, 7, 8), 4), (1, (4, 5), 2),
                                        (2, (1, 2, 6), 3)]),
])
def test_slots_invert_the_head_map(rows, groups, head_map, want):
    """Each query row lies in exactly one slot of the bytes that hold its
    head: with G even head c's rows, then head c + G/2's, over bytes
    [c*D, c*D + D); with G odd one head's; at most 10 rows a slot, bytes read
    by no row take none. The kernel's table pads each slot's rows with its
    first."""
    slots = m.int4_slots(rows, groups, head_map)
    assert [tuple(s) for s in slots] == want
    assert sorted(r for _, rs, _ in slots for r in rs) == list(range(rows))
    hm = m._row_groups(rows, groups, head_map).tolist()
    for c, rs, low in slots:
        assert all(hm[r] == c for r in rs[:low])
        assert all(hm[r] == c + groups // 2 for r in rs[low:])
    table = m._int4_slot_table(rows, groups, head_map, "cpu")
    assert table.shape == (len(want), 3 + m.I4_ROWS)
    for (c, rs, low), row in zip(want, table.tolist()):
        assert row == [c, len(rs), low, *rs] + [rs[0]] * (m.I4_ROWS - len(rs))


def _values(t, elem, row_map, block, live, B, groups, d, sel):
    """The live keys' values [B, live, R, d] as each query row reads them:
    unpacked nibbles (int4) or the int8 values."""
    t = m._keys(t, row_map, block, live, 1)
    t = m.unpack_int4(t) if elem.per_byte == 2 else t.float()
    return t.reshape(B, live, groups, d)[:, :, sel]


def _split_softmax(q, kq, ks, vq, vs, bias, head_map=None, row_map=None,
                   block_k=None, live_keys=None, elem=m.INT4):
    """The kernel's arithmetic in torch, CTA by CTA over the plan's ranges:
    each CTA's scores and block maxima, the cluster's maxima exchanged
    (M_last; the running max before a CTA's first block from the CTAs
    before it), the running max M_j of each local block by a scan, p,
    c_j * bf16(p * vs) and the partials, summed over the CTAs in rank order.
    Returns (output, the running max of each key's block [B, R, live])."""
    hm, block, live, plan = m.int4_call_plan(q, kq, ks, vq, vs, bias,
                                             head_map, row_map, block_k,
                                             live_keys, elem)
    B, R, d = q.shape
    groups = kq.shape[2] * elem.per_byte // d
    sel = m._row_groups(R, groups, hm)
    k, v = (_values(t, elem, row_map, block, live, B, groups, d, sel)
            for t in (kq, vq))
    kss, vss = (m._keys(t, row_map, block, live, 2).float() for t in (ks, vs))
    if kss.shape[1] != R:
        kss, vss = kss[:, sel], vss[:, sel]
    qb = q.to(torch.bfloat16).float()
    s = torch.einsum("brd,bkrd->brk", qb, k) * kss + bias[..., :live]
    ranges = plan.ranges(live)
    cmax = [s[..., a:b].amax(-1) for a, b in ranges]
    every = torch.clamp(torch.stack(cmax).amax(0), min=m.NEG_INF)
    acc = torch.zeros((B, R, d))
    l = torch.zeros((B, R))
    mj_all = torch.empty_like(s)
    for rank, (a, b) in enumerate(ranges):
        before = torch.full((B, R), m.NEG_INF)
        for c in cmax[:rank]:
            before = torch.maximum(before, c)
        if block_k is None:
            mj = every[..., None].expand(B, R, b - a)
        else:
            seg_max = torch.stack([s[..., j:min(b, j + block)].amax(-1)
                                   for j in range(a, b, block)], -1)
            run = torch.maximum(before[..., None], torch.cummax(seg_max, -1)[0])
            mj = run.repeat_interleave(block, -1)[..., :b - a]
        mj_all[..., a:b] = mj
        c = torch.exp(mj - every[..., None])
        p = torch.exp(s[..., a:b] - mj)
        l += (p * c).sum(-1)
        term = (p * vss[..., a:b]).to(torch.bfloat16).float() * c
        acc += torch.einsum("brk,bkrd->brd", term, v[:, a:b])
    out = (acc / l.clamp(min=1e-30)[..., None]).to(torch.bfloat16)
    return out.to(q.dtype), mj_all


@pytest.mark.parametrize("opts", [
    {}, dict(live_keys=700), dict(block_k=32), dict(block_k=32, live_keys=500),
    dict(block_k=32, row_map=True), dict(block_k=128, live_keys=70)],
    ids=["one_block", "one_block_live", "blocks", "blocks_live", "row_map",
         "live_below_block"])
def test_split_softmax_keeps_the_plain_rounding_points(opts):
    """Over the plan's split the running max of every key's block is the
    sequential one bit for bit (so p and bf16(p * vs) are the plain
    version's values), and the output is plain_int4's within the kernel
    tolerance; 12 query rows over 4 kv blocks under the beam fold, 1 sample
    so the plan takes 8 CTAs, masked keys at the end."""
    rng = np.random.RandomState(5)
    B, R, G, d, K = 1, 12, 4, 32, 1024
    kw = dict(opts)
    if kw.pop("row_map", False):
        kw["row_map"] = torch.tensor(rng.randint(0, 2, (B, K // 32)),
                                     dtype=torch.int32)
        rows_kv = 2
    else:
        rows_kv = B
    q = torch.tensor(rng.randn(B, R, d), dtype=torch.float32)
    kq, vq = (m.pack_int4(torch.tensor(rng.randint(-7, 8, (rows_kv, K, G * d)),
                                       dtype=torch.int8)) for _ in range(2))
    ks, vs = (torch.tensor(rng.rand(rows_kv, G, K) * 0.2).to(torch.bfloat16)
              for _ in range(2))
    bias = torch.tensor(rng.randn(B, 1, K) * 2, dtype=torch.float32)
    bias[..., -100:] = -1e9
    hm = tuple(range(G)) * 3
    got, mj = _split_softmax(q, kq, ks, vq, vs, bias, hm, **kw)
    _, block, live, plan = m.int4_call_plan(q, kq, ks, vq, vs, bias, hm,
                                            **kw)
    assert plan.splits > 1 or live <= block
    # the running max of the plain version's online softmax, block by block
    run = torch.full((B, R), m.NEG_INF)
    seq = torch.empty_like(mj)
    s = _scores(q, kq, ks, bias, hm, kw.get("row_map"), block, live)
    for j in range(0, live, block):
        run = torch.maximum(run, s[..., j:j + block].amax(-1))
        seq[..., j:j + block] = run[..., None]
    assert torch.equal(mj, seq)
    ref = m.plain_int4(q, kq, ks, vq, vs, bias, hm, **kw)
    torch.testing.assert_close(got.float(), ref.float(), atol=2e-3,
                               rtol=2e-2)


def _scores(q, kq, ks, bias, hm, row_map, block, live, elem=m.INT4):
    """s = (bf16(q) . k) * ks + bias over the live keys, as plain reads
    them."""
    B, R, d = q.shape
    groups = kq.shape[2] * elem.per_byte // d
    sel = m._row_groups(R, groups, hm)
    k = _values(kq, elem, row_map, block, live, B, groups, d, sel)
    kss = m._keys(ks, row_map, block, live, 2).float()
    if kss.shape[1] != R:
        kss = kss[:, sel]
    qb = q.to(torch.bfloat16).float()
    return torch.einsum("brd,bkrd->brk", qb, k) * kss + bias[..., :live]


# -- decode_i8: the Int8 policy of the same core --------------------------------

# (name, B, R, G, d, K, scale rows or None (G), head_map, options): row 5's
# forms (the greedy cross at the batch's pack and at 1792 keys, the beam
# cross over pack 1280 and 1792, the beam-5 self ring whole, through a row
# map, up to a valid prefix, both), the greedy cross at b48 and the beam
# cross at b16, the OCR ring, beam-5 int8 over segments of 128, and the
# card cases' shapes
I8_SHAPES = (
    ("mg_cross_b8_1280", 8, H, H, D, 1280, None, None, {}),
    ("mg_cross_b8_1792", 8, H, H, D, 1792, None, None, {}),
    ("mg_cross_b48", 48, H, H, D, 1792, None, None, {}),
    ("beam_cross_1280", 8, 5 * H, H, D, 1280, None, BEAM, {}),
    ("beam_cross_1792", 8, 5 * H, H, D, 1792, None, BEAM, {}),
    ("beam_cross_b16", 16, 5 * H, H, D, 1792, None, BEAM, {}),
    ("self_ring", 40, H, H, D, 512, None, None, {}),
    ("self_row_map", 40, H, H, D, 512, None, None,
     dict(row_map=True, block_k=128)),
    ("self_prefix", 40, H, H, D, 512, None, None,
     dict(block_k=128, live_keys=384)),
    ("self_row_map_prefix", 40, H, H, D, 512, None, None,
     dict(row_map=True, block_k=128, live_keys=384)),
    ("self_row_map_b16", 80, H, H, D, 512, None, None,
     dict(row_map=True, block_k=128)),
    ("ocr_ring", 8, 15, 5, 64, 640, None, None, {}),
    ("beam_per_row_scales", 2, 12, 4, 64, 900, 12, tuple(range(4)) * 3, {}),
    ("rows_in_three_slots", 2, 24, 1, 32, 600, None, None, {}),
    ("small_heads", 3, 8, 2, 8, 320, None, None, {}),
    ("head_dim_256", 2, 4, 2, 256, 1000, 4, None, {}),
    ("live_ragged_blocks", 2, 4, 4, 64, 1024, None, None,
     dict(block_k=64, live_keys=716)),
)


@pytest.mark.parametrize("shape", I8_SHAPES, ids=[s[0] for s in I8_SHAPES])
def test_int8_plan_covers_live_keys_in_one_cluster(shape):
    """decode_i8's plan: the ranges cover [0, live) once, none empty, on
    block_k boundaries when the call has a block size; at most 8 CTAs a
    cluster; one head a slot; each CTA's shared memory as the kernel lays
    it out with f32 scales, within the card's 227 KB."""
    _, B, R, G, d, K, srows, hm, opts = shape
    args, kw = _operands(B, R, G, d, K, srows, opts, elem=m.INT8)
    hmap, block, live, plan = m.int4_call_plan(*args, head_map=hm, **kw,
                                               elem=m.INT8)
    ranges = plan.ranges(live)
    assert 1 <= plan.splits <= m.I4_CLUSTER
    assert ranges[0][0] == 0 and ranges[-1][1] == live
    assert all(a < b for a, b in ranges)
    assert all(ranges[i][1] == ranges[i + 1][0]
               for i in range(len(ranges) - 1))
    if "block_k" in kw:
        assert block == kw["block_k"] == plan.seg
        assert all(a % block == 0 for a, _ in ranges)
    else:
        assert block == live and plan.chunk % m.I4_GRAIN == 0
    slots = m.int4_slots(R, G, hmap, m.INT8)
    assert all(low == len(rows) for _, rows, low in slots)
    assert plan.rows == max(len(rows) for _, rows, _ in slots) <= m.I4_ROWS
    sr = m.int4_scale_rows((srows or G) == R, plan.rows, G, m.INT8)
    assert sr == (plan.rows if (srows or G) == R else 1)
    keys = min(plan.chunk, live)
    assert plan.smem == m.int4_smem(d, plan.rows, sr, keys, plan.seg,
                                    4) <= m.I4_SMEM
    assert m.int4_smem(d, plan.rows, sr, keys, plan.seg, 4) > m.int4_smem(
        d, plan.rows, sr, keys, plan.seg, 2)


@pytest.mark.parametrize("rows,groups,head_map,want", [
    (16, 16, None, [(g, (g,), 1) for g in range(16)]),
    (80, 16, BEAM, [(g, tuple(range(g, 80, 16)), 5) for g in range(16)]),
    (15, 5, None, [(g, (3 * g, 3 * g + 1, 3 * g + 2), 3) for g in range(5)]),
    (24, 2, None, [(0, tuple(range(10)), 10), (0, tuple(range(10, 12)), 2),
                   (1, tuple(range(12, 22)), 10), (1, (22, 23), 2)]),
    (16, 1, None, [(0, tuple(range(10)), 10), (0, tuple(range(10, 16)), 6)]),
    (4, 4, (0, 0, 2, 3), [(0, (0, 1), 2), (2, (2,), 1), (3, (3,), 1)]),
])
def test_int8_slots_invert_the_head_map(rows, groups, head_map, want):
    """Under int8 a slot is one head's run of D bytes and the rows that
    read that head (greedy: one; the beam fold: the 5 beams; OCR: 3 query
    heads), at most 10 a slot, every row in exactly one slot, unread heads
    in none; the kernel's table has every row as a row of head c."""
    slots = m.int4_slots(rows, groups, head_map, m.INT8)
    assert [tuple(s) for s in slots] == want
    assert sorted(r for _, rs, _ in slots for r in rs) == list(range(rows))
    hm = m._row_groups(rows, groups, head_map).tolist()
    assert all(hm[r] == c for c, rs, _ in slots for r in rs)
    table = m._int4_slot_table(rows, groups, head_map, "cpu", m.INT8)
    for (c, rs, low), row in zip(want, table.tolist()):
        assert row == [c, len(rs), low, *rs] + [rs[0]] * (m.I4_ROWS - len(rs))


@pytest.mark.parametrize("B,R,G,d,srows,hm,opts", [
    (1, 16, 16, 64, None, None, {}),
    (8, 80, 16, 64, None, BEAM, {}),
    (8, 15, 5, 64, None, None, {}),
    (2, 4, 2, 256, 4, None, {}),
    (4, 16, 16, 64, None, None, dict(block_k=128)),
])
def test_int8_refusal_is_the_wrappers(B, R, G, d, srows, hm, opts):
    """decode_i8's refusal limit is its plan's: at the longest live count
    the plan fits, the wrapper stops only at the CPU tensors; one key more
    and it refuses for shared memory, before any launch. At head dim 64
    (every path's) it takes over 11000 keys, more than the paths' longest
    (the 1792-key cross)."""
    from markushgrapher_torch.ops import _build

    lo, hi = 1, 40960
    args, kw = _operands(B, R, G, d, hi, srows, opts, elem=m.INT8)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        try:
            m.int4_call_plan(*args, hm, live_keys=mid, **kw, elem=m.INT8)
            lo = mid
        except ValueError:
            hi = mid
    unit = opts.get("block_k", m.I4_GRAIN)
    assert lo % unit == 0 and hi < 40960 and (d != 64 or lo > 11000)
    K = -(-(lo + 1) // unit) * unit
    args, kw = _operands(B, R, G, d, K, srows, opts, device="cpu",
                         elem=m.INT8)
    _build.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        m._launch_cluster(*args, hm, None, kw.get("block_k"), lo, m.INT8)
    with pytest.raises(ValueError, match="decode_i8: .* shared memory"):
        m._launch_cluster(*args, hm, None, kw.get("block_k"), lo + 1,
                          m.INT8)
    assert _build.LAUNCHES["decode_i8"] == 0


@pytest.mark.parametrize("opts", [
    {}, dict(live_keys=700), dict(block_k=32), dict(block_k=32, live_keys=500),
    dict(block_k=32, row_map=True), dict(block_k=128, live_keys=70)],
    ids=["one_block", "one_block_live", "blocks", "blocks_live", "row_map",
         "live_below_block"])
@pytest.mark.parametrize("per_row", [False, True], ids=["per_head", "per_row"])
def test_split_softmax_int8_keeps_the_plain_rounding_points(opts, per_row):
    """decode_i8 over the plan's split: the running max of every key's
    block is the sequential one bit for bit (so p and bf16(p * vs) are
    plain_int8's values), and the output is plain_int8's within the kernel
    tolerance; 12 query rows over 4 kv heads under the beam fold, the full
    int8 range, f32 scales per head or per query row, masked keys at the
    end."""
    rng = np.random.RandomState(7 + per_row)
    B, R, G, d, K = 1, 12, 4, 32, 1024
    kw = dict(opts)
    if kw.pop("row_map", False):
        kw["row_map"] = torch.tensor(rng.randint(0, 2, (B, K // 32)),
                                     dtype=torch.int32)
        rows_kv = 2
    else:
        rows_kv = B
    q = torch.tensor(rng.randn(B, R, d), dtype=torch.float32)
    kq, vq = (torch.tensor(rng.randint(-128, 128, (rows_kv, K, G * d)),
                           dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.tensor(rng.rand(rows_kv, R if per_row else G, K) * 0.02,
                           dtype=torch.float32) for _ in range(2))
    bias = torch.tensor(rng.randn(B, 1, K) * 2, dtype=torch.float32)
    bias[..., -100:] = -1e9
    hm = tuple(range(G)) * 3
    got, mj = _split_softmax(q, kq, ks, vq, vs, bias, hm, **kw, elem=m.INT8)
    _, block, live, plan = m.int4_call_plan(q, kq, ks, vq, vs, bias, hm,
                                            **kw, elem=m.INT8)
    assert plan.splits > 1 or live <= block
    run = torch.full((B, R), m.NEG_INF)
    seq = torch.empty_like(mj)
    s = _scores(q, kq, ks, bias, hm, kw.get("row_map"), block, live, m.INT8)
    for j in range(0, live, block):
        run = torch.maximum(run, s[..., j:j + block].amax(-1))
        seq[..., j:j + block] = run[..., None]
    assert torch.equal(mj, seq)
    ref = m.plain_int8(q, kq, ks, vq, vs, bias, hm, **kw)
    torch.testing.assert_close(got.float(), ref.float(), atol=2e-3,
                               rtol=2e-2)


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm on uint32 arrays: result byte i is byte
    (sel >> 4i) & 7 of the eight bytes of (x, y)."""
    pool = [(x >> (8 * i)) & 0xFF for i in range(4)] + \
        [(y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(pool[(sel >> (4 * i)) & 7] << np.uint32(8 * i)
               for i in range(4)).astype(np.uint32)


def _bf16_rn(f):
    """float32 -> bf16 bits, round to nearest even (cvt.rn.bf16x2.f32)."""
    u = f.view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint32)


@pytest.mark.parametrize("b0,b1", [(0, 1), (2, 3), (0, 2), (1, 3)])
def test_int8_bf16_route_is_exact(b0, b1):
    """decode_i8's bytes to bf16 operands (decode_cluster.cuh, Int8): u =
    w ^ 0x80808080, byte B of u under the exponent byte of 2^23 (byte
    permute 0x7540 + B with 0x4B000000) is the float 2^23 + x + 128, minus
    2^23 + 128 in float32 is x, and the bf16 pair of two such bytes holds
    both exactly: for all 256 values of every byte of a word, in each byte
    pair the scores and P V take."""
    vals = np.arange(-128, 128, dtype=np.int64)
    other = np.roll(vals, 77)
    # the word: byte b0 takes every value, byte b1 another, the rest fixed
    x = np.zeros((256, 4), dtype=np.int64)
    x[:, :] = np.array([5, -128, 127, -1])
    x[:, b0], x[:, b1] = vals, other
    w = sum(((x[:, i] & 0xFF).astype(np.uint32) << np.uint32(8 * i))
            for i in range(4)).astype(np.uint32)
    u = w ^ np.uint32(0x80808080)
    c = np.full_like(u, 0x4B000000)
    pair = []
    for b in (b0, b1):
        f = _byte_perm(u, c, 0x7540 + b).view(np.float32) - np.float32(
            8388736.0)
        assert f.dtype == np.float32
        assert np.array_equal(f, x[:, b].astype(np.float32))
        pair.append(_bf16_rn(f))
    packed = pair[0] | (pair[1] << np.uint32(16))
    lo = (packed << np.uint32(16)).view(np.float32)
    hi = (packed & np.uint32(0xFFFF0000)).view(np.float32)
    assert np.array_equal(lo, x[:, b0].astype(np.float32))
    assert np.array_equal(hi, x[:, b1].astype(np.float32))
    # torch's bf16 rounding agrees
    assert torch.equal(torch.tensor(x[:, b0], dtype=torch.float32).to(
        torch.bfloat16).float(), torch.tensor(lo))


# -- the lattice on decode_int4's core ------------------------------------------


@pytest.mark.parametrize("rows,ring,seg,n_live", [
    (40, 512, 128, 1), (40, 512, 128, 4), (40, 512, 8, 37), (40, 1024, 512, 2),
    (80, 512, 128, 3)])
def test_lattice_call_plan_is_the_row_mapped_int4_plan(rows, ring, seg, n_live):
    """lattice_self_int4 on the card is decode_int4's call with the row
    map, blocks of one segment and the first n_live segments' keys: the
    same head map, block, live count and launch plan; ranges of whole
    segments, so no CTA reads a dead one."""
    args, kw = _operands(rows, H, H, D, ring, None,
                         dict(row_map=True, block_k=seg))
    rm = kw["row_map"]
    got = m.lattice_call_plan(*args, rm, n_live, seg)
    want = m.int4_call_plan(*args, row_map=rm, block_k=seg,
                            live_keys=n_live * seg)
    assert got == want
    _, block, live, plan = got
    assert (block, live) == (seg, n_live * seg)
    assert all(a % seg == 0 and (b % seg == 0 or b == live)
               for a, b in plan.ranges(live))


@pytest.mark.parametrize("n_live,seg,maps,match", [
    (0, 128, 4, "n_live"), (5, 128, 4, "n_live"), (-1, 128, 4, "n_live"),
    (1, 128, 2, "row_map"), (1, 100, 4, "block_k")])
def test_lattice_refuses_before_launch(n_live, seg, maps, match):
    """n_live outside [1, L / seg], a row map of the wrong shape and a
    segment that does not tile the ring are refused by the plan, before
    the wrapper reaches a device."""
    from markushgrapher_torch.ops import _build

    args, _ = _operands(4, H, H, D, 512, None, {}, device="cpu")
    rm = torch.zeros((4, maps), dtype=torch.int32)
    _build.reset_launches()
    with pytest.raises(ValueError, match=match):
        m.lattice_call_plan(*args, rm, n_live, seg)
    q, kq, ks, vq, vs, bias = args
    with pytest.raises(ValueError, match=match):
        m.lattice_self_int4(q.to("meta"), kq.to("meta"), ks.to("meta"),
                            vq.to("meta"), vs.to("meta"), bias.to("meta"),
                            rm.to("meta"), n_live, seg)
    assert _build.LAUNCHES["lattice_self_int4"] == 0


# resident CTAs of clusters of decode_i8's tensor-core instance that an
# NVIDIA H100 80GB HBM3 reported (cudaOccupancyMaxActiveClusters, through
# decode_bench.py), by (CTAs its shared memory and registers allow an SM,
# CTAs a cluster): clusters of 3 to 8 hold fewer than the SMs' count
H100_RESIDENT = {(1, 1): 132, (1, 2): 132, (2, 2): 264, (2, 3): 237,
                 (3, 1): 396, (3, 3): 372, (3, 4): 368, (3, 5): 345,
                 (3, 6): 372, (4, 1): 528, (4, 2): 528, (4, 3): 489,
                 (4, 4): 496, (4, 5): 470, (4, 6): 474, (4, 7): 483,
                 (4, 8): 496}


@pytest.mark.parametrize("name,want", [("mg_cross_b8_1280", 2),
                                       ("beam_cross_b16", 4),
                                       ("self_ring", 1), ("mg_cross_b48", 5)])
def test_int8_plan_counts_the_cards_clusters(monkeypatch, name, want):
    """On the card decode_i8's plan counts its waves by the clusters the
    card holds (here the counts an H100 reported), and among the fewest
    waves takes the fewest keys a CTA: the greedy cross at the batch's pack
    takes clusters of 2 (256 CTAs, one wave; 3 would be 384 of 372
    resident), the beam cross at b16 clusters of 4 (3 waves), the self ring
    one CTA a (row, head), the cross at b48 clusters of 5 (9 waves, 384
    keys a CTA). decode_int4's rule is untouched."""
    def resident(elem, on_card, rows, d, splits, smem):
        if not (elem.measured and on_card):
            return m.int4_resident(smem, d)
        per_sm = min(4, m.I4_SM_SMEM // (smem + 1024))
        return H100_RESIDENT[per_sm, splits]

    shape = {s[0]: s for s in I8_SHAPES}[name]
    _, B, R, G, d, K, srows, hm, opts = shape
    slots = m.int4_slots(R, G, hm, m.INT8)
    rows = max(len(r) for _, r, _ in slots)
    args = (B, len(slots), rows, d, K, opts.get("block_k"),
            m.int4_scale_rows((srows or G) == R, rows, G, m.INT8), m.INT8)
    m.int4_plan.cache_clear()
    monkeypatch.setattr(m, "_resident_ctas", resident)
    try:
        assert m.int4_plan(*args, True).splits == want
        assert m.int4_plan(8, 8, 2, 64, 1792, None, 2, m.INT4,
                           True)[:2] == (5, 384)
    finally:
        m.int4_plan.cache_clear()
