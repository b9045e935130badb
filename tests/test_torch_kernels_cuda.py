"""The port's CUDA kernels against their plain PyTorch versions on the card.

Needs an NVIDIA Hopper GPU and nvcc; everywhere else each test skips. On the
card: `python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py`
(`--noconftest`: the repo's conftest imports jax, which the card's machine
does not have)."""

import os
import sys

import numpy as np
import pytest
import torch

from markushgrapher_torch.ops import _build, bias_build, flash_attention
from markushgrapher_torch.ops import flash_relbias, megastep, mxu_decode

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's Hopper kernels)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke

    return chip_smoke


def test_main_path_shapes(dev, chip_smoke):
    """Each kernel at the main path's shapes, with chip_smoke's tolerances."""
    res = chip_smoke.check_kernels(dev, pack=1280)
    res.update(chip_smoke.check_ocr_kernels(dev, chip_smoke.ocr_model(dev)))
    assert set(res) == set(chip_smoke.KERNELS) - set(chip_smoke.FLASH_BIAS) \
        - {"flash_relbias"}


def test_bias_builder_packed_positions(dev):
    rng = np.random.RandomState(0)
    B, L, H = 2, 320, 16
    tabs = [torch.tensor(rng.randn(32, H), dtype=torch.float32, device=dev)
            for _ in range(3)]
    bbox = torch.tensor(rng.rand(B, L, 4), dtype=torch.float32, device=dev)
    pos = torch.tensor(np.stack([np.sort(rng.permutation(3 * L)[:L])
                                 for _ in range(B)]), device=dev)
    args = (*tabs, bbox, None, L, 32, 128, 100, 100)
    got, s = bias_build.encoder_position_bias_kernel_i8(*args, positions=pos)
    ref, s_ref = bias_build.plain(*args, positions=pos)
    assert torch.equal(got, ref) and torch.equal(s, s_ref)


def _bias_args(dev, rng, batch, length, heads=16, dtype=torch.float32,
               packed=False):
    tabs = [torch.tensor(rng.randn(32, heads) * 0.5, device=dev).to(dtype)
            for _ in range(3)]
    bbox = torch.tensor(np.sort(rng.rand(batch, length, 4), axis=-1),
                        dtype=torch.float32, device=dev)
    bbox[:, length // 2: length // 2 + 17] = 0.0       # padded slots
    pos = None
    if packed:
        pos = torch.tensor(np.stack([np.sort(rng.permutation(3 * length)[
            :length]) for _ in range(batch)]), dtype=torch.int32, device=dev)
    return (*tabs, bbox, None, length, 32, 128, 100, 100), pos


@pytest.mark.parametrize("length", [200, 320])
@pytest.mark.parametrize("packed", [False, True])
def test_bias_build_ragged_lengths(dev, length, packed):
    """L = 200 is no multiple of 16 (byte stores, a ragged last item);
    L = 320 is (16-byte row stores); with and without positions. Three
    samples, so CTAs' item ranges cross samples."""
    args, pos = _bias_args(dev, np.random.RandomState(length + packed), 3,
                           length, packed=packed)
    _build.reset_launches()
    got, s = bias_build.encoder_position_bias_kernel_i8(*args, positions=pos)
    assert _build.LAUNCHES["bias_build_i8"] == 1
    ref, s_ref = bias_build.plain(*args, positions=pos)
    assert torch.equal(got, ref) and torch.equal(s, s_ref)


@pytest.mark.parametrize("heads,dtype", [(6, torch.bfloat16),
                                         (12, torch.float16),
                                         (16, torch.bfloat16)])
def test_bias_build_heads_and_table_types(dev, heads, dtype):
    """Head counts that pad to 4 (6: a group of 2 heads, 12: three groups),
    tables read in their own type (float16: converted to float32 first)."""
    args, pos = _bias_args(dev, np.random.RandomState(heads), 2, 256,
                           heads=heads, dtype=dtype)
    got, s = bias_build.encoder_position_bias_kernel_i8(*args)
    ref, s_ref = bias_build.plain(*args)
    assert torch.equal(got, ref) and torch.equal(s, s_ref)


def test_bias_build_scales_and_half_integers(dev):
    """Table maxima whose amax / 127 and amax * f32(1/127) round apart (the
    scale is the plain version's on the card), and values whose quotient by
    the scale lies on a half-integer or one ulp beside it (rint's ties to
    even)."""
    rng = np.random.RandomState(7)
    inv = np.float32(1) / np.float32(127)
    cand = rng.uniform(1, 100, 200000).astype(np.float32)
    apart = cand[(cand / np.float32(127)) != (cand * inv)][:16]
    assert len(apart) == 16
    t1 = rng.uniform(-1, 1, (32, 16)).astype(np.float32)
    t1[0] = apart
    for h in range(16):
        s = np.float32(np.float32(apart[h] * inv) + np.float32(1e-12))
        for n, k in enumerate(range(-60, 60, 8)):
            v0 = np.float32(np.float32(k + 0.5) * s)
            t1[1 + n, h] = np.nextafter(v0, np.float32(np.inf * (n % 3 - 1)),
                                        dtype=np.float32) if n % 3 != 1 else v0
    zeros = torch.zeros((32, 16), device=dev)
    tabs = (torch.tensor(t1, device=dev), zeros, zeros)
    bbox = torch.tensor(np.sort(rng.rand(2, 256, 4), axis=-1),
                        dtype=torch.float32, device=dev)
    args = (*tabs, bbox, None, 256, 32, 128, 100, 100)
    got, s = bias_build.encoder_position_bias_kernel_i8(*args)
    ref, s_ref = bias_build.plain(*args)
    assert torch.equal(s, s_ref) and torch.equal(got, ref)


def test_bias_build_one_launch_no_copy(dev):
    """After the first call (device LUTs cached, the card's occupancy
    asked), a call makes at most two kernel launches (the table kernel and
    the slab kernel), both of bias_build_i8, and no host -> device copy."""
    from torch.profiler import ProfilerActivity, profile

    args, pos = _bias_args(dev, np.random.RandomState(3), 2, 512, packed=True)
    bias_build.encoder_position_bias_kernel_i8(*args, positions=pos)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        bias_build.encoder_position_bias_kernel_i8(*args, positions=pos)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [n for n in names if not n.startswith(("Memcpy", "Memset"))]
    assert len(kernels) <= 2, kernels
    assert kernels and all("bias_build" in n for n in kernels), kernels
    assert not [n for n in names if "HtoD" in n], names


def test_bias_build_refuses_before_launch(dev):
    """A length whose centres do not fit a CTA's shared memory."""
    args, _ = _bias_args(dev, np.random.RandomState(5), 1, 16384)
    _build.reset_launches()
    with pytest.raises(ValueError, match="shared memory"):
        bias_build.encoder_position_bias_kernel_i8(*args)
    assert _build.LAUNCHES["bias_build_i8"] == 0


def test_flash_ragged_length(dev):
    """L = 200 is no multiple of the 64-row tiles: the edges are masked."""
    rng = np.random.RandomState(1)
    B, L, H, D = 1, 200, 4, 64
    q, k, v = (torch.tensor(rng.randn(B, L, H, D) * 0.3, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    bias = torch.tensor(rng.randint(-127, 128, (B, H, L, L)),
                        dtype=torch.int8, device=dev)
    scales = torch.full((H,), 0.02, device=dev)
    mask = torch.ones((B, L), dtype=torch.int32, device=dev)
    mask[:, 150:] = 0
    got = flash_attention.flash_attention_bias_i8(q, k, v, bias, scales, mask)
    ref = flash_attention.plain(q, k, v, bias, scales, mask)
    torch.testing.assert_close(got.float(), ref.float(), atol=1e-3,
                               rtol=1.6e-2)


def test_decode_small_heads(dev):
    """Tiny head dim (D = 4, H = 8) and a [1, 1, K] bias broadcast."""
    rng = np.random.RandomState(2)
    B, H, D, K = 3, 8, 4, 256
    q = torch.tensor(rng.randn(B, H, D), dtype=torch.float32, device=dev)
    kq, vq = (mxu_decode.pack_int4(torch.tensor(
        rng.randint(-7, 8, (B, K, H * D)), dtype=torch.int8, device=dev))
        for _ in range(2))
    ks, vs = (torch.tensor(rng.rand(B, H, K) * 0.2, device=dev)
              .to(torch.bfloat16) for _ in range(2))
    bias = torch.zeros((1, 1, K), device=dev)
    got = mxu_decode.cross_decode_mxu_int4(q, kq, ks, vq, vs, bias)
    ref = mxu_decode.plain_int4(q, kq, ks, vq, vs, bias)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, ref, atol=2e-3, rtol=2e-2)


@pytest.mark.parametrize("case", ["grouped", "beam", "per_head_bias"])
def test_decode_i8_layouts(dev, case):
    """decode_i8 with grouped kv blocks (G < R), the beam head map with
    per-block scales, and the self ring's per-head causal bias with a
    zero-scale unwritten tail; full int8 range; tiny head dim D = 8 takes
    the 4-byte loads."""
    rng = np.random.RandomState(3)
    B, D, K = 3, 8, 320
    rows, groups, head_map = {"grouped": (8, 2, None),
                              "beam": (12, 4, tuple(range(4)) * 3),
                              "per_head_bias": (8, 8, None)}[case]
    q = torch.tensor(rng.randn(B, rows, D), dtype=torch.float32, device=dev)
    kq, vq = (torch.tensor(rng.randint(-127, 128, (B, K, groups * D)),
                           dtype=torch.int8, device=dev) for _ in range(2))
    srows = groups if case == "beam" else rows
    ks, vs = (torch.tensor(rng.rand(B, srows, K) * 0.02, dtype=torch.float32,
                           device=dev) for _ in range(2))
    if case == "per_head_bias":
        step = 200
        bias = torch.tensor(rng.randn(1, rows, K) * 0.5, dtype=torch.float32,
                            device=dev)
        bias[:, :, step + 1:] = torch.finfo(torch.float32).min
        ks[:, :, step + 1:] = 0.0
        vs[:, :, step + 1:] = 0.0
        kq[:, step + 1:] = 0
        vq[:, step + 1:] = 0
    else:
        bias = torch.zeros((B, 1, K), device=dev)
        bias[:, :, -50:] = -1e9
    _build.reset_launches()
    got = mxu_decode.cross_decode_mxu(q, kq, ks, vq, vs, bias,
                                      head_map=head_map)
    assert _build.LAUNCHES["decode_i8"] == 1
    ref = mxu_decode.plain_int8(q, kq, ks, vq, vs, bias, head_map=head_map)
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, ref, atol=2e-3, rtol=2e-2)


def test_decode_int4_head_map(dev):
    """decode_int4 with the beam head map (3 beams over a 4-head packed
    slab), per-block bf16 scales, bf16 query and output."""
    rng = np.random.RandomState(4)
    B, H, D, K, beams = 2, 4, 64, 512, 3
    head_map = tuple(range(H)) * beams
    q = torch.tensor(rng.randn(B, beams * H, D), device=dev).to(
        torch.bfloat16)
    kq, vq = (mxu_decode.pack_int4(torch.tensor(
        rng.randint(-7, 8, (B, K, H * D)), dtype=torch.int8, device=dev))
        for _ in range(2))
    ks, vs = (torch.tensor(rng.rand(B, H, K) * 0.2, device=dev)
              .to(torch.bfloat16) for _ in range(2))
    bias = torch.zeros((B, 1, K), device=dev)
    bias[:, :, -70:] = -1e9
    got = mxu_decode.cross_decode_mxu_int4(q, kq, ks, vq, vs, bias,
                                           head_map=head_map)
    ref = mxu_decode.plain_int4(q, kq, ks, vq, vs, bias, head_map=head_map)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), ref.float(), atol=2e-3,
                               rtol=2e-2)


def test_decode_i8_refuses_too_many_keys(dev):
    """Past the cluster's shared memory (13056 keys at one query row a
    head of 64) the wrapper refuses before any launch."""
    q = torch.zeros((1, 16, 64), dtype=torch.bfloat16, device=dev)
    kv = torch.zeros((1, 16384, 1024), dtype=torch.int8, device=dev)
    sc = torch.zeros((1, 16, 16384), device=dev)
    _build.reset_launches()
    with pytest.raises(ValueError, match="shared memory"):
        mxu_decode.cross_decode_mxu(q, kv, sc, kv, sc,
                                    torch.zeros((1, 1, 16384), device=dev))
    assert _build.LAUNCHES["decode_i8"] == 0


def test_wrappers_count_and_refuse(dev):
    _build.reset_launches()
    q = torch.zeros((1, 64, 2, 32), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="head dim 64"):
        flash_attention.flash_attention_bias_i8(
            q, q, q, torch.zeros((1, 2, 64, 64), dtype=torch.int8,
                                 device=dev),
            torch.ones(2, device=dev), torch.ones((1, 64), device=dev))
    assert _build.LAUNCHES["flash_i8"] == 0


@pytest.mark.parametrize("groups,d", [(5, 64), (3, 16), (5, 8)])
def test_decode_int4_odd_groups(dev, groups, d):
    """Odd kv-head counts: a head's D nibbles straddle the column split at
    G*D/2 (5 x 64: head 2; 3 x 16: head 1; 5 x 8: head 2), 15 query rows
    grouped over them, the self ring's causal bias and zero tail."""
    rng = np.random.RandomState(groups * d)
    B, R, K, step = 3, 15, 640, 400
    q = torch.tensor(rng.randn(B, R, d), device=dev).to(torch.bfloat16)
    vals = rng.randint(-7, 8, (2, B, K, groups * d))
    vals[:, :, step + 1:] = 0
    kq, vq = (mxu_decode.pack_int4(torch.tensor(v, dtype=torch.int8,
                                                device=dev)) for v in vals)
    sc = rng.rand(2, B, groups, K) * 0.2
    sc[:, :, :, step + 1:] = 0
    ks, vs = (torch.tensor(s_, device=dev).to(torch.bfloat16) for s_ in sc)
    bias = torch.full((1, 1, K), torch.finfo(torch.float32).min, device=dev)
    bias[..., :step + 1] = 0.0
    _build.reset_launches()
    got = mxu_decode.cross_decode_mxu_int4(q, kq, ks, vq, vs, bias)
    assert _build.LAUNCHES["decode_int4"] == 1
    ref = mxu_decode.plain_int4(q, kq, ks, vq, vs, bias)
    torch.testing.assert_close(got.float(), ref.float(), atol=2e-3,
                               rtol=2e-2)


def _int4_call(dev, rng, B, R, G, d, K, *, scale_rows=None, bias_shape=None,
               rows_kv=None, q_dtype=torch.bfloat16, int8=False):
    """decode_int4 operands: q [B, R, d], packed K/V [rows_kv or B, K, G*d/2]
    with values in [-7, 7], bf16 scales [rows, scale_rows or G, K], a bias of
    bias_shape (default [B, 1, K]) at 0.5 scale. int8: decode_i8 operands
    instead, K/V [rows, K, G*d] over the full int8 range and f32 scales."""
    rows_kv = B if rows_kv is None else rows_kv
    q = torch.tensor(rng.randn(B, R, d), device=dev).to(q_dtype)
    if int8:
        kq, vq = (torch.tensor(rng.randint(-128, 128, (rows_kv, K, G * d)),
                               dtype=torch.int8, device=dev)
                  for _ in range(2))
        ks, vs = (torch.tensor(rng.rand(rows_kv, scale_rows or G, K) * 0.02,
                               dtype=torch.float32, device=dev)
                  for _ in range(2))
    else:
        kq, vq = (mxu_decode.pack_int4(torch.tensor(
            rng.randint(-7, 8, (rows_kv, K, G * d)), dtype=torch.int8,
            device=dev)) for _ in range(2))
        ks, vs = (torch.tensor(rng.rand(rows_kv, scale_rows or G, K) * 0.2,
                               device=dev).to(torch.bfloat16)
                  for _ in range(2))
    bias = torch.tensor(rng.randn(*(bias_shape or (B, 1, K))) * 0.5,
                        dtype=torch.float32, device=dev)
    return q, kq, ks, vq, vs, bias


def _int4_case(dev, case, int8=False):
    """(operands, options) of one test_decode_int4_cases case (int8: of
    test_decode_i8_cases)."""
    rng = np.random.RandomState(len(case) * 7 + sum(map(ord, case)))

    def call(*args, **kw):
        return _int4_call(dev, rng, *args, int8=int8, **kw)

    if case == "head_map_any":          # two rows on block 0, block 1 unread
        return call(3, 4, 4, 64, 700), dict(head_map=(0, 0, 2, 3))
    if case == "beam_per_row_scales":   # 3 beams over 4 heads, [B, R, K]
        return call(2, 12, 4, 64, 900, scale_rows=12), dict(
            head_map=tuple(range(4)) * 3)
    if case == "bias_1RK":
        return call(3, 8, 8, 64, 777, bias_shape=(1, 8, 777)), {}
    if case == "bias_B1K":
        args = call(3, 8, 8, 64, 777)
        args[-1][:, :, -90:] = -1e9
        return args, {}
    if case == "masked_rows":           # -1e9 (uniform) and float32's lowest
        args = call(2, 8, 4, 64, 1500, bias_shape=(2, 8, 1500))
        args[-1][0, 1] = -1e9
        args[-1][1, 6] = torch.finfo(torch.float32).min
        return args, {}
    if case == "live_below_block":      # one block, fewer keys than block_k
        args = call(4, 8, 8, 64, 512)
        rm = torch.tensor(rng.randint(0, 4, (4, 4)), dtype=torch.int32,
                          device=dev)
        return args, dict(row_map=rm, block_k=128, live_keys=50)
    if case == "live_ragged":           # 1001 keys in ranges of 32s
        return call(2, 4, 4, 64, 1200), dict(live_keys=1001)
    if case == "live_ragged_blocks":    # 11 blocks of 64 and 12 keys
        return call(2, 4, 4, 64, 1024), dict(block_k=64, live_keys=716)
    if case == "b1_g1":
        return call(1, 4, 1, 64, 3000), {}
    if case == "row_map_one_row":       # every block from physical row 2
        rm = torch.full((4, 8), 2, dtype=torch.int32, device=dev)
        return call(4, 8, 8, 64, 512, rows_kv=4), dict(row_map=rm,
                                                       block_k=64)
    if case == "out_f32":
        return call(3, 16, 16, 64, 1792, q_dtype=torch.float32), {}
    if case == "out_bf16":
        return call(3, 16, 16, 64, 1792), {}
    if case == "rows_in_three_slots":   # 24 rows on one byte block (int4)
        return call(2, 24, 2, 32, 600), {}
    if case == "head_dim_256":
        return call(2, 4, 2, 256, 1000, scale_rows=4), {}
    if case == "small_heads":           # D 8: the CUDA cores, 4-byte copies
        return call(3, 8, 2, 8, 320), {}
    if case == "head_dim_128":          # the CUDA cores, 16-byte copies
        return call(2, 8, 4, 128, 900), {}
    if case == "ocr_gqa":               # 15 query heads over 5 kv heads
        args = call(8, 15, 5, 64, 640, bias_shape=(1, 1, 640))
        args[-1][..., 504:] = torch.finfo(torch.float32).min
        return args, {}
    if case == "beam_cross_b16":        # several waves, 5 beams a slot
        args = call(16, 80, 16, 64, 1792)
        args[-1][:, :, 1692:] = -1e9
        return args, dict(head_map=tuple(range(16)) * 5)
    if case.startswith("stream_rows"):  # continuous batching's OCR ring
        # rows at their own positions (a per-row mask [B, 1, S]): long rows
        # beside rows refilled far below the batch's largest slot, whose
        # keys past their own slot hold another image's leftovers
        args = call(8, 15, 5, 64, 512)
        slots = torch.tensor([300, 105, 290, 103, 120, 299, 110, 200],
                             device=dev)
        keys = torch.arange(512, device=dev)
        args[-1][:] = torch.where(keys <= slots[:, None, None], 0.0,
                                  torch.finfo(torch.float32).min)
        return args, (mxu_decode.valid_prefix_blocks(512, 300, 128)
                      if case == "stream_rows_live" else {})
    if case == "ocr_ring_bench":        # decode_bench.py's seeded OCR ring
        sys.path.insert(0, os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        import decode_bench

        return {label: (args, kw) for label, args, kw in decode_bench.shapes(
            dev, "i8")}["OCR ring B=8 R=15 G=5 S=640"]
    raise KeyError(case)


INT4_CASES = ("head_map_any", "beam_per_row_scales", "bias_1RK", "bias_B1K",
              "masked_rows", "live_below_block", "live_ragged",
              "live_ragged_blocks", "b1_g1", "row_map_one_row", "out_f32",
              "out_bf16", "rows_in_three_slots", "head_dim_256",
              "stream_rows", "stream_rows_live")


@pytest.mark.parametrize("case", INT4_CASES)
def test_decode_int4_cases(dev, case):
    """Each option of decode_int4 and each edge of its key split against
    plain_int4, in one launch: any head map, per-query-row scales under the
    beam fold, both bias broadcasts, rows masked everywhere, a live count
    below one block or no multiple of the split, B = 1 with G = 1, a row map
    onto one physical row, float32 and bf16 output, more rows on a byte
    block than one CTA serves (slots of 10, 10 and 4 rows, the second
    reading both nibbles), head dim 256, and the OCR ring of continuous
    batching (rows at their own positions under a per-row mask, refilled
    rows far below the largest slot, with and without live keys at its
    block)."""
    args, kw = _int4_case(dev, case)
    _build.reset_launches()
    got = mxu_decode.cross_decode_mxu_int4(*args, **kw)
    assert _build.LAUNCHES["decode_int4"] == 1
    ref = mxu_decode.plain_int4(*args, **kw)
    assert got.dtype == args[0].dtype and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), ref.float(), atol=2e-3,
                               rtol=2e-2)


I8_CASES = INT4_CASES + ("small_heads", "head_dim_128", "ocr_gqa",
                         "beam_cross_b16", "ocr_ring_bench")


@pytest.mark.parametrize("case", I8_CASES)
def test_decode_i8_cases(dev, case):
    """decode_i8, the Int8 policy of the cluster core, against plain_int8
    in one launch at each of test_decode_int4_cases' options and split
    edges, over the full int8 range with f32 scales (with int8 one head a
    slot: the 24 rows over 2 heads take slots of 10 and 2 rows each), and
    at head dims 8 and 128 (the CUDA cores), the OCR GQA, the beam cross
    at b16 and decode_bench.py's seeded OCR ring (B=8, 15 rows over 5 kv
    heads, S=640, position 503, full-range int8, q at 0.5 scale and a
    random bias, where a one-ulp move of a score used to flip a bf16(p *
    vs) that decided two outputs)."""
    args, kw = _int4_case(dev, case, int8=True)
    _build.reset_launches()
    got = mxu_decode.cross_decode_mxu(*args, **kw)
    assert _build.LAUNCHES["decode_i8"] == 1
    ref = mxu_decode.plain_int8(*args, **kw)
    assert got.dtype == args[0].dtype and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), ref.float(), atol=2e-3,
                               rtol=2e-2)


def test_decode_i8_longest_live_and_one_more(dev):
    """The longest valid prefix decode_i8's plan fits in a cluster (13056
    keys at one query row a head of 64; the old one-block kernel took
    11958) runs; one key more is refused before any launch."""
    rng = np.random.RandomState(41)
    K = 20480
    args = _int4_call(dev, rng, 1, 16, 16, 64, K, int8=True)
    lo, hi = 1, K
    while hi - lo > 1:
        mid = (lo + hi) // 2
        try:
            mxu_decode.int4_call_plan(*args, live_keys=mid,
                                      elem=mxu_decode.INT8)
            lo = mid
        except ValueError:
            hi = mid
    assert hi < K
    _build.reset_launches()
    got = mxu_decode.cross_decode_mxu(*args, live_keys=lo)
    assert _build.LAUNCHES["decode_i8"] == 1
    ref = mxu_decode.plain_int8(*args, live_keys=lo)
    torch.testing.assert_close(got.float(), ref.float(), atol=2e-3,
                               rtol=2e-2)
    _build.reset_launches()
    with pytest.raises(ValueError, match="shared memory"):
        mxu_decode.cross_decode_mxu(*args, live_keys=lo + 1)
    assert _build.LAUNCHES["decode_i8"] == 0


def test_decode_int4_longest_live_and_one_more(dev):
    """The longest valid prefix the wrapper's plan fits in a cluster runs;
    one key more is refused before any launch."""
    rng = np.random.RandomState(37)
    K = 20480
    args = _int4_call(dev, rng, 1, 2, 2, 64, K)
    lo, hi = 1, K
    while hi - lo > 1:
        mid = (lo + hi) // 2
        try:
            mxu_decode.int4_call_plan(*args, live_keys=mid)
            lo = mid
        except ValueError:
            hi = mid
    assert hi < K  # the search found the limit
    _build.reset_launches()
    got = mxu_decode.cross_decode_mxu_int4(*args, live_keys=lo)
    assert _build.LAUNCHES["decode_int4"] == 1
    ref = mxu_decode.plain_int4(*args, live_keys=lo)
    torch.testing.assert_close(got.float(), ref.float(), atol=2e-3,
                               rtol=2e-2)
    _build.reset_launches()
    with pytest.raises(ValueError, match="shared memory"):
        mxu_decode.cross_decode_mxu_int4(*args, live_keys=lo + 1)
    assert _build.LAUNCHES["decode_int4"] == 0


def _mega_inputs(dev, n_layers, b, dm, heads, groups, d, f, ring, pos, seed):
    """Random int8 weights (per-channel scales ~ 1/sqrt(fan-in) / 127), a
    ring whose columns < pos hold int8 codes and scales, bf16 x."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def codes(*shape):
        return torch.randint(-127, 128, shape, generator=g, device=dev,
                             dtype=torch.int8)

    def scales(shape, fan_in):
        return (torch.rand(shape, generator=g, device=dev) + 0.5) * (
            3 ** 0.5 / 127 / fan_in ** 0.5)

    dq, dkv = heads * d, groups * d
    nqkv = dq + 2 * dkv
    w = {"wqkv": codes(n_layers, nqkv, dm),
         "sqkv": scales((n_layers, nqkv), dm),
         "wo": codes(n_layers, dm, dq), "so": scales((n_layers, dm), dq),
         "wgu": codes(n_layers, 2 * f, dm),
         "sgu": scales((n_layers, 2 * f), dm),
         "wd": codes(n_layers, dm, f), "sd": scales((n_layers, dm), f),
         "ln_attn": 1 + 0.1 * torch.randn((n_layers, dm), generator=g,
                                          device=dev),
         "ln_mlp": 1 + 0.1 * torch.randn((n_layers, dm), generator=g,
                                         device=dev)}
    rings = {}
    for name in ("k", "v"):
        vals = codes(n_layers, b, ring, dkv)
        vals[:, :, pos:] = 0
        sc = torch.rand((n_layers, b, groups, ring), generator=g,
                        device=dev) * 0.03
        sc[..., pos:] = 0
        rings[name + "_q"], rings[name + "_s"] = vals, sc
    x = torch.randn((b, dm), generator=g, device=dev).to(torch.bfloat16)
    return x, rings, w


@pytest.mark.parametrize("batch,heads,groups,d", [
    (3, 6, 2, 32), (16, 6, 2, 32), (24, 6, 2, 32), (48, 6, 2, 32),
    (50, 6, 2, 32), (8, 15, 5, 64), (5, 6, 2, 8)])
@pytest.mark.parametrize("pos", [1, 150])
def test_megastep_matches_plain(dev, chip_smoke, pos, batch, heads, groups,
                                d):
    """ocr_megastep against plain_megastep: one layer at a time (the plain
    output chained as the next input) within chip_smoke's tolerance, with
    its ring column `pos` within one int8 step and its scales within 1e-3,
    and the two-layer step, every layer's ring column as tight (layer 1
    reads layer 0's float32 output, which plain now sums in the kernel's
    order and rounding). Every instance the kernel picks: batch
    tiles of one 8-row tile (B = 3, 5, 8), two (16) and groups of up to
    48 rows (24, 48, and 50 in two groups); the attention at any head dim
    (32; 8, below the 16 columns a thread takes in P V) and at the OCR
    model's 64, 15 query heads over 5 kv heads."""
    from markushgrapher_torch.ocr.vlm import rope_frequencies

    x, rings, w = _mega_inputs(dev, 2, batch, 192, heads, groups, d, 256,
                               256, pos, 7)
    rope = rope_frequencies(d, 512, 1e5).to(dev)
    kw = dict(heads=heads, groups=groups, rms_eps=1e-5)
    ring_k = {k: v.clone() for k, v in rings.items()}
    ring_p = {k: v.clone() for k, v in rings.items()}
    _build.reset_launches()
    got = megastep.ocr_megastep(x, ring_k, w, rope, pos, **kw)
    assert _build.LAUNCHES["ocr_megastep"] == 1
    ref = megastep.plain_megastep(x, ring_p, w, rope, pos, **kw)
    torch.testing.assert_close(got.float(), ref.float(), atol=2e-2,
                               rtol=3e-2)
    for k in ("k_q", "v_q"):
        diff = (ring_k[k].int() - ring_p[k].int()).abs()
        assert int(diff[:, :, :pos].max()) == 0
        assert int(diff[:, :, pos].max()) <= 1
    for k in ("k_s", "v_s"):
        torch.testing.assert_close(ring_k[k], ring_p[k], rtol=1e-3, atol=0)
    xin = x
    for layer in range(2):
        one = {k: t[layer:layer + 1] for k, t in w.items()}
        rk = {k: t[layer:layer + 1].clone() for k, t in rings.items()}
        rp = {k: t[layer:layer + 1].clone() for k, t in rings.items()}
        got = megastep.ocr_megastep(xin, rk, one, rope, pos, **kw)
        ref = megastep.plain_megastep(xin, rp, one, rope, pos, **kw)
        atol, rtol = chip_smoke.TOL["ocr_megastep"]
        torch.testing.assert_close(got.float(), ref.float(), atol=atol,
                                   rtol=rtol)
        chip_smoke.rings_close(rk, rp, pos, f"layer {layer}")
        xin = ref


def test_megastep_refuses_before_launch(dev):
    x, rings, w = _mega_inputs(dev, 1, 2, 64, 4, 2, 16, 64, 128, 10, 1)
    _build.reset_launches()
    with pytest.raises(ValueError, match="position"):
        megastep.ocr_megastep(x, rings, w, torch.zeros((8, 8, 2),
                                                       device=dev), 10,
                              heads=4, groups=2, rms_eps=1e-5)
    assert _build.LAUNCHES["ocr_megastep"] == 0


def test_flash_bias_main_path_shapes(dev, chip_smoke):
    """The float-bias forward at row 3's serving shape and forward + both
    backward kernels at the training shape, with chip_smoke's gates."""
    res = chip_smoke.check_flash_bias(dev)
    assert set(res) == set(chip_smoke.FLASH_BIAS)


@pytest.mark.parametrize("length,bias_dtype,bias_batch", [
    (200, torch.float32, 1), (200, torch.bfloat16, 2),
    (640, torch.bfloat16, 1), (1000, torch.float32, 2)])
def test_flash_bias_ragged_lengths_and_bias_layouts(dev, chip_smoke, length,
                                                    bias_dtype, bias_batch):
    """Lengths that are no multiple of the 64-row tiles (and not of 8: the
    bias rows are read without 16-byte loads), float32 and bf16 biases,
    batch-1 biases; each kernel against its plain version, and the
    autograd op's d(bias) summed over the batch for a batch-1 bias."""
    rng = np.random.RandomState(length)
    B, H, D = 2, 3, 64
    q, k, v, do = (torch.tensor(rng.randn(B, length, H, D) * s,
                                dtype=torch.bfloat16, device=dev)
                   for s in (0.3, 0.3, 1.0, 0.1))
    bias = rng.randn(bias_batch, H, length, length) * 0.5
    bias[..., length - length // 4:] = -1e9
    bias = torch.tensor(bias, dtype=bias_dtype, device=dev)
    o, lse = flash_attention.flash_bias_fwd(q, k, v, bias)
    o_r, lse_r = flash_attention.plain_fwd(q, k, v, bias)
    chip_smoke.within("flash_bias", o, o_r)
    chip_smoke.lse_within(lse, lse_r)
    di = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, bias, do, lse, di)
    for got, ref, name in zip(
            flash_attention.flash_bias_dkv(*args) +
            flash_attention.flash_bias_dq(*args),
            flash_attention.plain_bwd_dkv(*args) +
            flash_attention.plain_bwd_dq(*args),
            ("dk", "dv", "dq", "dbias")):
        assert got.dtype == ref.dtype, name
        chip_smoke.grad_within(name, got, ref)
    leaf = bias.clone().requires_grad_()
    flash_attention.flash_attention_train(q, k, v, leaf).backward(do)
    assert leaf.grad.shape == bias.shape and leaf.grad.dtype == bias_dtype
    ds = flash_attention.plain_bwd_dq(*args)[1].float().sum(0, keepdim=True)
    if bias_batch == 1:
        chip_smoke.grad_within("dbias summed", leaf.grad, ds)


@pytest.mark.parametrize("kind,length,bias_batch,masked", [
    ("int8", 200, 2, "tail"),       # 200-byte bias rows: no TMA
    ("int8", 1280, 2, "tail"),      # the packed route's length
    ("bf16", 1280, 2, "tail"),
    ("int8", 640, 2, "first tile"),
    ("bf16", 640, 2, "first tile"),
    ("int8", 640, 2, "one row"),
    ("bf16", 640, 2, "one row"),
    ("bf16", 203, 1, "tail"),       # batch-1 bias, 406-byte rows: no TMA
    ("float32", 203, 2, "tail")])   # 812-byte rows: no TMA
def test_flash_fwd_sm90_cases(dev, chip_smoke, kind, length, bias_batch,
                              masked):
    """The wgmma forward core (flash_fwd_sm90.cuh) under both bias policies
    against the plain versions: bias rows that TMA cannot stride, the packed
    length, a first 64-key tile whose keys are all masked, a batch row whose
    keys are all masked (uniform weights), a batch-1 and a float32 bias;
    one launch each. The float biases mask keys at -1e9, as the bf16 slab
    does (a row masked below the running max's -1e30 start gives 0)."""
    rng = np.random.RandomState(length + len(masked))
    B, H, D = 2, 3, 64
    q, k, v = (torch.tensor(rng.randn(B, length, H, D) * s,
                            dtype=torch.bfloat16, device=dev)
               for s in (0.3, 0.3, 1.0))
    keep = np.ones((B, length), bool)
    if masked == "tail":
        keep[:, length - length // 4:] = False
    elif masked == "first tile":
        keep[:, :64] = False
    else:
        keep[1] = False
    _build.reset_launches()
    if kind == "int8":
        bias = torch.tensor(rng.randint(-127, 128, (B, H, length, length)),
                            dtype=torch.int8, device=dev)
        scales = torch.tensor(rng.rand(H) * 0.05, dtype=torch.float32,
                              device=dev)
        mask = torch.tensor(keep.astype(np.int32), device=dev)
        got = flash_attention.flash_attention_bias_i8(q, k, v, bias, scales,
                                                      mask)
        ref = flash_attention.plain(q, k, v, bias, scales, mask)
        assert _build.LAUNCHES["flash_i8"] == 1
        chip_smoke.within("flash_i8", got, ref)
    else:
        bias = rng.randn(bias_batch, H, length, length) * 0.5
        bias = np.where(keep[:bias_batch, None, None, :], bias, -1e9)
        bias = torch.tensor(bias, device=dev, dtype={
            "bf16": torch.bfloat16, "float32": torch.float32}[kind])
        got, lse = flash_attention.flash_bias_fwd(q, k, v, bias)
        ref, lse_ref = flash_attention.plain_fwd(q, k, v, bias)
        assert _build.LAUNCHES["flash_bias"] == 1
        chip_smoke.within("flash_bias", got, ref)
        chip_smoke.lse_within(lse, lse_ref)
    if masked == "one row":  # every key masked: the mean of v
        torch.testing.assert_close(
            got[1].float(), v[1].float().mean(0, keepdim=True).expand(
                length, H, D), atol=1e-3, rtol=1.6e-2)


@pytest.mark.parametrize("kind,length,bias_batch,masked", [
    ("bf16", 200, 2, "tail"),        # 400-byte bias rows: TMA
    ("float32", 200, 2, "tail"),
    ("bf16", 203, 2, "tail"),        # 406-byte rows: no TMA
    ("float32", 203, 1, "tail"),     # 812-byte rows, batch-1 bias
    ("bf16", 1536, 2, "tail"),       # the training length
    ("bf16", 640, 2, "first tile"),
    ("float32", 640, 2, "first tile"),
    ("bf16", 640, 2, "query rows"),
    ("float32", 333, 2, "query rows"),
    ("bf16", 640, 1, "tail")])
def test_flash_bwd_sm90_cases(dev, chip_smoke, kind, length, bias_batch,
                              masked):
    """The wgmma backward kernels (flash_bias_bwd.cu) and the autograd op
    against the plain versions, one launch each: bias rows that TMA can and
    cannot stride, bf16 and float32 biases, the training length, a first
    64-key tile whose keys are all masked, query rows whose every key is at
    -1e9, and batch-1 biases, whose d(bias) the op sums over the batch."""
    rng = np.random.RandomState(length + len(masked) + bias_batch)
    B, H, D = 2, 3, 64
    q, k, v, do = (torch.tensor(rng.randn(B, length, H, D) * s,
                                dtype=torch.bfloat16, device=dev)
                   for s in (0.3, 0.3, 1.0, 0.1))
    bias = rng.randn(bias_batch, H, length, length) * 0.5
    if masked == "tail":
        bias[..., length - length // 4:] = -1e9
    elif masked == "first tile":
        bias[..., :64] = -1e9
    else:
        bias[:, :, [5, length - 7], :] = -1e9
    bias = torch.tensor(bias, device=dev, dtype={
        "bf16": torch.bfloat16, "float32": torch.float32}[kind])
    o, lse = flash_attention.flash_bias_fwd(q, k, v, bias)
    di = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, bias, do, lse, di)
    _build.reset_launches()
    got = flash_attention.flash_bias_dkv(*args) + \
        flash_attention.flash_bias_dq(*args)
    assert _build.LAUNCHES["flash_bias_dkv"] == 1
    assert _build.LAUNCHES["flash_bias_dq"] == 1
    ref = flash_attention.plain_bwd_dkv(*args) + \
        flash_attention.plain_bwd_dq(*args)
    for g, r, name in zip(got, ref, ("dk", "dv", "dq", "dbias")):
        assert g.dtype == r.dtype and g.shape == r.shape, name
        chip_smoke.grad_within(name, g, r)
    cols = {"tail": slice(length - length // 4, None),
            "first tile": slice(0, 64)}.get(masked)
    if cols is not None:  # keys masked at -1e9: dS = 0 there
        assert not bool(got[3][..., cols].any())
    leaf = [t.clone().requires_grad_() for t in (q, k, v, bias)]
    flash_attention.flash_attention_train(*leaf).backward(do)
    dbias = ref[3].float().sum(0, keepdim=True) if bias_batch == 1 \
        else ref[3]
    for t, r, name in zip(leaf, (ref[2], ref[0], ref[1], dbias),
                          ("op dq", "op dk", "op dv", "op dbias")):
        assert t.grad.shape == t.shape and t.grad.dtype == t.dtype, name
        chip_smoke.grad_within(name, t.grad, r)


def test_flash_bias_refuses(dev):
    q = torch.zeros((1, 64, 2, 32), dtype=torch.bfloat16, device=dev)
    bias = torch.zeros((1, 2, 64, 64), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="head dim 64"):
        flash_attention.flash_bias_fwd(q, q, q, bias)
    q = torch.zeros((1, 64, 2, 64), dtype=torch.float32, device=dev)
    with pytest.raises(ValueError, match="bf16"):
        flash_attention.flash_bias_fwd(q, q, q, bias)
    q = q.to(torch.bfloat16)
    with pytest.raises(ValueError, match="bias"):
        flash_attention.flash_bias_fwd(q, q, q, bias[:, :1])


def test_flash_relbias_main_path_shapes(dev, chip_smoke):
    """The in-kernel-bias flash forward at B=2 and B=8, MG's encoder shape,
    with chip_smoke's gate."""
    assert set(chip_smoke.check_flash_relbias(dev)) == {"flash_relbias"}


@pytest.mark.parametrize("length,masked", [(200, 40), (333, 333), (1000, 0)])
def test_flash_relbias_ragged_and_masked(dev, chip_smoke, length, masked):
    """Lengths that are no multiple of the 64-row tiles, boxes spread past
    the 2d buckets' saturation (centres in [-1, 2]), and rows whose keys are
    all masked (masked == length: a uniform average, as the plain
    softmax)."""
    rng = np.random.RandomState(length)
    B, H, D = 2, 3, 64
    q, k, v = (torch.tensor(rng.randn(B, length, H, D) * s,
                            dtype=torch.bfloat16, device=dev)
               for s in (0.3, 0.3, 1.0))
    hx, vy = (torch.tensor(rng.rand(B, length) * 3 - 1, dtype=torch.float32,
                           device=dev) for _ in range(2))
    mask = torch.ones((B, length), dtype=torch.int32, device=dev)
    mask[:, length - masked:] = 0
    tables = [torch.tensor(rng.randn(32, H), dtype=torch.float32,
                           device=dev) for _ in range(3)]
    args = (q, k, v, hx, vy, mask, *tables)
    got = flash_relbias.flash_attention_relbias(*args)
    chip_smoke.within("flash_relbias", got, flash_relbias.plain(*args))


def _relbias_inputs(dev, seed, batch, length, heads, masked, boxes,
                    spread):
    """Seeded flash_relbias operands: bf16 q, k, v; centres uniform over
    [-spread / 3, 2 spread / 3] (spread 3: past the 2d buckets'
    saturation), or drawn from `boxes` distinct centres per sample (many
    keys in one box, as OCR cells give); the last `masked` keys masked."""
    rng = np.random.RandomState(seed)
    q, k, v = (torch.tensor(rng.randn(batch, length, heads, 64) * sc,
                            dtype=torch.bfloat16, device=dev)
               for sc in (0.3, 0.3, 1.0))
    if boxes:
        cells = rng.rand(2, batch, boxes) * spread - spread / 3
        pick = rng.randint(0, boxes, (batch, length))
        hx, vy = (torch.tensor(np.take_along_axis(c, pick, 1),
                               dtype=torch.float32, device=dev)
                  for c in cells)
    else:
        hx, vy = (torch.tensor(rng.rand(batch, length) * spread - spread / 3,
                               dtype=torch.float32, device=dev)
                  for _ in range(2))
    mask = torch.ones((batch, length), dtype=torch.int32, device=dev)
    mask[:, length - masked:] = 0
    tables = [torch.tensor(rng.randn(32, heads), dtype=torch.float32,
                           device=dev) for _ in range(3)]
    return q, k, v, hx, vy, mask, *tables


# (batch, length, masked keys, boxes): a length below one 64-key tile; B = 1
# at a length past 2 * 128 + 192, so that a warp meets key tiles beyond the
# 1d buckets' saturation on both sides of the diagonal and near it; repeated
# centres with a masked tail at a length that is no multiple of the
# 192-row CTA
RELBIAS_CASES = [(2, 40, 7, 0), (1, 460, 0, 0), (2, 700, 100, 12)]


@pytest.mark.parametrize("batch,length,masked,boxes", RELBIAS_CASES)
def test_flash_relbias_lengths_and_centres(dev, chip_smoke, batch, length,
                                           masked, boxes):
    args = _relbias_inputs(dev, length, batch, length, 4, masked, boxes, 3.0)
    _build.reset_launches()
    got = flash_relbias.flash_attention_relbias(*args)
    assert _build.LAUNCHES["flash_relbias"] == 1
    chip_smoke.within("flash_relbias", got, flash_relbias.plain(*args))


@pytest.mark.parametrize("batch,length,masked,boxes,dists", [
    *((*c, (128, 100, 100)) for c in RELBIAS_CASES),
    (2, 300, 60, 0, (16, 20, 50))])
def test_flash_relbias_bias_terms_bit_exact(dev, chip_smoke, batch, length,
                                            masked, boxes, dists):
    """The kernel's bias terms (the value each score's QK^T is added to,
    from its debug instance) equal relbias.centre_position_bias with masked
    keys at -1e30 bit for bit, at the default bucket distances and at
    others (max 1d 16, max 2d 20, scaling 50); that instance's output is
    the serving one's."""
    from markushgrapher_torch.ops.relbias import centre_position_bias

    args = _relbias_inputs(dev, length + 1, batch, length, 3, masked, boxes,
                           3.0)
    q, k, v, hx, vy, mask, t1, th, tv = args
    max1, max2, scaling = dists
    out, terms = flash_relbias.kernel_bias_terms(*args, max1, max2, scaling)
    # the reference on the CPU, whose float32 log built the kernel's LUTs
    cpu = [t.cpu() for t in (t1, th, tv, hx, vy)]
    ref = centre_position_bias(*cpu, length, 32, max1, scaling, max2)
    ref = torch.where(mask.cpu()[:, None, None, :] > 0, ref, -1e30)
    assert terms.shape == ref.shape
    bad = terms.cpu() != ref
    assert not bool(bad.any()), (
        f"{int(bad.sum())} bias terms differ, first at "
        f"{bad.nonzero()[0].tolist()}")
    served = flash_relbias.flash_attention_relbias(*args, max1, max2,
                                                   scaling)
    assert torch.equal(out, served)
    chip_smoke.within("flash_relbias", served,
                      flash_relbias.plain(*args, max1, max2, scaling))


def test_flash_relbias_refuses_before_launch(dev):
    _build.reset_launches()
    q = torch.zeros((1, 64, 2, 64), dtype=torch.bfloat16, device=dev)
    hx = torch.zeros((1, 64), device=dev)
    mask = torch.ones((1, 64), dtype=torch.int32, device=dev)
    tab = torch.zeros((32, 2), device=dev)
    with pytest.raises(ValueError, match="bf16"):
        flash_relbias.flash_attention_relbias(q.float(), q, q, hx, hx, mask,
                                              tab, tab, tab)
    with pytest.raises(ValueError, match="head dim 64"):
        flash_relbias.flash_attention_relbias(
            q[..., :32], q[..., :32], q[..., :32], hx, hx, mask, tab, tab,
            tab)
    with pytest.raises(ValueError, match="hx"):
        flash_relbias.flash_attention_relbias(q, q, q, hx[:, :32], hx, mask,
                                              tab, tab, tab)
    with pytest.raises(ValueError, match="tables"):
        flash_relbias.flash_attention_relbias(q, q, q, hx, hx, mask,
                                              tab[:, :1], tab, tab)
    assert _build.LAUNCHES["flash_relbias"] == 0


# -- row maps, valid prefixes, the lattice, normalize_u8 -----------------------


def _ring(dev, rng, int4, rows, heads, d, ring, step, seg, poison=False):
    """Self-ring operands: q [rows, heads, d] bf16, K/V [rows, ring, G*D]
    (packed for int4) with per-head scales, the causal bias row (float32's
    lowest past `step`, where the ring holds zeros, or garbage with
    poison=True) and a random row map [rows, ring / seg]."""
    top = 8 if int4 else 128
    vals = rng.randint(1 - top, top, (2, rows, ring, heads * d))
    sc = rng.rand(2, rows, heads, ring) * (0.2 if int4 else 0.02)
    if poison:
        vals[:, :, step + 1:] = top - 1
        sc[:, :, :, step + 1:] = 1e9
    else:
        vals[:, :, step + 1:] = 0
        sc[:, :, :, step + 1:] = 0
    kv = [torch.tensor(v, dtype=torch.int8, device=dev) for v in vals]
    if int4:
        kv = [mxu_decode.pack_int4(t) for t in kv]
    sdt = torch.bfloat16 if int4 else torch.float32
    ks, vs = (torch.tensor(s_, device=dev).to(sdt) for s_ in sc)
    q = torch.tensor(rng.randn(rows, heads, d), device=dev).to(torch.bfloat16)
    bias = torch.full((1, heads, ring), torch.finfo(torch.float32).min,
                      device=dev)
    bias[..., :step + 1] = torch.tensor(rng.randn(1, heads, step + 1) * 0.5,
                                        dtype=torch.float32, device=dev)
    rm = torch.tensor(rng.randint(0, rows, (rows, ring // seg)),
                      dtype=torch.int32, device=dev)
    return q, kv[0], ks, kv[1], vs, bias, rm


@pytest.mark.parametrize("int4", [True, False])
@pytest.mark.parametrize("mode,seg", [("row_map", 128), ("prefix", 128),
                                      ("row_map+prefix", 128),
                                      ("row_map", 8), ("row_map+prefix", 512)])
def test_decode_row_map_and_prefix(dev, int4, mode, seg):
    """The row-mapped and valid-prefix forms of both decode kernels at the
    beam-5 self-ring shape scaled down (40 rows, 16 heads of 64, ring
    1024), against their plain versions: blocks of 8, 128 and 512 keys."""
    rng = np.random.RandomState(seg + 2 * int4 + len(mode))
    step = 700
    args = _ring(dev, rng, int4, 40, 16, 64, 1024, step, seg)
    kw = dict(block_k=seg)
    if "row_map" in mode:
        kw["row_map"] = args[-1]
    if "prefix" in mode:
        kw.update(mxu_decode.valid_prefix_blocks(1024, step, seg))
    name = "decode_int4" if int4 else "decode_i8"
    kernel, plain = ((mxu_decode.cross_decode_mxu_int4, mxu_decode.plain_int4)
                     if int4 else
                     (mxu_decode.cross_decode_mxu, mxu_decode.plain_int8))
    _build.reset_launches()
    got = kernel(*args[:-1], **kw)
    assert _build.LAUNCHES[name] == 1
    ref = plain(*args[:-1], **kw)
    torch.testing.assert_close(got.float(), ref.float(), atol=2e-3,
                               rtol=2e-2)


def test_decode_int4_odd_groups_with_prefix(dev):
    """The OCR ring's shape (15 query rows over 5 kv heads of 64, whose
    head 2 straddles the nibble split) read up to its valid prefix in
    blocks of 128."""
    rng = np.random.RandomState(17)
    B, R, G, d, K, step = 8, 15, 5, 64, 640, 300
    vals = rng.randint(-7, 8, (2, B, K, G * d))
    vals[:, :, step + 1:] = 0
    kq, vq = (mxu_decode.pack_int4(torch.tensor(v, dtype=torch.int8,
                                                device=dev)) for v in vals)
    sc = rng.rand(2, B, G, K) * 0.2
    sc[..., step + 1:] = 0
    ks, vs = (torch.tensor(s_, device=dev).to(torch.bfloat16) for s_ in sc)
    q = torch.tensor(rng.randn(B, R, d), device=dev).to(torch.bfloat16)
    bias = torch.full((1, 1, K), torch.finfo(torch.float32).min, device=dev)
    bias[..., :step + 1] = 0.0
    kw = mxu_decode.valid_prefix_blocks(K, step, 128)
    got = mxu_decode.cross_decode_mxu_int4(q, kq, ks, vq, vs, bias, **kw)
    ref = mxu_decode.plain_int4(q, kq, ks, vq, vs, bias, **kw)
    torch.testing.assert_close(got.float(), ref.float(), atol=2e-3,
                               rtol=2e-2)


@pytest.mark.parametrize("seg,n_live", [(128, 1), (128, 2), (128, 4),
                                        (8, 37), (512, 2)])
def test_lattice_matches_plain_and_row_mapped_decode(dev, seg, n_live):
    """lattice_self_int4 at the beam-5 b8 self-ring shape (40 rows, 16
    heads of 64, ring 512 or 1024) against its plain version and against
    the row-mapped decode_int4 kernel over the whole ring (segments of 512
    take more than 48 KB of shared memory)."""
    ring = 1024 if seg == 512 else 512
    step = n_live * seg - 1 - seg // 3
    rng = np.random.RandomState(seg + n_live)
    *args, rm = _ring(dev, rng, True, 40, 16, 64, ring, step, seg)
    _build.reset_launches()
    got = mxu_decode.lattice_self_int4(*args, rm, n_live, seg)
    assert _build.LAUNCHES["lattice_self_int4"] == 1
    ref = mxu_decode.plain_lattice_int4(*args, rm, n_live, seg)
    torch.testing.assert_close(got.float(), ref.float(), atol=2e-3,
                               rtol=2e-2)
    whole = mxu_decode.cross_decode_mxu_int4(*args, row_map=rm, block_k=seg)
    torch.testing.assert_close(got.float(), whole.float(), atol=2e-3,
                               rtol=2e-2)


def test_lattice_never_reads_dead_segments(dev):
    """Garbage values and 1e9 scales in the segments past n_live leave the
    kernel's output unchanged bit for bit (they are never read)."""
    rng = np.random.RandomState(23)
    *clean, rm = _ring(dev, rng, True, 40, 16, 64, 512, 255, 128)
    rng = np.random.RandomState(23)
    *bad, _ = _ring(dev, rng, True, 40, 16, 64, 512, 255, 128, poison=True)
    a = mxu_decode.lattice_self_int4(*clean, rm, 2, 128)
    b = mxu_decode.lattice_self_int4(*bad, rm, 2, 128)
    assert torch.equal(a, b)


def test_lattice_and_row_map_refuse_before_launch(dev):
    """n_live of 0 or past the ring, a row map of the wrong shape, and a
    row map on the CPU are refused before any launch."""
    rng = np.random.RandomState(29)
    *args, rm = _ring(dev, rng, True, 4, 16, 64, 512, 300, 128)
    _build.reset_launches()
    with pytest.raises(ValueError, match="n_live"):
        mxu_decode.lattice_self_int4(*args, rm, 0, 128)
    with pytest.raises(ValueError, match="n_live"):
        mxu_decode.lattice_self_int4(*args, rm, 5, 128)
    with pytest.raises(ValueError, match="row_map"):
        mxu_decode.lattice_self_int4(*args, rm[:, :2], 1, 128)
    with pytest.raises(ValueError, match="CUDA"):
        mxu_decode.cross_decode_mxu_int4(*args, row_map=rm.cpu(),
                                         block_k=128)
    assert _build.LAUNCHES["lattice_self_int4"] == 0
    assert _build.LAUNCHES["decode_int4"] == 0


def test_lattice_odd_groups(dev):
    """On decode_int4's core the lattice takes an odd kv-head count (15
    query rows over 5 heads of 64, head 2 across the nibble split) with
    odd segments: against its plain version, in one launch."""
    rng = np.random.RandomState(43)
    B, R, G, d, L, seg, n_live = 6, 15, 5, 64, 630, 45, 9
    vals = rng.randint(-7, 8, (2, B, L, G * d))
    kq, vq = (mxu_decode.pack_int4(torch.tensor(v, dtype=torch.int8,
                                                device=dev)) for v in vals)
    ks, vs = (torch.tensor(rng.rand(B, G, L) * 0.2, device=dev).to(
        torch.bfloat16) for _ in range(2))
    q = torch.tensor(rng.randn(B, R, d), device=dev).to(torch.bfloat16)
    bias = torch.tensor(rng.randn(1, R, L) * 0.5, dtype=torch.float32,
                        device=dev)
    rm = torch.tensor(rng.randint(0, B, (B, L // seg)), dtype=torch.int32,
                      device=dev)
    args = (q, kq, ks, vq, vs, bias, rm, n_live, seg)
    _build.reset_launches()
    got = mxu_decode.lattice_self_int4(*args)
    assert _build.LAUNCHES["lattice_self_int4"] == 1
    assert _build.LAUNCHES["decode_int4"] == 0
    ref = mxu_decode.plain_lattice_int4(*args)
    torch.testing.assert_close(got.float(), ref.float(), atol=2e-3,
                               rtol=2e-2)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_normalize_u8_bit_exact(dev, out_dtype):
    """normalize_u8 against its plain version bit for bit: an OCR page
    batch, a ragged size (the scalar tail), aligned inputs shorter than one
    512-byte tile (the tail alone), a view at a 1-byte offset (the
    byte-at-a-time path), and ImageNet's mean / std."""
    from markushgrapher_torch.ops import preprocess

    rng = np.random.RandomState(31)
    pages = torch.tensor(rng.randint(0, 256, (8, 512, 512, 3)),
                         dtype=torch.uint8, device=dev)
    flat = torch.tensor(rng.randint(0, 256, 1001), dtype=torch.uint8,
                        device=dev)
    short = [torch.tensor(rng.randint(0, 256, n), dtype=torch.uint8,
                          device=dev) for n in (1, 16, 511)]
    assert all(x.data_ptr() % 16 == 0 for x in short)
    for x, mean, std in ((pages, 0.5, 0.5), (flat[:999], 0.5, 0.5),
                         *((x, 0.5, 0.5) for x in short),
                         (flat[1:], 0.485, 0.229)):
        _build.reset_launches()
        got = preprocess.normalize_u8(x, mean, std, out_dtype)
        assert _build.LAUNCHES["normalize_u8"] == 1
        ref = preprocess.plain_normalize_u8(x, mean, std, out_dtype)
        assert got.dtype == out_dtype and torch.equal(got, ref)
    img = pages[:2]
    for pool in (1, 2):
        assert torch.equal(
            preprocess.preprocess_patchify(img, pool=pool),
            preprocess.preprocess_patchify_reference(img, pool=pool))
