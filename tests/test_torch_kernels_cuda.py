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
from markushgrapher_torch.ops import megastep, mxu_decode

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
    assert set(res) == set(chip_smoke.KERNELS)


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
    q = torch.zeros((1, 16, 64), dtype=torch.bfloat16, device=dev)
    kv = torch.zeros((1, 12288, 1024), dtype=torch.int8, device=dev)
    sc = torch.zeros((1, 16, 12288), device=dev)
    _build.reset_launches()
    with pytest.raises(ValueError, match="shared memory"):
        mxu_decode.cross_decode_mxu(q, kv, sc, kv, sc,
                                    torch.zeros((1, 1, 12288), device=dev))
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


@pytest.mark.parametrize("pos", [1, 150])
def test_megastep_matches_plain(dev, chip_smoke, pos):
    """ocr_megastep against plain_megastep: one layer at a time (the plain
    output chained as the next input) within chip_smoke's tolerance, the
    ring column `pos` within one int8 step, and the two-layer step."""
    from markushgrapher_torch.ocr.vlm import rope_frequencies

    heads, groups, d = 6, 2, 32
    x, rings, w = _mega_inputs(dev, 2, 3, 192, heads, groups, d, 256, 256,
                               pos, 7)
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
