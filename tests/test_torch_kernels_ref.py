"""The plain PyTorch versions of the port's four kernels against the JAX
functions they replace (Pallas run in interpret mode, as the JAX package's
own tests run it), and the CPU dispatch of their wrappers."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from markushgrapher_tpu.ops import bias_build as jbias
from markushgrapher_tpu.ops import flash_attention as jflash
from markushgrapher_tpu.ops import mxu_decode as jdec
from markushgrapher_tpu.ops import relbias as jrel
from markushgrapher_torch.ops import _build
from markushgrapher_torch.ops import bias_build as tbias
from markushgrapher_torch.ops import flash_attention as tflash
from markushgrapher_torch.ops import mxu_decode as tdec


def _bias_inputs(seed=0, B=2, L=256, H=8, packed=False):
    rng = np.random.RandomState(seed)
    tabs = [rng.randn(32, H).astype(np.float32) for _ in range(3)]
    bbox = rng.rand(B, L, 4).astype(np.float32)
    bbox[:, L - 40:] = 0.0
    mask = (bbox.sum(-1) > 0).astype(np.int32)
    pos = (np.stack([np.sort(rng.permutation(2 * L)[:L]) for _ in range(B)])
           .astype(np.int32) if packed else None)
    return tabs, bbox, mask, pos


@pytest.mark.parametrize("packed", [False, True])
def test_bias_builder_bit_equal_to_gather_builder(packed):
    tabs, bbox, mask, pos = _bias_inputs(packed=packed)
    L = bbox.shape[1]
    want, s_want = jrel.encoder_position_bias_chunked_i8(
        *map(jnp.asarray, tabs), jnp.asarray(bbox), jnp.asarray(mask), L,
        32, 128, 100, 100,
        positions=None if pos is None else jnp.asarray(pos))
    _build.reset_launches()
    got, s_got = tbias.encoder_position_bias_kernel_i8(
        *map(torch.from_numpy, tabs), torch.from_numpy(bbox),
        torch.from_numpy(mask), L, 32, 128, 100, 100,
        positions=None if pos is None else torch.from_numpy(pos))
    assert _build.LAUNCHES["bias_build_i8"] == 0    # CPU -> plain version
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(s_got.numpy(), np.asarray(s_want), rtol=1e-6)


def test_bias_builder_vs_tpu_kernel():
    """The TPU one-hot kernel is <= 1 LSB off on < 1e-3 of the entries
    (its hi/lo bf16 table split); the port is exact against the gather
    builder, so the same bound holds against it."""
    tabs, bbox, mask, _ = _bias_inputs(seed=1)
    L = bbox.shape[1]
    want, s_want = jbias.encoder_position_bias_kernel_i8(
        *map(jnp.asarray, tabs), jnp.asarray(bbox), jnp.asarray(mask), L,
        32, 128, 100, 100)
    got, s_got = tbias.plain(*map(torch.from_numpy, tabs),
                             torch.from_numpy(bbox), torch.from_numpy(mask),
                             L, 32, 128, 100, 100)
    d = np.abs(got.numpy().astype(np.int32) - np.asarray(want, np.int32))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3
    np.testing.assert_allclose(s_got.numpy(), np.asarray(s_want), rtol=1e-6)


def test_flash_plain_vs_jax_kernel():
    rng = np.random.RandomState(2)
    B, L, H, D = 2, 256, 4, 16
    q, k = (rng.randn(B, L, H, D).astype(np.float32) * 0.3 for _ in "qk")
    v = rng.randn(B, L, H, D).astype(np.float32)
    bias = rng.randint(-127, 128, (B, H, L, L)).astype(np.int8)
    scales = rng.rand(H).astype(np.float32) * 0.05
    mask = np.ones((B, L), np.int32)
    mask[:, -70:] = 0
    args = (q, k, v, bias, scales, mask)
    want = jflash.flash_attention_bias_i8(*map(jnp.asarray, args))
    _build.reset_launches()
    got = tflash.flash_attention_bias_i8(*map(torch.from_numpy, args))
    assert _build.LAUNCHES["flash_i8"] == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("kind", ["cross", "self"])
def test_decode_plain_vs_jax_kernel(kind):
    """atol 2e-2: both sides round q, p * vs and the output to bf16 (the TPU
    kernel's rounding points), so a one-ulp flip at any of them moves the
    float32-compared output by up to ~1e-2 at these magnitudes."""
    rng = np.random.RandomState(3)
    B, H, D, K = 2, 8, 8, 256
    q = rng.randn(B, H, D).astype(np.float32)
    kv = [rng.randint(-7, 8, (B, K, H * D)).astype(np.int8) for _ in "kv"]
    sc = [(rng.rand(B, H, K) * 0.3).astype(np.float32) for _ in "kv"]
    if kind == "cross":
        bias = np.zeros((B, 1, K), np.float32)
        bias[:, :, -60:] = -1e9
    else:
        step = 150
        bias = (rng.randn(1, H, K) * 0.5).astype(np.float32)
        bias[:, :, step + 1:] = np.finfo(np.float32).min
        for t, s in zip(kv, sc):
            t[:, step + 1:] = 0
            s[:, :, step + 1:] = 0.0
    kq, vq = (np.array(jdec.pack_int4(jnp.asarray(t))) for t in kv)
    ks, vs = (jnp.asarray(s, jnp.bfloat16) for s in sc)
    want = jdec.cross_decode_mxu_int4(jnp.asarray(q), jnp.asarray(kq), ks,
                                      jnp.asarray(vq), vs, jnp.asarray(bias))
    to_t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa
    _build.reset_launches()
    got = tdec.cross_decode_mxu_int4(
        torch.from_numpy(q), torch.from_numpy(kq),
        to_t(ks).to(torch.bfloat16), torch.from_numpy(vq),
        to_t(vs).to(torch.bfloat16), torch.from_numpy(bias))
    assert _build.LAUNCHES["decode_int4"] == 0
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-2,
                               rtol=0)


def test_pack_int4_matches_and_round_trips():
    vals = np.random.RandomState(4).randint(-7, 8, (3, 5, 32)).astype(np.int8)
    got = tdec.pack_int4(torch.from_numpy(vals))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jdec.pack_int4(jnp.asarray(vals))))
    np.testing.assert_array_equal(tdec.unpack_int4(got).numpy(),
                                  vals.astype(np.float32))


def _bf16_ulp(x):
    """One bf16 ulp of each entry (8 significant bits)."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def _decode_case(case, rng, B=2, D=8, K=256):
    """(q, K/V int8 [B, K, G*D], per-row scales [B, R, K], bias, head_map,
    groups) for one layout of the decode kernels' contract."""
    if case == "grouped":            # GQA: 8 query rows over 2 kv blocks
        rows, groups, head_map = 8, 2, None
    elif case == "beam":             # 3 beams x 4 heads over a 4-head slab
        rows, groups, head_map = 12, 4, tuple(range(4)) * 3
    else:                            # one query row per kv block
        rows, groups, head_map = 8, 8, None
    q = rng.randn(B, rows, D).astype(np.float32)
    kv = [rng.randint(-127, 128, (B, K, groups * D)).astype(np.int8)
          for _ in "kv"]
    sc = [(rng.rand(B, groups, K) * 0.02).astype(np.float32) for _ in "kv"]
    if case == "per_head_bias":      # the self ring: causal row per head
        step = 150
        bias = (rng.randn(1, rows, K) * 0.5).astype(np.float32)
        bias[:, :, step + 1:] = np.finfo(np.float32).min
        for t, s_ in zip(kv, sc):
            t[:, step + 1:] = 0
            s_[:, :, step + 1:] = 0.0
    else:                            # the cross slab: shared key mask
        bias = np.zeros((B, 1, K), np.float32)
        bias[:, :, -60:] = -1e9
    hm = np.asarray(head_map if head_map is not None
                    else np.arange(rows) // (rows // groups))
    rows_sc = [s_[:, hm] for s_ in sc]                  # tiled per row
    return q, kv, sc, rows_sc, bias, head_map


@pytest.mark.parametrize("case", ["grouped", "beam", "shared_bias",
                                  "per_head_bias"])
def test_decode_i8_plain_vs_jax_kernel(case):
    """Plain int8 decode attention (and the wrapper's CPU dispatch) against
    the JAX `cross_decode_mxu`, within one bf16 ulp of each output: both
    round q, p * vs and the output at the same points and sum in f32. The
    port takes the scales per query row, as the JAX kernel does, and per
    kv block, indexed by the head map."""
    q, (kq, vq), sc, rows_sc, bias, head_map = _decode_case(
        case, np.random.RandomState(5))
    want = np.asarray(jdec.cross_decode_mxu(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(rows_sc[0]),
        jnp.asarray(vq), jnp.asarray(rows_sc[1]), jnp.asarray(bias),
        head_map=head_map))
    _build.reset_launches()
    for scales in (rows_sc, sc):
        got = tdec.cross_decode_mxu(
            torch.from_numpy(q), torch.from_numpy(kq),
            torch.from_numpy(scales[0]), torch.from_numpy(vq),
            torch.from_numpy(scales[1]), torch.from_numpy(bias),
            head_map=head_map).numpy()
        assert got.dtype == np.float32 and np.isfinite(got).all()
        assert (np.abs(got - want) <= _bf16_ulp(want)).all(), \
            np.abs(got - want).max()
    assert _build.LAUNCHES["decode_i8"] == 0            # CPU -> plain


def test_decode_int4_head_map_plain_vs_jax_kernel():
    """Plain int4 decode attention with the beam head map (3 beams folded
    over a 4-head packed slab) against the JAX `cross_decode_mxu_int4`,
    with per-row (tiled) and per-block scales; atol as in
    test_decode_plain_vs_jax_kernel."""
    rng = np.random.RandomState(6)
    B, H, D, K, beams = 2, 4, 8, 256, 3
    head_map = tuple(range(H)) * beams
    q = rng.randn(B, beams * H, D).astype(np.float32)
    kv = [rng.randint(-7, 8, (B, K, H * D)).astype(np.int8) for _ in "kv"]
    sc = [(rng.rand(B, H, K) * 0.3).astype(np.float32) for _ in "kv"]
    bias = np.zeros((B, 1, K), np.float32)
    bias[:, :, -60:] = -1e9
    kq, vq = (np.array(jdec.pack_int4(jnp.asarray(t))) for t in kv)
    ks, vs = (jnp.asarray(s, jnp.bfloat16) for s in sc)
    want = np.asarray(jdec.cross_decode_mxu_int4(
        jnp.asarray(q), jnp.asarray(kq), jnp.tile(ks, (1, beams, 1)),
        jnp.asarray(vq), jnp.tile(vs, (1, beams, 1)), jnp.asarray(bias),
        head_map=head_map))
    to_t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa
    _build.reset_launches()
    for rep in (beams, 1):
        got = tdec.cross_decode_mxu_int4(
            torch.from_numpy(q), torch.from_numpy(kq),
            to_t(ks).repeat(1, rep, 1).to(torch.bfloat16),
            torch.from_numpy(vq),
            to_t(vs).repeat(1, rep, 1).to(torch.bfloat16),
            torch.from_numpy(bias), head_map=head_map)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-2, rtol=0)
    assert _build.LAUNCHES["decode_int4"] == 0


# -- copy-on-write row maps, valid prefixes, the lattice, normalize_u8 --------

SEG = 128


def _ring_case(rng, int4, B=4, H=8, D=8, K=512, step=None):
    """Self-ring operands of the decode kernels: q [B, H, D], K/V [B, K,
    H*D] (packed for int4) with per-row scales [B, H, K] (bf16 for int4),
    a per-head bias row with the causal tail at float32's lowest past
    `step` (the ring there holds zeros), and a random row map [B, K /
    SEG]."""
    top = 8 if int4 else 128
    q = rng.randn(B, H, D).astype(np.float32)
    kv = [rng.randint(1 - top, top, (B, K, H * D)).astype(np.int8)
          for _ in "kv"]
    sc = [(rng.rand(B, H, K) * (0.3 if int4 else 0.02)).astype(np.float32)
          for _ in "kv"]
    bias = (rng.randn(1, H, K) * 0.5).astype(np.float32)
    if step is not None:
        bias[:, :, step + 1:] = np.finfo(np.float32).min
        for t, s_ in zip(kv, sc):
            t[:, step + 1:] = 0
            s_[:, :, step + 1:] = 0.0
    if int4:
        kv = [np.array(jdec.pack_int4(jnp.asarray(t))) for t in kv]
        sc = [np.asarray(jnp.asarray(s_, jnp.bfloat16), np.float32)
              for s_ in sc]
    rm = rng.randint(0, B, (B, K // SEG)).astype(np.int32)
    return q, kv, sc, bias, rm


def _jax_decode(int4, q, kv, sc, bias, **kw):
    fn = jdec.cross_decode_mxu_int4 if int4 else jdec.cross_decode_mxu
    sdt = jnp.bfloat16 if int4 else jnp.float32
    return np.asarray(fn(jnp.asarray(q), jnp.asarray(kv[0]),
                         jnp.asarray(sc[0], sdt), jnp.asarray(kv[1]),
                         jnp.asarray(sc[1], sdt), jnp.asarray(bias), **kw))


def _torch_decode(int4, q, kv, sc, bias, **kw):
    fn = tdec.cross_decode_mxu_int4 if int4 else tdec.cross_decode_mxu
    sdt = torch.bfloat16 if int4 else torch.float32
    return fn(torch.from_numpy(q), torch.from_numpy(kv[0]),
              torch.from_numpy(sc[0]).to(sdt), torch.from_numpy(kv[1]),
              torch.from_numpy(sc[1]).to(sdt), torch.from_numpy(bias),
              **kw).numpy()


def _close(int4, got, want):
    """int8: within one bf16 ulp of each output; int4: atol 2e-2 (both as
    test_decode_plain_vs_jax_kernel / test_decode_i8_plain_vs_jax_kernel)."""
    assert got.dtype == np.float32 and np.isfinite(got).all()
    if int4:
        np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)
    else:
        assert (np.abs(got - want) <= _bf16_ulp(want)).all(), \
            np.abs(got - want).max()


@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("mode", ["row_map", "prefix", "row_map+prefix"])
def test_decode_row_map_and_prefix_plain_vs_jax_kernel(int4, mode):
    """The plain decode with a random row map (B=4, K=512, segments of
    128), with the valid prefix (the JAX `block_map` of
    `valid_prefix_blocks` at step 300: blocks 3.. redirected, here not
    read), and with both composed, against the JAX kernel in interpret
    mode; the online softmax runs over the 128-key blocks on both sides.
    The wrapper's CPU dispatch goes to the plain version."""
    step = 300
    q, kv, sc, bias, rm = _ring_case(np.random.RandomState(7), int4,
                                     step=step)
    jkw, tkw = dict(block_k=SEG), dict(block_k=SEG)
    if "row_map" in mode:
        jkw["row_map"], tkw["row_map"] = jnp.asarray(rm), torch.from_numpy(rm)
    if "prefix" in mode:
        jkw.update(jdec.valid_prefix_blocks(512, step, SEG))
        tkw.update(tdec.valid_prefix_blocks(512, step, SEG))
        assert tkw["live_keys"] == 384
    want = _jax_decode(int4, q, kv, sc, bias, **jkw)
    _build.reset_launches()
    _close(int4, _torch_decode(int4, q, kv, sc, bias, **tkw), want)
    assert _build.LAUNCHES["decode_int4" if int4 else "decode_i8"] == 0


@pytest.mark.parametrize("n_live", [1, 2, 4])
def test_lattice_plain_vs_jax_kernel(n_live):
    """plain_lattice_int4 (and the wrapper's CPU dispatch) against the JAX
    `lattice_self_int4` in interpret mode: the first n_live segments of
    128, each read through the row map, the rest masked by the bias; the
    row-mapped plain int4 decode over the whole ring gives the same bits."""
    step = n_live * SEG - 1
    q, kv, sc, bias, rm = _ring_case(np.random.RandomState(8), True,
                                     step=step)
    want = np.asarray(jdec.lattice_self_int4(
        jnp.asarray(q), jnp.asarray(kv[0]), jnp.asarray(sc[0], jnp.bfloat16),
        jnp.asarray(kv[1]), jnp.asarray(sc[1], jnp.bfloat16),
        jnp.asarray(bias), jnp.asarray(rm), n_live, seg=SEG))
    args = (torch.from_numpy(q), torch.from_numpy(kv[0]),
            torch.from_numpy(sc[0]).to(torch.bfloat16),
            torch.from_numpy(kv[1]),
            torch.from_numpy(sc[1]).to(torch.bfloat16),
            torch.from_numpy(bias))
    _build.reset_launches()
    got = tdec.lattice_self_int4(*args, torch.from_numpy(rm), n_live,
                                 SEG).numpy()
    assert _build.LAUNCHES["lattice_self_int4"] == 0
    _close(True, got, want)
    whole = tdec.plain_int4(*args, row_map=torch.from_numpy(rm),
                            block_k=SEG).numpy()
    np.testing.assert_array_equal(got, whole)


def test_lattice_never_reads_dead_segments():
    """Poisoned scales and values in the segments at or past n_live (as
    tests/test_mxu_decode.py poisons the JAX kernel's) leave the plain
    lattice's output unchanged, bit for bit."""
    q, kv, sc, bias, rm = _ring_case(np.random.RandomState(9), True)
    bias[:, :, 2 * SEG:] = -1e9
    to_t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa

    def run(kv, sc):
        return tdec.plain_lattice_int4(
            to_t(q), to_t(kv[0]), to_t(sc[0]).to(torch.bfloat16),
            to_t(kv[1]), to_t(sc[1]).to(torch.bfloat16), to_t(bias),
            to_t(rm), 2, SEG).numpy()

    clean = run(kv, sc)
    bad_kv = [t.copy() for t in kv]
    bad_sc = [s_.copy() for s_ in sc]
    for t, s_ in zip(bad_kv, bad_sc):
        t[:, 2 * SEG:] = 0x77
        s_[:, :, 2 * SEG:] = 1e9
    np.testing.assert_array_equal(run(bad_kv, bad_sc), clean)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_normalize_u8_bit_equal_to_jax(out_dtype):
    """normalize_u8 (the wrapper's CPU dispatch: the plain version) equals
    the JAX Pallas kernel in interpret mode bit for bit, over every uint8
    value and a ragged [2, 24, 40, 3] batch."""
    from markushgrapher_tpu.ops import preprocess as jpre
    from markushgrapher_torch.ops import preprocess as tpre

    rng = np.random.RandomState(10)
    img = rng.randint(0, 256, (2, 24, 40, 3)).astype(np.uint8)
    img[0, 0, :, :].flat[:] = np.arange(120) % 256
    img[0, 1, :, :].flat[:] = np.arange(120, 240) % 256
    img[0, 2, :, :].flat[:] = np.arange(240, 360) % 256
    for mean, std in ((0.5, 0.5), (0.485, 0.229)):
        want = np.asarray(jpre.normalize_u8(
            jnp.asarray(img), mean=mean, std=std,
            out_dtype=getattr(jnp, out_dtype)), np.float32)
        _build.reset_launches()
        got = tpre.normalize_u8(torch.from_numpy(img), mean=mean, std=std,
                                out_dtype=getattr(torch, out_dtype))
        assert _build.LAUNCHES["normalize_u8"] == 0
        assert got.dtype == getattr(torch, out_dtype)
        np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("pool", [1, 2])
def test_preprocess_patchify_bit_equal_to_jax(pool):
    """preprocess_patchify and its reference against the JAX ones (pool 1
    and 2, patch 8, bf16 and float32 out): bit for bit."""
    from markushgrapher_tpu.ops import preprocess as jpre
    from markushgrapher_torch.ops import preprocess as tpre

    img = np.random.RandomState(11).randint(0, 256, (2, 32, 48, 3)).astype(
        np.uint8)
    for name in ("float32", "bfloat16"):
        want = np.asarray(jpre.preprocess_patchify(
            jnp.asarray(img), patch=8, pool=pool,
            out_dtype=getattr(jnp, name)), np.float32)
        for fn in (tpre.preprocess_patchify,
                   tpre.preprocess_patchify_reference):
            got = fn(torch.from_numpy(img), patch=8, pool=pool,
                     out_dtype=getattr(torch, name))
            assert got.shape == want.shape
            np.testing.assert_array_equal(got.float().numpy(), want)
