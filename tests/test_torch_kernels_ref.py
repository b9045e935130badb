"""The plain PyTorch versions of the port's three kernels against the JAX
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
