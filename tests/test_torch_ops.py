"""Relative-bias and fusion ops of the port against `markushgrapher_tpu.ops`
on the same numpy inputs: bucket ids identical, float outputs within 1e-6."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from markushgrapher_tpu.ops import fusion as jfusion
from markushgrapher_tpu.ops import relbias as jrel
from markushgrapher_torch.ops import fusion as tfusion
from markushgrapher_torch.ops import relbias as trel


@pytest.mark.parametrize("bidirectional,max_distance,span", [
    (True, 128, 2048), (False, 128, 2048), (True, 100, 150),
    (False, 100, 150)])
def test_buckets_identical(bidirectional, max_distance, span):
    rel = np.arange(-span, span + 1, dtype=np.int32)
    want = np.asarray(jrel.relative_position_bucket(
        jnp.asarray(rel), bidirectional, 32, max_distance))
    got = trel.relative_position_bucket(torch.from_numpy(rel), bidirectional,
                                        32, max_distance).numpy()
    np.testing.assert_array_equal(got, want)


def test_lut_saturates_beyond_max_distance():
    """Clamping a distance into the +-max_distance table is exact."""
    for md in (128, 100):
        rel = torch.arange(-4 * md, 4 * md + 1, dtype=torch.int32)
        direct = trel.relative_position_bucket(rel, True, 32, md)
        lut = trel.bucket_lut(32, md)
        np.testing.assert_array_equal(
            lut[rel.clamp(-md, md) + md].numpy(), direct.numpy())


def test_bucket_2d_identical():
    coord = np.random.RandomState(0).rand(2, 64).astype(np.float32)
    want = np.asarray(jrel.bucket_2d(jnp.asarray(coord), scaling_factor=100,
                                     num_buckets=32, max_distance=100))
    got = trel.bucket_2d(torch.from_numpy(coord), scaling_factor=100,
                         num_buckets=32, max_distance=100).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("packed", [False, True])
def test_encoder_position_bias(packed):
    rng = np.random.RandomState(1)
    B, L, H = 2, 96, 4
    tabs = [rng.randn(32, H).astype(np.float32) for _ in range(3)]
    bbox = rng.rand(B, L, 4).astype(np.float32)
    pos = (np.stack([rng.permutation(3 * L)[:L] for _ in range(B)])
           .astype(np.int32) if packed else None)
    want = jrel.encoder_position_bias(
        *map(jnp.asarray, tabs), jnp.asarray(bbox), L, 32, 128, 100, 100,
        positions=None if pos is None else jnp.asarray(pos))
    got = trel.encoder_position_bias(
        *map(torch.from_numpy, tabs), torch.from_numpy(bbox), L, 32, 128,
        100, 100, positions=None if pos is None else torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


def test_decoder_position_bias_and_mask_bias():
    table = np.random.RandomState(2).randn(32, 4).astype(np.float32)
    want = jrel.decoder_position_bias(jnp.asarray(table), 40, 32, 128)
    got = trel.decoder_position_bias(torch.from_numpy(table), 40, 32, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    mask = np.array([[1, 1, 0, 1], [0, 0, 1, 1]], np.int32)
    np.testing.assert_array_equal(
        trel.mask_bias(torch.from_numpy(mask)).numpy(),
        np.asarray(jrel.mask_bias(jnp.asarray(mask))))


def test_combine_image_text_embeddings():
    rng = np.random.RandomState(3)
    B, T, n, D = 2, 40, 4, 8
    img = rng.randn(B, n * n, D).astype(np.float32)
    tok = rng.randn(B, T, D).astype(np.float32)
    bbox = np.sort(rng.rand(B, T, 4).astype(np.float32), axis=-1)
    bbox = bbox[..., [0, 2, 1, 3]]
    bbox[0, 30:] = 0.0            # pad tokens: no patch, still claim one
    bbox[1, 5] = 1.0              # full-page box
    mask = (bbox.sum(-1) > 0).astype(np.int32)
    want = jfusion.combine_image_text_embeddings(
        jnp.asarray(img), jnp.asarray(tok), jnp.asarray(bbox),
        jnp.asarray(mask), n)
    got = tfusion.combine_image_text_embeddings(
        torch.from_numpy(img), torch.from_numpy(tok), torch.from_numpy(bbox),
        torch.from_numpy(mask), n)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=0)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(tfusion.get_visual_bbox(n).numpy(),
                                  np.asarray(jfusion.get_visual_bbox(n)))
