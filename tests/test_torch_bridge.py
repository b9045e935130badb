"""JAX -> torch -> JAX weight round trip on the tiny config is bit-equal, and
the torch state_dict loads into the port's modules with every key used."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.linen import meta

from markushgrapher_tpu.config import MarkushGrapherConfig, SwinConfig, VTLConfig
from markushgrapher_tpu.models.markushgrapher import MarkushGrapherModel as JModel
from markushgrapher_torch.convert.from_jax import params_from_jax, params_to_jax
from markushgrapher_torch.models.markushgrapher import MarkushGrapherModel

T = 496


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


@pytest.mark.parametrize("variant", ["none", "me-lf-stack-1"])
def test_round_trip_bit_equal(variant):
    cfg = MarkushGrapherConfig(
        vtl=VTLConfig(vocab_size=128, d_model=32, d_kv=4, d_ff=64,
                      num_layers=2, num_decoder_layers=2, num_heads=8,
                      image_size=64, patch_size=16, dropout_rate=0.0),
        swin=SwinConfig(image_size=32, patch_size=2, embed_dim=8,
                        depths=(2, 2), num_heads=(2, 4), window_size=4),
        architecture_variant=variant, max_seq_length=T,
        max_seq_length_decoder=8)
    rng = np.random.RandomState(0)
    batch = dict(
        input_ids=jnp.asarray(rng.randint(3, 120, size=(1, T))),
        bbox=jnp.asarray(rng.rand(1, T, 4).astype(np.float32)),
        attention_mask=jnp.ones((1, T), jnp.int32),
        labels=jnp.zeros((1, 8), jnp.int32),
        pixel_values=jnp.asarray(rng.rand(1, 64, 64, 3), jnp.float32),
        ocsr_pixel_values=jnp.asarray(rng.rand(1, 32, 32, 3), jnp.float32))
    params = meta.unbox(JModel(cfg, dtype=jnp.float32).init(
        jax.random.PRNGKey(0), **batch))
    tree = jax.tree.map(np.asarray, params)

    sd = params_from_jax(tree)
    model = MarkushGrapherModel(cfg)
    model.load_state_dict(sd)                       # strict: names + shapes
    back = params_to_jax(model.state_dict(), cfg)

    want = dict(_leaves(tree["params"]))
    got = dict(_leaves(back["params"]))
    assert sorted(got) == sorted(want)
    for name, arr in want.items():
        assert got[name].shape == arr.shape, name
        assert got[name].dtype == np.float32
        np.testing.assert_array_equal(got[name], arr, err_msg=name)
    # torch Linear layout [out, in]
    assert sd["encoder.layer_0.ff.wi.weight"].shape == (64, 32)
    assert torch.equal(sd["lm_head.weight"],
                       torch.tensor(tree["params"]["lm_head"]["kernel"].T))
