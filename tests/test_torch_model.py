"""The PyTorch port's model against the JAX reference on the CPU, at a tiny
config where the JAX flash + int8-bias branch engages (496 text + 16 patch
positions = 512), the port's model on its int8 slab route: Swin output,
encoder states, and greedy tokens under the serving quantisation (int4 KV,
int8 weights, cross packing)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.linen import meta

from markushgrapher_tpu.config import MarkushGrapherConfig, SwinConfig, VTLConfig
from markushgrapher_tpu.decode import generate as jgen
from markushgrapher_tpu.models import markushgrapher as jmg
from markushgrapher_torch.convert.from_jax import params_from_jax
from markushgrapher_torch.decode import generate as tgen
from markushgrapher_torch.models import markushgrapher as tmg
from markushgrapher_torch.models.swin import SwinEncoder

T = 496
MAX_LEN = 8


def tiny_cfg(variant):
    return MarkushGrapherConfig(
        vtl=VTLConfig(vocab_size=128, d_model=32, d_kv=4, d_ff=64,
                      num_layers=2, num_decoder_layers=2, num_heads=8,
                      image_size=64, patch_size=16, dropout_rate=0.0),
        swin=SwinConfig(image_size=16, patch_size=2, embed_dim=8,
                        depths=(1,), num_heads=(2,), window_size=4),
        architecture_variant=variant, max_seq_length=T,
        max_seq_length_decoder=MAX_LEN)


def tiny_batch(seed=0, batch=2):
    rng = np.random.RandomState(seed)
    n_valid = [300, 180][:batch]
    bbox = np.sort(rng.rand(batch, T, 4).astype(np.float32), axis=-1)
    bbox = bbox[..., [0, 2, 1, 3]]          # x0 <= x1, y0 <= y1
    mask = np.zeros((batch, T), np.int32)
    for b, n in enumerate(n_valid):
        mask[b, :n] = 1
        bbox[b, n:] = 0.0
    return dict(
        input_ids=rng.randint(3, 120, size=(batch, T)).astype(np.int32),
        bbox=bbox, attention_mask=mask,
        pixel_values=rng.rand(batch, 64, 64, 3).astype(np.float32),
        ocsr_pixel_values=rng.rand(batch, 16, 16, 3).astype(np.float32))


def jax_model(cfg, **kw):
    return jmg.MarkushGrapherModel(cfg, dtype=jnp.float32,
                                   flash_attention=True, bias_int8=True,
                                   int4_cross=True, **kw)


def torch_pair(variant, seed=0):
    """(cfg, batch, JAX params, torch model) with the same weights."""
    cfg = tiny_cfg(variant)
    batch = tiny_batch(seed)
    init_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    init_batch["labels"] = jnp.zeros((2, MAX_LEN), jnp.int32)
    params = meta.unbox(jax_model(cfg).init(jax.random.PRNGKey(seed),
                                            **init_batch))
    tree = jax.tree.map(np.asarray, params)
    model = tmg.MarkushGrapherModel(cfg, bias_int8=True)
    model.load_state_dict(params_from_jax(tree))
    return cfg, batch, params, model


def jax_encode(cfg, params, batch, **kw):
    args = [jnp.asarray(batch[k]) for k in
            ("input_ids", "bbox", "attention_mask", "pixel_values",
             "ocsr_pixel_values")]
    return jax_model(cfg, **kw).apply(
        params, *args, method=jmg.MarkushGrapherModel.encode)


def torch_encode(model, batch):
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    return model.encode(t["input_ids"], t["bbox"], t["attention_mask"],
                        t["pixel_values"], t["ocsr_pixel_values"])


@pytest.fixture(scope="module", params=["none", "me-lf-stack-1",
                                        "me-lf-stack-1-molscribe-only"])
def pair(request):
    return torch_pair(request.param)


def test_encoder_states_match(pair):
    """Same int8 slab (gather builder on the JAX side, the port's builder is
    bit-exact against it), so only float order differs: 1e-4 relative to the
    largest state."""
    cfg, batch, params, model = pair
    enc_j, mask_j = jax_encode(cfg, params, batch)
    enc_t, mask_t = torch_encode(model, batch)
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
    ref = np.asarray(enc_j)
    err = np.abs(enc_t.numpy() - ref).max() / np.abs(ref).max()
    assert err < 1e-4, err


def test_swin_matches():
    scfg = SwinConfig(image_size=32, patch_size=2, embed_dim=8,
                      depths=(2, 2), num_heads=(2, 4), window_size=4)
    from markushgrapher_tpu.models.swin import SwinEncoder as JSwin

    x = np.random.RandomState(5).rand(2, 32, 32, 3).astype(np.float32)
    jm = JSwin(scfg, dtype=jnp.float32)
    params = meta.unbox(jm.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    ref = np.asarray(jm.apply(params, jnp.asarray(x)))
    model = SwinEncoder(scfg)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-4 * np.abs(ref).max(),
                               rtol=0)


@pytest.mark.parametrize("bias_kernel", [False, True])
def test_greedy_tokens_identical(pair, bias_kernel):
    """Greedy ids equal JAX greedy_generate at f32 under int4 KV, int8
    weights and cross packing; with bias_kernel the JAX encode uses its
    one-hot builder (<= 1 LSB on a few slab entries)."""
    cfg, batch, params, model = pair
    enc_j, mask_j = jax_encode(cfg, params, batch, bias_kernel=bias_kernel)
    pack = -(-jmg.encoder_valid_max(cfg, jnp.asarray(batch["bbox"]),
                                    jnp.asarray(batch["attention_mask"]))
             // 256) * 256
    ids_j = jgen.greedy_generate(
        jax_model(cfg, bias_kernel=bias_kernel), params, enc_j, mask_j,
        MAX_LEN, eos_id=1, quant_cross_kv=True, quant_weights=True,
        cross_pack_len=pack)
    enc_t, mask_t = torch_encode(model, batch)
    ids_t = tgen.greedy_generate(model, enc_t, mask_t, MAX_LEN, eos_id=1,
                                 quant_cross_kv=True, quant_weights=True,
                                 cross_pack_len=pack)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))


def test_row_budget_zero_emits_only_pad(pair):
    """A budget of 0 emits only pad (the reference emits one token there);
    other rows keep their greedy tokens up to their budget."""
    cfg, batch, _, model = pair
    enc, mask = torch_encode(model, batch)
    quant = dict(quant_cross_kv=True, quant_weights=True)
    full = tgen.greedy_generate(model, enc, mask, MAX_LEN, eos_id=-1, **quant)
    capped = tgen.greedy_generate(model, enc, mask, MAX_LEN, eos_id=-1,
                                  row_budgets=torch.tensor([0, 3]), **quant)
    assert (capped[0] == 0).all()
    assert torch.equal(capped[1, :3], full[1, :3])
    assert (capped[1, 3:] == 0).all()


def test_encoder_valid_max_matches(pair):
    cfg, batch, _, _ = pair
    want = jmg.encoder_valid_max(cfg, jnp.asarray(batch["bbox"]),
                                 jnp.asarray(batch["attention_mask"]))
    got = tmg.encoder_valid_max(cfg, torch.from_numpy(batch["bbox"]),
                                torch.from_numpy(batch["attention_mask"]))
    assert got == want


@pytest.mark.parametrize("variant", ["none", "me-lf-stack-1",
                                     "me-lf-stack-1-molscribe-only"])
def test_ragged_length_encode_goes_through_kernel_wrappers(variant,
                                                           monkeypatch):
    """At a fused length that is no 256-multiple (200 text + 16 patches) the
    encoder still runs the int8 slab builder once and the flash wrapper in
    every layer (no quiet switch to another path). The JAX reference serves
    this length with a float bias, so the states differ by the int8 slab's
    rounding (at most half a step, max|table sum| / 254, per bias entry):
    measured 2.2e-3 of the largest state here, held to 1e-2. The
    molscribe-only variant has no VTL encoder: no bias or flash call, and
    its states are the OCSR branch's, held the same way."""
    from markushgrapher_torch.ops import bias_build, flash_attention

    calls = {"bias": 0, "flash": 0}

    def spy(key, fn):
        def call(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return call

    monkeypatch.setattr(bias_build, "encoder_position_bias_kernel_i8",
                        spy("bias", bias_build.encoder_position_bias_kernel_i8))
    monkeypatch.setattr(flash_attention, "flash_attention_bias_i8",
                        spy("flash", flash_attention.flash_attention_bias_i8))
    cfg = dataclasses.replace(tiny_cfg(variant), max_seq_length=200)
    batch = {k: (v[:, :200] if k in ("input_ids", "bbox", "attention_mask")
                 else v) for k, v in tiny_batch(1).items()}
    init_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    init_batch["labels"] = jnp.zeros((2, MAX_LEN), jnp.int32)
    params = meta.unbox(jax_model(cfg).init(jax.random.PRNGKey(1),
                                            **init_batch))
    model = tmg.MarkushGrapherModel(cfg, bias_int8=True)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    enc_t, mask_t = torch_encode(model, batch)
    vtl = variant != "me-lf-stack-1-molscribe-only"
    assert calls == {"bias": int(vtl), "flash": cfg.vtl.num_layers * vtl}
    enc_j, mask_j = jax_encode(cfg, params, batch)
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
    ref = np.asarray(enc_j)
    assert enc_t.shape[1] % 256 != 0
    err = np.abs(enc_t.numpy() - ref).max() / np.abs(ref).max()
    assert err < 1e-2, err
