"""The port's beam search and its KV schemes against the JAX package on the
CPU at f32, on the tiny config of test_torch_model.py (Pallas in interpret
mode on the JAX side): beam-5 tokens identical and scores within 1e-4 under
int4 and int8 KV with int8 weights and under float KV with float weights
(the reference's predict mode; bf16 on the card, float32 here), over length
penalties, an eos that fires mid-decode and `early_stopping`; greedy tokens
identical under int8 KV with int8 weights, float KV with float weights, and
int8 KV with float weights; num_beams=1 equal to greedy."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.linen import meta

from markushgrapher_tpu.decode import generate as jgen
from markushgrapher_tpu.models import markushgrapher as jmg
from markushgrapher_torch.convert.from_jax import params_from_jax
from markushgrapher_torch.decode import generate as tgen
from markushgrapher_torch.models import markushgrapher as tmg
from test_torch_model import jax_encode, tiny_batch, tiny_cfg, torch_encode

MAX_LEN = 16
BEAMS = 5
KV = {"int4": True, "int8": False, "float": False}
QUANT = dict(quant_cross_kv=True, quant_weights=True)


def flags(kv):
    """generate's flags of a KV scheme: quantised KV with int8 weights, or
    float caches with the model's weights."""
    quant = kv != "float"
    return dict(quant_cross_kv=quant, quant_weights=quant)


def jax_model(cfg, int4):
    return jmg.MarkushGrapherModel(cfg, dtype=jnp.float32,
                                   flash_attention=True, bias_int8=True,
                                   int4_cross=int4)


@pytest.fixture(scope="module")
def setup():
    """(cfg, batch, JAX params, torch model, JAX encoder states and mask,
    cross pack length) with the same weights on both sides."""
    cfg = dataclasses.replace(tiny_cfg("none"),
                              max_seq_length_decoder=MAX_LEN)
    batch = tiny_batch(0)
    init_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    init_batch["labels"] = jnp.zeros((2, MAX_LEN), jnp.int32)
    params = meta.unbox(jax_model(cfg, True).init(jax.random.PRNGKey(0),
                                                  **init_batch))
    model = tmg.MarkushGrapherModel(cfg, bias_int8=True)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    enc, mask = jax_encode(cfg, params, batch)
    pack = -(-jmg.encoder_valid_max(cfg, jnp.asarray(batch["bbox"]),
                                    jnp.asarray(batch["attention_mask"]))
             // 256) * 256
    return cfg, batch, params, model, enc, mask, pack


def _eos_mid_decode(model, enc, mask, pack, kv):
    """A token the eos-free best hypothesis of row 1 emits at step 5, so
    that as eos it fires mid-decode and finished hypotheses of several
    lengths merge."""
    ids, _ = tgen.beam_generate(model, enc, mask, MAX_LEN, BEAMS, eos_id=-1,
                                cross_pack_len=pack, **flags(kv))
    return int(ids[1, 5])


@pytest.mark.parametrize("length_penalty,eos,early_stopping", [
    (0.5, "mid", False), (1.0, "mid", False), (2.0, "mid", False),
    (1.0, "never", False), (1.0, "mid", True)])
@pytest.mark.parametrize("kv", ["int4", "int8", "float"])
def test_beam_matches_jax(setup, monkeypatch, kv, length_penalty, eos,
                          early_stopping):
    """Same encoder states into both decoders. The JAX package serves beam
    self rings as one whole-ring segment at its serving length (512 on the
    TPU); off the TPU it picks small segments read through a row map with
    an online softmax across them, so the test pins one segment, the
    configuration the port implements."""
    cfg, _, params, model, enc_j, mask_j, pack = setup
    monkeypatch.setattr(jgen, "_pick_self_seg", lambda max_len: max_len)
    model.int4_cross = KV[kv]
    enc = torch.from_numpy(np.array(enc_j))
    mask = torch.from_numpy(np.array(mask_j))
    eos_id = -1 if eos == "never" else _eos_mid_decode(model, enc, mask,
                                                       pack, kv)
    ids_j, sc_j = jgen.beam_generate(
        jax_model(cfg, KV[kv]), params, enc_j, mask_j, MAX_LEN, BEAMS,
        eos_id=eos_id, length_penalty=length_penalty,
        early_stopping=early_stopping, cross_pack_len=pack, **flags(kv))
    ids_t, sc_t = tgen.beam_generate(
        model, enc, mask, MAX_LEN, BEAMS, eos_id=eos_id,
        length_penalty=length_penalty, early_stopping=early_stopping,
        cross_pack_len=pack, **flags(kv))
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    np.testing.assert_allclose(sc_t.numpy(), np.asarray(sc_j), atol=1e-4,
                               rtol=0)


def test_greedy_int8_tokens_identical(setup):
    """Greedy ids equal JAX greedy_generate at f32 under int8 KV, int8
    weights and cross packing, each side on its own encoder states."""
    cfg, batch, params, model, enc_j, mask_j, pack = setup
    model.int4_cross = False
    ids_j = jgen.greedy_generate(
        jax_model(cfg, False), params, enc_j, mask_j, MAX_LEN, eos_id=1,
        quant_cross_kv=True, quant_weights=True, cross_pack_len=pack)
    enc_t, mask_t = torch_encode(model, batch)
    ids_t = tgen.greedy_generate(model, enc_t, mask_t, MAX_LEN, eos_id=1,
                                 cross_pack_len=pack, **QUANT)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))


@pytest.mark.parametrize("quant_kv,quant_weights", [
    (False, False), (True, False)])
def test_greedy_float_weights_tokens_identical(setup, quant_kv,
                                               quant_weights):
    """Greedy ids equal JAX greedy_generate at f32 with the model's own
    decode weights, over float caches (the reference's default) and over
    int8 KV, each side on its own encoder states."""
    cfg, batch, params, model, enc_j, mask_j, pack = setup
    model.int4_cross = False
    kw = dict(quant_cross_kv=quant_kv, quant_weights=quant_weights)
    ids_j = jgen.greedy_generate(jax_model(cfg, False), params, enc_j, mask_j,
                                 MAX_LEN, eos_id=1, cross_pack_len=pack, **kw)
    enc_t, mask_t = torch_encode(model, batch)
    ids_t = tgen.greedy_generate(model, enc_t, mask_t, MAX_LEN, eos_id=1,
                                 cross_pack_len=pack, **kw)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))


@pytest.mark.parametrize("kv", ["int4", "int8"])
def test_one_beam_equals_greedy(setup, kv):
    """With eos never firing, beam search of width 1 keeps the argmax path;
    generate(num_beams=1) is greedy."""
    _, batch, _, model, _, _, pack = setup
    model.int4_cross = KV[kv]
    enc, mask = torch_encode(model, batch)
    greedy = tgen.greedy_generate(model, enc, mask, MAX_LEN, eos_id=-1,
                                  cross_pack_len=pack, **QUANT)
    beam, _ = tgen.beam_generate(model, enc, mask, MAX_LEN, 1, eos_id=-1,
                                 cross_pack_len=pack, **QUANT)
    assert torch.equal(beam, greedy)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    assert torch.equal(tgen.generate(model, tb, MAX_LEN, num_beams=1,
                                     eos_id=-1, cross_pack_len=pack,
                                     **QUANT), greedy)
