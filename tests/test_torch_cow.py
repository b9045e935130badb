"""The port's copy-on-write beam rings, valid-prefix ring reads
(`block_skip`) and the lattice reads against the JAX package on the CPU at
f32 (Pallas in interpret mode on the JAX side), on the tiny configs of
test_torch_beam.py and test_torch_ocr.py:
  - beam-5 with the JAX side unpinned (off the TPU it picks segments of 4 at
    MAX_LEN 16: four segments read through a row map, with the online
    softmax across them) and the port given `self_seg=4`: int4 and int8 KV,
    and int4 with the lattice (`BEAM_LATTICE=1` on the JAX side): tokens
    identical, scores within 1e-4;
  - block_skip: MG greedy int8 at 256 steps (two 128-key blocks), the MG
    beam with block_skip composed with the row map, and OCR greedy under
    int4 and int8 rings (ring 256), each against JAX and the port without
    block_skip;
  - `pick_self_seg`'s table and its refusal of a bad BEAM_SELF_SEG."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.linen import meta

from markushgrapher_tpu.data.vocab import MGTokenizer as JTokenizer
from markushgrapher_tpu.decode import generate as jgen
from markushgrapher_tpu.models import markushgrapher as jmg
from markushgrapher_tpu.ocr import engine as j_eng
from markushgrapher_tpu.ocr import vlm as j_vlm
from markushgrapher_torch.convert.from_jax import params_from_jax
from markushgrapher_torch.data.vocab import MGTokenizer as TTokenizer
from markushgrapher_torch.decode import generate as tgen
from markushgrapher_torch.models import markushgrapher as tmg
from markushgrapher_torch.ocr import engine as t_eng
from markushgrapher_torch.ocr import vlm as t_vlm
from test_torch_model import tiny_batch, tiny_cfg
from test_torch_ocr import ocr_cfg

MAX_LEN = 16
BEAMS = 5
SEG = 4                        # the JAX package's choice off the TPU
QUANT = dict(quant_cross_kv=True, quant_weights=True)


def jax_model(cfg, int4, **kw):
    return jmg.MarkushGrapherModel(cfg, dtype=jnp.float32,
                                   flash_attention=True, bias_int8=True,
                                   int4_cross=int4, **kw)


@pytest.fixture(scope="module")
def setup():
    """(cfg, JAX params, torch model, JAX encoder states and mask as numpy,
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
    args = [jnp.asarray(batch[k]) for k in
            ("input_ids", "bbox", "attention_mask", "pixel_values",
             "ocsr_pixel_values")]
    enc, mask = jax_model(cfg, True).apply(
        params, *args, method=jmg.MarkushGrapherModel.encode)
    pack = -(-jmg.encoder_valid_max(cfg, jnp.asarray(batch["bbox"]),
                                    jnp.asarray(batch["attention_mask"]))
             // 256) * 256
    return cfg, params, model, np.asarray(enc), np.asarray(mask), pack


def _beams(setup, kv, lattice, block_skip, monkeypatch, eos_id=-1):
    """(JAX ids, JAX scores, port ids, port scores) of beam-5 over the
    same encoder states, the JAX side choosing its own segments."""
    cfg, params, model, enc, mask, pack = setup
    assert jgen._pick_self_seg(MAX_LEN) == SEG
    if lattice:
        monkeypatch.setenv("BEAM_LATTICE", "1")
    int4 = kv == "int4"
    ids_j, sc_j = jgen.beam_generate(
        jax_model(cfg, int4, block_skip=block_skip), params,
        jnp.asarray(enc), jnp.asarray(mask), MAX_LEN, BEAMS, eos_id=eos_id,
        cross_pack_len=pack, **QUANT)
    tm = model.clone(int4_cross=int4, block_skip=block_skip)
    ids_t, sc_t = tgen.beam_generate(
        tm, torch.tensor(enc), torch.tensor(mask), MAX_LEN, BEAMS,
        eos_id=eos_id, cross_pack_len=pack, self_seg=SEG, lattice=lattice,
        **QUANT)
    return np.asarray(ids_j), np.asarray(sc_j), ids_t.numpy(), sc_t.numpy()


@pytest.mark.parametrize("kv,lattice", [("int4", False), ("int8", False),
                                        ("int4", True)])
def test_cow_beam_matches_unpinned_jax(setup, monkeypatch, kv, lattice):
    """Beam-5 over copy-on-write rings of four segments: the same tokens
    as the JAX package's own segmented beam and scores within 1e-4 (the
    online softmax across segments rounds p * vs against the running max:
    the one-segment port differs from it by up to 2.4e-4)."""
    ids_j, sc_j, ids_t, sc_t = _beams(setup, kv, lattice, False, monkeypatch)
    np.testing.assert_array_equal(ids_t, ids_j)
    np.testing.assert_allclose(sc_t, sc_j, atol=1e-4, rtol=0)


def test_block_skip_beam_matches_jax_and_full_reads(setup, monkeypatch):
    """block_skip composed with the row map (int4, four segments): the
    same tokens and scores as JAX with block_skip and, to the bit, as the
    port without it (the unread keys are the ones the mask zeroes)."""
    ids_j, sc_j, ids_t, sc_t = _beams(setup, "int4", False, True,
                                      monkeypatch)
    np.testing.assert_array_equal(ids_t, ids_j)
    np.testing.assert_allclose(sc_t, sc_j, atol=1e-4, rtol=0)
    cfg, _, model, enc, mask, pack = setup
    ids_f, sc_f = tgen.beam_generate(
        model.clone(int4_cross=True), torch.tensor(enc),
        torch.tensor(mask), MAX_LEN, BEAMS, eos_id=-1,
        cross_pack_len=pack, self_seg=SEG, **QUANT)
    np.testing.assert_array_equal(ids_t, ids_f.numpy())
    np.testing.assert_array_equal(sc_t, sc_f.numpy())


def test_block_skip_greedy_int8_at_256_steps(setup):
    """MG greedy under int8 KV for 256 steps (a ring of two 128-key blocks,
    so the valid prefix and the online softmax over blocks engage): the
    port with block_skip gives JAX's block_skip tokens and its own tokens
    without block_skip."""
    cfg, params, model, enc, mask, pack = setup
    steps = 256
    jm = jax_model(dataclasses.replace(cfg, max_seq_length_decoder=steps),
                   False, block_skip=True)
    want = np.asarray(jgen.greedy_generate(
        jm, params, jnp.asarray(enc), jnp.asarray(mask), steps, eos_id=-1,
        cross_pack_len=pack, **QUANT))
    got = {}
    for skip in (True, False):
        got[skip] = tgen.greedy_generate(
            model.clone(int4_cross=False, block_skip=skip),
            torch.tensor(enc), torch.tensor(mask), steps, eos_id=-1,
            cross_pack_len=pack, **QUANT).numpy()
    np.testing.assert_array_equal(got[True], want)
    np.testing.assert_array_equal(got[True], got[False])


@pytest.mark.parametrize("ring", ["int4", "int8"])
def test_ocr_block_skip_greedy_matches_jax(ring):
    """ChemicalOCR greedy ids with block_skip over a 256-slot ring (prefix
    + 128 new tokens: two 128-key blocks) at the 15-over-5-head grouping:
    the JAX engine's ids with block_skip, and the port's without it."""
    new = 128
    jcfg = ocr_cfg(j_vlm, 15, 5, 60, max_new=new)
    rng = np.random.RandomState(0)
    pix = rng.rand(2, 32, 32, 3).astype(np.float32)
    prompt = rng.randint(3, 100, size=(2, 5)).astype(np.int32)
    jmodel = j_vlm.ChemicalOCRModel(jcfg, dtype=jnp.float32, block_skip=True)
    params = meta.unbox(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(pix),
                                    jnp.asarray(prompt)))
    kw = dict(max_new_tokens=new, batch_size=2, eos_id=-1, quant_kv=True,
              int4_kv=ring == "int4", quant_weights=True)
    want = np.asarray(j_eng.ChemicalOCR(
        jmodel, params, JTokenizer(),
        j_eng.OCREngineConfig(**kw)).generate_batch_async(pix))
    got = {}
    for skip in (True, False):
        tmodel = t_vlm.ChemicalOCRModel(ocr_cfg(t_vlm, 15, 5, 60, new),
                                        block_skip=skip)
        tmodel.load_state_dict(params_from_jax(jax.tree.map(np.asarray,
                                                            params)))
        eng = t_eng.ChemicalOCR(tmodel, TTokenizer(),
                                t_eng.OCREngineConfig(**kw), device="cpu")
        got[skip] = eng.generate_batch_async(pix).numpy()
    np.testing.assert_array_equal(got[True], want)
    np.testing.assert_array_equal(got[True], got[False])


@pytest.mark.parametrize("max_len,env,want", [
    (512, {}, (512, False)),
    (1024, {}, (512, False)),
    (384, {}, (128, False)),
    (16, {}, (0, False)),
    (512, {"BEAM_LATTICE": "1"}, (128, True)),
    (16, {"BEAM_LATTICE": "1"}, (0, True)),
    (512, {"BEAM_SELF_SEG": "256"}, (256, False)),
    (512, {"BEAM_SELF_SEG": "0"}, (0, False)),
    (512, {"BEAM_LATTICE": "1", "BEAM_SELF_SEG": "256"}, (128, True)),
])
def test_pick_self_seg_table(monkeypatch, max_len, env, want):
    """The TPU branch of the reference's `_pick_self_seg` (the JAX side
    answers the same on a TPU backend) and the lattice flag."""
    for name in ("BEAM_LATTICE", "BEAM_SELF_SEG"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    assert tgen.pick_self_seg(max_len) == want
    monkeypatch.setattr(jgen.jax, "default_backend", lambda: "tpu")
    assert jgen._pick_self_seg(max_len) == want[0]


@pytest.mark.parametrize("env,args", [
    ({"BEAM_SELF_SEG": "100"}, {}),          # not a 128-multiple
    ({"BEAM_SELF_SEG": "384"}, {}),          # does not divide 512
    ({}, {"self_seg": 3}),                   # explicit, does not divide
])
def test_pick_self_seg_refuses(monkeypatch, env, args):
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    with pytest.raises(ValueError):
        tgen.pick_self_seg(512, **args)


def test_explicit_arguments_override_the_environment(monkeypatch):
    monkeypatch.setenv("BEAM_LATTICE", "1")
    monkeypatch.setenv("BEAM_SELF_SEG", "256")
    assert tgen.pick_self_seg(512, self_seg=4, lattice=False) == (4, False)
    assert tgen.pick_self_seg(512, lattice=False) == (256, False)
