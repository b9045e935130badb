"""The port's quantised decode weights against the JAX package on the CPU at
f32: int4 weights (`weight_bits=4`) and W8A8 dots (`act_quant=True`), at the
tiny configs of test_torch_beam.py / test_torch_ocr.py (the JAX decode
kernels in Pallas interpret mode).

Codes and scales are bit for bit JAX's `_quantize_w` / `_act_q8` (the JAX
functions called eagerly, whose divisions are IEEE quotients), and W8A8
products JAX's `_dot8` exactly; decode-step logits agree within 1e-4 and
generated ids are token for token JAX's: MG greedy under int8 and int4 KV,
beam-5 under int4 KV (the JAX beam pinned to one self-ring segment, as
test_torch_beam.py pins it) and `generate` with cross packing; ChemicalOCR
`generate_batch` under int8 and int4 rings, its continuous batching and
`predict(stream=True)`. Also the refusal JAX keeps, W8A8 with int4
weights (the megastep's under either mode: test_torch_ocr.py)."""

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
from markushgrapher_tpu.models import t5 as jt5
from markushgrapher_tpu.ocr import engine as j_eng
from markushgrapher_tpu.ocr import vlm as j_vlm
from markushgrapher_tpu.ops.relbias import mask_bias as j_mask_bias
from markushgrapher_torch.convert.from_jax import params_from_jax
from markushgrapher_torch.data.vocab import MGTokenizer as TTokenizer
from markushgrapher_torch.decode import generate as tgen
from markushgrapher_torch.models import markushgrapher as tmg
from markushgrapher_torch.ocr import engine as t_eng
from markushgrapher_torch.ops import wq_linear as wq
from test_torch_model import jax_encode, tiny_batch, tiny_cfg, torch_encode
from test_torch_ocr import make_pair

MAX_LEN = 16
BEAMS = 5
# (weight_bits, act_quant) of the two modes
MODES = {"w4": dict(weight_bits=4), "w8a8": dict(act_quant=True)}
QUANT = dict(quant_cross_kv=True, quant_weights=True)


def jax_model(cfg, int4):
    return jmg.MarkushGrapherModel(cfg, dtype=jnp.float32,
                                   flash_attention=True, bias_int8=True,
                                   int4_cross=int4)


@pytest.fixture(scope="module")
def setup():
    """(cfg, batch, JAX params, torch model, JAX encoder states and mask,
    cross pack length), the same weights on both sides."""
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


def codes(q) -> np.ndarray:
    """JAX codes (int8 or native int4) as int8 numpy."""
    return np.asarray(q).astype(np.int8)


def as_rows(q, n_in: int) -> np.ndarray:
    """A JAX kernel-layout weight [in axes..., out axes...] with `n_in`
    input axes as the port's [out, in]."""
    q = codes(q)
    n = int(np.prod(q.shape[:n_in]))
    return q.reshape(n, -1).T


def port_codes(qw, key) -> np.ndarray:
    q = qw[key + "_q"]
    return (wq.unpack_w4(q) if qw["bits"] == 4 else q).numpy()


def assert_dicts_equal(tq, jq, layout):
    """layout: {port key: (JAX key or keys concatenated, input axes)}."""
    assert tq["act_s8"] == ("act_s8" in jq)
    for key, (jkeys, n_in) in layout.items():
        want_q = np.concatenate([as_rows(jq[k + "_q"], n_in) for k in jkeys])
        want_s = np.concatenate([np.asarray(jq[k + "_s"]).reshape(-1)
                                 for k in jkeys])
        np.testing.assert_array_equal(port_codes(tq, key), want_q,
                                      err_msg=key)
        np.testing.assert_array_equal(tq[key + "_s"].numpy(), want_s,
                                      err_msg=key)


@pytest.mark.parametrize("bits,act", [(8, False), (4, False), (8, True)])
def test_decoder_layer_dict_matches_jax(setup, bits, act):
    """Every decode weight of every MG decoder layer, and the lm_head (int8
    at any bits), bit for bit JAX's."""
    cfg, _, params, model, *_ = setup
    jq = jax_model(cfg, True).apply(
        params, bits, act, method=jmg.MarkushGrapherModel.quantize_weights)
    tq = model.quantize_weights(bits, act)
    layout = {"qkv": (("qkv",), 1), "self_o": (("self_o",), 2),
              "cross_q": (("cross_q",), 1), "cross_o": (("cross_o",), 2),
              "wi": (("wi",), 1), "wo": (("wo",), 1)}
    for t_layer, j_layer in zip(tq["layers"], jq["layers"]):
        assert t_layer["bits"] == bits
        assert_dicts_equal(t_layer, j_layer, layout)
    np.testing.assert_array_equal(tq["lm_head"]["q"].numpy(),
                                  as_rows(jq["lm_head"]["q"], 1))
    np.testing.assert_array_equal(tq["lm_head"]["s"].numpy(),
                                  np.asarray(jq["lm_head"]["s"]))


@pytest.mark.parametrize("name", ["h4g2", "h15g5"])
@pytest.mark.parametrize("bits,act", [(8, False), (4, False), (8, True)])
def test_ocr_layer_dict_matches_jax(name, bits, act):
    """Every decode weight of every OCR LM layer (gate and up stacked, as
    JAX's gu) and the LM head, bit for bit JAX's."""
    _, _, jmodel, params, tmodel, _, _ = make_pair(name)
    jq = jmodel.apply(params, bits, act,
                      method=j_vlm.ChemicalOCRModel.quantize_weights)
    tq = tmodel.quantize_weights(bits, act)
    layout = {"qkv": (("qkv",), 1), "o": (("o",), 2), "gu": (("gu",), 1),
              "down": (("down",), 1)}
    for t_layer, j_layer in zip(tq["layers"], jq["layers"]):
        assert_dicts_equal(t_layer, j_layer, layout)
    np.testing.assert_array_equal(tq["lm_head"]["w"].numpy(),
                                  codes(jq["lm_head"]["q"]).astype(np.float32))
    np.testing.assert_array_equal(tq["lm_head"]["s"].numpy(),
                                  np.asarray(jq["lm_head"]["s"]))


def test_pack_w4_layout_and_round_trip():
    """Byte j of a row: code 2j in the low nibble, 2j + 1 in the high one,
    two's complement; unpack_w4 inverts pack_w4 over every code pair."""
    c = torch.tensor([[1, -2, 7, -8], [-7, 0, 3, 5]], dtype=torch.int8)
    assert wq.pack_w4(c).tolist() == [[0xE1, 0x87], [0x09, 0x53]]
    every = torch.tensor(np.stack(np.meshgrid(np.arange(-8, 8),
                                              np.arange(-8, 8))).reshape(2, -1)
                         .T.reshape(1, -1), dtype=torch.int8)
    assert torch.equal(wq.unpack_w4(wq.pack_w4(every)), every)
    rng = np.random.RandomState(0)
    w = torch.tensor(rng.randn(24, 40).astype(np.float32))
    q4, s4 = wq.quantize_w(w, 4)
    assert q4.dtype == torch.uint8 and q4.shape == (24, 20)
    assert int(wq.unpack_w4(q4).abs().max()) == 7
    with pytest.raises(ValueError):
        wq.pack_w4(c[:, :3])
    with pytest.raises(ValueError):
        wq.quantize_w(w, 2)


@pytest.mark.parametrize("shape,axes", [((6, 1, 40), (-1,)),
                                        ((3, 1, 5, 8), (-2, -1))])
def test_quantize_act8_matches_jax(shape, axes):
    """Codes and scales of `_act_q8` bit for bit, over the last axis and
    over heads x d_kv (the o projection's activation, which the port flattens
    first), with exact half-integer ties among the inputs."""
    rng = np.random.RandomState(1)
    x = rng.randn(*shape).astype(np.float32)
    x.reshape(-1)[::7] = 0.5
    x[0] = 0.0                                           # an all-zero row
    jq, js = jt5._act_q8(jnp.asarray(x), axes)
    flat = torch.tensor(x.reshape(*shape[:2], -1) if len(axes) == 2 else x)
    tq, ts = wq.quantize_act8(flat)
    np.testing.assert_array_equal(tq.numpy(), codes(jq).reshape(tq.shape))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js).reshape(ts.shape))


@pytest.mark.parametrize("proj", ["in", "o"])
@pytest.mark.parametrize("rows", [1, 6])
def test_w8a8_plain_matches_dot8(proj, rows):
    """wq_linear_plain under W8A8 equals JAX's `_dot8` times the weight
    scale at f32, bit for bit: a projection over the last axis, and the o
    projection whose activation JAX quantises over heads x d_kv."""
    rng = np.random.RandomState(rows)
    h, d, out = 4, 16, 24
    if proj == "in":
        x = rng.randn(rows, 1, h * d).astype(np.float32)
        w = rng.randn(h * d, out).astype(np.float32) * 0.1
        jq, js = jt5._quantize_w(jnp.asarray(w), (0,), 8)
        y = jt5._dot8(jnp.asarray(x), jq, (((2,), (0,)), ((), ())))
        xt = torch.tensor(x)
    else:
        x = rng.randn(rows, 1, h, d).astype(np.float32)
        w = rng.randn(h, d, out).astype(np.float32) * 0.1
        jq, js = jt5._quantize_w(jnp.asarray(w), (0, 1), 8)
        y = jt5._dot8(jnp.asarray(x), jq, (((2, 3), (0, 1)), ((), ())),
                      act_axes=(-2, -1))
        xt = torch.tensor(x.reshape(rows, 1, h * d))
    want = np.asarray((y * js).astype(jnp.float32))
    tq, ts = wq.quantize_w(torch.tensor(w.reshape(h * d, out).T.copy()), 8)
    got = wq.wq_linear_plain(xt, tq, ts, 8, act=True)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(wq.wq_linear(xt, tq, ts, 8, True), got)


@pytest.mark.parametrize("bits", [8, 4])
def test_weight_only_plain_matches_deq_dot(bits):
    """int8 / int4 weight-only products against JAX's `_deq` dot times the
    scale at f32 (the sums in another order: within 1e-5 relative)."""
    rng = np.random.RandomState(bits)
    x = rng.randn(5, 1, 64).astype(np.float32)
    w = rng.randn(64, 48).astype(np.float32) * 0.1
    jq, js = jt5._quantize_w(jnp.asarray(w), (0,), bits)
    y = jnp.einsum("bqd,df->bqf", jnp.asarray(x), jt5._deq(jq, jnp.float32))
    want = np.asarray(y.astype(jnp.float32) * js)
    tq, ts = wq.quantize_w(torch.tensor(w.T.copy()), bits)
    got = wq.wq_linear_plain(torch.tensor(x), tq, ts, bits)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_wq_linear_refuses():
    """W8A8 needs int8 weights; weights must fit the activations."""
    w = torch.randn(8, 64)
    q4, s4 = wq.quantize_w(w, 4)
    x = torch.randn(2, 64)
    with pytest.raises(ValueError, match="W8A8"):
        wq.wq_linear(x, q4, s4, 4, act=True)
    with pytest.raises(ValueError, match="do not fit"):
        wq.wq_linear(x, q4, s4, 8)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_decode_step_logits_match_jax(setup, mode):
    """Four decode steps from JAX's encoder states under int4 KV: float32
    logits within 1e-4 of JAX's `decode_step` (called eagerly), each side
    fed JAX's argmax tokens."""
    cfg, _, params, model, enc_j, mask_j, _ = setup
    bits, act = MODES[mode].get("weight_bits", 8), \
        MODES[mode].get("act_quant", False)
    jm = jax_model(cfg, True)
    jcaches = jm.apply(params, enc_j, MAX_LEN, True,
                       method=jmg.MarkushGrapherModel.init_cache)
    jqw = jm.apply(params, bits, act,
                   method=jmg.MarkushGrapherModel.quantize_weights)
    jbias = jm.apply(params, MAX_LEN,
                     method=jmg.MarkushGrapherModel.full_decoder_bias)
    jcross = j_mask_bias(mask_j)
    model.int4_cross = True
    enc = torch.from_numpy(np.array(enc_j))
    mask = torch.from_numpy(np.array(mask_j))
    caches, qw, bias_full, cross_bias = tgen._prepare(
        model, enc, mask, MAX_LEN, None, True, True, bits, act)
    tok = np.zeros((2, 1), np.int32)
    for step in range(4):
        jl, jcaches = jm.apply(params, jnp.asarray(tok), jcaches,
                               jnp.int32(step), jbias, jcross, jqw,
                               method=jmg.MarkushGrapherModel.decode_step)
        tl = model.decode_step(torch.tensor(tok, dtype=torch.long), caches,
                               step, bias_full, cross_bias, qw)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4, err_msg=f"step {step}")
        tok = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("kv", ["int8", "int4"])
def test_greedy_ids_match_jax(setup, kv, mode):
    """Greedy ids token for token JAX's greedy_generate under int8 / int4
    KV with int4 weights or W8A8, cross packing on, each side on its own
    encoder states."""
    cfg, batch, params, model, enc_j, mask_j, pack = setup
    model.int4_cross = kv == "int4"
    ids_j = jgen.greedy_generate(
        jax_model(cfg, kv == "int4"), params, enc_j, mask_j, MAX_LEN,
        eos_id=1, cross_pack_len=pack, **QUANT, **MODES[mode])
    enc_t, mask_t = torch_encode(model, batch)
    ids_t = tgen.greedy_generate(model, enc_t, mask_t, MAX_LEN, eos_id=1,
                                 cross_pack_len=pack, **QUANT, **MODES[mode])
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_beam_matches_jax(setup, monkeypatch, mode):
    """Beam-5 under int4 KV: ids identical, scores within 1e-4, from the
    same encoder states (the JAX beam pinned to one self-ring segment)."""
    cfg, _, params, model, enc_j, mask_j, pack = setup
    monkeypatch.setattr(jgen, "_pick_self_seg", lambda max_len: max_len)
    model.int4_cross = True
    kw = dict(eos_id=-1, cross_pack_len=pack, **QUANT, **MODES[mode])
    ids_j, sc_j = jgen.beam_generate(jax_model(cfg, True), params, enc_j,
                                     mask_j, MAX_LEN, BEAMS, **kw)
    ids_t, sc_t = tgen.beam_generate(
        model, torch.from_numpy(np.array(enc_j)),
        torch.from_numpy(np.array(mask_j)), MAX_LEN, BEAMS, **kw)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    np.testing.assert_allclose(sc_t.numpy(), np.asarray(sc_j), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_generate_with_cross_pack_matches_jax(setup, mode):
    """`generate` (encode + greedy) with cross_pack_len under int4 KV: the
    same ids as JAX's."""
    cfg, batch, params, model, *_, pack = setup
    model.int4_cross = True
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    ids_j = jgen.generate(jax_model(cfg, True), params, jbatch, MAX_LEN,
                          eos_id=1, cross_pack_len=pack, **QUANT,
                          **MODES[mode])
    ids_t = tgen.generate(model, {k: torch.from_numpy(v)
                                  for k, v in batch.items()},
                          MAX_LEN, eos_id=1, cross_pack_len=pack, **QUANT,
                          **MODES[mode])
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))


def test_mg_refusals(setup):
    """act with bits=4 raises in both models; every other form builds."""
    cfg, _, params, model, *_ = setup
    with pytest.raises(ValueError, match="bits=4"):
        jax_model(cfg, True).apply(
            params, 4, True, method=jmg.MarkushGrapherModel.quantize_weights)
    with pytest.raises(ValueError, match="bits=4"):
        model.quantize_weights(4, True)
    for bits, act in ((8, False), (4, False), (8, True)):
        layer = model.quantize_weights(bits, act)["layers"][0]
        assert (layer["bits"], layer["act_s8"]) == (bits, act)


def ocr_engines(name, ring, **kw):
    """(JAX engine, port engine) over make_pair's weights at f32."""
    _, _, jmodel, params, tmodel, _, _ = make_pair(name)
    flags = dict(quant_kv=True, int4_kv=ring == "int4", quant_weights=True,
                 **kw)
    return (j_eng.ChemicalOCR(jmodel, params, JTokenizer(),
                              j_eng.OCREngineConfig(**flags)),
            t_eng.ChemicalOCR(tmodel, TTokenizer(),
                              t_eng.OCREngineConfig(**flags), device="cpu"))


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("ring", ["int8", "int4"])
def test_ocr_generate_batch_matches_jax(ring, mode):
    """ChemicalOCR greedy ids identical to the JAX engine's at the 15 / 5
    grouping, int8 and int4 rings, int4 weights or W8A8."""
    jeng, teng = ocr_engines("h15g5", ring, max_new_tokens=8, batch_size=2,
                             eos_id=-1, **MODES[mode])
    pix = make_pair("h15g5")[5]
    np.testing.assert_array_equal(teng.generate_batch_async(pix).numpy(),
                                  np.asarray(jeng.generate_batch_async(pix)))
    assert teng.generate_batch(pix) == jeng.generate_batch(pix)


def test_ocr_stream_matches_jax():
    """Continuous batching under int4 rings and int4 weights: 6 images with
    budgets through 3 rows, refill waves of 2, the ids and retirement order
    of JAX's stream; then predict(stream=True) under W8A8 gives JAX's
    cells."""
    jeng, teng = ocr_engines("h4g2", "int4", max_new_tokens=6, batch_size=3,
                             eos_id=-1, weight_bits=4)
    images = np.random.RandomState(4).rand(6, 32, 32, 3).astype(np.float32)
    kw = dict(budgets=[6, 2, 5, 1, 6, 3], batch=3, refill_batch=2, inner=2)
    want = list(jeng.stream_retired(images, **kw))
    got = list(teng.stream_retired(images, **kw))
    assert [i for i, _ in got] == [i for i, _ in want]
    for (i, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=f"image {i}")
    pytest.importorskip("PIL")
    jeng, teng = ocr_engines("h4g2", "int4", max_new_tokens=6, batch_size=2,
                             stream=True, refill_batch=2, stream_inner=2,
                             act_quant=True)
    samples = [{"page_image": np.full((48, 48, 3), i * 40, np.uint8)}
               for i in range(5)]
    assert teng.predict(samples, image_size=32) == jeng.predict(
        samples, image_size=32)
