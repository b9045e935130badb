"""The port's ChemicalOCR stage against the JAX package on the CPU, at tiny
configs: the 4-head / 2-kv-head model of tests/test_ocr.py and the OCR LM's
15-head / 5-kv-head grouping scaled down (d_model 60, head dim 4). The same
weights (JAX init, bridged), pixels and prompts go through both; the JAX
decode kernels run in Pallas interpret mode. Also the device pixel
preprocessing, the weight bridge round trip and the engine's config and
input checks."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.linen import meta

from markushgrapher_tpu.data import device_pixels as j_pix
from markushgrapher_tpu.data.vocab import MGTokenizer as JTokenizer
from markushgrapher_tpu.ocr import engine as j_eng
from markushgrapher_tpu.ocr import vlm as j_vlm
from markushgrapher_tpu.ops import mxu_decode as j_mxu
from markushgrapher_torch.convert.from_jax import (params_from_jax,
                                                   params_to_jax)
from markushgrapher_torch.data import device_pixels as t_pix
from markushgrapher_torch.data.vocab import MGTokenizer as TTokenizer
from markushgrapher_torch.ocr import engine as t_eng
from markushgrapher_torch.ocr import vlm as t_vlm
from markushgrapher_torch.ops import mxu_decode as t_mxu

PROMPT_LEN = 5


def ocr_cfg(mod, heads, kv_heads, d_model, max_new=8):
    """tests/test_ocr.py's tiny config (4 / 2 heads, d_model 16) or the
    15 / 5 grouping at d_model 60, built from `mod`'s config classes."""
    return mod.OCRConfig(
        vision=mod.OCRVisionConfig(image_size=32, patch_size=8, d_model=16,
                                   num_layers=1, num_heads=2, d_ff=32),
        text=mod.OCRTextConfig(vocab_size=33201, d_model=d_model,
                               num_layers=2, num_heads=heads,
                               num_kv_heads=kv_heads, d_ff=32,
                               max_position=256),
        pixel_shuffle_factor=2, max_new_tokens=max_new)


SHAPES = {"h4g2": (4, 2, 16), "h15g5": (15, 5, 60)}


@functools.lru_cache(maxsize=None)
def make_pair(name):
    """(name, JAX cfg, JAX model, params, torch model, pixels, prompt) with
    the same float32 weights on both sides."""
    heads, kv, dm = SHAPES[name]
    jcfg = ocr_cfg(j_vlm, heads, kv, dm)
    jmodel = j_vlm.ChemicalOCRModel(jcfg, dtype=jnp.float32)
    rng = np.random.RandomState(0)
    pix = rng.rand(2, 32, 32, 3).astype(np.float32)
    prompt = rng.randint(3, 100, size=(2, PROMPT_LEN)).astype(np.int32)
    params = meta.unbox(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(pix),
                                    jnp.asarray(prompt)))
    tmodel = t_vlm.ChemicalOCRModel(ocr_cfg(t_vlm, heads, kv, dm))
    tmodel.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return name, jcfg, jmodel, params, tmodel, pix, prompt


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_forward_and_prefill_logits(name):
    """Teacher-forced and prefill logits at f32 (op order only differs:
    atol 1e-4 on logits of magnitude ~1)."""
    _, jcfg, jmodel, params, tmodel, pix, prompt = make_pair(name)
    tgt = np.asarray([[7, 9, 11], [13, 15, 17]], np.int32)
    want = np.asarray(jmodel.apply(params, jnp.asarray(pix),
                                   jnp.asarray(prompt), jnp.asarray(tgt)))
    got = tmodel(torch.tensor(pix), torch.tensor(prompt),
                 torch.tensor(tgt)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    for quant_kv, int4 in ((False, False), (True, False), (True, True)):
        jl, jc, jlen = jmodel.apply(
            params, jnp.asarray(pix), jnp.asarray(prompt),
            method=j_vlm.ChemicalOCRModel.prefill, max_len=4,
            quant_kv=quant_kv, int4=int4)
        tl, tc, tlen = tmodel.prefill(torch.tensor(pix), torch.tensor(prompt),
                                      4, quant_kv=quant_kv, int4=int4)
        assert tlen == jlen == jcfg.num_image_tokens + PROMPT_LEN
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
        assert tc[0]["v" if not quant_kv else ("v_q4" if int4 else "v_q")
                     ].shape[1] == 128


@pytest.mark.parametrize("name,ring", [
    ("h4g2", "int4"), ("h15g5", "float"), ("h15g5", "int8"),
    ("h15g5", "int4")])
def test_greedy_tokens_match_jax(name, ring):
    """ChemicalOCR greedy ids identical to the JAX engine at f32: the float
    ring with float weights, the int8 and int4 rings with int8 weights; at
    5 kv heads the int4 heads straddle the nibble split (odd G)."""
    _, jcfg, jmodel, params, tmodel, pix, prompt = make_pair(name)
    quant = ring != "float"
    kw = dict(max_new_tokens=8, batch_size=2, eos_id=-1, quant_kv=quant,
              int4_kv=ring == "int4", quant_weights=quant)
    jeng = j_eng.ChemicalOCR(jmodel, params, JTokenizer(),
                             j_eng.OCREngineConfig(**kw))
    want = np.asarray(jeng.generate_batch_async(pix))
    teng = t_eng.ChemicalOCR(tmodel, TTokenizer(), t_eng.OCREngineConfig(**kw),
                             device="cpu")
    got = teng.generate_batch_async(pix).numpy()
    np.testing.assert_array_equal(got, want)
    assert teng.generate_batch(pix) == jeng.generate_batch(pix)


@pytest.mark.parametrize("groups", [5, 4])
def test_plain_int4_matches_jax_kernel(groups):
    """plain_int4 (the int4 decode kernel's plain version) against the JAX
    cross_decode_mxu_int4 in interpret mode: 15 query heads over 5 kv heads
    of D = 64 (a 160-byte packed row; head 2 straddles the split) and over
    4 (even). Outputs are bf16-rounded on both sides: within one bf16 ulp."""
    rng = np.random.RandomState(groups)
    b, rows, d, k = 2, 15 if groups == 5 else 16, 64, 256
    q = rng.randn(b, rows, d).astype(np.float32) * 0.3
    vals = rng.randint(-7, 8, size=(2, b, k, groups * d)).astype(np.int8)
    sc = (rng.rand(2, b, groups, k) * 0.1).astype(np.float32)
    sc = np.asarray(jnp.asarray(sc).astype(jnp.bfloat16).astype(jnp.float32))
    bias = np.where(np.arange(k) < 200, 0.0,
                    np.finfo(np.float32).min).astype(np.float32)[None, None]
    packed = [np.asarray(j_mxu.pack_int4(jnp.asarray(v))) for v in vals]
    rep = rows // groups
    want = np.asarray(j_mxu.cross_decode_mxu_int4(
        jnp.asarray(q), jnp.asarray(packed[0]),
        jnp.asarray(np.repeat(sc[0], rep, 1)), jnp.asarray(packed[1]),
        jnp.asarray(np.repeat(sc[1], rep, 1)), jnp.asarray(bias)))
    tpack = [t_mxu.pack_int4(torch.tensor(v)) for v in vals]
    assert all(np.array_equal(t.numpy(), p) for t, p in zip(tpack, packed))
    got = t_mxu.plain_int4(torch.tensor(q), tpack[0], torch.tensor(sc[0]),
                           tpack[1], torch.tensor(sc[1]), torch.tensor(bias))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=2 ** -8)


@pytest.mark.parametrize("fn,size", [("ocr_from_uint8", None),
                                     ("vtl_from_uint8", 512),
                                     ("vtl_from_uint8", 384),
                                     ("ocsr_from_uint8", 384)])
def test_device_pixels_match_jax(fn, size):
    """uint8 pages -> each stage's pixels; the 512 -> 384 resize antialiases
    on both sides (jax.image.resize, F.interpolate(antialias=True)): within
    1e-5 absolute (float32 rounding of the filter sums)."""
    pages = np.random.RandomState(1).randint(
        0, 256, size=(2, 512, 512, 3)).astype(np.uint8)
    args = () if size is None else (size,)
    want = np.asarray(getattr(j_pix, fn)(jnp.asarray(pages), *args))
    got = getattr(t_pix, fn)(torch.tensor(pages), *args).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_bridge_round_trip_bit_equal(name):
    """flax tree -> state_dict -> flax tree is bit-equal, leaf by leaf."""
    _, jcfg, _, params, tmodel, _, _ = make_pair(name)
    tree = jax.tree.map(np.asarray, params)
    sd = params_from_jax(tree)
    assert set(sd) == set(tmodel.state_dict())
    back = params_to_jax(sd, tmodel.cfg)
    flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        assert flat_b[path].shape == leaf.shape, path
        assert np.array_equal(flat_b[path], leaf), path


def test_build_ocr_configs():
    """Same configs as JAX for known keys; unknown keys refused on both."""
    ov = {"text.num_layers": 3, "vision.image_size": 64, "max_new_tokens": 16,
          "quant_kv": True, "megastep": True}
    jc, je = j_eng.build_ocr_configs(ov)
    tc, te = t_eng.build_ocr_configs(ov)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert {k: v for k, v in dataclasses.asdict(je).items()
            if k in dataclasses.asdict(te)} == dataclasses.asdict(te)
    for bad in ({"text.bogus": 1}, {"bogus": 1}, {"mega_blocks": 2}):
        with pytest.raises((ValueError, TypeError)):
            j_eng.build_ocr_configs(bad)
        with pytest.raises((ValueError, TypeError)):
            t_eng.build_ocr_configs(bad)


@pytest.mark.parametrize("kw", [
    dict(megastep=True), dict(megastep=True, quant_kv=True, int4_kv=True),
    dict(int4_kv=True)], ids=["mega-float", "mega-int4", "int4-no-quant"])
def test_engine_config_refusals_match_jax(kw):
    with pytest.raises(ValueError):
        j_eng.OCREngineConfig(**kw)
    with pytest.raises(ValueError, match="requires"):
        t_eng.OCREngineConfig(**kw)


def test_engine_config_refuses_unported():
    """Nothing of the JAX config is left unported: its int4 / W8A8
    decode-weight values build as in JAX, and the megastep still refuses
    them, as JAX's does; continuous batching (stream, refill_batch,
    stream_inner) builds as in JAX."""
    for key, value in (("weight_bits", 4), ("act_quant", True)):
        assert getattr(t_eng.build_ocr_configs({key: value})[1], key) \
            == getattr(j_eng.build_ocr_configs({key: value})[1], key) \
            == value
        mega = {key: value, "quant_kv": True, "megastep": True}
        with pytest.raises(ValueError):
            j_eng.build_ocr_configs(mega)
        with pytest.raises(ValueError, match="int8 weights"):
            t_eng.build_ocr_configs(mega)
    for key, value in (("stream", True), ("refill_batch", 16),
                       ("stream_inner", 8)):
        assert getattr(t_eng.build_ocr_configs({key: value})[1], key) \
            == getattr(j_eng.build_ocr_configs({key: value})[1], key) \
            == value


def test_engine_config_takes_every_jax_field():
    """Every field of the JAX OCREngineConfig, at its JAX default, builds in
    the port, one at a time and all together; mega_block_s (the TPU ring
    block) at any value; weight_bits=4 and act_quant=True build, alone and
    together (as in JAX), and both still raise beside megastep=True; the
    model refuses act with bits=4 when it quantises, as JAX's does."""
    jax_fields = dataclasses.fields(j_eng.OCREngineConfig)
    defaults = {f.name: f.default for f in jax_fields}
    for name, value in defaults.items():
        _, eng = t_eng.build_ocr_configs({name: value})
        assert getattr(eng, name) == value
    _, eng = t_eng.build_ocr_configs(defaults)
    assert {f.name: getattr(eng, f.name) for f in jax_fields} == defaults
    assert t_eng.build_ocr_configs({"mega_block_s": 256})[1].mega_block_s \
        == 256
    for ov in ({"weight_bits": 4}, {"act_quant": True},
               {"weight_bits": 4, "act_quant": True}):
        eng = t_eng.build_ocr_configs(ov)[1]
        assert {k: getattr(eng, k) for k in ov} == ov
        j_eng.build_ocr_configs(ov)
        mega = dict(ov, quant_kv=True, megastep=True)
        with pytest.raises(ValueError):
            j_eng.build_ocr_configs(mega)
        with pytest.raises(ValueError, match="weight_bits=8"):
            t_eng.build_ocr_configs(mega)
    _, _, jmodel, params, tmodel, _, _ = make_pair("h4g2")
    with pytest.raises(ValueError, match="bits=4"):
        jmodel.apply(params, 4, True,
                     method=j_vlm.ChemicalOCRModel.quantize_weights)
    with pytest.raises(ValueError, match="bits=4"):
        tmodel.quantize_weights(4, True)


def test_empty_input_and_device():
    """predict([]) is [] (the reference's stream path raised IndexError);
    a zero-row batch is refused; the engine asks for CUDA unless told to
    run on the CPU."""
    cfg = ocr_cfg(t_vlm, 4, 2, 16)
    eng = t_eng.ChemicalOCR(t_vlm.ChemicalOCRModel(cfg), TTokenizer(),
                            t_eng.OCREngineConfig(max_new_tokens=2),
                            device="cpu")
    assert eng.predict([]) == []
    with pytest.raises(ValueError, match="no images"):
        eng.generate_batch(np.zeros((0, 32, 32, 3), np.uint8))
    saved = torch.cuda.is_available
    torch.cuda.is_available = lambda: False
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            t_eng.ChemicalOCR(t_vlm.ChemicalOCRModel(cfg), TTokenizer())
    finally:
        torch.cuda.is_available = saved


def test_predict_cells_uint8_pages():
    """predict over dict rows (uint8 pages resized to the vision size, a
    ragged last batch) gives one cells list per row, as JAX does on the
    same weights."""
    pytest.importorskip("PIL")
    heads, kv, dm = SHAPES["h4g2"]
    jcfg = ocr_cfg(j_vlm, heads, kv, dm, max_new=4)
    jmodel = j_vlm.ChemicalOCRModel(jcfg, dtype=jnp.float32)
    rng = np.random.RandomState(3)
    pages = [{"page_image": rng.randint(0, 256, (40, 48, 3)).astype(np.uint8)}
             for _ in range(3)]
    params = meta.unbox(jmodel.init(
        jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3)),
        jnp.ones((1, PROMPT_LEN), jnp.int32)))
    tmodel = t_vlm.ChemicalOCRModel(ocr_cfg(t_vlm, heads, kv, dm, 4))
    tmodel.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    kw = dict(max_new_tokens=4, batch_size=2)
    want = j_eng.ChemicalOCR(jmodel, params, JTokenizer(),
                             j_eng.OCREngineConfig(**kw)).predict(pages)
    got = t_eng.ChemicalOCR(tmodel, TTokenizer(), t_eng.OCREngineConfig(**kw),
                            device="cpu").predict(pages)
    assert got == want and len(got) == 3
