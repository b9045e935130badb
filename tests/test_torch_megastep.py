"""The whole-step OCR decode (`ops.megastep`, plain version on the CPU)
against the JAX package's `decode_step_mega` (its Pallas kernel in interpret
mode): the same float32 parameters, the same int8 rings (the JAX prefill's)
and the same fed tokens, over 3 steps, at the 15-head / 5-kv-head grouping
(d_model 60) and the 4 / 2 tiny shape. Logits within tests/test_megastep.py's
tolerance (atol 0.15, rtol 0.05: bf16 dots, another summation order) with
equal argmax; the rings after each step equal in the prefix and within one
int8 step (and 1e-5 relative in the scale) in the written columns."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.linen import meta

from markushgrapher_tpu.ocr import vlm as j_vlm
from markushgrapher_tpu.ops.megastep import build_consts
from markushgrapher_torch.convert.from_jax import params_from_jax
from markushgrapher_torch.ocr import engine as t_eng
from markushgrapher_torch.ocr import vlm as t_vlm
from markushgrapher_torch.data.vocab import MGTokenizer
from markushgrapher_torch.ops import _build, megastep

STEPS = 3


def mega_cfg(mod, heads, kv_heads, d_model, vocab=512):
    return mod.OCRConfig(
        vision=mod.OCRVisionConfig(image_size=32, patch_size=8, d_model=16,
                                   num_layers=1, num_heads=2, d_ff=32),
        text=mod.OCRTextConfig(vocab_size=vocab, d_model=d_model, num_layers=2,
                               num_heads=heads, num_kv_heads=kv_heads,
                               d_ff=64, max_position=256),
        pixel_shuffle_factor=2, max_new_tokens=8)


def setup(heads, kv_heads, d_model, seed):
    jcfg = mega_cfg(j_vlm, heads, kv_heads, d_model)
    jmodel = j_vlm.ChemicalOCRModel(jcfg, dtype=jnp.bfloat16)
    rng = np.random.RandomState(seed)
    pix = jnp.asarray(rng.rand(2, 32, 32, 3).astype(np.float32))
    prompt = jnp.asarray(rng.randint(3, 500, size=(2, 5)), jnp.int32)
    params = meta.unbox(jmodel.init(jax.random.PRNGKey(seed), pix, prompt))
    logits0, caches, prefix_len = jmodel.apply(
        params, pix, prompt, method=j_vlm.ChemicalOCRModel.prefill,
        max_len=12, quant_kv=True, int4=False)
    tmodel = t_vlm.ChemicalOCRModel(mega_cfg(t_vlm, heads, kv_heads, d_model))
    tmodel.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return jmodel, params, tmodel, logits0, caches, prefix_len


def deq(vals, scales, groups):
    """Dequantised ring [B, S, G, D] of values [B, S, G*D], scales [B, G, S]."""
    v = np.asarray(vals, np.float32)
    b, s, gd = v.shape
    return v.reshape(b, s, groups, gd // groups) * np.asarray(
        scales, np.float32).transpose(0, 2, 1)[..., None]


@pytest.mark.parametrize("shape", [(15, 5, 60), (4, 2, 16)],
                         ids=["h15g5", "h4g2"])
def test_plain_megastep_matches_jax(shape):
    heads, kv, dm = shape
    jmodel, params, tmodel, logits0, caches, prefix_len = setup(*shape, 2)
    t = jmodel.cfg.text
    d = t.d_model // t.num_heads
    jrings = j_vlm.ChemicalOCRModel.stack_caches(caches)
    ring_len = int(jrings["k_q"].shape[2])
    mw = jmodel.apply(params, method=j_vlm.ChemicalOCRModel.megastep_pack)
    consts = build_consts(2, heads, kv, d)
    trings = {k: torch.tensor(np.asarray(v)) for k, v in jrings.items()}
    tw = tmodel.megastep_pack()
    tok = np.asarray(jnp.argmax(logits0[:, -1], -1), np.int32)[:, None]
    _build.reset_launches()
    for step in range(STEPS):
        want, jrings = jmodel.apply(
            params, jnp.asarray(tok), jrings, step, prefix_len, mw, consts,
            ring_len, method=j_vlm.ChemicalOCRModel.decode_step_mega)
        got = tmodel.decode_step_mega(torch.tensor(tok), trings, step,
                                      prefix_len, tw)
        want, got = np.asarray(want[:, 0]), got[:, 0].numpy()
        np.testing.assert_allclose(got, want, atol=0.15, rtol=0.05)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
        col = prefix_len + step
        for layer in range(t.num_layers):
            for name in ("k", "v"):
                jq = np.asarray(jrings[name + "_q"][layer])
                js = np.asarray(jrings[name + "_s"][layer])
                tq = trings[name + "_q"][layer].numpy()
                ts = trings[name + "_s"][layer].numpy()
                # the prefill's columns stay as they were; the columns
                # written by steps 0..step within one int8 step
                pre, new = slice(0, prefix_len), slice(prefix_len, col + 1)
                np.testing.assert_array_equal(tq[:, pre], jq[:, pre])
                np.testing.assert_array_equal(ts[:, :, pre], js[:, :, pre])
                np.testing.assert_array_equal(tq[:, col + 1:], 0)
                assert np.abs(tq[:, new].astype(int)
                              - jq[:, new].astype(int)).max() <= 1
                np.testing.assert_allclose(ts[:, :, new], js[:, :, new],
                                           rtol=1e-5)
                a = deq(jq, js, kv)[:, new]
                b = deq(tq, ts, kv)[:, new]
                assert np.abs(a - b).max() <= 1.01 * js[:, :, new].max()
        tok = want.argmax(-1).astype(np.int32)[:, None]
    # a CPU tensor takes the plain version: no kernel was launched
    assert _build.LAUNCHES["ocr_megastep"] == 0


def test_megastep_engine_matches_jax_engine_argmax():
    """The engine's megastep path end to end (prefill, pack, stack, 6 steps)
    gives the JAX megastep engine's greedy ids on the same weights at the
    15 / 5 grouping, with bf16 weights on both sides (the port computes in
    its parameters' dtype)."""
    heads, kv, dm = 15, 5, 60
    # the tokenizer's prompt ids need the full vocabulary
    jcfg = mega_cfg(j_vlm, heads, kv, dm, vocab=33201)
    jmodel = j_vlm.ChemicalOCRModel(jcfg, dtype=jnp.bfloat16)
    rng = np.random.RandomState(5)
    pix = rng.rand(2, 32, 32, 3).astype(np.float32)
    params = meta.unbox(jmodel.init(jax.random.PRNGKey(5),
                                    jnp.asarray(pix[:1]),
                                    jnp.ones((1, 5), jnp.int32)))
    params = jax.tree.map(lambda x: x.astype(jnp.bfloat16), params)
    tmodel = t_vlm.ChemicalOCRModel(mega_cfg(t_vlm, heads, kv, dm, 33201))
    tmodel.load_state_dict(params_from_jax(jax.tree.map(
        lambda x: np.asarray(x.astype(jnp.float32)), params)))
    tmodel.to(torch.bfloat16)
    from markushgrapher_tpu.data.vocab import MGTokenizer as JTokenizer
    from markushgrapher_tpu.ocr import engine as j_eng

    kw = dict(max_new_tokens=6, batch_size=2, eos_id=-1, quant_kv=True,
              quant_weights=True, megastep=True)
    want = np.asarray(j_eng.ChemicalOCR(
        jmodel, params, JTokenizer(),
        j_eng.OCREngineConfig(**kw)).generate_batch_async(pix))
    got = t_eng.ChemicalOCR(tmodel, MGTokenizer(), t_eng.OCREngineConfig(**kw),
                            device="cpu").generate_batch_async(pix).numpy()
    np.testing.assert_array_equal(got, want)


def test_megastep_refuses_bad_shapes():
    """The wrapper's checks (they run before any launch)."""
    cfg = mega_cfg(t_vlm, 4, 2, 16)
    model = t_vlm.ChemicalOCRModel(cfg).to(torch.bfloat16)
    w = model.megastep_pack()["lm"]
    rings = {"k_q": torch.zeros((2, 1, 128, 8), dtype=torch.int8),
             "v_q": torch.zeros((2, 1, 128, 8), dtype=torch.int8),
             "k_s": torch.zeros((2, 1, 2, 128)),
             "v_s": torch.zeros((2, 1, 2, 128))}
    x = torch.zeros((1, 16), dtype=torch.bfloat16)
    dims = megastep._check(x, rings, w, model.rope(), 5, 4, 2)
    assert dims == dict(L=2, B=1, S=128, Dm=16, H=4, G=2, D=4, F=64)
    with pytest.raises(ValueError, match="position"):
        megastep._check(x, rings, w, model.rope(), 128, 4, 2)
    with pytest.raises(ValueError, match="shapes"):
        megastep._check(x, rings, w, model.rope(), 5, 4, 4)
    # B = 17 and 48 are taken (the kernel tiles the batch in groups of up
    # to 48 rows); an empty batch is refused before any launch
    for b in (17, 48):
        dims = megastep._check(torch.zeros((b, 16), dtype=torch.bfloat16),
                               {k: v.expand(2, b, *v.shape[2:]) for k, v in
                                rings.items()}, w, model.rope(), 5, 4, 2)
        assert dims["B"] == b
    with pytest.raises(ValueError, match="batch"):
        megastep._check(torch.zeros((0, 16), dtype=torch.bfloat16),
                        {k: v[:, :0] for k, v in rings.items()}, w,
                        model.rope(), 5, 4, 2)
