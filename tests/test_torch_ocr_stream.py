"""The port's ChemicalOCR continuous batching against the JAX package on the
CPU, at tests/test_torch_ocr.py's tiny configs (the 4-head / 2-kv-head model
and the 15-over-5 grouping at d_model 60) with the same JAX-initialised
float32 weights: the vector-step decode (per-row positions) on float, int8
and int4 rings, with and without block_skip, then `generate_stream` /
`stream_retired` with per-image budgets and refill waves, `predict` under
`stream=True`, short and empty queues and the config's refusal. The JAX
decode kernels run in Pallas interpret mode."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from markushgrapher_tpu.data.vocab import MGTokenizer as JTokenizer
from markushgrapher_tpu.ocr import engine as j_eng
from markushgrapher_tpu.ocr import vlm as j_vlm
from markushgrapher_torch.data.vocab import MGTokenizer as TTokenizer
from markushgrapher_torch.ocr import engine as t_eng
from markushgrapher_torch.ops import mxu_decode as t_mxu
from test_torch_ocr import make_pair

RINGS = {"float": dict(), "int8": dict(quant_kv=True),
         "int4": dict(quant_kv=True, int4=True)}
VALUES = {"float": ("k", "v"), "int8": ("k_q", "v_q"),
          "int4": ("k_q4", "v_q4")}
SCALES = {"float": (), "int8": ("k_s", "v_s"), "int4": ("k_s4", "v_s4")}
BUDGETS = [8, 3, 5, 8, 1, 2, 8, 4, 6, 8]


def to_port(jcaches, ring, rep):
    """JAX prefill rings -> the port's layout (int4 scales one row per kv
    head, [B, G, S], where JAX repeats them to the query heads)."""
    out = []
    for c in jcaches:
        t = {k: torch.tensor(np.asarray(v.astype(jnp.float32)
                                        if v.dtype == jnp.bfloat16 else v))
             for k, v in c.items()}
        if ring == "int4":
            t = {k: v[:, ::rep].to(torch.bfloat16) if k.endswith("_s4")
                 else v for k, v in t.items()}
        out.append(t)
    return out


def jax_prefill(jmodel, params, pix, prompt, ring, max_len):
    return jmodel.apply(params, jnp.asarray(pix), jnp.asarray(prompt),
                        method=j_vlm.ChemicalOCRModel.prefill,
                        max_len=max_len, **RINGS[ring])


def rings_equal(got, want, ring, rep):
    """The port's rings after a step against JAX's: values (int8 / int4
    codes) equal, float rings and scales within 1e-5."""
    for tc, jc in zip(got, want):
        for k in VALUES[ring]:
            w = np.asarray(jc[k])
            if ring == "float":
                np.testing.assert_allclose(tc[k].numpy(), w, atol=1e-5,
                                           rtol=1e-5)
            else:
                np.testing.assert_array_equal(tc[k].numpy(), w)
        for k in SCALES[ring]:
            w = np.asarray(jc[k].astype(jnp.float32))
            w = w[:, ::rep] if ring == "int4" else w
            np.testing.assert_allclose(tc[k].float().numpy(), w, atol=1e-6,
                                       rtol=1e-5)


@pytest.mark.parametrize("ring", sorted(RINGS))
def test_vector_step_all_rows_equal_is_scalar_step(ring):
    """A [B] step with every row at one position gives the scalar step's
    logits and rings, bit for bit."""
    _, jcfg, jmodel, params, tmodel, pix, prompt = make_pair("h15g5")
    _, caches, l0 = tmodel.prefill(torch.tensor(pix), torch.tensor(prompt),
                                   8, **RINGS[ring])
    tok = torch.tensor([[7], [13]])
    twin = [{k: v.clone() for k, v in c.items()} for c in caches]
    want = tmodel.decode_step(tok, caches, 3, l0)
    got = tmodel.decode_step(tok, twin, torch.tensor([3, 3]), l0)
    assert torch.equal(got, want)
    for a, b in zip(twin, caches):
        assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("name", ["h4g2", "h15g5"])
@pytest.mark.parametrize("ring", sorted(RINGS))
def test_vector_step_matches_jax(name, ring):
    """Rows at different positions (steps [9, 2]) on the same rings: the
    port's logits within 1e-4 of JAX's, the written ring codes equal."""
    _, jcfg, jmodel, params, tmodel, pix, prompt = make_pair(name)
    rep = jcfg.text.num_heads // jcfg.text.num_kv_heads
    _, jc, l0 = jax_prefill(jmodel, params, pix, prompt, ring, 16)
    steps = np.asarray([9, 2], np.int32)
    tok = np.asarray([[7], [13]], np.int32)
    want, jc_new = jmodel.apply(params, jnp.asarray(tok), jc,
                                jnp.asarray(steps), l0,
                                method=j_vlm.ChemicalOCRModel.decode_step)
    tc = to_port(jc, ring, rep)
    got = tmodel.decode_step(torch.tensor(tok), tc,
                             torch.tensor(steps, dtype=torch.long), l0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    rings_equal(tc, jc_new, ring, rep)


@pytest.mark.parametrize("slots", [(130, 110), (120, 110)])
def test_vector_step_block_skip_matches_jax(slots, monkeypatch):
    """block_skip with rows at different positions over a 256-key int4
    ring: the decode reads up to the 128-key block of the largest slot
    (both blocks at (130, 110), the first only at (120, 110)), each row's
    mask zeroing its tail; logits within 1e-4 of JAX's under block_skip and
    of the port's whole-ring read."""
    _, jcfg, jmodel, params, tmodel, pix, _ = make_pair("h4g2")
    rng = np.random.RandomState(11)
    prompt = np.tile(rng.randint(3, 100, size=(1, 100)), (2, 1))
    jskip = j_vlm.ChemicalOCRModel(jcfg, dtype=jnp.float32, block_skip=True)
    _, jc, l0 = jax_prefill(jskip, params, pix, prompt, "int4", 140)
    steps = np.asarray(slots, np.int32) - l0
    tok = np.asarray([[7], [13]], np.int32)
    want, _ = jskip.apply(params, jnp.asarray(tok), jc, jnp.asarray(steps),
                          l0, method=j_vlm.ChemicalOCRModel.decode_step)
    live = []
    attend = t_mxu.cross_decode_mxu_int4
    monkeypatch.setattr(t_mxu, "cross_decode_mxu_int4", lambda *a, **kw: (
        live.append(kw.get("live_keys")), attend(*a, **kw))[1])
    logits = {}
    for skip in (True, False):
        tmodel.block_skip = skip
        try:
            logits[skip] = tmodel.decode_step(
                torch.tensor(tok), to_port(jc, "int4", 2),
                torch.tensor(steps, dtype=torch.long), l0,
                slot_bound=max(slots)).numpy()
        finally:
            tmodel.block_skip = False
    tmodel.block_skip = True
    try:
        with pytest.raises(ValueError, match="slot_bound"):
            tmodel.decode_step(torch.tensor(tok), to_port(jc, "int4", 2),
                               torch.tensor(steps, dtype=torch.long), l0)
    finally:
        tmodel.block_skip = False
    assert jc[0]["k_q4"].shape[1] == 256
    assert live[:2] == [256 if max(slots) >= 128 else 128] * 2
    assert live[2:] == [None] * 2
    np.testing.assert_allclose(logits[True], np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(logits[True], logits[False], atol=1e-4,
                               rtol=1e-4)


def engines(name, ring, **kw):
    """(JAX engine, port engine) over make_pair's weights at f32: float
    weights on the float ring, int8 decode weights on the quantised ones."""
    _, jcfg, jmodel, params, tmodel, _, _ = make_pair(name)
    quant = ring != "float"
    flags = dict(quant_kv=quant, int4_kv=ring == "int4",
                 quant_weights=quant, **kw)
    return (j_eng.ChemicalOCR(jmodel, params, JTokenizer(),
                              j_eng.OCREngineConfig(**flags)),
            t_eng.ChemicalOCR(tmodel, TTokenizer(),
                              t_eng.OCREngineConfig(**flags), device="cpu"))


@pytest.mark.parametrize("name,ring", [
    ("h4g2", "float"), ("h4g2", "int4"), ("h15g5", "int8"),
    ("h15g5", "int4")])
def test_generate_stream_matches_jax(name, ring):
    """10 images with per-image budgets through 4 rows, refill waves of 2,
    2 steps a chunk: the same ids as JAX's stream for every image, in the
    same retirement order; a budget's tail is pad."""
    jeng, teng = engines(name, ring, max_new_tokens=8, batch_size=4,
                         eos_id=-1)
    images = np.random.RandomState(3).rand(10, 32, 32, 3).astype(np.float32)
    kw = dict(budgets=BUDGETS, batch=4, refill_batch=2, inner=2)
    want = list(jeng.stream_retired(images, **kw))
    got = list(teng.stream_retired(images, **kw))
    assert [i for i, _ in got] == [i for i, _ in want]
    for (i, g), (_, w) in zip(got, want):
        assert g.shape == (8,) and g.dtype == torch.long
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=f"image {i}")
        assert (g[BUDGETS[i]:] == 0).all()
    assert [g.tolist() for g in teng.generate_stream(images, **kw)] == [
        np.asarray(w).tolist() for w in jeng.generate_stream(images, **kw)]


def test_stream_ids_do_not_depend_on_the_schedule():
    """One image's ids are the same whatever the batch, refill wave, chunk
    length or row it lands in, and equal the batched engine's up to its
    budget."""
    _, teng = engines("h15g5", "int8", max_new_tokens=8, batch_size=4)
    images = np.random.RandomState(5).randint(
        0, 256, (6, 32, 32, 3)).astype(np.uint8)
    budgets = [8, 2, 7, 1, 8, 5]
    runs = [teng.generate_stream(images, budgets, batch, refill, inner)
            for batch, refill, inner in ((4, 2, 2), (3, 1, 5), (6, 8, 64),
                                         (1, 1, 3))]
    batched = teng.generate_batch_async(images)
    for i, budget in enumerate(budgets):
        want = batched[i].clone()
        want[budget:] = 0
        for run in runs:
            assert torch.equal(run[i], want), i


def test_predict_stream_matches_jax():
    """predict under stream=True (uint8 pages resized to the vision size)
    gives JAX's cells, and the batched predict's."""
    pytest.importorskip("PIL")
    kw = dict(max_new_tokens=6, batch_size=2, stream=True, refill_batch=2,
              stream_inner=2)
    jeng, teng = engines("h4g2", "int4", **kw)
    samples = [{"page_image": np.full((48, 48, 3), i * 40, np.uint8)}
               for i in range(5)]
    want = jeng.predict(samples, image_size=32)
    assert teng.predict(samples, image_size=32) == want
    teng.cfg.stream = False
    assert teng.predict(samples, image_size=32) == want


def test_stream_short_queue():
    """2 images over 4 rows: the rows with no image are born finished, and
    both images come back with JAX's ids."""
    jeng, teng = engines("h4g2", "int8", max_new_tokens=6, batch_size=4,
                         eos_id=-1)
    images = np.random.RandomState(4).rand(2, 32, 32, 3).astype(np.float32)
    want = jeng.generate_stream(images, inner=3)
    got = teng.generate_stream(images, inner=3)
    assert len(got) == 2
    np.testing.assert_array_equal(torch.stack(got).numpy(), np.stack(want))


def test_stream_empty_queue_and_megastep_refused():
    """An empty image list gives [] and yields nothing (the reference raises
    IndexError); budgets that do not match the images are refused;
    stream=True with megastep=True is refused, as in JAX."""
    _, teng = engines("h4g2", "float", max_new_tokens=4)
    assert teng.generate_stream([]) == []
    assert list(teng.stream_retired(np.zeros((0, 32, 32, 3)))) == []
    with pytest.raises(ValueError, match="2 budgets for 3 images"):
        teng.generate_stream(np.zeros((3, 32, 32, 3)), budgets=[4, 4])
    kw = dict(stream=True, megastep=True, quant_kv=True)
    with pytest.raises(ValueError, match="megastep"):
        j_eng.OCREngineConfig(**kw)
    with pytest.raises(ValueError, match="per-row positions"):
        t_eng.OCREngineConfig(**kw)
