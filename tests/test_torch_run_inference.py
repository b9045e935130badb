"""The port's page -> OCR -> MarkushGrapher scripts (`markushgrapher_torch.
scripts.run_inference` and `apply_ocr`) on the CPU at tiny configs, over
seeded PNGs: the artifacts of a --skip_ocr run and of OCR-enabled runs
(batched and under `ocr.stream=true`) in the reference's formats, stage 1's
`cells` column and stage 2's prediction rows against the JAX scripts'
under the same weights (float32 on both sides), and the refusals (--staged,
msgpack OCR weights, no card without --device cpu)."""

import functools
import json
import os
import runpy
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization
from flax.linen import meta

from markushgrapher_tpu import eval_main as jeval_main
from markushgrapher_tpu import eval_pipeline as jeval
from markushgrapher_tpu.models.markushgrapher import MarkushGrapherModel
from markushgrapher_tpu.ocr import engine as j_eng
from markushgrapher_tpu.ocr import vlm as j_vlm
from markushgrapher_torch import eval_main as teval_main
from markushgrapher_torch import eval_pipeline as teval
from markushgrapher_torch.ocr import engine as t_eng
from markushgrapher_torch.scripts import apply_ocr as t_apply
from markushgrapher_torch.scripts import image_dir_to_hf_dataset as t_pages
from markushgrapher_torch.scripts import run_inference as t_run

datasets = pytest.importorskip("datasets")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MG = ["architecture_variant=none", "d_model=64", "num_layers=1",
      "num_heads=2", "d_ff=128", "image_size=64", "max_seq_length=64",
      "max_seq_length_decoder=12", "per_device_eval_batch_size=2"]
OCR = {"vision.image_size": 32, "vision.d_model": 32, "vision.num_layers": 1,
       "vision.num_heads": 2, "vision.d_ff": 64, "text.vocab_size": 33104,
       "text.d_model": 32, "text.num_layers": 1, "text.num_heads": 4,
       "text.num_kv_heads": 2, "text.d_ff": 64, "text.max_position": 256,
       "pixel_shuffle_factor": 2, "max_new_tokens": 8, "batch_size": 2}


def sets(mg=True, ocr=None):
    """--set arguments: the tiny MarkushGrapher and OCR overrides."""
    out = []
    for kv in (MG if mg else []) + [f"ocr.{k}={v}" for k, v in
                                    (ocr or {}).items()]:
        out += ["--set", kv]
    return out


@pytest.fixture(autouse=True)
def small_canvas(monkeypatch):
    """Stage 0 fits each image into a 128-pixel canvas (the scripts' default
    is 1024, whose pixel lists the datasets library takes ~12 s a page to
    read back on this CPU); both stages resize it to their own sizes."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import image_dir_to_hf_dataset as j_pages
    finally:
        sys.path.pop(0)
    for mod in (j_pages, t_pages):
        monkeypatch.setattr(mod, "generate_hf_dataset", functools.partial(
            mod.generate_hf_dataset, canvas_size=128))


@pytest.fixture()
def image_dir(tmp_path):
    from PIL import Image

    d = tmp_path / "imgs"
    d.mkdir()
    rng = np.random.RandomState(0)
    for i in range(2):
        Image.fromarray((rng.rand(64, 64, 3) * 255).astype(np.uint8)).save(
            d / f"mol_{i}.png")
    return str(d)


def artifacts(run_dir, n=2):
    """The reference's per-run configs and eval artifacts; the prediction
    rows."""
    import yaml

    with open(os.path.join(run_dir, "datasets_predict.yaml")) as f:
        assert yaml.safe_load(f)["mdu"]["training_dataset_name"] \
            == "mdu_3008_aug"
    with open(os.path.join(run_dir, "predict.yaml")) as f:
        assert yaml.safe_load(f)["dataset_name"] == "mdu"
    pred = os.path.join(run_dir, "predictions")
    with open(os.path.join(pred, f"scores_{n}.json")) as f:
        assert isinstance(json.load(f), dict)
    with open(os.path.join(pred, f"predictions_{n}.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert len(rows) == n
    return rows


def cells(ds_dir):
    ds = datasets.load_from_disk(ds_dir)
    return [list(split["cells"]) for split in ds.values()]


def _with_raw(parse, text):
    return parse(text) + [{"bbox": [0.0, 0.0, 1.0, 1.0], "text": text}]


def keep_raw(monkeypatch, *engines):
    """Each engine module's parse of a generation into cells also keeps the
    raw generation, as one more cell over the whole page. Random weights
    practically never emit the `<loc_N>` lines that `cells_from_prediction`
    parses, so without it every page's cells would be [] whatever stage 1
    decoded."""
    for mod in engines:
        monkeypatch.setattr(mod, "cells_from_prediction", functools.partial(
            _with_raw, mod.cells_from_prediction))


def raw_texts(columns):
    """The raw generation of every page (`keep_raw`), each non-empty."""
    texts = [page[-1]["text"] for split in columns for page in split]
    assert texts and all(texts)
    return texts


def test_run_inference_skip_ocr(image_dir, tmp_path):
    """--skip_ocr: stage 0 from the images, the per-run YAMLs, eval_main's
    predictions and scores."""
    out = str(tmp_path / "run")
    t_run.main(["--images", image_dir, "--output", out, "--skip_ocr",
                "--max_eval_samples", "2", "--device", "cpu"] + sets())
    artifacts(out)


def test_run_inference_with_ocr_batched_and_stream(image_dir, tmp_path,
                                                   monkeypatch):
    """The OCR-enabled flow: stage 1 writes the `cells` column that stage 2
    reads; under `--set ocr.stream=true` (continuous batching) the same
    generations, cells and prediction rows."""
    keep_raw(monkeypatch, t_eng)
    rows, got = {}, {}
    for stream in (False, True):
        out = str(tmp_path / f"run_{stream}")
        extra = dict(stream=True, refill_batch=1, stream_inner=3) \
            if stream else {}
        t_run.main(["--images", image_dir, "--output", out,
                    "--max_eval_samples", "2", "--device", "cpu"]
                   + sets(ocr={**OCR, **extra}))
        got[stream] = cells(os.path.join(out, "dataset_ocr"))
        assert len(got[stream][0]) == 2
        rows[stream] = artifacts(out)
    assert raw_texts(got[True]) == raw_texts(got[False])
    assert got[True] == got[False] and rows[True] == rows[False]


def test_stage1_cells_match_jax(image_dir, tmp_path, monkeypatch):
    """The port's apply_ocr (.npz weights) decodes the generations and
    writes the cells column that the JAX script does (msgpack), under the
    same OCR weights at float32; a msgpack file is refused by name."""
    raw = str(tmp_path / "raw")
    t_pages.generate_hf_dataset(image_dir, raw)
    cfg, _ = j_eng.build_ocr_configs(OCR)
    model = j_vlm.ChemicalOCRModel(cfg, dtype=jnp.float32)
    boxed = model.init(jax.random.PRNGKey(1),
                       jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 8), jnp.int32))
    (tmp_path / "ocr.msgpack").write_bytes(serialization.to_bytes(boxed))
    flat = {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(
                meta.unbox(boxed))[0]}
    np.savez(tmp_path / "ocr.npz", **flat)

    keep_raw(monkeypatch, j_eng, t_eng)
    real = j_vlm.ChemicalOCRModel
    monkeypatch.setattr(j_vlm, "ChemicalOCRModel", lambda cfg, dtype=None,
                        **kw: real(cfg, dtype=jnp.float32, **kw))
    monkeypatch.setattr(t_apply, "DTYPE", torch.float32)
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        from apply_ocr import main as j_apply
    finally:
        sys.path.pop(0)
    j_apply(raw, str(tmp_path / "jax"), str(tmp_path / "ocr.msgpack"),
            overrides=OCR)
    t_apply.main(raw, str(tmp_path / "torch"), str(tmp_path / "ocr.npz"),
                 overrides=OCR, device="cpu")
    want = cells(str(tmp_path / "jax"))
    assert raw_texts(cells(str(tmp_path / "torch"))) == raw_texts(want)
    assert cells(str(tmp_path / "torch")) == want
    with pytest.raises(ValueError, match="msgpack"):
        t_apply.main(raw, str(tmp_path / "no"), str(tmp_path / "ocr.msgpack"),
                     overrides=OCR, device="cpu")


def test_stage2_rows_match_jax(image_dir, tmp_path, monkeypatch):
    """--skip_ocr through both run_inference scripts under the same
    MarkushGrapher weights (the JAX script's random init, handed to the
    port as an .npz): the same prediction rows, both in float32."""
    npz = str(tmp_path / "mg.npz")
    load = jeval_main.load_eval_params

    def saved(*args, **kw):
        params = load(*args, **kw)
        np.savez(npz, **{"/".join(str(getattr(p, "key", p)) for p in path):
                         np.asarray(x) for path, x in
                         jax.tree_util.tree_flatten_with_path(
                             meta.unbox(params))[0]})
        return params

    monkeypatch.setattr(jeval_main, "load_eval_params", saved)
    monkeypatch.setattr(jeval_main, "MarkushGrapherModel",
                        lambda cfg, dtype=None, **kw: MarkushGrapherModel(
                            cfg, dtype=jnp.float32, **kw))
    monkeypatch.setattr(jeval_main, "EvalConfig", functools.partial(
        jeval.EvalConfig, bf16_params=False))
    monkeypatch.setattr(teval_main, "EvalConfig", functools.partial(
        teval.EvalConfig, bf16_params=False))
    common = ["--images", image_dir, "--skip_ocr", "--max_eval_samples", "2"]
    monkeypatch.setattr(sys, "argv", ["run_inference.py", "--output",
                                      str(tmp_path / "jax")] + common
                        + sets())
    runpy.run_path(os.path.join(REPO, "scripts", "run_inference.py"),
                   run_name="__main__")
    t_run.main(["--output", str(tmp_path / "torch"), "--checkpoint", npz,
                "--device", "cpu"] + common + sets())
    want = artifacts(str(tmp_path / "jax"))
    assert artifacts(str(tmp_path / "torch")) == want
    assert all(row["prediction_text"] for row in want)


def test_run_inference_refusals(image_dir, tmp_path, monkeypatch, capsys):
    """--staged is refused by name before any work; with no card
    run_inference and apply_ocr raise unless asked for the CPU."""
    with pytest.raises(SystemExit):
        t_run.main(["--images", image_dir, "--output", str(tmp_path / "s"),
                    "--staged", "4", "--device", "cpu"])
    assert "--staged" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "s")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        t_run.main(["--images", image_dir, "--output", str(tmp_path / "c")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_apply.main(str(tmp_path), str(tmp_path / "o"), overrides=OCR)
