"""The port's Evaluator writes the same prediction rows as the JAX Evaluator
(same synthetic samples, same weights through the bridge, float32 weights so
that no bf16 rounding differs between the two frameworks): greedy under int4
KV and beam 5 under int8 KV with the serving flags on both sides, and
length-bucketed batching; the port's eval_main serves a config with
`configs/predict.yaml`'s keys (no serving flags: the bf16 slab encoder, beam
5 over float caches) as the JAX eval_main does, guards packed lengths, and
runs on the CUDA device unless it is asked for the CPU."""

import functools
import json
import logging
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from flax.linen import meta

from markushgrapher_tpu.config import MarkushGrapherConfig, SwinConfig, VTLConfig
from markushgrapher_tpu.data.collator import DataCollator
from markushgrapher_tpu.data.dataset import MDUDataset
from markushgrapher_tpu.data.markush_tokenizer import MarkushTokenizer
from markushgrapher_tpu.data.synthetic import generate_dataset
from markushgrapher_tpu import eval_pipeline as jeval
from markushgrapher_tpu.decode import generate as jgen
from markushgrapher_tpu.models.markushgrapher import MarkushGrapherModel as JModel
from markushgrapher_tpu.models.markushgrapher import encoder_valid_max
from markushgrapher_torch import eval_pipeline as teval
from markushgrapher_torch import eval_main as teval_main
from markushgrapher_torch.convert.from_jax import params_from_jax
from markushgrapher_torch.models.markushgrapher import MarkushGrapherModel

T, DEC = 496, 8
REPO_CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def _read(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _predictions_both(tmp_path, int4_cross=True, num_beams=1, n=2,
                      **extra):
    """Run the JAX and the port's Evaluator on the same `n` synthetic
    samples and weights, with the serving flags on (int8 slab, quantised KV
    and weights, cross packing) and `extra` EvalConfig fields; returns
    ([JAX rows, port rows], [JAX scores, port scores])."""
    cfg = MarkushGrapherConfig(
        vtl=VTLConfig(vocab_size=33201, d_model=32, d_kv=4, d_ff=64,
                      num_layers=2, num_decoder_layers=2, num_heads=8,
                      image_size=64, patch_size=16, dropout_rate=0.0),
        swin=SwinConfig(image_size=16, patch_size=2, embed_dim=8,
                        depths=(1,), num_heads=(2,), window_size=4),
        max_seq_length=T, max_seq_length_decoder=DEC)
    mt = MarkushTokenizer()
    ds = MDUDataset(source=generate_dataset(n), markush_tokenizer=mt,
                    image_size=64, ocsr_image_size=16, max_seq_length=T,
                    max_seq_length_decoder=DEC)
    collator = DataCollator(max_length=T, max_length_decoder=DEC)
    sample = dict(ds[0])
    sample.pop("id")
    init_batch = {k: jnp.asarray(v) for k, v in collator([sample]).items()}
    jmodel = JModel(cfg, dtype=jnp.float32, flash_attention=True,
                    bias_int8=True, bias_kernel=True, int4_cross=int4_cross)
    params = meta.unbox(jmodel.init(jax.random.PRNGKey(0), **init_batch))

    host = collator([{k: v for k, v in ds[i].items() if k != "id"}
                     for i in range(2)])
    pack = -(-encoder_valid_max(cfg, jnp.asarray(host["bbox"]),
                                jnp.asarray(host["attention_mask"]))
             // 256) * 256
    assert pack < cfg.encoder_total_len      # packing engages
    common = dict(max_length=DEC, batch_size=2, bf16_params=False,
                  cache_predictions=False, cross_pack_len=pack,
                  num_beams=num_beams, quant_kv=True, quant_weights=True,
                  int4_cross=int4_cross)
    common.update(extra)
    jcfg = jeval.EvalConfig(output_dir=str(tmp_path / "jax"), **common)
    jeval.Evaluator(jmodel, params, mt, jcfg).run(ds, collator)

    tmodel = MarkushGrapherModel(cfg, int4_cross=int4_cross, bias_int8=True,
                                 bias_kernel=True)
    tmodel.load_state_dict(params_from_jax(jax.tree.map(np.asarray,
                                                        params)))
    tcfg = teval.EvalConfig(output_dir=str(tmp_path / "torch"), **common)
    teval.Evaluator(tmodel, mt, tcfg).run(ds, collator)

    rows = [_read(tmp_path / side / f"predictions_{n}.jsonl")
            for side in ("jax", "torch")]
    scores = [json.loads((tmp_path / side / f"scores_{n}.json").read_text())
              for side in ("jax", "torch")]
    for s in scores:
        s.pop("eval_images_per_sec")
    return rows, scores


def test_predictions_match_jax(tmp_path):
    (want, got), scores = _predictions_both(tmp_path)
    assert len(got) == 2 and got == want
    assert all(row["prediction_text"] for row in got)
    assert scores[0] == scores[1]


def test_beam_predictions_match_jax(tmp_path, monkeypatch):
    """Beam 5 under int8 KV, the reference's predict mode with its default
    quantised KV; the JAX side at one self-ring segment (see
    test_torch_beam.test_beam_matches_jax)."""
    monkeypatch.setattr(jgen, "_pick_self_seg", lambda max_len: max_len)
    (want, got), scores = _predictions_both(tmp_path, int4_cross=False,
                                            num_beams=5)
    assert len(got) == 2 and got == want
    assert all(row["prediction_text"] for row in got)
    assert scores[0] == scores[1]


def test_length_buckets_match_jax_and_guard_packs(tmp_path, caplog):
    """length_buckets=2 over four samples (valid encoder counts 159, 180,
    144, 164 with the 64 molscribe tokens, rounded up to 32 without margin
    or cap: two buckets, 160 and 192): both sides group them alike and
    write the same rows; and a batch whose valid count exceeds the model's
    encoder_pack_len is refused."""
    with caplog.at_level(logging.INFO,
                         logger="markushgrapher_torch.eval_pipeline"):
        (want, got), scores = _predictions_both(
            tmp_path, n=4, length_buckets=2, bucket_round_to=32,
            bucket_margin=0, cross_pack_len=0)
    assert "length buckets: [(160, 2), (192, 2)]" in caplog.text
    assert len(got) == 4 and got == want
    assert scores[0] == scores[1]

    cfg = MarkushGrapherConfig(
        vtl=VTLConfig(vocab_size=33201, d_model=32, d_kv=4, d_ff=64,
                      num_layers=1, num_decoder_layers=1, num_heads=8,
                      image_size=64, patch_size=16, dropout_rate=0.0),
        swin=SwinConfig(image_size=16, patch_size=2, embed_dim=8,
                        depths=(1,), num_heads=(2,), window_size=4),
        max_seq_length=T, max_seq_length_decoder=DEC)
    mt = MarkushTokenizer()
    ds = MDUDataset(source=generate_dataset(2), markush_tokenizer=mt,
                    image_size=64, ocsr_image_size=16, max_seq_length=T,
                    max_seq_length_decoder=DEC)
    host = DataCollator(max_length=T, max_length_decoder=DEC)(
        [{k: v for k, v in ds[i].items() if k != "id"} for i in range(2)])

    def evaluator(pack_len):
        model = MarkushGrapherModel(cfg, encoder_pack_len=pack_len)
        return teval.Evaluator(model.init_weights(0), mt, teval.EvalConfig(
            max_length=DEC, batch_size=2, bf16_params=False))

    # VTL valid counts 95 and 116, plus 64 molscribe tokens in the encoder
    # output: a 64 pack drops valid VTL positions and is refused; a 128
    # pack holds them and runs (the reference's guard also counts the
    # molscribe tokens, 180 > 128, and refuses it)
    with pytest.raises(ValueError, match="encoder_pack_len"):
        evaluator(64).generate_batch(host)
    assert evaluator(128).generate_batch(host).shape == (2, DEC)


def _one_sample_setup():
    """(cfg, tokenizer, one-sample dataset, collator) of the cache tests."""
    cfg = MarkushGrapherConfig(
        vtl=VTLConfig(vocab_size=33201, d_model=32, d_kv=4, d_ff=64,
                      num_layers=1, num_decoder_layers=1, num_heads=8,
                      image_size=64, patch_size=16, dropout_rate=0.0),
        swin=SwinConfig(image_size=16, patch_size=2, embed_dim=8,
                        depths=(1,), num_heads=(2,), window_size=4),
        max_seq_length=T, max_seq_length_decoder=DEC)
    mt = MarkushTokenizer()
    ds = MDUDataset(source=generate_dataset(1), markush_tokenizer=mt,
                    image_size=64, ocsr_image_size=16, max_seq_length=T,
                    max_seq_length_decoder=DEC)
    return cfg, mt, ds, DataCollator(max_length=T, max_length_decoder=DEC)


def test_cache_digest_follows_the_beam_rings(tmp_path):
    """The quantised beam's copy-on-write segments and lattice move scores
    at the bf16 level, and block_skip changes what the model reads: two
    runs into one output_dir that differ only in `lattice` keep two cache
    files, and segment sizes and block_skip key apart too. Under greedy
    decode the beam's ring options change nothing and share one key."""
    cfg, mt, ds, collator = _one_sample_setup()

    def evaluator(num_beams=5, block_skip=False, **ring):
        model = MarkushGrapherModel(cfg, int4_cross=True,
                                    block_skip=block_skip)
        return teval.Evaluator(model.init_weights(0), mt, teval.EvalConfig(
            max_length=DEC, batch_size=1, bf16_params=False,
            output_dir=str(tmp_path), quant_kv=True, quant_weights=True,
            int4_cross=True, num_beams=num_beams, **ring))

    for lattice in (False, True):
        evaluator(self_seg=4, lattice=lattice).run(ds, collator)
    assert len(list(tmp_path.glob("predictions_cache_eval_*.pkl"))) == 2
    variants = (dict(self_seg=4), dict(self_seg=4, lattice=True),
                dict(self_seg=2), dict(self_seg=0), dict(block_skip=True))
    assert len({evaluator(**kw)._cache_digest() for kw in variants}) == 5
    assert evaluator(num_beams=1, self_seg=4)._cache_digest() == \
        evaluator(num_beams=1, self_seg=2, lattice=True)._cache_digest()


def test_cache_digest_follows_the_model_route_and_kv_scheme(tmp_path):
    """The prediction cache is keyed on what the model runs: two runs into
    one output_dir that differ only in the encoder route (bias_int8) keep
    two cache files; the in-kernel and packed routes and the int4 / int8 KV
    schemes key apart too; and an EvalConfig whose int4_cross disagrees
    with the model's under quantised KV (the defaults: model int4, config
    int8) is refused."""
    cfg, mt, ds, collator = _one_sample_setup()

    def evaluator(quant_kv=False, int4_cross=False, **flags):
        model = MarkushGrapherModel(cfg, int4_cross=int4_cross, **flags)
        return teval.Evaluator(model.init_weights(0), mt, teval.EvalConfig(
            max_length=DEC, batch_size=1, bf16_params=False,
            output_dir=str(tmp_path), quant_kv=quant_kv,
            quant_weights=quant_kv, int4_cross=int4_cross))

    for bias_int8 in (False, True):
        evaluator(bias_int8=bias_int8).run(ds, collator)
    assert len(list(tmp_path.glob("predictions_cache_eval_*.pkl"))) == 2
    variants = ({}, dict(bias_int8=True), dict(inkernel_bias=True),
                dict(encoder_pack_len=128), dict(quant_kv=True),
                dict(quant_kv=True, int4_cross=True))
    assert len({evaluator(**kw)._cache_digest() for kw in variants}) == 6
    with pytest.raises(ValueError, match="int4_cross"):
        teval.Evaluator(MarkushGrapherModel(cfg), mt,
                        teval.EvalConfig(quant_kv=True))


PREDICT_KEYS = ("datasets_config", "dataset_name", "image_size",
                "max_seq_length", "max_seq_length_decoder",
                "architecture_variant", "vocab_size", "d_model",
                "num_layers", "num_heads", "d_ff", "beam_search",
                "normalize_bbox", "max_eval_samples", "model_name_or_path",
                "output_dir", "per_device_eval_batch_size")


def test_eval_main_serves_predict_yaml_as_jax(tmp_path, monkeypatch):
    """A YAML with exactly configs/predict.yaml's keys (beam 5, no serving
    flags), sized down: both eval_mains write the same
    predictions_<N>.jsonl rows under the same bridged weights. The port's
    route: the bf16 slab encoder (`flash_attention_bias`), beam 5 over float
    caches with float decode weights. Both sides compute in float32 here
    (the two frameworks round bf16 at other places); the Swin-B branch of
    `me-lf-stack-1` is not sized by the YAML, so the variant is `none`."""
    import datasets as hfds
    import yaml

    from markushgrapher_tpu import eval_main as jeval_main
    from markushgrapher_tpu.arguments import (build_model_config,
                                              parse_yaml_config)

    source = generate_dataset(2, image_size=64)
    hfds.DatasetDict(test=hfds.Dataset.from_list(source)).save_to_disk(
        str(tmp_path / "pages"))
    with open(REPO_CONFIGS / "predict.yaml") as f:
        predict = yaml.safe_load(f)
    assert tuple(predict) == PREDICT_KEYS
    with open(REPO_CONFIGS / "datasets" / "datasets_predict.yaml") as f:
        datasets = yaml.safe_load(f)
    datasets["mdu"]["dataset_path"] = str(tmp_path / "pages")
    yaml.safe_dump(datasets, (tmp_path / "datasets.yaml").open("w"))
    predict.update(datasets_config=str(tmp_path / "datasets.yaml"),
                   image_size=64, max_seq_length=T, max_seq_length_decoder=DEC,
                   architecture_variant="none", d_model=32, num_layers=1,
                   num_heads=8, d_ff=64, per_device_eval_batch_size=2,
                   model_name_or_path=str(tmp_path / "weights.npz"))
    outputs = {}
    for side in ("jax", "torch"):
        cfg_path = tmp_path / f"{side}.yaml"
        yaml.safe_dump(dict(predict, output_dir=str(tmp_path / side)),
                       cfg_path.open("w"))
        outputs[side] = tmp_path / side / "predictions" / "predictions_2.jsonl"

    margs, dargs, _ = parse_yaml_config(str(tmp_path / "jax.yaml"))
    assert not (margs.quant_kv or margs.quant_weights or margs.bias_int8)
    cfg = build_model_config(margs, dargs)
    monkeypatch.setattr(jeval_main, "MarkushGrapherModel", functools.partial(
        JModel, dtype=jnp.float32))
    monkeypatch.setattr(jeval_main, "EvalConfig", functools.partial(
        jeval.EvalConfig, bf16_params=False))
    monkeypatch.setattr(teval_main, "EvalConfig", functools.partial(
        teval.EvalConfig, bf16_params=False))
    collator = DataCollator(max_length=T, max_length_decoder=DEC)
    mt = MarkushTokenizer()
    ds = MDUDataset(source=source, markush_tokenizer=mt, image_size=64,
                    max_seq_length=T, max_seq_length_decoder=DEC)
    one = {k: v for k, v in ds[0].items() if k != "id"}
    init_batch = {k: jnp.asarray(v) for k, v in collator([one]).items()}
    params = meta.unbox(JModel(cfg, dtype=jnp.float32).init(
        jax.random.PRNGKey(0), **init_batch))
    flat = {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(params)[0]}
    np.savez(tmp_path / "weights.npz", **flat)

    jeval_main.main(str(tmp_path / "jax.yaml"), params=params)
    teval_main.main(str(tmp_path / "torch.yaml"), device="cpu")
    want, got = _read(outputs["jax"]), _read(outputs["torch"])
    assert len(got) == 2 and got == want
    assert all(row["prediction_text"] for row in got)


def test_eval_main_needs_cuda_unless_asked_for_cpu(tmp_path, monkeypatch):
    """With the serving flags set and no device given, eval_main runs on
    the CUDA device and raises where there is none."""
    cfg = tmp_path / "predict.yaml"
    cfg.write_text("datasets_config: none.yaml\ndataset_name: x\n"
                   "quant_kv: true\nquant_weights: true\nbias_int8: true\n"
                   "bias_kernel: true\nbeam_search: true\n"
                   "int4_cross: false\n")
    monkeypatch.setattr(teval_main.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        teval_main.main(str(cfg))
