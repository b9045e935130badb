"""The port's Evaluator writes the same prediction rows as the JAX Evaluator
(same synthetic samples, same weights through the bridge, serving flags on
both sides, float32 weights so that no bf16 rounding differs between the two
frameworks); the port's eval_main refuses a config without the serving
flags."""

import json

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
from markushgrapher_tpu.models.markushgrapher import MarkushGrapherModel as JModel
from markushgrapher_tpu.models.markushgrapher import encoder_valid_max
from markushgrapher_torch import eval_pipeline as teval
from markushgrapher_torch import eval_main as teval_main
from markushgrapher_torch.convert.from_jax import params_from_jax
from markushgrapher_torch.models.markushgrapher import MarkushGrapherModel

T, DEC = 496, 8


def _read(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_predictions_match_jax(tmp_path):
    cfg = MarkushGrapherConfig(
        vtl=VTLConfig(vocab_size=33201, d_model=32, d_kv=4, d_ff=64,
                      num_layers=2, num_decoder_layers=2, num_heads=8,
                      image_size=64, patch_size=16, dropout_rate=0.0),
        swin=SwinConfig(image_size=16, patch_size=2, embed_dim=8,
                        depths=(1,), num_heads=(2,), window_size=4),
        max_seq_length=T, max_seq_length_decoder=DEC)
    mt = MarkushTokenizer()
    ds = MDUDataset(source=generate_dataset(2), markush_tokenizer=mt,
                    image_size=64, ocsr_image_size=16, max_seq_length=T,
                    max_seq_length_decoder=DEC)
    collator = DataCollator(max_length=T, max_length_decoder=DEC)
    sample = dict(ds[0])
    sample.pop("id")
    init_batch = {k: jnp.asarray(v) for k, v in collator([sample]).items()}
    jmodel = JModel(cfg, dtype=jnp.float32, flash_attention=True,
                    bias_int8=True, bias_kernel=True, int4_cross=True)
    params = meta.unbox(jmodel.init(jax.random.PRNGKey(0), **init_batch))

    host = collator([{k: v for k, v in ds[i].items() if k != "id"}
                     for i in range(2)])
    pack = -(-encoder_valid_max(cfg, jnp.asarray(host["bbox"]),
                                jnp.asarray(host["attention_mask"]))
             // 256) * 256
    assert pack < cfg.encoder_total_len      # packing engages
    common = dict(max_length=DEC, batch_size=2, bf16_params=False,
                  cache_predictions=False, cross_pack_len=pack)
    # the port serves int4 KV + int8 weights only: no flags on its side
    jcfg = jeval.EvalConfig(output_dir=str(tmp_path / "jax"), quant_kv=True,
                            quant_weights=True, int4_cross=True, **common)
    jeval.Evaluator(jmodel, params, mt, jcfg).run(ds, collator)

    tmodel = MarkushGrapherModel(cfg)
    tmodel.load_state_dict(params_from_jax(jax.tree.map(np.asarray,
                                                        params)))
    tcfg = teval.EvalConfig(output_dir=str(tmp_path / "torch"), **common)
    teval.Evaluator(tmodel, mt, tcfg).run(ds, collator)

    want = _read(tmp_path / "jax" / "predictions_2.jsonl")
    got = _read(tmp_path / "torch" / "predictions_2.jsonl")
    assert len(got) == 2 and got == want
    assert all(row["prediction_text"] for row in got)
    scores = [json.loads((tmp_path / side / "scores_2.json").read_text())
              for side in ("jax", "torch")]
    for s in scores:
        s.pop("eval_images_per_sec")
    assert scores[0] == scores[1]


def test_eval_main_requires_serving_flags(tmp_path):
    cfg = tmp_path / "predict.yaml"
    cfg.write_text("datasets_config: none.yaml\ndataset_name: x\n"
                   "quant_kv: true\n")
    with pytest.raises(ValueError, match="quant_weights"):
        teval_main.main(str(cfg))
