"""Prediction / evaluation entry point of the port:
`python -m markushgrapher_torch.eval_main <config.yaml>`.

Reads the same YAML keys as `markushgrapher_tpu.eval_main`, builds the model
and dataset, runs batched greedy generation on the port and writes
`predictions_<N>.jsonl` / `scores_<N>.json` under `<output_dir>/predictions`.

Only the serving path is ported, so the YAML must set `quant_kv`,
`quant_weights`, `int4_cross`, `bias_int8` and `bias_kernel` to true (the
reference's defaults leave them off and reach the float-bias flash encoder,
which is not ported: ROADMAP queue 2). `beam_search: true` is refused
(ROADMAP queue 1 item 6). Weights: `model_name_or_path` may name an `.npz`
of the flattened flax parameter tree ("/"-joined paths, through
`convert.from_jax`); otherwise the model runs from a seeded random init.
Orbax checkpoint restore is not ported yet.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Dict, Optional

import numpy as np
import torch

from markushgrapher_tpu.arguments import build_model_config, parse_yaml_config
from markushgrapher_tpu.data.collator import DataCollator
from markushgrapher_tpu.data.dataset import DatasetRegistry
from markushgrapher_tpu.data.markush_tokenizer import MarkushTokenizer
from markushgrapher_torch.convert.from_jax import params_from_jax
from markushgrapher_torch.eval_pipeline import EvalConfig, Evaluator
from markushgrapher_torch.models.markushgrapher import MarkushGrapherModel

logger = logging.getLogger(__name__)

# hardcoded eval flags and the GT-parsing encoding of the reference eval
REMOVE_STEREO = True
FIX_CXSMILES = True
INPUT_ENCODING_TRAINING_DATASET = "mdu_3005"
SERVING_FLAGS = ("quant_kv", "quant_weights", "int4_cross", "bias_int8",
                 "bias_kernel")


def require_serving_flags(margs) -> None:
    off = [f for f in SERVING_FLAGS if not getattr(margs, f)]
    if off:
        raise ValueError(
            f"markushgrapher_torch serves only the int8-bias flash encoder "
            f"and int4-KV / int8-weight decode; set {off} to true in the "
            "config (the other paths are ROADMAP queue 2)")


def load_npz_tree(path: str) -> Dict:
    """.npz with '/'-joined flax paths -> nested dict of arrays."""
    tree: Dict = {}
    with np.load(path) as data:
        for key in data.files:
            node = tree
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
    return tree


def build_model(margs, dargs, device) -> MarkushGrapherModel:
    cfg = build_model_config(margs, dargs)
    with torch.device(device):
        model = MarkushGrapherModel(cfg)
    path = margs.model_name_or_path
    if path and path.endswith(".npz") and os.path.isfile(path):
        logger.info("loading weights %s", path)
        model.load_state_dict(params_from_jax(load_npz_tree(path)))
    else:
        logger.warning("no .npz weights given; evaluating random init")
        model.init_weights(seed=0)
    return model


def main(config_path: Optional[str] = None,
         device: Optional[str] = None) -> Dict[str, float]:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s")
    config_path = config_path or sys.argv[1]
    margs, dargs, targs = parse_yaml_config(config_path)
    require_serving_flags(margs)
    if margs.beam_search:
        raise NotImplementedError(
            "beam search is not ported yet: ROADMAP queue 1 item 6")
    device = device or ("cuda" if torch.cuda.is_available() else "cpu")
    model = build_model(margs, dargs, device)

    registry = DatasetRegistry.from_yaml(dargs.datasets_config)
    test_ds = registry.build(
        dargs.dataset_name, split="test", train=False,
        image_size=dargs.image_size, max_seq_length=dargs.max_seq_length,
        max_seq_length_decoder=dargs.max_seq_length_decoder)
    ds_cfg = registry.configs[dargs.dataset_name]
    input_mt = MarkushTokenizer(
        tokenizer=test_ds.markush_tokenizer.tokenizer,
        encode_position=ds_cfg.get("encode_position", False),
        encode_index=ds_cfg.get("encode_index", False),
        condense_labels=ds_cfg.get("condense_labels", True),
        training_dataset_name=INPUT_ENCODING_TRAINING_DATASET,
        vocab_dir=ds_cfg.get("vocab_dir"))

    eval_cfg = EvalConfig(
        max_length=dargs.max_seq_length_decoder,
        batch_size=targs.per_device_eval_batch_size,
        max_eval_samples=dargs.max_eval_samples,
        remove_stereo=REMOVE_STEREO, fix_cxsmiles=FIX_CXSMILES,
        save_visualizations=dargs.save_visualizations,
        cross_pack_len=margs.cross_pack_len,
        output_dir=os.path.join(targs.output_dir, "predictions"))
    evaluator = Evaluator(model, test_ds.markush_tokenizer, eval_cfg,
                          input_tokenizer=input_mt)
    collator = DataCollator(max_length=dargs.max_seq_length,
                            max_length_decoder=dargs.max_seq_length_decoder)
    result = evaluator.run(test_ds, collator,
                           benchmark_name=dargs.dataset_name or "eval")
    logger.info("scores: %s", result.scores)
    return result.scores


if __name__ == "__main__":
    main()
