"""Prediction / evaluation entry point of the port:
`python -m markushgrapher_torch.eval_main <config.yaml>`.

Reads the same YAML keys as `markushgrapher_tpu.eval_main`, builds the model
and dataset, runs batched generation on the port (beam 5 when `beam_search:
true`, as the reference's predict config) and writes `predictions_<N>.jsonl`
/ `scores_<N>.json` under `<output_dir>/predictions`.

The model is built as the reference's: `bias_int8`, `bias_kernel`,
`encoder_pack_len` and `int4_cross` from the YAML pick the encoder route and
the quantised KV scheme, and `quant_kv` / `quant_weights` / `int4_cross` /
`cross_pack_len` reach the `EvalConfig`. With none of them set (the
reference's `configs/predict.yaml`) the encoder runs the bf16 bias slab and
decode uses bf16 KV caches and bf16 weights. Runs on the CUDA device unless
the caller passes `device="cpu"`. Weights, as the reference restores
them: `model_name_or_path` names a checkpoint directory (`checkpoint-N`
of `train_main`, through `Checkpointer.restore_params`) or an `.npz` of the
flattened flax parameter tree ("/"-joined paths, through
`convert.from_jax`); when it is empty, the last checkpoint under
`output_dir`; when none of these exists, a seeded random init, with a
warning.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Dict, Optional

import numpy as np
import torch

from markushgrapher_torch.arguments import build_model_config, parse_yaml_config
from markushgrapher_torch.data.collator import DataCollator
from markushgrapher_torch.data.dataset import DatasetRegistry
from markushgrapher_torch.data.markush_tokenizer import MarkushTokenizer
from markushgrapher_torch.convert.from_jax import params_from_jax
from markushgrapher_torch.eval_pipeline import EvalConfig, Evaluator
from markushgrapher_torch.models.markushgrapher import MarkushGrapherModel
from markushgrapher_torch.train.checkpoint import Checkpointer, last_checkpoint

logger = logging.getLogger(__name__)

# hardcoded eval flags and the GT-parsing encoding of the reference eval
REMOVE_STEREO = True
FIX_CXSMILES = True
INPUT_ENCODING_TRAINING_DATASET = "mdu_3005"
BEAMS = 5                       # the reference's predict mode (beam_search)


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


def build_model(margs, dargs, targs, device) -> MarkushGrapherModel:
    """The model of the YAML's flags with its weights: the checkpoint
    `model_name_or_path` names (a directory) or else the last one under
    `targs.output_dir`, an `.npz` flax tree, or a seeded random init."""
    cfg = build_model_config(margs, dargs)
    with torch.device(device):
        model = MarkushGrapherModel(cfg, int4_cross=margs.int4_cross,
                                    bias_int8=margs.bias_int8,
                                    bias_kernel=margs.bias_kernel,
                                    encoder_pack_len=margs.encoder_pack_len)
    path = margs.model_name_or_path or last_checkpoint(targs.output_dir)
    if path and os.path.isdir(path):
        logger.info("loading checkpoint %s", path)
        ckptr = Checkpointer(os.path.dirname(path) or ".")
        model.load_state_dict(ckptr.restore_params(path))
    elif path and path.endswith(".npz") and os.path.isfile(path):
        logger.info("loading weights %s", path)
        model.load_state_dict(params_from_jax(load_npz_tree(path)))
    else:
        logger.warning("no checkpoint found; evaluating random init")
        model.init_weights(seed=0)
    return model


def main(config_path: Optional[str] = None,
         device: Optional[str] = None) -> Dict[str, float]:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s")
    config_path = config_path or sys.argv[1]
    margs, dargs, targs = parse_yaml_config(config_path)
    device = device or "cuda"
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "markushgrapher_torch.eval_main runs on a CUDA device and found "
            "none; pass device='cpu' to run the plain versions on the CPU")
    model = build_model(margs, dargs, targs, device)

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
        num_beams=BEAMS if margs.beam_search else 1,
        batch_size=targs.per_device_eval_batch_size,
        max_eval_samples=dargs.max_eval_samples,
        remove_stereo=REMOVE_STEREO, fix_cxsmiles=FIX_CXSMILES,
        save_visualizations=dargs.save_visualizations,
        quant_kv=margs.quant_kv, quant_weights=margs.quant_weights,
        int4_cross=margs.int4_cross, cross_pack_len=margs.cross_pack_len,
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
