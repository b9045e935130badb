#!/usr/bin/env python
"""Run ChemicalOCR over every split of an on-disk HF dataset, writing the
`cells` column (stage 1 of the pipeline): the port of the JAX package's
`scripts/apply_ocr.py`.

The model is `ChemicalOCRModel(cfg, block_skip=True)` in bf16 on the CUDA
device (or `device="cpu"`), served by `ChemicalOCR.predict_to_disk` (under
`stream=True` through continuous batching). Weights: an `.npz` of the flax
tree with '/'-joined keys (what `convert.from_jax` reads, as
`eval_main.load_npz_tree` does for MarkushGrapher); the JAX script's msgpack
files are refused, since checkpoint conversion is not ported yet. With no
weights, a seeded random init (smoke-test mode).

Usage: python -m markushgrapher_torch.scripts.apply_ocr <dataset_dir>
    <output_dir> [ocr_params.npz]
"""

from __future__ import annotations

import sys
from typing import Dict, Optional

import torch

from markushgrapher_torch.convert.from_jax import params_from_jax
from markushgrapher_torch.data.vocab import MGTokenizer
from markushgrapher_torch.eval_main import load_npz_tree
from markushgrapher_torch.ocr.engine import ChemicalOCR, build_ocr_configs
from markushgrapher_torch.ocr.vlm import ChemicalOCRModel

# the serving dtype of the model's weights and compute
DTYPE = torch.bfloat16


def main(dataset_dir: str, output_dir: str,
         params_path: Optional[str] = None,
         overrides: Optional[Dict] = None,
         device: Optional[str] = None) -> None:
    device = device or "cuda"
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "apply_ocr runs on a CUDA device and found none; pass "
            "device='cpu' to run the plain versions on the CPU")
    if params_path and not params_path.endswith(".npz"):
        raise ValueError(
            f"apply_ocr: {params_path}: msgpack checkpoints are not read by "
            "the port (checkpoint conversion is not ported yet); give an "
            ".npz of the flax tree with '/'-joined keys")
    cfg, engine_cfg = build_ocr_configs(overrides)
    # block_skip: valid-prefix reads of the quantised rings (exact)
    with torch.device(device):
        model = ChemicalOCRModel(cfg, block_skip=True)
    if params_path:
        model.load_state_dict(params_from_jax(load_npz_tree(params_path)))
    else:
        print("WARNING: no OCR weights given; running random init "
              "(smoke-test mode)")
        model.init_weights(0)
    engine = ChemicalOCR(model.to(DTYPE), MGTokenizer(), engine_cfg,
                         device=device)
    engine.predict_to_disk(dataset_dir, output_dir)


if __name__ == "__main__":
    main(*sys.argv[1:])
