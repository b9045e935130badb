#!/usr/bin/env python
"""End-to-end inference on the port: images or an HF dataset -> ChemicalOCR
-> MarkushGrapher -> predictions + scores, in one process (the port of the
JAX package's `scripts/run_inference.py`).

Stage 0 builds the canonical dataset (`image_dir_to_hf_dataset` /
`prepare_hf_dataset`), stage 1 writes its `cells` column (`apply_ocr`,
skipped with --skip_ocr), stage 2 writes the per-run `datasets_predict.yaml`
and `predict.yaml` and runs `eval_main` on them, which writes
`predictions/predictions_<N>.jsonl` and `scores_<N>.json`. `--set
ocr.<key>=<value>` goes to the OCR stage (`ocr.stream=true`: continuous
batching), any other `--set key=value` to the predict config.

Usage:
  python -m markushgrapher_torch.scripts.run_inference --images <dir>
      --output <run_dir> [options]
  python -m markushgrapher_torch.scripts.run_inference --hf_dataset <path>
      --output <run_dir> [options]

Options: --skip_ocr (use existing cells), --beam (beam-5 decode),
--max_eval_samples N, --checkpoint <dir or .npz>, --ocr_params <.npz>,
--device (default cuda; cpu runs the plain versions). --staged
(stage-parallel multi-device serving) is not ported yet and is refused.
"""

from __future__ import annotations

import argparse
import datetime
import os

import torch


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--images", help="directory of PNG/JPG images")
    src.add_argument("--hf_dataset", help="on-disk HF dataset path")
    ap.add_argument("--output", default=None)
    ap.add_argument("--skip_ocr", action="store_true")
    ap.add_argument("--beam", action="store_true")
    ap.add_argument("--max_eval_samples", type=int, default=None)
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--ocr_params", default=None)
    ap.add_argument("--staged", type=int, default=0, metavar="N_OCR",
                    help="stage-parallel serving over several devices: not "
                         "ported yet, refused")
    ap.add_argument("--device", default="cuda",
                    help="torch device of both stages (default cuda)")
    ap.add_argument("--set", dest="overrides", action="append", default=[],
                    help="extra predict-config overrides, key=value "
                         "(repeatable); values parsed as YAML")
    args = ap.parse_args(argv)
    if args.staged:
        ap.error("--staged (stage-parallel multi-device serving) is not "
                 "ported yet; run without it")
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise RuntimeError("run_inference runs on a CUDA device and found "
                           "none; pass --device cpu to run the plain "
                           "versions on the CPU")

    import yaml

    from markushgrapher_torch import eval_main
    from markushgrapher_torch.scripts import apply_ocr

    run_dir = args.output or os.path.join(
        "runs", datetime.datetime.now().strftime("run_%Y%m%d_%H%M%S"))
    os.makedirs(run_dir, exist_ok=True)

    # -- stage 0: dataset construction / normalisation ----------------------
    ds_dir = os.path.join(run_dir, "dataset_raw")
    if args.images:
        from markushgrapher_torch.scripts.image_dir_to_hf_dataset import \
            generate_hf_dataset

        generate_hf_dataset(args.images, ds_dir)
    else:
        from markushgrapher_torch.scripts.prepare_hf_dataset import \
            main as prepare

        prepare(args.hf_dataset, ds_dir)

    # `--set ocr.<key>=<value>` overrides go to the OCR stage, the rest to
    # the predict config
    ocr_overrides = {}
    predict_overrides = []
    for kv in args.overrides:
        key, _, value = kv.partition("=")
        if key.startswith("ocr."):
            ocr_overrides[key[len("ocr."):]] = yaml.safe_load(value)
        else:
            predict_overrides.append((key, yaml.safe_load(value)))

    # -- stage 1: ChemicalOCR -----------------------------------------------
    if args.skip_ocr:
        ocr_dir = ds_dir
    else:
        ocr_dir = os.path.join(run_dir, "dataset_ocr")
        apply_ocr.main(ds_dir, ocr_dir, args.ocr_params,
                       overrides=ocr_overrides, device=args.device)

    # -- stage 2: MarkushGrapher eval over per-run configs -------------------
    datasets_yaml = os.path.join(run_dir, "datasets_predict.yaml")
    with open(datasets_yaml, "w") as f:
        yaml.safe_dump({"mdu": {
            "dataset_path": ocr_dir,
            "normalize_bbox": True,
            "condense_labels": True,
            # mdu for HF-dataset runs, mdu_3008_aug for raw image dirs;
            # picks the vocab inventory
            "training_dataset_name": ("mdu" if args.hf_dataset
                                      else "mdu_3008_aug"),
        }}, f)
    predict_cfg = {
        "datasets_config": datasets_yaml,
        "dataset_name": "mdu",
        "beam_search": bool(args.beam),
        "max_seq_length_decoder": 512,
        "max_eval_samples": args.max_eval_samples,
        "model_name_or_path": args.checkpoint,
        "output_dir": run_dir,
    }
    for key, value in predict_overrides:
        predict_cfg[key] = value
    predict_yaml = os.path.join(run_dir, "predict.yaml")
    with open(predict_yaml, "w") as f:
        yaml.safe_dump(predict_cfg, f)

    scores = eval_main.main(predict_yaml, device=args.device)
    print("scores:", {k: round(v, 4) for k, v in scores.items()})
    print(f"artifacts in {run_dir}/predictions")


if __name__ == "__main__":
    main()
