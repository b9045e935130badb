"""Training entry point: `python -m markushgrapher_torch.train_main
<config.yaml>` (port of `markushgrapher_tpu.train_main`, the same YAML keys).

Parses the config, builds the model and datasets (+ benchmark datasets),
trains with periodic benchmark evaluation through the port's `Evaluator`
(greedy, on a bf16 copy of the weights), resumes from the last checkpoint,
and saves the final state, `train_results.json` and `metrics.jsonl`. Runs
on CUDA, and refuses to start without a card unless called as
`main(path, device="cpu")`.
"""

from __future__ import annotations

import copy
import json
import logging
import os
import sys
import time
from typing import Dict, Optional

import torch

from markushgrapher_torch.arguments import (
    build_model_config,
    build_train_config,
    frozen_prefixes,
    parse_yaml_config,
)
from markushgrapher_torch.data.augment import Augmenter, OCRAugmenter
from markushgrapher_torch.data.collator import DataCollator
from markushgrapher_torch.data.dataset import (
    BatchIterator,
    DatasetRegistry,
    MultitaskIterator,
)
from markushgrapher_torch.eval_pipeline import EvalConfig, Evaluator
from markushgrapher_torch.models.markushgrapher import MarkushGrapherModel
from markushgrapher_torch.train.checkpoint import Checkpointer, last_checkpoint
from markushgrapher_torch.train.trainer import Trainer
from markushgrapher_torch.utils.tracker import make_tracker

logger = logging.getLogger(__name__)


def setup_logging(level=logging.INFO):
    logging.basicConfig(
        level=level,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
        stream=sys.stdout)


def main(config_path: Optional[str] = None,
         device: Optional[str] = None) -> Dict[str, float]:
    setup_logging()
    config_path = config_path or sys.argv[1]
    margs, dargs, targs = parse_yaml_config(config_path)
    device = torch.device(device or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "markushgrapher_torch.train_main runs on a CUDA device and found "
            "none; pass device='cpu' to train on the CPU")
    logger.info("model args: %s", margs)
    logger.info("device: %s", device)

    cfg = build_model_config(margs, dargs)
    tcfg = build_train_config(targs, dargs, margs)
    with torch.device(device):
        model = MarkushGrapherModel(cfg)

    registry = DatasetRegistry.from_yaml(dargs.datasets_config)
    ds_kwargs = dict(image_size=dargs.image_size,
                     max_seq_length=dargs.max_seq_length,
                     max_seq_length_decoder=dargs.max_seq_length_decoder)
    # comma-separated names -> multitask uniform sampling
    train_names = [n.strip() for n in dargs.dataset_name.split(",")
                   if n.strip()]
    train_sets = {}
    for name in train_names:
        ds = registry.build(name, split="train", train=True, **ds_kwargs)
        if dargs.augment_train:
            ds.augmenter = Augmenter(seed=targs.seed)
            ds.ocr_augmenter = OCRAugmenter(seed=targs.seed)
        train_sets[name] = ds
    train_ds = train_sets[train_names[0]]
    val_ds = registry.build(train_names[0], split="val", train=False,
                            **ds_kwargs)

    benchmarks = {}
    for name in margs.eval_benchmarks:
        if name in registry.configs:
            benchmarks[name] = registry.build(name, split="test",
                                              train=False, **ds_kwargs)
        else:
            logger.warning("benchmark %s not in datasets config; skipping",
                           name)

    collator = DataCollator(max_length=dargs.max_seq_length,
                            max_length_decoder=dargs.max_seq_length_decoder)
    batch_size = tcfg.per_device_batch_size
    multitask = None
    if len(train_sets) > 1:
        levels = {name: int(registry.configs[name].get("curriculum_level", 0))
                  for name in train_sets}
        multitask = MultitaskIterator({
            name: BatchIterator(ds, collator, batch_size, shuffle=True,
                                seed=targs.seed, loop=True)
            for name, ds in train_sets.items()}, seed=targs.seed,
            levels=levels)
        train_iter = iter(multitask)
    else:
        train_iter = iter(BatchIterator(train_ds, collator, batch_size,
                                        shuffle=True, seed=targs.seed,
                                        loop=True))

    def strip_meta(batch):
        return {k: v for k, v in batch.items()
                if k not in ("id", "task_name")}

    tracker = make_tracker(targs.report_to, output_dir=targs.output_dir,
                           task_name=getattr(dargs, "clearml_task_name",
                                             None))
    tracker.connect({**vars(margs), **vars(dargs), **vars(targs)})

    trainer = Trainer(model=model, cfg=tcfg,
                      frozen_prefixes=frozen_prefixes(margs),
                      metric_for_best_model=targs.metric_for_best_model
                      or None,
                      on_curriculum_level=(multitask.set_level
                                           if multitask else None),
                      tracker=tracker)
    state = trainer.init_state(targs.seed)

    ckptr = Checkpointer(targs.output_dir, targs.save_total_limit)
    resume = targs.resume_from_checkpoint or last_checkpoint(targs.output_dir)
    if resume:
        logger.info("resuming from %s", resume)
        state = ckptr.restore(resume, state)

    def eval_fn(state, step):
        metrics: Dict[str, float] = {}
        eval_cfg = EvalConfig(
            max_length=dargs.max_seq_length_decoder,
            num_beams=1,  # greedy for the on-the-fly eval
            batch_size=targs.per_device_eval_batch_size,
            max_eval_samples=dargs.max_eval_samples or 25,
            save_visualizations=dargs.save_visualizations,
            output_dir=os.path.join(targs.output_dir, f"eval_{step}"))
        # the evaluator serves a bf16 copy; the master weights stay float32
        evaluator = Evaluator(copy.deepcopy(state.params),
                              train_ds.markush_tokenizer, eval_cfg)
        for name, ds in {"mdu": val_ds, **benchmarks}.items():
            try:
                result = evaluator.run(ds, collator, benchmark_name=name)
                metrics.update(result.scores)
            except Exception as e:  # benchmark eval must not kill training
                logger.exception("benchmark %s failed: %s", name, e)
        return metrics

    trainer.eval_fn = eval_fn

    state = trainer.train(
        state, (strip_meta(b) for b in train_iter), targs.seed,
        max_steps=tcfg.max_steps, log_every=targs.logging_steps,
        checkpointer=ckptr)

    ckptr.save(state.step, state)
    metrics_path = os.path.join(targs.output_dir, "train_results.json")
    with open(metrics_path, "w") as f:
        json.dump(trainer.log_history, f, indent=2, default=float)
    with open(os.path.join(targs.output_dir, "metrics.jsonl"), "a") as f:
        for event in trainer.log_history:
            f.write(json.dumps(dict(event, ts=time.time()), default=float)
                    + "\n")
    tracker.close()
    logger.info("training done; history at %s", metrics_path)
    return trainer.log_history[-1] if trainer.log_history else {}


if __name__ == "__main__":
    main()
