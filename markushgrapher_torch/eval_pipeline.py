"""Batched evaluation: dataset -> batched greedy generation on the port ->
decode -> chemistry scoring -> artifacts (port of
`markushgrapher_tpu.eval_pipeline`).

Writes the reference's artifacts: `predictions_<N>.jsonl` rows {id, cxsmiles,
cxsmiles_opt, gt_cxsmiles, gt_cxsmiles_opt, prediction_text} and
`scores_<N>.json`, with a prediction pickle cache keyed on the decode config
and a weights fingerprint. Scoring uses the shared `markushgrapher_tpu.chem`
modules. Greedy only; length-bucketed batching is not ported yet.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import pickle
import re
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from markushgrapher_tpu.chem import cxsmiles as cx_lib
from markushgrapher_tpu.chem.abbreviation import Abbreviation, fix_cxsmiles
from markushgrapher_tpu.chem.evaluation import aggregate_scores, score_sample
from markushgrapher_tpu.data.collator import DataCollator
from markushgrapher_tpu.data.markush_tokenizer import MarkushTokenizer
from markushgrapher_torch.decode.generate import generate
from markushgrapher_torch.models.markushgrapher import encoder_valid_max

logger = logging.getLogger(__name__)

MODEL_INPUTS = ("input_ids", "bbox", "attention_mask", "pixel_values",
                "ocsr_pixel_values")


@dataclass
class EvalConfig:
    max_length: int = 512
    num_beams: int = 1           # beam search: ROADMAP queue 1 item 6
    batch_size: int = 8
    max_eval_samples: Optional[int] = None
    remove_stereo: bool = False
    fix_cxsmiles: bool = True
    output_dir: str = "eval_out"
    cache_predictions: bool = True
    bf16_params: bool = True     # serve with bf16 weights
    # static packed cross-cache length (0 = off); must bound every row's
    # valid encoder count (models.markushgrapher.encoder_valid_max)
    cross_pack_len: int = 0
    save_visualizations: int = 0
    # -1 never fires: a benchmark on random weights decodes max_length steps
    eos_id: int = 1


@dataclass
class EvalResult:
    scores: Dict[str, float]
    predictions: List[Dict[str, Any]]
    per_sample: List[Dict[str, Any]]


class Evaluator:
    def __init__(self, model, markush_tokenizer: Optional[MarkushTokenizer],
                 cfg: EvalConfig, abbreviation: Optional[Abbreviation] = None,
                 input_tokenizer: Optional[MarkushTokenizer] = None):
        """`model` is a `markushgrapher_torch` MarkushGrapherModel holding
        its weights on the device it serves from; it serves int4 KV caches
        with int8 decode weights. markush_tokenizer (default: the standard
        `MarkushTokenizer()`) decodes and parses predictions;
        input_tokenizer (default: the same) parses ground-truth
        annotations."""
        if cfg.bf16_params:
            model = model.to(torch.bfloat16)
        self.model = model.eval()
        self.mt = markush_tokenizer or MarkushTokenizer()
        self.mt_input = input_tokenizer or self.mt
        self.cfg = cfg
        self.abbreviation = abbreviation or Abbreviation()
        self._params_fp: Optional[float] = None

    @property
    def device(self) -> torch.device:
        return self.model.shared_embedding.device

    # -- generation -------------------------------------------------------

    def generate_batch(self, batch: Dict[str, np.ndarray],
                       cross_pack_len: Optional[int] = None) -> np.ndarray:
        """Collated numpy batch -> generated ids [B, max_length] (numpy)."""
        pack = cross_pack_len or self.cfg.cross_pack_len or None
        model_batch = {k: torch.as_tensor(np.asarray(v), device=self.device)
                       for k, v in batch.items() if k in MODEL_INPUTS}
        if pack:
            # a packed length below a row's valid count would silently drop
            # valid keys: check every batch
            mv = encoder_valid_max(self.model.cfg, model_batch["bbox"],
                                   model_batch["attention_mask"])
            if mv > pack:
                raise ValueError(
                    f"packed length {pack} < batch valid count {mv}: raise "
                    "cross_pack_len (size via encoder_valid_max, rounded up)")
        out = generate(self.model, model_batch,
                       max_length=self.cfg.max_length,
                       num_beams=self.cfg.num_beams,
                       eos_id=self.cfg.eos_id,
                       cross_pack_len=pack)
        return out.cpu().numpy()

    # -- the loop -----------------------------------------------------------

    def _cache_digest(self) -> str:
        """Key the prediction cache on the decode config and a weights
        fingerprint, so stale predictions are never re-scored."""
        if self._params_fp is None:
            self._params_fp = float(sum(
                p.detach().to(torch.float32).sum().item()
                for p in self.model.parameters()))
        cfg = self.cfg
        key = (f"torch;beams={cfg.num_beams};len={cfg.max_length};"
               f"xp={cfg.cross_pack_len};"
               f"bf16={cfg.bf16_params};fp={self._params_fp:.6e}")
        return hashlib.md5(key.encode()).hexdigest()[:10]

    def run(self, dataset, collator: Optional[DataCollator] = None,
            benchmark_name: str = "eval") -> EvalResult:
        cfg = self.cfg
        os.makedirs(cfg.output_dir, exist_ok=True)
        cache_path = os.path.join(
            cfg.output_dir,
            f"predictions_cache_{benchmark_name}_{self._cache_digest()}.pkl")
        n = len(dataset)
        if cfg.max_eval_samples:
            n = min(n, cfg.max_eval_samples)
        cached: Dict[Any, str] = {}
        if cfg.cache_predictions and os.path.exists(cache_path):
            with open(cache_path, "rb") as f:
                cached = pickle.load(f)
            logger.info("loaded %d cached predictions", len(cached))

        collator = collator or DataCollator()
        predictions: List[Dict[str, Any]] = []
        per_sample: List[Dict[str, Any]] = []
        t0 = time.time()
        batch_samples: List[Dict] = []
        batch_meta: List[Dict] = []

        def flush():
            nonlocal batch_samples, batch_meta
            todo = [i for i, m in enumerate(batch_meta)
                    if m["id"] not in cached]
            if todo:
                samples = [batch_samples[i] for i in todo]
                while len(samples) < cfg.batch_size:   # fixed batch shape
                    samples.append(samples[-1])
                ids_out = self.generate_batch(collator(samples))
                for k, i in enumerate(todo):
                    cached[batch_meta[i]["id"]] = self.mt.decode(ids_out[k])
            for m in batch_meta:
                self._score_one(m, cached[m["id"]], predictions, per_sample)
            batch_samples, batch_meta = [], []
            if cfg.cache_predictions:
                with open(cache_path, "wb") as f:
                    pickle.dump(cached, f)

        for idx in range(n):
            item = dataset[idx]
            meta = {
                "id": item.pop("id", idx),
                "gt_cxsmiles_opt": dataset.source[idx].get("cxsmiles_opt", ""),
                "gt_annotation": dataset.source[idx].get("annotation", ""),
            }
            if idx < cfg.save_visualizations:
                from markushgrapher_tpu.data.dataset import resize_image

                meta["cells"] = list(dataset.source[idx].get("cells") or [])
                img = dataset.source[idx].get("page_image")
                meta["image"] = (resize_image(img, 512)
                                 if img is not None else None)
            item.pop("labels", None)
            batch_samples.append(item)
            batch_meta.append(meta)
            if len(batch_samples) == cfg.batch_size:
                flush()
        if batch_samples:
            flush()

        elapsed = time.time() - t0
        scores = aggregate_scores(per_sample, prefix=f"{benchmark_name}_ar_")
        scores[f"{benchmark_name}_images_per_sec"] = (
            round(n / elapsed, 4) if elapsed > 0 else 0.0)
        self._write_artifacts(predictions, scores, n)
        return EvalResult(scores=scores, predictions=predictions,
                          per_sample=per_sample)

    # -- scoring -------------------------------------------------------------

    def _score_one(self, meta: Dict, text: str, predictions: List,
                   per_sample: List) -> None:
        gt_opt = meta["gt_cxsmiles_opt"]
        gt_stable = self.mt_input.get_stable(meta["gt_annotation"]) or {}
        s = score_sample(text, gt_opt, gt_stable, self.mt,
                         abbreviation=self.abbreviation,
                         remove_stereo=self.cfg.remove_stereo,
                         fix=self.cfg.fix_cxsmiles)
        per_sample.append(s)
        m = re.search(r"<cxsmi>(.*?)(</cxsmi>|$)", text)
        pred_opt = m.group(1).replace(" ", "").split("!")[0] if m else None
        pred_out = None
        if pred_opt:
            pred_out = cx_lib.convert_opt_to_out(pred_opt)
            if self.cfg.fix_cxsmiles:
                pred_out = fix_cxsmiles(pred_out, self.abbreviation)
        gt_out = cx_lib.convert_opt_to_out(gt_opt)
        predictions.append({
            "id": meta["id"],
            "cxsmiles": pred_out,
            "cxsmiles_opt": pred_opt,
            "gt_cxsmiles": (fix_cxsmiles(gt_out, self.abbreviation)
                            if self.cfg.fix_cxsmiles else gt_out),
            "gt_cxsmiles_opt": gt_opt,
            "prediction_text": text,
        })
        if len(predictions) <= self.cfg.save_visualizations:
            try:
                from markushgrapher_tpu.utils.viz import display_eval_sample

                viz_dir = os.path.join(self.cfg.output_dir, "visualization")
                os.makedirs(viz_dir, exist_ok=True)
                display_eval_sample(
                    image=meta.get("image"), cells=meta.get("cells", []),
                    gt_text=meta["gt_annotation"], pred_text=text,
                    gt_stable=gt_stable,
                    pred_stable=self.mt.get_stable(text),
                    pred_cxsmiles=pred_out,
                    scores={k: s[k] for k in
                            ("cxsmi_equality", "stable_equality",
                             "markush_equality") if k in s},
                    output_path=os.path.join(viz_dir,
                                             f"sample_{meta['id']}.png"))
            except Exception as e:  # a figure must never fail an eval
                logger.warning("visualization failed for %s: %s",
                               meta["id"], e)

    def _write_artifacts(self, predictions, scores, n: int) -> None:
        pred_path = os.path.join(self.cfg.output_dir,
                                 f"predictions_{n}.jsonl")
        with open(pred_path, "w") as f:
            for row in predictions:
                f.write(json.dumps(row) + "\n")
        scores_path = os.path.join(self.cfg.output_dir, f"scores_{n}.json")
        with open(scores_path, "w") as f:
            json.dump(scores, f, indent=2)
        logger.info("wrote %s and %s", pred_path, scores_path)
