"""Batched evaluation: dataset -> batched generation on the port (greedy or
beam search) -> decode -> chemistry scoring -> artifacts (port of
`markushgrapher_tpu.eval_pipeline`).

Writes the reference's artifacts: `predictions_<N>.jsonl` rows {id, cxsmiles,
cxsmiles_opt, gt_cxsmiles, gt_cxsmiles_opt, prediction_text} and
`scores_<N>.json`, with a prediction pickle cache keyed on the decode config,
the KV scheme, the encoder route and a weights fingerprint. Scoring uses the port's own copies
of the chemistry modules (`markushgrapher_torch.chem`). With
`length_buckets` the samples are grouped by their valid encoder count into
static pack lengths (`data.bucketing`), each batch packed to its bucket's.
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

from markushgrapher_torch.chem import cxsmiles as cx_lib
from markushgrapher_torch.chem.abbreviation import Abbreviation, fix_cxsmiles
from markushgrapher_torch.chem.evaluation import aggregate_scores, score_sample
from markushgrapher_torch.data.collator import DataCollator
from markushgrapher_torch.data.markush_tokenizer import MarkushTokenizer
from markushgrapher_torch.decode.generate import generate, pick_self_seg
from markushgrapher_torch.data.bucketing import bucket_pack_lengths
from markushgrapher_torch.models.markushgrapher import (encoder_valid_counts,
                                                        encoder_valid_max)

logger = logging.getLogger(__name__)

MODEL_INPUTS = ("input_ids", "bbox", "attention_mask", "pixel_values",
                "ocsr_pixel_values")


@dataclass
class EvalConfig:
    max_length: int = 512
    num_beams: int = 1           # reference predict: 5 (beam_search flag)
    batch_size: int = 8
    max_eval_samples: Optional[int] = None
    remove_stereo: bool = False
    fix_cxsmiles: bool = True
    output_dir: str = "eval_out"
    cache_predictions: bool = True
    bf16_params: bool = True     # serve with bf16 weights
    quant_kv: bool = False       # quantised KV caches (else float)
    quant_weights: bool = False  # int8 decode-step weights
    int4_cross: bool = False     # int4 KV (the model must be built with it)
    # static packed cross-cache length (0 = off); must bound every row's
    # valid encoder count (models.markushgrapher.encoder_valid_max)
    cross_pack_len: int = 0
    # length-bucketed batching (0 = off, else the number of buckets, >= 2):
    # samples grouped by valid encoder count into static pack lengths
    # (data.bucketing); overrides cross_pack_len, which becomes the cap
    length_buckets: int = 0
    bucket_round_to: int = 256   # pack lengths round up to this multiple
    bucket_margin: int = 64      # headroom above each sample's valid count
    save_visualizations: int = 0
    # the quantised beam's copy-on-write self rings: segment size and the
    # lattice reads (None: decode.generate.pick_self_seg's default and its
    # BEAM_SELF_SEG / BEAM_LATTICE environment)
    self_seg: Optional[int] = None
    lattice: Optional[bool] = None
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
        its weights on the device it serves from (cast to bf16 with
        `bf16_params`, as the reference's `cast_params`); it decodes with
        `cfg.quant_kv` (its `int4_cross` scheme) or float caches and, with
        `cfg.quant_weights`, int8 decode weights. markush_tokenizer
        (default: the standard `MarkushTokenizer()`) decodes and parses
        predictions;
        input_tokenizer (default: the same) parses ground-truth
        annotations."""
        if cfg.quant_kv and cfg.int4_cross != model.int4_cross:
            raise ValueError(f"EvalConfig.int4_cross={cfg.int4_cross} but "
                             f"the model decodes with int4_cross="
                             f"{model.int4_cross}")
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
        """Collated numpy batch -> generated ids [B, max_length] (numpy).
        cross_pack_len overrides cfg.cross_pack_len for this batch (the
        length-bucketed loop passes each bucket's length)."""
        pack = (cross_pack_len if cross_pack_len is not None
                else (self.cfg.cross_pack_len or None))
        model_batch = {k: torch.as_tensor(np.asarray(v), device=self.device)
                       for k, v in batch.items() if k in MODEL_INPUTS}
        # a packed length below a row's valid count would silently drop
        # valid keys: check every batch. The cross caches hold the whole
        # encoder output, the packed VTL encoder only its own positions (the
        # reference holds both to the whole count, which refuses batches
        # that pack fine once molscribe tokens precede the VTL ones)
        for name, length, with_mols in (
                ("cross_pack_len", pack, True),
                ("encoder_pack_len", self.model.encoder_pack_len, False)):
            if not length:
                continue
            mv = encoder_valid_max(self.model.cfg, model_batch["bbox"],
                                   model_batch["attention_mask"], with_mols)
            if mv > length:
                raise ValueError(
                    f"packed length {length} < batch valid count {mv}: "
                    f"raise {name} (size via "
                    "models.markushgrapher.encoder_valid_max, rounded up)")
        out = generate(self.model, model_batch,
                       max_length=self.cfg.max_length,
                       num_beams=self.cfg.num_beams,
                       eos_id=self.cfg.eos_id,
                       quant_cross_kv=self.cfg.quant_kv,
                       quant_weights=self.cfg.quant_weights,
                       cross_pack_len=pack, self_seg=self.cfg.self_seg,
                       lattice=self.cfg.lattice)
        return out.cpu().numpy()

    # -- the loop -----------------------------------------------------------

    def _cache_digest(self) -> str:
        """Key the prediction cache on what changes predictions: the decode
        config (with the quantised beam's ring segments and lattice, which
        move scores at the bf16 level), the KV scheme, encoder route and
        valid-prefix reads the model runs, the pack lengths and a weights
        fingerprint, so stale predictions are never re-scored."""
        if self._params_fp is None:
            self._params_fp = float(sum(
                p.detach().to(torch.float32).sum().item()
                for p in self.model.parameters()))
        cfg, m = self.cfg, self.model
        seg, lattice = ((0, False) if cfg.num_beams <= 1 or not cfg.quant_kv
                        else pick_self_seg(cfg.max_length, cfg.self_seg,
                                           cfg.lattice))
        key = (f"torch;beams={cfg.num_beams};len={cfg.max_length};"
               f"seg={seg};lattice={lattice};block_skip={m.block_skip};"
               f"qkv={cfg.quant_kv};qw={cfg.quant_weights};"
               f"i4={cfg.quant_kv and m.int4_cross};xp={cfg.cross_pack_len};"
               f"lb={cfg.length_buckets},{cfg.bucket_round_to},"
               f"{cfg.bucket_margin};bias_int8={m.bias_int8};"
               f"inkernel={m.inkernel_bias};ep={m.encoder_pack_len};"
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

        def save_cache():
            if cfg.cache_predictions:
                with open(cache_path, "wb") as f:
                    pickle.dump(cached, f)

        def flush(pack_len: Optional[int] = None):
            nonlocal batch_samples, batch_meta
            if not batch_samples:
                return
            todo = [i for i, m in enumerate(batch_meta)
                    if m["id"] not in cached]
            if todo:
                samples = [batch_samples[i] for i in todo]
                while len(samples) < cfg.batch_size:   # fixed batch shape
                    samples.append(samples[-1])
                ids_out = self.generate_batch(collator(samples),
                                              cross_pack_len=pack_len)
                for k, i in enumerate(todo):
                    cached[batch_meta[i]["id"]] = self.mt.decode(ids_out[k])
            for m in batch_meta:
                self._score_one(m, cached[m["id"]], predictions, per_sample)
            batch_samples, batch_meta = [], []

        def push(idx: int, pack_len: Optional[int]) -> None:
            item = dataset[idx]
            meta = {
                "id": item.pop("id", idx),
                "gt_cxsmiles_opt": dataset.source[idx].get("cxsmiles_opt", ""),
                "gt_annotation": dataset.source[idx].get("annotation", ""),
            }
            # visualisations follow the dataset index, bucketed or not
            if idx < cfg.save_visualizations:
                from markushgrapher_torch.data.dataset import resize_image

                meta["cells"] = list(dataset.source[idx].get("cells") or [])
                img = dataset.source[idx].get("page_image")
                meta["image"] = (resize_image(img, 512)
                                 if img is not None else None)
            item.pop("labels", None)
            batch_samples.append(item)
            batch_meta.append(meta)
            if len(batch_samples) == cfg.batch_size:
                flush(pack_len)
                save_cache()

        if cfg.length_buckets >= 2:
            # bucket-major order: batches never span buckets
            for pack_len, idxs in self._assign_buckets(dataset, n, collator):
                for idx in idxs:
                    push(int(idx), pack_len)
                flush(pack_len)
        else:
            for idx in range(n):
                push(idx, None)
            flush()
        save_cache()

        elapsed = time.time() - t0
        scores = aggregate_scores(per_sample, prefix=f"{benchmark_name}_ar_")
        scores[f"{benchmark_name}_images_per_sec"] = (
            round(n / elapsed, 4) if elapsed > 0 else 0.0)
        self._write_artifacts(predictions, scores, n)
        return EvalResult(scores=scores, predictions=predictions,
                          per_sample=per_sample)

    def _assign_buckets(self, dataset, n: int, collator: DataCollator):
        """First pass: per-sample valid encoder counts (bbox and
        attention_mask only, 64 samples per call) -> static pack-length
        buckets [(pack_len or None, sample indices)]. A bucket whose length
        reaches the unpacked encoder length runs unpacked (None)."""
        cfg_m = self.model.cfg
        counts = np.zeros(n, np.int64)
        chunk, base = [], 0
        for idx in range(n):
            item = dataset[idx]
            chunk.append({k: item[k] for k in ("bbox", "attention_mask")})
            if len(chunk) == 64 or idx == n - 1:
                cb = collator(chunk)
                c = encoder_valid_counts(
                    cfg_m, torch.as_tensor(cb["bbox"], device=self.device),
                    torch.as_tensor(cb["attention_mask"], device=self.device))
                counts[base:base + len(chunk)] = c.cpu().numpy()
                base += len(chunk)
                chunk = []
        buckets = bucket_pack_lengths(counts, self.cfg.length_buckets,
                                      round_to=self.cfg.bucket_round_to,
                                      margin=self.cfg.bucket_margin,
                                      cap=self.cfg.cross_pack_len or None)
        total = cfg_m.encoder_total_len
        out = [(None if ln >= total else ln, idxs) for ln, idxs in buckets]
        logger.info("length buckets: %s",
                    [(ln, len(idxs)) for ln, idxs in out])
        return out

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
                from markushgrapher_torch.utils.viz import display_eval_sample

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
