"""ChemicalOCR engine: batched OCR on the port (port of
`markushgrapher_tpu.ocr.engine`, batched path).

Batched prefill, then greedy decode as a Python loop over steps against the
per-layer rings (or, under `megastep`, one `ops.megastep` launch per step),
then loc-grammar parsing into the `cells` column, and `predict_to_disk`'s
DatasetDict save: the reference's stage-1 / stage-2 on-disk contract
(`markushgrapher/ocr/chemical_ocr.py:396-478`).

`OCREngineConfig` has every field of the JAX config. Not ported yet, and
refused by name: continuous batching (`stream=True`, or `refill_batch` /
`stream_inner` away from their defaults; `generate_stream` /
`stream_retired`), int4 decode weights (`weight_bits=4`) and W8A8 decode
dots (`act_quant=True`). `mega_block_s` picks the TPU kernel's ring block
and changes nothing here (the megastep reads the ring in chunks that fit
shared memory). The engine runs on the CUDA device
unless the caller passes `device="cpu"`. It takes a built model, as the
reference's does: valid-prefix ring reads are the model's flag
(`ChemicalOCRModel(cfg, block_skip=True)`).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, fields
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from markushgrapher_torch.data.device_pixels import ocr_from_uint8
from markushgrapher_torch.ocr.grammar import cells_from_prediction
from markushgrapher_torch.ocr.vlm import (ChemicalOCRModel, OCRConfig,
                                          OCRTextConfig, OCRVisionConfig)

logger = logging.getLogger(__name__)

DEFAULT_PROMPT = "Perform OCR on this chemical structure image."


@dataclass
class OCREngineConfig:
    max_new_tokens: int = 4096      # chemical_ocr.py:334
    batch_size: int = 8
    eos_id: int = 2                 # -1 never fires: fixed-length decode
    pad_id: int = 0
    quant_weights: bool = False     # int8 decode-step weights (serving mode)
    quant_kv: bool = False          # int8 KV rings (serving mode)
    int4_kv: bool = False           # pack the KV rings to int4 (needs quant_kv)
    weight_bits: int = 8            # 8 only: int4 decode weights not ported
    act_quant: bool = False         # False only: W8A8 not ported
    megastep: bool = False          # whole-step decode kernel, int8 weights
    mega_block_s: int = 0           # the TPU kernel's ring block: no effect
    stream: bool = False            # continuous batching: not ported yet
    refill_batch: int = 8           # stream refill wave size (stream only)
    stream_inner: int = 64          # stream steps per readback (stream only)

    def __post_init__(self):
        if self.stream or (self.refill_batch, self.stream_inner) != (8, 64):
            raise ValueError(
                "OCREngineConfig: continuous batching (stream=True, "
                "refill_batch, stream_inner) is not ported yet; use the "
                "batched engine")
        if self.weight_bits != 8:
            raise ValueError(
                f"OCREngineConfig: int4 decode weights (weight_bits="
                f"{self.weight_bits}) are not ported yet; weight_bits=8")
        if self.act_quant:
            raise ValueError(
                "OCREngineConfig: W8A8 decode dots (act_quant=True) are not "
                "ported yet")
        if self.int4_kv and not self.quant_kv:
            raise ValueError(
                "OCREngineConfig: int4_kv=True requires quant_kv=True — "
                "prefill would silently build full-precision rings otherwise")
        if self.megastep and (not self.quant_kv or self.int4_kv):
            # the step quantises its own weights to int8 (megastep_pack)
            raise ValueError(
                "OCREngineConfig: megastep=True requires int8 rings "
                "(quant_kv=True, int4_kv=False)")


def build_ocr_configs(overrides=None):
    """(OCRConfig, OCREngineConfig) with flat-key overrides.

    Keys: `vision.<field>` / `text.<field>` for the submodel configs, bare
    field names for OCRConfig / OCREngineConfig (`max_new_tokens` sets both).
    Unknown keys raise — a typo'd override must not silently serve the
    full-size model."""
    ov = dict(overrides or {})
    vis = {k[len("vision."):]: ov.pop(k) for k in list(ov)
           if k.startswith("vision.")}
    txt = {k[len("text."):]: ov.pop(k) for k in list(ov)
           if k.startswith("text.")}
    top_names = {f.name for f in fields(OCRConfig)} - {"vision", "text"}
    eng_names = {f.name for f in fields(OCREngineConfig)}
    top = {k: ov.pop(k) for k in list(ov) if k in top_names}
    eng = {k: ov.pop(k) for k in list(ov) if k in eng_names}
    if "max_new_tokens" in top:
        eng.setdefault("max_new_tokens", top["max_new_tokens"])
    if ov:
        raise ValueError(f"unknown OCR override keys: {sorted(ov)}")
    cfg = OCRConfig(vision=OCRVisionConfig(**vis), text=OCRTextConfig(**txt),
                    **top)
    return cfg, OCREngineConfig(**eng)


class ChemicalOCR:
    """Batched OCR inference engine over a `ChemicalOCRModel` that holds its
    weights; `tokenizer` is MGTokenizer-compatible (`encode(text,
    add_eos=False)`, `decode(ids)`)."""

    def __init__(self, model: ChemicalOCRModel, tokenizer: Any,
                 cfg: Optional[OCREngineConfig] = None,
                 prompt: str = DEFAULT_PROMPT, device: Optional[str] = None):
        self.device = torch.device(device or "cuda")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "ChemicalOCR runs on a CUDA device and found none; pass "
                "device='cpu' to run the plain versions on the CPU")
        self.model = model.to(self.device).eval()
        self.tokenizer = tokenizer
        self.cfg = cfg or OCREngineConfig()
        self.prompt_ids = torch.tensor(
            tokenizer.encode(prompt, add_eos=False), dtype=torch.long,
            device=self.device)

    @torch.no_grad()
    def _generate(self, pixel_values: torch.Tensor,
                  prompt_ids: torch.Tensor) -> torch.Tensor:
        """[B, max_new_tokens] generated ids (pad after EOS): the first token
        from the prefill logits, then one decode step per token until every
        row has emitted EOS (never, with eos_id=-1)."""
        model, cfg = self.model, self.cfg
        if pixel_values.dtype == torch.uint8:
            pixel_values = ocr_from_uint8(pixel_values)
        logits, caches, prefix_len = model.prefill(
            pixel_values, prompt_ids, cfg.max_new_tokens,
            quant_kv=cfg.quant_kv, int4=cfg.int4_kv)
        if cfg.megastep:
            mw = model.megastep_pack()
            caches = model.stack_caches(caches)
        else:
            qw = model.quantize_weights() if cfg.quant_weights else None
        batch = pixel_values.shape[0]
        first = logits[:, -1].argmax(dim=-1)
        out = torch.full((batch, cfg.max_new_tokens), cfg.pad_id,
                         dtype=torch.long, device=first.device)
        out[:, 0] = first
        finished = first == cfg.eos_id
        tok = first[:, None]
        for step in range(1, cfg.max_new_tokens):
            if cfg.eos_id >= 0 and bool(finished.all()):
                break
            # the fed token is the (step-1)-th generated one: ring slot and
            # RoPE position prefix_len + step - 1
            if cfg.megastep:
                logits = model.decode_step_mega(tok, caches, step - 1,
                                                prefix_len, mw)
            else:
                logits = model.decode_step(tok, caches, step - 1, prefix_len,
                                           qw)
            nxt = logits[:, -1].argmax(dim=-1)
            nxt = torch.where(finished, cfg.pad_id, nxt)
            finished = finished | (nxt == cfg.eos_id)
            out[:, step] = nxt
            tok = nxt[:, None]
        return out

    def generate_batch_async(self, images, return_pixels: bool = False):
        """Run OCR decode for a batch; returns the id tensor on the device
        (the caller syncs when it reads it). `images` [B, H, W, 3] may be
        float in [0, 1] or uint8 (normalised on the device). With
        return_pixels=True also returns the device pixel tensor, so a
        downstream stage can reuse it (data/device_pixels.py)."""
        if len(images) == 0:
            raise ValueError("ChemicalOCR.generate_batch: no images (a batch "
                             "needs at least one row)")
        pix = torch.as_tensor(np.asarray(images) if not isinstance(
            images, torch.Tensor) else images, device=self.device)
        prompt = self.prompt_ids[None].expand(pix.shape[0], -1)
        ids = self._generate(pix, prompt)
        return (ids, pix) if return_pixels else ids

    def decode_ids(self, ids) -> List[str]:
        rows = ids.cpu().numpy() if isinstance(ids, torch.Tensor) else ids
        return [self.tokenizer.decode([int(i) for i in row]) for row in rows]

    def generate_batch(self, images) -> List[str]:
        """images: [B, H, W, 3] float in [0, 1] or uint8 -> decoded strings."""
        return self.decode_ids(self.generate_batch_async(images))

    # -- dataset-level API (chemical_ocr.py predict:396-478) ----------------

    def predict(self, dataset, image_key: str = "page_image",
                image_size: Optional[int] = None) -> List[List[Dict]]:
        """Run OCR over every sample of a list-like of dicts; returns the new
        `cells` column (an empty dataset gives [])."""
        from markushgrapher_torch.data.dataset import resize_image

        size = image_size or self.model.cfg.vision.image_size
        cells_out: List[List[Dict]] = []
        batch_imgs: List[np.ndarray] = []
        t0 = time.time()

        def flush():
            nonlocal batch_imgs
            if not batch_imgs:
                return
            real = len(batch_imgs)
            while len(batch_imgs) < self.cfg.batch_size:
                batch_imgs.append(batch_imgs[-1])
            texts = self.generate_batch(
                np.stack(batch_imgs).astype(np.float32) / 255.0)
            for text in texts[:real]:
                cells_out.append(cells_from_prediction(text))
            batch_imgs = []

        n = len(dataset)
        for i in range(n):
            batch_imgs.append(resize_image(dataset[i][image_key], size))
            if len(batch_imgs) == self.cfg.batch_size:
                flush()
        flush()
        logger.info("OCR: %d images in %.1fs", n, time.time() - t0)
        return cells_out

    def predict_to_disk(self, dataset_dir: str, output_dir: str,
                        splits: Optional[Sequence[str]] = None) -> None:
        """load_from_disk -> predict -> replace `cells` -> save_to_disk
        (the stage-1 / stage-2 on-disk contract)."""
        import datasets as hfds

        ds = hfds.load_from_disk(dataset_dir)
        if not hasattr(ds, "keys"):
            ds = hfds.DatasetDict(test=ds)
        out = {}
        for split in (splits or list(ds.keys())):
            split_ds = ds[split]
            cells = self.predict(split_ds)
            out[split] = split_ds.map(
                lambda sample, i: {"cells": cells[i]}, with_indices=True)
        hfds.DatasetDict(out).save_to_disk(output_dir)
        logger.info("wrote OCR dataset to %s", output_dir)
