"""ChemicalOCR engine: batched and continuous-batching OCR on the port (port
of `markushgrapher_tpu.ocr.engine`).

Batched: one prefill, then greedy decode as a Python loop over steps against
the per-layer rings (or, under `megastep`, one `ops.megastep` launch per
step). Continuous batching (`generate_stream` / `stream_retired`, and
`predict` under `stream=True`): rows retire at EOS or at their image's token
budget, and freed rows take the next images of the queue in refill waves,
each row decoding at its own position (`ChemicalOCRModel.decode_step` with a
vector step). Then loc-grammar parsing into the `cells` column, and
`predict_to_disk`'s DatasetDict save: the reference's stage-1 / stage-2
on-disk contract (`markushgrapher/ocr/chemical_ocr.py:396-478`).

`OCREngineConfig` has every field of the JAX config, with its refusals:
the decode weights are int8, int4 (`weight_bits=4`) or W8A8 dots
(`act_quant=True`, int8 weights only: `quantize_weights` raises otherwise),
and the megastep takes int8 rings and int8 weights only. `mega_block_s`
picks the TPU kernel's ring block and
changes nothing here (the megastep reads the ring in chunks that fit shared
memory). The engine runs on the CUDA device unless the caller passes
`device="cpu"`. It takes a built model, as the reference's does: valid-prefix
ring reads are the model's flag (`ChemicalOCRModel(cfg, block_skip=True)`).
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
    quant_weights: bool = False     # quantised decode-step weights (serving)
    quant_kv: bool = False          # int8 KV rings (serving mode)
    int4_kv: bool = False           # pack the KV rings to int4 (needs quant_kv)
    weight_bits: int = 8            # 4: int4 decode weights
    act_quant: bool = False         # W8A8 decode dots (int8 weights)
    megastep: bool = False          # whole-step decode kernel, int8 weights
    mega_block_s: int = 0           # the TPU kernel's ring block: no effect
    stream: bool = False            # continuous batching in predict()
    refill_batch: int = 8           # stream refill wave size
    stream_inner: int = 64          # stream decode steps per host readback

    def __post_init__(self):
        if self.stream and self.megastep:
            raise ValueError(
                "OCREngineConfig: stream=True is incompatible with "
                "megastep=True (stacked rings have no per-row positions)")
        if self.int4_kv and not self.quant_kv:
            raise ValueError(
                "OCREngineConfig: int4_kv=True requires quant_kv=True — "
                "prefill would silently build full-precision rings otherwise")
        if self.megastep and (not self.quant_kv or self.int4_kv
                              or self.weight_bits != 8 or self.act_quant):
            raise ValueError(
                "OCREngineConfig: megastep=True requires int8 rings and "
                "int8 weights (quant_kv=True, int4_kv=False, weight_bits=8, "
                "act_quant=False)")


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
            qw = (model.quantize_weights(cfg.weight_bits, cfg.act_quant)
                  if cfg.quant_weights else None)
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

    # -- continuous batching (retire at EOS or budget, refill) ----------------

    def _stream_prefill(self, images, idxs: List[int]):
        """Prefill of the images `idxs` of the queue: (per-layer rings of
        len(idxs) rows, first tokens [len(idxs)], L0)."""
        if isinstance(images, torch.Tensor):
            pix = images[idxs].to(self.device)
        else:
            pix = torch.as_tensor(np.stack([np.asarray(images[i])
                                            for i in idxs]),
                                  device=self.device)
        if pix.dtype == torch.uint8:
            pix = ocr_from_uint8(pix)
        cfg = self.cfg
        logits, caches, prefix_len = self.model.prefill(
            pix, self.prompt_ids[None].expand(len(idxs), -1),
            cfg.max_new_tokens, quant_kv=cfg.quant_kv, int4=cfg.int4_kv)
        return caches, logits[:, -1].argmax(dim=-1), prefix_len

    def _stream_chunk(self, state: Dict, qw, prefix_len: int, steps: int,
                      top: int) -> None:
        """`steps` decode steps of every row at its own position, in place
        (the reference's chunk body): the fed token is each row's (n-1)-th,
        a finished row emits pad_id and keeps its n, a row finishes at EOS
        or when n + 1 reaches its budget. `top` bounds the largest ring slot
        at the first step (the host's block_skip bound)."""
        cfg, model = self.cfg, self.model
        rows = torch.arange(state["n"].shape[0], device=self.device)
        for i in range(steps):
            logits = model.decode_step(state["tok"], state["caches"],
                                       state["n"] - 1, prefix_len, qw,
                                       slot_bound=top + i)
            fin, n = state["finished"], state["n"]
            nxt = torch.where(fin, cfg.pad_id, logits[:, -1].argmax(dim=-1))
            pos = n.clamp(0, cfg.max_new_tokens - 1)
            state["out"][rows, pos] = torch.where(
                fin, state["out"][rows, pos], nxt)
            state["finished"] = fin | (nxt == cfg.eos_id) | (
                n + 1 >= state["budget"])
            state["n"] = torch.where(fin, n, n + 1)
            state["tok"] = nxt[:, None]

    def generate_stream(self, images, budgets=None, batch: int = 0,
                        refill_batch: int = 8, inner: int = 64
                        ) -> List[torch.Tensor]:
        """Continuous-batching OCR over a queue of images: rows retire at
        EOS or at their image's token budget and the next images refill the
        freed rows, so a long page no longer holds the whole batch.

        images: [N, H, W, 3] float in [0, 1] or uint8 (an array, a tensor
        or a list of per-image arrays). budgets: optional [N] per-image
        token budgets, clipped to [1, max_new_tokens]. Returns N
        [max_new_tokens] id tensors (pad after the last token), in the
        images' order; an image's ids do not depend on the batch, the
        refill waves, `inner` or its row."""
        results: List[Optional[torch.Tensor]] = [None] * len(images)
        for i, ids in self.stream_retired(images, budgets, batch,
                                          refill_batch, inner):
            results[i] = ids
        return results

    @torch.no_grad()
    def stream_retired(self, images, budgets=None, batch: int = 0,
                       refill_batch: int = 8, inner: int = 64):
        """Generator form of generate_stream: yields (image index, ids) as
        each row retires, in retirement order, so a downstream stage can
        start on an image while the other rows decode.

        The state holds, per row of `batch` (default cfg.batch_size): the
        rings, n (tokens generated), the fed token, finished, out [batch,
        max_new_tokens] and the budget. A chunk runs up to `inner` decode
        steps, then reads finished and n back once; it stops early only
        where every row has reached its budget, which the host knows (EOS
        may come earlier: the further steps leave a finished row as it is).
        Freed rows wait until `refill_batch` of them are free, or until the
        rest of the queue fits in them; a wave prefills only its images and
        writes its rows' rings and state in place. A short queue's rows
        with no image are born finished; an empty queue yields nothing."""
        cfg = self.cfg
        if cfg.megastep:
            raise ValueError("stream_retired: megastep uses a stacked-ring "
                             "layout without per-row positions; disable it")
        n_imgs = len(images)
        if n_imgs == 0:
            return
        batch = batch or cfg.batch_size
        refill_batch = max(1, min(refill_batch, batch))
        max_new = cfg.max_new_tokens
        if budgets is None:
            budgets = np.full(n_imgs, max_new, np.int64)
        budgets = np.clip(np.asarray(budgets, np.int64), 1, max_new)
        if budgets.shape != (n_imgs,):
            raise ValueError(f"stream_retired: {budgets.shape[0]} budgets "
                             f"for {n_imgs} images")
        qw = (self.model.quantize_weights(cfg.weight_bits, cfg.act_quant)
              if cfg.quant_weights else None)
        dev = self.device

        next_img = min(batch, n_imgs)
        owners = list(range(next_img)) + [-1] * (batch - next_img)
        caches, first, prefix_len = self._stream_prefill(
            images, list(range(next_img)))
        if next_img < batch:        # rows with no image: zero rings
            caches = [{k: torch.cat([t, t.new_zeros(
                (batch - next_img,) + t.shape[1:])]) for k, t in c.items()}
                for c in caches]
            first = torch.cat([first, first.new_full(
                (batch - next_img,), cfg.pad_id)])
        budget_h = np.ones(batch, np.int64)
        budget_h[:next_img] = budgets[:next_img]
        budget = torch.as_tensor(budget_h, device=dev)
        out = torch.full((batch, max_new), cfg.pad_id, dtype=torch.long,
                         device=dev)
        out[:, 0] = first
        state = {
            "caches": caches, "out": out, "budget": budget,
            "n": torch.ones(batch, dtype=torch.long, device=dev),
            "tok": first[:, None],
            "finished": (first == cfg.eos_id) | (budget <= 1)
            | (torch.arange(batch, device=dev) >= next_img)}
        n_h = np.ones(batch, np.int64)
        free: List[int] = []
        while True:
            # every live row reaches its budget within `steps` steps
            steps = min(inner, max([int(budget_h[r] - n_h[r])
                                    for r in range(batch)
                                    if owners[r] >= 0], default=0))
            self._stream_chunk(state, qw, prefix_len, steps,
                               prefix_len + int(n_h.max()) - 1)
            fin_n = torch.stack([state["finished"].long(),
                                 state["n"]]).cpu().numpy()
            fin, n_h = fin_n[0].astype(bool), fin_n[1]
            newly = [r for r in range(batch) if fin[r] and owners[r] >= 0]
            if newly:
                got = state["out"][torch.as_tensor(newly, device=dev)].cpu()
                done = [(owners[r], ids) for r, ids in zip(newly, got)]
                for r in newly:
                    owners[r] = -1
                yield from done
                free += newly
            while free and next_img < n_imgs and (
                    len(free) >= refill_batch
                    or n_imgs - next_img <= len(free)):
                take = min(refill_batch, n_imgs - next_img)
                rows, free = free[:take], free[take:]
                idxs = list(range(next_img, next_img + take))
                next_img += take
                self._stream_swap(state, rows, idxs, images, budgets)
                for r, i in zip(rows, idxs):
                    owners[r] = i
                    n_h[r] = 1
                    budget_h[r] = budgets[i]
            if all(o < 0 for o in owners) and next_img >= n_imgs:
                break

    def _stream_swap(self, state: Dict, rows: List[int], idxs: List[int],
                     images, budgets) -> None:
        """A refill wave: prefill the images `idxs` and write their rings
        and state into `rows` in place (the reference's swap)."""
        cfg = self.cfg
        caches, first, _ = self._stream_prefill(images, idxs)
        at = torch.as_tensor(rows, device=self.device)
        for full, new in zip(state["caches"], caches):
            for k, t in new.items():
                full[k][at] = t
        budget = torch.as_tensor(budgets[idxs], device=self.device)
        state["out"][at] = cfg.pad_id
        state["out"][at, 0] = first
        state["n"][at] = 1
        state["tok"][at] = first[:, None]
        state["finished"][at] = (first == cfg.eos_id) | (budget <= 1)
        state["budget"][at] = budget

    # -- dataset-level API (chemical_ocr.py predict:396-478) ----------------

    def predict(self, dataset, image_key: str = "page_image",
                image_size: Optional[int] = None) -> List[List[Dict]]:
        """Run OCR over every sample of a list-like of dicts; returns the new
        `cells` column (an empty dataset gives []). Under `stream=True`
        through `stream_retired`, else in batches of batch_size."""
        from markushgrapher_torch.data.dataset import resize_image

        size = image_size or self.model.cfg.vision.image_size
        if self.cfg.stream:
            # continuous batching (the reference's vllm default,
            # chemical_ocr.py:242-287)
            t0 = time.time()
            imgs = [resize_image(dataset[i][image_key], size)
                    for i in range(len(dataset))]
            out: List[Optional[List[Dict]]] = [None] * len(imgs)
            for i, ids in self.stream_retired(
                    imgs, batch=self.cfg.batch_size,
                    refill_batch=self.cfg.refill_batch,
                    inner=self.cfg.stream_inner):
                out[i] = cells_from_prediction(self.decode_ids(ids[None])[0])
            logger.info("OCR (stream): %d images in %.1fs", len(imgs),
                        time.time() - t0)
            return out
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
