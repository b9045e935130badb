"""Seeded synthetic pages as a collated model batch, without rendering (no
PIL): OCR cells in the shape `markushgrapher_tpu.data.synthetic` renders,
encoded by the shared `SampleEncoder` and `DataCollator`, with seeded uint8
pixels normalised as the dataset does. For smoke runs and timing on random
weights, where the page content does not matter but its shape does."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from markushgrapher_tpu.data.collator import DataCollator
from markushgrapher_tpu.data.encode import (SampleEncoder,
                                            normalize_ocsr_image,
                                            normalize_vtl_image)
from markushgrapher_tpu.data.markush_tokenizer import MarkushTokenizer
from markushgrapher_tpu.data.synthetic import SUBSTITUENT_POOL
from markushgrapher_torch.config import MarkushGrapherConfig


def page_cells(rng: np.random.RandomState, size: int = 512) -> List[Dict]:
    """Atom-label boxes around the structure and one definition line per R
    group, with boxes normalised to [0, 1]."""
    cells = []
    for _ in range(rng.randint(6, 16)):
        x = size * (0.45 + 0.22 * rng.uniform(-1, 1))
        y = size * (0.32 + 0.22 * rng.uniform(-1, 1))
        cells.append({"bbox": [(x - 9) / size, (y - 7) / size,
                               (x + 9) / size, (y + 7) / size],
                      "text": str(rng.choice(["R1", "R2", "N", "O", "Cl",
                                              "OH", "X", "Br"]))})
    y0 = int(size * 0.72)
    for i in range(rng.randint(1, 4)):
        subs = rng.choice(SUBSTITUENT_POOL, rng.randint(1, 4), replace=False)
        text = f"R{i + 1} = {', '.join(subs)}"
        w = min(0.85, 0.02 + 0.011 * len(text))
        cells.append({"bbox": [0.08, y0 / size, 0.08 + w, (y0 + 14) / size],
                      "text": text})
        y0 += 22
    return cells


def page_batch(cfg: MarkushGrapherConfig, batch: int, seed: int,
               tokenizer: Optional[MarkushTokenizer] = None
               ) -> Dict[str, np.ndarray]:
    """`batch` seeded pages -> the collated numpy batch that
    `Evaluator.generate_batch` takes."""
    rng = np.random.RandomState(seed)
    enc = SampleEncoder(tokenizer or MarkushTokenizer(),
                        max_seq_length=cfg.max_seq_length)
    samples = []
    for _ in range(batch):
        s = enc.encode_inputs(page_cells(rng, cfg.vtl.image_size),
                              image_size=float(cfg.vtl.image_size))
        s["pixel_values"] = normalize_vtl_image(rng.randint(
            0, 256, (cfg.vtl.image_size,) * 2 + (3,)).astype(np.uint8))
        s["ocsr_pixel_values"] = normalize_ocsr_image(rng.randint(
            0, 256, (cfg.swin.image_size,) * 2 + (3,)).astype(np.uint8))
        samples.append(s)
    return DataCollator(max_length=cfg.max_seq_length)(samples)
