"""Fixed-shape batch collation.

The reference already right-pads every batch to max_length / max_length_decoder
(DS4SD/MarkushGrapher:markushgrapher/core/trainers/data_collator.py:11-110 — its
own comment notes dynamic padding is "very bad for TPU", arguments.py:100-103).
Here that is the contract: every batch has identical shapes so XLA compiles
exactly one program. Labels pad with -100 (CE ignore)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np

LABEL_PAD = -100


def pad_to(arr: np.ndarray, length: int, value) -> np.ndarray:
    """Right-pad (or truncate) axis 0 to `length`."""
    n = arr.shape[0]
    if n >= length:
        return arr[:length]
    pad_shape = (length - n,) + arr.shape[1:]
    return np.concatenate([arr, np.full(pad_shape, value, dtype=arr.dtype)], 0)


@dataclass
class DataCollator:
    max_length: int = 512
    max_length_decoder: int = 512
    pad_token_id: int = 0

    def __call__(self, samples: Sequence[Dict[str, np.ndarray]]
                 ) -> Dict[str, np.ndarray]:
        batch: Dict[str, List[np.ndarray]] = {}
        for s in samples:
            for k, v in s.items():
                batch.setdefault(k, []).append(np.asarray(v))

        out: Dict[str, np.ndarray] = {}
        for key, items in batch.items():
            if key == "input_ids":
                out[key] = np.stack([pad_to(x, self.max_length, self.pad_token_id)
                                     for x in items])
            elif key == "attention_mask":
                out[key] = np.stack([pad_to(x, self.max_length, 0) for x in items])
            elif key == "bbox":
                out[key] = np.stack([pad_to(x, self.max_length, 0.0) for x in items])
            elif key == "labels":
                out[key] = np.stack(
                    [pad_to(x, self.max_length_decoder, LABEL_PAD) for x in items])
            elif key in ("pixel_values", "ocsr_pixel_values"):
                out[key] = np.stack(items)
            elif key == "definition_groups":
                out[key] = np.stack([pad_to(x, 16, 0) for x in items])
            else:  # ids and other metadata pass through as lists
                out[key] = items  # type: ignore[assignment]
        return out
