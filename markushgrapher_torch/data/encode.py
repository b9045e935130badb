"""Sample encoding: one dataset sample -> fixed-shape model arrays.

Merges the roles of the reference's `TaskCollator.collate`
(DS4SD/MarkushGrapher:markushgrapher/core/datasets/task_collator.py:28-105),
`MarkushgrapherProcessor` (UDOP processor: instruction + OCR words + boxes ->
input_ids/bbox) and `encode_item` (utils/common.py:14-97). The instruction is
prompt text with zero boxes; each OCR word's subword pieces share the word's
box; labels route through the Markush tokenizer by tag.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from markushgrapher_torch.data.cells import prepare_cells_to_text
from markushgrapher_torch.data.markush_tokenizer import MarkushTokenizer
from markushgrapher_torch.data.vocab import EOS_ID, MGTokenizer

DEFAULT_QUESTION = "What markush structure is in the image?"
INSTRUCTION_PREFIX = "Question Answering. "

# image normalization constants
VTL_MEAN, VTL_STD = 0.5, 0.5            # UDOP image processor style
OCSR_MEAN = np.array([0.485, 0.456, 0.406], np.float32)  # imagenet (MolScribe)
OCSR_STD = np.array([0.229, 0.224, 0.225], np.float32)


@dataclass
class SampleEncoder:
    markush_tokenizer: MarkushTokenizer
    max_seq_length: int = 512
    max_seq_length_decoder: int = 512
    normalize_bbox: bool = True  # boxes already in [0,1] cell space
    udop_tokenizer_only: bool = False  # bypass Markush routing (plain text)

    @property
    def tokenizer(self) -> MGTokenizer:
        return self.markush_tokenizer.tokenizer

    def encode_inputs(
        self,
        cells: Sequence[Dict],
        question: str = DEFAULT_QUESTION,
        image_size: float = 512.0,
    ) -> Dict[str, np.ndarray]:
        """Instruction + OCR words/boxes -> input_ids [T], bbox [T,4] in [0,1],
        attention_mask [T] (unpadded; collator pads)."""
        instruction = INSTRUCTION_PREFIX + question
        ids: List[int] = []
        boxes: List[Sequence[float]] = []
        for piece in self.tokenizer.tokenize(instruction):
            ids.append(self.tokenizer.piece_to_id(piece))
            boxes.append((0.0, 0.0, 0.0, 0.0))

        words, word_boxes, _ = prepare_cells_to_text(
            cells, self.tokenizer, image_size, image_size,
            self.normalize_bbox, self.max_seq_length)
        for word, box in zip(words, word_boxes):
            if self.normalize_bbox:
                norm = tuple(c / image_size for c in box)
            else:
                norm = tuple(c / 500.0 for c in box)  # 0-500 grid -> [0,1]
            # words from prepare_cells_to_text are already sentencepiece
            # pieces; every piece of the word shares the word box
            ids.append(self.tokenizer.piece_to_id(word))
            boxes.append(norm)

        ids = ids[: self.max_seq_length - 1] + [EOS_ID]
        boxes = boxes[: self.max_seq_length - 1] + [(0.0, 0.0, 0.0, 0.0)]
        return {
            "input_ids": np.asarray(ids, np.int32),
            "bbox": np.asarray(boxes, np.float32),
            "attention_mask": np.ones(len(ids), np.int32),
        }

    def encode_labels(self, answer: str) -> np.ndarray:
        """Answer -> label ids + EOS (tag-routed; utils/common.py:45-64)."""
        if self.udop_tokenizer_only:
            ids = self.tokenizer.encode(answer)  # includes EOS
        else:
            ids = self.markush_tokenizer.encode(answer) + [EOS_ID]
        return np.asarray(ids[: self.max_seq_length_decoder], np.int32)

    def __call__(
        self,
        cells: Sequence[Dict],
        answer: str,
        image: Optional[np.ndarray] = None,       # HWC uint8/float
        ocsr_image: Optional[np.ndarray] = None,  # HWC uint8/float
        question: str = DEFAULT_QUESTION,
    ) -> Dict[str, np.ndarray]:
        enc = self.encode_inputs(cells, question)
        enc["labels"] = self.encode_labels(answer)
        if image is not None:
            enc["pixel_values"] = normalize_vtl_image(image)
        if ocsr_image is not None:
            enc["ocsr_pixel_values"] = normalize_ocsr_image(ocsr_image)
        return enc


def normalize_vtl_image(image: np.ndarray) -> np.ndarray:
    x = image.astype(np.float32)
    if x.max() > 1.5:
        x = x / 255.0
    return (x - VTL_MEAN) / VTL_STD


def normalize_ocsr_image(image: np.ndarray) -> np.ndarray:
    x = image.astype(np.float32)
    if x.max() > 1.5:
        x = x / 255.0
    return (x - OCSR_MEAN) / OCSR_STD
