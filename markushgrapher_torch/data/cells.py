"""OCR cell preprocessing: cells -> per-subword (words, bboxes).

Behavioral equivalent of the reference's
DS4SD/MarkushGrapher:markushgrapher/core/common/data_preprocessing.py (cell boxes
split proportionally to estimated glyph width, 12 px/char) and the bbox
normalization helpers in core/common/utils.py:175-222. Also provides the
`<loc_N>`-token IoU used by the trainer's eval metrics
(curriculumTrainer.py:689-703).
"""

from __future__ import annotations

import logging
from typing import Dict, List, Sequence, Tuple

from markushgrapher_torch.data.vocab import SP_SPACE, MGTokenizer

logger = logging.getLogger(__name__)

PX_PER_CHAR = 12


def clamp(v, lo, hi):
    return max(min(v, hi), lo)


def normalize_bbox(bbox: Sequence[float], size: Sequence[float],
                   scale: int = 1000) -> List[int]:
    return [
        int(clamp(scale * bbox[0] / size[0], 0, scale)),
        int(clamp(scale * bbox[1] / size[1], 0, scale)),
        int(clamp(scale * bbox[2] / size[0], 0, scale)),
        int(clamp(scale * bbox[3] / size[1], 0, scale)),
    ]


def normalize_bbox_format(bbox: Sequence[float], image_width: float,
                          image_height: float) -> Tuple[int, int, int, int]:
    """Pixel box -> 0-500 grid (pre-2025 trainings path,
    data_preprocessing.py:85-87)."""
    xmin, ymin, xmax, ymax = bbox
    return (int(xmin / image_width * 500), int(ymin / image_height * 500),
            int(xmax / image_width * 500), int(ymax / image_height * 500))


def check_max_values(bbox: Sequence[float], max_value: int = 500) -> bool:
    return any(c > max_value for c in bbox)


def normal_text(t) -> str:
    if isinstance(t, float) and t == int(t):
        t = int(t)
    return str(t).strip()


def estimate_word_width(word: str) -> int:
    if word == SP_SPACE:
        length = 1
    else:
        length = len([c for c in word if c != SP_SPACE])
    return length * PX_PER_CHAR


def split_bounding_box_for_words(
    sentence: str, bounding_box: Sequence[float], tokenizer: MGTokenizer,
) -> Tuple[List[str], List[Tuple[float, float, float, float]]]:
    """Split one cell's box into per-subword boxes proportional to estimated
    glyph width (data_preprocessing.py:24-48)."""
    words = tokenizer.tokenize(sentence)
    total = sum(estimate_word_width(w) for w in words)
    if total == 0:
        return words, [tuple(bounding_box)] * len(words)
    x_min, y_min, x_max, y_max = bounding_box
    left = x_min
    boxes = []
    for w in words:
        frac = estimate_word_width(w) / total
        width = (x_max - x_min) * frac
        boxes.append((left, y_min, left + width, y_max))
        left += width
    return words, boxes


def prepare_cells_to_text(
    cells: Sequence[Dict],
    tokenizer: MGTokenizer,
    w: float,
    h: float,
    normalize: bool,
    max_sequence_length: int = 512,
) -> Tuple[List[str], List[Tuple], int]:
    """Flatten OCR cells into (words, bboxes, token_count), truncating at
    max_sequence_length-15 (data_preprocessing.py:59-104). Cell bboxes come
    in normalized [0,1]; when `normalize` is False the output boxes are on
    the 0-500 grid, otherwise pixel coordinates (renormalized downstream)."""
    words: List[str] = []
    bboxes: List[Tuple] = []
    token_idx = 0
    for cell in cells:
        if not cell["text"] or cell["text"].isspace():
            continue
        cell_bbox = [cell["bbox"][0] * w, cell["bbox"][1] * h,
                     cell["bbox"][2] * w, cell["bbox"][3] * h]
        split_words, split_boxes = split_bounding_box_for_words(
            cell["text"], cell_bbox, tokenizer)
        for word_text, word_bbox in zip(split_words, split_boxes):
            if word_text.isspace():
                continue
            if not normalize:
                word_bbox = normalize_bbox_format(word_bbox, w, h)
            if check_max_values(word_bbox):
                logger.debug("cell box out of range %s", word_bbox)
                continue
            words.append(normal_text(word_text))
            bboxes.append(word_bbox)
            token_idx += len(tokenizer.tokenize(normal_text(word_text)))
            if token_idx >= max_sequence_length - 15:
                break
        if token_idx >= max_sequence_length:
            break
    return words, bboxes, token_idx


def order_cells(cells: Sequence[Dict]) -> List[Dict]:
    """Sort cells in reading order (y, then x) — mdu_dataset.py:78-80."""
    return sorted(cells, key=lambda c: (c["bbox"][1], c["bbox"][0]))


def loc_token_iou(box1: Sequence[str], box2: Sequence[str]) -> float:
    """IoU over two 4-tuples of `<loc_N>` token strings
    (core/common/utils.py:155-172)."""
    x1a, y1a, x2a, y2a = [int(box1[i][5:-1]) for i in range(4)]
    x1b, y1b, x2b, y2b = [int(box2[i][5:-1]) for i in range(4)]
    inter = max(0, min(x2a, x2b) - max(x1a, x1b)) * \
        max(0, min(y2a, y2b) - max(y1a, y1b))
    union = abs(x2a - x1a) * abs(y2a - y1a) + abs(x2b - x1b) * abs(y2b - y1b) - inter
    return inter / union if union > 0 else 0.0
