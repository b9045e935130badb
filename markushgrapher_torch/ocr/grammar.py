"""ChemicalOCR output grammar: `<ocr>`-wrapped text with quantized boxes.

Behavioral equivalent of the reference's parsing helpers
(DS4SD/MarkushGrapher:markushgrapher/ocr/chemical_ocr.py:165-223): two coordinate
formats (legacy `<loc_N>` tokens and the newer `x1>y1>x2>y2>text` lines),
boxes normalized by /500, and `<ocr>...</ocr>` span extraction.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

MAX_BBOX = 500


def clean_ocr_text(text: str, start_tag: str = "<ocr>",
                   end_tag: str = "</ocr>") -> str:
    """Drop everything before `start_tag` and after `end_tag`."""
    text = re.sub(rf"^.*?({re.escape(start_tag)})", r"\1", text,
                  flags=re.DOTALL)
    if end_tag:
        text = re.sub(rf"({re.escape(end_tag)}).*?$", r"\1", text,
                      flags=re.DOTALL)
    return text


def parse_ocr_string(ocr_string: str) -> Tuple[List[str], List[List[float]]]:
    """Predicted string -> (words, normalized boxes in [0,1])."""
    cleaned = re.sub(r"</?ocr>", "", ocr_string).strip()
    words: List[str] = []
    boxes: List[List[float]] = []

    if "<loc_" in cleaned:
        cleaned = re.sub(r"^<loc_0><loc_0><loc_500><loc_500>", "", cleaned,
                         count=1).strip()
        for line in cleaned.splitlines():
            locs = list(map(int, re.findall(r"<loc_(\d+)>", line)))
            text = re.sub(r"(?:<loc_\d+>)+", "", line).strip()
            if len(locs) >= 4 and text:
                bbox = locs[-4:]
                words.append(text)
                boxes.append([x / MAX_BBOX for x in bbox])
    else:
        for line in cleaned.splitlines():
            m = re.match(r"^(?:\d+>)*(\d+)>(\d+)>(\d+)>(\d+)>(.+)$",
                         line.strip())
            if m:
                text = m.group(5).strip()
                if text:
                    words.append(text)
                    boxes.append([int(m.group(k)) / MAX_BBOX
                                  for k in range(1, 5)])
    return words, boxes


def cells_from_prediction(text: str) -> List[Dict]:
    """Full pipeline: raw generation -> `cells` rows [{bbox, text}]
    (chemical_ocr.py:446-458)."""
    words, boxes = parse_ocr_string(clean_ocr_text(text))
    return [{"bbox": box, "text": word} for word, box in zip(words, boxes)]


def render_ocr_target(cells: List[Dict], fmt: str = "loc") -> str:
    """Inverse direction, used to build OCR training targets
    (ocr_dataset.py create_det:53-79): cells -> `<ocr>...</ocr>` string."""
    lines: List[str] = []
    if fmt == "loc":
        header = "<loc_0><loc_0><loc_500><loc_500>"
        for cell in cells:
            q = [max(0, min(MAX_BBOX, round(c * MAX_BBOX)))
                 for c in cell["bbox"]]
            lines.append("".join(f"<loc_{v}>" for v in q) + cell["text"])
        return "<ocr>" + header + "\n".join(lines) + "</ocr>"
    for cell in cells:
        q = [max(0, min(MAX_BBOX, round(c * MAX_BBOX))) for c in cell["bbox"]]
        lines.append(">".join(str(v) for v in q) + ">" + cell["text"])
    return "<ocr>" + "\n".join(lines) + "</ocr>"
