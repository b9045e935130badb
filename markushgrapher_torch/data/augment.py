"""Train-time augmentation (host-side, numpy/cv2) — replaces the reference's
albumentations pipeline (DS4SD/MarkushGrapher:markushgrapher/utils/ocsr/
image_augmentation.py: ShiftScaleRotate, RandomLines, PepperPatches,
Downscale/GaussianBlur) and OCR noise augmentation (ocr_augmentation.py:
bbox jitter + realistic character noise)."""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

try:
    import cv2
    HAS_CV2 = True
except Exception:  # pragma: no cover
    HAS_CV2 = False


@dataclass
class Augmenter:
    """Geometric + photometric image augmentation with bbox tracking.

    Cells carry normalized [0,1] boxes; geometric transforms update them.
    """

    shift_limit: float = 0.05
    scale_limit: float = 0.1
    rotate_limit: float = 2.0
    p_geometric: float = 0.5
    p_lines: float = 0.3
    p_pepper: float = 0.3
    p_blur: float = 0.3
    max_lines: int = 4
    pepper_patches: int = 3
    pepper_density: float = 0.05
    seed: int = 0

    def __post_init__(self):
        self.rng = random.Random(self.seed)

    def __call__(self, image: np.ndarray, cells: Sequence[Dict]
                 ) -> Tuple[np.ndarray, List[Dict]]:
        cells = [dict(c) for c in cells]
        if HAS_CV2 and self.rng.random() < self.p_geometric:
            image, cells = self._shift_scale_rotate(image, cells)
        if self.rng.random() < self.p_lines:
            image = self._random_lines(image)
        if self.rng.random() < self.p_pepper:
            image = self._pepper_patches(image)
        if HAS_CV2 and self.rng.random() < self.p_blur:
            k = self.rng.choice([3, 5])
            image = cv2.GaussianBlur(image, (k, k), 0)
        return image, cells

    def _shift_scale_rotate(self, image, cells):
        h, w = image.shape[:2]
        angle = self.rng.uniform(-self.rotate_limit, self.rotate_limit)
        scale = 1.0 + self.rng.uniform(-self.scale_limit, self.scale_limit)
        tx = self.rng.uniform(-self.shift_limit, self.shift_limit) * w
        ty = self.rng.uniform(-self.shift_limit, self.shift_limit) * h
        mat = cv2.getRotationMatrix2D((w / 2, h / 2), angle, scale)
        mat[0, 2] += tx
        mat[1, 2] += ty
        out = cv2.warpAffine(image, mat, (w, h), borderValue=(255, 255, 255))
        for cell in cells:
            x0, y0, x1, y1 = cell["bbox"]
            corners = np.array(
                [[x0 * w, y0 * h], [x1 * w, y0 * h],
                 [x0 * w, y1 * h], [x1 * w, y1 * h]], np.float32)
            ones = np.ones((4, 1), np.float32)
            warped = np.hstack([corners, ones]) @ mat.T
            nx0, ny0 = warped.min(0)
            nx1, ny1 = warped.max(0)
            cell["bbox"] = [
                float(np.clip(nx0 / w, 0, 1)), float(np.clip(ny0 / h, 0, 1)),
                float(np.clip(nx1 / w, 0, 1)), float(np.clip(ny1 / h, 0, 1))]
        return out, cells

    def _random_lines(self, image):
        img = image.copy()
        h, w = img.shape[:2]
        for _ in range(self.rng.randint(1, self.max_lines)):
            p0 = (self.rng.randint(0, w - 1), self.rng.randint(0, h - 1))
            p1 = (self.rng.randint(0, w - 1), self.rng.randint(0, h - 1))
            color = self.rng.randint(0, 120)
            if HAS_CV2:
                cv2.line(img, p0, p1, (color,) * 3, 1)
        return img

    def _pepper_patches(self, image):
        img = image.copy()
        h, w = img.shape[:2]
        rng = np.random.RandomState(self.rng.randint(0, 2 ** 31))
        for _ in range(self.pepper_patches):
            ph = rng.randint(8, max(9, h // 8))
            pw = rng.randint(8, max(9, w // 8))
            y = rng.randint(0, h - ph)
            x = rng.randint(0, w - pw)
            mask = rng.rand(ph, pw) < self.pepper_density
            region = img[y:y + ph, x:x + pw]
            region[mask] = 0
        return img


# character confusion table (ocr_augmentation.py:67-119)
CHAR_SUBS = {"0": "O", "O": "0", "1": "l", "l": "1", "5": "S", "S": "5",
             "8": "B", "B": "8"}


@dataclass
class OCRAugmenter:
    """OCR noise: bbox jitter + realistic text noise."""

    bbox_jitter: float = 0.01
    p_char_sub: float = 0.02
    p_insert: float = 0.01
    p_delete: float = 0.01
    p_transpose: float = 0.01
    p_case: float = 0.02
    seed: int = 0

    def __post_init__(self):
        self.rng = random.Random(self.seed)

    def __call__(self, cells: Sequence[Dict]) -> List[Dict]:
        out = []
        for cell in cells:
            cell = dict(cell)
            cell["bbox"] = [
                float(np.clip(c + self.rng.uniform(-self.bbox_jitter,
                                                   self.bbox_jitter), 0, 1))
                for c in cell["bbox"]]
            cell["text"] = self.augment_text(cell["text"])
            out.append(cell)
        return out

    def augment_text(self, text: str) -> str:
        chars = list(text)
        i = 0
        result = []
        while i < len(chars):
            c = chars[i]
            r = self.rng.random()
            if r < self.p_delete:
                i += 1
                continue
            if r < self.p_delete + self.p_transpose and i + 1 < len(chars):
                result.extend([chars[i + 1], c])
                i += 2
                continue
            if c in CHAR_SUBS and self.rng.random() < self.p_char_sub:
                c = CHAR_SUBS[c]
            if c.isalpha() and self.rng.random() < self.p_case:
                c = c.swapcase()
            result.append(c)
            if self.rng.random() < self.p_insert:
                result.append(self.rng.choice("abcdefghij0123456789"))
            i += 1
        return "".join(result)
