#!/usr/bin/env python
"""Build the canonical HF dataset from a directory of PNGs (the port's copy
of the JAX package's `scripts/image_dir_to_hf_dataset.py`).

Equivalent of the reference's scripts/dataset/image_dir_to_hf_dataset.py:
50-91 — creates the sample schema {id, page_image_path, description,
annotation, mol, cxsmiles_dataset, cxsmiles, cxsmiles_opt, keypoints, cells,
page_image} with the image fit into a white square canvas (crop_resize_pad
to 1024x1024 at scale 0.8, matching utils_dataset.py
square_with_white_borders_resize:92-121).

Usage: python -m markushgrapher_torch.scripts.image_dir_to_hf_dataset <image_dir> <output_dir>
"""

from __future__ import annotations

import os
import sys

import numpy as np


def square_with_white_borders_resize(image, size: int = 1024,
                                     scale: float = 0.8):
    """Fit the image into a size x size white canvas at `scale`."""
    from PIL import Image

    img = image.convert("RGB")
    target = int(size * scale)
    ratio = min(target / img.width, target / img.height)
    new_w, new_h = int(img.width * ratio), int(img.height * ratio)
    img = img.resize((new_w, new_h), Image.LANCZOS)
    canvas = Image.new("RGB", (size, size), (255, 255, 255))
    canvas.paste(img, ((size - new_w) // 2, (size - new_h) // 2))
    return canvas


def generate_hf_dataset(image_dir: str, output_dir: str,
                        canvas_size: int = 1024) -> None:
    import datasets as hfds
    from PIL import Image

    samples = []
    names = sorted(f for f in os.listdir(image_dir)
                   if f.lower().endswith((".png", ".jpg", ".jpeg")))
    for name in names:
        path = os.path.join(image_dir, name)
        img = square_with_white_borders_resize(Image.open(path), canvas_size)
        samples.append({
            "id": os.path.splitext(name)[0],
            "page_image_path": path,
            "page_image": np.asarray(img, np.uint8),
            "description": "",
            "annotation": "",
            "mol": "",
            "cxsmiles_dataset": "",
            "cxsmiles": "",
            "cxsmiles_opt": "",
            "keypoints": [],
            "cells": [],
        })
    if not samples:
        raise SystemExit(f"no images found in {image_dir}")
    ds = hfds.Dataset.from_list(samples)
    hfds.DatasetDict({"test": ds}).save_to_disk(output_dir)
    print(f"wrote {len(samples)} samples to {output_dir}")


if __name__ == "__main__":
    generate_hf_dataset(sys.argv[1], sys.argv[2])
