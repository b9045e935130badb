"""Synthetic Markush training-data generator.

Fills the role of the external `markushgenerator` package the reference
trains on (SURVEY.md §2.2: DS4SD/MarkushGenerator produces the synthetic
training sets, README.md:286): random molecular scaffolds with R-group
attachment points, optional position-variation (m:) and repeat (Sg:)
sections, a substituent-definition table, a rendered page image and OCR
cells — emitted in the canonical HF sample schema
(scripts/dataset/image_dir_to_hf_dataset.py:69-82 of the reference).

`page_batch` makes seeded pages as a collated model batch without rendering
(no PIL): OCR cells in the shape `render` emits, encoded by `SampleEncoder`
and `DataCollator`, with seeded uint8 pixels normalised as the dataset does.
For smoke runs and timing on random weights, where the page content does
not matter but its shape does. `labelled_batch` does the same for labelled
training samples.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from markushgrapher_torch.config import MarkushGrapherConfig
from markushgrapher_torch.data.collator import DataCollator
from markushgrapher_torch.data.encode import (SampleEncoder,
                                              normalize_ocsr_image,
                                              normalize_vtl_image)
from markushgrapher_torch.data.markush_tokenizer import MarkushTokenizer

SUBSTITUENT_POOL = [
    "H", "F", "Cl", "Br", "I", "OH", "NH2", "CN", "NO2", "CF3", "OMe",
    "methyl", "ethyl", "propyl", "isopropyl", "a halogen atom",
    "an alkyl group", "an aryl group", "hydrogen", "phenyl",
]

R_LETTERS = "RXYZWQ"


@dataclass
class SyntheticMarkushGenerator:
    seed: int = 0
    max_rgroups: int = 3
    p_m_section: float = 0.4
    p_sg_section: float = 0.25
    image_size: int = 512

    def __post_init__(self):
        self.rng = random.Random(self.seed)

    # -- structure generation ------------------------------------------------

    def random_scaffold(self) -> Tuple[str, int]:
        """Random SMILES scaffold; returns (smiles, atom_count)."""
        r = self.rng
        parts: List[str] = []
        atoms = 0
        if r.random() < 0.7:  # aromatic ring core
            parts.append("c1ccccc1")
            atoms += 6
        else:
            n = r.randint(4, 6)
            parts.append("C1" + "C" * (n - 2) + "C1")
            atoms += n
        # aliphatic tail
        tail = r.randint(1, 4)
        parts.append("C" * tail)
        atoms += tail
        if r.random() < 0.4:
            parts.append(r.choice(["O", "N", "C(=O)O"]))
            atoms += 1 if parts[-1] in ("O", "N") else 3
        return "".join(parts), atoms

    def sample(self, idx: int = 0) -> Dict:
        r = self.rng
        scaffold, n_atoms = self.random_scaffold()
        n_r = r.randint(1, self.max_rgroups)
        labels = [f"{R_LETTERS[i % len(R_LETTERS)]}{i // len(R_LETTERS) + 1}"
                  if i >= len(R_LETTERS) else f"R{i + 1}" for i in range(n_r)]

        # attach R groups by appending branches at the end (keeps the SMILES
        # valid without graph surgery)
        cxsmiles_opt = scaffold
        for lab in labels:
            cxsmiles_opt += f"(<r>{lab}</r>)" if r.random() < 0.5 \
                else f"<r>{lab}</r>"
        total_atoms = n_atoms + n_r

        sections = []
        if r.random() < self.p_m_section and n_atoms >= 6:
            anchor = total_atoms - 1
            ring = sorted(r.sample(range(6), 3))
            sections.append(f"m:{anchor}:{'.'.join(map(str, ring))}")
        if r.random() < self.p_sg_section and n_atoms >= 8:
            a = r.randint(6, n_atoms - 2)
            sections.append(f"Sg:n:{a}:n:ht")
        if sections:
            cxsmiles_opt += " |" + ",".join(sections) + "|"

        stable = {lab: r.sample(SUBSTITUENT_POOL, r.randint(1, 3))
                  for lab in labels}
        stable_str = "<ns>".join(
            f"{lab}:{'<n>'.join(subs)}" for lab, subs in stable.items())
        annotation = (f"<markush><cxsmi>{cxsmiles_opt}</cxsmi>"
                      f"<stable>{stable_str}</stable></markush>")

        image, cells = self.render(cxsmiles_opt, stable)
        return {
            "id": idx,
            "page_image": image,
            "page_image_path": "",
            "description": "",
            "annotation": annotation,
            "mol": "",
            "cxsmiles_dataset": "",
            "cxsmiles": cxsmiles_opt,
            "cxsmiles_opt": cxsmiles_opt,
            "keypoints": [],
            "cells": cells,
        }

    # -- rendering --------------------------------------------------------------

    def render(self, cxsmiles_opt: str, stable: Dict[str, List[str]]
               ) -> Tuple[np.ndarray, List[Dict]]:
        """Draw the structure region + definition lines; emit OCR cells."""
        from PIL import Image, ImageDraw

        from markushgrapher_torch.chem.cxsmiles import convert_opt_to_out, parse_cxsmiles
        from markushgrapher_torch.chem.mol import parse_smiles
        from markushgrapher_torch.utils.viz import layout_2d

        s = self.image_size
        img = Image.new("RGB", (s, s), (255, 255, 255))
        d = ImageDraw.Draw(img)
        cells: List[Dict] = []

        try:
            cx = parse_cxsmiles(convert_opt_to_out(cxsmiles_opt))
            mol = parse_smiles(cx.smiles)
            pos = layout_2d(mol, iterations=80, seed=self.rng.randint(0, 999))
            cxp = s * 0.45, s * 0.32  # structure center
            scale = s * 0.22
            pts = pos * scale + np.asarray(cxp)
            for b in mol.bonds:
                d.line([tuple(pts[b.a]), tuple(pts[b.b])], fill=(0, 0, 0),
                       width=2)
            for i, atom in enumerate(mol.atoms):
                label = cx.labels[i] if i < len(cx.labels) and cx.labels[i] \
                    else ("" if atom.symbol == "C" else atom.symbol)
                if label:
                    x, y = pts[i]
                    d.rectangle([x - 9, y - 7, x + 9, y + 7],
                                fill=(255, 255, 255))
                    d.text((x - 7, y - 6), label, fill=(0, 0, 0))
                    cells.append({
                        "bbox": [max(0.0, (x - 9) / s), max(0.0, (y - 7) / s),
                                 min(1.0, (x + 9) / s), min(1.0, (y + 7) / s)],
                        "text": label})
        except Exception:
            pass  # unparsable scaffold: blank structure region

        y0 = int(s * 0.72)
        for lab, subs in stable.items():
            text = f"{lab} = {', '.join(subs)}"
            d.text((int(s * 0.08), y0), text, fill=(0, 0, 0))
            w = min(0.85, 0.02 + 0.011 * len(text))
            cells.append({
                "bbox": [0.08, y0 / s, 0.08 + w, (y0 + 14) / s],
                "text": text})
            y0 += 22
        return np.asarray(img, np.uint8), cells


def generate_dataset(n: int, seed: int = 0, image_size: int = 512
                     ) -> List[Dict]:
    gen = SyntheticMarkushGenerator(seed=seed, image_size=image_size)
    return [gen.sample(i) for i in range(n)]


def save_synthetic_dataset(output_dir: str, n_train: int = 1000,
                           n_val: int = 50, n_test: int = 50,
                           seed: int = 0, image_size: int = 512) -> None:
    import datasets as hfds

    splits = {}
    offset = 0
    for split, n in (("train", n_train), ("val", n_val), ("test", n_test)):
        gen = SyntheticMarkushGenerator(seed=seed + offset,
                                        image_size=image_size)
        splits[split] = hfds.Dataset.from_list(
            [gen.sample(offset + i) for i in range(n)])
        offset += n
    hfds.DatasetDict(splits).save_to_disk(output_dir)


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



def labelled_batch(cfg: MarkushGrapherConfig, batch: int, seed: int,
                   tokenizer: Optional[MarkushTokenizer] = None
                   ) -> Dict[str, np.ndarray]:
    """`batch` labelled samples without rendering (no PIL): the generator's
    annotations, seeded OCR cells (`page_cells`) and seeded uint8 pixels
    normalised as the dataset does, through `MDUDataset` and `DataCollator`
    at the config's lengths: the numpy batch `Trainer.train_step` takes."""
    from markushgrapher_torch.data.dataset import MDUDataset

    rng = np.random.RandomState(seed)
    size, ocsr = cfg.vtl.image_size, cfg.swin.image_size
    gen = SyntheticMarkushGenerator(seed=seed, image_size=size)
    gen.render = lambda cxsmiles_opt, stable: (None, page_cells(rng, size))
    ds = MDUDataset(source=[gen.sample(i) for i in range(batch)],
                    markush_tokenizer=tokenizer or MarkushTokenizer(),
                    image_size=size, ocsr_image_size=ocsr,
                    max_seq_length=cfg.max_seq_length,
                    max_seq_length_decoder=cfg.max_seq_length_decoder)
    items = []
    for i in range(batch):
        item = {k: v for k, v in ds[i].items() if k != "id"}
        item["pixel_values"] = normalize_vtl_image(
            rng.randint(0, 256, (size, size, 3)).astype(np.uint8))
        item["ocsr_pixel_values"] = normalize_ocsr_image(
            rng.randint(0, 256, (ocsr, ocsr, 3)).astype(np.uint8))
        items.append(item)
    return DataCollator(max_length=cfg.max_seq_length,
                        max_length_decoder=cfg.max_seq_length_decoder)(items)
