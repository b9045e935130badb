"""Datasets: the MDU (Markush document understanding) dataset over on-disk HF
datasets, the dataset registry, and multitask sampling.

Capability parity with the reference's data layer:
 - `MDUDataset` ~ `MDU_Dataset` (DS4SD/MarkushGrapher:markushgrapher/core/datasets/
   mdu_dataset.py:22-251): splice `cxsmiles_opt` into the annotation's
   `<cxsmi>` span, LANCZOS-resize the page image, fixed QA prompt, train-time
   augmentation with bbox tracking, reading-order cell sort, sample encoding.
 - `DatasetRegistry` ~ `DatasetChain` (dataset_chain.py:15-68): YAML-driven
   construction of named datasets.
 - `MultitaskIterator` ~ `MultitaskDataloader` (curriculumTrainer.py:81-133):
   uniform task sampling across datasets.

Sample schema (scripts/dataset/image_dir_to_hf_dataset.py:69-82): {id,
page_image, cells, annotation, cxsmiles_opt, cxsmiles, mol, keypoints, ...}.
"""

from __future__ import annotations

import logging
import re
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from markushgrapher_torch.data.cells import order_cells
from markushgrapher_torch.data.collator import DataCollator
from markushgrapher_torch.data.encode import DEFAULT_QUESTION, SampleEncoder
from markushgrapher_torch.data.markush_tokenizer import MarkushTokenizer

logger = logging.getLogger(__name__)


def replace_cxsmiles_with_cxsmiles_opt(annotation: str, cxsmiles_opt: str) -> str:
    """Splice `cxsmiles_opt + "![[0,0]]"` into the `<cxsmi>` span
    (mdu_dataset.py:69-113)."""
    return re.sub(
        re.escape("<cxsmi>") + r"(.*?)" + re.escape("</cxsmi>"),
        lambda m: "<cxsmi>" + cxsmiles_opt + "![[0,0]]" + "</cxsmi>",
        annotation,
        count=1,
    )


def resize_image(image, size: int) -> np.ndarray:
    """LANCZOS resize to size x size, HWC uint8 (mdu_dataset.py:118)."""
    from PIL import Image

    if isinstance(image, list):  # hf-datasets stores plain arrays as lists
        image = np.asarray(image)
    if isinstance(image, np.ndarray):
        image = Image.fromarray(image.astype(np.uint8))
    image = image.convert("RGB").resize((size, size), Image.LANCZOS)
    return np.asarray(image, np.uint8)


@dataclass
class MDUDataset:
    """Map-style dataset over an HF dataset (or any list-like of dicts)."""

    source: Any                       # hf Dataset / list of sample dicts
    markush_tokenizer: MarkushTokenizer
    image_size: int = 512
    ocsr_image_size: int = 384
    max_seq_length: int = 512
    max_seq_length_decoder: int = 512
    train: bool = False
    augmenter: Optional[Any] = None   # data.augment.Augmenter
    ocr_augmenter: Optional[Any] = None
    question: str = DEFAULT_QUESTION
    udop_tokenizer_only: bool = False

    def __post_init__(self):
        self.encoder = SampleEncoder(
            self.markush_tokenizer,
            max_seq_length=self.max_seq_length,
            max_seq_length_decoder=self.max_seq_length_decoder,
            udop_tokenizer_only=self.udop_tokenizer_only,
        )

    @classmethod
    def from_disk(cls, dataset_path: str, split: str = "train", **kwargs):
        import datasets as hfds

        ds = hfds.load_from_disk(dataset_path)
        if hasattr(ds, "keys") and split in getattr(ds, "keys", lambda: [])():
            ds = ds[split]
        return cls(source=ds, **kwargs)

    def __len__(self) -> int:
        return len(self.source)

    def build_answer(self, sample: Dict) -> str:
        annotation = sample.get("annotation") or ""
        cxsmiles_opt = sample.get("cxsmiles_opt") or sample.get("cxsmiles") or ""
        if "<cxsmi>" in annotation and cxsmiles_opt:
            return replace_cxsmiles_with_cxsmiles_opt(annotation, cxsmiles_opt)
        if annotation:
            return annotation
        return f"<cxsmi>{cxsmiles_opt}![[0,0]]</cxsmi>"

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        sample = self.source[idx]
        image = sample.get("page_image")
        if image is None and sample.get("page_image_path"):
            from PIL import Image

            image = Image.open(sample["page_image_path"])
        cells = list(sample.get("cells") or [])

        img = resize_image(image, self.image_size) if image is not None else None

        if self.train and self.augmenter is not None and img is not None:
            img, cells = self.augmenter(img, cells)
        if self.train and self.ocr_augmenter is not None:
            cells = self.ocr_augmenter(cells)

        cells = order_cells(cells)
        answer = self.build_answer(sample)
        ocsr_img = (resize_image(image, self.ocsr_image_size)
                    if image is not None else None)
        enc = self.encoder(cells, answer, image=img, ocsr_image=ocsr_img,
                           question=self.question)
        enc["id"] = sample.get("id", idx)
        return enc

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


@dataclass
class DatasetRegistry:
    """YAML-driven dataset construction (the reference's DatasetChain reads
    config/datasets/*.yaml with keys dataset_path / encode_position /
    encode_index / condense_labels / normalize_bbox / training_dataset_name /
    udop_tokenizer_only, dataset_chain.py:43-65)."""

    configs: Dict[str, Dict]

    @classmethod
    def from_yaml(cls, path: str) -> "DatasetRegistry":
        import yaml

        with open(path) as f:
            return cls(yaml.safe_load(f))

    def build(self, name: str, split: str = "train", train: bool = False,
              **dataset_kwargs) -> MDUDataset:
        """Extra kwargs (image_size, max_seq_length, ...) pass through to
        MDUDataset."""
        cfg = dict(self.configs[name])
        mt = MarkushTokenizer(
            encode_position=cfg.get("encode_position", False),
            encode_index=cfg.get("encode_index", False),
            condense_labels=cfg.get("condense_labels", True),
            # reference dataset configs carry training_dataset_name; it picks
            # the vocab inventory + separators (markush_tokenizer.py:21-42)
            training_dataset_name=cfg.get("training_dataset_name"),
            vocab_dir=cfg.get("vocab_dir"),
        )
        return MDUDataset.from_disk(
            cfg["dataset_path"], split=split, markush_tokenizer=mt,
            train=train,
            udop_tokenizer_only=cfg.get("udop_tokenizer_only", False),
            **dataset_kwargs)


class BatchIterator:
    """Batches a map-style dataset through a DataCollator, optionally
    shuffled/sharded (the DistributedSampler equivalent is index sharding —
    each data-parallel host takes a strided slice)."""

    def __init__(self, dataset, collator: DataCollator, batch_size: int,
                 shuffle: bool = False, seed: int = 0, drop_last: bool = True,
                 shard_index: int = 0, num_shards: int = 1,
                 loop: bool = False):
        self.dataset = dataset
        self.collator = collator
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.loop = loop

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        epoch = 0
        while True:
            idx = np.arange(len(self.dataset))
            if self.shuffle:
                np.random.RandomState(self.seed + epoch).shuffle(idx)
            idx = idx[self.shard_index::self.num_shards]
            for start in range(0, len(idx), self.batch_size):
                chunk = idx[start:start + self.batch_size]
                if len(chunk) < self.batch_size and self.drop_last:
                    continue
                yield self.collator([self.dataset[int(i)] for i in chunk])
            epoch += 1
            if not self.loop:
                return


class MultitaskIterator:
    """Uniform task sampling across multiple batch iterators
    (curriculumTrainer.py MultitaskDataloader:81-133), with optional
    curriculum gating: tasks declare a difficulty level and only become
    sampleable once the current level reaches it (the reference's
    elevateMRCallback raises difficulty on eval-loss plateaus,
    curriculumTrainer.py:784-833)."""

    def __init__(self, iterators: Dict[str, Any], seed: int = 0,
                 levels: Optional[Dict[str, int]] = None):
        self.names = list(iterators.keys())
        self.iters = {k: iter(v) for k, v in iterators.items()}
        self.rng = np.random.RandomState(seed)
        self.levels = levels or {}
        self.level = max(self.levels.values(), default=0) \
            if not self.levels else 0

    def set_level(self, level: int) -> None:
        self.level = level

    def _active(self) -> List[str]:
        active = [n for n in self.names
                  if self.levels.get(n, 0) <= self.level]
        return active or self.names

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        active = self._active()
        name = active[self.rng.randint(len(active))]
        batch = next(self.iters[name])
        batch["task_name"] = name
        return batch
