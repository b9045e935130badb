#!/usr/bin/env python
"""Normalize a hub/local HF dataset to the canonical sample schema (the
port's copy of the JAX package's `scripts/prepare_hf_dataset.py`).

Equivalent of the reference's scripts/dataset/prepare_hf_dataset.py:25-81:
ensure id/page_image/cells/cxsmiles* columns exist and synthesize
`annotation` = <cxsmi>{cxsmiles_opt}</cxsmi> when missing.

Usage: python -m markushgrapher_torch.scripts.prepare_hf_dataset <source_path_or_hub_id> <output_dir>
"""

from __future__ import annotations

import os
import sys


def load_source_dataset(source: str):
    import datasets as hfds

    if os.path.isdir(source):
        return hfds.load_from_disk(source)
    return hfds.load_dataset(source)


def normalize_dataset(ds):
    import datasets as hfds

    if not hasattr(ds, "keys"):
        ds = hfds.DatasetDict(test=ds)

    def fix(sample, idx):
        out = {}
        if "id" not in sample or sample["id"] is None:
            out["id"] = idx
        if not sample.get("cells"):
            out["cells"] = []
        cxopt = sample.get("cxsmiles_opt") or sample.get("cxsmiles") or ""
        if not sample.get("cxsmiles_opt"):
            out["cxsmiles_opt"] = cxopt
        if not sample.get("annotation"):
            out["annotation"] = (
                f"<markush><cxsmi>{cxopt}</cxsmi><stable></stable></markush>"
                if cxopt else "")
        return out

    return hfds.DatasetDict({
        split: d.map(fix, with_indices=True) for split, d in ds.items()})


def main(source: str, output_dir: str) -> None:
    ds = normalize_dataset(load_source_dataset(source))
    ds.save_to_disk(output_dir)
    print(f"normalized dataset written to {output_dir}: "
          f"{ {k: len(v) for k, v in ds.items()} }")


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
