"""Reference vocabulary-inventory importer.

The reference ships 12 per-dataset SMILES/CXSMILES token inventories as JSON
files (`data/vocabulary/*.json`) and selects among them by
`training_dataset_name` (DS4SD/MarkushGrapher:markushgrapher/core/common/
markush_tokenizer.py:160-235 `select_vocab_files`). The `<other_N>` id of
every domain token is its position in [base markers] + [inventory keys in
file order] (`set_vocabulary`, :237-285) — so running published checkpoints
requires importing the *actual* shipped files with the *actual* dispatch.

This module reproduces that selection and ordering against any vocabulary
directory. The directory is located by, in order: an explicit argument,
`$MARKUSHGRAPHER_VOCAB_DIR`, the vendored snapshot shipped with this package
(`vendor/vocabulary/`, golden-tested byte-equal to the reference's files —
see `vendor/README.md`).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

_VENDORED_VOCAB_DIR = os.path.join(os.path.dirname(__file__), "vendor",
                                   "vocabulary")


def find_vocab_dir(vocab_dir: Optional[str] = None) -> Optional[str]:
    for cand in (vocab_dir, os.environ.get("MARKUSHGRAPHER_VOCAB_DIR"),
                 _VENDORED_VOCAB_DIR):
        if cand and os.path.isdir(cand):
            return cand
    return None


def select_vocab_files(
    training_dataset_name: str,
    encode_position: bool = False,
    grounded_smiles: bool = False,
) -> Tuple[List[str], str]:
    """File-name dispatch, mirroring reference `select_vocab_files`
    (markush_tokenizer.py:160-235). Returns (vocabulary_files, atom_file)."""
    name = training_dataset_name
    if name in ("ocxsr_12", "ocxsr_17", "ocxsr_19"):
        return ["ocxsr_12.json"], "ocxsr_12_atoms.json"
    if name in ("ocsr_3", "ocsr_test"):
        if encode_position and grounded_smiles:
            return ["ocsr_3_mol.json"], "ocsr_3_atoms.json"
        return ["ocsr_3.json"], "ocsr_vocab_atoms.json"
    if name == "ocsr_2":
        return (
            ["ocsr_vocab_atoms.json", "ocsr_vocab_bonds.json", "ocsr_vocab_chars.json"],
            "ocsr_vocab_atoms.json",
        )
    if name in ("ocxsr_2", "ocxsr_m_2", "ocxsr_11", "ocxsr_test"):
        return ["ocxsr_2.json"], "ocxsr_2_atoms.json"
    # default (mdu*)
    return ["ocsr_3.json"], "ocsr_vocab_atoms.json"


def load_reference_vocabulary(
    training_dataset_name: str,
    vocab_dir: Optional[str] = None,
    encode_position: bool = False,
    grounded_smiles: bool = False,
) -> Tuple[Dict[str, int], Dict[str, int]]:
    """Load (full inventory, atom inventory) for a dataset name.

    Key order of the returned dicts IS the `<other_N>` assignment order
    (after the base markers) — json.load preserves file order.
    """
    d = find_vocab_dir(vocab_dir)
    if d is None:
        raise FileNotFoundError(
            "no vocabulary directory found (set MARKUSHGRAPHER_VOCAB_DIR or pass vocab_dir)"
        )
    files, atom_file = select_vocab_files(
        training_dataset_name, encode_position, grounded_smiles
    )
    full: Dict[str, int] = {}
    for fn in files:
        with open(os.path.join(d, fn)) as f:
            for k in json.load(f):
                # The reference extends a LIST without dedup (set_vocabulary,
                # markush_tokenizer.py:276-281): a duplicate key would consume
                # an id slot and shift every subsequent <other_N> vs the
                # published checkpoint. Dict-keyed inventories can't represent
                # that, so fail loudly instead of silently re-indexing.
                if k in full:
                    raise ValueError(
                        f"duplicate vocabulary key {k!r} in {fn} (files={files}): "
                        "reference id assignment would diverge from this importer"
                    )
                full[k] = len(full)
    with open(os.path.join(d, atom_file)) as f:
        atoms = {k: i for i, k in enumerate(json.load(f))}
    return full, atoms


def base_markers(
    training_dataset_name: str,
    substituents_separator: str,
    rtable_item_separator: str = "<ns>",
    encode_index: bool = False,
) -> List[str]:
    """Base structural markers preceding the inventory in `<other_N>` space
    (reference set_vocabulary, markush_tokenizer.py:240-274)."""
    vocab: List[str] = []
    if "ocsr" in training_dataset_name:
        vocab.extend(["<smi>", "</smi>"])
    elif "mdu_2002" in training_dataset_name:
        vocab.extend(["<cxsmi>", "</cxsmi>"])
    else:
        vocab.extend(["<cxsmi>", "</cxsmi>", "<r>", "</r>"])
        vocab.extend([
            "<markush>", "</markush>", "<stable>", "</stable>",
            substituents_separator, rtable_item_separator,
        ])
    if encode_index:
        vocab.extend(["<i>", "</i>"])
    return vocab


def substituents_separator_for(training_dataset_name: str) -> str:
    """`,` for mdu_300, `<n>` otherwise (markush_tokenizer.py:21-26)."""
    return "," if training_dataset_name == "mdu_300" else "<n>"
