"""Domain (SMILES/CXSMILES) token inventories.

The reference ships per-dataset token inventories as JSON files
(DS4SD/MarkushGrapher:data/vocabulary/*.json; selection logic in
markush_tokenizer.py:160-235). This framework generates an equivalent default
inventory programmatically — covering the SMILES organic subset, aromatic
atoms, common bracket atoms (charges, stereo, isotopes), bonds, ring-closure
digits and branch symbols — and can additionally ingest a user-supplied JSON
inventory in the same `{token: index}` format (e.g. one extracted from a
training corpus).
"""

from __future__ import annotations

import json
from typing import Dict, List, Sequence, Tuple

ORGANIC_ATOMS = ["B", "Br", "C", "Cl", "F", "I", "N", "O", "P", "S"]
AROMATIC_ATOMS = ["b", "c", "n", "o", "s", "p"]

# Elements that commonly appear in bracket atoms in patent chemistry corpora.
BRACKET_ELEMENTS = [
    "H", "B", "C", "N", "O", "F", "Si", "P", "S", "Cl", "Se", "Br", "I",
    "Li", "Na", "K", "Mg", "Ca", "Zn", "Fe", "Cu", "Sn", "Al", "As", "Te",
]
AROMATIC_BRACKET = ["c", "n", "o", "s", "se", "te", "b", "p"]

BONDS = ["-", "=", "#", ":", "/", "\\", "~", ".", "$"]
STRUCTURAL = ["(", ")", "%10", "%11", "%12", "%13", "%14", "%15"] + [str(d) for d in range(10)]
WILDCARDS = ["*", "[*]"]


def _bracket_variants() -> List[str]:
    out: List[str] = []
    for el in BRACKET_ELEMENTS:
        out.append(f"[{el}]")
        for h in ["H", "H2", "H3"]:
            out.append(f"[{el}{h}]")
        for q in ["+", "-", "+2", "-2", "2+", "2-"]:
            out.append(f"[{el}{q}]")
            out.append(f"[{el}H{q}]")
        for st in ["@", "@@"]:
            out.append(f"[{el}{st}]")
            out.append(f"[{el}{st}H]")
    for el in AROMATIC_BRACKET:
        out.append(f"[{el}]")
        out.append(f"[{el}H]")
        out.append(f"[{el}+]")
        out.append(f"[{el}-]")
    # deuterium/tritium and a few common isotopes
    out.extend(["[2H]", "[3H]", "[13C]", "[13CH]", "[13CH2]", "[13CH3]", "[14C]",
                "[15N]", "[18F]", "[nH]"])
    return out


def default_smiles_vocab() -> Dict[str, int]:
    """Default token inventory (analog of the reference's `ocsr_3.json`)."""
    tokens: List[str] = []
    seen = set()

    def add(ts: Sequence[str]) -> None:
        for t in ts:
            if t not in seen:
                seen.add(t)
                tokens.append(t)

    add(sorted(set(
        ORGANIC_ATOMS + AROMATIC_ATOMS + BONDS + STRUCTURAL + WILDCARDS
        + _bracket_variants()
    )))
    return {t: i for i, t in enumerate(tokens)}


def default_atom_vocab() -> Dict[str, int]:
    """Atom-only inventory (analog of `ocsr_vocab_atoms.json`): the subset of
    tokens that denote atoms — used to decide which tokens carry `<loc>` /
    `<i>` annotations (markush_tokenizer.py:325-343,410-418)."""
    from markushgrapher_torch.chem.smiles_tokenize import is_atom_token

    full = default_smiles_vocab()
    atoms = [t for t in full if is_atom_token(t)]
    return {t: i for i, t in enumerate(atoms)}


def load_vocab_json(path: str) -> Dict[str, int]:
    with open(path) as f:
        return json.load(f)


def vocab_from_corpus(smiles_list: Sequence[str]) -> Tuple[Dict[str, int], Dict[str, int]]:
    """Build (full, atoms) inventories from a corpus of (CX)SMILES strings —
    the recommended path for training parity with a specific dataset."""
    from markushgrapher_torch.chem.smiles_tokenize import atomwise_tokenizer, is_atom_token

    toks = set()
    for s in smiles_list:
        body = s.split("|")[0].split("!")[0]
        toks.update(atomwise_tokenizer(body))
    ordered = sorted(toks)
    full = {t: i for i, t in enumerate(ordered)}
    atoms = {t: i for i, t in enumerate([t for t in ordered if is_atom_token(t)])}
    return full, atoms
