"""Optional RDKit backend for the chemistry substrate.

Where RDKit is not installed, `markushgrapher_torch.chem.mol` provides
pure-Python equivalents. When RDKit *is* importable (production images), the
functions here give the reference's exact behavior (utils_markush.py,
utils_evaluation.py use RDKit for parsing, canonicalization, InChI,
fingerprints). `backend()` reports which engine is active; the high-level
helpers dispatch automatically.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Tuple

logger = logging.getLogger(__name__)

try:
    from rdkit import Chem  # type: ignore
    from rdkit.Chem import DataStructs  # type: ignore

    HAS_RDKIT = True
except Exception:  # pragma: no cover - depends on image
    Chem = None
    HAS_RDKIT = False


def backend() -> str:
    return "rdkit" if HAS_RDKIT else "pure-python"


def canonical_smiles(smiles: str) -> Optional[str]:
    if HAS_RDKIT:
        mol = Chem.MolFromSmiles(smiles, sanitize=True)
        if mol is None:
            return None
        return Chem.MolToSmiles(mol)
    from markushgrapher_torch.chem import mol as mol_lib

    try:
        return mol_lib.canonical_smiles(smiles)
    except Exception:
        return None


def canonical_smiles_with_order(smiles: str) -> Optional[Tuple[str, List[int]]]:
    """Canonical SMILES + atom output order (the reference reads RDKit's
    `_smilesAtomOutputOrder` for m-section remapping, utils_markush.py:52-113)."""
    if HAS_RDKIT:
        mol = Chem.MolFromSmiles(smiles, sanitize=True)
        if mol is None:
            return None
        out = Chem.MolToSmiles(mol)
        order = list(map(int, mol.GetProp("_smilesAtomOutputOrder")
                         .strip("[]").split(",")))
        return out, order
    from markushgrapher_torch.chem import mol as mol_lib

    try:
        return mol_lib.canonical_smiles_with_order(smiles)
    except Exception:
        return None


def is_valid_smiles(smiles: str) -> bool:
    if HAS_RDKIT:
        return Chem.MolFromSmiles(smiles, sanitize=False) is not None
    from markushgrapher_torch.chem import mol as mol_lib

    return mol_lib.is_valid_smiles(smiles)


def inchi(smiles: str) -> Optional[str]:
    """InChI when RDKit is present; canonical SMILES as the stable identifier
    otherwise (self-consistent for GT-vs-prediction equality)."""
    if HAS_RDKIT:
        from rdkit.Chem.inchi import MolToInchi  # type: ignore

        mol = Chem.MolFromSmiles(smiles)
        if mol is None:
            return None
        return MolToInchi(mol)
    return canonical_smiles(smiles)


def inchi_stereo_insensitive(smiles: str) -> Optional[str]:
    """InChI with /SNon (the reference's default comparison mode,
    utils_evaluation.py:1222-1231); pure-Python backend: canonical SMILES of
    the stereo-stripped molecule (same equivalence classes for the
    stereo-insensitive equality test)."""
    if HAS_RDKIT:
        from rdkit.Chem.inchi import MolToInchi  # type: ignore

        mol = Chem.MolFromSmiles(smiles)
        if mol is None:
            return None
        return MolToInchi(mol, options="/SNon")
    try:
        return canonical_smiles(remove_stereo(smiles))
    except Exception:
        return None


def remove_stereo(smiles: str) -> str:
    if HAS_RDKIT:
        mol = Chem.MolFromSmiles(smiles)
        if mol is None:
            return smiles
        Chem.RemoveStereochemistry(mol)
        return Chem.MolToSmiles(mol)
    from markushgrapher_torch.chem import mol as mol_lib

    return mol_lib.remove_stereo(smiles)


def tanimoto(smiles_a: str, smiles_b: str) -> float:
    if HAS_RDKIT:
        ma = Chem.MolFromSmiles(smiles_a)
        mb = Chem.MolFromSmiles(smiles_b)
        if ma is None or mb is None:
            return 0.0
        return DataStructs.FingerprintSimilarity(
            Chem.RDKFingerprint(ma), Chem.RDKFingerprint(mb))
    from markushgrapher_torch.chem import mol as mol_lib

    return mol_lib.tanimoto(smiles_a, smiles_b)
