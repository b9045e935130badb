"""Abbreviation expansion: replace labeled `*` atoms whose label is a known
chemical abbreviation (iPr, CO2H, OMe, ...) with the corresponding fragment,
by graph surgery on the molecular graph.

Equivalent of the reference's `Abbreviation` class
(DS4SD/MarkushGrapher:markushgrapher/utils/ocsr/abbreviation.py:14-334, which does
RWMol surgery with Og-marker atoms) re-done on this framework's pure-Python
Mol. The default table covers the common abbreviations; a JSON file in the
same `{label: smiles}` format (e.g. markushgenerator's abbreviations_2.json)
can be loaded on top.
"""

from __future__ import annotations

import json
from typing import Dict, Optional

from markushgrapher_torch.chem.cxsmiles import CXSmiles, parse_cxsmiles
from markushgrapher_torch.chem.mol import Mol, parse_smiles, to_smiles

# default abbreviation -> SMILES (attachment implicit at first atom)
DEFAULT_ABBREVIATIONS: Dict[str, str] = {
    "Me": "C",
    "Et": "CC",
    "Pr": "CCC",
    "nPr": "CCC",
    "iPr": "C(C)C",
    "Bu": "CCCC",
    "nBu": "CCCC",
    "iBu": "CC(C)C",
    "tBu": "C(C)(C)C",
    "Ph": "c1ccccc1",
    "Bn": "Cc1ccccc1",
    "Bz": "C(=O)c1ccccc1",
    "Ac": "C(C)=O",
    "OMe": "OC",
    "OEt": "OCC",
    "OAc": "OC(C)=O",
    "OH": "O",
    "NH2": "N",
    "NO2": "[N+](=O)[O-]",
    "CN": "C#N",
    "CF3": "C(F)(F)F",
    "CCl3": "C(Cl)(Cl)Cl",
    "CO2H": "C(=O)O",
    "COOH": "C(=O)O",
    "CO2Me": "C(=O)OC",
    "CO2Et": "C(=O)OCC",
    "CHO": "C=O",
    "SO2": "S(=O)=O",
    "SO3H": "S(=O)(=O)O",
    "SMe": "SC",
    "NMe2": "N(C)C",
    "NHMe": "NC",
    "Ms": "S(C)(=O)=O",
    "Ts": "S(=O)(=O)c1ccc(C)cc1",
    "Boc": "C(=O)OC(C)(C)C",
    "Cbz": "C(=O)OCc1ccccc1",
}


class Abbreviation:
    def __init__(self, table: Optional[Dict[str, str]] = None,
                 json_path: Optional[str] = None):
        self.table = dict(DEFAULT_ABBREVIATIONS)
        if table:
            self.table.update(table)
        if json_path:
            with open(json_path) as f:
                self.table.update(json.load(f))

    def known(self, label: str) -> bool:
        return label in self.table

    def expand_cxsmiles(self, cxsmiles: str) -> str:
        """Expand every `*` atom whose `$` label is a known abbreviation;
        unknown labels (true R-groups) are kept."""
        try:
            cx = parse_cxsmiles(cxsmiles)
            mol = parse_smiles(cx.smiles)
        except Exception:
            return cxsmiles

        to_expand = [(i, lbl) for i, lbl in enumerate(cx.labels)
                     if lbl and self.known(lbl)
                     and i < mol.num_atoms() and mol.atoms[i].symbol == "*"]
        if not to_expand:
            return cxsmiles

        # index bookkeeping: splice fragments one at a time, tracking how the
        # original indices move (appended fragment atoms go to the tail)
        index_map = list(range(mol.num_atoms()))
        for star_idx, label in to_expand:
            cur = index_map[star_idx]
            frag = parse_smiles(self.table[label])
            mol = _splice(mol, cur, frag)
            # after _splice: atom `cur` removed, atoms > cur shift down by 1,
            # fragment atoms appended at the end (first frag atom = bond target)
            for orig, now in enumerate(index_map):
                if now > cur:
                    index_map[orig] = now - 1
                elif now == cur and orig != star_idx:
                    index_map[orig] = -1
            index_map[star_idx] = -1  # expanded away

        new_labels = [""] * mol.num_atoms()
        for orig, lbl in enumerate(cx.labels):
            now = index_map[orig] if orig < len(index_map) else -1
            if lbl and now >= 0:
                new_labels[now] = lbl
        new_m = []
        for m in cx.m_sections:
            anchor = index_map[m.anchor] if m.anchor < len(index_map) else -1
            targets = [index_map[t] for t in m.targets
                       if t < len(index_map) and index_map[t] >= 0]
            if anchor >= 0 and targets:
                m.anchor, m.targets = anchor, targets
                new_m.append(m)
        new_sg = []
        for s in cx.sg_sections:
            atoms = [index_map[a] for a in s.atoms
                     if a < len(index_map) and index_map[a] >= 0]
            if atoms:
                s.atoms = atoms
                new_sg.append(s)

        smiles, order = to_smiles(mol)
        old_to_new = {old: new for new, old in enumerate(order)}
        remapped_labels = [""] * mol.num_atoms()
        for i, lbl in enumerate(new_labels):
            if lbl:
                remapped_labels[old_to_new[i]] = lbl
        for m in new_m:
            m.anchor = old_to_new[m.anchor]
            m.targets = sorted(old_to_new[t] for t in m.targets)
        for s in new_sg:
            s.atoms = sorted(old_to_new[a] for a in s.atoms)
        return CXSmiles(smiles=smiles, labels=remapped_labels,
                        m_sections=new_m, sg_sections=new_sg).render()


def _splice(mol: Mol, star_idx: int, frag: Mol) -> Mol:
    """Remove atom `star_idx`, append `frag`, bond the star's neighbors to the
    fragment's first atom. Returns a new Mol; original indices > star_idx
    shift down by one, fragment indices start at (num_atoms - 1)."""
    new = Mol()
    remap = {}
    for i, atom in enumerate(mol.atoms):
        if i == star_idx:
            continue
        remap[i] = new.add_atom(atom)
    frag_base = new.num_atoms()
    for atom in frag.atoms:
        new.add_atom(atom)
    for bond in mol.bonds:
        if bond.a == star_idx:
            new.add_bond(remap[bond.b], frag_base, bond.order, bond.aromatic)
        elif bond.b == star_idx:
            new.add_bond(remap[bond.a], frag_base, bond.order, bond.aromatic)
        else:
            new.add_bond(remap[bond.a], remap[bond.b], bond.order,
                         bond.aromatic, bond.stereo)
    for bond in frag.bonds:
        new.add_bond(frag_base + bond.a, frag_base + bond.b, bond.order,
                     bond.aromatic, bond.stereo)
    return new


def fix_cxsmiles(cxsmiles: str, abbreviation: Optional[Abbreviation] = None
                 ) -> str:
    """Abbreviation expansion + `<eom>` -> `_AP` attachment-point marker
    (utils_evaluation.py fix_cxsmiles:42-52)."""
    cxsmiles = cxsmiles.replace("<eom>", "_AP")
    return (abbreviation or Abbreviation()).expand_cxsmiles(cxsmiles)
