"""Minimal molecular graph: SMILES parser, writer, canonicalization,
fingerprints.

The reference delegates all chemistry to RDKit (C++). Where RDKit is not
installed, this module provides a self-contained pure-Python substrate
with the operations the evaluation suite needs:

 - SMILES -> graph (`parse_smiles`): organic subset, aromatic atoms, bracket
   atoms (isotope/charge/H-count/stereo tags/atom maps), ring closures incl.
   %NN, branches, dot-separated fragments, wildcards;
 - graph -> canonical SMILES (`to_smiles`): Morgan-style iterative
   refinement ranking with deterministic tie-breaking, returning the atom
   output order (needed to remap CXSMILES `m:` indices the way the reference
   does with RDKit's `_smilesAtomOutputOrder`, utils_markush.py:52-113);
 - ECFP-like hashed circular fingerprints + Tanimoto.

When RDKit *is* importable it is preferred by higher layers (chem.rdkit_compat);
equality metrics only require self-consistency, which this module guarantees.
"""

from __future__ import annotations

import hashlib
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

ORGANIC_SUBSET = {"B", "C", "N", "O", "P", "S", "F", "Cl", "Br", "I", "*"}
AROMATIC_ORGANIC = {"b", "c", "n", "o", "p", "s"}

# normal valences for implicit-H assignment (SMILES spec)
VALENCES = {"B": (3,), "C": (4,), "N": (3, 5), "O": (2,), "P": (3, 5),
            "S": (2, 4, 6), "F": (1,), "Cl": (1,), "Br": (1,), "I": (1,)}

ELEMENTS = set("""H He Li Be B C N O F Ne Na Mg Al Si P S Cl Ar K Ca Sc Ti V
Cr Mn Fe Co Ni Cu Zn Ga Ge As Se Br Kr Rb Sr Y Zr Nb Mo Tc Ru Rh Pd Ag Cd In
Sn Sb Te I Xe Cs Ba La Ce Pr Nd Pm Sm Eu Gd Tb Dy Ho Er Tm Yb Lu Hf Ta W Re
Os Ir Pt Au Hg Tl Pb Bi Po At Rn Fr Ra Ac Th Pa U Np Pu Am Cm Bk Cf Es Fm Md
No Lr Rf Db Sg Bh Hs Mt Ds Rg Cn Nh Fl Mc Lv Ts Og""".split())
AROMATIC_BRACKET_OK = {"b", "c", "n", "o", "p", "s", "se", "as", "te", "si"}


@dataclass
class Atom:
    symbol: str                 # element symbol, capitalized ("C", "Cl", "*")
    aromatic: bool = False
    charge: int = 0
    isotope: int = 0
    explicit_h: Optional[int] = None  # None = implicit by valence
    atom_map: int = 0
    chirality: str = ""        # "@", "@@" or ""
    bracket: bool = False       # was written as bracket atom


@dataclass
class Bond:
    a: int
    b: int
    order: int = 1              # 1,2,3; aromatic bonds order=1 + aromatic flag
    aromatic: bool = False
    stereo: str = ""           # "/" or "\\" as written on the bond


class Mol:
    def __init__(self):
        self.atoms: List[Atom] = []
        self.bonds: List[Bond] = []
        self._adj: Dict[int, List[int]] = {}

    def add_atom(self, atom: Atom) -> int:
        self.atoms.append(atom)
        self._adj[len(self.atoms) - 1] = []
        return len(self.atoms) - 1

    def add_bond(self, a: int, b: int, order: int = 1, aromatic: bool = False,
                 stereo: str = "") -> None:
        if a == b:
            raise ValueError("self-bond")
        self.bonds.append(Bond(a, b, order, aromatic, stereo))
        self._adj[a].append(len(self.bonds) - 1)
        self._adj[b].append(len(self.bonds) - 1)

    def neighbors(self, i: int) -> List[Tuple[int, Bond]]:
        out = []
        for bi in self._adj[i]:
            bond = self.bonds[bi]
            out.append((bond.b if bond.a == i else bond.a, bond))
        return out

    def degree(self, i: int) -> int:
        return len(self._adj[i])

    def num_atoms(self) -> int:
        return len(self.atoms)

    def fragments(self) -> List[List[int]]:
        """Connected components (RDKit GetMolFrags equivalent)."""
        seen: Set[int] = set()
        comps = []
        for start in range(len(self.atoms)):
            if start in seen:
                continue
            stack, comp = [start], []
            seen.add(start)
            while stack:
                i = stack.pop()
                comp.append(i)
                for j, _ in self.neighbors(i):
                    if j not in seen:
                        seen.add(j)
                        stack.append(j)
            comps.append(sorted(comp))
        return comps

    def implicit_h(self, i: int) -> int:
        atom = self.atoms[i]
        if atom.explicit_h is not None:
            return atom.explicit_h
        if atom.bracket or atom.symbol == "*":
            return 0
        valences = VALENCES.get(atom.symbol)
        if valences is None:
            return 0
        if atom.aromatic:
            # SMILES convention: bare aromatic atoms carry the Daylight
            # default H counts (pyrrole-type N must be written [nH]).
            deg = self.degree(i)
            if atom.symbol in ("C", "B"):
                return max(0, 3 - deg)
            if atom.symbol in ("N", "P"):
                return max(0, 2 - deg)
            return 0
        bond_sum = 0
        for _, bond in self.neighbors(i):
            bond_sum += 1 if bond.aromatic else bond.order
        for v in valences:
            if bond_sum <= v:
                return v - bond_sum
        return 0


# -- SMILES parsing -----------------------------------------------------------

_BRACKET_RE = re.compile(
    r"^(?P<isotope>\d+)?(?P<symbol>[A-Z][a-z]?|[a-z]{1,2}|\*)"
    r"(?P<chiral>@{1,2}(?:TH[12]|AL[12]|SP[1-3]|TB\d{1,2}|OH\d{1,2})?)?"
    r"(?P<hcount>H\d*)?"
    r"(?P<charge>\+{1,3}|-{1,3}|\+\d+|-\d+)?"
    r"(?::(?P<map>\d+))?$")

_TWO_LETTER = {"Cl", "Br"}


class SmilesParseError(ValueError):
    pass


def parse_smiles(smiles: str) -> Mol:
    mol = Mol()
    prev: List[Optional[int]] = [None]  # branch stack
    pending_bond: Optional[Tuple[int, bool, str]] = None  # (order, aromatic, stereo)
    ring_open: Dict[str, Tuple[int, Optional[Tuple[int, bool, str]]]] = {}

    i = 0
    n = len(smiles)

    def attach(idx: int):
        nonlocal pending_bond
        p = prev[-1]
        if p is not None:
            if pending_bond is None:
                a_arom = mol.atoms[p].aromatic and mol.atoms[idx].aromatic
                mol.add_bond(p, idx, 1, a_arom)
            else:
                order, arom, stereo = pending_bond
                mol.add_bond(p, idx, order, arom, stereo)
        pending_bond = None
        prev[-1] = idx

    def ring_bond(key: str, idx: int):
        nonlocal pending_bond
        if key in ring_open:
            j, saved = ring_open.pop(key)
            spec = pending_bond or saved
            if spec is None:
                arom = mol.atoms[j].aromatic and mol.atoms[idx].aromatic
                mol.add_bond(j, idx, 1, arom)
            else:
                mol.add_bond(j, idx, spec[0], spec[1], spec[2])
            pending_bond = None
        else:
            ring_open[key] = (idx, pending_bond)
            pending_bond = None

    while i < n:
        c = smiles[i]
        if c == "[":
            end = smiles.find("]", i)
            if end < 0:
                raise SmilesParseError(f"unclosed bracket at {i}: {smiles}")
            body = smiles[i + 1:end]
            m = _BRACKET_RE.match(body)
            if not m:
                raise SmilesParseError(f"bad bracket atom [{body}]")
            sym = m.group("symbol")
            aromatic = sym[0].islower() and sym != "*"
            if sym != "*":
                if aromatic and sym not in AROMATIC_BRACKET_OK:
                    raise SmilesParseError(f"unknown aromatic atom [{body}]")
                if not aromatic and sym not in ELEMENTS:
                    raise SmilesParseError(f"unknown element [{body}]")
            hgroup = m.group("hcount")
            hcount = 0
            if hgroup:
                hcount = int(hgroup[1:]) if len(hgroup) > 1 else 1
            chgroup = m.group("charge") or ""
            if chgroup in ("+", "++", "+++"):
                charge = len(chgroup)
            elif chgroup in ("-", "--", "---"):
                charge = -len(chgroup)
            elif chgroup:
                charge = int(chgroup)
            else:
                charge = 0
            idx = mol.add_atom(Atom(
                symbol=sym.capitalize() if aromatic else sym,
                aromatic=aromatic,
                charge=charge,
                isotope=int(m.group("isotope") or 0),
                explicit_h=hcount,
                atom_map=int(m.group("map") or 0),
                chirality=(m.group("chiral") or ""),
                bracket=True))
            attach(idx)
            i = end + 1
        elif c.isalpha() or c == "*":
            if smiles[i:i + 2] in _TWO_LETTER:
                sym, i = smiles[i:i + 2], i + 2
            else:
                sym, i = c, i + 1
            if sym in AROMATIC_ORGANIC:
                idx = mol.add_atom(Atom(symbol=sym.upper(), aromatic=True))
            elif sym in ORGANIC_SUBSET:
                idx = mol.add_atom(Atom(symbol=sym))
            else:
                raise SmilesParseError(f"unknown atom {sym!r} in {smiles}")
            attach(idx)
        elif c in "-=#:/\\~":
            order = {"-": 1, "=": 2, "#": 3, ":": 1, "~": 1, "/": 1, "\\": 1}[c]
            pending_bond = (order, c == ":", c if c in "/\\" else "")
            i += 1
        elif c.isdigit():
            ring_bond(c, prev[-1])
            i += 1
        elif c == "%":
            ring_bond(smiles[i:i + 3], prev[-1])
            i += 3
        elif c == "(":
            prev.append(prev[-1])
            i += 1
        elif c == ")":
            if len(prev) == 1:
                raise SmilesParseError("unbalanced ')'")
            prev.pop()
            i += 1
        elif c == ".":
            prev[-1] = None
            pending_bond = None
            i += 1
        else:
            raise SmilesParseError(f"unexpected char {c!r} at {i} in {smiles}")

    if ring_open:
        raise SmilesParseError(f"unclosed ring bonds {sorted(ring_open)} in {smiles}")
    if len(prev) != 1:
        raise SmilesParseError("unclosed branch")
    return mol


# -- canonical ranking ---------------------------------------------------------

def _initial_invariant(mol: Mol, i: int) -> Tuple:
    a = mol.atoms[i]
    return (mol.degree(i), a.symbol, a.aromatic, a.charge, a.isotope,
            mol.implicit_h(i), a.explicit_h if a.explicit_h is not None else -1)


def canonical_ranks(mol: Mol) -> List[int]:
    """Morgan-style iterative refinement; returns rank per atom (0 = first)."""
    n = mol.num_atoms()
    if n == 0:
        return []
    inv = [_initial_invariant(mol, i) for i in range(n)]
    order = sorted(range(n), key=lambda i: inv[i])
    ranks = [0] * n
    r = 0
    for k, i in enumerate(order):
        if k > 0 and inv[i] != inv[order[k - 1]]:
            r = k
        ranks[i] = r

    for _ in range(n):
        new_inv = []
        for i in range(n):
            nbr = sorted((ranks[j], b.order, b.aromatic)
                         for j, b in mol.neighbors(i))
            new_inv.append((ranks[i], tuple(nbr)))
        order = sorted(range(n), key=lambda i: new_inv[i])
        new_ranks = [0] * n
        r = 0
        for k, i in enumerate(order):
            if k > 0 and new_inv[i] != new_inv[order[k - 1]]:
                r = k
            new_ranks[i] = r
        if new_ranks == ranks:
            break
        ranks = new_ranks

    # break remaining ties deterministically (lowest current rank first)
    while len(set(ranks)) < n:
        counts: Dict[int, List[int]] = {}
        for i, rk in enumerate(ranks):
            counts.setdefault(rk, []).append(i)
        tied_rank = min(rk for rk, idxs in counts.items() if len(idxs) > 1)
        chosen = min(counts[tied_rank])
        ranks = [rk if i != chosen else rk - 1 for i, rk in enumerate(ranks)]
        # re-refine after the tie-break
        for _ in range(n):
            new_inv = []
            for i in range(n):
                nbr = sorted((ranks[j], b.order, b.aromatic)
                             for j, b in mol.neighbors(i))
                new_inv.append((ranks[i], tuple(nbr)))
            order = sorted(range(n), key=lambda i: new_inv[i])
            new_ranks = [0] * n
            r = 0
            for k, i in enumerate(order):
                if k > 0 and new_inv[i] != new_inv[order[k - 1]]:
                    r = k
                new_ranks[i] = r
            if new_ranks == ranks:
                break
            ranks = new_ranks
    return ranks


# -- SMILES writing -------------------------------------------------------------

def _atom_str(mol: Mol, i: int) -> str:
    a = mol.atoms[i]
    sym = a.symbol.lower() if a.aromatic else a.symbol
    # content-based (NOT input-bracket-based) so '[nH]'-parsed and
    # aromatize()-produced atoms write identically
    needs_bracket = (
        a.charge != 0 or a.isotope or a.atom_map or a.chirality
        or (a.symbol not in ORGANIC_SUBSET and sym.upper() not in ORGANIC_SUBSET)
        or (a.explicit_h is not None and a.symbol != "*" and (
            a.explicit_h != _organic_default_h(mol, i))))
    if a.symbol == "*" and not (a.charge or a.isotope or a.atom_map):
        return "*"
    if not needs_bracket:
        return sym
    parts = ["["]
    if a.isotope:
        parts.append(str(a.isotope))
    parts.append(sym)
    if a.chirality:
        parts.append(a.chirality)
    h = a.explicit_h if a.explicit_h is not None else mol.implicit_h(i)
    if h == 1:
        parts.append("H")
    elif h > 1:
        parts.append(f"H{h}")
    if a.charge == 1:
        parts.append("+")
    elif a.charge == -1:
        parts.append("-")
    elif a.charge > 1:
        parts.append(f"+{a.charge}")
    elif a.charge < -1:
        parts.append(str(a.charge))
    if a.atom_map:
        parts.append(f":{a.atom_map}")
    parts.append("]")
    return "".join(parts)


def _organic_default_h(mol: Mol, i: int) -> int:
    saved = mol.atoms[i].explicit_h
    mol.atoms[i].explicit_h = None
    was_bracket = mol.atoms[i].bracket
    mol.atoms[i].bracket = False
    h = mol.implicit_h(i)
    mol.atoms[i].explicit_h = saved
    mol.atoms[i].bracket = was_bracket
    return h


def _bond_str(bond: Bond, a_arom: bool, b_arom: bool) -> str:
    if bond.aromatic or (a_arom and b_arom and bond.order == 1):
        return ""
    return {1: "", 2: "=", 3: "#"}[bond.order]


def to_smiles(mol: Mol, canonical: bool = True
              ) -> Tuple[str, List[int]]:
    """Write SMILES. Returns (smiles, atom_output_order): output_order[k] is
    the input index of the k-th atom written (RDKit _smilesAtomOutputOrder)."""
    n = mol.num_atoms()
    if n == 0:
        return "", []
    ranks = canonical_ranks(mol) if canonical else list(range(n))

    visited: Set[int] = set()
    ring_numbers: Dict[Tuple[int, int], int] = {}
    ring_counter = [0]
    output_order: List[int] = []

    # assign ring-closure digits: find ring bonds via DFS spanning tree
    tree_edges: Set[int] = set()

    def plan(root: int):
        stack = [(root, -1)]
        seen = {root}
        while stack:
            i, parent_bond = stack.pop()
            for j, bond in sorted(mol.neighbors(i), key=lambda t: ranks[t[0]]):
                bi = mol.bonds.index(bond)
                if bi == parent_bond or bi in tree_edges:
                    continue
                if j in seen:
                    continue
                seen.add(j)
                tree_edges.add(bi)
                stack.append((j, bi))

    def write(root: int) -> str:
        out: List[str] = []
        # ring bonds at each atom
        ring_digits: Dict[int, List[Tuple[str, str]]] = {}
        comp_ring_bonds = []
        stack = [(root, -1)]
        seen = {root}
        order_edges: Dict[int, List[Tuple[int, int]]] = {}
        while stack:
            i, pb = stack.pop()
            for j, bond in sorted(mol.neighbors(i), key=lambda t: -ranks[t[0]]):
                bi = mol.bonds.index(bond)
                if bi == pb:
                    continue
                if j in seen:
                    if bi not in [b for b, _ in comp_ring_bonds]:
                        comp_ring_bonds.append((bi, i))
                    continue
                seen.add(j)
                order_edges.setdefault(i, []).insert(0, (j, bi))
                stack.append((j, bi))
        for bi, _ in comp_ring_bonds:
            ring_counter[0] += 1
            num = ring_counter[0]
            digit = str(num) if num < 10 else f"%{num:02d}"
            bond = mol.bonds[bi]
            bstr = _bond_str(bond, mol.atoms[bond.a].aromatic,
                             mol.atoms[bond.b].aromatic)
            ring_digits.setdefault(bond.a, []).append((digit, bstr))
            ring_digits.setdefault(bond.b, []).append((digit, ""))

        def emit(i: int, bond_prefix: str):
            out.append(bond_prefix)
            out.append(_atom_str(mol, i))
            output_order.append(i)
            for digit, bstr in ring_digits.get(i, []):
                out.append(bstr + digit)
            children = order_edges.get(i, [])
            for k, (j, bi) in enumerate(children):
                bond = mol.bonds[bi]
                bstr = _bond_str(bond, mol.atoms[bond.a].aromatic,
                                 mol.atoms[bond.b].aromatic) or bond.stereo
                if k < len(children) - 1:
                    out.append("(")
                    emit(j, bstr)
                    out.append(")")
                else:
                    emit(j, bstr)

        emit(root, "")
        return "".join(out)

    frags = mol.fragments()
    # order fragments by their minimum-rank atom
    frags.sort(key=lambda comp: min(ranks[i] for i in comp))
    parts = []
    for comp in frags:
        root = min(comp, key=lambda i: ranks[i])
        parts.append(write(root))
    return ".".join(parts), output_order


def _small_rings(mol: Mol, max_size: int = 6) -> List[List[int]]:
    """Simple cycles of size 3..max_size (enough for aromaticity perception;
    RDKit uses SSSR). Deduplicated by atom set."""
    rings: List[List[int]] = []
    seen_sets: Set[frozenset] = set()
    n = mol.num_atoms()
    for start in range(n):
        # DFS paths of length <= max_size returning to start
        stack = [(start, [start])]
        while stack:
            cur, path = stack.pop()
            for j, _ in mol.neighbors(cur):
                if j == start and len(path) >= 3:
                    key = frozenset(path)
                    if key not in seen_sets:
                        seen_sets.add(key)
                        rings.append(list(path))
                elif j not in path and len(path) < max_size and j > start:
                    stack.append((j, path + [j]))
    return rings


def aromatize(mol: Mol) -> Mol:
    """Mark aromatic rings written in Kekule form as aromatic, in place.

    The reference sanitizes (aromatizes) every parsed molecule before
    comparison/canonicalization (utils_evaluation.py:1430-1452 'Aromatize
    SMILES to avoid mismatches of kekulization'); without this, a Kekule
    prediction never string-matches an aromatic GT. Covers the dominant
    patterns: 6-rings with perfect single/double alternation (benzene,
    pyridine, fused naphthalene/indole-type) and 5-rings with two double
    bonds plus one lone-pair donor (N/O/S/Se); the donor N keeps its H
    explicitly ([nH], the SMILES convention)."""
    rings = _small_rings(mol)
    bond_index = {}
    for bi, b in enumerate(mol.bonds):
        bond_index[(b.a, b.b)] = bi
        bond_index[(b.b, b.a)] = bi
    changed = True
    while changed:
        changed = False
        for ring in rings:
            size = len(ring)
            if size not in (5, 6):
                continue
            bis = [bond_index[(ring[k], ring[(k + 1) % size])]
                   for k in range(size)]
            if all(mol.bonds[bi].aromatic for bi in bis):
                continue
            if any(mol.bonds[bi].order > 2 for bi in bis):
                continue
            if any(a.symbol not in ("C", "N", "O", "S", "B", "P", "Se")
                   for a in (mol.atoms[i] for i in ring)):
                continue
            # per ring atom: count ring double bonds (aromatic counts as
            # satisfying the alternation on fused systems)
            dbl = {}
            arom_deg = {}
            for k in range(size):
                i = ring[k]
                dbl[i] = sum(1 for bi in bis
                             if mol.bonds[bi].order == 2
                             and i in (mol.bonds[bi].a, mol.bonds[bi].b))
                arom_deg[i] = sum(
                    1 for j, b in mol.neighbors(i)
                    if b.aromatic and j in ring)
            donors = [i for i in ring if dbl[i] == 0 and arom_deg[i] == 0]
            ok = False
            if size == 6:
                ok = all(dbl[i] == 1 or arom_deg[i] > 0 for i in ring)
            elif size == 5:
                if len(donors) == 1 and all(
                        dbl[i] == 1 or arom_deg[i] > 0
                        for i in ring if i != donors[0]):
                    d = mol.atoms[donors[0]]
                    # the donor must have a lone pair and no exocyclic double
                    exo_dbl = any(b.order == 2 for _, b in
                                  mol.neighbors(donors[0]))
                    ok = (d.symbol in ("N", "O", "S", "Se", "P")
                          and not exo_dbl)
            if not ok:
                continue
            for i in donors:
                a = mol.atoms[i]
                if a.symbol in ("N", "P") and a.explicit_h is None:
                    a.explicit_h = mol.implicit_h(i)  # pyrrole-type keeps H
            for i in ring:
                mol.atoms[i].aromatic = True
            for bi in bis:
                mol.bonds[bi].order = 1
                mol.bonds[bi].aromatic = True
            changed = True
    return mol


def canonical_smiles(smiles: str) -> str:
    return to_smiles(aromatize(parse_smiles(smiles)))[0]


def canonical_smiles_with_order(smiles: str) -> Tuple[str, List[int]]:
    return to_smiles(aromatize(parse_smiles(smiles)))


# -- fingerprints -----------------------------------------------------------------

def _hash(data: str) -> int:
    return int.from_bytes(hashlib.md5(data.encode()).digest()[:8], "little")


def morgan_fingerprint(mol: Mol, radius: int = 2, n_bits: int = 2048) -> Set[int]:
    """ECFP-style hashed circular fingerprint (substitute for RDKit's
    RDKFingerprint in the Tanimoto metric, utils_evaluation.py:1230s)."""
    ids = {}
    for i in range(mol.num_atoms()):
        ids[i] = _hash(str(_initial_invariant(mol, i)))
    bits: Set[int] = set()
    bits.update(v % n_bits for v in ids.values())
    for _ in range(radius):
        new_ids = {}
        for i in range(mol.num_atoms()):
            env = sorted((b.order, b.aromatic, ids[j])
                         for j, b in mol.neighbors(i))
            new_ids[i] = _hash(str((ids[i], tuple(env))))
        ids = new_ids
        bits.update(v % n_bits for v in ids.values())
    return bits


def tanimoto(smiles_a: str, smiles_b: str) -> float:
    try:
        fa = morgan_fingerprint(parse_smiles(smiles_a))
        fb = morgan_fingerprint(parse_smiles(smiles_b))
    except SmilesParseError:
        return 0.0
    if not fa and not fb:
        return 1.0
    union = len(fa | fb)
    return len(fa & fb) / union if union else 0.0


def is_valid_smiles(smiles: str) -> bool:
    try:
        parse_smiles(smiles)
        return True
    except (SmilesParseError, Exception):
        return False


def remove_stereo(smiles: str) -> str:
    """Strip stereo annotations (the REMOVE_STEREO eval flag, eval.py:22)."""
    mol = parse_smiles(smiles)
    for a in mol.atoms:
        a.chirality = ""
    for b in mol.bonds:
        b.stereo = ""
    return to_smiles(mol)[0]
