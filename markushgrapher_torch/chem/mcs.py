"""Maximum common substructure + substructure matching on `chem.mol` graphs.

Pure-Python substitute for the RDKit machinery at the core of the reference's
Markush scoring (DS4SD/MarkushGrapher:markushgrapher/utils/ocsr/utils_evaluation.py):

 - `rdFMCS.FindMCS([a, b], timeout=5)` (:1535, :1712) -> `find_mcs`, a
   connected maximum-common-edge-subgraph search (atoms compared by element,
   bonds by order-or-aromatic — rdFMCS's default AtomCompareElements /
   BondCompareOrder), branch-and-bound with the reference's 5 s timeout
   discipline (best-found-so-far is returned on timeout, like RDKit).
 - `mol.GetSubstructMatches(mcs_query, uniquify=False)` (:1730-1733) ->
   `substruct_matches`, a VF2-style monomorphism enumerator returning ALL
   embeddings (including automorphic permutations), each as a tuple
   `match[k] = host atom index of pattern atom k`.

Fast paths: equal canonical SMILES -> identity-size MCS without search, and
a one-sided embedding check (one fragment contained in the other) before the
general search.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from markushgrapher_torch.chem.mol import Mol

BondClass = object  # int order or the string "ar"


def _bond_class(order: int, aromatic: bool) -> BondClass:
    return "ar" if aromatic else order


def _atom_label(mol: Mol, i: int) -> str:
    # element-only comparison; '*' (R-group placeholder) only matches '*'
    return mol.atoms[i].symbol


@dataclass
class Pattern:
    """A labeled subgraph usable as a substructure query."""
    labels: List[str]
    bonds: List[Tuple[int, int, BondClass]]

    def adjacency(self) -> Dict[int, List[Tuple[int, BondClass]]]:
        adj: Dict[int, List[Tuple[int, BondClass]]] = {
            i: [] for i in range(len(self.labels))}
        for a, b, c in self.bonds:
            adj[a].append((b, c))
            adj[b].append((a, c))
        return adj


@dataclass
class MCSResult:
    num_atoms: int
    num_bonds: int
    pattern: Optional[Pattern]          # None when no common atom exists
    # atom index lists into the two input graphs, aligned with pattern atoms
    atoms_a: List[int]
    atoms_b: List[int]
    canceled: bool = False              # timeout hit (best-so-far returned)


def _graph(mol: Mol):
    labels = [_atom_label(mol, i) for i in range(mol.num_atoms())]
    adj: Dict[int, Dict[int, BondClass]] = {i: {} for i in range(len(labels))}
    for b in mol.bonds:
        c = _bond_class(b.order, b.aromatic)
        adj[b.a][b.b] = c
        adj[b.b][b.a] = c
    return labels, adj


def _pattern_from_mapping(la, adj_a, lb, adj_b,
                          mapping: Dict[int, int]) -> MCSResult:
    atoms_a = sorted(mapping)
    index_of = {a: k for k, a in enumerate(atoms_a)}
    bonds: List[Tuple[int, int, BondClass]] = []
    for a in atoms_a:
        for a2, c in adj_a[a].items():
            if a2 in mapping and a < a2 and \
                    adj_b[mapping[a]].get(mapping[a2]) == c:
                bonds.append((index_of[a], index_of[a2], c))
    return MCSResult(
        num_atoms=len(atoms_a), num_bonds=len(bonds),
        pattern=Pattern(labels=[la[a] for a in atoms_a], bonds=bonds),
        atoms_a=atoms_a, atoms_b=[mapping[a] for a in atoms_a])


def find_mcs(mol_a: Mol, mol_b: Mol, timeout: float = 5.0) -> MCSResult:
    """Connected maximum common edge subgraph of two molecule graphs.

    Maximizes matched-bond count, then atom count (rdFMCS's
    maximizeBonds=True default). Returns the best mapping found within
    `timeout` seconds."""
    la, adj_a = _graph(mol_a)
    lb, adj_b = _graph(mol_b)
    na, nb = len(la), len(lb)
    if na == 0 or nb == 0 or not (set(la) & set(lb)):
        return MCSResult(0, 0, None, [], [])

    deadline = time.monotonic() + timeout

    # fast path: identical graphs via full embedding (try the smaller as the
    # pattern inside the larger; covers exact matches and sub/superset
    # predictions, the dominant benchmark cases)
    small_is_a = na <= nb
    small = mol_a if small_is_a else mol_b
    host = mol_b if small_is_a else mol_a
    ls, adj_s = (la, adj_a) if small_is_a else (lb, adj_b)
    full_pat = Pattern(
        labels=ls,
        bonds=[(b.a, b.b, _bond_class(b.order, b.aromatic))
               for b in small.bonds])
    if len(small.fragments()) == 1:  # connected-MCS contract
        emb = substruct_matches(host, full_pat, max_matches=1,
                                deadline=deadline)
        if emb:
            mapping = ({i: emb[0][i] for i in range(len(ls))} if small_is_a
                       else {emb[0][i]: i for i in range(len(ls))})
            return _pattern_from_mapping(la, adj_a, lb, adj_b, mapping)

    best: Dict[str, object] = {"bonds": -1, "atoms": 0, "map": {}}
    total_bonds_a = len(mol_a.bonds)
    total_bonds_b = len(mol_b.bonds)
    canceled = [False]

    def grow(mapping: Dict[int, int], used_b: set, bonds: int,
             frontier: List[Tuple[int, int]], banned: set) -> None:
        if time.monotonic() > deadline:
            canceled[0] = True
            return
        if (bonds, len(mapping)) > (best["bonds"], best["atoms"]):
            best["bonds"], best["atoms"] = bonds, len(mapping)
            best["map"] = dict(mapping)
        # bound: the common subgraph can never exceed the smaller bond count
        if min(total_bonds_a, total_bonds_b) <= best["bonds"]:
            return  # already found a perfect-size mapping
        # candidate pairs adjacent to the mapped core
        cands: List[Tuple[int, int, int]] = []  # (-new_bonds, a, b)
        seen_pairs = set()
        for a0, b0 in mapping.items():
            for a, ca in adj_a[a0].items():
                if a in mapping:
                    continue
                for b, cb in adj_b[b0].items():
                    if b in used_b or ca != cb or la[a] != lb[b]:
                        continue
                    if (a, b) in seen_pairs or (a, b) in banned:
                        continue
                    seen_pairs.add((a, b))
                    nbonds = sum(
                        1 for a2, c2 in adj_a[a].items()
                        if a2 in mapping and adj_b[b].get(mapping[a2]) == c2)
                    cands.append((-nbonds, a, b))
        if not cands:
            return
        cands.sort()
        local_banned = set(banned)
        for negb, a, b in cands:
            if (a, b) in local_banned:
                continue
            mapping[a] = b
            used_b.add(b)
            grow(mapping, used_b, bonds - negb, frontier, local_banned)
            del mapping[a]
            used_b.discard(b)
            # exclude this pair in sibling branches (standard B&B split)
            local_banned.add((a, b))
            if time.monotonic() > deadline:
                canceled[0] = True
                return

    # seed with the rarest-label atom pairs first
    from collections import Counter

    count_b = Counter(lb)
    seeds = sorted(range(na), key=lambda a: count_b.get(la[a], 0))
    tried_seed_labels = Counter()
    for a0 in seeds:
        if time.monotonic() > deadline:
            canceled[0] = True
            break
        # one seed per (label, degree-class) is enough for connected MCS
        key = (la[a0], len(adj_a[a0]))
        tried_seed_labels[key] += 1
        if tried_seed_labels[key] > 4:
            continue
        for b0 in range(nb):
            if lb[b0] != la[a0]:
                continue
            grow({a0: b0}, {b0}, 0, [], set())
            if time.monotonic() > deadline:
                canceled[0] = True
                break

    if not best["map"]:
        return MCSResult(0, 0, None, [], [], canceled=canceled[0])
    res = _pattern_from_mapping(la, adj_a, lb, adj_b, best["map"])
    res.canceled = canceled[0]
    return res


def substruct_matches(host: Mol, pattern: Pattern, uniquify: bool = False,
                      max_matches: int = 2000,
                      deadline: Optional[float] = None,
                      ) -> List[Tuple[int, ...]]:
    """All embeddings of `pattern` into `host` (monomorphism: every pattern
    bond must exist in the host with the same class; the host may have extra
    bonds — RDKit GetSubstructMatches semantics). uniquify=False returns all
    distinct index tuples including automorphic permutations (:1730-1733);
    uniquify=True collapses matches covering the same atom set."""
    hl, hadj = _graph(host)
    np_ = len(pattern.labels)
    if np_ == 0:
        return []
    padj = pattern.adjacency()

    # VF2 ordering: BFS from the most-constrained pattern atom so each new
    # atom (after the first) is adjacent to an already-placed one
    start = max(range(np_), key=lambda i: (len(padj[i]),))
    order: List[int] = [start]
    placed = {start}
    while len(order) < np_:
        nxt = None
        for i in order:
            for j, _ in padj[i]:
                if j not in placed:
                    nxt = j
                    break
            if nxt is not None:
                break
        if nxt is None:  # disconnected pattern: start a new component
            nxt = next(i for i in range(np_) if i not in placed)
        placed.add(nxt)
        order.append(nxt)

    matches: List[Tuple[int, ...]] = []
    seen_sets = set()
    assign: Dict[int, int] = {}
    used = set()

    def backtrack(k: int) -> bool:
        if deadline is not None and time.monotonic() > deadline:
            return True
        if k == np_:
            tup = tuple(assign[i] for i in range(np_))
            if uniquify:
                key = frozenset(tup)
                if key in seen_sets:
                    return False
                seen_sets.add(key)
            matches.append(tup)
            return len(matches) >= max_matches
        p = order[k]
        anchors = [(j, c) for j, c in padj[p] if j in assign]
        if anchors:
            j0, c0 = anchors[0]
            candidates = [h for h, c in hadj[assign[j0]].items() if c == c0]
        else:
            candidates = range(len(hl))
        for h in candidates:
            if h in used or hl[h] != pattern.labels[p]:
                continue
            if any(hadj[h].get(assign[j]) != c for j, c in anchors):
                continue
            assign[p] = h
            used.add(h)
            if backtrack(k + 1):
                return True
            del assign[p]
            used.discard(h)
        return False

    backtrack(0)
    return matches
