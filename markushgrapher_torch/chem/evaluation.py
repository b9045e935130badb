"""Chemistry-aware evaluation metrics.

Behavioral re-implementation of the reference's evaluation suite
(DS4SD/MarkushGrapher:markushgrapher/utils/ocsr/utils_evaluation.py, 1969 LoC)
on this framework's chemistry substrate. Metric namespace matches the
reference ({benchmark}_ar_{valid,tanimoto,inchi_equality,string_equality,
stable_recall,stable_precision,stable_equality,r,m,sg,cxsmi_equality,
markush_equality,...}, curriculumTrainer.py:744-769) so downstream dashboards
and the `metric_for_best_model` selection port unchanged.

Markush scoring follows the reference algorithm structurally
(compute_markush_prediction_quality, utils_evaluation.py:1366-1969): fragment
decomposition, per-GT-fragment greedy MCS matching with R-label tie filtering
and consumption, fragment-weighted tanimoto/inchi reduction, a gt->pred
atom-index mapping built from all MCS substructure matches, and R/m/Sg
correctness tested THROUGH that mapping. MCS runs on the pure-Python graph
substrate (chem.mcs, 5s timeout like rdFMCS); scalar chemistry (canonical
SMILES, InChI, fingerprints) dispatches through chem.rdkit_compat so
RDKit-present images get reference-exact values. `inchi_equality` matches the
reference's /SNon semantics (stereo-insensitive) on both backends.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

from markushgrapher_torch.chem import cxsmiles as cx_lib
from markushgrapher_torch.chem import mcs as mcs_lib
from markushgrapher_torch.chem import mol as mol_lib
from markushgrapher_torch.chem import rdkit_compat
from markushgrapher_torch.chem.abbreviation import Abbreviation, fix_cxsmiles


def levenshtein(a: str, b: str) -> int:
    try:
        from markushgrapher_torch.utils import native

        d = native.levenshtein(a, b)
        if d is not None:
            return d
    except Exception:
        pass
    if a == b:
        return 0
    if not a:
        return len(b)
    if not b:
        return len(a)
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def get_stable_score(
    gt_stable: Optional[Dict[str, List[str]]],
    predicted_stable: Optional[Dict[str, List[str]]],
    permissive: bool = True,
    normalize: bool = True,
) -> Dict[str, object]:
    """Substituent-table recall/precision/equality with filler-word
    normalization ("aryl" == "an aryl group") — exact semantics of
    utils_evaluation.py:594-733."""
    scores = {"stable_equality": False, "stable_recall": 0.0,
              "stable_precision": 0.0}
    if predicted_stable is None:
        return scores
    gt_stable = gt_stable or {}
    if gt_stable == {}:
        if predicted_stable == {}:
            return {"stable_equality": True, "stable_recall": 1.0,
                    "stable_precision": 1.0}
        return scores

    if normalize:
        new_pred = {}
        for label, preds in predicted_stable.items():
            if label not in gt_stable:
                new_pred[label] = preds
                continue
            norm_gt = [s.replace("a ", "").replace(" group", "")
                       for s in gt_stable[label]]
            fixed = []
            for p in preds:
                if p in gt_stable[label]:
                    fixed.append(p)
                    continue
                norm_p = p.replace("a ", "").replace(" group", "")
                if norm_p in norm_gt:
                    fixed.append(gt_stable[label][norm_gt.index(norm_p)])
                else:
                    fixed.append(p)
            new_pred[label] = fixed
        predicted_stable = new_pred

    if permissive:
        gt_stable = {k.lower(): [e.lower().replace(" ", "") for e in v]
                     for k, v in gt_stable.items()}
        predicted_stable = {k.lower(): [e.lower().replace(" ", "") for e in v]
                            for k, v in predicted_stable.items()}

    gt_found, perfect = [], []
    for label, gts in gt_stable.items():
        if label not in predicted_stable:
            perfect.append(False)
            gt_found.append([False] * len(gts))
            continue
        perfect.append(set(gts) == set(predicted_stable[label]))
        gt_found.append([g in predicted_stable[label] for g in gts])

    pred_found = []
    for label, preds in predicted_stable.items():
        if preds == []:
            continue
        if label not in gt_stable:
            pred_found.append([False] * len(preds))
            continue
        pred_found.append([p in gt_stable[label] for p in preds])

    scores["stable_equality"] = all(perfect) if perfect else False
    scores["stable_recall"] = round(
        _mean([sum(r) / len(r) for r in gt_found]), 3) if gt_found else 0.0
    prec = _mean([sum(r) / len(r) for r in pred_found]) if pred_found else float("nan")
    scores["stable_precision"] = 0.0 if math.isnan(prec) else round(prec, 3)
    return scores


def _mean(xs: Sequence[float]) -> float:
    return sum(xs) / len(xs) if xs else float("nan")


def _ngrams(seq: Sequence[str], n: int):
    return [tuple(seq[i:i + n]) for i in range(len(seq) - n + 1)]


def rouge_n(pred: str, gt: str, n: int) -> float:
    """Char-level ROUGE-N f-measure (reference uses rouge_scorer over
    space-joined chars, utils_evaluation.py:1264-1276)."""
    p, g = list(pred), list(gt)
    pn, gn = _ngrams(p, n), _ngrams(g, n)
    if not pn or not gn:
        return 0.0
    from collections import Counter

    overlap = sum((Counter(pn) & Counter(gn)).values())
    prec = overlap / len(pn)
    rec = overlap / len(gn)
    return 2 * prec * rec / (prec + rec) if prec + rec else 0.0


def rouge_l(pred: str, gt: str) -> float:
    """Char-level ROUGE-L f-measure via LCS."""
    a, b = pred, gt
    if not a or not b:
        return 0.0
    prev = [0] * (len(b) + 1)
    for ca in a:
        cur = [0]
        for j, cb in enumerate(b, 1):
            cur.append(prev[j - 1] + 1 if ca == cb else max(prev[j], cur[-1]))
        prev = cur
    lcs = prev[-1]
    prec, rec = lcs / len(a), lcs / len(b)
    return 2 * prec * rec / (prec + rec) if prec + rec else 0.0


def nlp_metrics(pred: str, gt: str) -> Dict[str, float]:
    """Char-level BLEU (nltk when available) + ROUGE-1/2/3/4/L
    (compute_nlp_metrics block, utils_evaluation.py:1238-1278)."""
    out: Dict[str, float] = {}
    try:
        from nltk.translate.bleu_score import (SmoothingFunction,
                                               sentence_bleu)

        ref, hyp = [list(gt)], list(pred)
        sm = SmoothingFunction().method1
        out["bleu_average"] = sentence_bleu(
            ref, hyp, weights=[0.25] * 4, smoothing_function=sm)
        for i in range(4):
            w = [0.0] * 4
            w[i] = 1.0
            out[f"bleu{i + 1}"] = sentence_bleu(
                ref, hyp, weights=w, smoothing_function=sm)
    except Exception:
        pass
    for n in range(1, 5):
        out[f"rouge{n}"] = rouge_n(pred, gt, n)
    out["rougeL"] = rouge_l(pred, gt)
    return out


def compute_molecule_prediction_quality(
    predicted_smiles: Optional[str],
    gt_smiles: str,
    remove_stereo: bool = False,
    remove_double_bond_stereo: bool = True,
    compute_nlp_metrics: bool = False,
) -> Dict[str, object]:
    """String/InChI/Tanimoto equality for plain molecules
    (utils_evaluation.py:1131-1282). `inchi_equality` follows the reference:
    InChI with /SNon (stereo-insensitive) whenever remove_stereo or
    remove_double_bond_stereo is set — the pure-Python backend compares
    canonical SMILES of the stereo-stripped molecules, the RDKit backend
    real InChI (chem.rdkit_compat)."""
    scores = {
        "levenshtein": len(gt_smiles), "levenshtein0": False,
        "tanimoto": 0.0, "tanimoto1": False,
        "valid": False, "inchi_equality": False, "string_equality": False,
    }
    if predicted_smiles is None or (
            isinstance(predicted_smiles, float) and math.isnan(predicted_smiles)):
        return scores
    if not rdkit_compat.is_valid_smiles(predicted_smiles):
        return scores

    scores["string_equality"] = predicted_smiles == gt_smiles
    if compute_nlp_metrics:
        d = levenshtein(predicted_smiles, gt_smiles)
        scores["levenshtein"] = d
        scores["levenshtein0"] = d == 0
        scores.update(nlp_metrics(predicted_smiles, gt_smiles))

    pred, gt = predicted_smiles, gt_smiles
    if remove_stereo:
        try:
            pred = rdkit_compat.remove_stereo(pred)
            gt = rdkit_compat.remove_stereo(gt)
        except Exception:
            pass
    scores["tanimoto"] = rdkit_compat.tanimoto(gt, pred)
    scores["tanimoto1"] = scores["tanimoto"] == 1.0
    try:
        if remove_stereo or remove_double_bond_stereo:
            gt_id = rdkit_compat.inchi_stereo_insensitive(gt)
            pred_id = rdkit_compat.inchi_stereo_insensitive(pred)
        else:
            gt_id = rdkit_compat.inchi(gt)
            pred_id = rdkit_compat.inchi(pred)
        scores["inchi_equality"] = bool(gt_id) and gt_id == pred_id
    except Exception:
        scores["inchi_equality"] = False
    scores["valid"] = True
    return scores


def _submol(mol: mol_lib.Mol, atom_idxs: Sequence[int]
            ) -> Tuple[mol_lib.Mol, List[int]]:
    """Fragment sub-molecule + new->old index map (MolFragmentToSmiles
    equivalent, utils_evaluation.py:1477-1504)."""
    import copy

    idxs = sorted(atom_idxs)
    old_to_new = {old: new for new, old in enumerate(idxs)}
    sub = mol_lib.Mol()
    for old in idxs:
        sub.add_atom(copy.copy(mol.atoms[old]))
    for b in mol.bonds:
        if b.a in old_to_new and b.b in old_to_new:
            sub.add_bond(old_to_new[b.a], old_to_new[b.b], b.order,
                         b.aromatic, b.stereo)
    return sub, idxs


def _markush_default(gt_cxsmiles: str) -> Dict[str, object]:
    """Reference default_incorrect_score semantics (utils_evaluation.py:
    792-841): r/m/sg are None — excluded from aggregation — when the GT has
    no such feature."""
    info = cx_lib.get_molecule_information(gt_cxsmiles)
    return {
        "valid": False, "valid_cxsmiles": False,
        "string_equality": False,
        "num_fragments_gt": 0, "num_fragments_pred": 0,
        "num_fragments_equal": False, "fragment_count_equality": False,
        "backbone_equality": False, "fragment_similarity": 0.0,
        "backbone_core_tanimoto": 0.0, "backbone_core_tanimoto1": False,
        "backbone_core_inchi_equality": False,
        "backbone_fragments_tanimoto_reduced": 0.0,
        "backbone_fragments_tanimoto1_reduced": False,
        "backbone_fragments_inchi_equality_reduced": False,
        "tanimoto": 0.0, "tanimoto1": False, "inchi_equality": False,
        "r": 0.0 if info["r"] else None,
        "m": 0.0 if info["m"] else None,
        "sg": 0.0 if info["sg"] else None,
        "cxsmi_equality": False,
    }


def compute_markush_prediction_quality(
    predicted_cxsmiles: Optional[str],
    gt_cxsmiles: str,
    remove_stereo: bool = False,
    mcs_timeout: float = 5.0,
) -> Dict[str, object]:
    """Markush (CXSMILES) structural comparison — structural port of the
    reference (utils_evaluation.py:1366-1969):

    1. canonicalize both sides (get_scores does this first, :849-863);
    2. fragment decomposition; core = largest GT fragment (:1470-1515);
    3. per-GT-fragment greedy matching by MCS atom count, with R-label tie
       filtering, smallest-fragment fallback, and consumption (:1520-1665);
    4. per-fragment molecule quality after replace_wildcards; fragment-size-
       weighted tanimoto; all-fragments inchi/tanimoto1 (:1601-1696);
    5. gt->pred atom-index mapping: every MCS substructure match of each
       matched pair, filtered to the fragments' atoms (:1698-1774);
    6. R-label (:1782-1802), m-section (:1804-1881), Sg-section (:1883-1930)
       correctness through the mapping, with consumption;
    7. cxsmi_equality = (r,m,sg each 1.0-or-None) AND inchi AND
       fragment-count (:1957-1964)."""
    scores = _markush_default(gt_cxsmiles)
    if not predicted_cxsmiles:
        return scores
    if not cx_lib.is_valid_cxsmiles(predicted_cxsmiles):
        return scores

    gt_canon = cx_lib.canonicalize_markush(gt_cxsmiles)
    pred_canon = cx_lib.canonicalize_markush(predicted_cxsmiles)
    if gt_canon is None or pred_canon is None:
        return scores
    scores["valid"] = scores["valid_cxsmiles"] = True
    scores["string_equality"] = pred_canon == gt_canon

    gt_cx = cx_lib.parse_cxsmiles(gt_canon)
    pred_cx = cx_lib.parse_cxsmiles(pred_canon)
    try:
        gt_mol = mol_lib.aromatize(mol_lib.parse_smiles(gt_cx.smiles))
        pred_mol = mol_lib.aromatize(mol_lib.parse_smiles(pred_cx.smiles))
    except Exception:
        return scores

    gt_frag_idx = gt_mol.fragments()
    pred_frag_idx = pred_mol.fragments()
    scores["num_fragments_gt"] = len(gt_frag_idx)
    scores["num_fragments_pred"] = len(pred_frag_idx)
    scores["num_fragments_equal"] = len(gt_frag_idx) == len(pred_frag_idx)
    scores["fragment_count_equality"] = scores["num_fragments_equal"]

    gt_frags = [_submol(gt_mol, idxs) for idxs in gt_frag_idx]
    pred_frags = [_submol(pred_mol, idxs) for idxs in pred_frag_idx]

    gt_frag_smi = sorted(mol_lib.to_smiles(f)[0] for f, _ in gt_frags)
    pred_frag_smi = sorted(mol_lib.to_smiles(f)[0] for f, _ in pred_frags)
    scores["backbone_equality"] = gt_frag_smi == pred_frag_smi
    scores["fragment_similarity"] = _fragment_similarity(
        gt_frag_smi, pred_frag_smi)

    gt_rgroups = {i: lbl for i, lbl in enumerate(gt_cx.labels) if lbl}

    core_i = max(range(len(gt_frags)),
                 key=lambda k: gt_frags[k][0].num_atoms())
    core_size = gt_frags[core_i][0].num_atoms()
    side_total = sum(f.num_atoms() for f, _ in gt_frags
                     if f.num_atoms() != core_size)

    # --- greedy per-GT-fragment matching by MCS size (:1520-1665) ---------
    frag_tan: List[float] = []
    frag_tan1: List[bool] = []
    frag_inchi: List[bool] = []
    fragments_mapping: Dict[int, List[Tuple[mol_lib.Mol, List[int]]]] = \
        defaultdict(list)
    current = list(pred_frags)  # (sub_mol, full-mol atom idxs)
    for i_gt, (gfm, gidxs) in enumerate(gt_frags):
        if not current:
            pred_smi = ""
            selected: List[int] = []
        else:
            n_found = [mcs_lib.find_mcs(pfm, gfm, timeout=mcs_timeout
                                        ).num_atoms
                       for pfm, _ in current]
            top = max(n_found)
            selected = [k for k, v in enumerate(n_found) if v == top]
            # R-label tie filter (:1540-1570)
            if len(selected) > 1:
                remove = set()
                for ridx, rlabel in gt_rgroups.items():
                    if ridx not in gidxs:
                        continue
                    for k in selected:
                        matched = any(
                            pred_cx.labels[fi]
                            and pred_cx.labels[fi].lower() == rlabel.lower()
                            for fi in current[k][1]
                            if fi < len(pred_cx.labels))
                        if not matched:
                            remove.add(k)
                kept = [k for k in selected if k not in remove]
                if not kept:  # fallback: smallest fragment (:1572-1585)
                    kept = [min(selected,
                                key=lambda k: len(current[k][1]))]
                selected = kept
            pred_smi = mol_lib.to_smiles(current[selected[0]][0])[0]

        gt_smi = mol_lib.to_smiles(gfm)[0]
        fscore = compute_molecule_prediction_quality(
            replace_wildcards(pred_smi, remove_stereo),
            replace_wildcards(gt_smi, remove_stereo),
            remove_stereo=remove_stereo)
        if gfm.num_atoms() == core_size:
            scores["backbone_core_tanimoto"] = round(fscore["tanimoto"], 3)
            scores["backbone_core_tanimoto1"] = fscore["tanimoto1"]
            scores["backbone_core_inchi_equality"] = fscore["inchi_equality"]
        else:
            frag_tan.append(round(fscore["tanimoto"], 3))
            frag_tan1.append(fscore["tanimoto1"])
            frag_inchi.append(fscore["inchi_equality"])

        for k in selected:
            fragments_mapping[i_gt].append(current[k])
        if len(selected) == 1:
            current = [c for k, c in enumerate(current) if k != selected[0]]

    scores["backbone_fragments_tanimoto_reduced"] = (
        round(_mean(frag_tan), 3) if frag_tan else 0.0)
    scores["backbone_fragments_tanimoto1_reduced"] = all(frag_tan1)
    scores["backbone_fragments_inchi_equality_reduced"] = all(frag_inchi)
    scores["tanimoto"] = round(
        (scores["backbone_fragments_tanimoto_reduced"] * side_total
         + scores["backbone_core_tanimoto"] * core_size)
        / (side_total + core_size), 3)
    scores["tanimoto1"] = (scores["backbone_fragments_tanimoto1_reduced"]
                           and scores["backbone_core_tanimoto1"])
    scores["inchi_equality"] = (
        scores["backbone_fragments_inchi_equality_reduced"]
        and scores["backbone_core_inchi_equality"])

    # --- gt->pred atom-index mapping via MCS substruct matches (:1698-1774)
    gt_to_pred: Dict[int, List[int]] = defaultdict(list)
    for i_gt, (gfm, gidxs) in enumerate(gt_frags):
        gidx_set = set(gidxs)
        for pfm, pidxs in fragments_mapping[i_gt]:
            mcs = mcs_lib.find_mcs(pfm, gfm, timeout=mcs_timeout)
            if mcs.pattern is None:
                continue
            pidx_set = set(pidxs)
            gt_matches = [m for m in mcs_lib.substruct_matches(
                gt_mol, mcs.pattern)
                if all(i in gidx_set for i in m)]
            pred_matches = [m for m in mcs_lib.substruct_matches(
                pred_mol, mcs.pattern)
                if all(i in pidx_set for i in m)]
            for gm in gt_matches:
                for pm in pred_matches:
                    for pi, gi in zip(pm, gm):
                        if pi not in gt_to_pred[gi]:
                            gt_to_pred[gi].append(pi)

    # --- R-label test through the mapping, with consumption (:1782-1802) --
    r_labels: Optional[List[bool]]
    if not gt_rgroups:
        r_labels = None
    else:
        r_labels = []
        mapping_r = {k: list(v) for k, v in gt_to_pred.items()}
        for i, rlabel in gt_rgroups.items():
            correct = False
            for j in mapping_r.get(i, []):
                pl = (pred_cx.labels[j]
                      if j < len(pred_cx.labels) else "")
                if pl and pl.lower() == rlabel.lower():
                    correct = True
                    mapping_r = {k: [x for x in v if x != j]
                                 for k, v in mapping_r.items()}
                    break
            r_labels.append(correct)

    # --- m-section test (:1804-1881) --------------------------------------
    m_sections: Optional[List[bool]]
    if not gt_cx.m_sections:
        m_sections = None
    else:
        m_sections = []
        mapping_m = {k: list(v) for k, v in gt_to_pred.items()}
        for gm in gt_cx.m_sections:
            correct = False
            for pm in pred_cx.m_sections:
                conn_ok = pm.anchor in mapping_m.get(gm.anchor, [])
                rings_ok = all(
                    any(i in pm.targets for i in mapping_m.get(ra, []))
                    for ra in gm.targets if ra in mapping_m)
                if conn_ok and rings_ok:
                    correct = True
                    # consume the connector only: several fragments can
                    # attach to the same ring (:1869-1878)
                    mapping_m = {k: [x for x in v if x != pm.anchor]
                                 for k, v in mapping_m.items()}
                    break
            m_sections.append(correct)

    # --- Sg-section test (:1883-1930) --------------------------------------
    sg_sections: Optional[List[bool]]
    if not gt_cx.sg_sections:
        sg_sections = None
    else:
        sg_sections = []
        mapping_sg = {k: list(v) for k, v in gt_to_pred.items()}
        for gs in gt_cx.sg_sections:
            force_incorrect = any(i not in mapping_sg for i in gs.atoms)
            correct = False
            if not force_incorrect:
                for ps in pred_cx.sg_sections:
                    p_atoms = set(ps.atoms)
                    if (len(p_atoms) == len(gs.atoms)
                            and all(any(p in mapping_sg[g] for p in p_atoms)
                                    for g in gs.atoms)
                            and ps.label == gs.label):
                        correct = True
                        mapping_sg = {
                            k: [x for x in v if x not in p_atoms]
                            for k, v in mapping_sg.items()}
                        break
            sg_sections.append(correct)

    # --- reduce (:1934-1964) ------------------------------------------------
    def _reduce(flags: Optional[List[bool]]) -> Optional[float]:
        if flags is None:
            return None
        if not flags:
            return 0.0
        return round(sum(flags) / len(flags), 3)

    scores["r"] = _reduce(r_labels)
    scores["m"] = _reduce(m_sections)
    scores["sg"] = _reduce(sg_sections)

    scores["cxsmi_equality"] = bool(
        (scores["r"] in (None, 1.0))
        and (scores["m"] in (None, 1.0))
        and (scores["sg"] in (None, 1.0))
        and scores["inchi_equality"]
        and scores["num_fragments_equal"])
    return scores


def replace_wildcards(smiles: str, remove_stereo: bool = False) -> str:
    """Substitute wildcard atoms (`*`) with carbon and re-canonicalize
    (utils_evaluation.py replace_wildcards:1339-1363 — applied to fragment
    SMILES before backbone comparison so attachment points don't block
    matching). Falls back to the input on parse failure, like the reference's
    permissive-parse retries."""
    try:
        mol = mol_lib.parse_smiles(smiles)
    except Exception:
        return smiles
    for atom in mol.atoms:
        if atom.symbol == "*":
            atom.symbol = "C"
            atom.isotope = 0
            atom.bracket = False
            atom.explicit_h = None
    try:
        out = mol_lib.to_smiles(mol)[0]
    except Exception:
        return smiles
    if remove_stereo:
        out = mol_lib.remove_stereo(out)
    return out


def get_smiles_star_raw(
    smiles: str,
    keypoints: Sequence[Sequence[float]] = (),
    atom_symbols: Sequence[str] = (),
    encode_position: bool = False,
    ocr_box_size: int = 80,
) -> str:
    """Build the `smiles!<atom boxes>` target string
    (utils_evaluation.py get_smiles_star_raw:1285-1336). Without
    encode_position this is the `smiles + "![[0,0]]"` form every shipped
    dataset uses; with it, per-atom OCR boxes of side `ocr_box_size` are
    centered on the keypoints (the reference reads symbols from a molblock;
    here they come from `atom_symbols`, same order as `keypoints`)."""
    if not encode_position:
        return smiles + "![[0,0]]"
    boxes = []
    for sym, kp in zip(atom_symbols, keypoints):
        boxes.append(str([kp[0] - ocr_box_size / 2, kp[1] - ocr_box_size / 2,
                          kp[0] + ocr_box_size / 2, kp[1] + ocr_box_size / 2]))
    return smiles + "!" + ",".join(boxes)


def _fragment_similarity(gt_frags: Sequence[str],
                         pred_frags: Sequence[str]) -> float:
    """Mean over GT fragments of the best Tanimoto match among predicted
    fragments (greedy one-to-one assignment, larger fragments first).
    Wildcards are carbon-substituted first (reference compares fragment
    backbones after replace_wildcards, utils_evaluation.py:1605-1608)."""
    if not gt_frags:
        return 1.0 if not pred_frags else 0.0
    gt_frags = [replace_wildcards(g) for g in gt_frags]
    pred_frags = [replace_wildcards(p) for p in pred_frags]
    pairs = []
    for gi, g in enumerate(gt_frags):
        for pi, p in enumerate(pred_frags):
            s = 1.0 if p == g else rdkit_compat.tanimoto(g, p)
            pairs.append((s, gi, pi))
    pairs.sort(reverse=True)
    used_g, used_p = set(), set()
    total = 0.0
    for s, gi, pi in pairs:
        if gi in used_g or pi in used_p:
            continue
        used_g.add(gi)
        used_p.add(pi)
        total += max(s, 0.0)
    return float(total / len(gt_frags))


def score_sample(
    prediction_text: str,
    gt_cxsmiles_opt: str,
    gt_stable: Optional[Dict[str, List[str]]],
    markush_tokenizer,
    abbreviation: Optional[Abbreviation] = None,
    remove_stereo: bool = False,
    fix: bool = True,
) -> Dict[str, object]:
    """One prediction string -> full score dict. Mirrors the per-sample flow
    of get_smiles_metrics (utils_evaluation.py:140-414): extract the
    <cxsmi> span and stable table, convert opt->out, fix abbreviations,
    compare against GT."""
    import re

    scores: Dict[str, object] = {}

    m = re.search(r"<cxsmi>(.*?)(</cxsmi>|$)", prediction_text)
    pred_opt = m.group(1).replace(" ", "").split("!")[0] if m else None

    gt_out = cx_lib.convert_opt_to_out(gt_cxsmiles_opt)
    pred_out = cx_lib.convert_opt_to_out(pred_opt) if pred_opt else None
    if fix:
        gt_out = fix_cxsmiles(gt_out, abbreviation)
        if pred_out:
            pred_out = fix_cxsmiles(pred_out, abbreviation)

    # whole-body molecule metrics first, then the Markush metrics so the
    # fragment-weighted tanimoto/inchi values win (the reference's markush
    # path never overwrites them with whole-body values, :842-885)
    gt_body = cx_lib.split_extension(gt_out)[0]
    pred_body = cx_lib.split_extension(pred_out)[0] if pred_out else None
    scores.update(compute_molecule_prediction_quality(
        pred_body, gt_body, remove_stereo=remove_stereo))

    scores.update(compute_markush_prediction_quality(
        pred_out, gt_out, remove_stereo=remove_stereo))

    pred_stable = markush_tokenizer.get_stable(prediction_text)
    scores.update(get_stable_score(gt_stable, pred_stable))

    info = cx_lib.get_molecule_information(gt_out)
    scores["gt_has_r"], scores["gt_has_m"], scores["gt_has_sg"] = (
        info["r"], info["m"], info["sg"])
    scores["markush_equality"] = bool(
        scores["cxsmi_equality"] and scores["stable_equality"])
    return scores


def aggregate_scores(per_sample: Sequence[Dict[str, object]],
                     prefix: str = "") -> Dict[str, float]:
    """Mean-reduce bool/float fields over samples (get_scores reduction,
    utils_evaluation.py:777-1128)."""
    out: Dict[str, float] = {}
    if not per_sample:
        return out
    keys = set().union(*(s.keys() for s in per_sample))
    for k in sorted(keys):
        vals = [s[k] for s in per_sample if isinstance(s.get(k), (bool, int, float))]
        if vals:
            out[f"{prefix}{k}"] = float(sum(float(v) for v in vals) / len(vals))
    out[f"{prefix}n_samples"] = float(len(per_sample))
    return out
