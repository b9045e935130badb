"""Evaluation visualization: per-sample debug figures and molecule drawing.

Capability parity with the reference's visualization layer:
 - `display_eval_sample` — multi-panel matplotlib debug figure: input image
   with OCR boxes, GT vs predicted text/substituent table, rendered predicted
   molecule, optional scores (utils_display.py:62-354);
 - `display_markush` — 2D molecule rendering with m-section highlights
   (utils_markush.py:116-244). The reference draws with RDKit (C++); here a
   numpy force-directed layout over the framework's own Mol graph is used —
   ring-biased Fruchterman-Reingold, bond-order aware edge drawing.

All entry points are side-effect-safe: invalid inputs produce a panel with
the error text instead of raising (the reference guards RDKit segfaults the
same way, utils_markush.py:141-176).
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)


def layout_2d(mol, iterations: int = 200, seed: int = 0) -> np.ndarray:
    """Force-directed 2D coordinates for a Mol graph: [N, 2]."""
    n = mol.num_atoms()
    if n == 0:
        return np.zeros((0, 2))
    rng = np.random.RandomState(seed)
    pos = rng.rand(n, 2) * np.sqrt(n)
    adj = np.zeros((n, n), bool)
    for b in mol.bonds:
        adj[b.a, b.b] = adj[b.b, b.a] = True
    k = 1.0
    t = 0.5
    for _ in range(iterations):
        delta = pos[:, None, :] - pos[None, :, :]
        dist = np.linalg.norm(delta, axis=-1) + 1e-6
        rep = (k * k / dist ** 2)[..., None] * delta
        att = np.where(adj[..., None], (dist / k)[..., None] * -delta / dist[..., None], 0.0)
        force = rep.sum(1) + att.sum(1)
        norm = np.linalg.norm(force, axis=-1, keepdims=True) + 1e-6
        pos = pos + np.minimum(norm, t) * force / norm
        t *= 0.98
    pos -= pos.mean(0)
    scale = np.abs(pos).max() + 1e-6
    return pos / scale


def draw_molecule(ax, cxsmiles: str, highlight_m: bool = True) -> bool:
    """Draw a (CX)SMILES onto a matplotlib axis. Returns success."""
    from markushgrapher_torch.chem.cxsmiles import parse_cxsmiles
    from markushgrapher_torch.chem.mol import parse_smiles

    try:
        cx = parse_cxsmiles(cxsmiles)
        mol = parse_smiles(cx.smiles)
    except Exception as e:
        ax.text(0.5, 0.5, f"invalid: {e}", ha="center", va="center",
                wrap=True, fontsize=7)
        ax.axis("off")
        return False

    pos = layout_2d(mol)
    n = mol.num_atoms()
    m_atoms = set()
    if highlight_m:
        for m in cx.m_sections:
            m_atoms.add(m.anchor)
            m_atoms.update(t for t in m.targets if t < n)

    for b in mol.bonds:
        x = [pos[b.a, 0], pos[b.b, 0]]
        y = [pos[b.a, 1], pos[b.b, 1]]
        lw = {1: 1.2, 2: 2.4, 3: 3.4}.get(b.order, 1.2)
        style = "--" if b.aromatic else "-"
        ax.plot(x, y, style, color="black", linewidth=lw, zorder=1)
    for i in range(n):
        atom = mol.atoms[i]
        label = cx.labels[i] if i < len(cx.labels) and cx.labels[i] else (
            "*" if atom.symbol == "*" else atom.symbol)
        color = ("tab:red" if i in m_atoms
                 else ("tab:blue" if label not in ("C", "c") else "none"))
        ax.scatter([pos[i, 0]], [pos[i, 1]], s=160,
                   c="white", edgecolors=color if color != "none" else "white",
                   zorder=2)
        if label not in ("C",) or mol.degree(i) == 0:
            ax.text(pos[i, 0], pos[i, 1], label, ha="center", va="center",
                    fontsize=8, zorder=3,
                    color="tab:red" if i in m_atoms else "black")
    ax.set_aspect("equal")
    ax.axis("off")
    return True


display_markush = draw_molecule


def display_eval_sample(
    image: Optional[np.ndarray],
    cells: Sequence[Dict],
    gt_text: str,
    pred_text: str,
    gt_stable: Optional[Dict] = None,
    pred_stable: Optional[Dict] = None,
    pred_cxsmiles: Optional[str] = None,
    scores: Optional[Dict] = None,
    output_path: Optional[str] = None,
):
    """6-panel debug figure (utils_display.py display_eval_sample:62-341).
    Returns the figure; saves to output_path when given."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(2, 3, figsize=(15, 9))
    ax_img, ax_gt, ax_pred = axes[0]
    ax_mol, ax_gt_tab, ax_pred_tab = axes[1]

    if image is not None:
        ax_img.imshow(image)
        h, w = image.shape[:2]
        for cell in cells:
            x0, y0, x1, y1 = cell["bbox"]
            ax_img.add_patch(plt.Rectangle(
                (x0 * w, y0 * h), (x1 - x0) * w, (y1 - y0) * h,
                fill=False, edgecolor="tab:green", linewidth=0.8))
    ax_img.set_title("input + OCR boxes")
    ax_img.axis("off")

    for ax, text, title in ((ax_gt, gt_text, "ground truth"),
                            (ax_pred, pred_text, "prediction")):
        ax.text(0.01, 0.99, _wrap(text), ha="left", va="top", fontsize=7,
                family="monospace", wrap=True)
        ax.set_title(title)
        ax.axis("off")

    if pred_cxsmiles:
        draw_molecule(ax_mol, pred_cxsmiles)
    else:
        ax_mol.axis("off")
    ax_mol.set_title("predicted molecule")

    for ax, stable, title in ((ax_gt_tab, gt_stable, "GT substituents"),
                              (ax_pred_tab, pred_stable, "pred substituents")):
        rows = "\n".join(f"{k}: {', '.join(map(str, v))}"
                         for k, v in (stable or {}).items())
        ax.text(0.01, 0.99, rows or "(empty)", ha="left", va="top",
                fontsize=8, family="monospace")
        ax.set_title(title)
        ax.axis("off")

    if scores:
        summary = "  ".join(f"{k}={v}" for k, v in list(scores.items())[:8])
        fig.suptitle(summary, fontsize=8)

    fig.tight_layout()
    if output_path:
        fig.savefig(output_path, dpi=110)
        plt.close(fig)
    return fig


def _wrap(text: str, width: int = 60) -> str:
    return "\n".join(text[i:i + width] for i in range(0, len(text), width))
