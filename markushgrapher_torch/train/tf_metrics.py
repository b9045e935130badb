"""Teacher-forced evaluation metrics (port of
`markushgrapher_tpu.train.tf_metrics`): per-batch argmax token accuracy,
`<loc_*>`-token MAE over the reserved id range, and IoU over groups of four
consecutive loc tokens (the reference's `compute_custom_metrics`)."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from markushgrapher_torch.data.vocab import LOC_BASE_ID, NUM_LOC

LOC_END_ID = LOC_BASE_ID + NUM_LOC - 1


def token_metrics(logits: torch.Tensor, labels: torch.Tensor
                  ) -> Dict[str, torch.Tensor]:
    """logits [B, S, V], labels [B, S] with -100 padding."""
    preds = logits.argmax(dim=-1)
    valid = labels != -100
    correct = (preds == labels) & valid
    acc = correct.sum() / valid.sum().clamp(min=1)
    is_loc = valid & (labels >= LOC_BASE_ID) & (labels <= LOC_END_ID)
    pred_is_loc = (preds >= LOC_BASE_ID) & (preds <= LOC_END_ID)
    both = is_loc & pred_is_loc
    mae = ((preds - labels).abs() * both).sum() / both.sum().clamp(min=1)
    loc_acc = both.sum() / is_loc.sum().clamp(min=1)
    return {"token_accuracy": acc, "loc_mae": mae,
            "loc_token_type_accuracy": loc_acc}


def loc_box_iou(pred_ids: np.ndarray, label_ids: np.ndarray) -> float:
    """Mean IoU over aligned groups of 4 consecutive loc tokens (host)."""
    ious = []
    for p_row, l_row in zip(pred_ids, label_ids):
        l_pos = [i for i, t in enumerate(l_row)
                 if LOC_BASE_ID <= t <= LOC_END_ID]
        for start in range(0, len(l_pos) - 3, 4):
            idx = l_pos[start:start + 4]
            if idx != list(range(idx[0], idx[0] + 4)):
                continue
            lb = [int(l_row[i]) - LOC_BASE_ID for i in idx]
            pb = [int(p_row[i]) - LOC_BASE_ID for i in idx]
            if not all(0 <= v < NUM_LOC for v in pb):
                continue
            inter = max(0, min(lb[2], pb[2]) - max(lb[0], pb[0])) * \
                max(0, min(lb[3], pb[3]) - max(lb[1], pb[1]))
            union = abs(lb[2] - lb[0]) * abs(lb[3] - lb[1]) + \
                abs(pb[2] - pb[0]) * abs(pb[3] - pb[1]) - inter
            ious.append(inter / union if union > 0 else 0.0)
    return float(np.mean(ious)) if ious else 0.0


@torch.no_grad()
def teacher_forced_eval(model, batch: Dict[str, torch.Tensor]
                        ) -> Dict[str, float]:
    """One teacher-forced forward (deterministic) -> metrics dict."""
    out = model(**batch)
    m = token_metrics(out["logits"], batch["labels"])
    result = {k: float(v) for k, v in m.items()}
    result["eval_loss"] = float(out["loss"])
    preds = out["logits"].argmax(dim=-1)
    result["loc_iou"] = loc_box_iou(preds.cpu().numpy(),
                                    batch["labels"].cpu().numpy())
    return result
