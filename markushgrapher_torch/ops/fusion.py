"""Vision-text-layout fusion (port of `markushgrapher_tpu.ops.fusion`).

Each OCR token's bbox centre selects the vision patch it lies in; that patch
embedding is added to the token embedding (zeroed for pad / full-page boxes).
Patches claimed by no token are appended in patch-index order through a
stable argsort of the claimed mask, so the output keeps one fixed
[B, T + P, D] shape.
"""

from __future__ import annotations

from typing import Tuple

import torch


def get_visual_bbox(num_patches_side: int, dtype=torch.float32,
                    device=None) -> torch.Tensor:
    """[P, 4] normalised grid boxes of the vision patches."""
    n = num_patches_side
    edges = torch.arange(n + 1, dtype=dtype, device=device) / n
    x0 = edges[:-1][None, :].expand(n, n)
    y0 = edges[:-1][:, None].expand(n, n)
    x1 = edges[1:][None, :].expand(n, n)
    y1 = edges[1:][:, None].expand(n, n)
    return torch.stack([x0, y0, x1, y1], dim=-1).reshape(-1, 4)


def combine_image_text_embeddings(
        image_embeddings: torch.Tensor,  # [B, P, D]
        inputs_embeds: torch.Tensor,     # [B, T, D]
        bbox: torch.Tensor,              # [B, T, 4] float in [0, 1]
        attention_mask: torch.Tensor,    # [B, T]
        num_patches_side: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (embeds [B, T+P, D], bbox [B, T+P, 4], mask [B, T+P])."""
    n = num_patches_side
    batch = inputs_embeds.shape[0]
    cx = (bbox[..., 0] + bbox[..., 2]) / 2.0
    cy = (bbox[..., 1] + bbox[..., 3]) / 2.0
    px = torch.floor(cx * n).clamp(0, n - 1).long()
    py = torch.floor(cy * n).clamp(0, n - 1).long()
    points = px + n * py                                   # [B, T]

    # pad (all-zero) and full-page (all-one) boxes add no patch but still
    # claim theirs
    box_mean = bbox.mean(dim=-1)
    target_seg = (box_mean == 0.0) | (box_mean == 1.0)
    gathered = torch.gather(
        image_embeddings, 1,
        points[..., None].expand(-1, -1, image_embeddings.shape[-1]))
    gathered = torch.where(target_seg[..., None],
                           torch.zeros_like(gathered), gathered)
    text_embeds = inputs_embeds + gathered

    claimed = torch.zeros((batch, n * n), dtype=torch.int32,
                          device=bbox.device)
    claimed.scatter_(1, points, 1)
    # stable sort of an int key: unclaimed patches first, in index order
    order = torch.argsort(claimed, dim=-1, stable=True)    # [B, P]
    keep = torch.gather(claimed, 1, order) == 0

    perm_embeds = torch.gather(
        image_embeddings, 1,
        order[..., None].expand(-1, -1, image_embeddings.shape[-1]))
    perm_vbbox = get_visual_bbox(n, bbox.dtype, bbox.device)[order]
    patch_embeds = torch.where(keep[..., None], perm_embeds,
                               torch.zeros_like(perm_embeds))
    patch_bbox = torch.where(keep[..., None], perm_vbbox,
                             torch.zeros_like(perm_vbbox))
    patch_mask = keep.to(attention_mask.dtype)
    return (torch.cat([text_embeds, patch_embeds], dim=1),
            torch.cat([bbox, patch_bbox], dim=1),
            torch.cat([attention_mask, patch_mask], dim=1))
