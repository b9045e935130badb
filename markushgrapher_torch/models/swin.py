"""Swin transformer vision encoder (the MolScribe-style OCSR branch): port of
`markushgrapher_tpu.models.swin`.

Shifted-window attention with a relative position bias table, patch merging
between stages, LayerNorm eps from the config (1e-5) and the tanh
approximation of GELU (what `jax.nn.gelu` computes by default). Pixels are
NHWC, as in the reference. Module names follow the flax tree
(`stage{s}_block{b}`, `merge{s}`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def relative_position_index(window: int) -> np.ndarray:
    """[w*w, w*w] index into the (2w-1)^2 relative bias table."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window),
                                  indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1)


def shift_attn_mask(resolution: int, window: int, shift: int) -> np.ndarray:
    """Additive [nW, w*w, w*w] mask for shifted-window attention."""
    img_mask = np.zeros((resolution, resolution))
    slices = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    cnt = 0
    for h in slices:
        for w in slices:
            img_mask[h, w] = cnt
            cnt += 1
    nw = resolution // window
    windows = img_mask.reshape(nw, window, nw, window).transpose(0, 2, 1, 3)
    windows = windows.reshape(-1, window * window)
    diff = windows[:, None, :] - windows[:, :, None]
    return np.where(diff != 0, -1e9, 0.0).astype(np.float32)


class LayerNorm(nn.LayerNorm):
    """LayerNorm computed in float32, returned in the parameters' dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.to(torch.float32), self.normalized_shape,
                         self.weight.to(torch.float32),
                         self.bias.to(torch.float32), self.eps)
        return y.to(self.weight.dtype)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: int):
        super().__init__()
        self.num_heads, self.window = num_heads, window
        self.head_dim = dim // num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.rel_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, num_heads))
        self.proj = nn.Linear(dim, dim)
        self.register_buffer(
            "rel_index", torch.tensor(relative_position_index(window)),
            persistent=False)

    def forward(self, x: torch.Tensor, mask) -> torch.Tensor:
        # x [B*nW, w*w, C]; mask [nW, w*w, w*w] or None
        bnw, n, _ = x.shape
        qkv = self.qkv(x).reshape(bnw, n, 3, self.num_heads, self.head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        bias = self.rel_bias_table[self.rel_index].permute(2, 0, 1)[None]
        scores = torch.einsum("bqhd,bkhd->bhqk",
                              (q * self.head_dim ** -0.5).to(torch.float32),
                              k.to(torch.float32))
        scores = scores + bias
        if mask is not None:
            nw = mask.shape[0]
            scores = scores.reshape(bnw // nw, nw, self.num_heads, n, n)
            scores = (scores + mask[None, :, None]).reshape(
                bnw, self.num_heads, n, n)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        return self.proj(out.reshape(bnw, n, -1))


class SwinBlock(nn.Module):
    def __init__(self, dim, num_heads, resolution, window, shift, mlp_ratio,
                 eps):
        super().__init__()
        self.resolution, self.window, self.shift = resolution, window, shift
        self.ln1 = LayerNorm(dim, eps=eps)
        self.attn = WindowAttention(dim, num_heads, window)
        self.ln2 = LayerNorm(dim, eps=eps)
        self.mlp_fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.mlp_fc2 = nn.Linear(int(dim * mlp_ratio), dim)
        mask = (torch.tensor(shift_attn_mask(resolution, window, shift))
                if shift > 0 else None)
        self.register_buffer("attn_mask", mask, persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, hw, c = x.shape
        r, w, s = self.resolution, self.window, self.shift
        shortcut = x
        x = self.ln1(x).reshape(b, r, r, c)
        if s > 0:
            x = torch.roll(x, shifts=(-s, -s), dims=(1, 2))
        nw = r // w
        x = x.reshape(b, nw, w, nw, w, c).permute(0, 1, 3, 2, 4, 5)
        x = self.attn(x.reshape(b * nw * nw, w * w, c), self.attn_mask)
        x = x.reshape(b, nw, nw, w, w, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, r, r, c)
        if s > 0:
            x = torch.roll(x, shifts=(s, s), dims=(1, 2))
        x = shortcut + x.reshape(b, hw, c)
        h = F.gelu(self.mlp_fc1(self.ln2(x)), approximate="tanh")
        return x + self.mlp_fc2(h)


class PatchMerging(nn.Module):
    def __init__(self, dim: int, resolution: int, eps: float):
        super().__init__()
        self.resolution = resolution
        self.ln = LayerNorm(4 * dim, eps=eps)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, c = x.shape
        r = self.resolution
        x = x.reshape(b, r // 2, 2, r // 2, 2, c).permute(0, 1, 3, 4, 2, 5)
        return self.reduction(self.ln(x.reshape(b, (r // 2) ** 2, 4 * c)))


class SwinEncoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        p, c = cfg.patch_size, cfg.num_channels
        self.patch_embed = nn.Linear(p * p * c, cfg.embed_dim)
        self.patch_ln = LayerNorm(cfg.embed_dim, eps=cfg.layer_norm_eps)
        self.blocks = []
        resolution = cfg.image_size // p
        dim = cfg.embed_dim
        for stage, (depth, heads) in enumerate(zip(cfg.depths,
                                                   cfg.num_heads)):
            window = min(cfg.window_size, resolution)
            for blk in range(depth):
                shift = 0 if (blk % 2 == 0 or window == resolution) \
                    else window // 2
                name = f"stage{stage}_block{blk}"
                self.add_module(name, SwinBlock(
                    dim, heads, resolution, window, shift, cfg.mlp_ratio,
                    cfg.layer_norm_eps))
                self.blocks.append(name)
            if stage < len(cfg.depths) - 1:
                name = f"merge{stage}"
                self.add_module(name, PatchMerging(dim, resolution,
                                                   cfg.layer_norm_eps))
                self.blocks.append(name)
                resolution //= 2
                dim *= 2
        self.final_ln = LayerNorm(dim, eps=cfg.layer_norm_eps)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """[B, H, W, C] NHWC -> [B, (H/32)*(W/32), num_features]."""
        b, h, w, c = pixel_values.shape
        p = self.cfg.patch_size
        x = pixel_values.reshape(b, h // p, p, w // p, p, c)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, (h // p) * (w // p),
                                                p * p * c)
        dtype = self.patch_embed.weight.dtype
        x = self.patch_ln(self.patch_embed(x.to(dtype)))
        for name in self.blocks:
            x = getattr(self, name)(x)
        return self.final_ln(x)
