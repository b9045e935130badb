"""MarkushGrapher model: OCSR Swin branch + VTL (UDOP) encoder and a T5
decoder; port of `markushgrapher_tpu.models.markushgrapher` for serving.

`encode` serves the VTL encoder one way, at every fused length: one int8
[B, H, L, L] bias slab from `ops.bias_build` shared by every layer's
`ops.flash_attention` (the reference's flash + bias_int8 + bias_kernel
branch). The decode side serves quantised KV caches (int4 or int8, the
reference's `int4_cross` flag) with int8 weights. The float-bias flash
branch, the float-KV decode and `encoder_pack_len` are not ported
(ROADMAP).

`use_kernels=False` makes the model call each kernel's plain PyTorch version
directly on any device: the reference path that the card's kernels are held
against.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from markushgrapher_torch.config import MarkushGrapherConfig
from markushgrapher_torch.models.swin import LayerNorm, SwinEncoder
from markushgrapher_torch.models.t5 import (RMSNorm, Decoder, Encoder,
                                            quantize_w)
from markushgrapher_torch.ops import bias_build, relbias
from markushgrapher_torch.ops.fusion import combine_image_text_embeddings


def _molscribe_tokens(cfg: MarkushGrapherConfig) -> int:
    if cfg.architecture_variant == "none":
        return 0
    return (cfg.swin.image_size // cfg.swin.patch_size
            // 2 ** (len(cfg.swin.depths) - 1)) ** 2


def encoder_valid_counts(cfg: MarkushGrapherConfig, bbox: torch.Tensor,
                         attention_mask: torch.Tensor,
                         include_molscribe: bool = True) -> torch.Tensor:
    """Per-sample valid encoder positions [B]: the VTL fused mask (text +
    unclaimed patches) plus the molscribe branch's always-valid tokens."""
    n = cfg.vtl.num_patches_side
    b = attention_mask.shape[0]
    dummy_t = torch.zeros(attention_mask.shape + (1,), device=bbox.device)
    dummy_p = torch.zeros((b, n * n, 1), device=bbox.device)
    _, _, fm = combine_image_text_embeddings(
        dummy_p, dummy_t, bbox.to(torch.float32), attention_mask, n)
    mols = _molscribe_tokens(cfg) if include_molscribe else 0
    return fm.sum(dim=1) + mols


def encoder_valid_max(cfg: MarkushGrapherConfig, bbox: torch.Tensor,
                      attention_mask: torch.Tensor,
                      include_molscribe: bool = True) -> int:
    """Max valid encoder positions across the batch (one host readback);
    callers round it up to pick a static `cross_pack_len`."""
    return int(encoder_valid_counts(cfg, bbox, attention_mask,
                                    include_molscribe).max())


class CellEmbeddings(nn.Module):
    """2D bbox-corner embeddings added to the encoder inputs."""

    def __init__(self, table_size: int, d_model: int):
        super().__init__()
        self.table_size = table_size
        self.x_embed = nn.Parameter(torch.zeros(table_size, d_model))
        self.y_embed = nn.Parameter(torch.zeros(table_size, d_model))

    def forward(self, bbox: torch.Tensor) -> torch.Tensor:
        q = (bbox.clamp(0.0, 1.0) * (self.table_size - 1)).to(torch.long)
        return (self.x_embed[q[..., 0]] + self.y_embed[q[..., 1]]
                + self.x_embed[q[..., 2]] + self.y_embed[q[..., 3]])


class PatchEmbed(nn.Module):
    """Stride-P patchify as reshape + one matmul (NHWC pixels)."""

    def __init__(self, patch_size: int, num_channels: int, d_model: int):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Linear(patch_size * patch_size * num_channels, d_model)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        b, h, w, c = pixel_values.shape
        p = self.patch_size
        if h % p or w % p:
            raise ValueError(f"image size {h}x{w} not divisible by patch "
                             f"size {p}")
        x = pixel_values.reshape(b, h // p, p, w // p, p, c)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, (h // p) * (w // p),
                                                p * p * c)
        return self.proj(x.to(self.proj.weight.dtype))


class MLPProjector(nn.Module):
    """Two-layer MLP from OCSR features to d_model (tanh GELU)."""

    def __init__(self, d_in: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = nn.Linear(d_in, hidden)
        self.fc2 = nn.Linear(hidden, out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class MarkushGrapherModel(nn.Module):
    def __init__(self, cfg: MarkushGrapherConfig, use_kernels: bool = True,
                 int4_cross: bool = True):
        super().__init__()
        self.cfg = cfg
        self.use_kernels = use_kernels
        # KV scheme of the decode caches: int4 (True) or int8 (False)
        self.int4_cross = int4_cross
        vtl = cfg.vtl
        nb, heads = vtl.relative_attention_num_buckets, vtl.num_heads
        self.shared_embedding = nn.Parameter(
            torch.zeros(vtl.vocab_size, vtl.d_model))
        if cfg.architecture_variant != "me-lf-stack-1-molscribe-only":
            self.patch_embed = PatchEmbed(vtl.patch_size, vtl.num_channels,
                                          vtl.d_model)
            self.cell2d = CellEmbeddings(vtl.cell_embeddings_size,
                                         vtl.d_model)
            self.enc_bias_1d = nn.Parameter(torch.zeros(nb, heads))
            self.enc_bias_h = nn.Parameter(torch.zeros(nb, heads))
            self.enc_bias_v = nn.Parameter(torch.zeros(nb, heads))
            self.encoder = Encoder(vtl.num_layers, vtl.d_model, heads,
                                   vtl.d_kv, vtl.d_ff, vtl.feed_forward_proj,
                                   vtl.layer_norm_epsilon)
        if cfg.architecture_variant != "none":
            self.molscribe_encoder = SwinEncoder(cfg.swin)
            self.molscribe_projector = MLPProjector(
                cfg.swin.num_features, cfg.projector_hidden, vtl.d_model)
        self.dec_bias_1d = nn.Parameter(torch.zeros(nb, heads))
        self.decoder = Decoder(vtl.num_decoder_layers, vtl.d_model, heads,
                               vtl.d_kv, vtl.d_ff, vtl.feed_forward_proj,
                               vtl.layer_norm_epsilon)
        self.lm_head = nn.Linear(vtl.d_model, vtl.vocab_size, bias=False)

    @property
    def dtype(self) -> torch.dtype:
        return self.shared_embedding.dtype

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> "MarkushGrapherModel":
        """Seeded random init on the parameters' device, with the reference's
        initialiser scales (normal embeddings / bias tables, fan-in scaled
        normal Linear weights, unit norms, zero biases)."""
        gen = torch.Generator(device=self.shared_embedding.device)
        gen.manual_seed(seed)
        for module in self.modules():
            if isinstance(module, nn.Linear):
                module.weight.normal_(0.0, 1.0 / math.sqrt(
                    module.in_features), generator=gen)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, (RMSNorm, LayerNorm)):
                module.weight.fill_(1.0)
                if getattr(module, "bias", None) is not None:
                    module.bias.zero_()
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            std = {"shared_embedding": 1.0, "x_embed": 0.02,
                   "y_embed": 0.02, "rel_bias_table": 0.02,
                   "enc_bias_1d": 0.5, "enc_bias_h": 0.5, "enc_bias_v": 0.5,
                   "dec_bias_1d": 0.5}.get(leaf)
            if std is not None:
                p.normal_(0.0, std, generator=gen)
        return self

    def embed_tokens(self, ids: torch.Tensor) -> torch.Tensor:
        return self.shared_embedding[ids.long()]

    # -- encoding ----------------------------------------------------------

    @torch.no_grad()
    def encode(self, input_ids, bbox, attention_mask,
               pixel_values: Optional[torch.Tensor],
               ocsr_pixel_values: Optional[torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (encoder states [B, L_enc, D], mask [B, L_enc])."""
        cfg, vtl = self.cfg, self.cfg.vtl
        branches: List[torch.Tensor] = []
        masks: List[torch.Tensor] = []
        if cfg.architecture_variant != "none":
            e1 = self.molscribe_projector(
                self.molscribe_encoder(ocsr_pixel_values))
            branches.append(e1)
            masks.append(torch.ones(e1.shape[:2], dtype=attention_mask.dtype,
                                    device=e1.device))
        if cfg.architecture_variant != "me-lf-stack-1-molscribe-only":
            if tuple(pixel_values.shape[1:3]) != (vtl.image_size,
                                                  vtl.image_size):
                raise ValueError(
                    f"pixel_values {tuple(pixel_values.shape[1:3])} != "
                    f"configured image_size {vtl.image_size}")
            bbox = bbox.to(torch.float32)
            embeds, full_bbox, full_mask = combine_image_text_embeddings(
                self.patch_embed(pixel_values), self.embed_tokens(input_ids),
                bbox, attention_mask, vtl.num_patches_side)
            embeds = embeds + self.cell2d(full_bbox)
            seq_len = embeds.shape[1]
            build = (bias_build.encoder_position_bias_kernel_i8
                     if self.use_kernels else bias_build.plain)
            bias_i8, scales = build(
                self.enc_bias_1d, self.enc_bias_h, self.enc_bias_v,
                full_bbox, full_mask, seq_len,
                vtl.relative_attention_num_buckets,
                vtl.relative_attention_max_distance,
                vtl.rel2d_scaling_factor, vtl.rel2d_max_distance)
            e2 = self.encoder(embeds, (bias_i8, scales, full_mask),
                              self.use_kernels)
            branches.append(e2)
            masks.append(full_mask)
        return torch.cat(branches, dim=1), torch.cat(masks, dim=1)

    # -- stepwise decode -----------------------------------------------------

    @torch.no_grad()
    def init_cache(self, enc: torch.Tensor, max_len: int,
                   self_rows: Optional[int] = None):
        """Per-layer caches: cross slabs of enc's [B] rows, self rings of
        `self_rows` rows (B * beams under beam search; default B)."""
        return self.decoder.init_cache(enc, max_len, self.int4_cross,
                                       self_rows or enc.shape[0])

    @torch.no_grad()
    def quantize_weights(self) -> Dict:
        """int8 decode weights (decoder projections / FF and the lm_head),
        the reference's quant_weights at weight_bits=8."""
        lm_q, lm_s = quantize_w(self.lm_head.weight)
        return {"layers": self.decoder.quantize_weights(),
                "lm_head": {"q": lm_q, "s": lm_s}}

    @torch.no_grad()
    def full_decoder_bias(self, max_len: int) -> torch.Tensor:
        """[1, H, S, S] float32 causal T5 bias."""
        vtl = self.cfg.vtl
        bias = relbias.decoder_position_bias(
            self.dec_bias_1d, max_len, vtl.relative_attention_num_buckets,
            vtl.relative_attention_max_distance)
        causal = torch.tril(torch.ones((max_len, max_len), dtype=torch.bool,
                                       device=bias.device))
        neg = torch.finfo(torch.float32).min
        return bias + torch.where(causal, 0.0, neg)[None, None]

    @torch.no_grad()
    def decode_step(self, token_ids: torch.Tensor, caches, step: int,
                    bias_full: torch.Tensor, cross_bias: torch.Tensor,
                    qw: Dict) -> torch.Tensor:
        """token_ids [rows, 1]; cross_bias [B, 1, Kp] f32 over the cross
        slabs' rows (padding keys at -1e9). Returns float32 logits
        [rows, 1, V]."""
        x = self.embed_tokens(token_ids)
        x = self.decoder.decode_step(x, caches, step, bias_full[:, :, step],
                                     cross_bias, qw["layers"],
                                     self.use_kernels)
        # bf16 operands, float32 accumulation, as the reference's int8 head
        logits = F.linear(x.to(torch.bfloat16).to(torch.float32),
                          qw["lm_head"]["q"].to(torch.float32))
        return logits * qw["lm_head"]["s"]
