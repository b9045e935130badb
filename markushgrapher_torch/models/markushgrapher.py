"""MarkushGrapher model: OCSR Swin branch + VTL (UDOP) encoder and a T5
decoder; port of `markushgrapher_tpu.models.markushgrapher` for serving and
training.

`encode` serves the reference's four VTL encoder routes, chosen as
`markushgrapher.py:287-360` chooses them:
  1. `encoder_pack_len` (0 = off) first packs each row's valid positions to
     a contiguous prefix (stable) and truncates the encoder to that length;
     the original indices travel into the bias builders as `positions`;
  2. `inkernel_bias` (not packed): every layer's `ops.flash_relbias` kernel
     computes the relative bias itself, no slab is built;
  3. `bias_int8`: one int8 [B, H, L, L] slab from `ops.bias_build`, shared
     by every layer's `ops.flash_attention.flash_attention_bias_i8`;
  4. otherwise one bf16 slab with the key mask in it
     (`relbias.encoder_position_bias_chunked`), shared by every layer's
     `ops.flash_attention.flash_attention_bias`.
Every route runs the flash kernels at every fused length: the reference's
256- and 512-multiple gates are TPU block rules (its kernels tile by 256 /
512; these need no tile multiple). `bias_kernel` and `bias_kernel_relayout`
only pick the reference's TPU builder for the int8 slab (its one-hot MXU
kernel, and how that kernel lays tiles out); the port's CUDA builder is
bit-exact against the plain gather builder, so both flags are accepted and
change nothing.

The decode side serves float caches in the model's dtype, or quantised KV
caches (int4 or int8, the reference's `int4_cross` flag), with the modules'
weights or quantised decode weights (`quantize_weights`: int8, int4 or
W8A8, each projection through `ops.wq_linear`). `block_skip` (the
reference's flag and default) reads only the quantised self rings' valid
prefix.

`use_kernels=False` makes the model call each kernel's plain PyTorch version
directly on any device: the reference path that the card's kernels are held
against.

Training (`forward`, the reference's teacher-forced `__call__`):
`encode_train` is the grad-enabled encoder. With deterministic=False on a
long VTL row (L > 512, a 256-multiple) it builds the reference's training
slab once, ((t1 + th) + tv) in float32 with -1e9 on masked keys, cast to bf16
(`relbias.encoder_position_bias_onehot`), and every layer's self-attention
goes through the trainable flash kernels; otherwise the float32 bias plus
`mask_bias` and dense attention, as the reference. `decode_train` is the
dense teacher-forced decoder, `lm_head` in float32. `remat` recomputes each
layer in backward.
"""

from __future__ import annotations

import copy
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from markushgrapher_torch.config import MarkushGrapherConfig
from markushgrapher_torch.models.swin import LayerNorm, SwinEncoder
from markushgrapher_torch.models.t5 import (RMSNorm, Decoder, Encoder,
                                            quantize_w, train_chunk_q)
from markushgrapher_torch.ops import bias_build, relbias
from markushgrapher_torch.ops.fusion import (combine_image_text_embeddings,
                                             pack_valid_first)


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


# the serving encoder's routes by name, as constructor flags; the packed
# route's encoder_pack_len is sized for each batch by `route_flags`
ROUTES = {"int8 slab": dict(bias_int8=True), "bf16 slab": {},
          "in-kernel bias": dict(inkernel_bias=True),
          "packed": dict(bias_int8=True, encoder_pack_len=None)}


def route_flags(cfg: MarkushGrapherConfig, route: str, bbox: torch.Tensor,
                attention_mask: torch.Tensor) -> Dict:
    """Constructor flags of a route of ROUTES for one batch: the packed
    route packs to the ceil-256 of the batch's VTL valid count (without the
    molscribe tokens), as the reference's bench sizes encoder_pack_len."""
    flags = dict(ROUTES[route])
    if "encoder_pack_len" in flags:
        mv = encoder_valid_max(cfg, bbox, attention_mask,
                               include_molscribe=False)
        flags["encoder_pack_len"] = -(-mv // 256) * 256
    return flags


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
                 int4_cross: bool = True, remat: bool = False,
                 bias_int8: bool = False, bias_kernel: bool = False,
                 bias_kernel_relayout: str = "kernel",
                 inkernel_bias: bool = False, encoder_pack_len: int = 0,
                 block_skip: bool = False):
        super().__init__()
        self.cfg = cfg
        self.use_kernels = use_kernels
        # training: recompute each encoder / decoder layer in backward
        self.remat = remat
        # quantised KV scheme of the decode caches: int4 (True) or int8
        self.int4_cross = int4_cross
        # the serving encoder's routes (module docstring); bias_kernel and
        # bias_kernel_relayout pick a TPU builder and change nothing here
        self.bias_int8 = bias_int8
        self.bias_kernel = bias_kernel
        self.bias_kernel_relayout = bias_kernel_relayout
        self.inkernel_bias = inkernel_bias
        # static packed VTL encoder length (0 = off): must bound every row's
        # VTL valid count (encoder_valid_max without the molscribe tokens)
        self.encoder_pack_len = encoder_pack_len
        # decode: read only the quantised self rings' valid prefix
        self.block_skip = block_skip
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
                                   vtl.layer_norm_epsilon, vtl.dropout_rate)
        if cfg.architecture_variant != "none":
            self.molscribe_encoder = SwinEncoder(cfg.swin)
            self.molscribe_projector = MLPProjector(
                cfg.swin.num_features, cfg.projector_hidden, vtl.d_model)
        self.dec_bias_1d = nn.Parameter(torch.zeros(nb, heads))
        self.decoder = Decoder(vtl.num_decoder_layers, vtl.d_model, heads,
                               vtl.d_kv, vtl.d_ff, vtl.feed_forward_proj,
                               vtl.layer_norm_epsilon, vtl.dropout_rate)
        self.lm_head = nn.Linear(vtl.d_model, vtl.vocab_size, bias=False)

    @property
    def dtype(self) -> torch.dtype:
        return self.shared_embedding.dtype

    # the constructor's flags after cfg, which `clone` may replace
    FLAGS = ("use_kernels", "int4_cross", "remat", "bias_int8", "bias_kernel",
             "bias_kernel_relayout", "inkernel_bias", "encoder_pack_len",
             "block_skip")

    def clone(self, **flags) -> "MarkushGrapherModel":
        """This model with some constructor flags replaced (an encoder
        route, the KV scheme) over the same submodules and weights, shared,
        not copied: the counterpart of the reference's flax `clone`."""
        unknown = set(flags) - set(self.FLAGS)
        if unknown:
            raise TypeError(f"not a constructor flag: {sorted(unknown)}")
        other = copy.copy(self)
        for name, value in flags.items():
            setattr(other, name, value)
        return other

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
            positions = None
            if 0 < self.encoder_pack_len < embeds.shape[1]:
                # padding kept inside the static length stays masked; the
                # original indices keep the 1d buckets' distances
                order, full_mask, embeds, full_bbox = pack_valid_first(
                    full_mask, self.encoder_pack_len, embeds, full_bbox)
                positions = order.to(torch.int32)
            e2 = self.encoder(embeds, self.encoder_bias(
                full_bbox, full_mask, positions), self.use_kernels)
            branches.append(e2)
            masks.append(full_mask)
        return torch.cat(branches, dim=1), torch.cat(masks, dim=1)

    def encoder_bias(self, full_bbox: torch.Tensor, full_mask: torch.Tensor,
                     positions: Optional[torch.Tensor] = None):
        """The serving encoder's bias, in the form its route gives every
        layer's attention (`t5.Attention.forward`): the in-kernel bias
        inputs (a dict) when `inkernel_bias` is set and the encoder is not
        packed, else the int8 slab tuple when `bias_int8`, else the bf16
        slab with the key mask at -1e9."""
        vtl = self.cfg.vtl
        seq_len = full_bbox.shape[1]
        geometry = (vtl.relative_attention_num_buckets,
                    vtl.relative_attention_max_distance,
                    vtl.rel2d_scaling_factor, vtl.rel2d_max_distance)
        tables = (self.enc_bias_1d, self.enc_bias_h, self.enc_bias_v)
        if self.inkernel_bias and positions is None:
            hx, vy = relbias.bbox_centres(full_bbox)
            return dict(hx=hx, vy=vy, mask=full_mask, bias_1d=tables[0],
                        bias_h=tables[1], bias_v=tables[2],
                        max_dist_1d=vtl.relative_attention_max_distance,
                        max_dist_2d=vtl.rel2d_max_distance,
                        scaling_2d=vtl.rel2d_scaling_factor)
        if self.bias_int8:
            build = (bias_build.encoder_position_bias_kernel_i8
                     if self.use_kernels else bias_build.plain)
            bias_i8, scales = build(*tables, full_bbox, full_mask, seq_len,
                                    *geometry, positions=positions)
            return bias_i8, scales, full_mask
        return relbias.encoder_position_bias_chunked(
            *tables, full_bbox, full_mask, seq_len, *geometry,
            positions=positions)

    # -- training: teacher-forced forward -------------------------------------

    def encode_train(self, input_ids, bbox, attention_mask,
                     pixel_values: Optional[torch.Tensor],
                     ocsr_pixel_values: Optional[torch.Tensor],
                     deterministic: bool = True,
                     generator: Optional[torch.Generator] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Grad-enabled encode: (states [B, L_enc, D] in the parameters'
        dtype, mask [B, L_enc])."""
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
            tok = self.embed_tokens(input_ids)
            embeds, full_bbox, full_mask = combine_image_text_embeddings(
                self.patch_embed(pixel_values).to(tok.dtype), tok,
                bbox.to(torch.float32), attention_mask, vtl.num_patches_side)
            embeds = embeds + self.cell2d(full_bbox)
            seq_len = embeds.shape[1]
            tables = (self.enc_bias_1d, self.enc_bias_h, self.enc_bias_v)
            geometry = (vtl.relative_attention_num_buckets,
                        vtl.relative_attention_max_distance,
                        vtl.rel2d_scaling_factor, vtl.rel2d_max_distance)
            if not deterministic and train_chunk_q(seq_len):
                bias = relbias.encoder_position_bias_onehot(
                    *tables, full_bbox, full_mask, seq_len, *geometry)
            else:
                bias = relbias.encoder_position_bias(
                    *tables, full_bbox, seq_len, *geometry) + \
                    relbias.mask_bias(full_mask)
            branches.append(self.encoder.train_forward(
                embeds, bias, deterministic, generator, self.remat))
            masks.append(full_mask)
        return (torch.cat([t.to(self.dtype) for t in branches], dim=1),
                torch.cat(masks, dim=1))

    def shift_right(self, labels: torch.Tensor) -> torch.Tensor:
        """labels -> decoder_input_ids: prepend decoder_start, drop the last,
        -100 -> pad."""
        vtl = self.cfg.vtl
        shifted = torch.roll(labels, 1, dims=-1)
        shifted[:, 0] = vtl.decoder_start_token_id
        return torch.where(shifted == -100, vtl.pad_token_id, shifted)

    def decode_train(self, decoder_input_ids: torch.Tensor, enc: torch.Tensor,
                     enc_mask: torch.Tensor, deterministic: bool = True,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
        """Teacher-forced decoder -> float32 logits [B, S, V]."""
        vtl = self.cfg.vtl
        seq_len = decoder_input_ids.shape[1]
        x = self.embed_tokens(decoder_input_ids)
        self_bias = self.full_decoder_bias(seq_len)
        cross_bias = relbias.mask_bias(enc_mask)
        x = self.decoder.train_forward(x, enc, self_bias, cross_bias,
                                       deterministic, generator, self.remat)
        with torch.autocast(x.device.type, enabled=False):
            return F.linear(x.to(torch.float32),
                            self.lm_head.weight.to(torch.float32))

    def forward(self, input_ids, bbox, attention_mask, labels,
                pixel_values: Optional[torch.Tensor] = None,
                ocsr_pixel_values: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """Full teacher-forced forward: {"loss", "logits" (float32)}.
        deterministic=False is the training forward (dropout from
        `generator`, the training encoder branch)."""
        enc, enc_mask = self.encode_train(
            input_ids, bbox, attention_mask, pixel_values, ocsr_pixel_values,
            deterministic, generator)
        labels = labels.long()
        logits = self.decode_train(self.shift_right(labels), enc, enc_mask,
                                   deterministic, generator)
        return {"loss": cross_entropy_with_ignore(logits, labels),
                "logits": logits}

    # -- stepwise decode -----------------------------------------------------

    @torch.no_grad()
    def init_cache(self, enc: torch.Tensor, max_len: int,
                   quant_cross: bool = False,
                   self_rows: Optional[int] = None):
        """Per-layer caches: cross K/V of enc's rows, self caches of
        `self_rows` rows (B * beams under beam search with quantised slabs;
        default enc's rows). Float caches in enc's dtype, or with
        quant_cross the quantised scheme of `int4_cross`."""
        return self.decoder.init_cache(enc, max_len, quant_cross,
                                       self.int4_cross,
                                       self_rows or enc.shape[0])

    @torch.no_grad()
    def quantize_weights(self, bits: int = 8, act: bool = False) -> Dict:
        """Quantised decode weights, the reference's quant_weights: the
        decoder projections / FF at `bits` (8 or 4), act marking W8A8 (int8
        weights only), and the lm_head, which stays int8 either way (its
        argmax is the decode output)."""
        lm_q, lm_s = quantize_w(self.lm_head.weight)
        return {"layers": self.decoder.quantize_weights(bits, act),
                "lm_head": {"q": lm_q, "s": lm_s}}

    def full_decoder_bias(self, max_len: int) -> torch.Tensor:
        """[1, H, S, S] float32 causal T5 bias (differentiable in the
        table)."""
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
                    qw: Optional[Dict] = None,
                    row_map: Optional[torch.Tensor] = None,
                    lattice: bool = False) -> torch.Tensor:
        """token_ids [rows, 1]; cross_bias [B, 1, K] f32 over the cross
        caches' rows (masked keys, and a quantised slab's padding, very
        negative); qw: `quantize_weights()` or None; row_map (int32 [rows,
        n_seg]): beam search's copy-on-write ring segments, read segment by
        segment under `lattice` (int4 rings). Returns float32 logits
        [rows, 1, V]."""
        x = self.embed_tokens(token_ids)
        x = self.decoder.decode_step(x, caches, step, bias_full[:, :, step],
                                     cross_bias,
                                     None if qw is None else qw["layers"],
                                     self.use_kernels, row_map,
                                     self.block_skip, lattice)
        if qw is None:
            return F.linear(x.to(torch.float32),
                            self.lm_head.weight.to(torch.float32))
        # bf16 operands, float32 accumulation, as the reference's int8 head
        logits = F.linear(x.to(torch.bfloat16).to(torch.float32),
                          qw["lm_head"]["q"].to(torch.float32))
        return logits * qw["lm_head"]["s"]


def cross_entropy_with_ignore(logits: torch.Tensor, labels: torch.Tensor,
                              ignore_index: int = -100,
                              label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean cross-entropy over non-ignored positions, float32 log-softmax;
    with label_smoothing, (1 - e) * nll + e * mean(-log p)."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0).long()
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    if label_smoothing > 0.0:
        nll = (1.0 - label_smoothing) * nll + label_smoothing * (
            -logp.mean(dim=-1))
    nll = torch.where(valid, nll, 0.0)
    return nll.sum() / valid.sum().clamp(min=1)
