"""ChemicalOCR vision-language model (port of `markushgrapher_tpu.ocr.vlm`):
SigLIP-style vision tower, pixel-shuffle connector and a decoder-only LM
(RMSNorm, rotary position embeddings, grouped-query attention, SiLU-gated
MLP; llama / SmolLM2 semantics), prefill and batched decode.

Module and parameter names follow the flax tree (`vision.block_{i}.qkv`,
`connector.proj`, `layer_{i}.q`, `embed`, `final_ln`, ...) so
`convert.from_jax` maps one onto the other; weights use torch's Linear layout
[out, in]. The compute dtype is the parameters' dtype (bf16 when serving).

Decode keeps one ring per layer, `L0 + max_new_tokens` long rounded up to a
128-multiple, written in place at each step:
  - float: k [B, S, G, D] (roped, float32 when the model is bf16), v
    [B, S, G, D] in the compute dtype;
  - int8 (`quant_kv`): values [B, S, G*D] int8, float32 scales [B, G, S], one
    per (token, kv head); attention through `ops.mxu_decode.cross_decode_mxu`;
  - int4 (`quant_kv` + `int4`): the same values nibble-packed (`pack_int4`
    column split, [B, S, G*D/2]) with bf16 scales [B, G, S]; attention through
    `cross_decode_mxu_int4`.
The JAX package repeats the scales to the query heads ([B, H, S]); the port's
decode kernels take one scale row per kv head and group the query heads
themselves, so the rings keep [B, G, S]. `block_skip` (the reference's flag
and default) reads only the quantised rings' valid prefix, in blocks of 128
keys (`ops.mxu_decode.valid_prefix_blocks`).

`decode_step` takes the step as an int (every row at one slot) or as an
int64 tensor [B] (continuous batching, `ocr.engine.ChemicalOCR.
generate_stream`: each row at its own slot, per-row RoPE, a per-row scatter
into each ring and a per-row kv mask [B, 1, 1, S], which the decode kernels
take as their bias [B, 1, S]). Under `block_skip` a vector step reads the
rings up to the 128-key block of the batch's largest slot (the reference's
`_skip_kw`); each row's own mask zeroes what lies past its slot, so the
result is the same. The caller gives that slot as a host integer
(`slot_bound`, any upper bound), so a step reads nothing back from the
device. The combined k||v int4 ring is not ported (ROADMAP). The decode
weights are the layers' own or quantised per output channel
(`quantize_weights`: int8, int4, or W8A8 with the activations quantised per
row; the LM head stays int8), each projection one call of `ops.wq_linear`;
the o projection takes the attention output in the compute dtype. The
whole-step decode (`decode_step_mega`) runs every layer in one launch of
`ops.megastep`, over int8 weights.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from markushgrapher_torch.models.swin import LayerNorm
from markushgrapher_torch.models.t5 import (RMSNorm, qlinear, quantize_kv,
                                            quantize_kv4, quant_marks,
                                            quantize_w)
from markushgrapher_torch.ops import megastep, mxu_decode

Cache = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class OCRVisionConfig:
    image_size: int = 512
    patch_size: int = 16
    d_model: int = 768
    num_layers: int = 12
    num_heads: int = 12
    d_ff: int = 3072
    layer_norm_eps: float = 1e-6

    @property
    def num_patches_side(self) -> int:
        return self.image_size // self.patch_size


@dataclass(frozen=True)
class OCRTextConfig:
    vocab_size: int = 49280          # SmolLM2-style vocab + loc extensions
    d_model: int = 960
    num_layers: int = 32
    num_heads: int = 15
    num_kv_heads: int = 5
    d_ff: int = 2560
    rope_theta: float = 100000.0
    rms_eps: float = 1e-5
    max_position: int = 8192


@dataclass(frozen=True)
class OCRConfig:
    vision: OCRVisionConfig = field(default_factory=OCRVisionConfig)
    text: OCRTextConfig = field(default_factory=OCRTextConfig)
    pixel_shuffle_factor: int = 4    # 32x32 patches -> 8x8 = 64 image tokens
    max_new_tokens: int = 4096

    @property
    def num_image_tokens(self) -> int:
        side = self.vision.num_patches_side // self.pixel_shuffle_factor
        return side * side


def rope_frequencies(dim: int, max_pos: int, theta: float) -> torch.Tensor:
    """[P, dim/2, 2] float32 table of (cos, sin)."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32)
                           / dim))
    t = torch.arange(max_pos, dtype=torch.float32)
    freqs = torch.outer(t, inv)
    return torch.stack([torch.cos(freqs), torch.sin(freqs)], dim=-1)


def apply_rope(x: torch.Tensor, rope: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """Llama rotate-half convention: x * cos + rotate_half(x) * sin with
    per-half frequencies. x [B, L, H, D]; positions [B, L]. The result is
    float32 (the table's type), as in the JAX package."""
    r = rope[positions]                                  # [B, L, D/2, 2]
    cos = torch.cat([r[..., 0], r[..., 0]], -1)[:, :, None]
    sin = torch.cat([r[..., 1], r[..., 1]], -1)[:, :, None]
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], -1)
    return x * cos + rotated * sin


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """float32 scores [B, H, Lq, Lk] of q [B, Lq, H, D] and k [B, Lk, H, D]
    (products of the inputs' values, summed in float32)."""
    return torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                        k.to(torch.float32))


class VisionBlock(nn.Module):
    def __init__(self, cfg: OCRVisionConfig):
        super().__init__()
        d = cfg.d_model
        self.num_heads = cfg.num_heads
        self.ln1 = LayerNorm(d, eps=cfg.layer_norm_eps)
        self.qkv = nn.Linear(d, 3 * d)
        self.proj = nn.Linear(d, d)
        self.ln2 = LayerNorm(d, eps=cfg.layer_norm_eps)
        self.fc1 = nn.Linear(d, cfg.d_ff)
        self.fc2 = nn.Linear(cfg.d_ff, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        hd = d // self.num_heads
        qkv = self.qkv(self.ln1(x)).reshape(b, n, 3, self.num_heads, hd)
        q, k, v = qkv.unbind(2)
        # plain unmasked attention: float32 scores of the bf16-rounded
        # scaled queries, probabilities cast to the compute dtype
        probs = _scores(q * hd ** -0.5, k).softmax(-1).to(x.dtype)
        attn = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        x = x + self.proj(attn.reshape(b, n, d))
        h = F.gelu(self.fc1(self.ln2(x)), approximate="tanh")
        return x + self.fc2(h)


class VisionTower(nn.Module):
    def __init__(self, cfg: OCRVisionConfig):
        super().__init__()
        self.cfg = cfg
        n = cfg.num_patches_side
        self.patch_embed = nn.Linear(cfg.patch_size ** 2 * 3, cfg.d_model)
        self.pos_embed = nn.Parameter(torch.zeros(n * n, cfg.d_model))
        for i in range(cfg.num_layers):
            self.add_module(f"block_{i}", VisionBlock(cfg))
        self.post_ln = LayerNorm(cfg.d_model, eps=cfg.layer_norm_eps)
        # Idefics3 bucketised position ids: fractional coordinates scaled by
        # (1 - 1e-6), bucketised against 1/n boundaries. For full square
        # images this gives max(i - 1, 0) per axis, not arange
        # (Idefics3VisionEmbeddings.forward); checkpoints depend on it.
        frac = np.arange(n) / n * (1 - 1e-6)
        bucket = np.searchsorted(np.arange(1, n) / n, frac, side="right")
        pos_ids = (bucket[:, None] * n + bucket[None, :]).reshape(-1)
        self.register_buffer("pos_ids", torch.tensor(pos_ids),
                             persistent=False)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] float pixels in [0, 1] -> [B, N, D]."""
        b, hh, ww, c = pixel_values.shape
        p = self.cfg.patch_size
        x = pixel_values.reshape(b, hh // p, p, ww // p, p, c)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, (hh // p) * (ww // p),
                                                p * p * c)
        dtype = self.patch_embed.weight.dtype
        x = self.patch_embed(x.to(dtype))
        x = x + self.pos_embed[self.pos_ids][None].to(dtype)
        for i in range(self.cfg.num_layers):
            x = getattr(self, f"block_{i}")(x)
        return self.post_ln(x)


class Connector(nn.Module):
    """Pixel-shuffle (space-to-depth) + projection (Idefics3 connector)."""

    def __init__(self, cfg: OCRConfig):
        super().__init__()
        self.n = cfg.vision.num_patches_side
        self.f = cfg.pixel_shuffle_factor
        self.proj = nn.Linear(self.f ** 2 * cfg.vision.d_model,
                              cfg.text.d_model, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, f = self.n, self.f
        b, _, d = x.shape
        x = x.reshape(b, n // f, f, n // f, f, d)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, (n // f) ** 2, f * f * d)
        return self.proj(x)


class LMLayer(nn.Module):
    def __init__(self, cfg: OCRTextConfig):
        super().__init__()
        self.heads, self.groups = cfg.num_heads, cfg.num_kv_heads
        self.d = d = cfg.d_model // cfg.num_heads
        self.ln_attn = RMSNorm(cfg.d_model, cfg.rms_eps)
        self.q = nn.Linear(cfg.d_model, self.heads * d, bias=False)
        self.k = nn.Linear(cfg.d_model, self.groups * d, bias=False)
        self.v = nn.Linear(cfg.d_model, self.groups * d, bias=False)
        self.o = nn.Linear(self.heads * d, cfg.d_model, bias=False)
        self.ln_mlp = RMSNorm(cfg.d_model, cfg.rms_eps)
        self.gate = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.up = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.down = nn.Linear(cfg.d_ff, cfg.d_model, bias=False)

    @property
    def dtype(self) -> torch.dtype:
        return self.q.weight.dtype

    def _attend(self, q, k, v, bias) -> torch.Tensor:
        """Grouped attention before the o projection: q [B, Lq, H, D], k / v
        [B, Lk, G, D] -> [B, Lq, H, D]."""
        rep = self.heads // self.groups
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
        scores = _scores(q * self.d ** -0.5, k)
        if bias is not None:
            scores = scores + bias
        probs = scores.softmax(-1).to(self.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", probs, v.to(self.dtype))

    def _split(self, t: torch.Tensor, n: int) -> torch.Tensor:
        return t.reshape(*t.shape[:2], n, self.d)

    def forward(self, x, rope, positions, causal_bias):
        return self._prefix(x, rope, positions, causal_bias)[0]

    def _prefix(self, x, rope, positions, causal_bias):
        h = self.ln_attn(x)
        q = apply_rope(self._split(self.q(h), self.heads), rope, positions)
        k = apply_rope(self._split(self.k(h), self.groups), rope, positions)
        v = self._split(self.v(h), self.groups)
        out = self._attend(q, k, v, causal_bias)
        x = x + self.o(out.reshape(*out.shape[:2], -1))
        h = self.ln_mlp(x)
        x = x + self.down(F.silu(self.gate(h)) * self.up(h))
        return x, k, v

    def prefill(self, x, rope, positions, causal_bias, max_len: int,
                quant_kv: bool = False, int4: bool = False
                ) -> Tuple[torch.Tensor, Cache]:
        """Like forward, and also returns this layer's ring of `max_len`
        positions (module docstring layouts) holding the prefix."""
        x, k, v = self._prefix(x, rope, positions, causal_bias)
        b, length = k.shape[:2]
        pad = max_len - length
        if not quant_kv:
            return x, {"k": F.pad(k, (0, 0, 0, 0, 0, pad)),
                       "v": F.pad(v, (0, 0, 0, 0, 0, pad))}
        quant, suffix, sdt = ((quantize_kv4, "_q4", torch.bfloat16) if int4
                              else (quantize_kv, "_q", torch.float32))
        cache = {}
        for kind, t in (("k", k), ("v", v)):
            tq, ts = quant(t)                       # [B, L, G, D], [B, L, G]
            tq = F.pad(tq.reshape(b, length, -1), (0, 0, 0, pad))
            cache[kind + suffix] = mxu_decode.pack_int4(tq) if int4 else tq
            cache[kind + ("_s4" if int4 else "_s")] = F.pad(
                ts, (0, 0, 0, pad)).transpose(1, 2).to(sdt).contiguous()
        return x, cache

    def quantize_weights(self, bits: int = 8, act: bool = False) -> Dict:
        """Decode-step weights quantised per output channel (int8, or int4
        at bits=4; act marks W8A8, int8 only), JAX's dict: q / k / v stack
        along the output rows (qkv), gate / up too (gu: one product, whose
        activation W8A8 quantises once), then o and down."""
        qw = quant_marks(bits, act)
        for key, w in (("qkv", torch.cat([self.q.weight, self.k.weight,
                                          self.v.weight], dim=0)),
                       ("o", self.o.weight),
                       ("gu", torch.cat([self.gate.weight, self.up.weight],
                                        dim=0)),
                       ("down", self.down.weight)):
            qw[key + "_q"], qw[key + "_s"] = quantize_w(w, bits)
        return qw

    def _qkv_decode(self, h, qw, use_kernels: bool):
        if qw is None:
            return (self._split(self.q(h), self.heads),
                    self._split(self.k(h), self.groups),
                    self._split(self.v(h), self.groups))
        qkv = qlinear(h, qw, "qkv", use_kernels)
        nq, nkv = self.heads * self.d, self.groups * self.d
        q, k, v = qkv.split([nq, nkv, nkv], dim=-1)
        return (self._split(q, self.heads), self._split(k, self.groups),
                self._split(v, self.groups))

    def _o_proj(self, out, qw, use_kernels: bool):
        out = out.reshape(*out.shape[:2], -1).to(self.dtype)
        if qw is None:
            return self.o(out)
        return qlinear(out, qw, "o", use_kernels)

    def _mlp_decode(self, h, qw, use_kernels: bool):
        if qw is None:
            return self.down(F.silu(self.gate(h)) * self.up(h))
        gate, up = qlinear(h, qw, "gu", use_kernels).chunk(2, dim=-1)
        return qlinear(F.silu(gate) * up, qw, "down", use_kernels)

    def decode_step(self, x, cache: Cache, rope, positions, slot, kv_mask,
                    qw=None, use_kernels: bool = True,
                    skip: Optional[Dict] = None) -> torch.Tensor:
        """x [B, 1, D]; one token at ring slot `slot`: an int (every row
        shares it) or an int64 tensor [B] (each row its own); kv_mask
        [1 or B, 1, 1, S] float32 (0 up to the row's slot, float32's lowest
        after). skip: the valid-prefix options of the quantised rings' reads
        (`valid_prefix_blocks`), or None. Writes this step's K/V into the
        ring in place, at each row's slot."""
        h = self.ln_attn(x)
        q, k_new, v_new = self._qkv_decode(h, qw, use_kernels)
        q = apply_rope(q, rope, positions)
        k_new = apply_rope(k_new, rope, positions)
        b = x.shape[0]
        # values [B, S, ...] at key axis 1, scales [B, G, S] at key axis 2
        at = ((slice(None), slot) if isinstance(slot, int) else
              (torch.arange(b, device=x.device), slot))
        at_s = (at[0], slice(None), at[1])
        if "k" in cache:                                  # float ring
            cache["k"][at] = k_new[:, 0]
            cache["v"][at] = v_new[:, 0]
            out = self._attend(q, cache["k"], cache["v"], kv_mask)
        else:
            int4 = "k_q4" in cache
            quant, vals, scales = ((quantize_kv4, "_q4", "_s4") if int4
                                   else (quantize_kv, "_q", "_s"))
            for kind, t in (("k", k_new), ("v", v_new)):
                tq, ts = quant(t)                         # [B,1,G,D], [B,1,G]
                tq = tq.reshape(b, -1)
                cache[kind + vals][at] = (mxu_decode.pack_int4(tq)
                                          if int4 else tq)
                ring_s = cache[kind + scales]
                ring_s[at_s] = ts[:, 0].to(ring_s.dtype)
            if int4:
                attend = (mxu_decode.cross_decode_mxu_int4 if use_kernels
                          else mxu_decode.plain_int4)
            else:
                attend = (mxu_decode.cross_decode_mxu if use_kernels
                          else mxu_decode.plain_int8)
            # the grouped map (query head r reads kv block r // (H / G))
            out = attend(q[:, 0] * self.d ** -0.5, cache["k" + vals],
                         cache["k" + scales], cache["v" + vals],
                         cache["v" + scales], kv_mask[:, 0],
                         **(skip or {}))[:, None]
        x = x + self._o_proj(out, qw, use_kernels)
        return x + self._mlp_decode(self.ln_mlp(x), qw, use_kernels)


class ChemicalOCRModel(nn.Module):
    def __init__(self, cfg: OCRConfig, use_kernels: bool = True,
                 block_skip: bool = False):
        super().__init__()
        self.cfg = cfg
        self.use_kernels = use_kernels
        # per-layer decode: read only the quantised rings' valid prefix
        self.block_skip = block_skip
        t = cfg.text
        self.vision = VisionTower(cfg.vision)
        self.connector = Connector(cfg)
        self.embed = nn.Parameter(torch.zeros(t.vocab_size, t.d_model))
        for i in range(t.num_layers):
            self.add_module(f"layer_{i}", LMLayer(t))
        self.final_ln = RMSNorm(t.d_model, t.rms_eps)
        # float32 (cos, sin) table per device, kept out of the parameters
        # and buffers so that casting the model leaves it float32
        self._ropes: Dict[torch.device, torch.Tensor] = {}

    @property
    def dtype(self) -> torch.dtype:
        return self.embed.dtype

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def layers(self) -> List[LMLayer]:
        return [getattr(self, f"layer_{i}")
                for i in range(self.cfg.text.num_layers)]

    def rope(self) -> torch.Tensor:
        dev = self.device
        if dev not in self._ropes:
            t = self.cfg.text
            self._ropes[dev] = rope_frequencies(
                t.d_model // t.num_heads, t.max_position,
                t.rope_theta).to(dev)
        return self._ropes[dev]

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> "ChemicalOCRModel":
        """Seeded random init on the parameters' device with the JAX
        package's initialiser scales: fan-in scaled normal Linear weights,
        normal(0.02) embeddings, zero biases, unit norms."""
        gen = torch.Generator(device=self.device)
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
        self.embed.normal_(0.0, 0.02, generator=gen)
        self.vision.pos_embed.normal_(0.0, 0.02, generator=gen)
        return self

    def input_embeddings(self, pixel_values, prompt_ids) -> torch.Tensor:
        """[image tokens] + [prompt tokens] -> [B, L0, D]."""
        img = self.connector(self.vision(pixel_values))
        txt = self.embed[prompt_ids.long()].to(self.dtype)
        return torch.cat([img, txt], dim=1)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(torch.float32) @ self.embed.to(torch.float32).T

    @staticmethod
    def _causal(length: int, device) -> torch.Tensor:
        tril = torch.tril(torch.ones((length, length), dtype=torch.bool,
                                     device=device))
        neg = torch.finfo(torch.float32).min
        return torch.where(tril, 0.0, neg)[None, None]

    @torch.no_grad()
    def forward(self, pixel_values, prompt_ids, target_ids=None
                ) -> torch.Tensor:
        """Teacher-forced forward; float32 logits over [image + prompt +
        target] positions."""
        x = self.input_embeddings(pixel_values, prompt_ids)
        if target_ids is not None:
            x = torch.cat([x, self.embed[target_ids.long()].to(self.dtype)],
                          dim=1)
        b, length, _ = x.shape
        positions = torch.arange(length, device=x.device)[None].expand(b, -1)
        causal = self._causal(length, x.device)
        for layer in self.layers():
            x = layer(x, self.rope(), positions, causal)
        return self._logits(self.final_ln(x))

    @torch.no_grad()
    def prefill(self, pixel_values, prompt_ids, max_len: int,
                quant_kv: bool = False, int4: bool = False):
        """Run the image + prompt prefix once. Returns (next-token logits
        [B, 1, V] float32, per-layer rings of L0 + max_len positions rounded
        up to a 128-multiple, L0)."""
        x = self.input_embeddings(pixel_values, prompt_ids)
        b, l0, _ = x.shape
        positions = torch.arange(l0, device=x.device)[None].expand(b, -1)
        causal = self._causal(l0, x.device)
        total = l0 + max_len
        total += -total % 128
        caches = []
        for layer in self.layers():
            x, cache = layer.prefill(x, self.rope(), positions, causal, total,
                                     quant_kv=quant_kv, int4=int4)
            caches.append(cache)
        return self._logits(self.final_ln(x)[:, -1:]), caches, l0

    @torch.no_grad()
    def quantize_weights(self, bits: int = 8, act: bool = False) -> Dict:
        """Quantised decode-step weights of every layer (`LMLayer.
        quantize_weights`) and the tied-embedding LM head, which stays int8
        at any bits (per-vocab-row scales). The head's int8 codes are held
        as float32 (exact): its product takes bf16-rounded activations and
        sums in float32, as the JAX package's head does."""
        emb_q, emb_s = quantize_w(self.embed)
        return {"layers": [layer.quantize_weights(bits, act)
                           for layer in self.layers()],
                "lm_head": {"w": emb_q.to(torch.float32), "s": emb_s}}

    def _head(self, x: torch.Tensor, head: Dict) -> torch.Tensor:
        xb = x.to(torch.bfloat16).to(torch.float32)
        return F.linear(xb, head["w"]) * head["s"]

    @torch.no_grad()
    def decode_step(self, token_ids, caches: List[Cache], step,
                    prefix_len: int, qw: Optional[Dict] = None,
                    slot_bound: Optional[int] = None) -> torch.Tensor:
        """One token for every row at ring slot prefix_len + step (step
        counts from 0 after the prefill): `step` an int (every row shares
        the slot) or an int64 tensor [B] (each row its own; module
        docstring). slot_bound: a host upper bound on the largest slot of a
        vector step, up to whose block `block_skip` reads the rings (needed
        there, so that no step waits for the device). Returns float32
        logits [B, 1, V]."""
        b = token_ids.shape[0]
        dev = token_ids.device
        c0 = caches[0]
        total = next(c0[k] for k in ("k", "k_q", "k_q4") if k in c0).shape[1]
        neg = torch.finfo(torch.float32).min
        keys = torch.arange(total, device=dev)
        if isinstance(step, torch.Tensor) and step.dim() == 1:
            if self.block_skip and slot_bound is None:
                raise ValueError("decode_step: a vector step under "
                                 "block_skip needs slot_bound")
            slot = prefix_len + step.to(device=dev, dtype=torch.long)
            positions = slot[:, None]
            kv_mask = torch.where(keys[None] <= slot[:, None], 0.0,
                                  neg)[:, None, None]
            top = slot_bound
        else:
            slot = top = prefix_len + int(step)
            positions = torch.full((b, 1), slot, dtype=torch.long,
                                   device=dev)
            kv_mask = torch.where(keys <= slot, 0.0, neg)[None, None, None]
        skip = (mxu_decode.valid_prefix_blocks(total, top, 128)
                if self.block_skip else None)
        x = self.embed[token_ids.long()].to(self.dtype)
        layer_qw = qw["layers"] if qw is not None else [None] * len(caches)
        for layer, cache, lqw in zip(self.layers(), caches, layer_qw):
            x = layer.decode_step(x, cache, self.rope(), positions, slot,
                                  kv_mask, lqw, self.use_kernels, skip)
        x = self.final_ln(x)
        if qw is not None:
            return self._head(x, qw["lm_head"])
        return self._logits(x)

    # -- whole-step decode (ops.megastep) -----------------------------------

    @torch.no_grad()
    def megastep_pack(self) -> Dict:
        """Stacked int8 weights for `ops.megastep` and the int8 LM head."""
        qw = self.quantize_weights()
        layers = self.layers()
        return {"lm": megastep.pack_lm(
                    qw["layers"], [la.ln_attn.weight for la in layers],
                    [la.ln_mlp.weight for la in layers]),
                "lm_head": qw["lm_head"]}

    @staticmethod
    def stack_caches(caches: List[Cache]) -> Cache:
        """Per-layer int8 rings (prefill output) -> the stacked
        {k_q [L, B, S, G*D], k_s [L, B, G, S], v_q, v_s} of ops.megastep."""
        if "k_q" not in caches[0]:
            raise ValueError("megastep requires int8 ring caches "
                             "(quant_kv=True, int4_kv=False)")
        return {k: torch.stack([c[k] for c in caches])
                for k in ("k_q", "k_s", "v_q", "v_s")}

    @torch.no_grad()
    def decode_step_mega(self, token_ids, rings: Cache, step: int,
                         prefix_len: int, mw: Dict) -> torch.Tensor:
        """decode_step through one launch of ops.megastep for all layers
        (int8 rings, stacked; written in place). Float32 logits [B, 1, V]."""
        t = self.cfg.text
        x = self.embed[token_ids.long()[:, 0]].to(torch.bfloat16)
        step_fn = (megastep.ocr_megastep if self.use_kernels
                   else megastep.plain_megastep)
        x = step_fn(x, rings, mw["lm"], self.rope(), prefix_len + step,
                    heads=t.num_heads, groups=t.num_kv_heads,
                    rms_eps=t.rms_eps)
        x = self.final_ln(x[:, None].to(self.dtype))
        return self._head(x, mw["lm_head"])
