"""T5-style transformer stack (the UDOP backbone): port of
`markushgrapher_tpu.models.t5`, encoder and serving decode step.

Pre-RMSNorm blocks (float32 statistics), attention without 1/sqrt(d)
scaling, relu (or gated-gelu) feed-forward. Module and parameter names follow
the flax tree (`layer_{i}`, `ln_attn`, `attn.{q,k,v,o}`, ...) so
`convert.from_jax` maps one onto the other; weights use torch's Linear
layout [out, in].

The decode step serves the int4-KV + int8-weight path only:
  - cross K/V slabs quantised once per generate call (per-(token, head)
    int4 with bf16 scales, `pack_int4` column split, key axis padded to a
    256-multiple);
  - separate int4 K and V self rings [B, S, H*D/2] with bf16 scales
    [B, H, S], written in place each step (the reference's greedy path keeps
    one combined k||v ring, a TPU layout choice; the math is the same);
  - every decode attention through `ops.mxu_decode.cross_decode_mxu_int4`;
  - every decode-step matmul against int8 weights dequantised to the compute
    dtype, scaled per output channel afterwards.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from markushgrapher_torch.ops import flash_attention, mxu_decode

Cache = Dict[str, torch.Tensor]


def quantize_kv4(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) symmetric int4 of [..., D]: values in [-7, 7]
    (int8 storage), float32 scales max|t| / 7 of shape [...]."""
    tf = t.to(torch.float32)
    scale = tf.abs().amax(dim=-1, keepdim=True) / 7.0 + 1e-8
    q = torch.round(tf / scale).clamp(-7, 7).to(torch.int8)
    return q, scale[..., 0]


def quantize_w(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weight-only symmetric int8 quantisation of a Linear weight [out, in],
    one float32 scale per output channel."""
    wf = w.to(torch.float32)
    s = wf.abs().amax(dim=1, keepdim=True) / 127.0 + 1e-12
    q = torch.round(wf / s).clamp(-127, 127).to(torch.int8)
    return q, s[:, 0]


def qlinear(x: torch.Tensor, w_q: torch.Tensor,
            s: torch.Tensor) -> torch.Tensor:
    """x @ dequant(w_q).T in x's dtype, then the per-channel scale in
    float32, back to x's dtype."""
    y = F.linear(x, w_q.to(x.dtype))
    return (y.to(torch.float32) * s).to(x.dtype)


class RMSNorm(nn.Module):
    """T5 layer norm: rms scaling only, float32 statistics."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        var = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + self.eps)
        return (y * self.weight).to(self.weight.dtype)


class Attention(nn.Module):
    """Multi-head attention projections, T5 semantics (no 1/sqrt(d))."""

    def __init__(self, d_model: int, num_heads: int, d_kv: int):
        super().__init__()
        self.num_heads, self.d_kv = num_heads, d_kv
        inner = num_heads * d_kv
        self.q = nn.Linear(d_model, inner, bias=False)
        self.k = nn.Linear(d_model, inner, bias=False)
        self.v = nn.Linear(d_model, inner, bias=False)
        self.o = nn.Linear(inner, d_model, bias=False)

    def split(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(*x.shape[:-1], self.num_heads, self.d_kv)

    def forward(self, x: torch.Tensor,
                bias: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
                use_kernels: bool = True) -> torch.Tensor:
        """x [B, L, D]; bias is (bias_i8 [B, H, L, L], scales [H],
        key_mask [B, L]) for the int8-slab flash attention."""
        q, k, v = self.split(self.q(x)), self.split(self.k(x)), \
            self.split(self.v(x))
        fn = (flash_attention.flash_attention_bias_i8 if use_kernels
              else flash_attention.plain)
        out = fn(q, k, v, *bias)
        return self.o(out.reshape(*out.shape[:2], -1))


class FeedForward(nn.Module):
    def __init__(self, d_model: int, d_ff: int, proj: str = "relu"):
        super().__init__()
        self.proj = proj
        if proj == "gated-gelu":
            self.wi_0 = nn.Linear(d_model, d_ff, bias=False)
            self.wi_1 = nn.Linear(d_model, d_ff, bias=False)
        else:
            self.wi = nn.Linear(d_model, d_ff, bias=False)
        self.wo = nn.Linear(d_ff, d_model, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.proj == "gated-gelu":
            h = F.gelu(self.wi_0(x), approximate="tanh") * self.wi_1(x)
        else:
            h = F.relu(self.wi(x))
        return self.wo(h)


class EncoderLayer(nn.Module):
    def __init__(self, d_model, num_heads, d_kv, d_ff, ff_proj="relu",
                 eps=1e-6):
        super().__init__()
        self.ln_attn = RMSNorm(d_model, eps)
        self.attn = Attention(d_model, num_heads, d_kv)
        self.ln_ff = RMSNorm(d_model, eps)
        self.ff = FeedForward(d_model, d_ff, ff_proj)

    def forward(self, x, bias, use_kernels: bool = True):
        x = x + self.attn(self.ln_attn(x), bias, use_kernels)
        return x + self.ff(self.ln_ff(x))


class Encoder(nn.Module):
    def __init__(self, num_layers, d_model, num_heads, d_kv, d_ff,
                 ff_proj="relu", eps=1e-6):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer_{i}", EncoderLayer(
                d_model, num_heads, d_kv, d_ff, ff_proj, eps))
        self.final_ln = RMSNorm(d_model, eps)

    def forward(self, x, bias, use_kernels: bool = True):
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, bias, use_kernels)
        return self.final_ln(x)


class DecoderLayer(nn.Module):
    def __init__(self, d_model, num_heads, d_kv, d_ff, ff_proj="relu",
                 eps=1e-6):
        super().__init__()
        self.num_heads, self.d_kv, self.ff_proj = num_heads, d_kv, ff_proj
        self.ln_self = RMSNorm(d_model, eps)
        self.self_attn = Attention(d_model, num_heads, d_kv)
        self.ln_cross = RMSNorm(d_model, eps)
        self.cross_attn = Attention(d_model, num_heads, d_kv)
        self.ln_ff = RMSNorm(d_model, eps)
        self.ff = FeedForward(d_model, d_ff, ff_proj)

    def init_cache(self, enc: torch.Tensor, max_len: int) -> Cache:
        """Quantise the cross K/V once; allocate empty int4 self rings."""
        batch, kv_len, _ = enc.shape
        hd = self.num_heads * self.d_kv
        dev = enc.device
        cache = {
            "self_k_q4": torch.zeros((batch, max_len, hd // 2),
                                     dtype=torch.int8, device=dev),
            "self_v_q4": torch.zeros((batch, max_len, hd // 2),
                                     dtype=torch.int8, device=dev),
            "self_k_s": torch.zeros((batch, self.num_heads, max_len),
                                    dtype=torch.bfloat16, device=dev),
            "self_v_s": torch.zeros((batch, self.num_heads, max_len),
                                    dtype=torch.bfloat16, device=dev),
        }
        kpad = (-kv_len) % 256
        for name, lin in (("cross_k", self.cross_attn.k),
                          ("cross_v", self.cross_attn.v)):
            q, s = quantize_kv4(self.cross_attn.split(lin(enc)))
            q = F.pad(q.reshape(batch, kv_len, hd), (0, 0, 0, kpad))
            cache[name + "_q4"] = mxu_decode.pack_int4(q)
            cache[name + "_s"] = F.pad(s, (0, 0, 0, kpad)).transpose(
                1, 2).to(torch.bfloat16).contiguous()
        return cache

    def quantize_weights(self) -> Dict[str, torch.Tensor]:
        qw: Dict[str, torch.Tensor] = {}
        sa, ca = self.self_attn, self.cross_attn
        qkv = torch.cat([sa.q.weight, sa.k.weight, sa.v.weight], dim=0)
        qw["qkv_q"], qw["qkv_s"] = quantize_w(qkv)
        qw["self_o_q"], qw["self_o_s"] = quantize_w(sa.o.weight)
        qw["cross_q_q"], qw["cross_q_s"] = quantize_w(ca.q.weight)
        qw["cross_o_q"], qw["cross_o_s"] = quantize_w(ca.o.weight)
        names = ("wi_0", "wi_1", "wo") if self.ff_proj == "gated-gelu" \
            else ("wi", "wo")
        for name in names:
            qw[name + "_q"], qw[name + "_s"] = quantize_w(
                getattr(self.ff, name).weight)
        return qw

    def _ff_decode(self, h: torch.Tensor, qw) -> torch.Tensor:
        if self.ff_proj == "gated-gelu":
            a = F.gelu(qlinear(h, qw["wi_0_q"], qw["wi_0_s"]),
                       approximate="tanh")
            mid = a * qlinear(h, qw["wi_1_q"], qw["wi_1_s"])
        else:
            mid = F.relu(qlinear(h, qw["wi_q"], qw["wi_s"]))
        return qlinear(mid, qw["wo_q"], qw["wo_s"])

    def decode_step(self, x: torch.Tensor, cache: Cache, step: int,
                    self_bias_row: torch.Tensor, cross_bias: torch.Tensor,
                    qw: Dict[str, torch.Tensor],
                    use_kernels: bool = True) -> torch.Tensor:
        """x [B, 1, D]; self_bias_row [1, H, S] f32 (causal row); cross_bias
        [B, 1, Kp] f32. Writes this step's K/V into the rings in place."""
        attend = (mxu_decode.cross_decode_mxu_int4 if use_kernels
                  else mxu_decode.plain)
        batch = x.shape[0]
        hd = self.num_heads * self.d_kv
        h = self.ln_self(x)
        qkv = qlinear(h, qw["qkv_q"], qw["qkv_s"])            # [B, 1, 3*HD]
        q, k_new, v_new = (self.self_attn.split(t)
                           for t in qkv.split(hd, dim=-1))
        for kind, t in (("k", k_new), ("v", v_new)):
            tq, ts = quantize_kv4(t)                          # [B,1,H,Dk]
            cache[f"self_{kind}_q4"][:, step] = mxu_decode.pack_int4(
                tq.reshape(batch, 1, hd))[:, 0]
            cache[f"self_{kind}_s"][:, :, step] = ts[:, 0].to(torch.bfloat16)
        out = attend(q[:, 0], cache["self_k_q4"], cache["self_k_s"],
                     cache["self_v_q4"], cache["self_v_s"], self_bias_row)
        x = x + qlinear(out.reshape(batch, 1, hd), qw["self_o_q"],
                        qw["self_o_s"])
        h = self.ln_cross(x)
        q = self.cross_attn.split(qlinear(h, qw["cross_q_q"],
                                          qw["cross_q_s"]))
        out = attend(q[:, 0], cache["cross_k_q4"], cache["cross_k_s"],
                     cache["cross_v_q4"], cache["cross_v_s"], cross_bias)
        x = x + qlinear(out.reshape(batch, 1, hd), qw["cross_o_q"],
                        qw["cross_o_s"])
        return x + self._ff_decode(self.ln_ff(x), qw)


class Decoder(nn.Module):
    def __init__(self, num_layers, d_model, num_heads, d_kv, d_ff,
                 ff_proj="relu", eps=1e-6):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer_{i}", DecoderLayer(
                d_model, num_heads, d_kv, d_ff, ff_proj, eps))
        self.final_ln = RMSNorm(d_model, eps)

    def layers(self) -> List[DecoderLayer]:
        return [getattr(self, f"layer_{i}") for i in range(self.num_layers)]

    def init_cache(self, enc: torch.Tensor, max_len: int) -> List[Cache]:
        return [layer.init_cache(enc, max_len) for layer in self.layers()]

    def quantize_weights(self):
        return [layer.quantize_weights() for layer in self.layers()]

    def decode_step(self, x, caches, step, self_bias_row, cross_bias, qw,
                    use_kernels: bool = True) -> torch.Tensor:
        for layer, cache, lqw in zip(self.layers(), caches, qw):
            x = layer.decode_step(x, cache, step, self_bias_row, cross_bias,
                                  lqw, use_kernels)
        return self.final_ln(x)
