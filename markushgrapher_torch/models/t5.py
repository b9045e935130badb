"""T5-style transformer stack (the UDOP backbone): port of
`markushgrapher_tpu.models.t5`: the serving encoder and decode step, and the
full-sequence training forwards (`train_forward`).

Pre-RMSNorm blocks (float32 statistics), attention without 1/sqrt(d)
scaling, relu (or gated-gelu) feed-forward. Module and parameter names follow
the flax tree (`layer_{i}`, `ln_attn`, `attn.{q,k,v,o}`, ...) so
`convert.from_jax` maps one onto the other; weights use torch's Linear
layout [out, in].

The decode step serves the reference's KV schemes (`init_cache`):
  - float (quant_cross off): cross K/V [B, K, H, D] and self caches
    [rows, S, H, D] in the model's dtype; attention is float32 scores and
    softmax with the probabilities in the cache dtype for the PV product,
    the reference's einsums (`dense_attention`, plain matmuls);
  - int8 (quant_cross, the reference's default quantised KV): cross K/V
    slabs [B, Kp, H*D] int8 with f32 scales [B, H, Kp]; self rings of the
    same layout [rows, S, H*D] / [rows, H, S]; every decode attention through
    `ops.mxu_decode.cross_decode_mxu`;
  - int4 (quant_cross and the model's `int4_cross`): the same slabs and rings
    nibble-packed (`pack_int4` column split, [.., H*D/2]) with bf16 scales;
    every decode attention through `ops.mxu_decode.cross_decode_mxu_int4`.
    The rings are separate K and V tensors (the reference's greedy path
    keeps one combined k||v ring, a TPU layout choice; the math is the
    same).
The quantised schemes quantise per (token, head); the cross key axis is
padded to a 256-multiple (zero scales, masked by the -1e9 cross bias). The
self caches are written in place at each step. Quantised cross slabs keep
one row per sample while the self rings carry `self_rows` rows (batch *
beams under beam search): the beam cross folds the beams into the kernel's
query rows with a `head_map`, so every beam of a sample reads its shared
slab in one pass. Float caches are tiled per beam, as the reference's.
Beam search may keep the quantised rings as copy-on-write segments read
through a row map (`reorder_self_rings`, the `row_map` and `lattice`
options of the decode step), and `block_skip` reads only the rings' valid
prefix (`DecoderLayer._self_attend_quant`). The
decode-step matmuls run against the modules' weights, or (quant_weights)
against weights quantised per output channel (`quantize_weights`: int8 or
int4 codes, or W8A8 with the activations quantised per row), each
projection one call of `ops.wq_linear` (`qlinear`).

Training (`train_forward`, grad-enabled): dropout at the reference's sites
(after the feed-forward activation, on each sub-layer output before its
residual add, and on the stacks' inputs and final norms), with keep masks
drawn from a `torch.Generator` seeded per layer, so a layer recomputed under
`torch.utils.checkpoint` (the reference's `remat`) draws the same masks.
Encoder self-attention on long rows (L > 512, a 256-multiple, the
reference's `_train_chunk_q` gate) goes through the trainable flash kernels
(`ops.flash_attention.flash_attention_train`); every other attention is the
dense float32-score softmax. Under bf16 autocast the matmuls run in bf16
over float32 weights; scores, softmax and norms stay float32.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from markushgrapher_torch.ops import (flash_attention, flash_relbias,
                                      mxu_decode, wq_linear)
from markushgrapher_torch.ops.wq_linear import quantize_w  # noqa: F401

Cache = Dict[str, torch.Tensor]


def quantize_kv(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) symmetric int8 of [..., D]: values in
    [-127, 127], float32 scales max|t| / 127 of shape [...]."""
    tf = t.to(torch.float32)
    scale = tf.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-8
    q = torch.round(tf / scale).to(torch.int8)
    return q, scale[..., 0]


def quantize_kv4(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) symmetric int4 of [..., D]: values in [-7, 7]
    (int8 storage), float32 scales max|t| / 7 of shape [...]."""
    tf = t.to(torch.float32)
    scale = tf.abs().amax(dim=-1, keepdim=True) / 7.0 + 1e-8
    q = torch.round(tf / scale).clamp(-7, 7).to(torch.int8)
    return q, scale[..., 0]


def quant_marks(bits: int, act: bool) -> Dict:
    """A decode layer's quantised-weight dict before its weights: the bit
    width and the W8A8 mark (JAX's `act_s8`), which needs int8 weights."""
    if act and bits != 8:
        raise ValueError("act-quantized decode dots require int8 weights "
                         f"(got bits={bits})")
    return {"bits": bits, "act_s8": act}


def qlinear(x: torch.Tensor, qw: Dict, key: str,
            use_kernels: bool = True) -> torch.Tensor:
    """x against the quantised weight `key` of a layer's dict (its codes
    key_q, scales key_s, the dict's bit width and W8A8 mark) through
    `ops.wq_linear`, or its plain version on any device when not
    use_kernels."""
    fn = wq_linear.wq_linear if use_kernels else wq_linear.wq_linear_plain
    return fn(x, qw[key + "_q"], qw[key + "_s"], qw["bits"], qw["act_s8"])


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

    def forward(self, x: torch.Tensor, bias,
                use_kernels: bool = True) -> torch.Tensor:
        """Serving self-attention of x [B, L, D] under one of the three bias
        forms the reference's `Attention.__call__` routes to a flash kernel:
          - a tuple (bias_i8 [B, H, L, L], scales [H], key_mask [B, L]): the
            int8 slab, `flash_attention.flash_attention_bias_i8`;
          - a float tensor [B or 1, H, L, L] (additive, key mask in it): the
            float slab, `flash_attention.flash_attention_bias`;
          - a dict of `flash_relbias.flash_attention_relbias` keyword
            arguments (hx, vy, mask, the three tables, the distances): the
            bias computed inside the kernel.
        use_kernels=False takes each kernel's plain version."""
        q, k, v = self.split(self.q(x)), self.split(self.k(x)), \
            self.split(self.v(x))
        if isinstance(bias, dict):
            fn = (flash_relbias.flash_attention_relbias if use_kernels
                  else flash_relbias.plain)
            out = fn(q, k, v, **bias)
        elif isinstance(bias, tuple):
            fn = (flash_attention.flash_attention_bias_i8 if use_kernels
                  else flash_attention.plain)
            out = fn(q, k, v, *bias)
        else:
            fn = (flash_attention.flash_attention_bias if use_kernels
                  else flash_attention.plain_bias)
            out = fn(q, k, v, bias)
        return self.o(out.reshape(*out.shape[:2], -1))

    def attend(self, x: torch.Tensor, bias: Optional[torch.Tensor],
               kv_input: Optional[torch.Tensor] = None,
               flash: bool = False) -> torch.Tensor:
        """Training attention over x (self) or kv_input (cross); bias
        broadcastable to [B, H, Q, K] (additive, mask included)."""
        src = x if kv_input is None else kv_input
        q, k, v = self.split(self.q(x)), self.split(self.k(src)), \
            self.split(self.v(src))
        if flash:
            out = flash_attention.flash_attention_train(q, k, v, bias)
        else:
            out = dense_attention(q, k, v, bias)
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

    def forward(self, x: torch.Tensor, rate: float = 0.0,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """Dropout (`rate`, masks from `gen`) on the hidden activation when
        training; none without a generator."""
        if self.proj == "gated-gelu":
            h = F.gelu(self.wi_0(x), approximate="tanh") * self.wi_1(x)
        else:
            h = F.relu(self.wi(x))
        return self.wo(dropout(h, rate, gen))


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

    def train_forward(self, x, bias, seed: Optional[int], rate: float,
                      flash: bool):
        gen = layer_generator(seed, x.device)
        h = self.attn.attend(self.ln_attn(x), bias, flash=flash)
        x = x + dropout(h, rate, gen)
        h = self.ff(self.ln_ff(x), rate, gen)
        return x + dropout(h, rate, gen)


class Encoder(nn.Module):
    def __init__(self, num_layers, d_model, num_heads, d_kv, d_ff,
                 ff_proj="relu", eps=1e-6, dropout_rate: float = 0.0):
        super().__init__()
        self.num_layers, self.num_heads = num_layers, num_heads
        self.dropout_rate = dropout_rate
        for i in range(num_layers):
            self.add_module(f"layer_{i}", EncoderLayer(
                d_model, num_heads, d_kv, d_ff, ff_proj, eps))
        self.final_ln = RMSNorm(d_model, eps)

    def forward(self, x, bias, use_kernels: bool = True):
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, bias, use_kernels)
        return self.final_ln(x)

    def train_forward(self, x: torch.Tensor, bias: torch.Tensor,
                      deterministic: bool,
                      generator: Optional[torch.Generator] = None,
                      remat: bool = False) -> torch.Tensor:
        """x [B, L, D]; bias [B or 1, H, L, L] additive (mask included).
        Dropout masks come from `generator` unless deterministic."""
        rate = self.dropout_rate
        generator = training_generator(deterministic, rate, generator)
        length = x.shape[1]
        flash = not deterministic and use_train_flash(length, length, bias,
                                                      self.num_heads)
        x = dropout(x, rate, layer_generator(draw_seed(generator), x.device))
        for i in range(self.num_layers):
            x = run_layer(getattr(self, f"layer_{i}").train_forward, remat,
                          x, bias, draw_seed(generator), rate, flash)
        x = self.final_ln(x)
        return dropout(x, rate, layer_generator(draw_seed(generator),
                                                x.device))


# -- training helpers ----------------------------------------------------------


def draw_seed(generator: Optional[torch.Generator]) -> Optional[int]:
    """A 62-bit seed from a host generator (None stays None)."""
    if generator is None:
        return None
    return int(torch.randint(0, 2 ** 62, (1,), generator=generator))


def training_generator(deterministic: bool, rate: float,
                       generator: Optional[torch.Generator]
                       ) -> Optional[torch.Generator]:
    """The host generator the dropout seeds come from: None when
    deterministic or the rate is 0; raises when dropout needs one and none
    was given (as flax does without a dropout rng)."""
    if deterministic or rate == 0.0:
        return None
    if generator is None:
        raise ValueError("dropout with deterministic=False needs a "
                         "torch.Generator")
    return generator


def layer_generator(seed: Optional[int],
                    device: torch.device) -> Optional[torch.Generator]:
    if seed is None:
        return None
    return torch.Generator(device=device).manual_seed(seed)


def dropout(x: torch.Tensor, rate: float,
            gen: Optional[torch.Generator]) -> torch.Tensor:
    """flax `nn.Dropout`: keep each entry with probability 1 - rate and
    scale it by 1 / (1 - rate); identity when gen is None (deterministic)
    or rate is 0."""
    if gen is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def run_layer(fn, remat: bool, *args):
    """fn(*args), recomputed in backward instead of saving its activations
    when remat (the reference's per-layer `nn.remat`)."""
    if remat and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    return fn(*args)


def train_chunk_q(q_len: int) -> Optional[int]:
    """The reference's long-row training gate (`_train_chunk_q`): rows
    longer than 512 that are 256-multiples."""
    return 256 if q_len > 512 and q_len % 256 == 0 else None


def use_train_flash(q_len: int, k_len: int, bias: Optional[torch.Tensor],
                    heads: int) -> bool:
    """Long rows with a full [*, H, Q, K] bias take the trainable flash
    kernels (`_train_chunk_q` and `_train_flash_ok` of the reference)."""
    return (train_chunk_q(q_len) is not None and k_len % 128 == 0
            and bias is not None and bias.dim() == 4
            and tuple(bias.shape[1:]) == (heads, q_len, k_len))


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor]) -> torch.Tensor:
    """q [B, Q, H, D], k / v [B, K, H, D]: float32 scores plus the bias,
    float32 softmax, probabilities cast to v's dtype for the PV product
    (the reference's dense attention, t5.py:401-407)."""
    ct = torch.promote_types(q.dtype, torch.float32)
    with torch.autocast(q.device.type, enabled=False):
        s = torch.einsum("bqhd,bkhd->bhqk", q.to(ct), k.to(ct))
        if bias is not None:
            s = s + bias.to(ct)
        p = torch.softmax(s, dim=-1).to(v.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", p, v)


def reorder_self_rings(caches: List[Cache], parent: torch.Tensor,
                       start: int, length: int) -> None:
    """Beam reorder of every layer's self caches, in place: row i takes row
    parent[i]'s positions [start, start + length).
      - The live-prefix form (start 0, length step + 1): positions past the
        decode index are still the unwritten zeros in every row, so
        reordering them would change nothing (the reference's whole-ring
        copy-on-write with one segment, `_cow_rings_prefix`, and its
        whole-cache gather of float caches).
      - The copy-on-write form (`_cow_rings`): only the segment that the
        next step writes; the earlier segments stay where they are and are
        read through the beam's row map."""
    for cache in caches:
        for name, ring in cache.items():
            if name.startswith("self_"):
                # values [rows, S, width] or [rows, S, H, D], scales
                # [rows, H, S]
                part = ring.narrow(2 if name.endswith("_s") else 1, start,
                                   length)
                part.copy_(part.index_select(0, parent))


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

    def train_forward(self, x, enc, self_bias, cross_bias,
                      seed: Optional[int], rate: float):
        """Teacher-forced full-sequence pass (dense attention)."""
        gen = layer_generator(seed, x.device)
        h = self.self_attn.attend(self.ln_self(x), self_bias)
        x = x + dropout(h, rate, gen)
        h = self.cross_attn.attend(self.ln_cross(x), cross_bias, kv_input=enc)
        x = x + dropout(h, rate, gen)
        h = self.ff(self.ln_ff(x), rate, gen)
        return x + dropout(h, rate, gen)

    def init_cache(self, enc: torch.Tensor, max_len: int, quant_cross: bool,
                   int4_cross: bool, rows: int) -> Cache:
        """Project the cross K/V once over enc's rows; allocate empty self
        caches of `rows` rows. Without quant_cross: float cross_k / cross_v
        [B, K, H, D] and self_k / self_v [rows, max_len, H, D] in enc's
        dtype. With it: quantised slabs ([B] rows) and rings, int4 or int8
        by `int4_cross`."""
        batch, kv_len, _ = enc.shape
        heads = self.num_heads
        dev = enc.device
        if not quant_cross:
            zeros = torch.zeros((rows, max_len, heads, self.d_kv),
                                dtype=enc.dtype, device=dev)
            return {"cross_k": self.cross_attn.split(self.cross_attn.k(enc)),
                    "cross_v": self.cross_attn.split(self.cross_attn.v(enc)),
                    "self_k": zeros, "self_v": zeros.clone()}
        hd = heads * self.d_kv
        width, sdt, quant = ((hd // 2, torch.bfloat16, quantize_kv4)
                             if int4_cross else
                             (hd, torch.float32, quantize_kv))
        suffix = "_q4" if int4_cross else "_q"
        cache = {}
        for kind in ("k", "v"):
            cache[f"self_{kind}{suffix}"] = torch.zeros(
                (rows, max_len, width), dtype=torch.int8, device=dev)
            cache[f"self_{kind}_s"] = torch.zeros(
                (rows, heads, max_len), dtype=sdt, device=dev)
        kpad = (-kv_len) % 256
        for name, lin in (("cross_k", self.cross_attn.k),
                          ("cross_v", self.cross_attn.v)):
            q, s = quant(self.cross_attn.split(lin(enc)))
            q = F.pad(q.reshape(batch, kv_len, hd), (0, 0, 0, kpad))
            cache[name + suffix] = (mxu_decode.pack_int4(q) if int4_cross
                                    else q)
            cache[name + "_s"] = F.pad(s, (0, 0, 0, kpad)).transpose(
                1, 2).to(sdt).contiguous()
        return cache

    def quantize_weights(self, bits: int = 8, act: bool = False) -> Dict:
        """The decode step's weights quantised per output channel
        (`ops.wq_linear.quantize_w`): int8 codes, or int4 at bits=4; act
        marks W8A8 (int8 weights only, JAX's ValueError otherwise). q / k /
        v stack along the output rows, and under gated-gelu so do wi_0 /
        wi_1: one product each, whose activation W8A8 quantises once, as
        JAX's `_ff_decode` does for both wi dots."""
        qw = quant_marks(bits, act)
        sa, ca = self.self_attn, self.cross_attn
        ff = self.ff
        wi = (torch.cat([ff.wi_0.weight, ff.wi_1.weight], dim=0)
              if self.ff_proj == "gated-gelu" else ff.wi.weight)
        for key, w in (("qkv", torch.cat([sa.q.weight, sa.k.weight,
                                          sa.v.weight], dim=0)),
                       ("self_o", sa.o.weight), ("cross_q", ca.q.weight),
                       ("cross_o", ca.o.weight), ("wi", wi),
                       ("wo", ff.wo.weight)):
            qw[key + "_q"], qw[key + "_s"] = quantize_w(w, bits)
        return qw

    def _ff_decode(self, h: torch.Tensor, qw,
                   use_kernels: bool) -> torch.Tensor:
        if qw is None:
            return self.ff(h)
        y = qlinear(h, qw, "wi", use_kernels)
        if self.ff_proj == "gated-gelu":
            a, g = y.chunk(2, dim=-1)
            mid = F.gelu(a, approximate="tanh") * g
        else:
            mid = F.relu(y)
        return qlinear(mid, qw, "wo", use_kernels)

    @staticmethod
    def _proj(attn: "Attention", name: str, h: torch.Tensor, qw, key: str,
              use_kernels: bool) -> torch.Tensor:
        """Projection `name` of `attn` on h: the module's weight, or the
        quantised weight qw[key] when the decode weights are quantised."""
        if qw is None:
            return getattr(attn, name)(h)
        return qlinear(h, qw, key, use_kernels)

    def _write_ring(self, cache: Cache, step: int, k_new: torch.Tensor,
                    v_new: torch.Tensor) -> None:
        """Quantise this step's K/V rows [rows, 1, H, Dk] into the self
        rings at position `step`, in place."""
        rows = k_new.shape[0]
        hd = self.num_heads * self.d_kv
        int4 = "self_k_q4" in cache
        for kind, t in (("k", k_new), ("v", v_new)):
            tq, ts = (quantize_kv4 if int4 else quantize_kv)(t)
            tq = tq.reshape(rows, hd)
            if int4:
                cache[f"self_{kind}_q4"][:, step] = mxu_decode.pack_int4(tq)
            else:
                cache[f"self_{kind}_q"][:, step] = tq
            scales = cache[f"self_{kind}_s"]
            scales[:, :, step] = ts[:, 0].to(scales.dtype)

    def _attend_fn(self, cache: Cache, use_kernels: bool):
        if "self_k_q4" in cache:
            return (mxu_decode.cross_decode_mxu_int4 if use_kernels
                    else mxu_decode.plain_int4), "_q4"
        return (mxu_decode.cross_decode_mxu if use_kernels
                else mxu_decode.plain_int8), "_q"

    def _self_attend_quant(self, q, cache: Cache, step: int,
                           self_bias_row: torch.Tensor, use_kernels: bool,
                           row_map: Optional[torch.Tensor], block_skip: bool,
                           lattice: bool) -> torch.Tensor:
        """Self-attention over the quantised rings, the kernel chosen as the
        reference's `_self_attend_quant`: under a row map (beam search's
        copy-on-write segments) key blocks of one segment, composed with
        the valid prefix under block_skip; under block_skip alone blocks of
        128 keys and the valid prefix; with the lattice (int4 rings) only
        the live segments, each read through the map."""
        attend, suffix = self._attend_fn(cache, use_kernels)
        ring_len = cache["self_k" + suffix].shape[1]
        kw: Dict = {}
        if row_map is not None:
            seg = ring_len // row_map.shape[1]
            if lattice and suffix == "_q4":
                lattice_fn = (mxu_decode.lattice_self_int4 if use_kernels
                              else mxu_decode.plain_lattice_int4)
                return lattice_fn(q, cache["self_k_q4"], cache["self_k_s"],
                                  cache["self_v_q4"], cache["self_v_s"],
                                  self_bias_row, row_map, step // seg + 1,
                                  seg)
            kw = dict(row_map=row_map, block_k=seg)
            if block_skip:
                kw.update(mxu_decode.valid_prefix_blocks(ring_len, step, seg))
        elif block_skip:
            kw = mxu_decode.valid_prefix_blocks(ring_len, step, 128)
        return attend(q, cache["self_k" + suffix], cache["self_k_s"],
                      cache["self_v" + suffix], cache["self_v_s"],
                      self_bias_row, **kw)

    def decode_step(self, x: torch.Tensor, cache: Cache, step: int,
                    self_bias_row: torch.Tensor, cross_bias: torch.Tensor,
                    qw: Optional[Dict[str, torch.Tensor]],
                    use_kernels: bool = True,
                    row_map: Optional[torch.Tensor] = None,
                    block_skip: bool = False,
                    lattice: bool = False) -> torch.Tensor:
        """x [rows, 1, D]; self_bias_row [1, H, S] f32 (causal row);
        cross_bias [B, 1, K] f32 over the cross caches' rows (rows = B *
        beams for quantised slabs, which beams share; B = rows for float
        caches, tiled per beam). qw: quantised decode weights
        (`quantize_weights`), or None for the module's own. row_map (int32
        [rows, n_seg]): ring segment s of row b lives in row row_map[b, s]
        (beam search's copy-on-write rings; the segment being written is
        always b's own); block_skip: read the rings' valid prefix only;
        lattice: read int4 rings under a row map segment by segment
        (`_self_attend_quant`). Writes this step's K/V into the self caches
        in place."""
        rows = x.shape[0]
        heads, dk = self.num_heads, self.d_kv
        hd = heads * dk
        sa, ca = self.self_attn, self.cross_attn
        h = self.ln_self(x)
        if qw is None:
            q, k_new, v_new = (sa.split(lin(h)) for lin in (sa.q, sa.k, sa.v))
        else:
            qkv = qlinear(h, qw, "qkv", use_kernels)         # [rows,1,3HD]
            q, k_new, v_new = (sa.split(t) for t in qkv.split(hd, dim=-1))
        if "self_k" in cache:
            # float caches: float32 scores, softmax, probabilities in the
            # cache dtype for the PV product (the reference's einsums)
            cache["self_k"][:, step] = k_new[:, 0]
            cache["self_v"][:, step] = v_new[:, 0]
            out = dense_attention(q, cache["self_k"], cache["self_v"],
                                  self_bias_row[:, :, None, :])
        else:
            self._write_ring(cache, step, k_new, v_new)
            out = self._self_attend_quant(q[:, 0], cache, step,
                                          self_bias_row, use_kernels,
                                          row_map, block_skip, lattice)
        x = x + self._proj(sa, "o", out.reshape(rows, 1, hd), qw, "self_o",
                           use_kernels)
        q = self._proj(ca, "q", self.ln_cross(x), qw, "cross_q",
                       use_kernels)                           # [rows,1,HD]
        if "cross_k" in cache:
            out = dense_attention(ca.split(q), cache["cross_k"],
                                  cache["cross_v"], cross_bias[:, :, None, :])
        else:
            attend, suffix = self._attend_fn(cache, use_kernels)
            slab_rows = cache["cross_k" + suffix].shape[0]
            beams = rows // slab_rows
            # beams fold into the query rows: row (beam, head) reads the
            # shared slab's column block `head`
            head_map = None if beams == 1 else tuple(range(heads)) * beams
            out = attend(q.reshape(slab_rows, beams * heads, dk),
                         cache["cross_k" + suffix], cache["cross_k_s"],
                         cache["cross_v" + suffix], cache["cross_v_s"],
                         cross_bias, head_map=head_map)
        x = x + self._proj(ca, "o", out.reshape(rows, 1, hd), qw, "cross_o",
                           use_kernels)
        return x + self._ff_decode(self.ln_ff(x), qw, use_kernels)


class Decoder(nn.Module):
    def __init__(self, num_layers, d_model, num_heads, d_kv, d_ff,
                 ff_proj="relu", eps=1e-6, dropout_rate: float = 0.0):
        super().__init__()
        self.num_layers = num_layers
        self.dropout_rate = dropout_rate
        for i in range(num_layers):
            self.add_module(f"layer_{i}", DecoderLayer(
                d_model, num_heads, d_kv, d_ff, ff_proj, eps))
        self.final_ln = RMSNorm(d_model, eps)

    def layers(self) -> List[DecoderLayer]:
        return [getattr(self, f"layer_{i}") for i in range(self.num_layers)]

    def train_forward(self, x, enc, self_bias, cross_bias,
                      deterministic: bool,
                      generator: Optional[torch.Generator] = None,
                      remat: bool = False) -> torch.Tensor:
        rate = self.dropout_rate
        generator = training_generator(deterministic, rate, generator)
        x = dropout(x, rate, layer_generator(draw_seed(generator), x.device))
        for layer in self.layers():
            x = run_layer(layer.train_forward, remat, x, enc, self_bias,
                          cross_bias, draw_seed(generator), rate)
        x = self.final_ln(x)
        return dropout(x, rate, layer_generator(draw_seed(generator),
                                                x.device))

    def init_cache(self, enc: torch.Tensor, max_len: int, quant_cross: bool,
                   int4_cross: bool, rows: int) -> List[Cache]:
        return [layer.init_cache(enc, max_len, quant_cross, int4_cross, rows)
                for layer in self.layers()]

    def quantize_weights(self, bits: int = 8, act: bool = False):
        return [layer.quantize_weights(bits, act) for layer in self.layers()]

    def decode_step(self, x, caches, step, self_bias_row, cross_bias, qw,
                    use_kernels: bool = True,
                    row_map: Optional[torch.Tensor] = None,
                    block_skip: bool = False,
                    lattice: bool = False) -> torch.Tensor:
        """qw: the per-layer quantised weights, or None for the modules' own;
        row_map / block_skip / lattice as `DecoderLayer.decode_step`."""
        for layer, cache, lqw in zip(self.layers(), caches,
                                     qw or [None] * self.num_layers):
            x = layer.decode_step(x, cache, step, self_bias_row, cross_bias,
                                  lqw, use_kernels, row_map, block_skip,
                                  lattice)
        return self.final_ln(x)
