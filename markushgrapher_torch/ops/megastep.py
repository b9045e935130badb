"""One whole ChemicalOCR LM decode step, every layer, in one launch: the CUDA
kernel `csrc/ocr_megastep.cu`, its wrapper, its plain version, and the
stacked weight layout it reads.

Replaces `markushgrapher_tpu/ops/megastep.py:ocr_megastep` (with the ring
writes of `ChemicalOCRModel.decode_step_mega`). Per layer, for each batch
row, with the int8 per-output-channel weights of `LMLayer.quantize_weights`:

  1. h = bf16(rms(x) * ln_attn)
  2. q / k / v = (h . W) * scale, float32 sums of bf16 x int8 products
  3. RoPE at position p: x * cos + rotate_half(bf16(x)) * sin (the rotated
     half from the bf16-rounded values, the cosine half from float32)
  4. the new k / v rows quantised per kv head to int8, scale max|t| / 127
     + 1e-8, and written into the rings at column p
  5. attention of qs = bf16(q / sqrt(d)) over ring columns < p: s = (qs .
     k_int8) * k_scale, m = max s, w = exp(s - m), acc = sum bf16(w *
     v_scale) * v_int8; then the new token's column from its dequantised
     k / v: s' = qs . k_deq, m' = max(m, s'), acc = acc * e^(m - m') +
     e^(s' - m') v_deq, l likewise; out = bf16(acc / l)
  6. x += (out . W_o) * scale
  7. h = bf16(rms(x) * ln_mlp); mid = bf16(silu(g) * u) with g / u as in
     2; x += (mid . W_down) * scale
The residual x stays float32 from layer to layer; the step returns bf16(x).
These are the JAX kernel's rounding points. Its ring attention is an online
softmax over ring blocks; with one block (the JAX choice for rings up to
8 MB of K+V, which covers the OCR rings) it is the two-part form above.

Each float32 sum is taken in the CUDA kernel's order and rounding, so that
the plain version rounds every bf16 point (h, the RoPE's rotated half, attn,
mid) as the kernel does: a sum one ulp apart flips a bf16 value now and
then, and one flip of h or mid in a layer moves the next layer's K/V scales
by ~1e-3. The GEMVs and the ring scores add 16 products per tensor-core
step, exactly, into a float32 accumulator rounded toward zero (the tensor
cores' truncation: on an H100, `megastep_parts.py` finds the kernel's QKV
output in all but 0.4 % of values, where round-to-nearest float32 matmuls
differ in 10-29 %), over the kernel's split of the columns among 8 warps,
whose partial sums are then added in order. The RMSNorm statistic,
the softmax's sum, the P V sums and the new token's score follow the
kernel's lane and warp reductions (`_lanes`, `_butterfly`).

Layout (`pack_lm`): weights [L, out, in] int8 (q, k, v rows stacked; gate
rows then up rows), scales [L, out] float32, RMSNorm weights [L, D]
float32; rings k_q / v_q [L, B, S, G*D] int8, k_s / v_s [L, B, G, S]
float32 (`ChemicalOCRModel.stack_caches`). The step writes the rings in
place at column p.

A CPU tensor goes to the plain version; a CUDA tensor goes to the kernel.
"""

from __future__ import annotations

import functools
from typing import Dict, Sequence

import torch

from markushgrapher_torch.ops import _build
from markushgrapher_torch.ops.tensor_core import tc_steps

_THREADS = 256


def pack_lm(qw_layers: Sequence[Dict[str, torch.Tensor]],
            ln_attn: Sequence[torch.Tensor],
            ln_mlp: Sequence[torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Stack per-layer int8 decode weights (`LMLayer.quantize_weights`) and
    RMSNorm weights into the step's [L, ...] arrays."""
    def st(fn):
        return torch.stack([fn(w) for w in qw_layers])

    return {
        "wqkv": st(lambda w: w["qkv_q"]), "sqkv": st(lambda w: w["qkv_s"]),
        "wo": st(lambda w: w["o_q"]), "so": st(lambda w: w["o_s"]),
        "wgu": st(lambda w: w["gu_q"]), "sgu": st(lambda w: w["gu_s"]),
        "wd": st(lambda w: w["down_q"]), "sd": st(lambda w: w["down_s"]),
        "ln_attn": torch.stack(list(ln_attn)).to(torch.float32),
        "ln_mlp": torch.stack(list(ln_mlp)).to(torch.float32),
    }


def rope_rows(rope: torch.Tensor, pos: int):
    """(cos [d], sin [d]) float32 rows of the [P, d/2, 2] table at `pos`,
    per-half frequencies (the kernel reads the same table row)."""
    r = rope[pos]
    return torch.cat([r[:, 0], r[:, 0]]), torch.cat([r[:, 1], r[:, 1]])


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


# the kernel's warps and threads per block
_WARPS = _THREADS // 32


def _butterfly(v: torch.Tensor, offsets) -> torch.Tensor:
    """The sum over the last dim that lane 0 holds after xor shuffles by
    `offsets`, in that order (each lane adds its partner's value)."""
    idx = torch.arange(v.shape[-1], device=v.device)
    for o in offsets:
        v = v + v[..., idx ^ o]
    return v[..., 0]


def _lanes(v: torch.Tensor, n: int) -> torch.Tensor:
    """[..., K] -> [..., n]: lane j's sum of elements j, j + n, ... in order
    (from 0), as a strided loop over K gives each of n threads; n = 1: the
    sum in order."""
    k = v.shape[-1]
    v = torch.nn.functional.pad(v, (0, -k % n))
    out = torch.zeros(v.shape[:-1] + (n,), dtype=v.dtype, device=v.device)
    for r in range(v.shape[-1] // n):
        out = out + v[..., r * n:(r + 1) * n]
    return out


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """bf16(x rsqrt(mean x^2 + eps) w); the sum of squares as the kernel
    takes it: per 16-column tile over 16 lanes, then the tiles over a
    warp."""
    b, dm = x.shape
    sq = torch.nn.functional.pad(x * x, (0, -dm % 16)).view(b, -1, 16)
    tiles = _butterfly(sq, (8, 4, 2, 1))
    ss = _butterfly(_lanes(tiles, 32), (16, 8, 4, 2, 1))
    var = (ss / dm)[:, None]
    return _bf16(x * torch.rsqrt(var + eps) * w)


@functools.lru_cache(maxsize=None)
def _gemv_steps(k: int) -> torch.Tensor:
    """The columns of each tensor-core step of a GEMV over k columns (k:
    past the end), by warp in issue order: [rounds, 8, 16]. Chunk c of 64
    columns goes to warp c % 8, as four steps of columns 16 t + 4 s + e
    (t, e < 4); the columns past the last chunk in steps of 16, step u to
    warp (chunks + u) % 8."""
    full = k // 64
    per_warp = [[] for _ in range(_WARPS)]
    for c in range(full):
        for s in range(4):
            per_warp[c % _WARPS].append(
                [c * 64 + 16 * t + 4 * s + e for t in range(4)
                 for e in range(4)])
    for u in range(-(-(k - 64 * full) // 16)):
        per_warp[(full + u) % _WARPS].append(
            [min(64 * full + 16 * u + j, k) for j in range(16)])
    rounds = max(len(p) for p in per_warp)
    idx = torch.full((rounds, _WARPS, 16), k, dtype=torch.long)
    for w, steps in enumerate(per_warp):
        if steps:
            idx[:len(steps), w] = torch.tensor(steps)
    return idx


def _tc_dot(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """h [B, K] (bf16 values) . int8 w [N, K]^T as the kernel's GEMV sums
    it: each warp's tensor-core steps (`_gemv_steps`), then the warps'
    partial sums in order. float32 [B, N]."""
    idx = _gemv_steps(h.shape[1]).to(h.device)
    hp = torch.nn.functional.pad(h.to(torch.float64), (0, 1))[:, idx]
    wp = torch.nn.functional.pad(w.to(torch.float64), (0, 1))[:, idx]
    sums = torch.einsum("brwk,nrwk->rbnw", hp, wp)  # exact in float64
    part = tc_steps(torch.zeros_like(sums[0]), sums).to(torch.float32)
    return _lanes(part, 1)[..., 0]


def _rope(t: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    half = t.shape[-1] // 2
    tb = _bf16(t)
    rotated = torch.cat([-tb[..., half:], tb[..., :half]], -1)
    return t * cos + rotated * sin


def _quantize(t: torch.Tensor):
    """Per-(row, kv head) int8 of t [B, G, D]: (codes, scales [B, G],
    dequantised values)."""
    scale = t.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-8
    q = torch.round(t / scale).clamp(-127, 127)
    return q.to(torch.int8), scale[..., 0], q * scale


def _wdot(h: torch.Tensor, w: torch.Tensor, s: torch.Tensor):
    """(h . W^T) * s: bf16-valued float32 rows against int8 [out, in]."""
    return _tc_dot(h, w) * s


def _ring_attention(qs, kr, vr, ks, vs, kdq, vdq):
    """One layer's attention of qs [B, H, D] (bf16 values) over the ring
    prefix kr / vr [B, p, H, D] (int8 values) with scales ks / vs [B, H, p]
    and the new token's dequantised kdq / vdq [B, H, D]: float32 [B, H, D]
    before the bf16 rounding, every sum in the kernel's order."""
    b, heads, d = qs.shape
    p = kr.shape[1]
    if d % 16 == 0:
        # scores on the tensor cores: 16 dims a step, into a zero
        # accumulator rounded toward zero
        sums = torch.stack([torch.einsum(
            "bhd,bkhd->bhk", qs[..., d0:d0 + 16].to(torch.float64),
            kr[..., d0:d0 + 16].to(torch.float64))
            for d0 in range(0, d, 16)])
        c = tc_steps(torch.zeros_like(sums[0]), sums).to(torch.float32)
    else:
        # on the CUDA cores: fma over d in order (the products are exact)
        c = _lanes(qs[:, :, None] * kr.transpose(1, 2), 1)[..., 0]
    s = c * ks
    m = s.amax(dim=-1, keepdim=True) if p else torch.full(
        (b, heads, 1), -torch.inf, device=qs.device)
    e = torch.exp(s - m)
    pv = _bf16(e * vs)
    # l: each thread's strided keys, a warp's lanes, then the warps in order
    den = _lanes(_butterfly(_lanes(e, _THREADS).view(b, heads, _WARPS, 32),
                            (16, 8, 4, 2, 1)), 1)
    # P V: thread (key lane kl, column block) sums keys kl, kl + KL, ...;
    # the key lanes of a warp meet by shuffles, then the warps in order
    cw = 16 if d % 16 == 0 else 4
    cpr = d // cw
    kl_n = _THREADS // cpr
    prod = (pv[..., None] * vr.transpose(1, 2)).transpose(-1, -2)
    acc = _lanes(prod, kl_n).view(b, heads, d, _WARPS, kl_n // _WARPS)
    offsets = [o for o in (1, 2, 4, 8, 16) if o < 32 // cpr]
    o = _lanes(_butterfly(acc, offsets), 1)[..., 0]
    # the new token's score: fma over lanes' strided dims, then the warp
    qd = qs.to(torch.float64) * kdq.to(torch.float64)   # exact
    qd = torch.nn.functional.pad(qd, (0, -d % 32))
    sl = torch.zeros((b, heads, 32), device=qs.device)
    for r in range(qd.shape[-1] // 32):
        sl = (sl.to(torch.float64) + qd[..., r * 32:(r + 1) * 32]).to(
            torch.float32)
    s_new = _butterfly(sl, (16, 8, 4, 2, 1))[..., None]
    m_new = torch.maximum(m, s_new)
    alpha = torch.exp(m - m_new)
    p_new = torch.exp(s_new - m_new)
    return (o * alpha + p_new * vdq) / (den * alpha + p_new).clamp(
        min=1e-30)


def plain_megastep(x: torch.Tensor, rings: Dict[str, torch.Tensor],
                   w: Dict[str, torch.Tensor], rope: torch.Tensor, pos: int,
                   *, heads: int, groups: int, rms_eps: float
                   ) -> torch.Tensor:
    """Plain version of the step (module docstring): x [B, Dm] -> bf16
    [B, Dm]; writes the rings at column `pos`."""
    n_layers = w["wqkv"].shape[0]
    b = x.shape[0]
    dq = w["wo"].shape[2]
    d = dq // heads
    dkv = groups * d
    f = w["wd"].shape[2]
    hm = torch.arange(heads, device=x.device) // (heads // groups)
    cos, sin = rope_rows(rope, pos)
    xs = x.to(torch.float32)
    for layer in range(n_layers):
        h = _rms(xs, w["ln_attn"][layer], rms_eps)
        q, k, v = _wdot(h, w["wqkv"][layer], w["sqkv"][layer]).split(
            [dq, dkv, dkv], dim=-1)
        q = _rope(q.reshape(b, heads, d), cos, sin)
        k = _rope(k.reshape(b, groups, d), cos, sin)
        kq, ks, kdq = _quantize(k)
        vq, vs, vdq = _quantize(v.reshape(b, groups, d))
        qs = _bf16(q * d ** -0.5)                            # [B, H, D]
        kr = rings["k_q"][layer, :, :pos].to(torch.float32).reshape(
            b, pos, groups, d)[:, :, hm]                     # [B, p, H, D]
        vr = rings["v_q"][layer, :, :pos].to(torch.float32).reshape(
            b, pos, groups, d)[:, :, hm]
        attn = _bf16(_ring_attention(
            qs, kr, vr, rings["k_s"][layer, :, :, :pos][:, hm],
            rings["v_s"][layer, :, :, :pos][:, hm], kdq[:, hm], vdq[:, hm]))
        xs = xs + _wdot(attn.reshape(b, dq), w["wo"][layer], w["so"][layer])
        h = _rms(xs, w["ln_mlp"][layer], rms_eps)
        g, u = _wdot(h, w["wgu"][layer], w["sgu"][layer]).split(f, dim=-1)
        mid = _bf16(torch.sigmoid(g) * g * u)
        xs = xs + _wdot(mid, w["wd"][layer], w["sd"][layer])
        for name, vals, sc in (("k", kq, ks), ("v", vq, vs)):
            rings[name + "_q"][layer, :, pos] = vals.reshape(b, dkv)
            rings[name + "_s"][layer, :, :, pos] = sc
    return xs.to(torch.bfloat16)


_WEIGHTS = ("wqkv", "sqkv", "wo", "so", "wgu", "sgu", "wd", "sd", "ln_attn",
            "ln_mlp")


def _check(x, rings, w, rope, pos, heads, groups) -> Dict[str, int]:
    """The shapes the kernel takes (module docstring layout); raises on
    anything else. Returns the dimensions."""
    n_layers, nqkv, dm = w["wqkv"].shape
    b = x.shape[0]
    dq = w["wo"].shape[2]
    f = w["wd"].shape[2]
    d = dq // heads if heads > 0 else 0
    dkv = groups * d
    _, _, ring_len, _ = rings["k_q"].shape
    want = {"wqkv": (n_layers, dq + 2 * dkv, dm), "sqkv": (n_layers, nqkv),
            "wo": (n_layers, dm, dq), "so": (n_layers, dm),
            "wgu": (n_layers, 2 * f, dm), "sgu": (n_layers, 2 * f),
            "wd": (n_layers, dm, f), "sd": (n_layers, dm),
            "ln_attn": (n_layers, dm), "ln_mlp": (n_layers, dm),
            "k_q": (n_layers, b, ring_len, dkv),
            "v_q": (n_layers, b, ring_len, dkv),
            "k_s": (n_layers, b, groups, ring_len),
            "v_s": (n_layers, b, groups, ring_len)}
    have = {**{k: tuple(w[k].shape) for k in _WEIGHTS},
            **{k: tuple(rings[k].shape) for k in want if k in rings}}
    bad = {k: have.get(k) for k in want if have.get(k) != want[k]}
    if heads <= 0 or groups <= 0 or heads % groups or dq % heads or bad:
        raise ValueError(f"ocr_megastep: shapes {bad} do not match "
                         f"{heads} heads over {groups} kv heads")
    if x.shape != (b, dm) or x.dtype != torch.bfloat16:
        raise ValueError(f"ocr_megastep: x must be bf16 [B, {dm}], got "
                         f"{tuple(x.shape)} {x.dtype}")
    if b < 1:
        raise ValueError(f"ocr_megastep: batch {b} must be at least 1")
    if d % 4 or d > _THREADS or _THREADS % d or dm % 16 or dq % 16 \
            or f % 16:
        raise ValueError(f"ocr_megastep: head dim {d} must divide "
                         f"{_THREADS} and be a multiple of 4, and d_model "
                         f"{dm} / heads * dim {dq} / d_ff {f} multiples of "
                         f"16")
    if not 0 <= pos < ring_len or rope.shape[0] <= pos \
            or tuple(rope.shape[1:]) != (d // 2, 2):
        raise ValueError(f"ocr_megastep: position {pos} outside the ring "
                         f"({ring_len}) or the rope table "
                         f"{tuple(rope.shape)}")
    for k, dt in (("wqkv", torch.int8), ("wo", torch.int8),
                  ("wgu", torch.int8), ("wd", torch.int8),
                  ("k_q", torch.int8), ("v_q", torch.int8)):
        t = rings[k] if k in rings else w[k]
        if t.dtype != dt:
            raise ValueError(f"ocr_megastep: {k} must be {dt}")
    for t in [w[k] for k in ("sqkv", "so", "sgu", "sd", "ln_attn",
                             "ln_mlp")] + [rings["k_s"], rings["v_s"], rope]:
        if t.dtype != torch.float32:
            raise ValueError("ocr_megastep: scales, norms and the rope "
                             "table must be float32")
    return dict(L=n_layers, B=b, S=ring_len, Dm=dm, H=heads, G=groups, D=d,
                F=f)


def ocr_megastep(x: torch.Tensor, rings: Dict[str, torch.Tensor],
                 w: Dict[str, torch.Tensor], rope: torch.Tensor, pos: int,
                 *, heads: int, groups: int, rms_eps: float) -> torch.Tensor:
    """One decode step of every layer (module docstring); x [B, Dm] bf16.
    Writes the rings at column `pos` in place and returns bf16 [B, Dm]."""
    if x.device.type == "cpu":
        return plain_megastep(x, rings, w, rope, pos, heads=heads,
                              groups=groups, rms_eps=rms_eps)
    dims = _check(x, rings, w, rope, pos, heads, groups)
    b, dm, f = dims["B"], dims["Dm"], dims["F"]
    nqkv = w["wqkv"].shape[1]
    dq = heads * dims["D"]
    # the grid barrier's arrival count (alone in 256 bytes: a count that
    # shares its line with x measured 11 % slower; zeroed by the C entry
    # before each launch) | x float32 [B, Dm] | each row's sums of squares
    # over 16-column tiles, padded to 4 [B, ceil(Dm / 64) * 4] | qkv float32
    # [B, nqkv] | attn and mid bf16 [B, Dq + 8], [B, F + 8]
    # (csrc/ocr_megastep.cu)
    scratch = torch.empty(64 + b * (dm + -(-dm // 64) * 4 + nqkv)
                          + b * (dq + f + 16) // 2, dtype=torch.float32,
                          device=x.device)
    out = torch.empty_like(x)
    tensors = [x, out, scratch, rope, *(rings[k] for k in
               ("k_q", "k_s", "v_q", "v_s")), *(w[k] for k in _WEIGHTS)]
    _build.require_cuda("ocr_megastep", *tensors)
    rc = _build.lib().mg_ocr_megastep(
        *(t.data_ptr() for t in tensors),
        *(dims[k] for k in ("L", "B", "S", "Dm", "H", "G", "D", "F")), pos,
        rms_eps, dims["D"] ** -0.5, _build.stream(out))
    _build.check(rc, "ocr_megastep")
    _build.LAUNCHES["ocr_megastep"] += 1
    return out
