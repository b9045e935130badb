#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one NVIDIA GPU: the MarkushGrapher
stage, the ChemicalOCR stage, the two in a pipeline, and MarkushGrapher
training.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero and
prints no result):

1. device: requires CUDA (no CPU fallback); prints torch / CUDA versions and
   the card's name and power limit;
2. build: compiles the port's CUDA kernels from `markushgrapher_torch/csrc`
   for sm_90a, one nvcc per source, all at once;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the main paths give it, with the stated tolerance, timed
   against it, beside its bound (bytes over 3.35 TB/s or operations over
   989 TFLOP/s bf16, whichever is larger) and, where one PyTorch call
   computes the same function, that call's time. The OCR shapes: the
   megastep at OCRConfig() width, batch 8, ring L0 + 512, at p = L0 and
   p = L0 + 400; decode_int4 (G = 5) and decode_i8 (15 rows over 5 kv
   heads) over that ring. The float-bias flash forward at its serving shape
   (B=2) and forward + both backward kernels at the training shape (B=8),
   L=1536, H=16, D=64, bf16 bias with 25 % of the keys masked, against
   SDPA with the bias as attn_mask as the library yardstick;
4. paths: the flagship 831M MarkushGrapherConfig() with seeded random bf16
   weights, served through `Evaluator.generate_batch` at batch 8 with eos
   never firing, along four paths: greedy under int4 KV for 512 steps, beam-5
   under int4 KV for 512 steps, greedy under int8 KV for 512 steps, and
   beam-5 under int8 KV for 128 steps. Then OCRConfig() (seeded random bf16
   weights) through `ChemicalOCR.generate_batch` on seeded uint8 pages at
   batch 8, 512 new tokens, eos never firing, along three paths: int4 KV,
   int8 KV, and the megastep (int8 KV, one launch per step). For each: the
   launch counts of every kernel (every count set to 0 just before the path,
   read just after), and every kernel call of the encode (MG) and of the
   first 8 decode steps held to its plain version on the same inputs (the
   megastep one layer at a time and as a whole step). For the int4 greedy
   path also the end-to-end difference from the plain path beside a
   half-ulp-nudge control; for every path a few rows decoded to strings;
5. timing: encode ms, decode ms/step and img/s of int4 greedy at batch 8 and
   48, beam-5 (int4) at batch 8 and 16, int8 greedy at batch 8 and 48; OCR
   prefill ms, ms/step and img/s of each OCR path at batch 8; and one
   pipeline run: uint8 pages -> OCR (int4 KV) -> loc-grammar cells (seeded
   fallback cells where random weights emit none) -> SampleEncoder /
   DataCollator with pixels from `data.device_pixels` -> MG greedy int4,
   512 steps at batch 8, in img/s;
6. training: MarkushGrapherConfig() (866.7M parameters) through
   `Trainer.train_step` at batch 8 on seeded labelled pages (512 text +
   1024 patch positions, 512 decoder positions), TrainConfig from
   configs/train.yaml without accumulation: bf16 compute over float32
   master weights, remat, dropout, the Swin frozen. One step holds every
   flash forward / recompute / backward call to its plain version, then 2
   warm and 5 timed steps: loss and grad norm per step (finite), ms/step,
   ex/s, peak memory; launch counts of the 8 steps (48 forward, 24 dkv and
   24 dq launches per step).

The last three lines are the card's name and power limit, one JSON object
describing the kernels, and `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import subprocess
import sys
import time

import numpy as np

SEED = 0
KERNELS = {
    "bias_build_i8": ("markushgrapher_torch/csrc/bias_build_i8.cu",
                      "markushgrapher_tpu/ops/bias_build.py:158"),
    "flash_i8": ("markushgrapher_torch/csrc/flash_i8.cu",
                 "markushgrapher_tpu/ops/flash_attention.py:152"),
    "decode_int4": ("markushgrapher_torch/csrc/decode_int4.cu",
                    "markushgrapher_tpu/ops/mxu_decode.py:498"),
    "decode_i8": ("markushgrapher_torch/csrc/decode_i8.cu",
                  "markushgrapher_tpu/ops/mxu_decode.py:351"),
    "ocr_megastep": ("markushgrapher_torch/csrc/ocr_megastep.cu",
                     "markushgrapher_tpu/ops/megastep.py:363"),
    # the float-bias forward is also the forward of the stock trainable
    # Pallas flash attention called at models/t5.py:380; the backward
    # kernels replace that call's bwd_dkv and bwd_dq
    "flash_bias": ("markushgrapher_torch/csrc/flash_bias.cu",
                   "markushgrapher_tpu/ops/flash_attention.py:63"),
    "flash_bias_dkv": ("markushgrapher_torch/csrc/flash_bias_bwd.cu",
                       "markushgrapher_tpu/models/t5.py:380"),
    "flash_bias_dq": ("markushgrapher_torch/csrc/flash_bias_bwd.cu",
                      "markushgrapher_tpu/models/t5.py:380"),
}
FLASH_BIAS = ("flash_bias", "flash_bias_dkv", "flash_bias_dq")
# the card's published peaks (H100 SXM, dense, 700 W): HBM bytes/s and bf16
# tensor-core FLOP/s; a kernel's bound is the larger of its bytes and its
# operations over these
PEAK_BYTES, PEAK_FLOPS = 3.35e12, 989e12
# kernel-vs-plain tolerances (|kernel - plain| <= atol + rtol * |plain|):
#  - bias_build_i8 is exact (same LUT buckets, same float32 op order);
#  - flash_i8, decode_int4 and decode_i8 return bf16, and sum in another
#    order than the plain float32 matmuls: two bf16 ulps (2 * 2^-7
#    relative), plus a small absolute floor for outputs near zero. The
#    decode kernels also round p * vs to bf16 inside, where a one-ulp flip
#    of one weight can move the output by a little more.
#  - ocr_megastep, one layer at a time on the same bf16 input: the output is
#    x + attention + MLP rounded to bf16 once, so two output ulps (2 * 2^-7
#    relative). The kernel sums its GEMVs in another order, so a new K/V
#    value that lies near a rounding tie gets the neighbouring int8 code
#    (one step, as the ring check allows); through the attention of the
#    group's three heads that moves a few outputs by up to ~4e-3 absolute
#    (measured at OCRConfig() width), which shows where x + delta nearly
#    cancels: an absolute floor of 8e-3. The whole 32-layer step is
#    reported, and gated at WHOLE_STEP_REL relative L2 (the float32
#    residual carries such moves on through the layers). Ring writes: the
#    int8 codes within one step, scales within 1e-3 relative.
# The same tolerances hold for every kernel call inside the model (phase 4),
# where they gate the attention output before the o-projection and the
# residual add.
TOL = {"flash_i8": (1e-3, 1.6e-2), "decode_int4": (2e-3, 2e-2),
       "decode_i8": (2e-3, 2e-2), "ocr_megastep": (8e-3, 1.6e-2),
       "flash_bias": (1e-3, 1.6e-2)}
WHOLE_STEP_REL = 2e-2
# flash_bias also returns the float32 log-sum-exp of each row, summed in
# float32 by both versions: |kernel - plain| <= 1e-4 + 1e-5 * |plain|.
# The backward kernels return bf16 dq / dk / dv and d(bias), from products
# whose operands P and dS are rounded to bf16 (the plain version keeps them
# float32): each output within GRAD_ULPS bf16 ulps (2^-7 relative) of its
# largest magnitude, and within GRAD_REL relative L2.
LSE_TOL = (1e-4, 1e-5)
GRAD_ULPS, GRAD_REL = 4, 1e-2
# the training phase: per-device batch, warm and timed steps after the one
# step whose every flash call is held to its plain version
TRAIN_BATCH, TRAIN_WARM, TRAIN_TIMED = 8, 2, 5
# phase 4's paths at batch 8: (name, int4 KV, beams, decode steps)
PATHS = (("greedy_int4", True, 1, 512), ("beam5_int4", True, 5, 512),
         ("greedy_int8", False, 1, 512), ("beam5_int8", False, 5, 128))
CHECKED_STEPS = 8
# the OCR paths: batch, new tokens, and (name, OCREngineConfig flags, the
# kernel each decode step launches)
OCR_BATCH, OCR_TOKENS = 8, 512
OCR_PATHS = (
    ("ocr_int4", dict(quant_kv=True, int4_kv=True, quant_weights=True),
     "decode_int4"),
    ("ocr_int8", dict(quant_kv=True, quant_weights=True), "decode_i8"),
    ("ocr_mega", dict(quant_kv=True, quant_weights=True, megastep=True),
     "ocr_megastep"))


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Device ms per call of fn. A sleep kernel queued ahead of the timed
    calls outlasts their host time (measured on the warm-up calls, with the
    sleep's cycles counted at the card's top clock, 1.98 GHz), so the host
    has queued every call before the device reaches the first: the events
    then time the device work, not the wrappers' Python."""
    import torch

    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    host_s = (time.perf_counter() - t0) / warmup
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(1.5 * host_s * iters * 1.98e9) + 1000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def within(name: str, got, ref) -> float:
    """Max |got - ref|; raises if any entry is outside TOL[name]."""
    import torch

    g, r = got.float(), ref.float()
    err = (g - r).abs()
    atol, rtol = TOL[name]
    bad = err > atol + rtol * r.abs()
    if not bool(torch.isfinite(g).all()) or bool(bad.any()):
        worst = torch.topk((err - rtol * r.abs()).flatten(), 3).indices
        raise AssertionError(
            f"{name}: {int(bad.sum())} entries outside atol={atol} "
            f"rtol={rtol}; max abs err {float(err.max()):.3e}; worst (got, "
            f"want): {[(float(g.flatten()[i]), float(r.flatten()[i])) for i in worst]}")
    return float(err.max())


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, flops: float) -> dict:
    """The least time the card could take: bytes over the HBM rate or
    operations over the bf16 tensor rate, whichever is larger."""
    by_bytes, by_ops = n_bytes / PEAK_BYTES, flops / PEAK_FLOPS
    return dict(bound_ms=max(by_bytes, by_ops) * 1e3,
                bound_by="bytes" if by_bytes >= by_ops else "operations")


def decode_bound(q, kq, ks, vq, vs, bias, out) -> dict:
    """Bound of one decode attention call on this run's data: only the keys
    that some query row does not mask (bias above -1e8) need their K/V and
    scale bytes read; 4 operations per (query row, live key, head dim)."""
    kv_len = kq.shape[1]
    live = int((bias.amax(dim=(0, 1)) > -1e8).sum())
    kv_bytes = nbytes(kq, vq, ks, vs) * live / kv_len
    flops = 4 * q.shape[0] * q.shape[1] * live * q.shape[2]
    return bound(nbytes(q, bias, out) + kv_bytes, flops)


def decode_run(name, kernel, plain, args, kw, iters=50) -> dict:
    """A decode kernel against its plain version on the same inputs, timed,
    beside its bound."""
    import torch

    got = kernel(*args, **kw)
    err = within(name, got, plain(*args, **kw))
    torch.cuda.synchronize()
    return dict(max_abs_err=err,
                ms=cuda_ms(lambda: kernel(*args, **kw), iters),
                plain_ms=cuda_ms(lambda: plain(*args, **kw), 20),
                library_ms=None, **decode_bound(*args, got))


def report(name: str, shape: str, res: dict) -> None:
    lib = res.get("library_ms")
    print(f"{name:<12} {shape}: max abs err {res['max_abs_err']:.3e}; kernel "
          f"{res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, bound "
          f"{res['bound_ms']:.4f} ms ({res['bound_by']}), library "
          f"{'none' if lib is None else f'{lib:.4f} ms'}", flush=True)


def check_kernels(dev, pack: int) -> dict:
    """Each kernel against its plain version at the main paths' shapes
    (`pack`: the batch's cross pack length). Returns {name: {max_abs_err,
    ms, plain_ms, bound_ms, bound_by, library_ms}} for each kernel's
    headline shape; the other shapes are printed."""
    import torch
    import torch.nn.functional as F

    from markushgrapher_torch.ops import bias_build, flash_attention, mxu_decode
    from markushgrapher_torch.ops.relbias import mask_bias

    rng = np.random.RandomState(SEED)
    out = {}

    # K1: int8 bias slab, B=2, H=16, L=1536 (512 text + 1024 patches)
    B, H, L, NB = 2, 16, 1536, 32
    tabs = [torch.tensor(rng.randn(NB, H).astype(np.float32) * 0.5,
                         device=dev) for _ in range(3)]
    bbox_np = np.sort(rng.rand(B, L, 4).astype(np.float32), axis=-1)
    bbox_np[:, 300:512] = 0.0                       # padded text slots
    bbox = torch.tensor(bbox_np, device=dev)
    mask = (bbox.sum(-1) > 0).to(torch.int32)
    args = (*tabs, bbox, mask, L, NB, 128, 100, 100)
    got, s_got = bias_build.encoder_position_bias_kernel_i8(*args)
    ref, s_ref = bias_build.plain(*args)
    torch.cuda.synchronize()
    if not (torch.equal(got, ref) and torch.equal(s_got, s_ref)):
        n = int((got != ref).sum())
        raise AssertionError(f"bias_build_i8: {n} entries differ from plain")
    out["bias_build_i8"] = dict(
        max_abs_err=0.0,
        ms=cuda_ms(lambda: bias_build.encoder_position_bias_kernel_i8(*args)),
        plain_ms=cuda_ms(lambda: bias_build.plain(*args)),
        library_ms=None, **bound(nbytes(*tabs, bbox, mask, got, s_got), 0))
    report("bias_build_i8", f"B={B} H={H} L={L} (bit-exact)",
           out["bias_build_i8"])

    # K2: flash over the int8 slab, bf16 q/k/v, 25 % of keys padded. Its
    # library yardstick: SDPA with the dequantised bias plus the key mask
    # as a bf16 attn_mask and scale 1 (both made outside the timing)
    D = 64
    q, k, v = (torch.tensor(rng.randn(B, L, H, D).astype(np.float32) * sc,
                            device=dev).to(torch.bfloat16)
               for sc in (0.3, 0.3, 1.0))
    scales = torch.tensor(rng.rand(H).astype(np.float32) * 0.05, device=dev)
    kmask = torch.ones((B, L), dtype=torch.int32, device=dev)
    kmask[:, int(L * 0.75):] = 0
    fargs = (q, k, v, got, scales, kmask)
    f_got = flash_attention.flash_attention_bias_i8(*fargs)
    f_ref = flash_attention.plain(*fargs)
    torch.cuda.synchronize()
    attn_mask = (got.float() * scales[None, :, None, None] + torch.where(
        kmask[:, None, None, :] > 0, 0.0, -1e30)).to(torch.bfloat16)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    out["flash_i8"] = dict(
        max_abs_err=within("flash_i8", f_got, f_ref),
        ms=cuda_ms(lambda: flash_attention.flash_attention_bias_i8(*fargs)),
        plain_ms=cuda_ms(lambda: flash_attention.plain(*fargs)),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=attn_mask, scale=1.0)),
        **bound(nbytes(q, k, v, got, scales, kmask, f_got),
                4 * B * H * L * L * D))
    report("flash_i8", f"B={B} H={H} L={L} D={D}", out["flash_i8"])
    del attn_mask, qt, kt, vt

    # K3 / K4: decode attention over int4 values [-7, 7] or int8 values
    # [-127, 127]; padding keys (and the ring's unwritten tail) have zero
    # values and scales, masked by the bias.
    HD = H * D

    def slab(rows, n_keys, n_valid, int4):
        top = 8 if int4 else 128
        vals = rng.randint(1 - top, top, size=(rows, n_keys, HD)).astype(
            np.int8)
        vals[:, n_valid:] = 0
        sc = rng.rand(rows, H, n_keys).astype(np.float32) * 0.05
        sc[:, :, n_valid:] = 0.0
        t = torch.tensor(vals, device=dev)
        s_ = torch.tensor(sc, device=dev)
        if int4:
            return mxu_decode.pack_int4(t), s_.to(torch.bfloat16)
        return t, s_

    def query(rows, n):
        return torch.tensor(rng.randn(rows, n, D).astype(np.float32),
                            device=dev).to(torch.bfloat16)

    def cross_bias(rows, n_keys, n_valid):
        cmask = torch.ones((rows, n_valid), dtype=torch.int32, device=dev)
        cmask[:, -100:] = 0
        return F.pad(mask_bias(cmask)[:, :1, 0, :], (0, n_keys - n_valid),
                     value=-1e9)

    def self_bias(ring, step):
        srow = np.full((1, H, ring), np.finfo(np.float32).min, np.float32)
        srow[:, :, :step + 1] = rng.randn(1, H, step + 1) * 0.5
        return torch.tensor(srow, device=dev)

    beams, step, ring = 5, 300, 512
    beam_map = tuple(range(H)) * beams
    for name, kernel, plain, int4 in (
            ("decode_int4", mxu_decode.cross_decode_mxu_int4,
             mxu_decode.plain_int4, True),
            ("decode_i8", mxu_decode.cross_decode_mxu,
             mxu_decode.plain_int8, False)):
        # greedy cross at B=8: Kp=1792 for int4 (its first slice's shape),
        # the batch's pack for int8; 20 % of the keys padded
        kp = 1792 if int4 else pack
        valid = kp * 4 // 5
        kq, ks = slab(8, kp, valid, int4)
        vq, vs = slab(8, kp, valid, int4)
        cargs = (query(8, H), kq, ks, vq, vs, cross_bias(8, kp, valid))
        out[name] = decode_run(name, kernel, plain, cargs, {})
        report(name, f"cross B=8 R={H} Kp={kp}", out[name])
        # beam cross: 8 slab rows, 5 beams folded into 80 query rows
        bq, bs = slab(8, pack, pack - 100, int4)
        bv, bvs = slab(8, pack, pack - 100, int4)
        bargs = (query(8, beams * H), bq, bs, bv, bvs,
                 cross_bias(8, pack, pack - 100))
        report(name, f"beam cross B=8 R={beams * H} Kp={pack} head_map",
               decode_run(name, kernel, plain, bargs,
                          dict(head_map=beam_map)))
        # self ring: 8 x 5 beam rows, per-head causal bias row
        rows = 8 * beams
        rk, rks = slab(rows, ring, step + 1, int4)
        rv, rvs = slab(rows, ring, step + 1, int4)
        sargs = (query(rows, H), rk, rks, rv, rvs, self_bias(ring, step))
        report(name, f"self rows={rows} R={H} S={ring} step={step}",
               decode_run(name, kernel, plain, sargs, {}))
    return out


def lse_within(got, ref) -> float:
    """flash_bias's log-sum-exp against the plain one, within LSE_TOL."""
    import torch

    err = (got - ref).abs()
    atol, rtol = LSE_TOL
    if not bool(torch.isfinite(got).all()) or bool(
            (err > atol + rtol * ref.abs()).any()):
        raise AssertionError(f"flash_bias lse: max abs err "
                             f"{float(err.max()):.3e}")
    return float(err.max())


def grad_within(name: str, got, ref) -> float:
    """A bf16 gradient of a backward kernel against its plain version on the
    same inputs: max |got - ref| within GRAD_ULPS bf16 ulps of max |ref| and
    relative L2 within GRAD_REL; returns the max abs error."""
    import torch

    g, r = got.float(), ref.float()
    err, top = float((g - r).abs().max()), float(r.abs().max())
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 1e-30
    rel = float((g - r).norm() / max(float(r.norm()), 1e-30))
    if not bool(torch.isfinite(g).all()) or err > GRAD_ULPS * ulp \
            or rel > GRAD_REL:
        raise AssertionError(
            f"{name}: max abs err {err:.3e} = {err / ulp:.2f} ulps of max "
            f"|plain| {top:.3e} (gate {GRAD_ULPS}), relative L2 {rel:.3e} "
            f"(gate {GRAD_REL})")
    return err


def flash_bias_inputs(dev, batch: int, seed: int):
    """bf16 q, k, v, dO [B, 1536, 16, 64] and a bf16 bias [B, 16, 1536,
    1536]: N(0, 0.5^2) with the last 25 % of the keys at -1e9, as the
    training slab masks padding."""
    import torch

    L, H, D = 1536, 16, 64
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(shape, scale):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(
            torch.bfloat16)

    q, k = randn((batch, L, H, D), 0.3), randn((batch, L, H, D), 0.3)
    v, do = randn((batch, L, H, D), 1.0), randn((batch, L, H, D), 0.1)
    bias = torch.randn((batch, H, L, L), generator=gen, device=dev) * 0.5
    bias[..., int(L * 0.75):] = -1e9
    return q, k, v, bias.to(torch.bfloat16), do


def check_flash_bias(dev) -> dict:
    """The float-bias flash kernels against their plain versions: the
    forward at row 3's serving shape (B=2) and forward + both backward
    kernels at the training shape (B=8), both L=1536, H=16, D=64, bf16
    bias. Library yardstick: SDPA with the bias as attn_mask and scale 1,
    forward, and forward + backward with a grad-requiring mask (its backward
    computes dq, dk, dv and d(mask) in one; reported for both backward
    kernels). Returns the training shape's rows."""
    import torch
    import torch.nn.functional as F

    from markushgrapher_torch.ops import flash_attention as fa

    H, L, D = 16, 1536, 64
    q, k, v, bias, _ = flash_bias_inputs(dev, 2, SEED + 5)
    got = fa.flash_attention_bias(q, k, v, bias)
    ref = fa.plain_bias(q, k, v, bias)
    torch.cuda.synchronize()
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    report("flash_bias", f"row 3 serving B=2 H={H} L={L} D={D} bf16 bias",
           dict(max_abs_err=within("flash_bias", got, ref),
                ms=cuda_ms(lambda: fa.flash_attention_bias(q, k, v, bias)),
                plain_ms=cuda_ms(lambda: fa.plain_bias(q, k, v, bias), 5, 1),
                library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=bias, scale=1.0)),
                **bound(nbytes(q, k, v, bias, got), 4 * 2 * H * L * L * D)))
    del q, k, v, bias, got, ref, qt, kt, vt

    B = TRAIN_BATCH
    q, k, v, bias, do = flash_bias_inputs(dev, B, SEED + 6)
    o, lse = fa.flash_bias_fwd(q, k, v, bias)
    o_ref, lse_ref = fa.plain_fwd(q, k, v, bias)
    torch.cuda.synchronize()
    fwd_err = within("flash_bias", o, o_ref)
    lse_err = lse_within(lse, lse_ref)
    del o_ref, lse_ref
    di = (o.float() * do.float()).sum(dim=-1).transpose(1, 2).contiguous()
    bwd = (q, k, v, bias, do, lse, di)
    dk, dv = fa.flash_bias_dkv(*bwd)
    dk_r, dv_r = fa.plain_bwd_dkv(*bwd)
    dkv_err = max(grad_within("flash_bias_dkv dk", dk, dk_r),
                  grad_within("flash_bias_dkv dv", dv, dv_r))
    del dk_r, dv_r
    dq, ds = fa.flash_bias_dq(*bwd)
    dq_r, ds_r = fa.plain_bwd_dq(*bwd)
    dq_err = max(grad_within("flash_bias_dq dq", dq, dq_r),
                 grad_within("flash_bias_dq dbias", ds, ds_r))
    del dq_r, ds_r
    torch.cuda.synchronize()

    qt, kt, vt, dot = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    grads = [t.detach().clone().requires_grad_()
             for t in (qt, kt, vt, bias)]

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(*grads[:3], attn_mask=grads[3],
                                             scale=1.0)
        torch.autograd.grad(out, grads, dot)

    lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=bias, scale=1.0))
    lib_bwd = cuda_ms(sdpa_fwd_bwd, 5, 1) - lib_fwd
    flops = B * H * L * L * D
    out = {
        "flash_bias": dict(
            max_abs_err=fwd_err,
            ms=cuda_ms(lambda: fa.flash_bias_fwd(q, k, v, bias)),
            plain_ms=cuda_ms(lambda: fa.plain_fwd(q, k, v, bias), 3, 1),
            library_ms=lib_fwd,
            **bound(nbytes(q, k, v, bias, o, lse), 4 * flops)),
        "flash_bias_dkv": dict(
            max_abs_err=dkv_err,
            ms=cuda_ms(lambda: fa.flash_bias_dkv(*bwd)),
            plain_ms=cuda_ms(lambda: fa.plain_bwd_dkv(*bwd), 3, 1),
            library_ms=lib_bwd,
            **bound(nbytes(*bwd, dk, dv), 8 * flops)),
        "flash_bias_dq": dict(
            max_abs_err=dq_err,
            ms=cuda_ms(lambda: fa.flash_bias_dq(*bwd)),
            plain_ms=cuda_ms(lambda: fa.plain_bwd_dq(*bwd), 3, 1),
            library_ms=lib_bwd,
            **bound(nbytes(*bwd, dq, ds), 6 * flops)),
    }
    shape = f"train B={B} H={H} L={L} D={D} bf16 bias"
    report("flash_bias", f"{shape}; lse max abs err {lse_err:.3e}",
           out["flash_bias"])
    report("flash_bias_dkv", f"{shape} (library: SDPA backward)",
           out["flash_bias_dkv"])
    report("flash_bias_dq", f"{shape}, d(bias) bf16 (library: SDPA "
           f"backward)", out["flash_bias_dq"])
    return out


def ocr_model(dev):
    """OCRConfig() at full width and depth, seeded random bf16 weights."""
    import torch

    from markushgrapher_torch.ocr.vlm import ChemicalOCRModel, OCRConfig

    with torch.device(dev):
        model = ChemicalOCRModel(OCRConfig(max_new_tokens=OCR_TOKENS))
    model.init_weights(SEED)
    return model.to(torch.bfloat16).eval()


def ocr_prefix_len(model) -> int:
    """L0: the image tokens plus the engine's prompt tokens."""
    from markushgrapher_torch.data.vocab import MGTokenizer
    from markushgrapher_torch.ocr.engine import DEFAULT_PROMPT

    return model.cfg.num_image_tokens + len(
        MGTokenizer().encode(DEFAULT_PROMPT, add_eos=False))


def mega_check(kernel, x, rings, w, rope, pos, kw) -> tuple:
    """ocr_megastep (`kernel`, counted as a launch) against plain_megastep
    on the same inputs: layer by layer (both on the plain chain's input,
    each output within TOL["ocr_megastep"], the ring column `pos` within one
    int8 step), then the whole step (relative L2 of the output and of the
    dequantised ring column within WHOLE_STEP_REL, the earlier columns
    untouched). The kernel's whole-step ring writes stay in
    `rings`; the launches of the layer-by-layer calls are not counted.
    Returns (kernel output, per-layer max abs err, whole-step max abs err,
    whole-step relative L2)."""
    import torch

    from markushgrapher_torch.ops import _build, megastep

    before = {k: v.clone() for k, v in rings.items()}
    got = kernel(x, rings, w, rope, pos, **kw)
    counted = _build.LAUNCHES["ocr_megastep"]
    ref_rings = {k: v.clone() for k, v in before.items()}
    ref = megastep.plain_megastep(x, ref_rings, w, rope, pos, **kw)
    # whole step: later layers see the residual after earlier layers' one-ulp
    # moves, so their ring rows are compared dequantised, like the output
    rel = _rel(got, ref)
    col = [_rel(deq_column(rings, n, pos), deq_column(ref_rings, n, pos))
           for n in ("k", "v")]
    untouched = all(torch.equal(rings[k][:, :, :pos], before[k][:, :, :pos])
                    for k in ("k_q", "v_q"))
    if not (max([rel] + col) <= WHOLE_STEP_REL and untouched
            and bool(got.float().isfinite().all())):
        raise AssertionError(
            f"ocr_megastep whole step: relative L2 {rel:.3e}, ring column "
            f"k / v {col[0]:.3e} / {col[1]:.3e} (gate {WHOLE_STEP_REL}); "
            f"earlier columns untouched {untouched}")
    errs, xin = [], x
    for layer in range(w["wqkv"].shape[0]):
        one = {k: t[layer:layer + 1] for k, t in w.items()}
        rk = {k: t[layer:layer + 1].clone() for k, t in before.items()}
        rp = {k: t[layer:layer + 1].clone() for k, t in before.items()}
        gk = kernel(xin, rk, one, rope, pos, **kw)
        gp = megastep.plain_megastep(xin, rp, one, rope, pos, **kw)
        try:
            errs.append(within("ocr_megastep", gk, gp))
        except AssertionError as e:
            raise AssertionError(f"layer {layer}, position {pos}: {e}")
        rings_close(rk, rp, pos, f"layer {layer}")
        xin = gp
    _build.LAUNCHES["ocr_megastep"] = counted
    return got, max(errs), float((got.float() - ref.float()).abs().max()), rel


def deq_column(rings: dict, name: str, pos: int):
    """Ring column `pos` of K or V dequantised, [L, B, G, D] float32."""
    vals = rings[name + "_q"][:, :, pos].float()
    sc = rings[name + "_s"][..., pos]
    return vals.reshape(*sc.shape, -1) * sc[..., None]


def rings_close(got: dict, ref: dict, pos: int, what: str) -> None:
    """Ring writes of kernel and plain: columns other than `pos` untouched
    alike, int8 codes at `pos` within one step, scales (max|k| / 127)
    within 1e-3 relative: one bf16 ulp of one normalised input element
    moves a projection by ~1e-4 of itself."""
    for name in ("k", "v"):
        dq = (got[name + "_q"].int() - ref[name + "_q"].int()).abs()
        ds = (got[name + "_s"] - ref[name + "_s"]).abs()
        tol_s = 1e-3 * ref[name + "_s"].abs() + 1e-12
        if int(dq.max()) > 1 or int(dq[:, :, :pos].max()) > 0 or bool(
                (ds > tol_s).any()):
            raise AssertionError(
                f"ocr_megastep {what}: ring {name} differs from plain (codes "
                f"by {int(dq.max())}, scales by {float(ds.max()):.3e})")


def check_ocr_kernels(dev, model) -> dict:
    """The kernels at the OCR shapes (OCRConfig() width, batch 8, ring
    L0 + 512 rounded up to 128): the megastep at p = L0 and p = L0 + 400
    (its headline), decode_int4 at G = 5 and decode_i8 at 15 rows over 5 kv
    heads, both at p = L0 + 400. Returns {"ocr_megastep": {...}}."""
    import torch

    from markushgrapher_torch.ops import megastep, mxu_decode

    t = model.cfg.text
    heads, groups, d = t.num_heads, t.num_kv_heads, t.d_model // t.num_heads
    l0 = ocr_prefix_len(model)
    ring = l0 + OCR_TOKENS
    ring += -ring % 128
    w = model.megastep_pack()["lm"]
    kw = dict(heads=heads, groups=groups, rms_eps=t.rms_eps)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    b, n_layers, dkv = OCR_BATCH, t.num_layers, groups * d
    late = l0 + min(400, OCR_TOKENS - 1)
    out = {}
    for pos in (l0, late):
        rings = {}
        for name in ("k", "v"):
            vals = torch.randint(-127, 128, (n_layers, b, ring, dkv),
                                 generator=gen, device=dev, dtype=torch.int8)
            sc = torch.rand((n_layers, b, groups, ring), generator=gen,
                            device=dev) * 0.03
            vals[:, :, pos:] = 0
            sc[..., pos:] = 0
            rings[name + "_q"], rings[name + "_s"] = vals, sc
        x = torch.randn((b, t.d_model), generator=gen, device=dev).to(
            torch.bfloat16)
        _, err, step_err, rel = mega_check(megastep.ocr_megastep, x, rings,
                                           w, model.rope(), pos, kw)
        torch.cuda.synchronize()
        live = {k: v[:, :, :pos] if k.endswith("_q") else v[..., :pos]
                for k, v in rings.items()}
        weights = sum(v.numel() for k, v in w.items() if v.dtype ==
                      torch.int8)
        flops = 2 * b * weights + 4 * b * heads * pos * d * n_layers
        res = dict(
            max_abs_err=err,
            ms=cuda_ms(lambda: megastep.ocr_megastep(
                x, rings, w, model.rope(), pos, **kw)),
            plain_ms=cuda_ms(lambda: megastep.plain_megastep(
                x, rings, w, model.rope(), pos, **kw), 3, 1),
            library_ms=None,
            **bound(nbytes(x, x, *w.values(), *live.values()), flops))
        report("ocr_megastep", f"L={n_layers} B={b} S={ring} p={pos}; whole "
               f"step max abs err {step_err:.3e}, rel L2 {rel:.3e}", res)
        out["ocr_megastep"] = res

    # decode attention over the OCR ring: 15 query heads over 5 kv heads
    pos = late
    rng = np.random.RandomState(SEED + 3)
    bias = torch.full((1, 1, ring), torch.finfo(torch.float32).min,
                      device=dev)
    bias[..., :pos + 1] = 0.0
    q = torch.tensor(rng.randn(b, heads, d).astype(np.float32) * 0.125,
                     device=dev).to(torch.bfloat16)
    for name, kernel, plain, top in (
            ("decode_int4", mxu_decode.cross_decode_mxu_int4,
             mxu_decode.plain_int4, 8),
            ("decode_i8", mxu_decode.cross_decode_mxu,
             mxu_decode.plain_int8, 128)):
        kv = []
        for _ in range(2):
            vals = rng.randint(1 - top, top, size=(b, ring, dkv)).astype(
                np.int8)
            vals[:, pos + 1:] = 0
            sc = rng.rand(b, groups, ring).astype(np.float32) * 0.05
            sc[:, :, pos + 1:] = 0.0
            vt, st = torch.tensor(vals, device=dev), torch.tensor(
                sc, device=dev)
            kv += ([mxu_decode.pack_int4(vt), st.to(torch.bfloat16)]
                   if top == 8 else [vt, st])
        report(name, f"OCR ring B={b} R={heads} G={groups} S={ring} "
               f"p={pos}", decode_run(name, kernel, plain,
                                      (q, *kv, bias), {}))
    return out


@contextlib.contextmanager
def checked_megastep(errs: dict, calls: int):
    """Route the model's first `calls` megastep calls through mega_check
    (layer by layer and whole step against the plain version); later calls
    go to the kernel alone. errs["ocr_megastep"] collects the per-layer max
    abs errors, errs["ocr_megastep_step"] the whole-step relative L2."""
    from markushgrapher_torch.ops import megastep

    saved = megastep.ocr_megastep
    left = [calls]

    def call(x, rings, w, rope, pos, **kw):
        if left[0] == 0:
            return saved(x, rings, w, rope, pos, **kw)
        left[0] -= 1
        got, err, _, rel = mega_check(saved, x, rings, w, rope, pos, kw)
        errs.setdefault("ocr_megastep", []).append(err)
        errs.setdefault("ocr_megastep_step", []).append(rel)
        return got

    megastep.ocr_megastep = call
    try:
        yield
    finally:
        megastep.ocr_megastep = saved


def ocr_engine(model, tok, flags: dict, dev, tokens: int = OCR_TOKENS):
    from markushgrapher_torch.ocr.engine import ChemicalOCR, OCREngineConfig

    return ChemicalOCR(model, tok, OCREngineConfig(
        max_new_tokens=tokens, batch_size=OCR_BATCH, eos_id=-1, **flags),
        device=str(dev))


def drive_ocr_path(model, tok, pages, flags: dict, dev) -> dict:
    """One OCR path through ChemicalOCR.generate_batch_async on uint8 pages,
    launch counts zeroed just before and read just after; every decode
    kernel call (or megastep) of the first CHECKED_STEPS steps held to its
    plain version on the same inputs."""
    import torch

    from markushgrapher_torch.ops import _build

    eng = ocr_engine(model, tok, flags, dev)
    errs: dict = {}
    with checked_kernels(errs, CHECKED_STEPS * model.cfg.text.num_layers), \
            checked_megastep(errs, CHECKED_STEPS):
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        ids = eng.generate_batch_async(pages)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
    step_rel = errs.pop("ocr_megastep_step", [])
    return dict(ids=ids, texts=eng.decode_ids(ids[:2]), launches=launches,
                first_s=time.perf_counter() - t0, step_rel=step_rel,
                inside={name: (max(e), len(e)) for name, e in errs.items()
                        if e})


def time_ocr_path(model, tok, pages, flags: dict, dev) -> dict:
    """Prefill ms, decode ms/step and img/s of one warm generate call (a
    16-token call warms it up)."""
    import torch

    from markushgrapher_torch.data.device_pixels import ocr_from_uint8

    ocr_engine(model, tok, flags, dev, 16).generate_batch_async(pages)
    eng = ocr_engine(model, tok, flags, dev)
    prompt = eng.prompt_ids[None].expand(pages.shape[0], -1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.prefill(ocr_from_uint8(pages), prompt, OCR_TOKENS,
                  quant_kv=True, int4=flags.get("int4_kv", False))
    torch.cuda.synchronize()
    pre_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    eng.generate_batch_async(pages)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    return dict(prefill_ms=pre_ms,
                ms_per_step=(total * 1e3 - pre_ms) / (OCR_TOKENS - 1),
                img_per_s=pages.shape[0] / total)


def time_pipeline(ocr, mg, mt, cfg, pages, dev) -> dict:
    """uint8 pages -> OCR (int4 KV) -> cells -> MG greedy int4, timed end to
    end (warm models): img/s, the two stages' seconds, and how many rows
    emitted loc-grammar cells (random weights: the others take seeded
    fallback cells, as bench_e2e.py does)."""
    import torch

    from markushgrapher_torch.data.collator import DataCollator
    from markushgrapher_torch.data.device_pixels import (ocsr_from_uint8,
                                                         vtl_from_uint8)
    from markushgrapher_torch.data.encode import SampleEncoder
    from markushgrapher_torch.data.synthetic import page_cells
    from markushgrapher_torch.decode.generate import generate
    from markushgrapher_torch.models.markushgrapher import encoder_valid_max
    from markushgrapher_torch.ocr.grammar import cells_from_prediction

    eng = ocr_engine(ocr, mt.tokenizer, OCR_PATHS[0][1], dev)
    enc = SampleEncoder(mt, max_seq_length=cfg.max_seq_length)
    collate = DataCollator(max_length=cfg.max_seq_length)
    rng = np.random.RandomState(SEED + 4)
    mg.int4_cross = True
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids, pix = eng.generate_batch_async(pages, return_pixels=True)
    cells = [cells_from_prediction(text) for text in eng.decode_ids(ids)]
    t_ocr = time.perf_counter() - t0
    batch = collate([enc.encode_inputs(
        c or page_cells(rng, cfg.vtl.image_size),
        image_size=float(cfg.vtl.image_size)) for c in cells])
    model_batch = {k: torch.as_tensor(batch[k], device=dev)
                   for k in ("input_ids", "bbox", "attention_mask")}
    model_batch["pixel_values"] = vtl_from_uint8(pix, cfg.vtl.image_size)
    model_batch["ocsr_pixel_values"] = ocsr_from_uint8(pix,
                                                       cfg.swin.image_size)
    mv = encoder_valid_max(cfg, model_batch["bbox"],
                           model_batch["attention_mask"])
    out = generate(mg, model_batch, max_length=cfg.max_seq_length_decoder,
                   eos_id=-1, cross_pack_len=-(-mv // 256) * 256)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    if out.shape != (pages.shape[0], cfg.max_seq_length_decoder):
        raise AssertionError(f"pipeline: MG ids {tuple(out.shape)}")
    return dict(img_per_s=pages.shape[0] / total, ocr_s=t_ocr,
                mg_s=total - t_ocr, grammar_rows=sum(map(bool, cells)))


def encoder_args(host: dict, dev) -> list:
    import torch

    from markushgrapher_torch.eval_pipeline import MODEL_INPUTS

    return [torch.as_tensor(host[k], device=dev) for k in MODEL_INPUTS]


def cross_pack(cfg, host: dict):
    """(ceil-256 of the batch's max valid encoder count, that count)."""
    import torch

    from markushgrapher_torch.models.markushgrapher import encoder_valid_max

    mv = encoder_valid_max(cfg, torch.as_tensor(host["bbox"]),
                           torch.as_tensor(host["attention_mask"]))
    return -(-mv // 256) * 256, mv


def _rel(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


@contextlib.contextmanager
def checked_kernels(errs: dict, decode_calls: int = -1):
    """Route the model's calls of each kernel wrapper through a check: the
    wrapper and its plain version run on the same inputs, the kernel's
    output is held to the kernel tolerance (bias_build_i8: bit-exact; the
    others: TOL, on the attention output before the o-projection and the
    residual add), and the kernel's output goes on. errs[name] collects the
    max abs error of every checked call. With decode_calls >= 0 only that
    many decode-kernel calls are checked; later ones go to the kernel
    alone. The plain versions launch no kernel, so the launch counts stay
    those of the path."""
    from markushgrapher_torch.ops import bias_build, flash_attention, mxu_decode

    sites = {"bias_build_i8": (bias_build, "encoder_position_bias_kernel_i8",
                               bias_build.plain),
             "flash_i8": (flash_attention, "flash_attention_bias_i8",
                          flash_attention.plain),
             "decode_int4": (mxu_decode, "cross_decode_mxu_int4",
                             mxu_decode.plain_int4),
             "decode_i8": (mxu_decode, "cross_decode_mxu",
                           mxu_decode.plain_int8)}
    saved = {name: getattr(mod, attr)
             for name, (mod, attr, _) in sites.items()}
    left = [decode_calls]

    def check(name, kernel, plain):
        def call(*args, **kw):
            if name.startswith("decode"):
                if left[0] == 0:
                    return kernel(*args, **kw)
                left[0] -= 1
            got, ref = kernel(*args, **kw), plain(*args, **kw)
            if name == "bias_build_i8":
                if not all(bool((g == r).all()) for g, r in zip(got, ref)):
                    raise AssertionError("bias_build_i8 in the model: "
                                         "differs from plain")
                errs[name].append(0.0)
            else:
                errs[name].append(within(name, got, ref))
            return got
        return call

    for name, (mod, attr, plain) in sites.items():
        errs.setdefault(name, [])
        setattr(mod, attr, check(name, saved[name], plain))
    try:
        yield
    finally:
        for name, (mod, attr, _) in sites.items():
            setattr(mod, attr, saved[name])


def drive_path(model, mt, cfg, host: dict, int4: bool, beams: int,
               steps: int) -> dict:
    """One path through Evaluator.generate_batch, with every launch count
    zeroed just before and read just after; every kernel call of the
    encode and of the first CHECKED_STEPS decode steps is held to its plain
    version on the same inputs along the way."""
    import torch

    from markushgrapher_torch.eval_pipeline import EvalConfig, Evaluator
    from markushgrapher_torch.ops import _build

    model.int4_cross = int4
    batch = host["input_ids"].shape[0]
    ev = Evaluator(model, mt, EvalConfig(max_length=steps, num_beams=beams,
                                         batch_size=batch, eos_id=-1))
    pack, _ = cross_pack(cfg, host)
    errs: dict = {}
    checked = CHECKED_STEPS * 2 * cfg.vtl.num_decoder_layers
    with checked_kernels(errs, decode_calls=checked):
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        ids = ev.generate_batch(host, cross_pack_len=pack)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
    return dict(ids=ids, launches=launches, first_s=time.perf_counter() - t0,
                inside={name: (max(e), len(e)) for name, e in errs.items()
                        if e})


def compare_to_plain(model, cfg, host: dict, dev) -> dict:
    """The int4 greedy path end to end against the plain path (encoder
    states, first 8 greedy tokens): what the model makes of the kernels'
    bf16-level differences, printed, not gated. On random weights the
    24-layer stacks amplify any such difference, so these are printed
    beside the same amplification of a half-ulp input nudge on the plain
    path alone, for two noise seeds."""
    import torch

    from markushgrapher_torch.decode.generate import greedy_generate

    model.int4_cross = True
    steps, batch = cfg.max_seq_length_decoder, host["input_ids"].shape[0]
    pack, _ = cross_pack(cfg, host)
    args = encoder_args(host, dev)
    budget = torch.full((batch,), 8, device=dev)

    def greedy8(enc, mask):
        return greedy_generate(model, enc, mask, steps, eos_id=-1,
                               cross_pack_len=pack, row_budgets=budget)

    enc_k, mask_k = model.encode(*args)
    ids_k = greedy8(enc_k, mask_k)
    layer0 = model.encoder.layer_0
    nudged = []
    model.use_kernels = False
    try:
        enc_p, mask_p = model.encode(*args)
        ids_p = greedy8(enc_p, mask_p)
        ids_pk = greedy8(enc_k, mask_k)
        for seed in (SEED, SEED + 1):
            gen = torch.Generator(device=dev).manual_seed(seed)

            def nudge(mod, inputs, gen=gen):
                x = inputs[0]
                noise = torch.randn(x.shape, device=dev,
                                    generator=gen) * 2 ** -9
                return (x + (noise * x.float()).to(x.dtype),) + inputs[1:]

            handle = layer0.register_forward_pre_hook(nudge)
            try:
                enc_n, mask_n = model.encode(*args)
            finally:
                handle.remove()
            ids_n = greedy8(enc_n, mask_n)
            nudged.append((seed, _rel(enc_n, enc_p), float(
                (ids_n[:, :8] == ids_p[:, :8]).float().mean())))
    finally:
        model.use_kernels = True
    first = ids_k[:, :8]
    return dict(
        masks_equal=bool(torch.equal(mask_k, mask_p)),
        finite=bool(torch.isfinite(enc_k.float()).all()),
        enc_err=_rel(enc_k, enc_p), nudged=nudged,
        match_e2e=float((first == ids_p[:, :8]).float().mean()),
        match_dec=float((first == ids_pk[:, :8]).float().mean()))


def time_path(model, mt, cfg, host: dict, dev, int4: bool,
              beams: int) -> dict:
    """Encode ms, decode ms/step and img/s of one warm generate_batch call
    (a 16-step run at the same batch warms it up)."""
    import torch

    from markushgrapher_torch.eval_pipeline import EvalConfig, Evaluator

    model.int4_cross = int4
    pack, _ = cross_pack(cfg, host)
    b, steps = host["input_ids"].shape[0], cfg.max_seq_length_decoder
    warm = Evaluator(model, mt, EvalConfig(max_length=16, num_beams=beams,
                                           batch_size=b, eos_id=-1))
    warm.generate_batch(host, cross_pack_len=pack)
    ev = Evaluator(model, mt, EvalConfig(max_length=steps, num_beams=beams,
                                         batch_size=b, eos_id=-1))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.encode(*encoder_args(host, dev))
    torch.cuda.synchronize()
    enc_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ev.generate_batch(host, cross_pack_len=pack)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    return dict(encode_ms=enc_ms,
                decode_ms_per_step=(total * 1e3 - enc_ms) / steps,
                img_per_s=b / total, cross_pack=pack,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9)


def train_config():
    """(TrainConfig, frozen prefixes) of configs/train.yaml, with the
    per-device batch TRAIN_BATCH and no gradient accumulation."""
    import dataclasses
    import os

    from markushgrapher_torch.arguments import train_settings

    tcfg, frozen = train_settings(os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "configs", "train.yaml"))
    return dataclasses.replace(tcfg, per_device_batch_size=TRAIN_BATCH,
                               gradient_accumulation_steps=1), frozen


@contextlib.contextmanager
def checked_flash(errs: dict):
    """Route every call of the three float-bias flash wrappers (the
    trainable op's forward, recompute and backward) through a check against
    its plain version on the same inputs; errs[name] collects the max abs
    error of each call. The plain versions launch no kernel."""
    from markushgrapher_torch.ops import flash_attention as fa

    saved = fa.flash_bias_fwd, fa.flash_bias_dkv, fa.flash_bias_dq

    def fwd(q, k, v, bias):
        out, lse = saved[0](q, k, v, bias)
        ref, ref_lse = fa.plain_fwd(q, k, v, bias)
        errs["flash_bias"].append(within("flash_bias", out, ref))
        lse_within(lse, ref_lse)
        return out, lse

    def dkv(*args):
        dk, dv = saved[1](*args)
        rk, rv = fa.plain_bwd_dkv(*args)
        errs["flash_bias_dkv"].append(max(
            grad_within("flash_bias_dkv dk", dk, rk),
            grad_within("flash_bias_dkv dv", dv, rv)))
        return dk, dv

    def dq(*args):
        dq_, ds = saved[2](*args)
        rq, rs = fa.plain_bwd_dq(*args)
        errs["flash_bias_dq"].append(max(
            grad_within("flash_bias_dq dq", dq_, rq),
            grad_within("flash_bias_dq dbias", ds, rs)))
        return dq_, ds

    fa.flash_bias_fwd, fa.flash_bias_dkv, fa.flash_bias_dq = fwd, dkv, dq
    try:
        yield
    finally:
        fa.flash_bias_fwd, fa.flash_bias_dkv, fa.flash_bias_dq = saved


def drive_training(dev, card: str) -> dict:
    """MarkushGrapherConfig() trained through Trainer.train_step on seeded
    labelled pages (data.synthetic.labelled_batch: 512 text + 1024 patch
    positions, 512 decoder positions), TrainConfig from configs/train.yaml
    at batch TRAIN_BATCH without accumulation (bf16 compute over float32
    master weights, remat, the Swin frozen). Launch counts zeroed just
    before the first step and read after the last; the first step holds
    every flash call to its plain version; then TRAIN_WARM warm and
    TRAIN_TIMED timed steps. Returns the launch counts."""
    import torch

    from markushgrapher_torch.config import MarkushGrapherConfig
    from markushgrapher_torch.data.markush_tokenizer import MarkushTokenizer
    from markushgrapher_torch.data.synthetic import labelled_batch
    from markushgrapher_torch.models.markushgrapher import MarkushGrapherModel
    from markushgrapher_torch.ops import _build
    from markushgrapher_torch.train.trainer import Trainer

    cfg = MarkushGrapherConfig()
    tcfg, frozen = train_config()
    batch = labelled_batch(cfg, TRAIN_BATCH, SEED, MarkushTokenizer())
    with torch.device(dev):
        model = MarkushGrapherModel(cfg)
    trainer = Trainer(model=model, cfg=tcfg, frozen_prefixes=frozen)
    state = trainer.init_state(SEED)
    n_params = sum(p.numel() for p in model.parameters())
    n_frozen = n_params - sum(p.numel() for p in state.opt.params)
    length = cfg.max_seq_length + cfg.vtl.num_patches
    print(f"training slice: {n_params / 1e6:.1f}M float32 master params "
          f"({n_frozen / 1e6:.1f}M frozen: {frozen}), {tcfg.dtype} compute, "
          f"remat {tcfg.remat}, dropout {cfg.vtl.dropout_rate}, batch "
          f"{TRAIN_BATCH}, VTL L={length}, decoder "
          f"{cfg.max_seq_length_decoder}, labels per row "
          f"{(batch['labels'] != -100).sum(1).tolist()}", flush=True)
    errs = {name: [] for name in FLASH_BIAS}
    losses, norms, times = [], [], []
    torch.cuda.synchronize()
    _build.reset_launches()
    with checked_flash(errs):
        state, m = trainer.train_step(state, batch, SEED)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    for i in range(TRAIN_WARM + TRAIN_TIMED):
        if i == TRAIN_WARM:
            torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = trainer.train_step(state, batch, SEED)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        torch.cuda.synchronize()
        if i >= TRAIN_WARM:
            times.append(time.perf_counter() - t0)
    launches = dict(_build.LAUNCHES)
    layers, steps = cfg.vtl.num_layers, 1 + TRAIN_WARM + TRAIN_TIMED
    per_step = {"flash_bias": (2 if tcfg.remat else 1) * layers,
                "flash_bias_dkv": layers, "flash_bias_dq": layers}
    want = {k: 0 for k in KERNELS}
    want.update({k: n * steps for k, n in per_step.items()})
    for name, e in errs.items():
        print(f"  inside the training step, {name} vs plain on the same "
              f"inputs: {len(e)} calls, max abs err {max(e):.3e}, all within "
              f"tolerance", flush=True)
    print(f"training: {steps} steps, launches {launches} (expected {want}); "
          f"loss per step {[round(x, 4) for x in losses]}, grad norm "
          f"{[round(x, 3) for x in norms]}", flush=True)
    if launches != want:
        raise AssertionError(f"training: launch counts {launches} != {want}")
    if {k: len(e) for k, e in errs.items()} != per_step:
        raise AssertionError(f"training: checked calls "
                             f"{ {k: len(e) for k, e in errs.items()} } != "
                             f"{per_step}")
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"training: non-finite loss or grad norm")
    ms = 1e3 * sum(times) / len(times)
    print(f"timing training b{TRAIN_BATCH}: {ms:.1f} ms/step (min "
          f"{1e3 * min(times):.1f}, max {1e3 * max(times):.1f} over "
          f"{len(times)} steps), {TRAIN_BATCH / (ms / 1e3):.3f} ex/s, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB allocated on "
          f"{card}", flush=True)
    return launches


def main() -> None:
    import torch

    # phase 1: device
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; the port's kernels need one")
    from markushgrapher_torch.config import MarkushGrapherConfig
    from markushgrapher_torch.data.markush_tokenizer import MarkushTokenizer
    from markushgrapher_torch.data.synthetic import page_batch
    from markushgrapher_torch.models.markushgrapher import MarkushGrapherModel
    from markushgrapher_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = gpu_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    print(f"device: {card} (count {torch.cuda.device_count()})", flush=True)

    # phase 2: build
    _build.lib()
    ptxas = [ln.strip() for ln in
             str(_build.build_info.get("ptxas", "")).splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"build: {_build.build_info['seconds']:.1f} s "
          f"({_build.library_path().name}); ptxas: {ptxas}", flush=True)

    # phase 3: kernels against their plain versions, at the batch's pack
    cfg = MarkushGrapherConfig()
    batch = 8
    mt = MarkushTokenizer()
    host = page_batch(cfg, batch, SEED, mt)
    pack, mv = cross_pack(cfg, host)
    kres = check_kernels(dev, pack)
    ocr = ocr_model(dev)
    kres.update(check_ocr_kernels(dev, ocr))
    kres.update(check_flash_bias(dev))

    # phase 4: the paths at full width, through Evaluator.generate_batch
    with torch.device(dev):
        model = MarkushGrapherModel(cfg)
    model.init_weights(SEED)
    model.to(torch.bfloat16).eval()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"slice: {n_params / 1e6:.1f}M params bf16, batch {batch}, valid "
          f"encoder max {mv} -> cross pack {pack}", flush=True)
    layers = cfg.vtl.num_decoder_layers
    launches = {}
    for name, int4, beams, steps in PATHS:
        res = drive_path(model, mt, cfg, host, int4, beams, steps)
        ids = res["ids"]
        dec = "decode_int4" if int4 else "decode_i8"
        want = {k: 0 for k in KERNELS}
        want.update(bias_build_i8=1, flash_i8=cfg.vtl.num_layers)
        want[dec] = 2 * layers * steps
        print(f"{name}: {steps} steps, launches {res['launches']} (expected "
              f"{want}); first run {res['first_s']:.2f} s", flush=True)
        for kname, (err, n) in res["inside"].items():
            print(f"  inside the model, {kname} vs plain on the same inputs: "
                  f"{n} calls (the encode, {CHECKED_STEPS} decode steps), "
                  f"max abs err {err:.3e}, all within tolerance", flush=True)
        if res["launches"] != want:
            raise AssertionError(f"{name}: launch counts {res['launches']} "
                                 f"!= {want}")
        if ids.shape != (batch, steps) or ids.min() < 0 \
                or ids.max() >= cfg.vtl.vocab_size:
            raise AssertionError(f"{name}: bad ids {ids.shape} "
                                 f"[{ids.min()}, {ids.max()}]")
        if set(res["inside"]) != {"bias_build_i8", "flash_i8", dec}:
            raise AssertionError(f"{name}: kernels checked inside the model: "
                                 f"{sorted(res['inside'])}")
        for r in range(2):
            print(f"  row {r}: {mt.decode(ids[r][:40])[:160]!r}", flush=True)
        for kname, n in res["launches"].items():
            launches[kname] = launches.get(kname, 0) + n
    e2e = compare_to_plain(model, cfg, host, dev)
    print(f"greedy_int4 end to end vs the plain path: encoder states rel L2 "
          f"{e2e['enc_err']:.3e}, first 8 greedy tokens match "
          f"{e2e['match_e2e']:.3f}, decode alone on the kernel path's encoder "
          f"states {e2e['match_dec']:.3f}", flush=True)
    for seed, err, match in e2e["nudged"]:
        print(f"control, plain path vs itself with a half-ulp nudge of layer "
              f"0's input (noise seed {seed}): encoder states rel L2 "
              f"{err:.3e}, first 8 greedy tokens match {match:.3f}",
              flush=True)
    if not (e2e["masks_equal"] and e2e["finite"]):
        raise AssertionError("encoder mask differs or states not finite")

    # phase 4, OCR: the three paths through ChemicalOCR.generate_batch
    pages = torch.tensor(np.random.RandomState(SEED).randint(
        0, 256, (OCR_BATCH, 512, 512, 3)), dtype=torch.uint8, device=dev)
    tok = mt.tokenizer
    t = ocr.cfg.text
    l0 = ocr_prefix_len(ocr)
    print(f"OCR slice: {sum(p.numel() for p in ocr.parameters()) / 1e6:.1f}M "
          f"params bf16, batch {OCR_BATCH}, L0 {l0}, ring "
          f"{l0 + OCR_TOKENS + (-(l0 + OCR_TOKENS)) % 128}", flush=True)
    for name, flags, kname in OCR_PATHS:
        res = drive_ocr_path(ocr, tok, pages, flags, dev)
        ids = res["ids"]
        want = {k: 0 for k in KERNELS}
        want[kname] = (OCR_TOKENS - 1) * (
            1 if kname == "ocr_megastep" else t.num_layers)
        print(f"{name}: {OCR_TOKENS} tokens, launches {res['launches']} "
              f"(expected {want}); first run {res['first_s']:.2f} s",
              flush=True)
        for kn, (err, n) in res["inside"].items():
            print(f"  inside the model, {kn} vs plain on the same inputs: {n} "
                  f"calls ({CHECKED_STEPS} decode steps"
                  f"{', each layer by layer' if kn == 'ocr_megastep' else ''})"
                  f", max abs err {err:.3e}, all within tolerance", flush=True)
        if res["step_rel"]:
            print(f"  whole megastep vs plain: relative L2 up to "
                  f"{max(res['step_rel']):.3e} (gate {WHOLE_STEP_REL})",
                  flush=True)
        if res["launches"] != want:
            raise AssertionError(f"{name}: launch counts {res['launches']} "
                                 f"!= {want}")
        if tuple(ids.shape) != (OCR_BATCH, OCR_TOKENS) or int(ids.min()) < 0 \
                or int(ids.max()) >= t.vocab_size:
            raise AssertionError(f"{name}: bad ids {tuple(ids.shape)}")
        if set(res["inside"]) != {kname}:
            raise AssertionError(f"{name}: kernels checked inside the model: "
                                 f"{sorted(res['inside'])}")
        for r, text in enumerate(res["texts"]):
            print(f"  row {r}: {text[:120]!r}", flush=True)
        for kn, n in res["launches"].items():
            launches[kn] = launches.get(kn, 0) + n
    ids_k = ocr_engine(ocr, tok, OCR_PATHS[0][1], dev,
                       8).generate_batch_async(pages)
    ocr.use_kernels = False
    try:
        ids_p = ocr_engine(ocr, tok, OCR_PATHS[0][1], dev,
                           8).generate_batch_async(pages)
    finally:
        ocr.use_kernels = True
    print(f"ocr_int4 end to end vs the plain path: first 8 tokens match "
          f"{float((ids_k == ids_p).float().mean()):.3f}", flush=True)

    # phase 5: timing (warm), 512 steps, eos never firing
    hosts = {8: host}
    for label, int4, beams, sizes in (("greedy int4", True, 1, (8, 48)),
                                      ("beam-5 int4", True, 5, (8, 16)),
                                      ("greedy int8", False, 1, (8, 48))):
        for b in sizes:
            if b not in hosts:
                hosts[b] = page_batch(cfg, b, SEED + 1, mt)
            t = time_path(model, mt, cfg, hosts[b], dev, int4, beams)
            print(f"timing {label} b{b}: encode {t['encode_ms']:.1f} ms, "
                  f"decode {t['decode_ms_per_step']:.3f} ms/step, "
                  f"{t['img_per_s']:.3f} img/s ({cfg.max_seq_length_decoder} "
                  f"steps, cross pack {t['cross_pack']}, peak "
                  f"{t['peak_gb']:.1f} GB) on {card}", flush=True)
    for name, flags, _ in OCR_PATHS:
        t = time_ocr_path(ocr, tok, pages, flags, dev)
        print(f"timing {name} b{OCR_BATCH}: prefill {t['prefill_ms']:.1f} ms, "
              f"decode {t['ms_per_step']:.3f} ms/step, {t['img_per_s']:.3f} "
              f"img/s ({OCR_TOKENS} new tokens) on {card}", flush=True)
    t = time_pipeline(ocr, model, mt, cfg, pages, dev)
    print(f"timing pipeline b{OCR_BATCH} (pages -> OCR int4, {OCR_TOKENS} "
          f"tokens -> cells -> MG greedy int4, "
          f"{cfg.max_seq_length_decoder} steps): {t['img_per_s']:.3f} img/s "
          f"(OCR {t['ocr_s']:.2f} s, MG {t['mg_s']:.2f} s; rows with "
          f"grammar cells {t['grammar_rows']} of {OCR_BATCH}) on {card}",
          flush=True)

    # phase 6: training at full width through Trainer.train_step
    del model, ocr
    gc.collect()
    torch.cuda.empty_cache()
    for name, n in drive_training(dev, card).items():
        launches[name] = launches.get(name, 0) + n

    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=launches[name], **kres[name])
               for name, (src, rep) in KERNELS.items()]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
