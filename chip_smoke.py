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
   for sm_90a, one nvcc per source, all at once; prints ptxas's registers,
   spills and static shared memory of the wgmma kernels (the three encoder
   forwards and the two float-bias backward kernels), of the OCR
   megastep (one instantiation per batch tiling), of the decode cluster
   core under both element policies, int4 and int8 (one instantiation per
   count of query rows a CTA serves), of bias_build_i8, of normalize_u8
   and of wq_linear (three weight forms x 1-8 row tiles a pass, and the
   W8A8 row quantiser);
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the main paths give it, with the stated tolerance, timed
   against it, beside its bound (bytes over 3.35 TB/s or operations over
   989 TFLOP/s bf16, whichever is larger) and the share of the bound it
   reaches, and, where one PyTorch call computes the same function, that
   call's time and the kernel's ratio to it. bias_build_i8 bit for bit at
   B=2, 8 and 48 (H=16, L=1536) and on the packed slab (B=8, L=1280, seeded
   positions), from float32 tables and from the same tables in bf16 (as
   the served model holds them); its launches alone and the whole wrapper
   call each timed on the bf16 tables.
   flash_i8 over the int8 slab
   at B=2 and at the serving batch B=8, L=1536, H=16, D=64, 25 % of the
   keys masked, against SDPA with the dequantised bias and mask as a bf16
   attn_mask. flash_relbias (the bias
   computed in the kernel) at B=2 and B=8, L=1536, H=16, D=64, bf16, with
   padded keys, and the CUDA-core floor of computing its bias beside the
   bound: no PyTorch call builds the relative bias, so its library
   time is none (SDPA over a prebuilt bf16 slab is printed for scale).
   The OCR shapes: the
   megastep at OCRConfig() width, batch 8, ring L0 + 512, at p = L0 and
   p = L0 + 400, and at batch 48 (MEGA_BATCH) at p = L0 + 400;
   decode_int4 (G = 5) and decode_i8 (15 rows over 5 kv heads) over that
   ring, and over continuous batching's ring (L0 + 256, rows at their own
   positions spread over [103, 358] under a per-row mask [B, 1, S], read
   up to the block of the largest), and decode_i8 on decode_bench.py's
   seeded OCR ring (full-range int8, q at 0.5 scale, a random bias up to
   p = 503); decode_int4 also with the 5 beams folded over the greedy cross's
   1792 keys, beside the greedy cross over the same slab; both decode
   kernels also at several waves of CTAs: the greedy cross at B=48 and the
   beam cross at B=16, Kp=1792. The float-bias flash forward at its serving shapes
   (B=2, B=8) and forward + both backward kernels at the training shape (B=8),
   L=1536, H=16, D=64, bf16 bias with 25 % of the keys masked, against
   SDPA with the bias as attn_mask as the library yardstick (SDPA's one
   backward call, which computes dq, dk, dv and d(mask) together, is also
   set against the sum of the two backward kernels). The beam-5
   self ring (40 rows, ring 512) as copy-on-write segments of 128 with a
   random row map: decode_int4 / decode_i8 read through the map, up to the
   valid prefix, and both; lattice_self_int4 at 1 and 4 live segments;
   normalize_u8 over [8, 512, 512, 3] uint8 pages (VTLConfig().image_size,
   the OCR page size) into bf16 and float32, and [48, ...] into bf16, bit
   for bit, timed over enough page batches in turn that each call reads
   its pages from HBM. No PyTorch call reads row-mapped packed int4 / scaled int8 K/V
   or normalises uint8 in one call: their library time is none.
   wq_linear (the quantised decode projections) in its three forms, int8
   and int4 weights and W8A8 (bit for bit), at every MG and OCR projection
   shape (WQ_SHAPES) and 8, 48 and 80 rows, over weight copies in turn
   past the L2, beside F.linear over the weights dequantised beforehand
   (W8A8: torch._int_mm on the same codes) and, for int8, the port's
   projection before this kernel;
4. paths: the flagship 831M MarkushGrapherConfig() with seeded random bf16
   weights, served through `Evaluator.generate_batch` at batch 8 with eos
   never firing, along eleven paths (PATHS): over the int8 slab encoder,
   greedy under int4 KV for 512 steps, beam-5 under int4 KV for 128 steps,
   greedy under int8 KV for 128 steps, and beam-5 under int8 KV for 128
   steps (int8 decode weights); `configs/predict.yaml`'s route, the bf16
   slab encoder (`flash_bias`) and beam-5 over bf16 KV caches with the bf16
   weights, 128 steps; greedy int4 over the in-kernel bias (`flash_relbias`)
   and over the packed encoder (pack: the ceil-256 of the batch's VTL valid
   count), 128 steps each; beam-5 int4 over copy-on-write rings of four
   128-position segments (`self_seg=128`) and with the lattice
   (`lattice=True`), 512 steps each; beam-5 int8 over segments of 128, 256
   steps; greedy int4 under `block_skip`, 512 steps (all but predict.yaml's
   with int8 decode weights through wq_linear); then greedy int4 with int4
   weights and with W8A8 dots (WQ_PATHS, 128 steps) through
   `greedy_generate`, as JAX's bench.py serves them. The packed encoder's
   states are held to the unpacked ones at the valid positions, both on the
   plain path in float32. Then OCRConfig() (seeded random bf16 weights)
   through `ChemicalOCR.generate_batch` on seeded uint8 pages at batch 8,
   eos never firing, along six paths: int4 KV and int8 KV (128 new
   tokens), the megastep (int8 KV, one launch per step, 512), int4 KV
   under `block_skip` (128), and int4 KV with int4 weights and with W8A8
   dots (128); then through `ChemicalOCR.stream_retired`
   (continuous batching) along two (OCR_STREAM_PATHS: int4 KV under
   `block_skip`, int8 KV), 16 seeded pages with seeded lognormal budgets
   (median 64, sigma 1, clipped to [16, 256], every 8th page at 256), 8
   rows, refill waves of 4, 32 steps a chunk: every page back once with
   exactly its budget of ids, one decode launch a layer a step, the per-row
   bias and (under block_skip) live keys below the ring's length in the
   decode calls, and the kernel calls of the first 8 steps and of the 8
   after the first refill wave held to their plain versions. For each
   path: the launch counts of every kernel, wq_linear's one a projection
   a step (every count set to 0 just before the path, read just after),
   the forms of the decode calls (through a row map, up to a valid
   prefix, the lattice) that the path's options must show, and every
   kernel call of the encode (MG) and of the first 8 decode steps held to
   its plain version on the same inputs (the megastep one layer at a time
   and as a whole step; each wq_linear call, W8A8 bit for bit). For the
   int4 greedy path also the end-to-end difference from the plain path beside a half-ulp-nudge control; for every path a
   few rows decoded to strings. Then the OCR pages through
   `ops.preprocess.preprocess_patchify` into MG's VTL patch vectors (one
   normalize_u8 launch), held to its reference bit for bit;
5. timing: encode ms of each encoder route (int8 slab, bf16 slab,
   in-kernel bias, packed) at batch 8 and 48; encode ms, decode ms/step and
   img/s over 512 steps of int4 greedy with and without `block_skip` at
   batch 8 and 48, beam-5 (int4) over one ring segment, segments of 128
   and the lattice at batch 8, int8 greedy at batch 48 (all over the
   int8 slab), and predict.yaml's beam-5 over the bf16 slab and bf16 KV at
   batch 8; greedy int4 with int8 weights, int4 weights, W8A8 and int8
   weights again, in turns, over 128 steps at batch 8;
   the decode kernels launched per step of each of these runs,
   from the launch counters (int4 greedy at batch 8: at most one per
   attention call, 48); OCR prefill ms, ms/step and img/s of the int4, int8 and
   megastep paths at batch 8 and of the megastep at batch 48, 512 new
   tokens, and of int4 KV with int8 weights, int4 weights and W8A8 at
   128; the int4 stream (warm): ms per decode step beside the batched
   int4 path's, img/s, tokens/s, the first and the refill prefills' ms and
   decode launches a step; and one
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
import copy
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
    "flash_relbias": ("markushgrapher_torch/csrc/flash_relbias.cu",
                      "markushgrapher_tpu/ops/flash_relbias.py:111"),
    # the lattice runs decode_int4.cu's entry (the cluster core,
    # csrc/decode_cluster.cuh) with a row map over its live segments
    "lattice_self_int4": ("markushgrapher_torch/csrc/decode_int4.cu",
                          "markushgrapher_tpu/ops/mxu_decode.py:666"),
    "normalize_u8": ("markushgrapher_torch/csrc/normalize_u8.cu",
                     "markushgrapher_tpu/ops/preprocess.py:33"),
    # no Pallas counterpart: the JAX package leaves the quantised decode
    # products to XLA, the fused convert + dot of `_deq` (t5.py:100) and the
    # s8 dot of `_dot8` (t5.py:117)
    "wq_linear": ("markushgrapher_torch/csrc/wq_linear.cu",
                  "markushgrapher_tpu/models/t5.py:100"),
}
# the decode attention kernels, whose calls inside the model are checked for
# the first CHECKED_STEPS decode steps
DECODE_KERNELS = ("decode_int4", "decode_i8", "lattice_self_int4")
FLASH_BIAS = ("flash_bias", "flash_bias_dkv", "flash_bias_dq")
# the kernel symbols of the wgmma kernels whose ptxas register, spill and
# shared-memory report phase 2 prints: the three encoder forwards
# (flash_fwd_sm90.cuh) and the two float-bias backward kernels
# (flash_bias_bwd.cu)
FLASH_FWD_SYMBOLS = ("flash_i8_kernel", "flash_bias_fwd_kernel",
                     "flash_relbias_kernel")
FLASH_BWD_SYMBOLS = ("flash_bias_dkv_kernel", "flash_bias_dq_kernel")
# the OCR megastep's instantiations (batch tiles of 8, 16, 48 rows) and
# the decode cluster core's (int4 and int8 policies, 1-10 query rows a CTA,
# tensor cores or CUDA cores)
MEGASTEP_SYMBOLS = ("ocr_megastep_kernel",)
DECODE_SYMBOLS = ("decode_cluster_kernel",)
# bias_build_i8 (its table kernel; the slab kernel on aligned / ragged
# rows) and the image front end (warp tiles / bytes, float32 / bf16)
ELEMENTWISE_SYMBOLS = ("bias_build_table", "bias_build_i8_kernel",
                       "normalize_u8_")
# wq_linear's instantiations and its W8A8 row quantiser
WQ_SYMBOLS = ("wq_linear_",)
# the card's published peaks (H100 SXM, dense, 700 W): HBM bytes/s and bf16
# tensor-core FLOP/s; a kernel's bound is the larger of its bytes and its
# operations over these
PEAK_BYTES, PEAK_FLOPS = 3.35e12, 989e12
# and its dense int8 tensor rate, operations a second
PEAK_INT8_OPS = 1979e12
# its L2 (H100 SXM: 50 MB)
L2_BYTES = 50 * 2 ** 20
# the CUDA cores (H100 SXM, 700 W): 67 TFLOP/s FP32 is 128 lanes a clock on
# each of 132 SMs at 1.98 GHz, also the rate at which an SM issues warp
# instructions (4 schedulers x 32 lanes); shared memory serves 32 words a
# clock per SM
PEAK_LANE_OPS, PEAK_SMEM_WORDS = 67e12 / 2, 132 * 32 * 1.98e9
# flash_relbias's bias on the CUDA cores, per score (csrc/flash_fwd_sm90.cuh
# rel2 / rel_bias): two 2d terms of 7 instructions (sub, mul, min |d|,
# add.rz, compare, select, shift-add) and a shared load each, two adds, half
# a shared load of key centres; one more load on key tiles near the
# diagonal (the 1d table), one select and a quarter load in tiles with a
# masked key
REL_OPS, REL_LOADS = 16, 2.5
# kernel-vs-plain tolerances (|kernel - plain| <= atol + rtol * |plain|):
#  - bias_build_i8 and normalize_u8 are exact (same LUT buckets, same
#    float32 op order);
#  - flash_i8, decode_int4 and decode_i8 return bf16, and sum in another
#    order than the plain float32 matmuls: two bf16 ulps (2 * 2^-7
#    relative), plus a small absolute floor for outputs near zero. The
#    decode kernels (and the lattice) also round p * vs to bf16 inside, where
#    a one-ulp flip of one weight can move the output by a little more; over
#    blocks of keys they also rescale by exp(m_j - m_last) where the plain
#    version multiplies the running factors, a float32 difference.
#  - wq_linear's int8 / int4 forms: both versions sum the exact products in
#    float32 (in another order), round the sum to bf16, scale it in float32
#    and round again: the two roundings can each land a bf16 ulp apart, two
#    ulps in all (2 * 2^-7 relative). Its W8A8 form sums integers exactly
#    and is held bit for bit, here and inside the model.
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
       "decode_i8": (2e-3, 2e-2), "lattice_self_int4": (2e-3, 2e-2),
       "ocr_megastep": (8e-3, 1.6e-2),
       "flash_bias": (1e-3, 1.6e-2), "flash_relbias": (1e-3, 1.6e-2),
       "wq_linear": (1e-3, 1.6e-2)}
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
# phase 4's paths at batch 8: (name, encoder route of
# models.markushgrapher.ROUTES, KV scheme, beams, decode steps, options).
# "bf16": float caches and weights, the route of configs/predict.yaml; the
# others decode with int8 weights. Options: the beam's copy-on-write ring
# segment (`self_seg`) and `lattice` (EvalConfig), the model's
# `block_skip`. A segmented path runs at least two segments.
PATHS = (("greedy_int4", "int8 slab", "int4", 1, 512, {}),
         ("beam5_int4", "int8 slab", "int4", 5, 128, {}),
         ("greedy_int8", "int8 slab", "int8", 1, 128, {}),
         ("beam5_int8", "int8 slab", "int8", 5, 128, {}),
         ("predict_beam5_bf16", "bf16 slab", "bf16", 5, 128, {}),
         ("inkernel_greedy_int4", "in-kernel bias", "int4", 1, 128, {}),
         ("packed_greedy_int4", "packed", "int4", 1, 128, {}),
         ("beam5_int4_seg128", "int8 slab", "int4", 5, 512,
          dict(self_seg=128)),
         ("beam5_int4_lattice", "int8 slab", "int4", 5, 512,
          dict(lattice=True)),
         ("beam5_int8_seg128", "int8 slab", "int8", 5, 256,
          dict(self_seg=128)),
         ("greedy_int4_block_skip", "int8 slab", "int4", 1, 512,
          dict(block_skip=True)))
# phase 4's greedy paths under int4 KV over the int8 slab through
# greedy_generate, as JAX's bench.py serves the decode-weight modes (its
# BENCH_W_INT4 / BENCH_W_ACT8): (name, generate's weight flags), WQ_STEPS
# steps, each also timed in phase 5 beside int8 weights
WQ_PATHS = (("greedy_int4_w4", dict(weight_bits=4)),
            ("greedy_int4_w8a8", dict(act_quant=True)))
WQ_STEPS = 128
# the kernels one encode launches along each route
ROUTE_KERNELS = {"int8 slab": ("bias_build_i8", "flash_i8"),
                 "bf16 slab": ("flash_bias",),
                 "in-kernel bias": ("flash_relbias",),
                 "packed": ("bias_build_i8", "flash_i8")}
# packed encoder against unpacked, both on the plain path in float32 at the
# valid positions: the same keys in another summation order, through 24
# layers of random weights
PACK_REL = 2e-3
CHECKED_STEPS = 8
# copy-on-write ring segment of the kernel checks (phase 3)
SEG = 128
# the OCR paths: batch, new tokens, and (name, OCREngineConfig flags, the
# kernel each decode step launches, options: the model's block_skip, the
# path's new tokens, default OCR_TOKENS, and the new tokens of its phase-5
# timing, default OCR_TOKENS)
OCR_BATCH, OCR_TOKENS = 8, 512
# the megastep's large-batch case: phase 3's check and phase 5's timing
MEGA_BATCH = 48
OCR_PATHS = (
    ("ocr_int4", dict(quant_kv=True, int4_kv=True, quant_weights=True),
     "decode_int4", dict(tokens=128)),
    ("ocr_int8", dict(quant_kv=True, quant_weights=True), "decode_i8",
     dict(tokens=128)),
    ("ocr_mega", dict(quant_kv=True, quant_weights=True, megastep=True),
     "ocr_megastep", {}),
    ("ocr_int4_block_skip",
     dict(quant_kv=True, int4_kv=True, quant_weights=True), "decode_int4",
     dict(block_skip=True, tokens=128)),
    ("ocr_int4_w4", dict(quant_kv=True, int4_kv=True, quant_weights=True,
                         weight_bits=4), "decode_int4",
     dict(tokens=128, timed=128)),
    ("ocr_int4_w8a8", dict(quant_kv=True, int4_kv=True, quant_weights=True,
                           act_quant=True), "decode_int4",
     dict(tokens=128, timed=128)))
# continuous batching's OCR paths (phase 4; the first also timed in phase
# 5): STREAM_PAGES seeded pages through OCR_BATCH rows, at most STREAM_TOKENS
# new tokens, refill waves of STREAM_REFILL rows, STREAM_INNER steps a chunk,
# eos never firing and pad_id -1 (no token id), so each page's ids are
# exactly its budget long; (name, OCREngineConfig flags, the kernel each
# decode step launches, the model's block_skip)
STREAM_PAGES, STREAM_TOKENS, STREAM_REFILL, STREAM_INNER = 16, 256, 4, 32
OCR_STREAM_PATHS = (
    ("ocr_int4_stream",
     dict(quant_kv=True, int4_kv=True, quant_weights=True), "decode_int4",
     True),
    ("ocr_int8_stream", dict(quant_kv=True, quant_weights=True),
     "decode_i8", False))


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def ptxas_usage(log: str, keys) -> list:
    """[(entry function, its registers, spills and static shared memory)]
    from `nvcc -Xptxas -v` output, for the entry functions whose mangled
    name contains one of `keys`."""
    out, name, spill = [], None, ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            sym = ln.split("'")[1]
            name = next((sym for k in keys if k in sym), None)
            spill = ""
        elif name and "spill" in ln:
            spill = ln.strip()
        elif name and "Used" in ln:
            out.append((name, f"{ln.split(':', 1)[1].strip()}; {spill}"))
            name = None
    return out


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


def in_turns(fn, inputs: list):
    """A call of fn on the next of `inputs` in turn that keeps its output
    until that input comes round again: with the inputs and outputs
    together several times the card's L2 (L2_BYTES), each call reads its
    input from HBM and writes its output over lines no longer in L2."""
    keep, turn = [None] * len(inputs), [0]

    def call():
        k = turn[0] % len(inputs)
        turn[0] += 1
        keep[k] = fn(inputs[k])
    return call


def turns_past_l2(per_call_bytes: int) -> int:
    """How many inputs `in_turns` needs to cycle over 4 x L2_BYTES."""
    return max(2, -(-4 * L2_BYTES // per_call_bytes))


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


def bound(n_bytes: float, flops: float, peak: float = PEAK_FLOPS) -> dict:
    """The least time the card could take: bytes over the HBM rate or
    operations over the tensor rate (bf16 unless `peak` says otherwise),
    whichever is larger."""
    by_bytes, by_ops = n_bytes / PEAK_BYTES, flops / peak
    return dict(bound_ms=max(by_bytes, by_ops) * 1e3,
                bound_by="bytes" if by_bytes >= by_ops else "operations")


def decode_bound(q, kq, ks, vq, vs, bias, out) -> dict:
    """Bound of one decode attention call on this run's data: only the keys
    that some query row of a sample does not mask (bias above -1e8) need
    their K/V and scale bytes read (each sample its own keys under a
    per-row mask); 4 operations per (query row, live key, head dim)."""
    share = float((bias.amax(dim=1) > -1e8).float().mean())
    kv_bytes = nbytes(kq, vq, ks, vs) * share
    flops = 4 * q.shape[0] * q.shape[1] * share * kq.shape[1] * q.shape[2]
    return bound(nbytes(q, bias, out) + kv_bytes, flops)


def decode_run(name, kernel, plain, args, kw, iters=50) -> dict:
    """A decode kernel against its plain version on the same inputs (the
    six operands q, K, K scales, V, V scales, bias, and the options kw),
    timed, beside its bound."""
    import torch

    got = kernel(*args, **kw)
    err = within(name, got, plain(*args, **kw))
    torch.cuda.synchronize()
    return dict(max_abs_err=err,
                ms=cuda_ms(lambda: kernel(*args, **kw), iters),
                plain_ms=cuda_ms(lambda: plain(*args, **kw), 20),
                library_ms=None, **decode_bound(*args, got))


def report(name: str, shape: str, res: dict) -> None:
    """A kernel's line: error, times, its bound and the share of the bound
    it reaches, and its ratio to the library call where there is one."""
    lib = res.get("library_ms")
    ratio = "" if lib is None else f" (kernel {res['ms'] / lib:.2f}x)"
    print(f"{name:<12} {shape}: max abs err {res['max_abs_err']:.3e}; kernel "
          f"{res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, bound "
          f"{res['bound_ms']:.4f} ms ({res['bound_by']}; "
          f"{res['bound_ms'] / res['ms']:.1%} of it reached), library "
          f"{'none' if lib is None else f'{lib:.4f} ms'}{ratio}", flush=True)


def bias_inputs(rng, dev, batch: int, length: int,
                packed: bool = False) -> tuple:
    """Inputs of bias_build_i8 drawn from `rng`: (t1, th, tv)
    [32, 16] float32 tables, sorted random boxes [B, L, 4] with text slots
    300-511 padded (zero boxes), the key mask, and for the packed slab the
    original indices of L of 1536 positions, sorted. Returns (args,
    positions)."""
    import torch

    tabs = [torch.tensor(rng.randn(32, 16).astype(np.float32) * 0.5,
                         device=dev) for _ in range(3)]
    bbox_np = np.sort(rng.rand(batch, length, 4).astype(np.float32), axis=-1)
    bbox_np[:, 300:512] = 0.0                       # padded text slots
    bbox = torch.tensor(bbox_np, device=dev)
    mask = (bbox.sum(-1) > 0).to(torch.int32)
    pos = None
    if packed:
        pos = torch.tensor(np.stack([np.sort(rng.permutation(1536)[:length])
                                     for _ in range(batch)]),
                           dtype=torch.int32, device=dev)
    return (*tabs, bbox, mask, length, 32, 128, 100, 100), pos


# bias_build_i8's shapes: (batch, length, packed); the first is the headline
BIAS_SHAPES = ((2, 1536, False), (8, 1536, False), (48, 1536, False),
               (8, 1280, True))


def check_bias_build(dev, rng) -> tuple:
    """bias_build_i8 bit for bit against its plain version at BIAS_SHAPES
    (the headline's inputs drawn from `rng`, the others' from seeds of
    their own), from float32 tables and from the same tables in bf16, then
    timed on the bf16 ones, as served, three ways: the kernels' launches
    alone (events around the launch), the whole wrapper call, the plain
    version; beside its bound (the slab's bytes). Returns the headline's
    result and slab."""
    import torch

    from markushgrapher_torch.ops import bias_build

    first = None
    for n, (b, length, packed) in enumerate(BIAS_SHAPES):
        args, pos = bias_inputs(
            rng if n == 0 else np.random.RandomState(SEED + 100 + n), dev, b,
            length, packed)
        for dt in (torch.float32, torch.bfloat16):
            args = (*(t.to(dt) for t in args[:3]), *args[3:])
            got, s_got = bias_build.encoder_position_bias_kernel_i8(
                *args, positions=pos)
            ref, s_ref = bias_build.plain(*args, positions=pos)
            torch.cuda.synchronize()
            if not (torch.equal(got, ref) and torch.equal(s_got, s_ref)):
                raise AssertionError(
                    f"bias_build_i8 B={b} L={length} {dt}: "
                    f"{int((got != ref).sum())} entries and "
                    f"{int((s_got != s_ref).sum())} scales differ from plain")
            del ref
        launch = bias_build.kernel_call(*args[:4], *args[5:], positions=pos)
        iters = 50 if b < 48 else 10
        res = dict(max_abs_err=0.0, ms=cuda_ms(launch, iters),
                   plain_ms=cuda_ms(lambda: bias_build.plain(
                       *args, positions=pos), 3 if b < 48 else 1, 1),
                   library_ms=None,
                   **bound(nbytes(*args[:5], got, s_got,
                                  *([] if pos is None else [pos])), 0))
        wrapper_ms = cuda_ms(lambda: bias_build.encoder_position_bias_kernel_i8(
            *args, positions=pos), iters)
        report("bias_build_i8", f"B={b} H=16 L={length}"
               f"{' packed' if packed else ''} (bit-exact from float32 and "
               f"bf16 tables; timed on bf16; whole wrapper "
               f"{wrapper_ms:.4f} ms)", res)
        if first is None:
            first = res, got
        del got, launch
        torch.cuda.empty_cache()
    return first


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

    # K1: int8 bias slab at B=2 (the headline), B=8 and B=48, and the
    # packed slab, bit-exact
    out["bias_build_i8"], got = check_bias_build(dev, rng)
    B, H, L = 2, 16, 1536

    # K2: flash over the int8 slab, bf16 q/k/v, 25 % of keys padded, at
    # B=2 (the headline) and at the serving batch B=8 (the slab repeated,
    # fresh q/k/v). Its library yardstick: SDPA with the dequantised bias
    # plus the key mask as a bf16 attn_mask and scale 1 (both made outside
    # the timing)
    D = 64
    scales = torch.tensor(rng.rand(H).astype(np.float32) * 0.05, device=dev)
    for fb, frng in ((B, rng), (4 * B, np.random.RandomState(SEED + 7))):
        q, k, v = (torch.tensor(frng.randn(fb, L, H, D).astype(np.float32)
                                * sc, device=dev).to(torch.bfloat16)
                   for sc in (0.3, 0.3, 1.0))
        slab = got if fb == B else got.repeat(fb // B, 1, 1, 1)
        kmask = torch.ones((fb, L), dtype=torch.int32, device=dev)
        kmask[:, int(L * 0.75):] = 0
        fargs = (q, k, v, slab, scales, kmask)
        f_got = flash_attention.flash_attention_bias_i8(*fargs)
        f_ref = flash_attention.plain(*fargs)
        torch.cuda.synchronize()
        attn_mask = (slab.float() * scales[None, :, None, None] + torch.where(
            kmask[:, None, None, :] > 0, 0.0, -1e30)).to(torch.bfloat16)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        res = dict(
            max_abs_err=within("flash_i8", f_got, f_ref),
            ms=cuda_ms(lambda: flash_attention.flash_attention_bias_i8(
                *fargs)),
            plain_ms=cuda_ms(lambda: flash_attention.plain(*fargs)),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=attn_mask, scale=1.0)),
            **bound(nbytes(q, k, v, slab, scales, kmask, f_got),
                    4 * fb * H * L * L * D))
        report("flash_i8", f"B={fb} H={H} L={L} D={D}", res)
        if fb == B:
            out["flash_i8"] = res
        del attn_mask, qt, kt, vt, f_got, f_ref, slab

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
        if int4:
            # the beam cross over the same slab: 5 beams folded into 80
            # query rows, each kv block's bytes read once for all of them
            report(name, f"beam cross B=8 R={beams * H} Kp={kp} head_map "
                   "(the greedy cross's slab)",
                   decode_run(name, kernel, plain,
                              (query(8, beams * H), *cargs[1:]),
                              dict(head_map=beam_map)))
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
        # the same ring as copy-on-write segments of 128 (a random row map
        # over the 40 rows): read through the map, up to the valid prefix
        # (3 of 4 blocks at step 300), and both
        rmap = torch.tensor(rng.randint(0, rows, (rows, ring // SEG)),
                            dtype=torch.int32, device=dev)
        prefix = mxu_decode.valid_prefix_blocks(ring, step, SEG)
        for form, kw in (("row map", dict(row_map=rmap, block_k=SEG)),
                         ("valid prefix", prefix),
                         ("row map + valid prefix",
                          dict(prefix, row_map=rmap))):
            report(name, f"self rows={rows} R={H} S={ring} step={step}, "
                   f"{form} (blocks of {SEG}, "
                   f"{kw.get('live_keys', ring)} keys read)",
                   decode_run(name, kernel, plain, sargs, kw))
        # several waves of CTAs: the greedy cross at B=48 and the beam cross
        # at B=16 over 1792 keys, 100 of them padded
        for nb, nq, kw in ((48, H, {}), (16, beams * H,
                                         dict(head_map=beam_map))):
            wk, wks = slab(nb, 1792, 1692, int4)
            wv, wvs = slab(nb, 1792, 1692, int4)
            report(name, f"{'beam ' if kw else ''}cross B={nb} R={nq} "
                   f"Kp=1792{' head_map' if kw else ''}",
                   decode_run(name, kernel, plain,
                              (query(nb, nq), wk, wks, wv, wvs,
                               cross_bias(nb, 1792, 1692)), kw))
            del wk, wks, wv, wvs

    # the lattice over the int4 rings of the same shape, 1 and 4 live
    # segments of 128 (steps 100 and 500), each read through the row map
    rmap = torch.tensor(rng.randint(0, rows, (rows, ring // SEG)),
                        dtype=torch.int32, device=dev)
    for n_live, lstep in ((1, 100), (4, 500)):
        rk, rks = slab(rows, ring, lstep + 1, True)
        rv, rvs = slab(rows, ring, lstep + 1, True)
        largs = (query(rows, H), rk, rks, rv, rvs, self_bias(ring, lstep))
        res = decode_run("lattice_self_int4", mxu_decode.lattice_self_int4,
                         mxu_decode.plain_lattice_int4, largs,
                         dict(row_map=rmap, n_live=n_live, seg=SEG))
        report("lattice_self_int4", f"rows={rows} R={H} S={ring} seg={SEG} "
               f"n_live={n_live} step={lstep}", res)
        out["lattice_self_int4"] = res

    # normalize_u8 over uint8 page batches: OCR / VTL pages (image size
    # 512) at b8 into bf16 (the headline) and float32 (what
    # preprocess_patchify takes), and at b48 into bf16. Exact against the
    # plain version; bound by its bytes, 1 in and 2 or 4 out per value,
    # and timed over copies of the pages in turn, so that it is HBM that
    # serves those bytes and not the L2
    from markushgrapher_torch.config import VTLConfig
    from markushgrapher_torch.ops import preprocess

    side = VTLConfig().image_size
    for b, dt in ((48, torch.bfloat16), (8, torch.float32),
                  (8, torch.bfloat16)):
        pages = torch.tensor(rng.randint(0, 256, (b, side, side, 3)),
                             dtype=torch.uint8, device=dev)
        got = preprocess.normalize_u8(pages, 0.5, 0.5, dt)
        if not torch.equal(got, preprocess.plain_normalize_u8(pages, 0.5,
                                                              0.5, dt)):
            raise AssertionError("normalize_u8 differs from plain")
        copies = [pages] + [pages.clone() for _ in range(
            turns_past_l2(nbytes(pages, got)) - 1)]
        res = dict(max_abs_err=0.0,
                   ms=cuda_ms(in_turns(lambda x: preprocess.normalize_u8(
                       x, 0.5, 0.5, dt), copies), 50),
                   plain_ms=cuda_ms(in_turns(
                       lambda x: preprocess.plain_normalize_u8(
                           x, 0.5, 0.5, dt), copies), 20),
                   library_ms=None,
                   **bound(nbytes(pages, got), 2 * pages.numel()))
        report("normalize_u8", f"[{b}, {side}, {side}, 3] uint8 -> "
               f"{str(dt).split('.')[-1]}", res)
        out["normalize_u8"] = res
        del pages, got, copies
    return out


# wq_linear's shapes: (label, K, N) of each decode projection of
# MarkushGrapherConfig() (d_model 1024, 16 heads of 64, d_ff 4096; the
# cross q and both o projections share a shape) and OCRConfig() (d_model
# 960, 15 + 2 x 5 heads of 64, d_ff 2560, gate and up stacked), at the rows
# of greedy b8 and b48 and of beam-5 b16
WQ_SHAPES = (("MG qkv", 1024, 3072), ("MG o", 1024, 1024),
             ("MG wi", 1024, 4096), ("MG wo", 4096, 1024),
             ("OCR qkv", 960, 1600), ("OCR o", 960, 960),
             ("OCR gate+up", 960, 5120), ("OCR down", 2560, 960))
WQ_ROWS = (8, 48, 80)
# (bits, act) of each weight form
WQ_FORMS = {"int8": (8, False), "int4": (4, False), "w8a8": (8, True)}
# wq_linear calls of one decode step and layer: MG qkv, self o, cross q,
# cross o, wi, wo; OCR qkv, o, gate + up, down
MG_PROJ, OCR_PROJ = 6, 4


def legacy_qlinear(x, w_q, s):
    """The port's decode projection before wq_linear: the whole int8 weight
    cast to x's dtype, the product in x's dtype, the float32 scale, the
    cast back."""
    import torch
    import torch.nn.functional as F

    return (F.linear(x, w_q.to(x.dtype)).to(torch.float32) * s).to(x.dtype)


def check_wq_linear(dev) -> dict:
    """wq_linear against its plain version in each weight form at each of
    WQ_SHAPES and WQ_ROWS (W8A8 bit for bit; the others within TOL), timed
    over enough copies of the weights in turn that each call reads its
    weights from HBM, beside its bound (weights, scales, x and y once; the
    products at the bf16 or int8 tensor rate), the library call (F.linear
    over the weights dequantised to bf16 beforehand, the product without
    the cast; for W8A8 torch._int_mm, cuBLASLt's s8 product, on the same
    codes, with the rows padded to 24 when fewer, as it takes only more
    than 16) and, for int8, the port's projection before this kernel
    (legacy_qlinear). Returns the headline, MG wi int8 at 8 rows."""
    import torch
    import torch.nn.functional as F

    from markushgrapher_torch.ops import wq_linear as wq

    gen = torch.Generator(device=dev).manual_seed(SEED)
    head = None
    for label, k, n in WQ_SHAPES:
        w = torch.randn((n, k), generator=gen, device=dev) * 0.02
        for form, (bits, act) in WQ_FORMS.items():
            w_q, w_s = wq.quantize_w(w, bits)
            copies = [(w_q, w_s)] + [
                (w_q.clone(), w_s.clone())
                for _ in range(turns_past_l2(nbytes(w_q)) - 1)]
            deq = (wq.unpack_w4(w_q) if bits == 4 else w_q).to(torch.bfloat16)
            deqs = [deq] + [deq.clone() for _ in range(
                turns_past_l2(nbytes(deq)) - 1)] if not act else []
            for rows in WQ_ROWS:
                x = torch.randn((rows, k), generator=gen,
                                device=dev).to(torch.bfloat16)
                got = wq.wq_linear(x, w_q, w_s, bits, act)
                ref = wq.wq_linear_plain(x, w_q, w_s, bits, act)
                torch.cuda.synchronize()
                if act and not torch.equal(got, ref):
                    raise AssertionError(
                        f"wq_linear {label} w8a8 rows={rows}: differs from "
                        f"plain at {int((got != ref).sum())} entries")
                res = dict(
                    max_abs_err=0.0 if act else within("wq_linear", got, ref),
                    ms=cuda_ms(in_turns(lambda c: wq.wq_linear(
                        x, c[0], c[1], bits, act), copies), 50),
                    plain_ms=cuda_ms(in_turns(lambda c: wq.wq_linear_plain(
                        x, c[0], c[1], bits, act), copies), 20),
                    **bound(nbytes(x, w_q, w_s, got), 2 * rows * k * n,
                            PEAK_INT8_OPS if act else PEAK_FLOPS))
                if act:
                    xq = F.pad(wq.quantize_act8(x)[0], (0, 0, 0, max(
                        0, 24 - rows)))
                    res["library_ms"] = cuda_ms(in_turns(
                        lambda c: torch._int_mm(xq, c[0].t()), copies), 50)
                else:
                    res["library_ms"] = cuda_ms(in_turns(
                        lambda d: F.linear(x, d), deqs), 50)
                report("wq_linear", f"{label} K={k} N={n} {form} rows={rows}",
                       res)
                if form == "int8":
                    legacy_ms = cuda_ms(in_turns(
                        lambda c: legacy_qlinear(x, *c), copies), 20)
                    print(f"  the port's projection before this kernel: "
                          f"{legacy_ms:.4f} ms", flush=True)
                if (label, form, rows) == ("MG wi", "int8", 8):
                    head = res
            del copies, deqs, deq
    return {"wq_linear": head}


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
    forward at row 3's serving shapes (B=2 and B=8) and forward + both
    backward kernels at the training shape (B=8), all L=1536, H=16, D=64,
    bf16 bias. Library yardstick: SDPA with the bias as attn_mask and scale 1,
    forward, and forward + backward with a grad-requiring mask (its backward
    computes dq, dk, dv and d(mask) in one; reported for each backward
    kernel and for their sum). Returns the training shape's rows."""
    import torch
    import torch.nn.functional as F

    from markushgrapher_torch.ops import flash_attention as fa

    H, L, D = 16, 1536, 64
    for sb, seed in ((2, SEED + 5), (TRAIN_BATCH, SEED + 8)):
        q, k, v, bias, _ = flash_bias_inputs(dev, sb, seed)
        got = fa.flash_attention_bias(q, k, v, bias)
        ref = fa.plain_bias(q, k, v, bias)
        torch.cuda.synchronize()
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        report("flash_bias", f"row 3 serving B={sb} H={H} L={L} D={D} bf16 "
               f"bias",
               dict(max_abs_err=within("flash_bias", got, ref),
                    ms=cuda_ms(lambda: fa.flash_attention_bias(q, k, v,
                                                               bias)),
                    plain_ms=cuda_ms(lambda: fa.plain_bias(q, k, v, bias), 5,
                                     1),
                    library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, attn_mask=bias, scale=1.0)),
                    **bound(nbytes(q, k, v, bias, got),
                            4 * sb * H * L * L * D)))
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
    pair = [out[n] for n in ("flash_bias_dkv", "flash_bias_dq")]
    both, both_bound = (sum(r[key] for r in pair)
                        for key in ("ms", "bound_ms"))
    print(f"flash_bias backward, dkv + dq, {shape}: kernels {both:.4f} ms, "
          f"bound {both_bound:.4f} ms ({both_bound / both:.1%} of it "
          f"reached), library {lib_bwd:.4f} ms (SDPA backward; kernels "
          f"{both / lib_bwd:.2f}x)", flush=True)
    return out


def relbias_inputs(dev, batch: int, seed: int):
    """flash_relbias's inputs at MG's encoder shape: bf16 q, k, v [B, 1536,
    16, 64], float32 bbox centres of seeded page boxes, a key mask with the
    text slots past 300 padded (as page_batch pads them), and three [32, 16]
    float32 tables N(0, 0.5^2)."""
    import torch

    L, H, D = 1536, 16, 64
    rng = np.random.RandomState(seed)
    q, k, v = (torch.tensor(rng.randn(batch, L, H, D).astype(np.float32)
                            * sc, device=dev).to(torch.bfloat16)
               for sc in (0.3, 0.3, 1.0))
    box = np.sort(rng.rand(batch, L, 4).astype(np.float32), axis=-1)
    hx = torch.tensor((box[..., 0] + box[..., 2]) / 2.0, device=dev)
    vy = torch.tensor((box[..., 1] + box[..., 3]) / 2.0, device=dev)
    mask = torch.ones((batch, L), dtype=torch.int32, device=dev)
    mask[:, 300:512] = 0
    tables = [torch.tensor(rng.randn(32, H).astype(np.float32) * 0.5,
                           device=dev) for _ in range(3)]
    return q, k, v, hx, vy, mask, tables


def relbias_floor(mask, heads: int, max1: int = 128) -> dict:
    """The CUDA-core floor of flash_relbias's bias on this run's inputs
    (REL_OPS, REL_LOADS): the instructions and shared loads its scores need
    over the SMs' issue and shared-load rates, the larger. A score of a key
    tile near a warp's 16 rows (not every distance at or past max1 on one
    side) loads its 1d term; a score of a tile with a masked key (or one at
    or past L) takes a select."""
    import torch

    batch, length = mask.shape
    tiles = -(-length // 64)
    k0 = torch.arange(tiles) * 64
    i0 = torch.arange(-(-length // 16)) * 16
    far = (k0[None, :] - (i0[:, None] + 15) >= max1) | \
        (k0[None, :] + 63 - i0[:, None] <= -max1)
    # scores per (warp, tile): 16 rows (those < L) x the tile's keys (< L)
    rows = (length - i0).clamp(max=16)
    keys = (length - k0).clamp(max=64)
    per = rows[:, None] * keys[None, :]
    near = int((per * ~far).sum()) * batch * heads
    pad = torch.ones((batch, tiles * 64), dtype=torch.bool)
    pad[:, :length] = mask.cpu() > 0
    masked_tiles = (~pad.view(batch, tiles, 64)).any(-1)     # [B, tiles]
    masked = int((masked_tiles.float() @ keys.float()).sum()) * length \
        * heads
    scores = batch * heads * length * length
    ops = REL_OPS * scores + masked
    loads = REL_LOADS * scores + near + 0.25 * masked
    by_issue = (ops + loads) / PEAK_LANE_OPS
    by_loads = loads / PEAK_SMEM_WORDS
    return dict(floor_ms=max(by_issue, by_loads) * 1e3,
                floor_by="issue" if by_issue >= by_loads else "shared loads",
                near=near / scores)


def check_flash_relbias(dev) -> dict:
    """flash_relbias against its plain version at B=2 and B=8 (the headline,
    MG's serving batch), H=16, L=1536, D=64, bf16. Bound: 4 B H L^2 D
    operations over the bf16 tensor rate (the bias costs no bytes: it is
    computed in the kernel); beside it the CUDA-core floor of computing the
    bias (`relbias_floor`). No single PyTorch call builds the relative
    bias, so library_ms is None; for scale only, SDPA over a prebuilt bf16
    slab (bias + mask) is timed and printed beside it."""
    import torch
    import torch.nn.functional as F

    from markushgrapher_torch.ops import flash_relbias as fr
    from markushgrapher_torch.ops.relbias import centre_position_bias

    out = {}
    for batch in (2, 8):
        q, k, v, hx, vy, mask, tables = relbias_inputs(dev, batch,
                                                       SEED + 7 + batch)
        args = (q, k, v, hx, vy, mask, *tables)
        got = fr.flash_attention_relbias(*args)
        ref = fr.plain(*args)
        torch.cuda.synchronize()
        B, L, H, D = q.shape
        slab = torch.where(mask[:, None, None, :] > 0, centre_position_bias(
            *tables, hx, vy, L, 32, 128, 100, 100), -1e30).to(torch.bfloat16)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=slab, scale=1.0))
        del slab, qt, kt, vt
        res = dict(max_abs_err=within("flash_relbias", got, ref),
                   ms=cuda_ms(lambda: fr.flash_attention_relbias(*args)),
                   plain_ms=cuda_ms(lambda: fr.plain(*args), 3, 1),
                   library_ms=None,
                   **bound(nbytes(q, k, v, hx, vy, mask, *tables, got),
                           4 * B * H * L * L * D))
        floor = relbias_floor(mask, H)
        report("flash_relbias", f"B={B} H={H} L={L} D={D} bf16, 212 of "
               f"{L} keys padded (library: none; for scale, SDPA over a "
               f"prebuilt bf16 slab {sdpa_ms:.4f} ms)", res)
        print(f"flash_relbias B={B}: CUDA-core floor of the bias "
              f"{floor['floor_ms']:.4f} ms ({floor['floor_by']}; "
              f"{floor['near']:.1%} of the scores on tiles near the "
              f"diagonal), {floor['floor_ms'] / res['ms']:.1%} of the "
              f"kernel's time", flush=True)
        del got, ref
        out["flash_relbias"] = res
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


def ocr_ring_len(model) -> int:
    """The engine's ring: L0 + OCR_TOKENS rounded up to 128."""
    ring = ocr_prefix_len(model) + OCR_TOKENS
    return ring + -ring % 128


def stream_ring_len(model) -> int:
    """The stream paths' ring: L0 + STREAM_TOKENS rounded up to 128."""
    ring = ocr_prefix_len(model) + STREAM_TOKENS
    return ring + -ring % 128


def mega_inputs(model, gen, batch: int, ring: int, pos: int) -> tuple:
    """The megastep's step inputs for `model` (OCRConfig() in phase 3):
    int8 K / V rings [L, batch, ring, G D] with scales in [0, 0.03) whose
    columns >= pos are zero, and bf16 x [batch, d_model], drawn from
    `gen` in that order."""
    import torch

    t = model.cfg.text
    n_layers, groups = t.num_layers, t.num_kv_heads
    dkv = groups * (t.d_model // t.num_heads)
    rings = {}
    for name in ("k", "v"):
        vals = torch.randint(-127, 128, (n_layers, batch, ring, dkv),
                             generator=gen, device=gen.device,
                             dtype=torch.int8)
        sc = torch.rand((n_layers, batch, groups, ring), generator=gen,
                        device=gen.device) * 0.03
        vals[:, :, pos:] = 0
        sc[..., pos:] = 0
        rings[name + "_q"], rings[name + "_s"] = vals, sc
    x = torch.randn((batch, t.d_model), generator=gen,
                    device=gen.device).to(torch.bfloat16)
    return x, rings


def check_ocr_kernels(dev, model) -> dict:
    """The kernels at the OCR shapes (OCRConfig() width, batch 8, ring
    L0 + 512 rounded up to 128): the megastep at p = L0 and p = L0 + 400
    (its headline), and at batch MEGA_BATCH at p = L0 + 400; decode_int4
    at G = 5 and decode_i8 at 15 rows over 5 kv heads, both at p = L0 +
    400. Returns {"ocr_megastep": {...}} (batch 8, p = L0 + 400)."""
    import torch

    from markushgrapher_torch.ops import megastep, mxu_decode

    t = model.cfg.text
    heads, groups, d = t.num_heads, t.num_kv_heads, t.d_model // t.num_heads
    l0 = ocr_prefix_len(model)
    ring = ocr_ring_len(model)
    w = model.megastep_pack()["lm"]
    kw = dict(heads=heads, groups=groups, rms_eps=t.rms_eps)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    b, n_layers, dkv = OCR_BATCH, t.num_layers, groups * d
    late = l0 + min(400, OCR_TOKENS - 1)
    out = {}
    for mb, pos in ((b, l0), (b, late), (MEGA_BATCH, late)):
        x, rings = mega_inputs(model, gen, mb, ring, pos)
        _, err, step_err, rel = mega_check(megastep.ocr_megastep, x, rings,
                                           w, model.rope(), pos, kw)
        torch.cuda.synchronize()
        live = {k: v[:, :, :pos] if k.endswith("_q") else v[..., :pos]
                for k, v in rings.items()}
        weights = sum(v.numel() for k, v in w.items() if v.dtype ==
                      torch.int8)
        flops = 2 * mb * weights + 4 * mb * heads * pos * d * n_layers
        res = dict(
            max_abs_err=err,
            ms=cuda_ms(lambda: megastep.ocr_megastep(
                x, rings, w, model.rope(), pos, **kw)),
            plain_ms=cuda_ms(lambda: megastep.plain_megastep(
                x, rings, w, model.rope(), pos, **kw), 3, 1),
            library_ms=None,
            **bound(nbytes(x, x, *w.values(), *live.values()), flops))
        report("ocr_megastep", f"L={n_layers} B={mb} S={ring} p={pos}; whole "
               f"step max abs err {step_err:.3e}, rel L2 {rel:.3e}", res)
        if mb == b:
            out["ocr_megastep"] = res
        del rings, live, x

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

    # continuous batching's ring (L0 + STREAM_TOKENS): rows at their own
    # positions, spread over [103, 358], under a per-row mask [B, 1, S],
    # read up to the 128-key block of the largest; past its slot a row's
    # keys hold another page's leftovers
    ring = stream_ring_len(model)
    slots = rng.permutation(np.linspace(103, 358, b).round().astype(int))
    keys = torch.arange(ring, device=dev)
    bias = torch.where(keys <= torch.tensor(slots, device=dev)[:, None, None],
                       0.0, torch.finfo(torch.float32).min)
    skip = mxu_decode.valid_prefix_blocks(ring, int(slots.max()), 128)
    for name, kernel, plain, top in (
            ("decode_int4", mxu_decode.cross_decode_mxu_int4,
             mxu_decode.plain_int4, 8),
            ("decode_i8", mxu_decode.cross_decode_mxu,
             mxu_decode.plain_int8, 128)):
        kv = []
        for _ in range(2):
            vt = torch.tensor(rng.randint(1 - top, top, size=(b, ring, dkv)),
                              dtype=torch.int8, device=dev)
            st = torch.tensor(rng.rand(b, groups, ring).astype(np.float32)
                              * 0.05, device=dev)
            kv += ([mxu_decode.pack_int4(vt), st.to(torch.bfloat16)]
                   if top == 8 else [vt, st])
        report(name, f"OCR stream ring B={b} R={heads} G={groups} S={ring} "
               f"slots {sorted(slots.tolist())} live_keys "
               f"{skip['live_keys']}", decode_run(name, kernel, plain,
                                                  (q, *kv, bias), skip))

    # decode_bench.py's seeded int8 OCR ring (full-range values, q at 0.5
    # scale, a random bias up to position 503)
    import decode_bench

    label = "OCR ring B=8 R=15 G=5 S=640"
    args, kw = {lab: (a, k) for lab, a, k in decode_bench.shapes(
        dev, "i8")}[label]
    report("decode_i8", f"decode_bench.py's {label} p=503", decode_run(
        "decode_i8", mxu_decode.cross_decode_mxu, mxu_decode.plain_int8,
        args, kw))
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


def drive_ocr_path(model, tok, pages, flags: dict, dev,
                   tokens: int = OCR_TOKENS) -> dict:
    """One OCR path through ChemicalOCR.generate_batch_async on uint8 pages,
    `tokens` new tokens, launch counts zeroed just before and read just
    after; every decode kernel call (or megastep) of the first
    CHECKED_STEPS steps held to its plain version on the same inputs."""
    import torch

    from markushgrapher_torch.ops import _build

    eng = ocr_engine(model, tok, flags, dev, tokens)
    errs: dict = {}
    layers = model.cfg.text.num_layers
    with checked_kernels(errs, CHECKED_STEPS * layers,
                         CHECKED_STEPS * OCR_PROJ * layers), \
            checked_megastep(errs, CHECKED_STEPS):
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        ids = eng.generate_batch_async(pages)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
    step_rel = errs.pop("ocr_megastep_step", [])
    forms = errs.pop("forms")
    return dict(ids=ids, texts=eng.decode_ids(ids[:2]), launches=launches,
                first_s=time.perf_counter() - t0, step_rel=step_rel,
                forms=forms,
                inside={name: (max(e), len(e)) for name, e in errs.items()
                        if e})


def time_ocr_path(model, tok, pages, flags: dict, dev,
                  tokens: int = OCR_TOKENS) -> dict:
    """Prefill ms, decode ms/step and img/s of one warm generate call of
    `tokens` new tokens (a 16-token call warms it up)."""
    import torch

    from markushgrapher_torch.data.device_pixels import ocr_from_uint8

    ocr_engine(model, tok, flags, dev, 16).generate_batch_async(pages)
    eng = ocr_engine(model, tok, flags, dev, tokens)
    prompt = eng.prompt_ids[None].expand(pages.shape[0], -1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.prefill(ocr_from_uint8(pages), prompt, tokens,
                  quant_kv=True, int4=flags.get("int4_kv", False))
    torch.cuda.synchronize()
    pre_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    eng.generate_batch_async(pages)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    return dict(prefill_ms=pre_ms,
                ms_per_step=(total * 1e3 - pre_ms) / (tokens - 1),
                img_per_s=pages.shape[0] / total)


def stream_budgets() -> np.ndarray:
    """The stream pages' token budgets: seeded lognormal (median 64, sigma
    1.0) clipped to [16, STREAM_TOKENS], every 8th page at STREAM_TOKENS."""
    rng = np.random.RandomState(SEED + 5)
    out = np.clip(np.round(64 * np.exp(rng.randn(STREAM_PAGES))), 16,
                  STREAM_TOKENS).astype(np.int64)
    out[7::8] = STREAM_TOKENS
    return out


@contextlib.contextmanager
def stream_probe(eng):
    """Count the stream's decode steps and time its prefills (the first
    fill and each refill wave, synchronised on both sides): yields a dict
    with "steps" and "prefill_ms", and "waves", called on the first wave's
    swap before it runs (a hook the caller may set)."""
    import torch

    probe = dict(steps=0, prefill_ms=[], waves=0, on_wave=None)
    model, step_fn = eng.model, eng.model.decode_step
    prefill_fn, swap_fn = eng._stream_prefill, eng._stream_swap

    def step(*a, **kw):
        probe["steps"] += 1
        return step_fn(*a, **kw)

    def prefill(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = prefill_fn(*a, **kw)
        torch.cuda.synchronize()
        probe["prefill_ms"].append((time.perf_counter() - t0) * 1e3)
        return out

    def swap(*a, **kw):
        if probe["waves"] == 0 and probe["on_wave"]:
            probe["on_wave"]()
        probe["waves"] += 1
        return swap_fn(*a, **kw)

    model.decode_step, eng._stream_prefill, eng._stream_swap = (
        step, prefill, swap)
    try:
        yield probe
    finally:
        del model.decode_step, eng._stream_prefill, eng._stream_swap


def run_stream(model, tok, pages, budgets, flags, dev, checked: int = 0):
    """One continuous-batching run through ChemicalOCR.stream_retired over
    `pages` with `budgets`, launch counts zeroed just before and read just
    after; with checked > 0 every decode kernel call of the first `checked`
    steps, and of the first `checked` steps after the first refill wave,
    held to its plain version on the same inputs."""
    import torch

    from markushgrapher_torch.ocr.engine import ChemicalOCR, OCREngineConfig
    from markushgrapher_torch.ops import _build

    eng = ChemicalOCR(model, tok, OCREngineConfig(
        max_new_tokens=STREAM_TOKENS, batch_size=OCR_BATCH, eos_id=-1,
        pad_id=-1, **flags), device=str(dev))
    calls = [checked * model.cfg.text.num_layers,
             checked * OCR_PROJ * model.cfg.text.num_layers]
    errs: dict = {}
    with (checked_kernels(errs, *calls) if checked else
          contextlib.nullcontext([0, 0])) as left, \
            stream_probe(eng) as probe:
        probe["on_wave"] = lambda: left.__setitem__(slice(None), calls)
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        retired = list(eng.stream_retired(
            pages, budgets, refill_batch=STREAM_REFILL, inner=STREAM_INNER))
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
    forms = errs.pop("forms", None)
    return dict(retired=retired, launches=launches, total_s=total,
                forms=forms, steps=probe["steps"], waves=probe["waves"],
                prefill_ms=probe["prefill_ms"],
                inside={name: (max(e), len(e)) for name, e in errs.items()
                        if e})


def check_stream(name: str, res: dict, budgets, kname: str, block_skip: bool,
                 layers: int, vocab: int) -> None:
    """A stream path's run: every page back once with exactly its budget
    of token ids (pad -1 after), the kernel launched once a layer a step,
    wq_linear once a projection a layer a step, and no other; where the
    run checked its kernel calls, the decode calls' forms (per-row bias;
    under block_skip live keys below the ring's length) and the kernels
    checked."""
    order = [i for i, _ in res["retired"]]
    if sorted(order) != list(range(len(budgets))):
        raise AssertionError(f"{name}: pages returned {order}")
    for i, ids in res["retired"]:
        b = int(budgets[i])
        if ids.shape != (STREAM_TOKENS,) or bool((ids[:b] < 0).any()) or \
                bool((ids[:b] >= vocab).any()) or bool((ids[b:] != -1).any()):
            raise AssertionError(f"{name}: page {i} (budget {b}) ids "
                                 f"{ids.tolist()}")
    want = {k: 0 for k in KERNELS}
    want[kname] = layers * res["steps"]
    want["wq_linear"] = OCR_PROJ * layers * res["steps"]
    if res["launches"] != want:
        raise AssertionError(f"{name}: launch counts {res['launches']} != "
                             f"{want} ({res['steps']} steps)")
    if res["forms"] is None:
        return
    need = {f"{kname} per-row bias"}
    if block_skip:
        need |= {f"{kname} live_keys", f"{kname} live_keys < keys"}
    if not need <= res["forms"]:
        raise AssertionError(f"{name}: decode calls {sorted(res['forms'])} "
                             f"lack the forms {sorted(need)}")
    if set(res["inside"]) != {kname, "wq_linear"}:
        raise AssertionError(f"{name}: kernels checked inside the model: "
                             f"{sorted(res['inside'])}")


def time_pipeline(ocr, mg, mt, cfg, pages, dev) -> dict:
    """uint8 pages -> OCR (int4 KV) -> cells -> MG greedy int4 over the int8
    slab (`mg` is a model on that route and scheme), timed end to end
    (warm models): img/s, the two stages' seconds, and how many rows
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
                   eos_id=-1, quant_cross_kv=True, quant_weights=True,
                   cross_pack_len=-(-mv // 256) * 256)
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
def checked_kernels(errs: dict, decode_calls: int = -1, wq_calls: int = -1):
    """Route the model's calls of each kernel wrapper through a check: the
    wrapper and its plain version run on the same inputs, the kernel's
    output is held to the kernel tolerance (bias_build_i8 and W8A8
    wq_linear: bit-exact; the others: TOL, on the attention output before
    the o-projection and the residual add, and on each projection's
    output), and the kernel's output goes on. errs[name] collects the max
    abs error of every checked call, errs["forms"] the forms of the
    decode kernels' calls ("decode_int4 row_map+live_keys", "decode_int4
    per-row bias", "decode_int4 live_keys < keys", ...). With
    decode_calls >= 0 only that many decode-kernel calls are checked, and
    with wq_calls >= 0 that many wq_linear calls; later ones go to the
    kernel alone (the context yields the two counts as a list, which the
    caller may raise again). The plain versions launch no kernel, so the
    launch counts stay those of the path."""
    import torch

    from markushgrapher_torch.ops import (bias_build, flash_attention,
                                          flash_relbias, mxu_decode,
                                          wq_linear)

    sites = {"bias_build_i8": (bias_build, "encoder_position_bias_kernel_i8",
                               bias_build.plain),
             "flash_i8": (flash_attention, "flash_attention_bias_i8",
                          flash_attention.plain),
             "flash_bias": (flash_attention, "flash_attention_bias",
                            flash_attention.plain_bias),
             "flash_relbias": (flash_relbias, "flash_attention_relbias",
                               flash_relbias.plain),
             "decode_int4": (mxu_decode, "cross_decode_mxu_int4",
                             mxu_decode.plain_int4),
             "decode_i8": (mxu_decode, "cross_decode_mxu",
                           mxu_decode.plain_int8),
             "lattice_self_int4": (mxu_decode, "lattice_self_int4",
                                   mxu_decode.plain_lattice_int4),
             "wq_linear": (wq_linear, "wq_linear",
                           wq_linear.wq_linear_plain)}
    saved = {name: getattr(mod, attr)
             for name, (mod, attr, _) in sites.items()}
    left = [decode_calls, wq_calls]

    forms = errs.setdefault("forms", set())

    def check(name, kernel, plain):
        def call(*args, **kw):
            if name in DECODE_KERNELS:
                forms.add(" ".join([name] + ["+".join(
                    k for k in ("row_map", "live_keys")
                    if kw.get(k) is not None)]).strip())
                if args[5].shape[0] > 1:
                    forms.add(f"{name} per-row bias")
                if kw.get("live_keys") is not None \
                        and kw["live_keys"] < args[1].shape[1]:
                    forms.add(f"{name} live_keys < keys")
                if left[0] == 0:
                    return kernel(*args, **kw)
                left[0] -= 1
            elif name == "wq_linear":
                if left[1] == 0:
                    return kernel(*args, **kw)
                left[1] -= 1
            got, ref = kernel(*args, **kw), plain(*args, **kw)
            # bias_build_i8 returns (slab, scales); wq_linear's args[4]:
            # W8A8
            exact = name == "bias_build_i8" or (name == "wq_linear"
                                                and args[4])
            if exact:
                pairs = zip(got, ref) if name == "bias_build_i8" else [
                    (got, ref)]
                if not all(torch.equal(g, r) for g, r in pairs):
                    raise AssertionError(f"{name} in the model: differs "
                                         "from plain")
                errs[name].append(0.0)
            else:
                errs[name].append(within(name, got, ref))
            return got
        return call

    for name, (mod, attr, plain) in sites.items():
        errs.setdefault(name, [])
        setattr(mod, attr, check(name, saved[name], plain))
    try:
        yield left
    finally:
        for name, (mod, attr, _) in sites.items():
            setattr(mod, attr, saved[name])


def eval_config(kv: str, **kw):
    """EvalConfig of a KV scheme: "int4" / "int8" quantised KV with int8
    weights (the model's int4_cross must match), "bf16" float caches and
    weights (configs/predict.yaml sets no quantisation)."""
    from markushgrapher_torch.eval_pipeline import EvalConfig

    quant = kv != "bf16"
    return EvalConfig(quant_kv=quant, quant_weights=quant,
                      int4_cross=kv == "int4", eos_id=-1, **kw)


def route_model(model, cfg, host: dict, route: str, kv: str):
    """The model along an encoder route of the model module's ROUTES (the
    packed route at the ceil-256 of the batch's VTL valid count) and a KV
    scheme: a clone over the same weights."""
    import torch

    from markushgrapher_torch.models.markushgrapher import route_flags

    flags = route_flags(cfg, route, torch.as_tensor(host["bbox"]),
                        torch.as_tensor(host["attention_mask"]))
    return model.clone(int4_cross=kv == "int4", **flags)


def drive_path(model, mt, cfg, host: dict, route: str, kv: str, beams: int,
               steps: int, opts: dict) -> dict:
    """One path through Evaluator.generate_batch, with every launch count
    zeroed just before and read just after; every kernel call of the
    encode and of the first CHECKED_STEPS decode steps is held to its plain
    version on the same inputs along the way. The cross caches pack to the
    batch's ceil-256 valid count under quantised KV (configs/predict.yaml's
    float KV packs nothing). opts: the EvalConfig's self_seg / lattice and
    the model's block_skip."""
    import torch

    from markushgrapher_torch.eval_pipeline import Evaluator
    from markushgrapher_torch.ops import _build

    opts = dict(opts)
    model = route_model(model, cfg, host, route, kv).clone(
        block_skip=opts.pop("block_skip", False))
    batch = host["input_ids"].shape[0]
    ev = Evaluator(model, mt, eval_config(kv, max_length=steps,
                                          num_beams=beams, batch_size=batch,
                                          **opts))
    pack = cross_pack(cfg, host)[0] if kv != "bf16" else None
    errs: dict = {}
    layers = cfg.vtl.num_decoder_layers
    with checked_kernels(errs, CHECKED_STEPS * 2 * layers,
                         CHECKED_STEPS * MG_PROJ * layers):
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        ids = ev.generate_batch(host, cross_pack_len=pack)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
    forms = errs.pop("forms")
    return dict(ids=ids, launches=launches, first_s=time.perf_counter() - t0,
                encoder_pack=model.encoder_pack_len, forms=forms,
                inside={name: (max(e), len(e)) for name, e in errs.items()
                        if e})


def drive_greedy(model, cfg, host: dict, dev, steps: int,
                 flags: dict) -> dict:
    """One greedy path through model.encode and greedy_generate, as JAX's
    bench.py serves the decode-weight modes (EvalConfig has no bit width):
    the int8 slab encoder, int4 KV, the cross caches packed to the batch's
    ceil-256 valid count, generate's weight flags. Launch counts zeroed
    just before and read just after; every kernel call of the encode and
    of the first CHECKED_STEPS decode steps held to its plain version."""
    import torch

    from markushgrapher_torch.decode.generate import greedy_generate
    from markushgrapher_torch.ops import _build

    model = route_model(model, cfg, host, "int8 slab", "int4")
    pack = cross_pack(cfg, host)[0]
    args = encoder_args(host, dev)
    layers = cfg.vtl.num_decoder_layers
    errs: dict = {}
    with checked_kernels(errs, CHECKED_STEPS * 2 * layers,
                         CHECKED_STEPS * MG_PROJ * layers):
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        enc, mask = model.encode(*args)
        ids = greedy_generate(model, enc, mask, steps, eos_id=-1,
                              quant_cross_kv=True, quant_weights=True,
                              cross_pack_len=pack, **flags)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
    forms = errs.pop("forms")
    return dict(ids=ids.cpu(), launches=launches,
                first_s=time.perf_counter() - t0, forms=forms,
                inside={name: (max(e), len(e)) for name, e in errs.items()
                        if e})


def time_greedy(model, cfg, host: dict, dev, flags: dict) -> dict:
    """Encode ms, decode ms/step, img/s and wq_linear launches per step of
    one warm greedy run of WQ_STEPS steps along drive_greedy's path (a
    16-step run warms it up)."""
    import torch

    from markushgrapher_torch.decode.generate import greedy_generate
    from markushgrapher_torch.ops import _build

    model = route_model(model, cfg, host, "int8 slab", "int4")
    pack = cross_pack(cfg, host)[0]
    args = encoder_args(host, dev)
    kw = dict(eos_id=-1, quant_cross_kv=True, quant_weights=True,
              cross_pack_len=pack, **flags)
    greedy_generate(model, *model.encode(*args), 16, **kw)
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    enc, mask = model.encode(*args)
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    greedy_generate(model, enc, mask, WQ_STEPS, **kw)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    return dict(encode_ms=enc_s * 1e3,
                decode_ms_per_step=(total - enc_s) * 1e3 / WQ_STEPS,
                img_per_s=host["input_ids"].shape[0] / total,
                wq_per_step=_build.LAUNCHES["wq_linear"] / WQ_STEPS)


def packed_vs_unpacked(model, cfg, host: dict, dev) -> float:
    """The packed encoder's states at the valid positions against the
    unpacked encoder's (tests/test_encoder_pack.py's contract), both on the
    plain path in float32 over the int8 slab: max |difference| over max
    |state|, gated at PACK_REL. The model comes back in bf16 on the kernel
    path."""
    import torch

    args = encoder_args(host, dev)
    model.float()
    try:
        enc_u, mask_u = route_model(model, cfg, host, "int8 slab", "int4"
                                    ).clone(use_kernels=False).encode(*args)
        enc_p, mask_p = route_model(model, cfg, host, "packed", "int4"
                                    ).clone(use_kernels=False).encode(*args)
    finally:
        model.to(torch.bfloat16)
    order = torch.argsort((mask_u <= 0).to(torch.int32), dim=1, stable=True)
    worst = 0.0
    for b in range(enc_u.shape[0]):
        nv = int(mask_u[b].sum())
        if int(mask_p[b, :nv].sum()) != nv or int(mask_p[b, nv:].sum()):
            raise AssertionError(f"packed encoder mask of row {b} is not "
                                 f"{nv} valid positions first")
        ref = enc_u[b, order[b, :nv]]
        worst = max(worst, float((enc_p[b, :nv] - ref).abs().max()
                                 / ref.abs().max()))
    if not worst <= PACK_REL:
        raise AssertionError(f"packed encoder vs unpacked: {worst:.3e} of "
                             f"the largest state (gate {PACK_REL})")
    return worst


def compare_to_plain(model, cfg, host: dict, dev) -> dict:
    """The int4 greedy path end to end against the plain path (encoder
    states, first 8 greedy tokens): what the model makes of the kernels'
    bf16-level differences, printed, not gated. On random weights the
    24-layer stacks amplify any such difference, so these are printed
    beside the same amplification of a half-ulp input nudge on the plain
    path alone, for two noise seeds."""
    import torch

    from markushgrapher_torch.decode.generate import greedy_generate

    model = route_model(model, cfg, host, "int8 slab", "int4")
    steps, batch = cfg.max_seq_length_decoder, host["input_ids"].shape[0]
    pack, _ = cross_pack(cfg, host)
    args = encoder_args(host, dev)
    budget = torch.full((batch,), 8, device=dev)

    def greedy8(enc, mask):
        return greedy_generate(model, enc, mask, steps, eos_id=-1,
                               quant_cross_kv=True, quant_weights=True,
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


def time_path(model, mt, cfg, host: dict, dev, route: str, kv: str,
              beams: int, opts: dict) -> dict:
    """Encode ms, decode ms/step, img/s and decode-kernel launches per step
    of one warm generate_batch call (a 16-step run at the same batch warms
    it up); opts as drive_path's."""
    import torch

    from markushgrapher_torch.eval_pipeline import Evaluator
    from markushgrapher_torch.ops import _build

    opts = dict(opts)
    model = route_model(model, cfg, host, route, kv).clone(
        block_skip=opts.pop("block_skip", False))
    pack = cross_pack(cfg, host)[0] if kv != "bf16" else None
    b, steps = host["input_ids"].shape[0], cfg.max_seq_length_decoder
    # the warm-up's 16 steps take no ring segments of 128
    warm = Evaluator(model, mt, eval_config(
        kv, max_length=16, num_beams=beams, batch_size=b,
        **{k: v for k, v in opts.items() if k != "self_seg"}))
    warm.generate_batch(host, cross_pack_len=pack)
    ev = Evaluator(model, mt, eval_config(kv, max_length=steps,
                                          num_beams=beams, batch_size=b,
                                          **opts))
    enc_ms = time_encode(model, host, dev)
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    ev.generate_batch(host, cross_pack_len=pack)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    return dict(encode_ms=enc_ms,
                decode_ms_per_step=(total * 1e3 - enc_ms) / steps,
                img_per_s=b / total, cross_pack=pack,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                decode_launches_per_step=sum(
                    _build.LAUNCHES[k] for k in DECODE_KERNELS) / steps)


def time_encode(model, host: dict, dev, calls: int = 1) -> float:
    """Host ms of a synchronised encode of the batch along the model's
    current route, averaged over `calls` warm calls."""
    import torch

    args = encoder_args(host, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        model.encode(*args)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / calls


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

    t_start = time.perf_counter()

    def phase(n: int) -> None:
        print(f"phase {n} starts at {time.perf_counter() - t_start:.0f} s",
              flush=True)

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
    phase(2)
    _build.lib()
    log = str(_build.build_info.get("ptxas", ""))
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"build: {_build.build_info['seconds']:.1f} s "
          f"({_build.library_path().name}); ptxas: {ptxas}", flush=True)
    for name, usage in ptxas_usage(log, FLASH_FWD_SYMBOLS +
                                   FLASH_BWD_SYMBOLS + MEGASTEP_SYMBOLS +
                                   DECODE_SYMBOLS + ELEMENTWISE_SYMBOLS +
                                   WQ_SYMBOLS):
        print(f"ptxas {name}: {usage}", flush=True)

    # phase 3: kernels against their plain versions, at the batch's pack
    phase(3)
    cfg = MarkushGrapherConfig()
    batch = 8
    mt = MarkushTokenizer()
    host = page_batch(cfg, batch, SEED, mt)
    pack, mv = cross_pack(cfg, host)
    kres = check_kernels(dev, pack)
    ocr = ocr_model(dev)
    kres.update(check_ocr_kernels(dev, ocr))
    kres.update(check_flash_bias(dev))
    kres.update(check_flash_relbias(dev))
    kres.update(check_wq_linear(dev))

    # phase 4: the paths at full width, through Evaluator.generate_batch
    phase(4)
    with torch.device(dev):
        model = MarkushGrapherModel(cfg)
    model.init_weights(SEED)
    model.to(torch.bfloat16).eval()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"slice: {n_params / 1e6:.1f}M params bf16, batch {batch}, valid "
          f"encoder max {mv} -> cross pack {pack}", flush=True)
    layers = cfg.vtl.num_decoder_layers
    launches = {}
    for name, route, kv, beams, steps, opts in PATHS:
        res = drive_path(model, mt, cfg, host, route, kv, beams, steps, opts)
        ids = res["ids"]
        dec = {"int4": ("decode_int4",), "int8": ("decode_i8",),
               "bf16": ()}[kv]
        want = {k: 0 for k in KERNELS}
        for kname in ROUTE_KERNELS[route]:
            want[kname] = 1 if kname == "bias_build_i8" else cfg.vtl.num_layers
        for kname in dec:
            want[kname] = 2 * layers * steps
        if kv != "bf16":
            want["wq_linear"] = MG_PROJ * layers * steps
        if opts.get("lattice"):
            # the self-attention reads the rings segment by segment
            dec += ("lattice_self_int4",)
            want["decode_int4"] = want["lattice_self_int4"] = layers * steps
        packed = res["encoder_pack"]
        print(f"{name} ({route} encoder{f' to {packed}' if packed else ''}, "
              f"{kv} KV{f', {opts}' if opts else ''}): {steps} steps, "
              f"launches {res['launches']} (expected {want}); decode forms "
              f"{sorted(res['forms'])}; first run {res['first_s']:.2f} s",
              flush=True)
        need = set()
        if opts.get("self_seg"):
            need.add(f"{dec[0]} row_map")
        if opts.get("block_skip"):
            need.add(f"{dec[0]} live_keys")
        if opts.get("lattice"):
            need.add("lattice_self_int4")
        if not need <= res["forms"]:
            raise AssertionError(f"{name}: decode calls {sorted(res['forms'])}"
                                 f" lack the forms {sorted(need)}")
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
        if set(res["inside"]) != set(ROUTE_KERNELS[route]) | set(dec) | (
                {"wq_linear"} if kv != "bf16" else set()):
            raise AssertionError(f"{name}: kernels checked inside the model: "
                                 f"{sorted(res['inside'])}")
        for r in range(2):
            print(f"  row {r}: {mt.decode(ids[r][:40])[:160]!r}", flush=True)
        for kname, n in res["launches"].items():
            launches[kname] = launches.get(kname, 0) + n
    # int4 weights and W8A8 through greedy_generate
    for name, flags in WQ_PATHS:
        res = drive_greedy(model, cfg, host, dev, WQ_STEPS, flags)
        ids = res["ids"]
        want = {k: 0 for k in KERNELS}
        want.update(bias_build_i8=1, flash_i8=cfg.vtl.num_layers,
                    decode_int4=2 * layers * WQ_STEPS,
                    wq_linear=MG_PROJ * layers * WQ_STEPS)
        print(f"{name} (int8 slab encoder, int4 KV, {flags}): {WQ_STEPS} "
              f"steps, launches {res['launches']} (expected {want}); first "
              f"run {res['first_s']:.2f} s", flush=True)
        for kname, (err, n) in res["inside"].items():
            exact = kname == "wq_linear" and flags.get("act_quant")
            print(f"  inside the model, {kname} vs plain on the same inputs: "
                  f"{n} calls (the encode, {CHECKED_STEPS} decode steps), "
                  f"max abs err {err:.3e}, all within tolerance"
                  f"{' (W8A8: bit for bit)' if exact else ''}", flush=True)
        if res["launches"] != want:
            raise AssertionError(f"{name}: launch counts {res['launches']} "
                                 f"!= {want}")
        if set(res["inside"]) != {"bias_build_i8", "flash_i8", "decode_int4",
                                  "wq_linear"}:
            raise AssertionError(f"{name}: kernels checked inside the model: "
                                 f"{sorted(res['inside'])}")
        if ids.shape != (batch, WQ_STEPS) or ids.min() < 0 \
                or ids.max() >= cfg.vtl.vocab_size:
            raise AssertionError(f"{name}: bad ids {ids.shape}")
        for r in range(2):
            print(f"  row {r}: {mt.decode(ids[r][:40])[:160]!r}", flush=True)
        for kname, n in res["launches"].items():
            launches[kname] = launches.get(kname, 0) + n
    err = packed_vs_unpacked(model, cfg, host, dev)
    packed = route_model(model, cfg, host, "packed", "int4").encoder_pack_len
    print(f"packed encoder (pack {packed}) vs unpacked on "
          f"the plain path in float32, at the valid positions: max abs "
          f"difference {err:.3e} of the largest state (gate {PACK_REL})",
          flush=True)
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

    # phase 4, OCR: the paths of OCR_PATHS through ChemicalOCR.generate_batch
    pages = torch.tensor(np.random.RandomState(SEED).randint(
        0, 256, (OCR_BATCH, 512, 512, 3)), dtype=torch.uint8, device=dev)
    tok = mt.tokenizer
    t = ocr.cfg.text
    l0 = ocr_prefix_len(ocr)
    print(f"OCR slice: {sum(p.numel() for p in ocr.parameters()) / 1e6:.1f}M "
          f"params bf16, batch {OCR_BATCH}, L0 {l0}, ring "
          f"{l0 + OCR_TOKENS + (-(l0 + OCR_TOKENS)) % 128}", flush=True)
    for name, flags, kname, opts in OCR_PATHS:
        tokens = opts.get("tokens", OCR_TOKENS)
        # a shallow copy shares the weights and takes its own block_skip
        routed = copy.copy(ocr)
        routed.block_skip = opts.get("block_skip", False)
        res = drive_ocr_path(routed, tok, pages, flags, dev, tokens)
        ids = res["ids"]
        want = {k: 0 for k in KERNELS}
        want[kname] = (tokens - 1) * (
            1 if kname == "ocr_megastep" else t.num_layers)
        checked = {kname}
        if kname != "ocr_megastep":
            want["wq_linear"] = (tokens - 1) * OCR_PROJ * t.num_layers
            checked.add("wq_linear")
        print(f"{name}: {tokens} tokens, launches {res['launches']} "
              f"(expected {want}); decode forms {sorted(res['forms'])}; "
              f"first run {res['first_s']:.2f} s", flush=True)
        if routed.block_skip and f"{kname} live_keys" not in res["forms"]:
            raise AssertionError(f"{name}: no valid-prefix decode call in "
                                 f"{sorted(res['forms'])}")
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
        if tuple(ids.shape) != (OCR_BATCH, tokens) or int(ids.min()) < 0 \
                or int(ids.max()) >= t.vocab_size:
            raise AssertionError(f"{name}: bad ids {tuple(ids.shape)}")
        if set(res["inside"]) != checked:
            raise AssertionError(f"{name}: kernels checked inside the model: "
                                 f"{sorted(res['inside'])}")
        for r, text in enumerate(res["texts"]):
            print(f"  row {r}: {text[:120]!r}", flush=True)
        for kn, n in res["launches"].items():
            launches[kn] = launches.get(kn, 0) + n
    # phase 4, OCR continuous batching: STREAM_PAGES pages with per-page
    # budgets through ChemicalOCR.stream_retired
    stream_pages = torch.tensor(np.random.RandomState(SEED + 6).randint(
        0, 256, (STREAM_PAGES, 512, 512, 3)), dtype=torch.uint8, device=dev)
    budgets = stream_budgets()
    print(f"OCR stream: {STREAM_PAGES} pages, budgets {budgets.tolist()}, "
          f"batch {OCR_BATCH}, refill waves of {STREAM_REFILL}, "
          f"{STREAM_INNER} steps a chunk, ring {stream_ring_len(ocr)}",
          flush=True)
    for name, flags, kname, block_skip in OCR_STREAM_PATHS:
        routed = copy.copy(ocr)
        routed.block_skip = block_skip
        res = run_stream(routed, tok, stream_pages, budgets, flags, dev,
                         CHECKED_STEPS)
        print(f"{name}: {res['steps']} decode steps, {res['waves']} refill "
              f"waves, retirement order {[i for i, _ in res['retired']]}, "
              f"launches {res['launches']}; decode forms "
              f"{sorted(res['forms'])}; first run {res['total_s']:.2f} s",
              flush=True)
        check_stream(name, res, budgets, kname, block_skip, t.num_layers,
                     t.vocab_size)
        for kn, (err, n) in res["inside"].items():
            print(f"  inside the model, {kn} vs plain on the same inputs: {n} "
                  f"calls ({CHECKED_STEPS} decode steps from the start and "
                  f"from the first refill wave), max abs err {err:.3e}, all "
                  f"within tolerance", flush=True)
        for i, ids in res["retired"][:2]:
            print(f"  page {i}: {tok.decode(ids[ids >= 0].tolist())[:120]!r}",
                  flush=True)
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

    # phase 4, the image front end: the OCR pages into MG's VTL patch
    # vectors through preprocess_patchify, held to its reference bit for bit
    from markushgrapher_torch.ops import preprocess

    torch.cuda.synchronize()
    _build.reset_launches()
    patches = preprocess.preprocess_patchify(pages, patch=cfg.vtl.patch_size)
    torch.cuda.synchronize()
    res = dict(_build.LAUNCHES)
    want = {k: 0 for k in KERNELS}
    want["normalize_u8"] = 1
    side = cfg.vtl.image_size // cfg.vtl.patch_size
    shape = (OCR_BATCH, side * side, cfg.vtl.patch_size ** 2 * 3)
    print(f"preprocess_patchify: pages {tuple(pages.shape)} -> "
          f"{tuple(patches.shape)}, launches {res} (expected {want})",
          flush=True)
    if res != want or tuple(patches.shape) != shape or not torch.equal(
            patches, preprocess.preprocess_patchify_reference(
                pages, patch=cfg.vtl.patch_size)):
        raise AssertionError("preprocess_patchify: launches, shape or "
                             "values differ from the reference")
    for kn, n in res.items():
        launches[kn] = launches.get(kn, 0) + n

    # phase 5: timing (warm), 512 steps, eos never firing
    phase(5)
    hosts = {8: host, 48: page_batch(cfg, 48, SEED + 1, mt)}
    for b in (8, 48):
        for route in ROUTE_KERNELS:
            routed = route_model(model, cfg, hosts[b], route, "int4")
            time_encode(routed, hosts[b], dev)                # warm
            ms = time_encode(routed, hosts[b], dev, calls=3)
            packed = routed.encoder_pack_len
            print(f"timing encode {route}{f' to {packed}' if packed else ''}"
                  f" b{b}: {ms:.1f} ms on {card}", flush=True)
    # the copy-on-write beams and block_skip beside the paths they change,
    # in turns at each batch (the beams at batch 8 only: on an H100 behind a
    # slow host their three batch-16 runs took ~2 min of a 1105 s run)
    for label, route, kv, beams, sizes, opts in (
            ("greedy int4", "int8 slab", "int4", 1, (8, 48), {}),
            ("greedy int4 block_skip", "int8 slab", "int4", 1, (8, 48),
             dict(block_skip=True)),
            ("beam-5 int4 one segment", "int8 slab", "int4", 5, (8,), {}),
            ("beam-5 int4 seg 128", "int8 slab", "int4", 5, (8,),
             dict(self_seg=128)),
            ("beam-5 int4 lattice", "int8 slab", "int4", 5, (8,),
             dict(lattice=True)),
            ("greedy int8", "int8 slab", "int8", 1, (48,), {}),
            ("predict.yaml beam-5 bf16", "bf16 slab", "bf16", 5, (8,), {})):
        for b in sizes:
            if b not in hosts:
                hosts[b] = page_batch(cfg, b, SEED + 1, mt)
            t = time_path(model, mt, cfg, hosts[b], dev, route, kv, beams,
                          opts)
            print(f"timing {label} b{b}: encode {t['encode_ms']:.1f} ms, "
                  f"decode {t['decode_ms_per_step']:.3f} ms/step, "
                  f"{t['img_per_s']:.3f} img/s ({cfg.max_seq_length_decoder} "
                  f"steps, cross pack {t['cross_pack']}, peak "
                  f"{t['peak_gb']:.1f} GB; decode kernels "
                  f"{t['decode_launches_per_step']:.1f} a step from the "
                  f"launch counters) on {card}", flush=True)
            if label == "greedy int4" and \
                    t["decode_launches_per_step"] > 2 * layers:
                raise AssertionError(
                    f"greedy int4 b{b}: {t['decode_launches_per_step']} "
                    f"decode launches a step, more than {2 * layers}")
    # the three decode-weight forms in turns, greedy int4 at batch 8
    for name, flags in (("greedy_int4_w8", {}),) + WQ_PATHS + (
            ("greedy_int4_w8", {}),):
        t = time_greedy(model, cfg, host, dev, flags)
        print(f"timing {name} b{batch}: encode {t['encode_ms']:.1f} ms, "
              f"decode {t['decode_ms_per_step']:.3f} ms/step, "
              f"{t['img_per_s']:.3f} img/s ({WQ_STEPS} steps; wq_linear "
              f"{t['wq_per_step']:.1f} a step from the launch counters) on "
              f"{card}", flush=True)
    pages_big = torch.tensor(np.random.RandomState(SEED + 1).randint(
        0, 256, (MEGA_BATCH, 512, 512, 3)), dtype=torch.uint8, device=dev)
    batched = {}
    for name, flags, _, opts in OCR_PATHS + (
            (OCR_PATHS[2][0], OCR_PATHS[2][1], None, dict(big=True)),
            (OCR_PATHS[0][0], OCR_PATHS[0][1], None, dict(timed=128))):
        if opts.get("block_skip"):
            continue
        batch_pages = pages_big if opts.get("big") else pages
        timed = opts.get("timed", OCR_TOKENS)
        t = time_ocr_path(ocr, tok, batch_pages, flags, dev, timed)
        batched.setdefault(name, t)
        print(f"timing {name} b{batch_pages.shape[0]}: prefill "
              f"{t['prefill_ms']:.1f} ms, decode {t['ms_per_step']:.3f} "
              f"ms/step, {t['img_per_s']:.3f} img/s ({timed} new "
              f"tokens) on {card}", flush=True)
    del pages_big
    # continuous batching (warm from phase 4), beside the batched int4 path
    name, flags, kname, block_skip = OCR_STREAM_PATHS[0]
    routed = copy.copy(ocr)
    routed.block_skip = block_skip
    res = run_stream(routed, tok, stream_pages, budgets, flags, dev)
    check_stream(name, res, budgets, kname, block_skip,
                 ocr.cfg.text.num_layers, ocr.cfg.text.vocab_size)
    pre = res["prefill_ms"]
    decode_ms = res["total_s"] * 1e3 - sum(pre)
    print(f"timing {name} b{OCR_BATCH}: {STREAM_PAGES} pages, "
          f"{int(budgets.sum())} tokens, {res['steps']} decode steps, "
          f"{res['total_s']:.2f} s: {STREAM_PAGES / res['total_s']:.3f} "
          f"img/s, {budgets.sum() / res['total_s']:.1f} tokens/s, decode "
          f"{decode_ms / res['steps']:.3f} ms/step (the batched ocr_int4 "
          f"path: {batched['ocr_int4']['ms_per_step']:.3f} ms/step in this "
          f"run), first prefill {pre[0]:.1f} ms (b{OCR_BATCH}), refill "
          f"prefill {np.mean(pre[1:]):.1f} ms a wave of up to "
          f"{STREAM_REFILL} ({res['waves']} waves), "
          f"{res['launches'][kname] / res['steps']:.1f} {kname} launches a "
          f"step, on {card}", flush=True)
    t = time_pipeline(ocr, route_model(model, cfg, host, "int8 slab", "int4"),
                      mt, cfg, pages, dev)
    print(f"timing pipeline b{OCR_BATCH} (pages -> OCR int4, {OCR_TOKENS} "
          f"tokens -> cells -> MG greedy int4, "
          f"{cfg.max_seq_length_decoder} steps): {t['img_per_s']:.3f} img/s "
          f"(OCR {t['ocr_s']:.2f} s, MG {t['mg_s']:.2f} s; rows with "
          f"grammar cells {t['grammar_rows']} of {OCR_BATCH}) on {card}",
          flush=True)

    # phase 6: training at full width through Trainer.train_step
    phase(6)
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
