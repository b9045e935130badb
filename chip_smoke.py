#!/usr/bin/env python3
"""Drive the PyTorch port's MarkushGrapher serving path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero and
prints no result):

1. device: requires CUDA (no CPU fallback); prints torch / CUDA versions and
   the card's name and power limit;
2. build: compiles the port's CUDA kernels from `markushgrapher_torch/csrc`
   for sm_90a;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the main path gives it, with the stated tolerance, and timed
   against it;
4. slice: the flagship 831M MarkushGrapherConfig() with seeded random bf16
   weights, served through `Evaluator.generate_batch` at batch 8 for 512
   greedy steps (eos never fires); checks the launch counts of every kernel;
   holds every kernel call of one encode and of the first 8 decode steps to
   its plain version on the same inputs; prints the end-to-end difference
   from the plain path beside a half-ulp-nudge control; decodes a few rows
   to strings;
5. timing: encode ms, decode ms/step and img/s at batch 8 and 48.

The last three lines are the card's name and power limit, one JSON object
describing the kernels, and `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import contextlib
import json
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
}
# kernel-vs-plain tolerances (|kernel - plain| <= atol + rtol * |plain|):
#  - bias_build_i8 is exact (same LUT buckets, same float32 op order);
#  - flash_i8 and decode_int4 return bf16, and sum in another order than
#    the plain float32 matmuls: two bf16 ulps (2 * 2^-7 relative), plus a
#    small absolute floor for outputs near zero. decode_int4 also rounds
#    p * vs to bf16 inside, where a one-ulp flip of one weight can move the
#    output by a little more.
# The same tolerances hold for every kernel call inside the model (phase 4),
# where they gate the attention output before the o-projection and the
# residual add.
TOL = {"flash_i8": (1e-3, 1.6e-2), "decode_int4": (2e-3, 2e-2)}


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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
        raise AssertionError(
            f"{name}: {int(bad.sum())} entries outside atol={atol} "
            f"rtol={rtol}; max abs err {float(err.max()):.3e}")
    return float(err.max())


def check_kernels(dev) -> dict:
    """Each kernel against its plain version at main-path shapes. Returns
    {name: {max_abs_err, ms, plain_ms}}."""
    import torch

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
        plain_ms=cuda_ms(lambda: bias_build.plain(*args)))
    print(f"bias_build_i8  B={B} H={H} L={L}: bit-exact; "
          f"kernel {out['bias_build_i8']['ms']:.3f} ms, plain "
          f"{out['bias_build_i8']['plain_ms']:.3f} ms", flush=True)

    # K2: flash over the int8 slab, bf16 q/k/v, 25 % of keys padded
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
    out["flash_i8"] = dict(
        max_abs_err=within("flash_i8", f_got, f_ref),
        ms=cuda_ms(lambda: flash_attention.flash_attention_bias_i8(*fargs)),
        plain_ms=cuda_ms(lambda: flash_attention.plain(*fargs)))
    print(f"flash_i8       B={B} H={H} L={L} D={D}: max abs err "
          f"{out['flash_i8']['max_abs_err']:.3e}; kernel "
          f"{out['flash_i8']['ms']:.3f} ms, plain "
          f"{out['flash_i8']['plain_ms']:.3f} ms", flush=True)

    # K3: cross (B=8, Kp=1792, 20 % padding) and self ring (S=512, step 300)
    B, HD = 8, H * D

    def slab(n_keys, n_valid):
        vals = rng.randint(-7, 8, size=(B, n_keys, HD)).astype(np.int8)
        vals[:, n_valid:] = 0
        sc = rng.rand(B, H, n_keys).astype(np.float32) * 0.05
        sc[:, :, n_valid:] = 0.0
        return (mxu_decode.pack_int4(torch.tensor(vals, device=dev)),
                torch.tensor(sc, device=dev).to(torch.bfloat16))

    qd = torch.tensor(rng.randn(B, H, D).astype(np.float32),
                      device=dev).to(torch.bfloat16)
    kp, valid = 1792, 1434
    kq, ks = slab(kp, valid)
    vq, vs = slab(kp, valid)
    cmask = torch.ones((B, valid), dtype=torch.int32, device=dev)
    cmask[:, -100:] = 0
    cbias = torch.nn.functional.pad(mask_bias(cmask)[:, :1, 0, :],
                                    (0, kp - valid), value=-1e9)
    cargs = (qd, kq, ks, vq, vs, cbias)
    c_got = mxu_decode.cross_decode_mxu_int4(*cargs)
    c_ref = mxu_decode.plain(*cargs)
    err_c = within("decode_int4", c_got, c_ref)

    step, ring = 300, 512
    rk, rks = slab(ring, step + 1)
    rv, rvs = slab(ring, step + 1)
    srow = np.full((1, H, ring), np.finfo(np.float32).min, np.float32)
    srow[:, :, :step + 1] = rng.randn(1, H, step + 1) * 0.5
    sbias = torch.tensor(srow, device=dev)
    sargs = (qd, rk, rks, rv, rvs, sbias)
    err_s = within("decode_int4", mxu_decode.cross_decode_mxu_int4(*sargs),
                   mxu_decode.plain(*sargs))
    torch.cuda.synchronize()
    ms_self = cuda_ms(lambda: mxu_decode.cross_decode_mxu_int4(*sargs), 50)
    plain_self = cuda_ms(lambda: mxu_decode.plain(*sargs), 20)
    out["decode_int4"] = dict(
        max_abs_err=max(err_c, err_s),
        ms=cuda_ms(lambda: mxu_decode.cross_decode_mxu_int4(*cargs), 50),
        plain_ms=cuda_ms(lambda: mxu_decode.plain(*cargs), 20))
    print(f"decode_int4    cross B={B} H={H} Kp={kp}: max abs err "
          f"{err_c:.3e}; kernel {out['decode_int4']['ms']:.4f} ms, plain "
          f"{out['decode_int4']['plain_ms']:.4f} ms", flush=True)
    print(f"decode_int4    self  B={B} H={H} S={ring}: max abs err "
          f"{err_s:.3e}; kernel {ms_self:.4f} ms, plain {plain_self:.4f} ms",
          flush=True)
    return out


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
def checked_kernels(errs: dict):
    """Route the model's calls of each kernel wrapper through a check: the
    wrapper and its plain version run on the same inputs, the kernel's
    output is held to the kernel tolerance (bias_build_i8: bit-exact; the
    others: TOL, on the attention output before the o-projection and the
    residual add), and the kernel's output goes on. errs[name] collects the
    max abs error of every call."""
    from markushgrapher_torch.ops import bias_build, flash_attention, mxu_decode

    sites = {"bias_build_i8": (bias_build, "encoder_position_bias_kernel_i8"),
             "flash_i8": (flash_attention, "flash_attention_bias_i8"),
             "decode_int4": (mxu_decode, "cross_decode_mxu_int4")}
    saved = {name: getattr(mod, attr) for name, (mod, attr) in sites.items()}

    def check(name, kernel, plain):
        def call(*args):
            got, ref = kernel(*args), plain(*args)
            if name == "bias_build_i8":
                if not all(bool((g == r).all()) for g, r in zip(got, ref)):
                    raise AssertionError("bias_build_i8 in the model: "
                                         "differs from plain")
                errs[name].append(0.0)
            else:
                errs[name].append(within(name, got, ref))
            return got
        return call

    for name, (mod, attr) in sites.items():
        errs.setdefault(name, [])
        setattr(mod, attr, check(name, saved[name], mod.plain))
    try:
        yield
    finally:
        for name, (mod, attr) in sites.items():
            setattr(mod, attr, saved[name])


def drive_slice(ev, cfg, host: dict, dev) -> dict:
    """The main path once through Evaluator.generate_batch with every launch
    count zeroed just before; then the kernel path against the plain
    versions on the same inputs:

    - every kernel call of one encode and of the first 8 decode steps, each
      against its plain version on that call's inputs (the kernel path's
      own layer inputs): the kernels' own error, gated;
    - end to end (encoder states, first 8 greedy tokens): what the model
      makes of it, printed. On random weights the 24-layer stacks amplify
      any bf16-level difference, so these are printed beside the same
      amplification of a half-ulp input nudge on the plain path alone, for
      two noise seeds."""
    import torch

    from markushgrapher_torch.decode.generate import greedy_generate
    from markushgrapher_torch.ops import _build

    model = ev.model
    steps, batch = ev.cfg.max_length, host["input_ids"].shape[0]
    pack, _ = cross_pack(cfg, host)
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    ids = ev.generate_batch(host, cross_pack_len=pack)
    torch.cuda.synchronize()
    out = dict(ids=ids, launches=dict(_build.LAUNCHES),
               first_s=time.perf_counter() - t0)

    args = encoder_args(host, dev)
    budget = torch.full((batch,), 8, device=dev)

    def greedy8(enc, mask):
        return greedy_generate(model, enc, mask, steps, eos_id=-1,
                               cross_pack_len=pack, row_budgets=budget)

    errs: dict = {}
    with checked_kernels(errs):
        enc_k, mask_k = model.encode(*args)
        greedy8(enc_k, mask_k)

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
    first = torch.as_tensor(ids[:, :8])
    out.update(
        masks_equal=bool(torch.equal(mask_k, mask_p)),
        finite=bool(torch.isfinite(enc_k.float()).all()),
        inside={name: (max(e), len(e)) for name, e in errs.items()},
        enc_err=_rel(enc_k, enc_p), nudged=nudged,
        match_e2e=float((first == ids_p[:, :8].cpu()).float().mean()),
        match_dec=float((first == ids_pk[:, :8].cpu()).float().mean()))
    return out


def time_slice(ev, cfg, host: dict, dev, warm: bool) -> dict:
    """Encode ms, decode ms/step and img/s of one generate_batch call."""
    import torch

    pack, _ = cross_pack(cfg, host)
    b, steps = host["input_ids"].shape[0], ev.cfg.max_length
    if not warm:
        ev.generate_batch(host, cross_pack_len=pack)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev.model.encode(*encoder_args(host, dev))
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


def main() -> None:
    import torch

    # phase 1: device
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; the port's kernels need one")
    from markushgrapher_torch.config import MarkushGrapherConfig
    from markushgrapher_torch.data.synthetic import page_batch
    from markushgrapher_torch.eval_pipeline import EvalConfig, Evaluator
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

    # phase 3: kernels against their plain versions
    kres = check_kernels(dev)

    # phase 4: the slice at full width, through Evaluator.generate_batch
    cfg = MarkushGrapherConfig()
    steps, batch = cfg.max_seq_length_decoder, 8
    with torch.device(dev):
        model = MarkushGrapherModel(cfg)
    model.init_weights(SEED)
    n_params = sum(p.numel() for p in model.parameters())
    ev = Evaluator(model, None, EvalConfig(max_length=steps,
                                           batch_size=batch, eos_id=-1))
    host = page_batch(cfg, batch, SEED, ev.mt)
    pack, mv = cross_pack(cfg, host)
    print(f"slice: {n_params / 1e6:.1f}M params bf16, batch {batch}, "
          f"{steps} greedy steps, valid encoder max {mv} -> cross pack "
          f"{pack}", flush=True)
    res = drive_slice(ev, cfg, host, dev)
    launches, ids = res["launches"], res["ids"]
    want = {"bias_build_i8": 1, "flash_i8": cfg.vtl.num_layers,
            "decode_int4": 2 * cfg.vtl.num_decoder_layers * steps}
    print(f"launches on the main path: {launches} (expected {want}); "
          f"first run {res['first_s']:.2f} s", flush=True)
    for r in range(2):
        print(f"row {r}: {ev.mt.decode(ids[r][:40])[:160]!r}", flush=True)
    for name, (err, n) in res["inside"].items():
        print(f"inside the model, {name} vs plain on the same inputs: "
              f"{n} calls (one encode, 8 decode steps), max abs err "
              f"{err:.3e}, all within tolerance", flush=True)
    print(f"end to end: encoder states rel L2 {res['enc_err']:.3e}, first 8 "
          f"greedy tokens match {res['match_e2e']:.3f}, decode alone on the "
          f"kernel path's encoder states {res['match_dec']:.3f}", flush=True)
    for seed, err, match in res["nudged"]:
        print(f"control, plain path vs itself with a half-ulp nudge of layer "
              f"0's input (noise seed {seed}): encoder states rel L2 "
              f"{err:.3e}, first 8 greedy tokens match {match:.3f}",
              flush=True)
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    if ids.shape != (batch, steps) or ids.min() < 0 \
            or ids.max() >= cfg.vtl.vocab_size:
        raise AssertionError(f"bad ids {ids.shape} [{ids.min()}, "
                             f"{ids.max()}]")
    if not (res["masks_equal"] and res["finite"]):
        raise AssertionError("encoder mask differs or states not finite")
    if set(res["inside"]) != set(KERNELS):
        raise AssertionError(f"kernels checked inside the model: "
                             f"{sorted(res['inside'])}")

    # phase 5: timing at batch 8 and 48 (warm)
    for b in (8, 48):
        hb = host if b == batch else page_batch(cfg, b, SEED + 1, ev.mt)
        t = time_slice(ev, cfg, hb, dev, warm=b == batch)
        print(f"timing b{b}: encode {t['encode_ms']:.1f} ms, decode "
              f"{t['decode_ms_per_step']:.3f} ms/step, {t['img_per_s']:.3f} "
              f"img/s (greedy-{steps}, cross pack {t['cross_pack']}, peak "
              f"{t['peak_gb']:.1f} GB) on {card}", flush=True)

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
