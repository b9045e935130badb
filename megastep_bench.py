"""Time builds of the OCR megastep kernel side by side on one card.

    python3 megastep_bench.py LABEL=SOURCE[:DEF,DEF...] ... \\
        [--check LABEL,...] [--trace LABEL,...] [--batches 8,48] \\
        [--positions 103,503] [--rounds 2]

Each SOURCE (a path from the repository root: the kernel in
`markushgrapher_torch/csrc/ocr_megastep.cu`, another revision of it, or a
copy with code taken out) is compiled with the port's nvcc flags and the
given -D defines into a library of its own, one nvcc per source, all at
once. Inputs and timing are chip_smoke.py's phase 3: the OCRConfig() model
from its seed, rings of its length, `chip_smoke.mega_inputs` and
`chip_smoke.cuda_ms`. The builds are timed in turns (the labels in order,
then reversed, for `rounds` rounds). --check holds the named builds to
`plain_megastep` through `chip_smoke.mega_check`. --trace builds the named
sources with -DMEGASTEP_TRACE and prints, per phase of a layer, its
start-to-start time (globaltimer, earliest block) and the largest and
median per-block time between its stamps (clock64), averaged over layers
1-28. Prints the card's name and power limit first. Needs a CUDA device
and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys

import numpy as np

import chip_smoke

PHASES = ("qkv", "attention", "o", "gate+up", "down")
TRACE_BLOCKS, TRACE_LAYERS = 132, 32


def build(variants, trace):
    """{label: (C entry, trace reader or None)} for (label, source,
    defines); one nvcc per source, all at once."""
    from markushgrapher_torch.ops import _build

    out = _build.BUILD_DIR / "bench"
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for label, src, defs in variants:
        defs = defs + (["MEGASTEP_TRACE"] if label in trace else [])
        so = out / f"{label}.so"
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
               str(_build.CSRC), *(f"-D{d}" for d in defs), "-o", str(so),
               src]
        procs.append((label, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    fns = {}
    for label, so, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {label}:\n{log}")
        usage = [ln.split(":", 1)[1].strip() for ln in log.splitlines()
                 if "Used" in ln and "registers" in ln]
        print(f"build {label}: ptxas {usage}", flush=True)
        lib = ctypes.CDLL(str(so))
        fn = lib.mg_ocr_megastep
        fn.argtypes = _build._SIGNATURES["mg_ocr_megastep"]
        fn.restype = ctypes.c_int
        reader = None
        if label in trace:
            reader = lib.mg_ocr_megastep_trace
            reader.argtypes = [ctypes.c_void_p]
            reader.restype = ctypes.c_int
        fns[label] = (fn, reader)
    return fns


def kernel_of(fn):
    """ops.megastep.ocr_megastep's signature over a build's C entry, with
    a scratch large enough for any revision's layout; raises on a launch
    error."""
    import torch

    from markushgrapher_torch.ops import _build, megastep

    def kernel(x, rings, w, rope, pos, *, heads, groups, rms_eps):
        dims = megastep._check(x, rings, w, rope, pos, heads, groups)
        scratch = torch.empty(1 << 22, dtype=torch.float32, device=x.device)
        out = torch.empty_like(x)
        tensors = [x, out, scratch, rope, *(rings[k] for k in
                   ("k_q", "k_s", "v_q", "v_s")),
                   *(w[k] for k in megastep._WEIGHTS)]
        _build.check(fn(*(t.data_ptr() for t in tensors),
                        *(dims[k] for k in ("L", "B", "S", "Dm", "H", "G",
                                            "D", "F")), pos, rms_eps,
                        dims["D"] ** -0.5, _build.stream(out)),
                     "ocr_megastep")
        return out
    return kernel


def show_trace(label, reader, call):
    """The stamps of one launch: per phase, start-to-start (earliest block)
    and the largest / median per-block interval between its six stamps."""
    import torch

    call()
    torch.cuda.synchronize()
    n = TRACE_BLOCKS * TRACE_LAYERS * 30
    buf = np.zeros(2 * n, dtype=np.uint64)
    if reader(buf.ctypes.data):
        raise RuntimeError("reading the trace failed")
    shape = (TRACE_BLOCKS, TRACE_LAYERS, 5, 6)
    clk = buf[:n].reshape(shape).astype(np.int64)
    gt = buf[n:].reshape(shape).astype(np.int64)
    ghz = float(np.median((clk[:, 29, 0, 0] - clk[:, 1, 0, 0]) /
                          (gt[:, 29, 0, 0] - gt[:, 1, 0, 0])))
    total = 0.0
    for ph, name in enumerate(PHASES):
        s2s, top, med = [], [[] for _ in range(5)], [[] for _ in range(5)]
        for layer in range(1, 29):
            nxt = gt[:, layer + (ph == 4), (ph + 1) % 5, 0].min()
            s2s.append(nxt - gt[:, layer, ph, 0].min())
            e = clk[:, layer, ph]
            for k in range(5):
                a, b = e[:, k], e[:, k + 1]
                # a block stamps an event only where it works in the phase
                ok = (b >= a) & (a >= e[:, 0]) & (b <= e[:, 5])
                span = (b[ok] - a[ok]) / ghz / 1e3 if ok.any() else [0.0]
                top[k].append(np.max(span))
                med[k].append(np.median(span))
        total += np.mean(s2s) / 1e3
        print(f"  trace {label} {name:>9}: start-to-start "
              f"{np.mean(s2s) / 1e3:.2f} us; between stamps, largest "
              + ", ".join(f"{np.mean(x):.2f}" for x in top) + " us, median "
              + ", ".join(f"{np.mean(x):.2f}" for x in med), flush=True)
    print(f"  trace {label}: {total:.2f} us per layer (SM clock "
          f"{ghz:.3f} GHz)", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="+", help="LABEL=SOURCE[:DEF,...]")
    ap.add_argument("--check", default="")
    ap.add_argument("--trace", default="")
    ap.add_argument("--batches", default="8")
    ap.add_argument("--positions", default="103,503")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        sys.exit("megastep_bench: needs a CUDA device")
    print(chip_smoke.gpu_line(), flush=True)
    variants = []
    for v in args.variants:
        label, spec = v.split("=", 1)
        src, _, defs = spec.partition(":")
        variants.append((label, src, [d for d in defs.split(",") if d]))
    trace = {t for t in args.trace.split(",") if t}
    fns = build(variants, trace)
    dev = torch.device("cuda")
    model = chip_smoke.ocr_model(dev)
    t = model.cfg.text
    w, rope = model.megastep_pack()["lm"], model.rope()
    kw = dict(heads=t.num_heads, groups=t.num_kv_heads, rms_eps=t.rms_eps)
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 2)
    for batch in map(int, args.batches.split(",")):
        for pos in map(int, args.positions.split(",")):
            x, rings = chip_smoke.mega_inputs(
                model, gen, batch, chip_smoke.ocr_ring_len(model), pos)
            calls = {}
            for label, (fn, reader) in fns.items():
                kernel = kernel_of(fn)
                if label in args.check.split(","):
                    try:
                        _, err, _, rel = chip_smoke.mega_check(
                            kernel, x, {k: v.clone() for k, v in
                                        rings.items()}, w, rope, pos, kw)
                        print(f"check {label} B={batch} p={pos}: per-layer "
                              f"max abs err {err:.3e}, whole-step relative "
                              f"L2 {rel:.3e}", flush=True)
                    except (AssertionError, RuntimeError) as e:
                        print(f"check {label} B={batch} p={pos}: {e}",
                              flush=True)
                ring_copy = {k: v.clone() for k, v in rings.items()}

                def call(kernel=kernel, ring_copy=ring_copy):
                    return kernel(x, ring_copy, w, rope, pos, **kw)
                try:
                    call()
                except RuntimeError as e:  # a build that refuses the shape
                    print(f"{label} B={batch} p={pos}: {e}", flush=True)
                    continue
                calls[label] = call
                if reader is not None:
                    show_trace(label, reader, call)
            order = list(calls)
            times = {label: [] for label in order}
            for r in range(args.rounds):
                for label in (order if r % 2 == 0 else order[::-1]):
                    times[label].append(chip_smoke.cuda_ms(calls[label], 20,
                                                           3))
            print(f"B={batch} p={pos}: " + "; ".join(
                f"{label} " + " ".join(f"{t:.4f}" for t in ts) + " ms"
                for label, ts in times.items()), flush=True)
            del x, rings, calls
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
