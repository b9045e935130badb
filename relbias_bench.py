"""Where flash_relbias's time goes: builds of its BiasRel kernel with one part
of the bias taken out, timed side by side on one card.

    python3 relbias_bench.py [--batch 8] [--rounds 4]

Each variant is a copy of `markushgrapher_torch/csrc/flash_fwd_sm90.cuh`
with one text edit (VARIANTS), compiled with `flash_relbias.cu` and the
port's nvcc flags into a library of its own under the git-ignored
`markushgrapher_torch/_build/relbias/`, one nvcc per variant, all at once:
  base          the kernel as it is;
  no_2d_loads   the 2d terms computed but not read from their tables (no
                shared loads, no bank conflicts);
  no_1d_loads   every key tile takes the far-tile 1d constant (no table
                loads near the diagonal);
  no_bias       no bias arithmetic: each score starts at the 1d constant
                (the core's Q K^T, softmax and P V and the producer's key
                staging remain).
The variants other than base compute another function; they are timed, not
checked. Inputs and timing are chip_smoke.py's phase 3
(`chip_smoke.relbias_inputs`, `chip_smoke.cuda_ms`); the builds are timed
in turns (in order, then reversed), and each line gives the fastest and
slowest round. Prints the card's name and power limit and each build's
ptxas registers and spills. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess

import chip_smoke

REL2_LOAD = """  asm("ld.shared.f32 %0, [%1];"
      : "=f"(v)
      : "r"((d < 0.f ? neg : pos) + (n << 2)));"""
NEAR_CALL = "rel_bias<true>(s, kd, kd + kBN, km, masked, k0, cq, R, 0.f)"
VARIANTS = {
    "base": [],
    "no_2d_loads": [(REL2_LOAD, "  v = __uint_as_float(((d < 0.f ? neg : pos)"
                     " + (n << 2)) & 0x007fffffu);")],
    "no_1d_loads": [(NEAR_CALL, NEAR_CALL.replace("<true>", "<false>")
                     .replace("0.f)", "R.tpos)"))],
    "no_bias": [(f"    s[4 * j{e}] = __fadd_rn(\n",
                 f"    if (false) s[4 * j{e}] = __fadd_rn(\n")
                for e in ("", " + 1", " + 2", " + 3")]
    + [("    if (masked) {\n      const int2 m",
        "    s[4 * j] = s[4 * j + 1] = s[4 * j + 2] = s[4 * j + 3] = a0;\n"
        "    if (masked) {\n      const int2 m")],
}


def build():
    """{label: C entry mg_flash_relbias} of every variant."""
    from markushgrapher_torch.ops import _build

    procs = []
    for label, edits in VARIANTS.items():
        d = _build.BUILD_DIR / "relbias" / label
        d.mkdir(parents=True, exist_ok=True)
        for name in ("sm90.cuh", "flash_relbias.cu"):
            shutil.copy(_build.CSRC / name, d / name)
        core = (_build.CSRC / "flash_fwd_sm90.cuh").read_text()
        for old, new in edits:
            if old not in core:
                raise RuntimeError(f"{label}: the kernel no longer has "
                                   f"{old!r}")
            core = core.replace(old, new)
        (d / "flash_fwd_sm90.cuh").write_text(core)
        so = d / "lib.so"
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so),
               str(d / "flash_relbias.cu")]
        procs.append((label, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    fns = {}
    for label, so, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {label}:\n{log}")
        for sym, usage in chip_smoke.ptxas_usage(log, ("relbias_kernelILb0",)):
            print(f"{label}: ptxas {usage}", flush=True)
        fn = ctypes.CDLL(str(so)).mg_flash_relbias
        fn.argtypes = _build._SIGNATURES["mg_flash_relbias"]
        fn.restype = ctypes.c_int
        fns[label] = fn
    return fns


def main() -> None:
    import torch

    from markushgrapher_torch.ops import _build, flash_relbias

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=4)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("relbias_bench: needs a CUDA device")
    print(chip_smoke.gpu_line(), flush=True)
    _build.lib()
    fns = build()
    dev = torch.device("cuda")
    q, k, v, hx, vy, mask, tables = chip_smoke.relbias_inputs(
        dev, a.batch, chip_smoke.SEED + 7 + a.batch)
    args = flash_relbias._kernel_args(q, k, v, hx, vy, mask, *tables, 128,
                                      100)
    out = torch.empty_like(q)
    b, length, heads, d = q.shape

    def call(fn):
        rc = fn(*(t.data_ptr() for t in args), b, length, heads, d, 32, 128,
                100, 100.0, out.data_ptr(), _build.stream(out))
        _build.check(rc, "flash_relbias")

    times = {label: [] for label in fns}
    for r in range(a.rounds):
        order = list(fns) if r % 2 == 0 else list(fns)[::-1]
        for label in order:
            times[label].append(chip_smoke.cuda_ms(
                lambda: call(fns[label]), 50, 3))
    for label, t in times.items():
        print(f"{label} B={b} H={heads} L={length}: {min(t):.4f} - "
              f"{max(t):.4f} ms over {a.rounds} rounds", flush=True)


if __name__ == "__main__":
    main()
