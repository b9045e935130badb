"""Where bias_build_i8's time goes: builds of its kernels with parts taken
out, and optionally the kernels they replaced, timed side by side on one
card.

    python3 bias_bench.py [--rounds 4] [--parent PATH] [--alt PATH]
        [--normalize-parent PATH]

Each variant is a copy of `markushgrapher_torch/csrc/bias_build_i8.cu` with
text edits (VARIANTS), compiled with the port's nvcc flags into a library
of its own under the git-ignored `markushgrapher_torch/_build/bias_bench/`,
one nvcc per build, all at once:
  base          the kernel as it is;
  threads_512   CTAs of 512 threads in place of 1024 (half the warps an SM,
                twice the registers a thread);
  stores_only   constant bytes stored at the kernel's addresses (no bucket
                math, no table lookups): the slab write alone;
  no_stores     every bucket and table lookup, nothing stored (a store
                guarded by a test of the bytes that never holds);
  buckets_only  the buckets of every (b, i, j), no table lookups, nothing
                stored;
  prologue_only the table kernel, the slab kernel's prologue (its head
                group's table and the LUTs) and each sample's centres, no
                item;
  no_table      the slab kernel alone, over the work buffer an earlier
                launch left (the table kernel and its launch gap taken out).
--alt names the source of a design with one launch, whose slab CTAs each
quantise their head group's table themselves (its C entry takes the grid
and the shared-memory bytes, and no work buffer), built alone and timed as
`alt` beside them.
--parent names the source of an older kernel for the same function, built
alone and timed as `parent`: e.g. `mkdir -p build/parent && git archive
<commit> markushgrapher_torch/csrc | tar -x -C build/parent`, then
`--parent build/parent/markushgrapher_torch/csrc/bias_build_i8.cu`. Its C
entry is the one before the redesign (scales, centres and LUTs made by the
caller: `relbias.combined_table`, `bias_scales`, `bbox_centres`,
`bucket_lut`, outside the timing). --normalize-parent does the same for
`normalize_u8.cu` (same C entry) against the current one and against
builds of it with text edits (NORMALIZE_VARIANTS: one tile or four in
flight a warp in place of two; a grid of the card's resident CTAs, each
warp looping over its tiles, in place of a CTA for every 8 warps' work),
at chip_smoke's three page shapes. base, alt and parent are checked bit for bit against the
plain version; the variants compute another function and are timed, not
checked.

Inputs are chip_smoke.py phase 3's (`chip_smoke.bias_inputs`, the same
seeds), with the tables in bf16 as the served model holds them (--parent's
kernel reads them converted to float32 outside the timing, as its wrapper
did): B=2, 8 and 48 at H=16, L=1536 and the packed slab at B=8, L=1280.
Times are the kernels' launches alone (`chip_smoke.cuda_ms`), the builds in
turns (in order, then reversed); each line gives the fastest and slowest
round and the share of the bound (the slab's bytes over 3.35 TB/s) the
fastest reaches. normalize_u8 is timed over copies of the pages in turn
(`chip_smoke.in_turns`), so that its bytes come from HBM. Prints the
card's name and power limit and each build's ptxas registers and spills.
Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess

import numpy as np

import chip_smoke

STORE = ("      *reinterpret_cast<uint4*>(dst + k * plane) =\n"
         "          make_uint4(w[k][0], w[k][1], w[k][2], w[k][3]);")
# a store that (almost) never happens but needs every byte computed
SINK = ("      if ((w[k][0] ^ w[k][1] ^ w[k][2] ^ w[k][3]) == 0x9e3779b9u)\n"
        + STORE)
LOOKUP = "      x[e] = tab[b1 + (p.nb + 1) * (bh + p.nb * bv)];"
TRANSPOSE = "    transpose4(x, w[0][q], w[1][q], w[2][q], w[3][q]);"
ITEM = "      item<kAligned>(p, s, sm, g, b, i, ch);"
THREADS = "constexpr int kThreads = 1024;"
VARIANTS = {
    "base": [],
    "threads_512": [(THREADS, THREADS.replace("1024", "512"))],
    "stores_only": [(TRANSPOSE, "    w[0][q] = w[1][q] = w[2][q] = w[3][q] ="
                                " 0x01010101u;")],
    "no_stores": [(STORE, SINK)],
    "buckets_only": [(LOOKUP, LOOKUP.replace("tab[", "(").replace("];", ");")),
                     (STORE, SINK)],
    "prologue_only": [(ITEM, "      if (i < 0) break;")],
    "no_table": [("  bias_build_table_kernel<<<",
                  "  if (false) bias_build_table_kernel<<<")],
}
TILES = "constexpr int kTiles = 2;"
GRID = "  return ctas < 2 ? 2 : ctas;"
RESIDENT = """  int dev = 0, sms = 132, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, normalize_u8_tiles<false>, kThreads, 0);
  const long long most = (long long)sms * per_sm;
  return ctas < sms ? sms : ctas > most ? most : ctas;"""
NORMALIZE_VARIANTS = {
    "normalize_tiles_1": [(TILES, TILES.replace("2", "1"))],
    "normalize_tiles_4": [(TILES, TILES.replace("2", "4"))],
    "normalize_resident": [(GRID, RESIDENT)],
}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the entry before the redesign: t1, th, tv, scales, hx, vy, positions, lut1,
# lut2, B, H, L, nb, max1, max2, scaling, out, stream
PARENT_SIGNATURE = [_P] * 9 + [_I] * 6 + [_F, _P, _P]
# --alt's entry: t1, th, tv, table dtype, bbox, positions, lut1, lut2, B, H,
# L, nb, max1, max2, scaling, grid, smem, out, scales, stream
ALT_SIGNATURE = [_P] * 3 + [_I] + [_P] * 4 + [_I] * 6 + [_F] + [_I] * 2 \
    + [_P] * 3


def compile_all(sources: dict) -> dict:
    """{label: ctypes library} of {label: source text}, one nvcc each, all
    at once; prints each build's ptxas registers and spills."""
    from markushgrapher_torch.ops import _build

    procs = []
    for label, text in sources.items():
        d = _build.BUILD_DIR / "bias_bench" / label
        d.mkdir(parents=True, exist_ok=True)
        src = d / "kernel.cu"
        src.write_text(text)
        so = d / "lib.so"
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so),
               str(src)]
        procs.append((label, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = {}
    for label, so, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {label}:\n{log}")
        for sym, usage in chip_smoke.ptxas_usage(
                log, ("bias_build", "normalize_u8")):
            print(f"{label}: {sym.split('_kernel')[0][-30:]}... {usage}",
                  flush=True)
        libs[label] = ctypes.CDLL(str(so))
    return libs


def variant_sources(name: str, variants: dict) -> dict:
    """{label: source text} of the port's `name` with each variant's text
    edits."""
    from markushgrapher_torch.ops import _build

    text = (_build.CSRC / name).read_text()
    out = {}
    for label, edits in variants.items():
        src = text
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"{label}: the kernel no longer has "
                                   f"{old!r}")
            src = src.replace(old, new)
        out[label] = src
    return out


def new_launch(lib, args, pos):
    """The launch of a build of the current C entry from library `lib` on
    chip_smoke's arguments: the wrapper's plan with the card's count of
    resident CTAs of that build."""
    import torch

    from markushgrapher_torch.ops import _build, bias_build

    t1, th, tv, bbox, _, length, nb, max1, scaling, max2 = args
    fn = lib.mg_bias_build_i8
    fn.argtypes = _build._SIGNATURES["mg_bias_build_i8"]
    fn.restype = _I
    lib.mg_bias_build_i8_resident.argtypes = [_I]
    batch, heads = bbox.shape[0], t1.shape[1]
    smem = bias_build.smem_bytes(length, nb, max1, max2, pos is not None)
    p = bias_build.plan(batch, heads, length, nb, max1, max2,
                        pos is not None,
                        lib.mg_bias_build_i8_resident(smem))
    luts = [bias_build.device_lut(nb, m, bbox.device) for m in (max1, max2)]
    out = torch.empty((batch, heads, length, length), dtype=torch.int8,
                      device=bbox.device)
    scales = torch.empty((heads,), dtype=torch.float32, device=bbox.device)
    work = torch.empty((p.groups * bias_build.table_words(nb),),
                       dtype=torch.int32, device=bbox.device)

    def launch():
        rc = fn(t1.data_ptr(), th.data_ptr(), tv.data_ptr(),
                bias_build.TABLE_DTYPES[t1.dtype], bbox.data_ptr(),
                None if pos is None else pos.data_ptr(), luts[0].data_ptr(),
                luts[1].data_ptr(), batch, heads, length, nb, max1, max2,
                float(scaling), p.ranges, p.per_cta, p.smem, work.data_ptr(),
                work.numel(), out.data_ptr(), scales.data_ptr(),
                _build.stream(out))
        _build.check(rc, "bias_build_i8")
        return out, scales
    return launch


def alt_launch(lib, args, pos):
    """The launch of --alt's one-launch design: as many CTAs as the card
    holds of it (its own plan at these shapes)."""
    import torch

    from markushgrapher_torch.ops import _build, bias_build

    t1, th, tv, bbox, _, length, nb, max1, scaling, max2 = args
    fn = lib.mg_bias_build_i8
    fn.argtypes = ALT_SIGNATURE
    fn.restype = _I
    lib.mg_bias_build_i8_smem.argtypes = [_I] * 6
    lib.mg_bias_build_i8_resident.argtypes = [_I]
    batch, heads = bbox.shape[0], t1.shape[1]
    smem = lib.mg_bias_build_i8_smem(heads, length, nb, max1, max2,
                                     int(pos is not None))
    grid = lib.mg_bias_build_i8_resident(smem)
    luts = [bias_build.device_lut(nb, m, bbox.device) for m in (max1, max2)]
    out = torch.empty((batch, heads, length, length), dtype=torch.int8,
                      device=bbox.device)
    scales = torch.empty((heads,), dtype=torch.float32, device=bbox.device)

    def launch():
        rc = fn(t1.data_ptr(), th.data_ptr(), tv.data_ptr(),
                bias_build.TABLE_DTYPES[t1.dtype], bbox.data_ptr(),
                None if pos is None else pos.data_ptr(), luts[0].data_ptr(),
                luts[1].data_ptr(), batch, heads, length, nb, max1, max2,
                float(scaling), grid, smem, out.data_ptr(),
                scales.data_ptr(), _build.stream(out))
        _build.check(rc, "bias_build_i8 alt")
        return out, scales
    return launch


def parent_launch(lib, args, pos):
    """The kernel before the redesign: the caller makes the scales, centres
    and LUTs."""
    import torch

    from markushgrapher_torch.ops import _build
    from markushgrapher_torch.ops.relbias import (bbox_centres, bias_scales,
                                                  bucket_lut, combined_table)

    t1, th, tv, bbox, _, length, nb, max1, scaling, max2 = args
    fn = lib.mg_bias_build_i8
    fn.argtypes = PARENT_SIGNATURE
    fn.restype = _I
    dev = bbox.device
    t1, th, tv = (t.float().contiguous() for t in (t1, th, tv))
    scales = bias_scales(combined_table(t1, th, tv, nb))
    hx, vy = (c.contiguous() for c in bbox_centres(bbox))
    luts = [bucket_lut(nb, m, dev) for m in (max1, max2)]
    batch, heads = bbox.shape[0], t1.shape[1]
    out = torch.empty((batch, heads, length, length), dtype=torch.int8,
                      device=dev)

    def launch():
        rc = fn(t1.data_ptr(), th.data_ptr(), tv.data_ptr(),
                scales.data_ptr(), hx.data_ptr(), vy.data_ptr(),
                None if pos is None else pos.data_ptr(), luts[0].data_ptr(),
                luts[1].data_ptr(), batch, heads, length, nb, max1, max2,
                float(scaling), out.data_ptr(), _build.stream(out))
        _build.check(rc, "bias_build_i8 parent")
        return out, scales
    return launch


def turns(calls: dict, rounds: int, iters: int) -> dict:
    """{label: [ms per round]} of zero-argument launches, timed in turns."""
    times = {label: [] for label in calls}
    for r in range(rounds):
        for label in (list(calls) if r % 2 == 0 else list(calls)[::-1]):
            times[label].append(chip_smoke.cuda_ms(calls[label], iters, 3))
    return times


def bench_bias(libs: dict, rounds: int) -> None:
    import torch

    from markushgrapher_torch.ops import bias_build

    dev = torch.device("cuda")
    for n, (batch, length, packed) in enumerate(chip_smoke.BIAS_SHAPES):
        rng = np.random.RandomState(chip_smoke.SEED if n == 0
                                    else chip_smoke.SEED + 100 + n)
        args, pos = chip_smoke.bias_inputs(rng, dev, batch, length, packed)
        args = (*(t.to(torch.bfloat16) for t in args[:3]), *args[3:])
        launchers = {"parent": parent_launch, "alt": alt_launch}
        calls = {label: launchers.get(label, new_launch)(lib, args, pos)
                 for label, lib in libs.items()}
        ref, s_ref = bias_build.plain(*args, positions=pos)
        for label in ("base", "alt", "parent"):
            if label in calls:
                got, s_got = calls[label]()
                torch.cuda.synchronize()
                if not (torch.equal(got, ref) and torch.equal(s_got, s_ref)):
                    raise AssertionError(f"{label} B={batch} L={length}: "
                                         "differs from plain")
                del got
        bound_ms = chip_smoke.bound(chip_smoke.nbytes(
            *args[:5], ref, s_ref, *([] if pos is None else [pos])),
            0)["bound_ms"]
        del ref
        shape = f"B={batch} H=16 L={length}{' packed' if packed else ''}"
        for label, t in turns(calls, rounds, 20 if batch < 48 else 5).items():
            print(f"{label:<13} {shape}: {min(t):.4f} - {max(t):.4f} ms over "
                  f"{rounds} rounds; bound {bound_ms:.4f} ms "
                  f"({bound_ms / min(t):.1%})", flush=True)
        del calls
        torch.cuda.empty_cache()


def bench_normalize(libs: dict, rounds: int) -> None:
    import torch

    from markushgrapher_torch.config import VTLConfig
    from markushgrapher_torch.ops import _build, preprocess

    side = VTLConfig().image_size
    rng = np.random.RandomState(chip_smoke.SEED)
    r, m, s = preprocess._constants(0.5, 0.5)
    for b, dt in ((48, torch.bfloat16), (8, torch.float32),
                  (8, torch.bfloat16)):
        pages = torch.tensor(rng.randint(0, 256, (b, side, side, 3)),
                             dtype=torch.uint8, device="cuda")
        ref = preprocess.plain_normalize_u8(pages, 0.5, 0.5, dt)
        n = chip_smoke.turns_past_l2(chip_smoke.nbytes(pages, ref))
        copies = [pages] + [pages.clone() for _ in range(n - 1)]
        calls = {}
        for label, lib in libs.items():
            fn = lib.mg_normalize_u8
            fn.argtypes = _build._SIGNATURES["mg_normalize_u8"]
            fn.restype = _I

            def call(x, fn=fn):
                out = torch.empty_like(ref)
                _build.check(fn(x.data_ptr(), x.numel(), r, m, s,
                                int(dt == torch.bfloat16), out.data_ptr(),
                                _build.stream(out)), "normalize_u8")
                return out
            torch.cuda.synchronize()
            if not torch.equal(call(pages), ref):
                raise AssertionError(f"normalize_u8 {label} differs")
            calls[label] = chip_smoke.in_turns(call, copies)
        bound_ms = chip_smoke.bound(chip_smoke.nbytes(pages, ref),
                                    0)["bound_ms"]
        shape = f"[{b}, {side}, {side}, 3] -> {str(dt).split('.')[-1]}"
        for label, t in turns(calls, rounds, 50).items():
            print(f"{label:<18} {shape}: {min(t):.4f} - {max(t):.4f} ms over "
                  f"{rounds} rounds, {n} page batches in turn; bound "
                  f"{bound_ms:.4f} ms ({bound_ms / min(t):.1%})", flush=True)
        del copies, calls
        torch.cuda.empty_cache()


def main() -> None:
    import torch

    from markushgrapher_torch.ops import _build

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--parent", default=None)
    ap.add_argument("--alt", default=None)
    ap.add_argument("--normalize-parent", default=None)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bias_bench: needs a CUDA device")
    print(chip_smoke.gpu_line(), flush=True)
    sources = variant_sources("bias_build_i8.cu", VARIANTS)
    if a.alt:
        sources["alt"] = open(a.alt).read()
    if a.parent:
        sources["parent"] = open(a.parent).read()
    if a.normalize_parent:
        sources.update(variant_sources(
            "normalize_u8.cu",
            {"normalize": [], **NORMALIZE_VARIANTS}))
        sources["normalize_parent"] = open(a.normalize_parent).read()
    libs = compile_all(sources)
    norm = {k: libs.pop(k) for k in list(libs) if k.startswith("normalize")}
    bench_bias(libs, a.rounds)
    if norm:
        bench_normalize(norm, a.rounds)


if __name__ == "__main__":
    main()
