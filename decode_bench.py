"""Where the decode cluster core's time goes: builds of it with one phase
taken out, and optionally the kernel it replaced, timed side by side on one
card, for one of its three uses.

    python3 decode_bench.py [--kernel int4|i8|lattice] [--rounds 4]
        [--parent PATH] [--trace] [--splits N,...]
    python3 decode_bench.py --tc-model

--kernel picks the use: decode_int4 (`csrc/decode_int4.cu`, the core's
Int4Pair policy; the default), decode_i8 (`csrc/decode_i8.cu`, its Int8
policy) or lattice_self_int4 (decode_int4's entry with the row map, blocks
of one segment and the live segments' keys). Each variant is a copy of
`markushgrapher_torch/csrc/decode_cluster.cuh` with text edits (VARIANTS)
beside the entry's source, compiled with the port's nvcc flags into a
library of its own under the git-ignored
`markushgrapher_torch/_build/decode_bench/`, one nvcc per variant, all at
once:
  base        the kernel as it is;
  no_pv       no P V products (the staging, scores, softmax, barriers and
              the cluster's reduction remain);
  no_scores   no score products either (each score is its bias);
  stage_only  no products and no softmax: the copies, the block maxima, the
              cluster barriers and the reduction;
  launch_only each CTA returns on entry (the launch of the grid);
  to_barrier_1  each CTA returns after cluster barrier 1 (staging, scores,
              block maxima, the maxima exchanged).
--parent names the source of an older kernel for the same use, built beside
every `*.cuh` of its own directory and timed as `parent`: e.g. `mkdir -p
build/parent && git archive <commit> markushgrapher_torch/csrc | tar -x -C
build/parent`, then `--parent
build/parent/markushgrapher_torch/csrc/decode_i8.cu` (or `decode_int4.cu`,
`lattice_i4.cu`). Its C entry takes the slot table as this one's does, or,
before the cluster design, the head map (`mg_decode_int4`, `mg_decode_i8`)
or the lattice's (`mg_lattice_i4`: row map, segment, live segments). The
variants other than base compute another function; they are timed, not
checked. A checked build's line gives its largest error against the plain
version and the entries outside chip_smoke.py's tolerance, which is
chip_smoke's gate, not this script's. Each shape's first line gives, for
every count of CTAs a cluster that fits, the clusters the card holds at
once (decode_cluster.cuh's max_clusters) beside the plan's model. --splits also times base with each given count of CTAs a cluster
(`base@N`) in place of the plan's. --trace also builds base with
-DDECODE_CLUSTER_TRACE and prints, for each shape, where one launch's CTAs
spend their time: the median and largest span of each interval between the
kernel's ten stamps, the spread of the CTAs' entries and the first entry to
the last exit. --tc-model instead checks the plain versions' model of a
tensor-core score sum (`ops.mxu_decode._scores`, `ops.tensor_core`) against
the card: one warp's chain of mma.sync m16n8k16 over D = 64, the core's score
product, on 4000 seeded tiles of 16 keys x 8 query rows, and prints how
often the model, and a float32 product sum, give the card's sum exactly.

The shapes, with seeded inputs of their own: chip_smoke.py phase 3's (rows
4-6 of PERF.md: the MG greedy cross at b8, Kp=1792 (and Kp=1280, the int8
headline); the beam cross with 5 beams folded, Kp=1280 and 1792; the
beam-5 self ring, 40 rows, S=512, step 300, whole, through a row map of
blocks of 128, up to its valid prefix and both; the OCR ring, B=8, 15 rows
over 5 kv heads, S=640, p=503), the greedy cross at b48 and the beam cross
at b16 (Kp=1792), whose CTAs take several waves, and the fixed cost (one
sample, one run of bytes, 512 keys); for the lattice the self ring at 1 and
4 live segments of 128 (steps 100 and 500) at 40 and 80 rows. Times with
`chip_smoke.cuda_ms`, the builds in turns (in order, then reversed); each
line gives the fastest and slowest round. Prints the card's name and power
limit and each build's ptxas registers and spills. Needs a CUDA device and
nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np

import chip_smoke

# the P V and score loops of both paths (tensor cores, CUDA cores) and the
# softmax loop; a variant makes each run over no keys
PV_LOOPS = ("    for (int kb = warp * 16; kb < n; kb += kWarps * 16) {",
            "  for (int kl = gi; !tc && kl < n; kl += groups) {")
SCORE_LOOPS = ("  for (int kb = warp * 16; tc && kb < n; kb += kWarps * 16) {",
               "  for (int kl = tid; !tc && kl < n; kl += kT) {")
TERM_LOOP = ("  for (int kl = tid; kl < n; kl += kT) {\n"
             "    const int j = by_seg(kl);")


def _none(*loops):
    return [(loop, loop.replace("< n;", "< 0;")) for loop in loops]


ENTRY = "  cg::cluster_group cluster = cg::this_cluster();\n"
BARRIER1 = "  cluster.sync();  // barrier 1: every CTA holds every CTA's maxima"
VARIANTS = {
    "base": [],
    "launch_only": [(ENTRY, "  if (live > 0) return;\n" + ENTRY)],
    "to_barrier_1": [(BARRIER1, BARRIER1 + "\n  if (live > 0) return;")],
    "no_pv": _none(*PV_LOOPS),
    "no_scores": _none(*PV_LOOPS, *SCORE_LOOPS),
    "stage_only": _none(*PV_LOOPS, *SCORE_LOOPS, TERM_LOOP),
}
# appended to the base build's entry: the clusters of `splits` CTAs of
# `smem` bytes the card holds at once (decode_cluster.cuh's max_clusters)
OCCUPANCY = """
extern "C" int mg_bench_clusters(int rows, int D, int splits, int smem) {
  return max_clusters<POLICY>(rows, D, splits, smem);
}
"""
CORE = "decode_cluster.cuh"
# --kernel: (entry source, its C entry)
KINDS = {"int4": ("decode_int4.cu", "mg_decode_int4"),
         "i8": ("decode_i8.cu", "mg_decode_i8"),
         "lattice": ("decode_int4.cu", "mg_decode_int4")}
_P, _I = ctypes.c_void_p, ctypes.c_int
# the C entries before the cluster design: q, kq, ks, vq, vs, bias,
# head_map, row_map, B, R, G, D, K, scale_rows, bias_bstride, bias_rstride,
# block_k, live, out_bf16, out, stream; the lattice's: q, kq, ks, vq, vs,
# bias, row_map, B, R, G, D, L, scale_rows, bias_bstride, bias_rstride, seg,
# n_live, out_bf16, out, stream
HEAD_MAP_SIGNATURE = [_P] * 8 + [_I] * 11 + [_P, _P]
LATTICE_SIGNATURE = [_P] * 7 + [_I] * 11 + [_P, _P]


# --tc-model: keys [T, 16, D] times q [T, 8, D] -> [T, 16, 8] float32, by
# one warp's mma.sync m16n8k16 (bf16, a float32 accumulator from zero), 16
# dims a step, as the cluster core takes its scores
TC_PROBE = r"""
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>
__device__ uint32_t pair(const __nv_bfloat16* p, int i) {
  __nv_bfloat162 v;
  v.x = p[i];
  v.y = p[i + 1];
  return *reinterpret_cast<uint32_t*>(&v);
}
__global__ void tc_probe(const __nv_bfloat16* keys, const __nv_bfloat16* q,
                         float* out, int D) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* a = keys + (size_t)blockIdx.x * 16 * D;
  const __nv_bfloat16* b = q + (size_t)blockIdx.x * 8 * D;
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k = 0; k < D; k += 16) {
    const uint32_t ar[4] = {pair(a, g * D + k + 2 * t),
                            pair(a, (g + 8) * D + k + 2 * t),
                            pair(a, g * D + k + 2 * t + 8),
                            pair(a, (g + 8) * D + k + 2 * t + 8)};
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(ar[0]), "r"(ar[1]), "r"(ar[2]), "r"(ar[3]),
          "r"(pair(b, g * D + k + 2 * t)), "r"(pair(b, g * D + k + 2 * t + 8)));
  }
  float* o = out + (size_t)blockIdx.x * 128;
  o[g * 8 + 2 * t] = c[0];
  o[g * 8 + 2 * t + 1] = c[1];
  o[(g + 8) * 8 + 2 * t] = c[2];
  o[(g + 8) * 8 + 2 * t + 1] = c[3];
}
extern "C" int mg_tc_probe(const void* keys, const void* q, void* out,
                           int tiles, int D) {
  tc_probe<<<tiles, 32>>>((const __nv_bfloat16*)keys,
                          (const __nv_bfloat16*)q, (float*)out, D);
  return (int)cudaGetLastError();
}
"""


def tc_model(dev) -> None:
    """How often `mxu_decode._scores`'s model of the tensor-core score sum
    gives the card's own, exactly: int8 and int4 key values with q at 0.5
    scale (the scale of this script's inputs), and int8 keys with q spread
    over 24 octaves."""
    import torch

    from markushgrapher_torch.ops import _build, mxu_decode, tensor_core

    d = _build.BUILD_DIR / "decode_bench" / "tc_probe"
    d.mkdir(parents=True, exist_ok=True)
    (d / "tc_probe.cu").write_text(TC_PROBE)
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                    str(d / "lib.so"), str(d / "tc_probe.cu")], check=True,
                   capture_output=True)
    fn = ctypes.CDLL(str(d / "lib.so")).mg_tc_probe
    fn.argtypes, fn.restype = [_P] * 3 + [_I] * 2, _I
    gen = torch.Generator().manual_seed(chip_smoke.SEED + 12)
    tiles, dim = 4000, 64
    for label, top, octaves in (("int8 keys, q at 0.5 scale", 128, 0),
                                ("int4 keys, q at 0.5 scale", 8, 0),
                                ("int8 keys, q over 24 octaves", 128, 24)):
        keys = torch.randint(1 - top, top, (tiles, 16, dim), generator=gen)
        q = torch.randn((tiles, 8, dim), generator=gen) * 0.5
        if octaves:
            q = q * torch.exp2(-torch.randint(0, octaves, q.shape,
                                              generator=gen).float())
        keys = keys.to(dev, torch.bfloat16)
        q = q.to(dev, torch.bfloat16)
        out = torch.empty((tiles, 16, 8), device=dev)
        _build.check(fn(keys.data_ptr(), q.data_ptr(), out.data_ptr(), tiles,
                        dim), "tc_probe")
        model = mxu_decode._scores(q.float(), keys.float()[:, :, None].expand(
            tiles, 16, 8, dim)).transpose(1, 2)
        f32 = torch.einsum("tkd,trd->tkr", keys.float(), q.float())
        print(f"tensor-core score sums, {label}: the plain model (TC_ALIGN "
              f"{tensor_core.TC_ALIGN}) gives the card's in "
              f"{float((model == out).float().mean()):.4%}, a float32 "
              f"product sum in {float((f32 == out).float().mean()):.4%}",
              flush=True)


TRACE_CTAS, TRACE_POINTS = 4096, 10
INTERVALS = ("issue", "K lands", "scores", "maxima + barrier 1",
             "running max", "p, l + V lands", "P V", "push + barrier 2",
             "outputs")


def parent_form(src: str, kind: str) -> str:
    """How the parent's C entry takes its call: "slots" (the cluster
    core's), "head_map" or "lattice"."""
    if kind == "lattice" and "mg_lattice_i4" in src:
        return "lattice"
    return "slots" if "const int* slots" in src else "head_map"


def build(kind: str, parent: Path | None, trace: bool = False):
    """({label: C entry} of every variant and the parent, the parent's
    form, the trace build's (entry, trace reader) or None, and the base
    build's count of co-resident clusters: (rows, D, splits, smem) ->
    clusters)."""
    from markushgrapher_torch.ops import _build

    entry, symbol = KINDS[kind]
    sources = {}
    for label, edits in VARIANTS.items():
        src = (_build.CSRC / CORE).read_text()
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"{label}: the core no longer has "
                                   f"{old!r}")
            src = src.replace(old, new)
        sources[label] = src
    if trace:
        sources["trace"] = sources["base"]
    procs = []
    for label, core in sources.items():
        d = _build.BUILD_DIR / "decode_bench" / kind / label
        d.mkdir(parents=True, exist_ok=True)
        (d / CORE).write_text(core)
        src = (_build.CSRC / entry).read_text()
        if label == "base":
            src += OCCUPANCY.replace(
                "POLICY", "Int8" if kind == "i8" else "Int4Pair")
        (d / entry).write_text(src)
        procs.append((label, d / entry))
    form = None
    if parent is not None:
        d = _build.BUILD_DIR / "decode_bench" / kind / "parent"
        d.mkdir(parents=True, exist_ok=True)
        for h in parent.parent.glob("*.cuh"):
            shutil.copy(h, d)
        shutil.copy(parent, d / parent.name)
        form = parent_form(parent.read_text(), kind)
        procs.append(("parent", d / parent.name))
    running = []
    for label, src in procs:
        so = src.parent / "lib.so"
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so),
               str(src)] + (["-DDECODE_CLUSTER_TRACE"] if label == "trace"
                            else [])
        running.append((label, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    fns, traced, occupancy = {}, None, None
    for label, so, proc in running:
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {label}:\n{log}")
        for sym, usage in chip_smoke.ptxas_usage(
                log, ("decode_cluster_kernel", "decode_int4_kernel",
                      "decode_i8_kernel", "lattice_i4_kernel")):
            print(f"{label}: {sym[-60:]} ptxas {usage}", flush=True)
        lib = ctypes.CDLL(str(so))
        fn = getattr(lib, "mg_lattice_i4" if label == "parent" and
                      form == "lattice" else symbol)
        fn.argtypes = ({"head_map": HEAD_MAP_SIGNATURE,
                        "lattice": LATTICE_SIGNATURE}.get(form)
                       if label == "parent" and form != "slots"
                       else _build._SIGNATURES["mg_decode_int4"])
        fn.restype = ctypes.c_int
        if label == "base":
            occupancy = lib.mg_bench_clusters
            occupancy.argtypes, occupancy.restype = [_I] * 4, ctypes.c_int
        if label == "trace":
            reader = getattr(lib, f"{symbol}_trace")
            reader.argtypes, reader.restype = [_P], ctypes.c_int
            traced = (fn, reader)
        else:
            fns[label] = fn
    return fns, form, traced, occupancy


def errors(name: str, got, want) -> str:
    """The largest |got - want| and the entries outside chip_smoke's
    TOL[name]; raises on a value that is not finite."""
    import torch

    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{name}: values that are not finite")
    err = (g - w).abs()
    atol, rtol = chip_smoke.TOL[name]
    out = int((err > atol + rtol * w.abs()).sum())
    return f"max abs err {float(err.max()):.3e}, {out} outside TOL"


def show_trace(label, reader, run, ctas):
    """The stamps of one launch of `ctas` CTAs: per interval the median and
    largest span over the CTAs (SM clock, converted at the clock the
    stamps show), the entries' spread and first entry to last exit."""
    import torch

    run()
    torch.cuda.synchronize()
    n = TRACE_CTAS * TRACE_POINTS
    buf = np.zeros(2 * n, dtype=np.uint64)
    if reader(buf.ctypes.data):
        raise RuntimeError("reading the trace failed")
    k = min(ctas, TRACE_CTAS)
    clk = buf[:n].reshape(TRACE_CTAS, TRACE_POINTS)[:k].astype(np.int64)
    gt = buf[n:].reshape(TRACE_CTAS, TRACE_POINTS)[:k].astype(np.int64)
    span = gt[:, -1] - gt[:, 0]
    ghz = float(np.median((clk[:, -1] - clk[:, 0])[span > 0] /
                          span[span > 0]))
    us = np.diff(clk, axis=1) / ghz / 1e3
    print(f"  trace {label}: {k} CTAs, entries spread over "
          f"{(gt[:, 0].max() - gt[:, 0].min()) / 1e3:.2f} us, first entry to "
          f"last exit {(gt[:, -1].max() - gt[:, 0].min()) / 1e3:.2f} us (SM "
          f"clock {ghz:.3f} GHz); median / largest us: " + "; ".join(
              f"{name} {np.median(u):.2f} / {u.max():.2f}"
              for name, u in zip(INTERVALS, us.T)), flush=True)


def shapes(dev, kind: str):
    """[(label, operands, options)] at phase 3's shapes, seeded; the
    lattice's options are (row_map, n_live, seg)."""
    import torch

    from markushgrapher_torch.ops import mxu_decode

    rng = np.random.RandomState(chip_smoke.SEED + 11)
    H, D = 16, 64
    int8 = kind == "i8"

    def slab(rows, n_keys, n_valid, heads=H):
        top = 128 if int8 else 8
        vals = rng.randint(1 - top, top, (rows, n_keys, heads * D)).astype(
            np.int8)
        vals[:, n_valid:] = 0
        sc = rng.rand(rows, heads, n_keys).astype(np.float32) * 0.05
        sc[:, :, n_valid:] = 0.0
        t, s_ = torch.tensor(vals, device=dev), torch.tensor(sc, device=dev)
        if int8:
            return t, s_
        return mxu_decode.pack_int4(t), s_.to(torch.bfloat16)

    def call(rows, n_q, n_keys, n_valid, bias, heads=H):
        q = torch.tensor(rng.randn(rows, n_q, D).astype(np.float32) * 0.5,
                         device=dev).to(torch.bfloat16)
        kq, ks = slab(rows, n_keys, n_valid, heads)
        vq, vs = slab(rows, n_keys, n_valid, heads)
        return (q, kq, ks, vq, vs, bias)

    def masked(rows, n_keys, n_valid):
        b = torch.zeros((rows, 1, n_keys), device=dev)
        b[..., n_valid - 100:] = -1e9
        return b

    def causal(heads, ring, step):
        b = torch.full((1, heads, ring), torch.finfo(torch.float32).min,
                       device=dev)
        b[..., :step + 1] = torch.tensor(
            rng.randn(1, heads, step + 1).astype(np.float32) * 0.5,
            device=dev)
        return b

    if kind == "lattice":
        out = []
        for rows in (40, 80):
            rmap = torch.tensor(rng.randint(0, rows, (rows, 4)),
                                dtype=torch.int32, device=dev)
            for n_live, step in ((1, 100), (4, 500)):
                out.append((f"lattice rows={rows} R=16 S=512 seg=128 "
                            f"n_live={n_live}",
                            call(rows, H, 512, step + 1, causal(H, 512, step)),
                            dict(row_map=rmap, n_live=n_live, seg=128)))
        return out
    beam = tuple(range(H)) * 5
    out = [(f"cross B=8 R=16 Kp={kp}",
            call(8, H, kp, kp * 4 // 5, masked(8, kp, kp * 4 // 5)), {})
           for kp in ((1280, 1792) if int8 else (1792,))]
    for kp in (1280, 1792):
        out.append((f"beam cross B=8 R=80 Kp={kp}",
                    call(8, 5 * H, kp, kp - 100, masked(8, kp, kp - 100)),
                    dict(head_map=beam)))
    ring = call(40, H, 512, 301, causal(H, 512, 300))
    rmap = torch.tensor(rng.randint(0, 40, (40, 4)), dtype=torch.int32,
                        device=dev)
    prefix = mxu_decode.valid_prefix_blocks(512, 300, 128)
    for form, kw in (("whole", {}), ("row map", dict(row_map=rmap,
                                                     block_k=128)),
                     ("valid prefix", prefix),
                     ("row map + valid prefix", dict(prefix, row_map=rmap))):
        out.append((f"self rows=40 R=16 S=512 {form}", ring, kw))
    ocr = call(8, 15, 640, 504, causal(1, 640, 503), heads=5)
    out.append(("OCR ring B=8 R=15 G=5 S=640", ocr, {}))
    out.append(("cross B=48 R=16 Kp=1792",
                call(48, H, 1792, 1433, masked(48, 1792, 1433)), {}))
    out.append(("beam cross B=16 R=80 Kp=1792",
                call(16, 5 * H, 1792, 1692, masked(16, 1792, 1692)),
                dict(head_map=beam)))
    # the fixed cost: one cluster of 8 CTAs of 64 keys
    out.append(("floor B=1 R=2 G=2 K=512",
                call(1, 2, 512, 512, torch.zeros((1, 1, 512), device=dev),
                     heads=2), {}))
    return out


def main() -> None:
    import torch

    from markushgrapher_torch.ops import _build, mxu_decode

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", choices=tuple(KINDS), default="int4")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--splits", default="")
    ap.add_argument("--tc-model", action="store_true")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("decode_bench: needs a CUDA device")
    print(chip_smoke.gpu_line(), flush=True)
    if a.tc_model:
        tc_model(torch.device("cuda"))
        return
    _build.lib()
    fns, form, traced, occupancy = build(a.kernel, a.parent, a.trace)
    dev = torch.device("cuda")
    elem = mxu_decode.INT8 if a.kernel == "i8" else mxu_decode.INT4
    tol = "lattice_self_int4" if a.kernel == "lattice" else elem.name
    for label, (q, kq, ks, vq, vs, bias), kw in shapes(dev, a.kernel):
        if a.kernel == "lattice":
            lat = kw
            kw = dict(row_map=lat["row_map"], block_k=lat["seg"],
                      live_keys=lat["n_live"] * lat["seg"])
            want = mxu_decode.plain_lattice_int4(q, kq, ks, vq, vs, bias,
                                                 **lat)
        else:
            want = (mxu_decode.plain_int8 if a.kernel == "i8"
                    else mxu_decode.plain_int4)(q, kq, ks, vq, vs, bias, **kw)
        hm, block, live, plan = mxu_decode.int4_call_plan(
            q, kq, ks, vq, vs, bias, **kw, elem=elem)
        B, R, d = q.shape
        G, K = kq.shape[2] * elem.per_byte // d, kq.shape[1]
        slots = mxu_decode._int4_slot_table(R, G, hm, str(dev), elem)
        hmt = (None if hm is None else torch.tensor(hm, dtype=torch.int32,
                                                     device=dev))
        hmd = 0 if hmt is None else hmt.data_ptr()
        rm = kw.get("row_map")
        rmp = 0 if rm is None else rm.data_ptr()
        aligned = int(kw.get("block_k") is not None)
        out = torch.empty_like(q)
        bb = bias.shape[1] * K if bias.shape[0] > 1 else 0
        br = K if bias.shape[1] > 1 else 0
        common = [t.data_ptr() for t in (q, kq, ks, vq, vs, bias)]

        alts = {}
        unit = block if aligned else mxu_decode.I4_GRAIN
        units = -(-live // unit)
        srows = mxu_decode.int4_scale_rows(ks.shape[1] == R, plan.rows, G,
                                           elem)
        fit = []
        for split in range(1, mxu_decode.I4_CLUSTER + 1):
            per = -(-units // split)
            n_split, keys = -(-units // per), min(per * unit, live)
            smem = mxu_decode.int4_smem(d, plan.rows, srows, keys,
                                        plan.seg if aligned else keys,
                                        elem.scale_bytes)
            if smem <= mxu_decode.I4_SMEM and n_split == split:
                clusters = occupancy(plan.rows, d, split, smem)
                fit.append(f"{split}: {smem} B, {B * slots.shape[0] * split}"
                           f" CTAs, {clusters * split} resident (model "
                           f"{mxu_decode.int4_resident(smem, d)})")
        print(f"{label}: splits " + "; ".join(fit), flush=True)
        for split in (int(x) for x in a.splits.split(",") if x):
            per = -(-units // split)
            keys = min(per * unit, live)
            if split != plan.splits and mxu_decode.int4_smem(
                    d, plan.rows, mxu_decode.int4_scale_rows(
                        ks.shape[1] == R, plan.rows, G, elem), keys,
                    plan.seg if aligned else keys, elem.scale_bytes) <= \
                    mxu_decode.I4_SMEM:
                alts[f"base@{-(-units // per)}"] = (-(-units // per),
                                                   per * unit)

        def run(name):
            fn = traced[0] if name == "trace" else fns[name.split("@")[0]]
            splits, chunk = alts.get(name, (plan.splits, plan.chunk))
            if name == "parent" and form == "lattice":
                rc = fn(*common, rmp, B, R, G, d, K, ks.shape[1], bb, br,
                        lat["seg"], lat["n_live"], 1, out.data_ptr(),
                        _build.stream(out))
            elif name == "parent" and form == "head_map":
                rc = fn(*common, hmd, rmp, B, R, G, d, K, ks.shape[1], bb,
                        br, block, live, 1, out.data_ptr(),
                        _build.stream(out))
            else:
                rc = fn(*common, slots.data_ptr(), rmp, B, R, G, d, K,
                        ks.shape[1], bb, br, block, live, slots.shape[0],
                        plan.rows, splits, chunk, aligned, 1,
                        out.data_ptr(), _build.stream(out))
            _build.check(rc, name)

        for name in ("base", "parent", *alts):
            if name in fns or name in alts:
                run(name)
                print(f"{label}: {name} {errors(tol, out, want)}",
                      flush=True)
        names = list(fns) + list(alts)
        times = {name: [] for name in names}
        for r in range(a.rounds):
            order = names if r % 2 == 0 else names[::-1]
            for name in order:
                times[name].append(chip_smoke.cuda_ms(lambda: run(name), 50,
                                                      3))
        bound = chip_smoke.decode_bound(q, kq, ks, vq, vs, bias, out)
        print(f"{label} (clusters of {plan.splits}, {plan.chunk} keys a CTA,"
              f" {plan.rows} rows a slot, {slots.shape[0]} slots, "
              f"{plan.smem} B; bound {bound['bound_ms']:.4f} ms): " +
              "; ".join(f"{n} {min(t):.4f} - {max(t):.4f}"
                        for n, t in times.items()), flush=True)
        if traced is not None:
            run("base")  # warm
            show_trace(label, traced[1], lambda: run("trace"),
                       B * slots.shape[0] * plan.splits)


if __name__ == "__main__":
    main()
