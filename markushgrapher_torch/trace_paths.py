"""Where the time of an encode, a prefill and a decode step goes on the card.

    python -m markushgrapher_torch.trace_paths [--stage all|mg|ocr|train]
        [--paths LABEL,...] [--batches N,...] [--out FILE]

MarkushGrapher (`--stage mg`): the flagship `MarkushGrapherConfig()` with
seeded random bf16 weights on seeded synthetic pages (as `chip_smoke.py`
does); one encode along each encoder route (int8 slab, bf16 slab, in-kernel
bias, packed) and, for each decode path (greedy or beam-5 under int4 or int8
KV with int8 weights, greedy int4 with int4 weights or W8A8 dots, and
`configs/predict.yaml`'s beam-5 over bf16 KV and bf16 weights) at the batch
sizes below, 512 steps' worth of caches with eos never firing. Beam-5 int4
also runs over copy-on-write rings of four 128-position segments (read
through the row map, and with the lattice) and greedy int4 under
`block_skip`, with windows at steps 32-48 and 300-316 beside the
one-segment beam's and the full-ring greedy's.
ChemicalOCR (`--stage ocr`): `OCRConfig()` with seeded random bf16 weights
on seeded uint8 pages at batch 8, through `ChemicalOCR.generate_batch`
with 512 new tokens, along its paths (int4 KV, int8 KV, megastep; int4 KV
with int4 weights and with W8A8 dots).
Training (`--stage train`): one `Trainer.train_step` of the flagship at
batch 8 on seeded labelled pages, TrainConfig from configs/train.yaml
without accumulation (as `chip_smoke.py` phase 6), after two warm steps.
Steps skip..skip+STEPS (skip = SKIP unless a path says otherwise) run twice:
once untraced (host clock, synchronised at both ends) and once under
`torch.profiler` with CPU and CUDA activities.
One encode (MG) or prefill (OCR) per batch size is traced the same way. For
each window it prints one line: untraced and traced ms per step, CUDA
kernels per step, the device busy share (the union of kernel intervals over
the traced wall) and the device time by kind of kernel. `--paths` / `--batches`
keep only the MG decode windows of those labels of PATHS and those batch
sizes (the encodes run at the batch sizes kept). `--out` also writes the
windows as JSON, with the top kernels by name. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

SEED = 0
SKIP, STEPS = 32, 16
TOP = 12            # kernels by name kept per window in the JSON
# (label, KV scheme, beams, batch sizes, options); "bf16": float caches and
# weights. Options: the beam's self_seg / lattice, generate's weight_bits /
# act_quant, the model's block_skip, and the first step of the window
# (default SKIP).
PATHS = (("greedy int4", "int4", 1, (8, 48), {}),
         ("greedy int8", "int8", 1, (8, 48), {}),
         ("beam-5 int4", "int4", 5, (8, 16), {}),
         ("beam-5 int8", "int8", 5, (8, 16), {}),
         ("beam-5 bf16 (predict.yaml)", "bf16", 5, (8,), {}),
         ("beam-5 int4 seg 128", "int4", 5, (8, 16), dict(self_seg=128)),
         ("beam-5 int4 lattice", "int4", 5, (8, 16), dict(lattice=True)),
         ("greedy int4 block_skip", "int4", 1, (8, 48),
          dict(block_skip=True)),
         ("greedy int4 w4", "int4", 1, (8, 48), dict(weight_bits=4)),
         ("greedy int4 w8a8", "int4", 1, (8, 48), dict(act_quant=True)))
# later windows of the paths whose reads grow with the decode index
LATE = dict(skip=300)
PATHS += tuple((label, kv, beams, sizes, dict(opts, **LATE))
               for label, kv, beams, sizes, opts in PATHS
               if label in ("greedy int4", "beam-5 int4")
               or set(opts) & {"self_seg", "lattice", "block_skip"})
# (label, ChemicalOCR engine flags) at batch OCR_BATCH
OCR_BATCH = 8
OCR_PATHS = (("ocr int4", dict(quant_kv=True, int4_kv=True,
                               quant_weights=True)),
             ("ocr int8", dict(quant_kv=True, quant_weights=True)),
             ("ocr megastep", dict(quant_kv=True, quant_weights=True,
                                   megastep=True)),
             ("ocr int4 w4", dict(quant_kv=True, int4_kv=True,
                                  quant_weights=True, weight_bits=4)),
             ("ocr int4 w8a8", dict(quant_kv=True, int4_kv=True,
                                    quant_weights=True, act_quant=True)))
TRAIN_BATCH, TRAIN_WARM = 8, 2
# device-time kinds, by the first substring of the kernel name that matches
KINDS = (("ocr_megastep", ("ocr_megastep",)),
         ("decode attention", ("decode_cluster_kernel",)),
         ("flash_i8", ("flash_i8",)), ("bias_build_i8", ("bias_build",)),
         ("flash_bias", ("flash_bias_fwd",)),
         ("flash_relbias", ("flash_relbias",)),
         ("flash_bias backward", ("flash_bias_dkv", "flash_bias_dq")),
         ("wq_linear", ("wq_linear",)),
         ("optimizer (foreach)", ("multi_tensor",)),
         ("GEMM", ("gemm", "gemv", "nvjet", "cutlass", "xmma", "cublas")),
         ("copy / fill", ("Memcpy", "Memset", "copy_", "fill_")),
         ("sort / top-k", ("sort", "Sort", "topk", "radix")),
         ("reduce", ("reduce", "Reduce")))


def select_paths(labels=None, batches=None) -> tuple:
    """PATHS cut to the given labels (comma-separated, each a label of
    PATHS) and batch sizes (comma-separated); None keeps all."""
    keep = None if labels is None else set(labels.split(","))
    sizes = None if batches is None else {int(b) for b in batches.split(",")}
    if keep is not None and keep - {p[0] for p in PATHS}:
        raise ValueError(f"not a label of PATHS: "
                         f"{sorted(keep - {p[0] for p in PATHS})}")
    out = []
    for label, kv, beams, bs, opts in PATHS:
        bs = tuple(b for b in bs if sizes is None or b in sizes)
        if bs and (keep is None or label in keep):
            out.append((label, kv, beams, bs, opts))
    return tuple(out)


class _WindowDone(Exception):
    """Raised from inside the decode loop once the window has run."""


def kind_of(name: str) -> str:
    for kind, keys in KINDS:
        if any(k in name for k in keys):
            return kind
    return "elementwise / other"


def _union_us(intervals: List[Tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def summarise(prof, wall_s: float, steps: int) -> Dict:
    """Kernels per step, busy share and device ms by kind from a finished
    profile of `steps` steps that took `wall_s` on the host clock."""
    from torch.autograd import DeviceType

    dev = [e for e in prof.events()
           if getattr(e, "device_type", None) == DeviceType.CUDA]
    spans = [(e.time_range.start, e.time_range.end) for e in dev]
    by_kind: Dict[str, float] = {}
    by_name: Dict[str, float] = {}
    for e, (s, t) in zip(dev, spans):
        k = kind_of(e.name)
        by_kind[k] = by_kind.get(k, 0.0) + (t - s) / 1e3
        by_name[e.name[:100]] = by_name.get(e.name[:100], 0.0) + (t - s) / 1e3

    def per_step(d, n=None):
        return {k: v / steps for k, v in sorted(
            d.items(), key=lambda kv: -kv[1])[:n]}

    busy_ms = _union_us(spans) / 1e3
    return dict(kernels_per_step=len(dev) / steps,
                traced_ms_per_step=wall_s * 1e3 / steps,
                busy_share=busy_ms / (wall_s * 1e3),
                device_ms_per_step=per_step(by_kind),
                top_kernels_ms_per_step=per_step(by_name, TOP))


def step_window(model, attr: str, run, traced,
                skip: Optional[int] = None) -> Tuple[float, object]:
    """Call run(), a decode loop that calls model.<attr> once per step,
    until step skip + STEPS (skip default SKIP); returns the host seconds of
    steps skip..skip+STEPS and the profiler (or None)."""
    import torch

    skip = SKIP if skip is None else skip
    prof = (torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA]) if traced else None)
    own = attr in vars(model)               # an instance attribute to restore
    inner = getattr(model, attr)
    state = {"n": 0}

    def step(*args, **kw):
        if state["n"] in (skip, skip + STEPS):
            torch.cuda.synchronize()
            if state["n"] == skip:
                if prof is not None:
                    prof.start()
                state["t0"] = time.perf_counter()
            else:
                state["wall"] = time.perf_counter() - state["t0"]
                if prof is not None:
                    prof.stop()
                raise _WindowDone
        state["n"] += 1
        return inner(*args, **kw)

    setattr(model, attr, step)
    try:
        run()
    except _WindowDone:
        pass
    finally:
        if own:
            setattr(model, attr, inner)
        else:
            delattr(model, attr)
    return state["wall"], prof


def decode_window(model, enc, mask, pack, beams, traced,
                  quant: bool = True, skip: Optional[int] = None,
                  **gen_kw) -> Tuple[float, object]:
    """The MarkushGrapher decode loop (greedy or beam search, with the
    beam's self_seg / lattice and generate's weight_bits / act_quant), over
    the model's quantised KV and quantised weights, or (quant=False) float
    caches and weights."""
    from markushgrapher_torch.decode.generate import (beam_generate,
                                                      greedy_generate)

    steps = model.cfg.max_seq_length_decoder
    kw = dict(eos_id=-1, cross_pack_len=pack, quant_cross_kv=quant,
              quant_weights=quant, **gen_kw)
    if beams == 1:
        def run():
            greedy_generate(model, enc, mask, steps, **kw)
    else:
        def run():
            beam_generate(model, enc, mask, steps, beams, **kw)
    return step_window(model, "decode_step", run, traced, skip)


def encode_window(encode, traced) -> Tuple[float, object]:
    """One call of encode() (an MG encode or an OCR prefill)."""
    import torch

    prof = (torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA]) if traced else None)
    torch.cuda.synchronize()
    if prof is not None:
        prof.start()
    t0 = time.perf_counter()
    encode()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if prof is not None:
        prof.stop()
    return wall, prof


def main(argv=None) -> None:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--stage", choices=("all", "mg", "ocr", "train"),
                    default="all")
    ap.add_argument("--paths", default=None,
                    help="comma-separated labels of PATHS to trace")
    ap.add_argument("--batches", default=None,
                    help="comma-separated batch sizes to trace")
    ap.add_argument("--out", default=None, help="write the windows as JSON")
    args = ap.parse_args(argv)
    paths = select_paths(args.paths, args.batches)
    if not torch.cuda.is_available():
        sys.exit("trace_paths: no CUDA device")
    from markushgrapher_torch.data.markush_tokenizer import MarkushTokenizer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    mt = MarkushTokenizer()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)

    windows = []

    def record(label, untraced_s, traced, steps):
        """traced: (host seconds, profiler) of the traced run."""
        res = dict(window=label, ms_per_step=untraced_s * 1e3 / steps,
                   **summarise(traced[1], traced[0], steps))
        windows.append(res)
        kinds = ", ".join(f"{k} {v:.3f}" for k, v in
                          res["device_ms_per_step"].items())
        print(f"{label}: {res['ms_per_step']:.3f} ms untraced, "
              f"{res['traced_ms_per_step']:.3f} ms traced, "
              f"{res['kernels_per_step']:.0f} kernels, busy share "
              f"{res['busy_share']:.3f}; device ms: {kinds}", flush=True)

    with torch.no_grad():
        if args.stage in ("all", "mg"):
            trace_mg(dev, mt, record, paths)
        if args.stage in ("all", "ocr"):
            trace_ocr(dev, mt, record)
    if args.stage in ("all", "train"):
        trace_train(dev, mt, record)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": card, "windows": windows}, f, indent=1)


def trace_mg(dev, mt, record, paths=PATHS) -> None:
    import torch

    from markushgrapher_torch.config import MarkushGrapherConfig
    from markushgrapher_torch.data.synthetic import page_batch
    from markushgrapher_torch.eval_pipeline import MODEL_INPUTS
    from markushgrapher_torch.models.markushgrapher import (
        ROUTES, MarkushGrapherModel, encoder_valid_max, route_flags)

    cfg = MarkushGrapherConfig()
    with torch.device(dev):
        model = MarkushGrapherModel(cfg)
    model.init_weights(SEED)
    model.to(torch.bfloat16).eval()
    for b in sorted({b for _, _, _, sizes, _ in paths for b in sizes}):
        host = page_batch(cfg, b, SEED + b, mt)
        args = [torch.as_tensor(host[k], device=dev) for k in MODEL_INPUTS]
        mv = encoder_valid_max(cfg, args[1], args[2])
        pack = -(-mv // 256) * 256

        for route in ROUTES:
            routed = model.clone(**route_flags(cfg, route, *args[1:3]))

            def encode(routed=routed, args=args):
                routed.encode(*args)

            encode_window(encode, False)                      # warm
            wall, _ = encode_window(encode, False)
            record(f"encode {route} b{b}", wall, encode_window(encode, True),
                   1)
        enc, mask = model.clone(bias_int8=True).encode(*args)
        for label, kv, beams, sizes, opts in paths:
            if b not in sizes:
                continue
            opts = dict(opts)
            skip = opts.pop("skip", SKIP)
            scheme = model.clone(int4_cross=kv == "int4",
                                 block_skip=opts.pop("block_skip", False))
            quant = kv != "bf16"
            # predict.yaml sets no cross pack
            xp = pack if quant else None
            wall, _ = decode_window(scheme, enc, mask, xp, beams, False, quant,
                                    skip, **opts)
            record(f"{label} b{b} decode steps {skip}-{skip + STEPS}", wall,
                   decode_window(scheme, enc, mask, xp, beams, True, quant,
                                 skip, **opts), STEPS)


def trace_ocr(dev, mt, record) -> None:
    import numpy as np
    import torch

    from markushgrapher_torch.data.device_pixels import ocr_from_uint8
    from markushgrapher_torch.ocr.engine import ChemicalOCR, OCREngineConfig
    from markushgrapher_torch.ocr.vlm import ChemicalOCRModel, OCRConfig

    tokens = 512
    with torch.device(dev):
        model = ChemicalOCRModel(OCRConfig(max_new_tokens=tokens))
    model.init_weights(SEED)
    model.to(torch.bfloat16).eval()
    pages = torch.tensor(np.random.RandomState(SEED).randint(
        0, 256, (OCR_BATCH, 512, 512, 3)), dtype=torch.uint8, device=dev)
    for label, flags in OCR_PATHS:
        eng = ChemicalOCR(model, mt.tokenizer, OCREngineConfig(
            max_new_tokens=tokens, batch_size=OCR_BATCH, eos_id=-1, **flags),
            device=str(dev))
        prompt = eng.prompt_ids[None].expand(OCR_BATCH, -1)

        def prefill(flags=flags):
            model.prefill(ocr_from_uint8(pages), prompt, tokens,
                          quant_kv=True, int4=flags.get("int4_kv", False))

        encode_window(prefill, False)                         # warm
        wall, _ = encode_window(prefill, False)
        record(f"{label} prefill b{OCR_BATCH}", wall,
               encode_window(prefill, True), 1)
        attr = "decode_step_mega" if flags.get("megastep") else "decode_step"

        def run(eng=eng):
            eng.generate_batch_async(pages)

        wall, _ = step_window(model, attr, run, False)
        record(f"{label} b{OCR_BATCH} decode steps {SKIP}-{SKIP + STEPS}",
               wall, step_window(model, attr, run, True), STEPS)


def trace_train(dev, mt, record) -> None:
    import torch

    from markushgrapher_torch.arguments import train_settings
    from markushgrapher_torch.config import MarkushGrapherConfig
    from markushgrapher_torch.data.synthetic import labelled_batch
    from markushgrapher_torch.models.markushgrapher import MarkushGrapherModel
    from markushgrapher_torch.train.trainer import Trainer

    cfg = MarkushGrapherConfig()
    tcfg, frozen = train_settings(str(Path(__file__).resolve().parents[1]
                                      / "configs" / "train.yaml"))
    tcfg = dataclasses.replace(tcfg, per_device_batch_size=TRAIN_BATCH,
                               gradient_accumulation_steps=1)
    batch = labelled_batch(cfg, TRAIN_BATCH, SEED, mt)
    with torch.device(dev):
        model = MarkushGrapherModel(cfg)
    trainer = Trainer(model=model, cfg=tcfg, frozen_prefixes=frozen)
    state = trainer.init_state(SEED)

    def step():
        trainer.train_step(state, batch, SEED)

    for _ in range(TRAIN_WARM):
        step()
    wall, _ = encode_window(step, False)
    record(f"train step b{TRAIN_BATCH}", wall, encode_window(step, True), 1)


if __name__ == "__main__":
    main()
