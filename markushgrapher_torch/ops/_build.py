"""Build and load the port's CUDA kernels; count their launches.

The sources in `markushgrapher_torch/csrc/*.cu` expose a plain C interface
(the two decode kernels and the OCR megastep share `decode_common.cuh`, the
float-bias flash forward and backward `flash_bias.cuh`). At first use they are
compiled with nvcc for Hopper (`sm_90a`), one nvcc
process per source, all started together, and linked into one shared
library under `markushgrapher_torch/_build/` (named by a hash of the sources
and flags, so an edit rebuilds), loaded with ctypes. Nothing is built or
imported at module import: the CPU tests import every module.

Every kernel wrapper adds one to its entry of `LAUNCHES` where it launches
its kernel, and nowhere else, so a run can show that the main path went
through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("bias_build_i8.cu", "flash_i8.cu", "decode_int4.cu",
           "decode_i8.cu", "ocr_megastep.cu", "flash_bias.cu",
           "flash_bias_bwd.cu")
# no --use_fast_math: the bias builder must be bit-exact with its plain
# version, and the attention kernels keep IEEE division and expf. The
# megastep's grid.sync() needs no -rdc (CUDA 11 and later).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: Dict[str, int] = {"bias_build_i8": 0, "flash_i8": 0,
                            "decode_int4": 0, "decode_i8": 0,
                            "ocr_megastep": 0, "flash_bias": 0,
                            "flash_bias_dkv": 0, "flash_bias_dq": 0}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # t1, th, tv, scales, hx, vy, positions, lut1, lut2,
    # B, H, L, nb, max1, max2, scaling, out, stream
    "mg_bias_build_i8": [_P] * 9 + [_I] * 6 + [_F, _P, _P],
    # q, k, v, bias, scales, key_mask, B, L, H, D, out, stream
    "mg_flash_i8": [_P] * 6 + [_I] * 4 + [_P, _P],
    # q, kq, ks, vq, vs, bias, head_map, B, R, G, D, K, scale_rows,
    # bias_bstride, bias_rstride, out_bf16, out, stream
    "mg_decode_int4": [_P] * 7 + [_I] * 9 + [_P, _P],
    "mg_decode_i8": [_P] * 7 + [_I] * 9 + [_P, _P],
    # x, out, scratch, rope, kq, ks, vq, vs, wqkv, sqkv, wo, so, wgu, sgu,
    # wd, sd, ln_attn, ln_mlp, L, B, S, Dm, H, G, D, F, pos, eps,
    # inv_sqrt_d, stream
    "mg_ocr_megastep": [_P] * 18 + [_I] * 9 + [_F, _F, _P],
    # q, k, v, bias, bias_f32, bias_batched, B, L, H, D, out, lse, stream
    "mg_flash_bias_fwd": [_P] * 4 + [_I] * 6 + [_P] * 3,
    # q, k, v, bias, bias_f32, bias_batched, do, lse, di, B, L, H, D,
    # dk, dv (dq, ds), stream
    "mg_flash_bias_dkv": [_P] * 4 + [_I] * 2 + [_P] * 3 + [_I] * 4
    + [_P] * 3,
    "mg_flash_bias_dq": [_P] * 4 + [_I] * 2 + [_P] * 3 + [_I] * 4
    + [_P] * 3,
}

_lib: Optional[ctypes.CDLL] = None
build_info: Dict[str, object] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if not cand.exists():
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin)")
    return str(cand)


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / s for s in SOURCES] + sorted(CSRC.glob("*.cuh")):
        h.update(path.read_bytes())
    return BUILD_DIR / f"libmg_kernels_{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the kernels unless the library for these sources exists:
    one nvcc per source, all running at once, then one link. Records the
    wall seconds and ptxas's register / spill report in `build_info`."""
    out = library_path()
    if out.exists():
        build_info.setdefault("seconds", 0.0)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{Path(s).stem}.{tag}.o" for s in SOURCES]
    cmds = [[nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / s)]
            for s, o in zip(SOURCES, objs)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    for cmd, proc, log in zip(cmds, procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{log}")
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    link = [nvcc(), "-shared", "-o", str(tmp), *map(str, objs)]
    proc = subprocess.run(link, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                           f"{' '.join(link)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    for o in objs:
        o.unlink()
    build_info.update(seconds=time.perf_counter() - t0, ptxas="".join(logs),
                      command=cmds + [link])
    return out


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check(rc: int, name: str) -> None:
    """Raise on the cudaError_t a C entry returned after its launch."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected CUDA tensors, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")
