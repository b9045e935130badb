"""Build and load the port's CUDA kernels; count their launches.

The sources in `markushgrapher_torch/csrc/*.cu` expose a plain C interface.
At first use they are compiled with nvcc for Hopper (`sm_90a`) into one
shared library under `markushgrapher_torch/_build/` (named by a hash of the
sources and flags, so an edit rebuilds) and loaded with ctypes. Nothing is
built or imported at module import: the CPU tests import every module.

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
SOURCES = ("bias_build_i8.cu", "flash_i8.cu", "decode_int4.cu")
# no --use_fast_math: the bias builder must be bit-exact with its plain
# version, and the attention kernels keep IEEE division and expf
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: Dict[str, int] = {"bias_build_i8": 0, "flash_i8": 0,
                            "decode_int4": 0}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # t1, th, tv, scales, hx, vy, positions, lut1, lut2,
    # B, H, L, nb, max1, max2, scaling, out, stream
    "mg_bias_build_i8": [_P] * 9 + [_I] * 6 + [_F, _P, _P],
    # q, k, v, bias, scales, key_mask, B, L, H, D, out, stream
    "mg_flash_i8": [_P] * 6 + [_I] * 4 + [_P, _P],
    # q, kq, ks, vq, vs, bias, B, H, D, K, bias_bstride, bias_hstride,
    # out_bf16, out, stream
    "mg_decode_int4": [_P] * 6 + [_I] * 7 + [_P, _P],
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
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libmg_kernels_{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the kernels unless the library for these sources exists.
    Records the wall seconds and ptxas's register / spill report in
    `build_info`."""
    out = library_path()
    if out.exists():
        build_info.setdefault("seconds", 0.0)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    build_info.update(seconds=time.perf_counter() - t0,
                      ptxas=proc.stdout + proc.stderr, command=cmd)
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
