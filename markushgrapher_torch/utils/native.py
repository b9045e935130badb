"""ctypes bindings for the C++ native runtime (csrc/markush_native.cpp).

Lazy-compiles the shared library with g++ on first use (no pybind11 in the
image; ctypes per the environment constraints) and falls back to the pure-
Python implementations if the toolchain is unavailable. Consumers:
chem.evaluation.levenshtein, chem.smiles_tokenize.atomwise_tokenizer,
data.cells box splitting.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import List, Optional

import numpy as np

logger = logging.getLogger(__name__)

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc", "markush_native.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "_native_build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libmarkush_native.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def _compile() -> bool:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
           "-o", _LIB_PATH, _SRC]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        return True
    except Exception as e:
        logger.warning("native build failed (%s); using Python fallbacks", e)
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        if not os.path.exists(_LIB_PATH) or (
                os.path.exists(_SRC)
                and os.path.getmtime(_SRC) > os.path.getmtime(_LIB_PATH)):
            if not os.path.exists(_SRC) or not _compile():
                _load_failed = True
                return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
            lib.mg_levenshtein.restype = ctypes.c_int
            lib.mg_levenshtein.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
            lib.mg_atomwise_tokenize.restype = ctypes.c_int
            lib.mg_atomwise_tokenize.argtypes = [
                ctypes.c_char_p,
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
                ctypes.c_int]
            lib.mg_quantize_boxes.restype = None
            lib.mg_quantize_boxes.argtypes = [
                np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
                ctypes.c_int, ctypes.c_int,
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")]
            lib.mg_split_cell_box.restype = None
            lib.mg_split_cell_box.argtypes = [
                np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
                ctypes.c_int,
                np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")]
            _lib = lib
        except OSError as e:
            logger.warning("native load failed (%s)", e)
            _load_failed = True
    return _lib


def available() -> bool:
    return get_lib() is not None


def levenshtein(a: str, b: str) -> Optional[int]:
    lib = get_lib()
    if lib is None:
        return None
    return lib.mg_levenshtein(a.encode(), b.encode())


def atomwise_tokenize(smiles: str) -> Optional[List[str]]:
    lib = get_lib()
    if lib is None:
        return None
    data = smiles.encode()
    max_tokens = len(data) + 1
    starts = np.zeros(max_tokens, np.int32)
    lens = np.zeros(max_tokens, np.int32)
    n = lib.mg_atomwise_tokenize(data, starts, lens, max_tokens)
    if n < 0:
        return None
    return [data[starts[i]:starts[i] + lens[i]].decode()
            for i in range(n)]


def quantize_boxes(boxes: np.ndarray, scale: int = 500) -> Optional[np.ndarray]:
    lib = get_lib()
    if lib is None:
        return None
    boxes = np.ascontiguousarray(boxes, np.float32)
    out = np.zeros(boxes.shape, np.int32).reshape(-1)
    lib.mg_quantize_boxes(boxes.reshape(-1), boxes.size // 4, scale, out)
    return out.reshape(boxes.shape)


def split_cell_box(cell_box: np.ndarray,
                   word_widths: np.ndarray) -> Optional[np.ndarray]:
    lib = get_lib()
    if lib is None:
        return None
    cell_box = np.ascontiguousarray(cell_box, np.float32)
    word_widths = np.ascontiguousarray(word_widths, np.int32)
    out = np.zeros((len(word_widths), 4), np.float32)
    lib.mg_split_cell_box(cell_box, word_widths, len(word_widths),
                          out.reshape(-1))
    return out
