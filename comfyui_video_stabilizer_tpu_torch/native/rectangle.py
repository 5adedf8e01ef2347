"""ctypes binding of the port's native host helpers (``rectangle.cpp``):
the largest all-ones rectangle and the corner greedy.

A copy of ``comfyui_video_stabilizer_tpu/native/rectangle.py``.  The
shared library is built with ``g++`` at first use
into ``ops/cuda_build.py::build_dir`` (a checkout's git-ignored
``build/``, an installed package's user cache), beside the CUDA kernel
library, named by a hash of the source and flags; it is never written
next to its source.  A build with no compiler raises (there is no
Python fallback).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import subprocess
from typing import Tuple

import numpy as np

from ..ops.cuda_build import build_dir

_SRC = pathlib.Path(__file__).resolve().parent / "rectangle.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def library_path() -> pathlib.Path:
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return build_dir() / f"librectangle_{digest}.so"


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    """Build (once; to a temporary name, then renamed, so concurrent
    builders never load a half-written file) and load the library."""
    path = library_path()
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        try:
            subprocess.run(["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp)], check=True, capture_output=True)
            os.replace(tmp, path)
        finally:
            tmp.unlink(missing_ok=True)
    lib = ctypes.CDLL(str(path))
    lib.largest_rectangle.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.largest_rectangle.restype = None
    lib.greedy_min_distance.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_double, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
    ]
    lib.greedy_min_distance.restype = ctypes.c_int64
    return lib


def largest_axis_aligned_rectangle(binary_mask: np.ndarray) -> Tuple[int, int, int, int]:
    """Largest all-ones axis-aligned rectangle of a 2-D mask (nonzero =
    valid) -> (x0, y0, w, h); (0, 0, W, H) when the mask has no one."""
    lib = _load()
    mask = np.ascontiguousarray(binary_mask > 0, dtype=np.uint8)
    h, w = mask.shape
    out = np.zeros(4, np.int64)
    lib.largest_rectangle(
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(h), ctypes.c_int64(w),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return int(out[0]), int(out[1]), int(out[2]), int(out[3])


def greedy_min_distance(
    ys: np.ndarray, xs: np.ndarray, height: int, width: int,
    min_distance: float, max_corners: int,
) -> np.ndarray:
    """Score-descending greedy acceptance; returns (k, 2) xy points."""
    lib = _load()
    ys64 = np.ascontiguousarray(ys, np.int64)
    xs64 = np.ascontiguousarray(xs, np.int64)
    out = np.zeros((max_corners, 2), np.int64)
    k = lib.greedy_min_distance(
        ys64.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        xs64.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(len(ys64)), ctypes.c_int64(height), ctypes.c_int64(width),
        ctypes.c_double(min_distance), ctypes.c_int64(max_corners),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return out[:k]
