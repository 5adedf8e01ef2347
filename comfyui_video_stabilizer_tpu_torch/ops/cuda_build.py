"""Build and bind the port's hand-written CUDA kernels.

The kernels in ``csrc/`` are compiled by ``nvcc`` for Hopper (sm_90a),
one ``nvcc`` per source, all started together, then linked into ONE
shared library with a plain C interface and loaded with ``ctypes``; no
PyTorch headers are compiled, so a build takes seconds.
The library lands in :func:`build_dir`, named by a hash of the sources
and flags, at first use; a later call with unchanged sources reuses it.
Nothing here runs at import time.

``-fmad=false`` keeps every multiply and add a separately rounded op,
as in the plain PyTorch versions the kernels are checked against, so
kernel and plain version agree bitwise.

``LAUNCHES`` counts kernel launches per kernel.  Each wrapper adds one
where it launches its kernel and nowhere else, so a caller can reset
the counts, run the main path and see which kernels it went through.

Every kernel puts the frame (or pair) index on a grid axis that holds at
most 65,535 blocks; the wrappers split longer stacks into launches over
:func:`frame_spans`, one count per launch.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

PACKAGE_DIR = pathlib.Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
SOURCES = ("warp.cu", "cost_volume.cu", "gftt.cu", "lk.cu", "extract.cu", "greedy.cu", "gray.cu", "linalg.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-Xcompiler", "-fPIC",
    "-Xptxas=-v",
)

# the largest grid y or z dimension a launch may have
MAX_GRID_FRAMES = 65535


class KernelError(RuntimeError):
    """A hand-written kernel could not be built, loaded or launched.

    Raised by this module, and as one of the two subclasses below by a
    kernel's wrapper that refuses its arguments on the card.  The Flow
    estimator's backend chain re-raises it instead of degrading to a
    slower tier, so a broken or refused kernel never passes as a
    degraded run."""


class KernelArgumentError(KernelError, ValueError):
    """A kernel's wrapper refused the arguments it was to launch with."""


class KernelTypeError(KernelError, TypeError):
    """A kernel's wrapper refused a tensor of the wrong dtype."""


LAUNCHES = {"warp": 0, "warp_blur": 0, "cost_volume": 0, "gftt": 0, "lk_gn": 0, "extract_windows": 0,
            "greedy": 0, "padding_stats": 0, "gray_pool": 0, "smallest_eigvec": 0, "solve8": 0,
            "homography_4pt": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def frame_spans(n: int) -> list[tuple[int, int]]:
    """[(start, end)] covering frames 0..n-1 in order, each at most
    ``MAX_GRID_FRAMES`` long."""
    return [(s, min(n, s + MAX_GRID_FRAMES)) for s in range(0, n, MAX_GRID_FRAMES)]


def build_dir(package_dir: pathlib.Path = PACKAGE_DIR) -> pathlib.Path:
    """Where the native libraries are built, never inside an install tree.

    In a source checkout (the package directory beside ``pyproject.toml``)
    that is the checkout's git-ignored ``build/``; an installed package
    builds into ``$XDG_CACHE_HOME`` (default ``~/.cache``) under
    ``comfyui_video_stabilizer_tpu_torch/build``.
    """
    root = package_dir.parent
    if (root / "pyproject.toml").is_file():
        return root / "build"
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(os.path.expanduser("~"), ".cache")
    return pathlib.Path(cache) / package_dir.name / "build"


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME / $CUDA_PATH, then $PATH, then the default
    toolkit location; raises when there is none."""
    candidates = []
    for var in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(var)
        if root:
            candidates.append(os.path.join(root, "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for cand in candidates:
        if os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise KernelError(
        "nvcc not found (looked in $CUDA_HOME, $CUDA_PATH, $PATH and the "
        "default toolkit location); the CUDA kernels cannot be built"
    )


def library_path() -> pathlib.Path:
    digest = hashlib.sha256()
    for name in SOURCES:
        digest.update(name.encode())
        digest.update((CSRC_DIR / name).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"libcvst_kernels_{digest.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the kernels unless a library of the same sources exists.

    Each source compiles in its own ``nvcc`` process, all started
    together; the objects are then linked into one library.  The
    compiler's resource report (registers, shared memory, spills
    per kernel, from ``-Xptxas=-v``) is kept beside the library as
    ``<name>.log``.  Writes to a temporary name and renames, so
    concurrent builders never load a half-written library.
    """
    path = library_path()
    if path.exists():
        return path
    nvcc = find_nvcc()
    objdir = path.parent / f"{path.stem}.{os.getpid()}.objs"
    objdir.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    try:
        compiles = []
        for name in SOURCES:
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(objdir / f"{name}.o"), str(CSRC_DIR / name)]
            compiles.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        report = [proc.communicate()[0] for _, proc in compiles]
        for (cmd, proc), out in zip(compiles, report):
            if proc.returncode != 0:
                raise KernelError(
                    f"nvcc failed with exit code {proc.returncode}:\n{' '.join(cmd)}\n{out}"
                )
        link = [nvcc, "-shared", "-o", str(tmp), *(str(objdir / f"{s}.o") for s in SOURCES)]
        proc = subprocess.run(link, capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise KernelError(
                f"nvcc failed with exit code {proc.returncode}:\n{' '.join(link)}\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        path.with_suffix(".log").write_text("".join(report))
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)
        shutil.rmtree(objdir, ignore_errors=True)
    return path


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library with every entry point's signature set."""
    path = build()
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as exc:
        raise KernelError(f"the kernel library {path} does not load: {exc}") from exc
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.cvst_warp.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, i32, ptr]
    lib.cvst_warp.restype = i32
    lib.cvst_warp_blur.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, i32, ptr]
    lib.cvst_warp_blur.restype = i32
    lib.cvst_padding_stats.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, ptr]
    lib.cvst_padding_stats.restype = i32
    lib.cvst_gray_pool.argtypes = [ptr, ptr, i32, i32, i32, i32, i32, i32, i32, ptr]
    lib.cvst_gray_pool.restype = i32
    lib.cvst_cost_volume.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr]
    lib.cvst_cost_volume.restype = i32
    lib.cvst_gftt_gray.argtypes = [ptr, ptr, i32, i32, i32, ptr]
    lib.cvst_gftt_gray.restype = i32
    lib.cvst_lk_gn.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, ctypes.c_float, ptr]
    lib.cvst_lk_gn.restype = i32
    lib.cvst_extract_windows.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr]
    lib.cvst_extract_windows.restype = i32
    lib.cvst_greedy.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, ctypes.c_float, ptr]
    lib.cvst_greedy.restype = i32
    lib.cvst_smallest_eigvec.argtypes = [ptr, ptr, i32, i32, ptr]
    lib.cvst_smallest_eigvec.restype = i32
    lib.cvst_solve8.argtypes = [ptr, ptr, ptr, i32, ptr]
    lib.cvst_solve8.restype = i32
    lib.cvst_homography_4pt.argtypes = [ptr, ptr, ptr, i32, ptr]
    lib.cvst_homography_4pt.restype = i32
    lib.cvst_error_string.argtypes = [i32]
    lib.cvst_error_string.restype = ctypes.c_char_p
    return lib


def current_stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_launch(err: int, kernel: str) -> None:
    """Raise when a launch was refused (cudaGetLastError() != 0)."""
    if err != 0:
        msg = library().cvst_error_string(err).decode()
        raise KernelError(f"CUDA kernel {kernel!r} failed to launch: error {err} ({msg})")


def require_cuda_tensor(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int) -> None:
    """Validate a kernel argument before its pointer is passed on."""
    if t.device.type != "cuda":
        raise KernelArgumentError(f"{name} must be a CUDA tensor, got device {t.device}")
    if t.dtype != dtype:
        raise KernelTypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise KernelArgumentError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise KernelArgumentError(f"{name} must be contiguous")
