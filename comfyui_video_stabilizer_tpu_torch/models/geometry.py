"""Geometry & trajectory core: matrices, parameter spaces, path math.

A copy of ``comfyui_video_stabilizer_tpu/models/geometry.py`` (numpy
only, the same code line for line; tests/test_torch_host_copies.py
holds the two equal), so the port loads nothing of the JAX package.

Host-side float64 numpy, fully vectorized over the clip (the reference
loops per frame in its nodes/stabilizer_utils.py).  This math is O(N·D)
scalars — hundreds of kilobytes for a feature-film-length clip — so it
stays on host by design: keeping it in float64 numpy gives bit-stable
metadata JSON and exact replay, while all pixel work runs in the
batched device kernels in ``ops/``.

Parameter spaces (contract, docs/requirements/001 of the reference):
  translation  -> [tx, ty]
  similarity   -> [tx, ty, theta, log_scale]
  perspective  -> [a-1, b, tx, c, d-1, ty, g, h]  (offsets from identity)
"""

from __future__ import annotations

import math
from typing import Literal, Tuple

import numpy as np

TransformMode = Literal["translation", "similarity", "perspective"]
FramingMode = Literal["crop", "crop_and_pad", "expand"]

PARAM_DIM = {"translation": 2, "similarity": 4, "perspective": 8}


# ---------------------------------------------------------------------------
# Matrix <-> parameter vector maps (vectorized over leading axes)
# ---------------------------------------------------------------------------

def matrices_to_params(matrices: np.ndarray, mode: TransformMode) -> np.ndarray:
    """(..., 3, 3) -> (..., D) smoothing parameters."""
    m = np.asarray(matrices, dtype=np.float64)
    if mode == "translation":
        return np.stack([m[..., 0, 2], m[..., 1, 2]], axis=-1)
    if mode == "similarity":
        a, c = m[..., 0, 0], m[..., 1, 0]
        scale = np.sqrt(np.maximum(a * a + c * c, 1e-10))
        theta = np.arctan2(c, a)
        return np.stack(
            [m[..., 0, 2], m[..., 1, 2], theta, np.log(scale)], axis=-1
        )
    return np.stack(
        [
            m[..., 0, 0] - 1.0,
            m[..., 0, 1],
            m[..., 0, 2],
            m[..., 1, 0],
            m[..., 1, 1] - 1.0,
            m[..., 1, 2],
            m[..., 2, 0],
            m[..., 2, 1],
        ],
        axis=-1,
    )


def params_to_matrices(params: np.ndarray, mode: TransformMode) -> np.ndarray:
    """(..., D) -> (..., 3, 3) float32 homogeneous matrices."""
    p = np.asarray(params, dtype=np.float64)
    lead = p.shape[:-1]
    out = np.zeros(lead + (3, 3), dtype=np.float64)
    out[..., 2, 2] = 1.0
    if mode == "translation":
        out[..., 0, 0] = 1.0
        out[..., 1, 1] = 1.0
        out[..., 0, 2] = p[..., 0]
        out[..., 1, 2] = p[..., 1]
    elif mode == "similarity":
        scale = np.exp(p[..., 3])
        cos_t = np.cos(p[..., 2])
        sin_t = np.sin(p[..., 2])
        out[..., 0, 0] = scale * cos_t
        out[..., 0, 1] = -scale * sin_t
        out[..., 1, 0] = scale * sin_t
        out[..., 1, 1] = scale * cos_t
        out[..., 0, 2] = p[..., 0]
        out[..., 1, 2] = p[..., 1]
    else:
        out[..., 0, 0] = p[..., 0] + 1.0
        out[..., 0, 1] = p[..., 1]
        out[..., 0, 2] = p[..., 2]
        out[..., 1, 0] = p[..., 3]
        out[..., 1, 1] = p[..., 4] + 1.0
        out[..., 1, 2] = p[..., 5]
        out[..., 2, 0] = p[..., 6]
        out[..., 2, 1] = p[..., 7]
    return out.astype(np.float32)


def matrix_to_params(matrix: np.ndarray, mode: TransformMode) -> np.ndarray:
    return matrices_to_params(matrix[None], mode)[0]


def params_to_matrix(params: np.ndarray, mode: TransformMode) -> np.ndarray:
    return params_to_matrices(np.asarray(params)[None], mode)[0]


# ---------------------------------------------------------------------------
# Estimation-resolution helpers
# ---------------------------------------------------------------------------

DEFAULT_ESTIMATION_MAX_SIDE = 960


def working_estimation_size(
    width: int, height: int, max_side: int = DEFAULT_ESTIMATION_MAX_SIDE
) -> Tuple[int, int] | None:
    """Reduced (w, h) for estimation, or None for small-enough inputs."""
    longest = max(int(width), int(height))
    if longest <= max_side:
        return None
    scale = max_side / float(longest)
    small_w = max(1, int(round(width * scale)))
    small_h = max(1, int(round(height * scale)))
    if small_w >= width or small_h >= height:
        return None
    return small_w, small_h


def rescale_transforms_to_full(
    matrices: np.ndarray,
    source_size: Tuple[int, int],
    working_size: Tuple[int, int],
) -> np.ndarray:
    """Conjugate S^-1 @ M @ S to lift working-res transforms to full res."""
    src_w, src_h = source_size
    small_w, small_h = working_size
    sx = small_w / float(src_w)
    sy = small_h / float(src_h)
    scale = np.diag([sx, sy, 1.0])
    inv_scale = np.diag([1.0 / sx, 1.0 / sy, 1.0])
    m = np.asarray(matrices, dtype=np.float64)
    return (inv_scale @ m @ scale).astype(np.float32)


# ---------------------------------------------------------------------------
# Path integration and smoothing
# ---------------------------------------------------------------------------

def integrate_path(delta_params: np.ndarray) -> np.ndarray:
    """(N-1, D) per-pair deltas -> (N, D) cumulative path, path[0] = 0."""
    deltas = np.asarray(delta_params, dtype=np.float64)
    n = deltas.shape[0] + 1
    path = np.zeros((n, deltas.shape[1]), dtype=np.float64)
    np.cumsum(deltas, axis=0, out=path[1:])
    return path


def smoothing_window(smooth: float, fps: float) -> int:
    """fps-scaled odd window length (>= 3) for the moving average."""
    fps = float(max(1.0, fps))
    min_seconds = 3.0 / 16.0
    max_seconds = 13.0 / 16.0
    window_seconds = min_seconds + smooth * (max_seconds - min_seconds)
    window = int(round(window_seconds * fps))
    window = max(3, window)
    if window % 2 == 0:
        window += 1
    return window


def smooth_path(path: np.ndarray, smooth: float, fps: float) -> np.ndarray:
    """Symmetric moving average with edge padding, all dims at once."""
    smooth = float(np.clip(smooth, 0.0, 1.0))
    path = np.asarray(path, dtype=np.float64)
    if smooth <= 0.0 or len(path) <= 2:
        return path.copy()
    window = smoothing_window(smooth, fps)
    pad = window // 2
    padded = np.pad(path, ((pad, pad), (0, 0)), mode="edge")
    kernel = np.full(window, 1.0 / window)
    # vectorized over dims via FFT-free sliding sum (cumsum trick keeps
    # float64 accuracy comparable to np.convolve for these magnitudes)
    out = np.empty_like(path)
    for dim in range(path.shape[1]):
        out[:, dim] = np.convolve(padded[:, dim], kernel, mode="valid")
    return out


# ---------------------------------------------------------------------------
# Bounding boxes, intersection/union framing solvers
# ---------------------------------------------------------------------------

def compute_bounding_boxes(
    matrices: np.ndarray, width: int, height: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Warp the 4 frame corners through each matrix; (N, 2) mins/maxs."""
    m = np.asarray(matrices, dtype=np.float64)
    corners = np.array(
        [
            [0.0, 0.0, 1.0],
            [float(width), 0.0, 1.0],
            [0.0, float(height), 1.0],
            [float(width), float(height), 1.0],
        ]
    )  # (4, 3)
    warped = np.einsum("nij,kj->nki", m, corners)  # (N, 4, 3)
    w = warped[..., 2]
    xy = warped[..., :2] / w[..., None]
    mins = xy.min(axis=1)
    maxs = xy.max(axis=1)
    return mins, maxs


def min_content_ratio(
    mins: np.ndarray, maxs: np.ndarray, width: int, height: int
) -> float:
    """Smaller of the intersection's width/height fractions."""
    x0 = float(np.max(mins[:, 0]))
    y0 = float(np.max(mins[:, 1]))
    x1 = float(np.min(maxs[:, 0]))
    y1 = float(np.min(maxs[:, 1]))
    iw = max(0.0, x1 - x0)
    ih = max(0.0, y1 - y0)
    if iw <= 0.0 or ih <= 0.0:
        return 1e-6
    return max(1e-6, min(iw / width, ih / height))


def intersection_box(mins: np.ndarray, maxs: np.ndarray) -> Tuple[float, float, float, float]:
    return (
        float(np.max(mins[:, 0])),
        float(np.max(mins[:, 1])),
        float(np.min(maxs[:, 0])),
        float(np.min(maxs[:, 1])),
    )


def prepare_expand_transform(
    mins: np.ndarray, maxs: np.ndarray
) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Union of warped bounds -> global translation + output canvas size."""
    x_min = float(np.min(mins[:, 0]))
    y_min = float(np.min(mins[:, 1]))
    x_max = float(np.max(maxs[:, 0]))
    y_max = float(np.max(maxs[:, 1]))
    out_w = int(math.ceil(x_max - x_min))
    out_h = int(math.ceil(y_max - y_min))
    translate = np.array(
        [[1.0, 0.0, -x_min], [0.0, 1.0, -y_min], [0.0, 0.0, 1.0]],
        dtype=np.float32,
    )
    return translate, (max(out_w, 1), max(out_h, 1))


def translation_matrix(tx: float, ty: float) -> np.ndarray:
    return np.array([[1.0, 0.0, tx], [0.0, 1.0, ty], [0.0, 0.0, 1.0]], dtype=np.float32)


def invert_matrices(matrices: np.ndarray) -> np.ndarray:
    """Batched 3x3 inversion in float64 (raises on singular input)."""
    return np.linalg.inv(np.asarray(matrices, dtype=np.float64))
