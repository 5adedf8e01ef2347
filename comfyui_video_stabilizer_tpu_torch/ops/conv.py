"""Separable 'SAME' convolution with reflect-101 edges, and the Sobel taps.

Counterpart of ``comfyui_video_stabilizer_tpu/ops/lk.py::_conv2``.
``ops/lk.py`` re-exports both names; they live here so that
``ops/gftt_cuda.py``, whose plain version starts from the Sobel
gradients, can import them without importing ``ops/lk.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from .pad import reflect_pad

_SOBEL_X = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float32)
_SOBEL_Y = _SOBEL_X.T


def _conv2(stack: torch.Tensor, kernel: np.ndarray, same: bool = True) -> torch.Tensor:
    """(..., H, W) (x) (kh, kw) 'SAME' with reflect-101 edges, as static
    shift-adds of the rank-1 factors: rows then columns, pivoting on the
    kernel's first nonzero so integer kernels keep exact weights, zero
    taps skipped.  ``same=False`` skips the pad and returns the
    (H - kh + 1, W - kw + 1) interior, with the same values there.

    ``_SOBEL_X`` runs rows (-1, -2, -1), then columns (1, -1);
    ``_SOBEL_Y`` runs rows (-1, 1), then columns (1, 2, 1).  K4
    (``csrc/gftt.cu``) repeats that order."""
    kernel = np.asarray(kernel, np.float64)
    kh, kw = kernel.shape
    r0, c0 = np.argwhere(kernel != 0.0)[0]
    ky64 = kernel[:, c0]
    kx64 = kernel[r0, :] / kernel[r0, c0]
    if not np.array_equal(np.outer(ky64, kx64), kernel):
        raise ValueError("_conv2 takes rank-1 kernels only")
    ky, kx = ky64.astype(np.float32), kx64.astype(np.float32)
    padded = reflect_pad(stack, kh // 2, kw // 2) if same else stack
    H, W = padded.shape[-2] - kh + 1, padded.shape[-1] - kw + 1
    v = None
    for i in range(kh):
        if ky[i] != 0.0:
            t = padded[..., i:i + H, :] * float(ky[i])
            v = t if v is None else v + t
    out = None
    for j in range(kw):
        if kx[j] != 0.0:
            t = v[..., j:j + W] * float(kx[j])
            out = t if out is None else out + t
    return out
