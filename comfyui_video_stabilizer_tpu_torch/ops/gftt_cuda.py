"""GFTT corner scores from the gray (PyTorch + K4).

Counterpart of ``comfyui_video_stabilizer_tpu/ops/gftt_pallas.py::
gftt_scores`` together with the Sobel gradients and products that the
JAX package forms before it (``ops/lk.py::_topk_packed``).  For a
(B, H, W) float32 gray stack:

  dx, dy     ``_conv2(g, _SOBEL_X)``, ``_conv2(g, _SOBEL_Y)`` (reflect-101)
  pa, pb, pc dx*dx, dx*dy, dy*dy
  box        21x21 sums over a reflect-101 pad of 10 of each product,
             rows then columns, each axis in the doubling order of the
             Pallas ``_rollsum``: ((S16[i] + S4[i+16]) + x[i+20]),
             S2 = x[i] + x[i+1], S4 = S2[i] + S2[i+2], S8 = S4[i] + S4[i+4],
             S16 = S8[i] + S8[i+8]
  eig        0.5 * ((a + c) - sqrt((a - c)^2 + (4 b) b))
  scores     eig where it is the maximum of its 3x3 neighbourhood (-inf
             outside the image), else -inf

The quality threshold (0.01 of each frame's maximum) and the top-k stay
with the caller (``ops/lk.py::_topk_packed``), as in the JAX package.

``gftt_scores_gray`` is the kernel wrapper: a CUDA tensor launches K4
(``csrc/gftt.cu``), a CPU tensor takes ``gftt_gray_plain``, which
computes in the same order.  ``gftt_plain`` is the part after the
products, the function the Pallas kernel computes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cuda_build
from .conv import _SOBEL_X, _SOBEL_Y, _conv2
from .pad import reflect_pad

RADIUS = 10  # (BLOCK_SIZE - 1) // 2 for the 21x21 aggregation


def _tree21(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sums of 21 consecutive entries along ``dim`` (the axis shrinks by
    20), in the doubling order of the Pallas ``_rollsum``."""
    n = x.shape[dim]

    def sl(t, start, length):
        return t.narrow(dim, start, length)

    s2 = sl(x, 0, n - 1) + sl(x, 1, n - 1)
    s4 = sl(s2, 0, n - 3) + sl(s2, 2, n - 3)
    s8 = sl(s4, 0, n - 7) + sl(s4, 4, n - 7)
    s16 = sl(s8, 0, n - 15) + sl(s8, 8, n - 15)
    m = n - 2 * RADIUS
    return (sl(s16, 0, m) + sl(s4, 16, m)) + sl(x, 2 * RADIUS, m)


def _box21(p: torch.Tensor) -> torch.Tensor:
    return _tree21(_tree21(reflect_pad(p, RADIUS, RADIUS), -2), -1)


def gftt_plain(pa: torch.Tensor, pb: torch.Tensor, pc: torch.Tensor) -> torch.Tensor:
    """(B, H, W) NMS'd min-eig scores from the Sobel products, -inf elsewhere."""
    a, b, c = _box21(pa), _box21(pb), _box21(pc)
    d = a - c
    eig = 0.5 * ((a + c) - torch.sqrt(d * d + (4.0 * b) * b))
    pooled = F.max_pool2d(eig[:, None], 3, stride=1, padding=1)[:, 0]
    return torch.where(eig >= pooled, eig, float("-inf"))


def gftt_gray_plain(g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K4: the Sobel gradients, their products,
    then ``gftt_plain``."""
    dx, dy = _conv2(g, _SOBEL_X), _conv2(g, _SOBEL_Y)
    return gftt_plain(dx * dx, dx * dy, dy * dy)


def gftt_scores_gray(g: torch.Tensor) -> torch.Tensor:
    """NMS'd min-eigenvalue scores of a gray stack.

    g: (B, H, W) float32.  Returns (B, H, W) float32 with -inf where a
    pixel fails the 3x3 NMS.  CUDA tensors launch K4 (raising if it
    cannot build or launch); CPU tensors take the plain version.
    """
    if g.device.type == "cpu":
        return gftt_gray_plain(g)
    cuda_build.require_cuda_tensor("g", g, torch.float32, 3)
    B, H, W = g.shape
    if B < 1 or H < 1 or W < 1:
        raise cuda_build.KernelArgumentError(
            f"K4 takes at least one frame of at least 1x1, got {tuple(g.shape)}")
    out = torch.empty_like(g)
    with torch.cuda.device(g.device):
        for s, e in cuda_build.frame_spans(B):
            err = cuda_build.library().cvst_gftt_gray(
                g[s:e].data_ptr(), out[s:e].data_ptr(), e - s, H, W, cuda_build.current_stream(g.device),
            )
            cuda_build.check_launch(err, "gftt")
            cuda_build.LAUNCHES["gftt"] += 1
    return out
