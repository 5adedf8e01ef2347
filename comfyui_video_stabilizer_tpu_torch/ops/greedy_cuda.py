"""The min-distance greedy of GFTT corner selection (PyTorch + K7).

Counterpart of ``comfyui_video_stabilizer_tpu/ops/lk.py::_greedy_device``,
which the JAX package runs on the device as a ``lax.scan`` of
16-candidate blocks.  For (B, K) int32 candidates ``top_idx`` (flat
pixel indices ``y * w + x`` in score order, -1 for an invalid one; the
valid ones sort first), each frame accepts, in that order, a valid
candidate whose float32 squared distance to every corner accepted before
it is at least ``min_distance**2``, until ``max_corners`` are accepted.
Returns (pts (B, max_corners, 2) float32 (x, y), counts (B,) int32);
unused slots hold (0, 0).

``greedy_min_distance`` is the kernel wrapper: a CUDA tensor launches K7
(``csrc/greedy.cu``: one block a frame, the candidates in blocks of 32),
a CPU tensor takes ``greedy_plain``, one step per candidate over the
whole batch.  ``greedy_blocked_plain`` repeats K7's four steps a block
in plain torch (no caller uses it; the CPU tests hold it to
``greedy_plain``).  The coordinates are integers, so every distance test
is exact and all of them agree exactly with the JAX scan and with the
native greedy (``native/rectangle.cpp``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import cuda_build

# the accepted corners K7 keeps in shared memory, 8 bytes a slot (48 KB)
MAX_KERNEL_CORNERS = 6144
# K7's candidates a block, one a lane of a warp (csrc/greedy.cu kBlock)
KERNEL_BLOCK = 32


def _min_d2(min_distance: float) -> float:
    """min_distance**2 rounded to float32, as the JAX scan forms it."""
    return float(np.float32(min_distance * min_distance))


def greedy_plain(top_idx: torch.Tensor, w: int, max_corners: int = 400,
                 min_distance: float = 7.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K7: the candidates one at a time, every
    frame of the batch at once."""
    B, K = top_idx.shape
    dev = top_idx.device
    idx = top_idx.to(torch.int64)
    valid = idx >= 0
    yi = torch.div(idx, w, rounding_mode="floor")
    ys, xs = yi.to(torch.float32), (idx - yi * w).to(torch.float32)
    min_d2 = _min_d2(min_distance)
    acc_x = torch.zeros((B, max_corners), dtype=torch.float32, device=dev)
    acc_y = torch.zeros_like(acc_x)
    n = torch.zeros(B, dtype=torch.int64, device=dev)
    slots = torch.arange(max_corners, device=dev)
    for j in range(K):
        y, x = ys[:, j, None], xs[:, j, None]
        near = (((acc_y - y) * (acc_y - y) + (acc_x - x) * (acc_x - x)) < min_d2) & (slots < n[:, None])
        ok = valid[:, j] & (n < max_corners) & ~near.any(dim=1)
        put = ok[:, None] & (slots == n[:, None])
        acc_x = torch.where(put, x, acc_x)
        acc_y = torch.where(put, y, acc_y)
        n = n + ok
    return torch.stack([acc_x, acc_y], dim=-1), n.to(torch.int32)


def greedy_blocked_plain(top_idx: torch.Tensor, w: int, max_corners: int = 400, min_distance: float = 7.0,
                         block: int = KERNEL_BLOCK) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7's design in plain PyTorch (``csrc/greedy.cu``): the candidates in
    blocks of ``block``, every frame at once.  Per block: (1) each
    candidate against the corners of earlier blocks; (2) each candidate's
    mask of the earlier candidates of its block closer than min_distance;
    (3) the kernel's rounds: an undecided live candidate with no undecided
    earlier neighbour is accepted, one with an earlier neighbour just
    accepted rejected; the accepted are cut to the first
    ``max_corners - n`` and take the next slots in order.  The result is
    :func:`greedy_plain`'s."""
    B, K = top_idx.shape
    dev = top_idx.device
    idx = top_idx.to(torch.int64)
    valid = idx >= 0
    yi = torch.div(idx, w, rounding_mode="floor")
    ys, xs = yi.to(torch.float32), (idx - yi * w).to(torch.float32)
    min_d2 = _min_d2(min_distance)
    acc_x = torch.zeros((B, max_corners), dtype=torch.float32, device=dev)
    acc_y = torch.zeros_like(acc_x)
    n = torch.zeros(B, dtype=torch.int64, device=dev)
    slots = torch.arange(max_corners, device=dev)
    for c0 in range(0, K, block):
        y, x, v = ys[:, c0:c0 + block], xs[:, c0:c0 + block], valid[:, c0:c0 + block]
        c = y.shape[1]
        dy, dx = acc_y[:, None, :] - y[:, :, None], acc_x[:, None, :] - x[:, :, None]
        near = ((dy * dy + dx * dx < min_d2) & (slots < n[:, None])[:, None, :]).any(dim=2)
        # earlier[b, i, j]: j < i and j closer than min_distance to i
        dy, dx = y[:, None, :] - y[:, :, None], x[:, None, :] - x[:, :, None]
        earlier = (dy * dy + dx * dx < min_d2) & torch.ones((c, c), dtype=torch.bool, device=dev).tril(-1)
        open_ = v & ~near
        take = torch.zeros_like(open_)
        while bool(open_.any()):
            now = open_ & ~(earlier & open_[:, None, :]).any(dim=2)
            lost = open_ & (earlier & now[:, None, :]).any(dim=2)
            take |= now
            open_ &= ~(now | lost)
        slot = n[:, None] + torch.cumsum(take, dim=1) - take.to(torch.int64)
        take &= slot < max_corners
        put = take[:, :, None] & (slot[:, :, None] == slots)
        acc_x = torch.where(put.any(dim=1), (put * x[:, :, None]).sum(dim=1), acc_x)
        acc_y = torch.where(put.any(dim=1), (put * y[:, :, None]).sum(dim=1), acc_y)
        n = n + take.sum(dim=1)
    return torch.stack([acc_x, acc_y], dim=-1), n.to(torch.int32)


def greedy_min_distance(top_idx: torch.Tensor, w: int, max_corners: int = 400,
                        min_distance: float = 7.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The greedy of every frame's candidates (module docstring).

    CUDA tensors launch K7 (raising if it cannot build or launch, or
    refuses the arguments); CPU tensors take the plain version.
    """
    if top_idx.device.type == "cpu":
        return greedy_plain(top_idx, w, max_corners, min_distance)
    cuda_build.require_cuda_tensor("top_idx", top_idx, torch.int32, 2)
    B, K = top_idx.shape
    if B < 1 or not 1 <= K < 2**31 or not 1 <= w < 2**31 or not 1 <= max_corners <= MAX_KERNEL_CORNERS:
        raise cuda_build.KernelArgumentError(
            f"K7 takes B >= 1 frames of 1 <= K < 2**31 candidates, 1 <= w < 2**31 and 1 <= max_corners <= "
            f"{MAX_KERNEL_CORNERS}, got {tuple(top_idx.shape)}, w {w}, max_corners {max_corners}")
    pts = torch.empty((B, max_corners, 2), dtype=torch.float32, device=top_idx.device)
    counts = torch.empty(B, dtype=torch.int32, device=top_idx.device)
    with torch.cuda.device(top_idx.device):
        for s, e in cuda_build.frame_spans(B):
            err = cuda_build.library().cvst_greedy(
                top_idx[s:e].data_ptr(), pts[s:e].data_ptr(), counts[s:e].data_ptr(), e - s, K, int(w),
                int(max_corners), _min_d2(min_distance), cuda_build.current_stream(top_idx.device),
            )
            cuda_build.check_launch(err, "greedy")
            cuda_build.LAUNCHES["greedy"] += 1
    return pts, counts
