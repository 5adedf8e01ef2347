"""Sparse feature tracking: GFTT corners + pyramidal Lucas-Kanade (PyTorch).

Counterpart of ``comfyui_video_stabilizer_tpu/ops/lk.py`` along its TPU
product path:

* ``gftt_batch``: the score map straight from the gray (K4,
  ops/gftt_cuda.py, which forms the Sobel gradients of ``_conv2`` and
  their products itself), the quality threshold and the top 2048
  candidates, then the score-descending min-distance-7 greedy (K7,
  ops/greedy_cuda.py, the JAX package's ``_greedy_device``), all on the
  grays' device: nothing leaves it.  ``gftt_batch_host`` runs the greedy
  on the host in the port's native C++ helper (``native/rectangle.py``,
  a copy of the JAX package's), the sequential oracle the tests hold K7
  and its plain version to; it is not on any product path.
* ``lk_track``: a 4-level Gaussian pyramid, then per level ``_lk_prep``
  (window extraction, K6, ops/extract_cuda.py; Scharr gradients;
  template sampling; the 2x2 normal equations), the Gauss-Newton loop
  (K5, ops/lk_cuda.py) and ``_lk_post``.

Reflect-101 borders come from one index map (ops/pad.py) that accepts
pads as wide as the axis, as jnp.pad does.  The XLA iteration backend
of the JAX package (``_lk_level_all``, used under a sharding mesh) is
not ported (ROADMAP.md).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..native import rectangle as _native
from . import extract_cuda as EX
from . import gftt_cuda as GF
from . import greedy_cuda as GR
from . import lk_cuda as LKC
from .conv import _SOBEL_X, _SOBEL_Y, _conv2  # noqa: F401  (re-exported)
from .pad import reflect_pad

MAX_CORNERS = 400
QUALITY_LEVEL = 0.01
MIN_DISTANCE = 7.0
BLOCK_SIZE = 21
WIN = 31
MAX_LEVEL = 3
MAX_ITERS = 50
EPS = 0.01
TRAVEL = 8                      # max displacement from the level's init
WEXT = WIN + 2 * TRAVEL + 2     # extracted search window side
TOP_K = 2048                    # candidates handed to the greedy

_SCHARR_LK_X = np.outer([3, 10, 3], [-1, 0, 1]).astype(np.float32)  # cv2 LK deriv kernel
_SCHARR_LK_Y = _SCHARR_LK_X.T
_PYR_TAPS = np.array([1, 4, 6, 4, 1], np.float32)


def _topk_packed(grays: torch.Tensor, k: int) -> torch.Tensor:
    """Top-k candidate indices per frame, -1 where the score is not a
    finite positive: K4 scores, the quality threshold 0.01 x max, then a
    stable descending sort (equal scores in ascending index order, as
    jax.lax.top_k returns them)."""
    return _top_candidates(GF.gftt_scores_gray(grays.to(torch.float32).contiguous()), k)


def _top_candidates(raw: torch.Tensor, k: int) -> torch.Tensor:
    """``_topk_packed`` after K4: the threshold and the stable sort of the
    (B, H, W) scores."""
    quality = raw.flatten(1).amax(1) * QUALITY_LEVEL
    scores = torch.where(raw > quality[:, None, None], raw, float("-inf")).flatten(1)
    top_vals, top_idx = torch.sort(scores, dim=1, descending=True, stable=True)
    top_vals, top_idx = top_vals[:, :k], top_idx[:, :k]
    ok = torch.isfinite(top_vals) & (top_vals > 0)
    return torch.where(ok, top_idx, -1).to(torch.int32)


def gftt_batch(grays: torch.Tensor, max_corners: int = MAX_CORNERS) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W) -> (pts (B, max_corners, 2) float32 (x, y), counts (B,) int32),
    on the grays' device with no host copy; unused slots hold (0, 0)."""
    B, H, W = grays.shape
    return GR.greedy_min_distance(_topk_packed(grays, min(TOP_K, H * W)), W, max_corners, MIN_DISTANCE)


def greedy_host(top_idx: np.ndarray, height: int, width: int,
                max_corners: int = MAX_CORNERS) -> Tuple[np.ndarray, np.ndarray]:
    """The native greedy of each row of (B, K) candidates (the valid ones
    first, -1 after): (pts (B, max_corners, 2) float32, counts (B,) int32)
    as numpy arrays.  Raises when the helper cannot be built or loaded."""
    B = top_idx.shape[0]
    pts = np.zeros((B, max_corners, 2), np.float32)
    counts = np.zeros(B, np.int32)
    for b in range(B):
        row = top_idx[b]
        idxs = row[: int((row != -1).sum())]   # the valid candidates sort first
        accepted = _native.greedy_min_distance(idxs // width, idxs % width, height, width, MIN_DISTANCE,
                                               max_corners)
        pts[b, : accepted.shape[0]] = accepted.astype(np.float32)
        counts[b] = accepted.shape[0]
    return pts, counts


def gftt_batch_host(grays: torch.Tensor, max_corners: int = MAX_CORNERS) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`gftt_batch` with the greedy on the host (:func:`greedy_host`):
    the (B, 2048) candidates are copied to the host and the corners back
    to the grays' device.  The sequential oracle of K7; only the tests
    call it."""
    B, H, W = grays.shape
    top_idx = _topk_packed(grays, min(TOP_K, H * W)).cpu().numpy()
    pts, counts = greedy_host(top_idx, H, W, max_corners)
    return torch.from_numpy(pts).to(grays.device), torch.from_numpy(counts).to(grays.device)


def _pyr_down(stack: torch.Tensor) -> torch.Tensor:
    """Gaussian blur (1, 4, 6, 4, 1) per axis, rows then columns, x1/256,
    then stride 2; reflect-101 edges."""
    return (_conv2(stack, np.outer(_PYR_TAPS, _PYR_TAPS)) * (1.0 / 256.0))[..., ::2, ::2]


def gaussian_pyramid(stack: torch.Tensor, levels: int = MAX_LEVEL) -> List[torch.Tensor]:
    pyr = [stack.to(torch.float32)]
    for _ in range(levels):
        pyr.append(_pyr_down(pyr[-1]))
    return pyr


def _lk_prep(I_stack, J_stack, pts_level, guess, win):
    """Window extraction + template sampling + normal equations, once per level.

    Returns (wins_j (B, F, WEXT, WEXT), T, gx, gy (B, F, win, win), a, b,
    c, inv_det (B, F), runnable (B, F) bool, cur_corner (B, F, 2) int32).
    Template windows (win + 5 a side) come from the reflect-1-padded I,
    so their Scharr/32 gradients match the full-image convolution; the
    template sits at the constant offset frac(pts) + 2 in them, so the
    bilinear sample is four static slices with per-feature weights.  It
    reads window cells 2..win + 2, whose Scharr taps stay inside the
    window, so the gradients are taken on the window's interior (offset
    1) without the JAX package's reflect pad of the window: the sampled
    values are the same.
    """
    B, H, W = I_stack.shape
    F = pts_level.shape[1]
    half = win // 2
    wext_t = win + 5
    tpl_corner = torch.floor(pts_level).to(torch.int32) - half - 1
    cur_corner = torch.floor(guess).to(torch.int32) - half - TRAVEL
    # the reflect halo shifts window row r to image row corner + r - 1
    wins_t = EX.extract_windows(reflect_pad(I_stack, 1, 1).contiguous(), tpl_corner.contiguous(), wext_t)
    wins_j = EX.extract_windows(J_stack.contiguous(), cur_corner.contiguous(), WEXT)
    flat_t = wins_t.reshape(B * F, wext_t, wext_t)
    wins_gx = _conv2(flat_t, _SCHARR_LK_X / 32.0, same=False).reshape(B, F, wext_t - 2, wext_t - 2)
    wins_gy = _conv2(flat_t, _SCHARR_LK_Y / 32.0, same=False).reshape(B, F, wext_t - 2, wext_t - 2)

    fy = (pts_level[..., 1] - torch.floor(pts_level[..., 1]))[..., None, None]
    fx = (pts_level[..., 0] - torch.floor(pts_level[..., 0]))[..., None, None]

    def samp(w, o):
        tmp = (1.0 - fy) * w[..., o:o + win, :] + fy * w[..., o + 1:o + 1 + win, :]
        return (1.0 - fx) * tmp[..., o:o + win] + fx * tmp[..., o + 1:o + 1 + win]

    T, gx, gy = samp(wins_t, 2), samp(wins_gx, 1), samp(wins_gy, 1)
    a = (gx * gx).sum(dim=(2, 3))
    b = (gx * gy).sum(dim=(2, 3))
    c = (gy * gy).sum(dim=(2, 3))
    det = a * c - b * b
    d = a - c
    min_eig = 0.5 * ((a + c) - torch.sqrt(d * d + (4.0 * b) * b)) / (win * win)
    solvable = (det > 1e-7) & (min_eig > 1e-4)
    in_t = (
        (pts_level[..., 0] - half >= 0) & (pts_level[..., 0] + half <= W - 1)
        & (pts_level[..., 1] - half >= 0) & (pts_level[..., 1] + half <= H - 1)
    )
    runnable = solvable & in_t & (min(H, W) >= win)
    inv_det = torch.where(det != 0, 1.0 / torch.where(det != 0, det, 1.0), 0.0)
    return wins_j, T, gx, gy, a, b, c, inv_det, runnable, cur_corner


def _lk_post(g_iter, guess, valid, runnable, win, H, W, is_level0):
    """cv2 semantics: upper levels never kill a track; level 0 folds
    runnability and the final in-image test into the status."""
    half = win // 2
    g_out = torch.where(runnable[..., None], g_iter, guess)
    if is_level0:
        in_final = (
            (g_out[..., 0] - half >= 0) & (g_out[..., 0] + half <= W - 1)
            & (g_out[..., 1] - half >= 0) & (g_out[..., 1] + half <= H - 1)
        )
        return g_out, valid & runnable & in_final
    return g_out, valid


def gn_inputs(prep, guess):
    """K5's operands (jw, T, gx, gy, scal) from ``_lk_prep``'s outputs,
    flattened over (B, F); scal holds the columns of ops/lk_cuda.py."""
    wins_j, T, gx, gy, a, b, c, inv_det, runnable, cur_corner = prep
    n = a.numel()
    win = T.shape[-1]
    base = cur_corner.to(torch.float32)
    scal = torch.stack(
        [a, b, c, inv_det, runnable.to(torch.float32), base[..., 0], base[..., 1],
         guess[..., 0], guess[..., 1]], dim=-1,
    ).reshape(n, LKC.N_SCAL)
    return (wins_j.reshape(n, WEXT, WEXT), T.reshape(n, win, win).contiguous(),
            gx.reshape(n, win, win).contiguous(), gy.reshape(n, win, win).contiguous(),
            scal.contiguous())


def lk_level(I_stack, J_stack, pts_level, guess, valid, iters=MAX_ITERS, eps=EPS,
             is_level0=False):
    """One pyramid level for all pairs: _lk_prep, the K5 loop (31x31
    patches), _lk_post.  Returns (positions (B, F, 2), status (B, F) bool)."""
    B, H, W = I_stack.shape
    prep = _lk_prep(I_stack, J_stack, pts_level, guess, WIN)
    g, _ = LKC.lk_gn_iterate(*gn_inputs(prep, guess), iters, eps)
    runnable = prep[8]
    return _lk_post(g.reshape(guess.shape), guess, valid, runnable, WIN, H, W, is_level0)


def lk_track(prev_pyr: List[torch.Tensor], curr_pyr: List[torch.Tensor], pts: torch.Tensor,
             counts: torch.Tensor, max_level: int = MAX_LEVEL,
             iters: int = MAX_ITERS, eps: float = EPS):
    """Track points pair-wise through the pyramids.

    prev_pyr/curr_pyr: per-level (B, h, w) stacks (frames[:-1] and
    frames[1:] of one clip pyramid); pts (B, F, 2); counts (B,) valid
    features per pair.  Returns (tracked (B, F, 2), status (B, F) bool).
    """
    F = pts.shape[1]
    valid = torch.arange(F, device=pts.device)[None, :] < counts.to(pts.device)[:, None]
    g = pts / (2.0 ** max_level)
    for lvl in range(max_level, -1, -1):
        g, status = lk_level(prev_pyr[lvl], curr_pyr[lvl], pts / (2.0 ** lvl), g, valid,
                             iters, eps, lvl == 0)
        if lvl > 0:
            g = g * 2.0
        valid = valid & status
    return g, valid
