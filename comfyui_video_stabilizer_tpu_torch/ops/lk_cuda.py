"""Pyramidal-LK Gauss-Newton iterations for every feature (PyTorch + K5).

Counterpart of ``comfyui_video_stabilizer_tpu/ops/lk_pallas.py::
lk_gn_iterate``.  Each feature carries its 49x49 search window ``jw``,
its sampled 31x31 template ``T`` with Scharr gradients ``gx``/``gy``,
and nine scalars (``scal`` columns, the Pallas row map):

  a, b, c, inv_det   the 2x2 normal matrix and 1/det
  run                1.0 when the track is runnable at this level
  base_x, base_y     the window's top-left corner (level pixels)
  guess_x, guess_y   the starting position

Per iteration, with half = 15, lo = 0.5 and hi = WEXT - WIN - 0.5:

  ly = clip(g_y - half - base_y, lo, hi)       (lx likewise)
  J  = bilinear 31x31 patch of jw at (ly, lx): rows (1-fy) W[ey] + fy W[ey+1],
       then columns the same
  bx = sum gx (J - T), by = sum gy (J - T): each row's 31 terms in
       sequence, then the 31 row sums in sequence
  dx = -(c bx - b by) inv_det,  dy = -(-b bx + a by) inv_det
  g  = clip(g + (dx, dy), base + half + lo, base + half + hi)
  done when dx^2 + dy^2 <= float32(eps^2), after 5 steps in a row with
  step^2 >= 0.98 x the previous one, or after ``iters`` iterations.

The Pallas kernel blends over 19 static shifts with per-lane weights of
which only two are nonzero; adding the zero terms is exact, so the
two-tap blend gives the same numbers.  A finished feature never moves,
so each feature stops on its own here instead of per 128-feature block.
A feature that is not runnable returns its guess and 0 iterations
(the caller's ``_lk_post`` keeps the guess for it in any case).

``lk_gn_iterate`` is the kernel wrapper: a CUDA tensor launches K5
(``csrc/lk.cu``), a CPU tensor takes ``lk_gn_plain``, which runs the
same operations in the same order, batched over the unfinished features.
"""

from __future__ import annotations

import numpy as np
import torch

from . import cuda_build

WIN = 31
WEXT = 49
N_SCAL = 9
COL_A, COL_B, COL_C, COL_INVD, COL_RUN = 0, 1, 2, 3, 4
COL_BASE_X, COL_BASE_Y, COL_GUESS_X, COL_GUESS_Y = 5, 6, 7, 8


def _eps2(eps: float) -> float:
    return float(np.float32(eps * eps))


def lk_gn_plain(jw, T, gx, gy, scal, iters: int, eps: float):
    """Plain PyTorch version of K5: (g (N, 2) float32, iterations (N,) int32)."""
    n = jw.shape[0]
    half = WIN // 2
    lo, hi = 0.5, WEXT - WIN - 0.5
    eps2 = _eps2(eps)
    a, b, c, invd, run, base_x, base_y, g_x, g_y = scal.unbind(1)
    g_x, g_y = g_x.clone(), g_y.clone()
    prev2 = torch.full((n,), 1.0e30, dtype=torch.float32, device=jw.device)
    stall = torch.zeros(n, dtype=torch.int32, device=jw.device)
    count = torch.zeros(n, dtype=torch.int32, device=jw.device)
    done = run <= 0.5
    ar = torch.arange(WIN, device=jw.device)
    for _ in range(iters):
        act = torch.nonzero(~done).squeeze(1)
        k = act.numel()
        if k == 0:
            break
        gxa, gya = g_x[act], g_y[act]
        bxa, bya = base_x[act], base_y[act]
        ly = torch.clamp((gya - half) - bya, lo, hi)
        lx = torch.clamp((gxa - half) - bxa, lo, hi)
        ey, ex = torch.floor(ly), torch.floor(lx)
        fy, fx = (ly - ey)[:, None, None], (lx - ex)[:, None, None]
        rows = ey.to(torch.int64)[:, None] + ar
        cols = ex.to(torch.int64)[:, None] + ar
        win = jw[act]
        r0 = win.gather(1, rows[:, :, None].expand(k, WIN, WEXT))
        r1 = win.gather(1, (rows + 1)[:, :, None].expand(k, WIN, WEXT))
        rb = (1.0 - fy) * r0 + fy * r1
        c0 = rb.gather(2, cols[:, None, :].expand(k, WIN, WIN))
        c1 = rb.gather(2, (cols + 1)[:, None, :].expand(k, WIN, WIN))
        res = ((1.0 - fx) * c0 + fx * c1) - T[act]
        px, py = gx[act] * res, gy[act] * res
        sx, sy = px[:, :, 0], py[:, :, 0]
        for j in range(1, WIN):
            sx, sy = sx + px[:, :, j], sy + py[:, :, j]
        bx, by = sx[:, 0], sy[:, 0]
        for i in range(1, WIN):
            bx, by = bx + sx[:, i], by + sy[:, i]
        aa, bb, cc, dd = a[act], b[act], c[act], invd[act]
        dx = -(cc * bx - bb * by) * dd
        dy = -(-bb * bx + aa * by) * dd
        g_x[act] = torch.minimum(torch.maximum(gxa + dx, (bxa + half) + lo), (bxa + half) + hi)
        g_y[act] = torch.minimum(torch.maximum(gya + dy, (bya + half) + lo), (bya + half) + hi)
        step2 = dx * dx + dy * dy
        st = torch.where(step2 >= 0.98 * prev2[act], stall[act] + 1, 0)
        stall[act] = st
        prev2[act] = step2
        count[act] += 1
        done[act] = (step2 <= eps2) | (st >= 5)
    return torch.stack([g_x, g_y], dim=1), count


def lk_gn_iterate(jw: torch.Tensor, T: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor,
                  scal: torch.Tensor, iters: int, eps: float):
    """Run the Gauss-Newton loop for N features.

    jw (N, 49, 49); T, gx, gy (N, 31, 31); scal (N, 9) float32 (COL_*
    map above).  Returns (g (N, 2) float32 tracked (x, y), iterations
    (N,) int32).  CUDA tensors launch K5 (raising if it cannot build or
    launch); CPU tensors take the plain version.
    """
    if jw.device.type == "cpu":
        return lk_gn_plain(jw, T, gx, gy, scal, iters, eps)
    n = jw.shape[0]
    cuda_build.require_cuda_tensor("jw", jw, torch.float32, 3)
    for name, t in (("T", T), ("gx", gx), ("gy", gy)):
        cuda_build.require_cuda_tensor(name, t, torch.float32, 3)
        if tuple(t.shape) != (n, WIN, WIN) or t.device != jw.device:
            raise cuda_build.KernelArgumentError(
                f"{name} must be ({n}, {WIN}, {WIN}) on {jw.device}, got {tuple(t.shape)}")
    cuda_build.require_cuda_tensor("scal", scal, torch.float32, 2)
    if tuple(jw.shape[1:]) != (WEXT, WEXT) or tuple(scal.shape) != (n, N_SCAL) or scal.device != jw.device:
        raise cuda_build.KernelArgumentError(f"K5 takes jw (N, {WEXT}, {WEXT}) and scal (N, {N_SCAL}), got "
                                             f"{tuple(jw.shape)} and {tuple(scal.shape)}")
    if not 1 <= n < 2**31 or iters < 0:
        raise cuda_build.KernelArgumentError(
            f"K5 takes 1 <= N < 2**31 features and iters >= 0, got {n}, {iters}")
    g = torch.empty((n, 2), dtype=torch.float32, device=jw.device)
    count = torch.empty(n, dtype=torch.int32, device=jw.device)
    with torch.cuda.device(jw.device):
        err = cuda_build.library().cvst_lk_gn(
            jw.data_ptr(), T.data_ptr(), gx.data_ptr(), gy.data_ptr(), scal.data_ptr(),
            g.data_ptr(), count.data_ptr(), n, iters, _eps2(eps),
            cuda_build.current_stream(jw.device),
        )
    cuda_build.check_launch(err, "lk_gn")
    cuda_build.LAUNCHES["lk_gn"] += 1
    return g, count
