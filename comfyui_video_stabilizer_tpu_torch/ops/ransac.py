"""Batched RANSAC fits, median shifts and residuals (PyTorch).

Counterpart of ``comfyui_video_stabilizer_tpu/ops/ransac.py``: K
parallel minimal-set hypotheses per pair (2-point similarity or 4-point
homography), drawn over the ranks of the valid points with the same
threefry bits as ``jax.random`` (ops/prng.py), scored on the first 2048
points in chunks of 64 hypotheses, then two least-squares refits on the
winner's inliers (similarity in closed form, homography by the
normalized DLT's smallest eigenvector).  The JAX package vmaps one pair
at a time; here every tensor carries a leading pair axis and hypotheses
form a second one.

Draws are with replacement, so a 4-point draw may repeat a point: its
8x8 system is singular but for the 1e-12 ridge both packages add, and
whether LAPACK's LU then meets an exactly zero pivot is a matter of
rounding.  JAX turns such a pivot into NaN, which ``hyp_ok`` masks, on
most repeated draws but not all (4-11 % of them come out finite, and
score no inliers); the port rejects every repeated 4-point draw
outright, so its CPU and CUDA paths agree on ``hyp_ok``.  The 4-point
solves are K11's 4-point entry, which builds each system itself, and
the refit's smallest eigenvector K10 (ops/linalg_cuda.py: partial-
pivoting elimination and Jacobi in the parallel order, plain twins on
the CPU), which never read the card on the host, so a CUDA graph holds
the whole fit.  A singular system gives the same
non-finite (or finite) result on both devices.  The normal matrix's
product is a library matmul, so refits agree with the CPU to rounding,
not bitwise.

``fit_model_batch``, ``median_translation_batch`` and
``reprojection_residuals`` are the JAX package's host entry points:
numpy in and out, the work on ``device`` (the card by default) through
``ransac_fit``, ``masked_median_shift`` and ``residuals``, with one
copy back.  The engines call the device halves directly.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..utils.device import fetch_packed, resolve_device
from . import linalg_cuda as LA
from . import prng

SIM_THRESH = 2.0     # px reprojection, estimateAffinePartial2D default in reference
PERSP_THRESH = 2.5   # px reprojection, findHomography call in reference
DEFAULT_HYPOTHESES = 512
_CHUNK = 64
_N_SCORE = 2048


def _similarity_matrices(a, b, tx, ty) -> torch.Tensor:
    """[[a, -b, tx], [b, a, ty], [0, 0, 1]] over the leading axes."""
    zero = torch.zeros_like(a)
    one = torch.ones_like(a)
    rows = (torch.stack([a, -b, tx], -1), torch.stack([b, a, ty], -1),
            torch.stack([zero, zero, one], -1))
    return torch.stack(rows, -2)


def _solve_similarity_2pt(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """p, q (..., 2, 2): two correspondences -> (..., 3, 3) similarity."""
    dp = p[..., 1, :] - p[..., 0, :]
    dq = q[..., 1, :] - q[..., 0, :]
    den = dp[..., 0] * dp[..., 0] + dp[..., 1] * dp[..., 1]
    den = torch.where(den == 0, 1e-12, den)
    a = (dq[..., 0] * dp[..., 0] + dq[..., 1] * dp[..., 1]) / den
    b = (dq[..., 1] * dp[..., 0] - dq[..., 0] * dp[..., 1]) / den
    tx = q[..., 0, 0] - (a * p[..., 0, 0] - b * p[..., 0, 1])
    ty = q[..., 0, 1] - (b * p[..., 0, 0] + a * p[..., 0, 1])
    return _similarity_matrices(a, b, tx, ty)


def _solve_homography_4pt(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """p, q (..., 4, 2) -> (..., 3, 3) homography with h22 = 1 (8x8 solve)."""
    return LA.solve_homography_4pt(p, q)


def _apply_homography(H: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """H (..., 3, 3) against coordinates x, y broadcast to (..., P)."""
    h = [[H[..., i, j, None] for j in range(3)] for i in range(3)]
    w = h[2][0] * x + h[2][1] * y + h[2][2]
    w = torch.where(torch.abs(w) < 1e-12, 1e-12, w)
    u = (h[0][0] * x + h[0][1] * y + h[0][2]) / w
    v = (h[1][0] * x + h[1][1] * y + h[1][2]) / w
    return u, v


def _refit_similarity(p: torch.Tensor, q: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Weighted LS similarity per pair: p, q (B, P, 2), weight (B, P) -> (B, 3, 3)."""
    wsum = torch.clamp(weight.sum(-1), min=1e-6)[:, None]
    pm = (p * weight[..., None]).sum(1) / wsum
    qm = (q * weight[..., None]).sum(1) / wsum
    pc = (p - pm[:, None]) * weight[..., None]
    qc = (q - qm[:, None]) * weight[..., None]
    den = torch.clamp((pc * pc).sum((1, 2)), min=1e-12)
    a = (pc[..., 0] * qc[..., 0] + pc[..., 1] * qc[..., 1]).sum(1) / den
    b = (pc[..., 0] * qc[..., 1] - pc[..., 1] * qc[..., 0]).sum(1) / den
    tx = qm[:, 0] - (a * pm[:, 0] - b * pm[:, 1])
    ty = qm[:, 1] - (b * pm[:, 0] + a * pm[:, 1])
    return _similarity_matrices(a, b, tx, ty)


def _refit_homography(p: torch.Tensor, q: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Weighted normalized DLT per pair via the smallest eigenvector of
    A^T A: p, q (B, P, 2), weight (B, P) -> (B, 3, 3).

    A pair whose normal matrix is not finite (a NaN sample: its zero
    weight does not cancel it, as in the JAX package) gets NaN, which
    the caller's finiteness guard rejects; K10 only sees finite
    matrices (such a pair's is swapped for the identity).
    """
    B = p.shape[0]
    wsum = torch.clamp(weight.sum(-1), min=1e-6)                     # (B,)
    pm = (p * weight[..., None]).sum(1) / wsum[:, None]
    qm = (q * weight[..., None]).sum(1) / wsum[:, None]
    ps = torch.sqrt(torch.clamp((((p - pm[:, None]) ** 2).sum(-1) * weight).sum(-1) / wsum, min=1e-12))
    qs = torch.sqrt(torch.clamp((((q - qm[:, None]) ** 2).sum(-1) * weight).sum(-1) / wsum, min=1e-12))
    pn = (p - pm[:, None]) / ps[:, None, None]
    qn = (q - qm[:, None]) / qs[:, None, None]
    x, y = pn[..., 0], pn[..., 1]
    u, v = qn[..., 0], qn[..., 1]
    zeros = torch.zeros_like(x)
    ones = torch.ones_like(x)
    r1 = torch.stack([x, y, ones, zeros, zeros, zeros, -x * u, -y * u, -u], dim=-1)
    r2 = torch.stack([zeros, zeros, zeros, x, y, ones, -x * v, -y * v, -v], dim=-1)
    A = torch.cat([r1 * weight[..., None], r2 * weight[..., None]], dim=1)   # (B, 2P, 9)
    ata = A.transpose(1, 2) @ A
    bad = ~_all_finite(ata)
    eye9 = torch.eye(9, dtype=ata.dtype, device=ata.device)
    Hn = LA.smallest_eigvec(torch.where(bad[:, None, None], eye9, ata)).reshape(B, 3, 3)
    zero, one = torch.zeros_like(ps), torch.ones_like(ps)
    Tp = torch.stack([
        torch.stack([1.0 / ps, zero, -pm[:, 0] / ps], -1),
        torch.stack([zero, 1.0 / ps, -pm[:, 1] / ps], -1),
        torch.stack([zero, zero, one], -1),
    ], -2)
    Tq_inv = torch.stack([
        torch.stack([qs, zero, qm[:, 0]], -1),
        torch.stack([zero, qs, qm[:, 1]], -1),
        torch.stack([zero, zero, one], -1),
    ], -2)
    H = Tq_inv @ Hn @ Tp
    h22 = H[:, 2, 2]
    H = H / torch.where(torch.abs(h22) < 1e-12, 1e-12, h22)[:, None, None]
    return torch.where(bad[:, None, None], float("nan"), H)


def _all_finite(H: torch.Tensor) -> torch.Tensor:
    return torch.isfinite(H).all(dim=-1).all(dim=-1)


_MODELS = {
    "similarity": (2, _solve_similarity_2pt, _refit_similarity),
    "perspective": (4, _solve_homography_4pt, _refit_homography),
}


def draw_hypotheses(keys: torch.Tensor, p: torch.Tensor, q: torch.Tensor, valid: torch.Tensor,
                    model: str, n_hyp: int):
    """The K minimal-set hypotheses of every pair: (hyps (B, K, 3, 3) with
    the identity where rejected, hyp_ok (B, K)).  A hypothesis is kept
    when all its draws are valid (and, for a homography, distinct), the
    pair has at least m valid points and the solve is finite."""
    B, P = valid.shape
    m, solver, _ = _MODELS[model]
    dev = p.device
    vcount = valid.sum(1)                                          # (B,) int64

    # rank lookup: valid point of rank r -> its index; invalid points
    # scatter into the spare slot P, which is sliced off
    vi = valid.to(torch.int64)
    ranks = torch.cumsum(vi, 1) - vi
    slots = torch.where(valid, ranks, P)
    src = torch.arange(P, device=dev).expand(B, P)
    lookup = torch.zeros((B, P + 1), dtype=torch.int64, device=dev).scatter_(1, slots, src)[:, :P]

    u = prng.uniform(keys, (n_hyp, m))                              # (B, K, m)
    denom = torch.clamp(vcount, min=1)
    r = torch.minimum((u * denom.to(torch.float32)[:, None, None]).to(torch.int64),
                      (denom - 1)[:, None, None])
    idx = torch.gather(lookup, 1, r.reshape(B, -1)).reshape(B, n_hyp, m)
    ps = torch.gather(p, 1, idx.reshape(B, -1, 1).expand(-1, -1, 2)).reshape(B, n_hyp, m, 2)
    qs = torch.gather(q, 1, idx.reshape(B, -1, 1).expand(-1, -1, 2)).reshape(B, n_hyp, m, 2)
    draw_ok = torch.gather(valid, 1, idx.reshape(B, -1)).reshape(B, n_hyp, m).all(-1)
    draw_ok = draw_ok & (vcount >= m)[:, None]
    if model == "perspective":  # a repeated point: singular but for the ridge
        draw_ok = draw_ok & ((idx[..., :, None] == idx[..., None, :]).sum((-1, -2)) == m)

    hyps = solver(ps, qs)                                           # (B, K, 3, 3)
    hyp_ok = draw_ok & _all_finite(hyps)
    eye = torch.eye(3, dtype=torch.float32, device=dev)
    return torch.where(hyp_ok[..., None, None], hyps, eye), hyp_ok


def score_hypotheses(hyps: torch.Tensor, hyp_ok: torch.Tensor, p: torch.Tensor, q: torch.Tensor,
                     valid: torch.Tensor, thresh: float) -> torch.Tensor:
    """Inlier counts (B, K') of each pair's hypotheses on its first 2048
    points, in chunks of 64 (K' = K rounded down to whole chunks);
    rejected hypotheses count 0."""
    n_hyp = hyps.shape[1]
    thresh_sq = thresh * thresh
    n_score = min(p.shape[1], _N_SCORE)
    xs, ys = p[:, None, :n_score, 0], p[:, None, :n_score, 1]
    qx, qy = q[:, None, :n_score, 0], q[:, None, :n_score, 1]
    score_valid = valid[:, None, :n_score].to(torch.float32)
    n_chunks = max(1, n_hyp // _CHUNK)
    counts = []
    for c in range(n_chunks):
        u_, v_ = _apply_homography(hyps[:, c * _CHUNK:(c + 1) * _CHUNK], xs, ys)
        err = (u_ - qx) ** 2 + (v_ - qy) ** 2
        counts.append(((err < thresh_sq) * score_valid).sum(-1))
    return torch.cat(counts, 1) * hyp_ok[:, : n_chunks * _CHUNK].to(torch.float32)


def ransac_fit(keys: torch.Tensor, p: torch.Tensor, q: torch.Tensor, valid: torch.Tensor,
               model: str, n_hyp: int = DEFAULT_HYPOTHESES, thresh: float = SIM_THRESH):
    """RANSAC fit of ``model`` ('similarity' or 'perspective') for every pair.

    keys (B, 2) threefry keys; p, q (B, P, 2) float32; valid (B, P) bool.
    Returns (matrices (B, 3, 3) float32, inlier counts (B,), valid counts (B,)).
    """
    B = valid.shape[0]
    m, _, refit = _MODELS[model]
    hyps, hyp_ok = draw_hypotheses(keys, p, q, valid, model, n_hyp)
    counts = score_hypotheses(hyps, hyp_ok, p, q, valid, thresh)
    best = torch.argmax(counts, dim=1)                              # first maximum
    H_best = hyps[torch.arange(B, device=p.device), best]
    thresh_sq = thresh * thresh

    def refine(H):
        u_, v_ = _apply_homography(H, p[..., 0], p[..., 1])
        err = (u_ - q[..., 0]) ** 2 + (v_ - q[..., 1]) ** 2
        inlier = (err < thresh_sq) & valid
        H2 = refit(p, q, inlier.to(torch.float32))
        H2 = torch.where(_all_finite(H2)[:, None, None], H2, H)
        return H2, inlier

    H1, _ = refine(H_best)
    H2, inliers = refine(H1)
    n_in = inliers.sum(1)
    H2 = torch.where((n_in >= m)[:, None, None], H2, H_best)
    return H2, n_in, valid.sum(1)


def masked_median_shift(prev_pts: torch.Tensor, curr_pts: torch.Tensor,
                        valid: torch.Tensor) -> torch.Tensor:
    """np.median of the valid point shifts per pair -> (B, 2).

    The JAX package selects the two middle order statistics by a
    bisection on the float bits (TPU sorts are slow); a sort picks the
    same elements exactly.
    """
    shifts = curr_pts - prev_pts
    masked = torch.where(valid[..., None], shifts, 3.0e38)
    v = valid.sum(1)
    lo_k = torch.clamp(torch.div(v - 1, 2, rounding_mode="floor"), min=0)
    hi_k = torch.div(v, 2, rounding_mode="floor")
    srt = torch.sort(masked, dim=1).values                         # (B, P, 2)
    P = srt.shape[1]
    a = torch.gather(srt, 1, lo_k.clamp(max=P - 1)[:, None, None].expand(-1, 1, 2))[:, 0]
    b = torch.gather(srt, 1, hi_k.clamp(max=P - 1)[:, None, None].expand(-1, 1, 2))[:, 0]
    med = 0.5 * (a + b)
    return torch.where((v > 0)[:, None], med, 0.0)


def residuals(matrices: torch.Tensor, prev_pts: torch.Tensor, curr_pts: torch.Tensor,
              valid: torch.Tensor) -> torch.Tensor:
    """Mean |affine-projected prev - curr| per pair (the flow residual metric)."""
    m = matrices.to(torch.float32)
    px, py = prev_pts[..., 0], prev_pts[..., 1]
    proj_x = m[:, 0, 0, None] * px + m[:, 0, 1, None] * py + m[:, 0, 2, None]
    proj_y = m[:, 1, 0, None] * px + m[:, 1, 1, None] * py + m[:, 1, 2, None]
    w = valid.to(torch.float32)
    total = (torch.abs(proj_x - curr_pts[..., 0]) * w).sum(1) + (torch.abs(proj_y - curr_pts[..., 1]) * w).sum(1)
    count = torch.clamp(w.sum(1), min=1.0)
    return torch.where(valid.any(1), total / count, 0.0)


def _upload(x, dtype, dev: torch.device) -> torch.Tensor:
    """A host array (numpy, or read-only like a JAX array's view) as a
    tensor on ``dev``, from a copy the caller does not share."""
    return torch.from_numpy(np.array(x, dtype)).to(dev)


def _points(dev: torch.device, prev_pts, curr_pts, valid):
    """The host arrays as (p, q) float32 and a bool mask on ``dev``."""
    return _upload(prev_pts, np.float32, dev), _upload(curr_pts, np.float32, dev), _upload(valid, bool, dev)


def fit_model_batch(
    prev_pts: np.ndarray,
    curr_pts: np.ndarray,
    valid: np.ndarray,
    model: str,
    *,
    n_hypotheses: int = DEFAULT_HYPOTHESES,
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """RANSAC-fit every pair in the batch, pair i with the key
    ``fold_in(PRNGKey(seed), i)``.

    prev_pts/curr_pts: (B, P, 2) float32, valid: (B, P) bool.
    Returns (matrices (B,3,3) f32, inlier_counts (B,), valid_counts (B,)).
    """
    B = prev_pts.shape[0]
    if B == 0:
        return np.zeros((0, 3, 3), np.float32), np.zeros(0), np.zeros(0)
    dev = resolve_device(device)
    thresh = SIM_THRESH if model == "similarity" else PERSP_THRESH
    keys = prng.fold_in(prng.PRNGKey(seed, device=dev), torch.arange(B, device=dev))
    H, n_in, n_valid = ransac_fit(keys, *_points(dev, prev_pts, curr_pts, valid), model, int(n_hypotheses),
                                  float(thresh))
    out = fetch_packed({"H": H, "n_in": n_in, "n_valid": n_valid})
    return out["H"], out["n_in"].astype(np.int32), out["n_valid"].astype(np.int32)


def median_translation_batch(prev_pts, curr_pts, valid, device: str | torch.device = "cuda") -> np.ndarray:
    """Median point shift per pair -> (B, 3, 3) translation matrices;
    only the (B, 2) medians come back to the host."""
    B = prev_pts.shape[0]
    out = np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))
    if B == 0:
        return out
    med = masked_median_shift(*_points(resolve_device(device), prev_pts, curr_pts, valid)).cpu().numpy()
    out[:, 0, 2] = med[:, 0]
    out[:, 1, 2] = med[:, 1]
    return out


def reprojection_residuals(matrices, prev_pts, curr_pts, valid, device: str | torch.device = "cuda") -> np.ndarray:
    """Mean |affine-projected prev - curr| per pair (the flow residual
    metric: the affine part only, as the reference's), as float64."""
    if matrices.shape[0] == 0:
        return np.zeros(0)
    dev = resolve_device(device)
    m = _upload(matrices, np.float32, dev)
    return residuals(m, *_points(dev, prev_pts, curr_pts, valid)).cpu().numpy().astype(np.float64)
