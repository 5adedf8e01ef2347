"""Robust per-pair fits: perspective and similarity RANSAC, median translation.

Plain PyTorch, frozen from the port's plain path.  The hypotheses are
drawn with threefry-2x32 bits as ``jax.random.uniform(fold_in(
PRNGKey(seed), pair), (n_hyp, m))`` draws them (partitionable bits), over
the ranks of each pair's valid points; 512 minimal-set hypotheses (two
points for a similarity, four for a homography) are scored on the first
2048 points in chunks of 64, and the winner is refitted twice on its
inliers by weighted least squares (a similarity in closed form, a
homography by the normalized DLT).  A 4-point draw that repeats a point
is rejected, as the port rejects it.

Departures from the port's order, each with a sound variant in
``engine.VARIANTS``:

- the 4-point systems ``[x, y, 1, 0, 0, 0, -x u, -y u]``, ``[0, 0, 0, x,
  y, 1, -x v, -y v]`` plus ``1e-12 I`` are solved by the library's LU
  (``torch.linalg.solve_ex``), the port by its own partial-pivoting
  elimination (K11); ``linalg64`` solves them in float64;
- the DLT refit takes the smallest eigenvector of its 9x9 normal matrix
  from ``torch.linalg.eigh``, the port by Jacobi in the parallel order
  (K10); ``linalg64`` takes it in float64;
- the refits' sums over the points run in the library's order;
  ``reordered`` takes them over the points in reverse order.
"""

from __future__ import annotations

import torch

SIM_THRESH = 2.0
PERSP_THRESH = 2.5
HYPOTHESES = 512
RIDGE = 1e-12
_CHUNK = 64
_N_SCORE = 2048
_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
REVERSED_SUMS = False  # a sound variant: the refits' sums taken over the points in reverse order
LINALG64 = False       # a sound variant: the 4-point solves and the DLT eigenvector in float64


def _threefry(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, on int64 tensors holding uint32 words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + k0) & _MASK
    x1 = (x1 + k1) & _MASK
    for step in range(5):
        for r in _ROTATIONS[step % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _MASK) ^ x0
        x0 = (x0 + ks[(step + 1) % 3]) & _MASK
        x1 = (x1 + ks[(step + 2) % 3] + step + 1) & _MASK
    return x0, x1


def pair_keys(seed: int, n: int, device) -> torch.Tensor:
    """fold_in(PRNGKey(seed), i) for i < n: (n, 2) int64 keys."""
    key = torch.tensor([0, seed & _MASK], dtype=torch.int64, device=device)
    data = torch.arange(n, dtype=torch.int64, device=device)
    y0, y1 = _threefry(key[0], key[1], torch.zeros_like(data), data)
    return torch.stack([y0, y1], dim=-1)


def uniform(keys: torch.Tensor, count: int) -> torch.Tensor:
    """(B, count) float32 uniforms in [0, 1), one row a key."""
    lo = torch.arange(count, dtype=torch.int64, device=keys.device)
    y0, y1 = _threefry(keys[:, 0, None], keys[:, 1, None], torch.zeros_like(lo), lo)
    bits = ((y0 ^ y1) >> 9) | 0x3F800000
    return torch.clamp(bits.to(torch.int32).view(torch.float32) - 1.0, min=0.0)


def solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x with A x = b for a batch of systems by the library's LU, no error
    check (a singular system gives what the factorization gives); in
    float64 under ``LINALG64``."""
    dtype = torch.float64 if LINALG64 else torch.float32
    return torch.linalg.solve_ex(A.to(dtype), b.to(dtype))[0].to(torch.float32)


def _similarity(a, b, tx, ty) -> torch.Tensor:
    zero, one = torch.zeros_like(a), torch.ones_like(a)
    return torch.stack((torch.stack([a, -b, tx], -1), torch.stack([b, a, ty], -1),
                        torch.stack([zero, zero, one], -1)), -2)


def _solve_2pt(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    dp = p[..., 1, :] - p[..., 0, :]
    dq = q[..., 1, :] - q[..., 0, :]
    den = dp[..., 0] * dp[..., 0] + dp[..., 1] * dp[..., 1]
    den = torch.where(den == 0, 1e-12, den)
    a = (dq[..., 0] * dp[..., 0] + dq[..., 1] * dp[..., 1]) / den
    b = (dq[..., 1] * dp[..., 0] - dq[..., 0] * dp[..., 1]) / den
    return _similarity(a, b, q[..., 0, 0] - (a * p[..., 0, 0] - b * p[..., 0, 1]),
                       q[..., 0, 1] - (b * p[..., 0, 0] + a * p[..., 0, 1]))


def _solve_4pt(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(..., 4, 2) correspondences -> (..., 3, 3) homography with h22 = 1."""
    x, y, u, v = p[..., 0], p[..., 1], q[..., 0], q[..., 1]
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    rows_u = torch.stack([x, y, one, zero, zero, zero, -x * u, -y * u], dim=-1)
    rows_v = torch.stack([zero, zero, zero, x, y, one, -x * v, -y * v], dim=-1)
    A = torch.cat([rows_u, rows_v], dim=-2) + RIDGE * torch.eye(8, dtype=torch.float32, device=p.device)
    h = solve(A, torch.cat([u, v], dim=-1))
    return torch.cat([h, torch.ones_like(h[..., :1])], dim=-1).reshape(h.shape[:-1] + (3, 3))


def _apply(H: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    h = [[H[..., i, j, None] for j in range(3)] for i in range(3)]
    w = h[2][0] * x + h[2][1] * y + h[2][2]
    w = torch.where(torch.abs(w) < 1e-12, 1e-12, w)
    return (h[0][0] * x + h[0][1] * y + h[0][2]) / w, (h[1][0] * x + h[1][1] * y + h[1][2]) / w


def _refit_similarity(p: torch.Tensor, q: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    if REVERSED_SUMS:
        p, q, weight = p.flip(1), q.flip(1), weight.flip(1)
    wsum = torch.clamp(weight.sum(-1), min=1e-6)[:, None]
    pm = (p * weight[..., None]).sum(1) / wsum
    qm = (q * weight[..., None]).sum(1) / wsum
    pc = (p - pm[:, None]) * weight[..., None]
    qc = (q - qm[:, None]) * weight[..., None]
    den = torch.clamp((pc * pc).sum((1, 2)), min=1e-12)
    a = (pc[..., 0] * qc[..., 0] + pc[..., 1] * qc[..., 1]).sum(1) / den
    b = (pc[..., 0] * qc[..., 1] - pc[..., 1] * qc[..., 0]).sum(1) / den
    return _similarity(a, b, qm[:, 0] - (a * pm[:, 0] - b * pm[:, 1]), qm[:, 1] - (b * pm[:, 0] + a * pm[:, 1]))


def smallest_eigvec(mats: torch.Tensor) -> torch.Tensor:
    """The eigenvector of the smallest eigenvalue of each symmetric (B, 9, 9)
    matrix, by ``torch.linalg.eigh`` (float64 under ``LINALG64``)."""
    dtype = torch.float64 if LINALG64 else torch.float32
    return torch.linalg.eigh(mats.to(dtype))[1][..., 0].to(torch.float32)


def _refit_homography(p: torch.Tensor, q: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The weighted DLT on Hartley-normalized points: the smallest
    eigenvector of A^T A, denormalized and divided by h22; NaN for a pair
    whose normal matrix is not finite."""
    if REVERSED_SUMS:
        p, q, weight = p.flip(1), q.flip(1), weight.flip(1)
    B = p.shape[0]
    wsum = torch.clamp(weight.sum(-1), min=1e-6)
    pm = (p * weight[..., None]).sum(1) / wsum[:, None]
    qm = (q * weight[..., None]).sum(1) / wsum[:, None]
    ps = torch.sqrt(torch.clamp((((p - pm[:, None]) ** 2).sum(-1) * weight).sum(-1) / wsum, min=1e-12))
    qs = torch.sqrt(torch.clamp((((q - qm[:, None]) ** 2).sum(-1) * weight).sum(-1) / wsum, min=1e-12))
    pn = (p - pm[:, None]) / ps[:, None, None]
    qn = (q - qm[:, None]) / qs[:, None, None]
    x, y, u, v = pn[..., 0], pn[..., 1], qn[..., 0], qn[..., 1]
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    r1 = torch.stack([x, y, one, zero, zero, zero, -x * u, -y * u, -u], dim=-1)
    r2 = torch.stack([zero, zero, zero, x, y, one, -x * v, -y * v, -v], dim=-1)
    A = torch.cat([r1 * weight[..., None], r2 * weight[..., None]], dim=1)
    ata = A.transpose(1, 2) @ A
    bad = ~torch.isfinite(ata).all(dim=-1).all(dim=-1)
    eye9 = torch.eye(9, dtype=ata.dtype, device=ata.device)
    Hn = smallest_eigvec(torch.where(bad[:, None, None], eye9, ata)).reshape(B, 3, 3)
    zero, one = torch.zeros_like(ps), torch.ones_like(ps)
    Tp = torch.stack([torch.stack([1.0 / ps, zero, -pm[:, 0] / ps], -1),
                      torch.stack([zero, 1.0 / ps, -pm[:, 1] / ps], -1),
                      torch.stack([zero, zero, one], -1)], -2)
    Tq_inv = torch.stack([torch.stack([qs, zero, qm[:, 0]], -1),
                          torch.stack([zero, qs, qm[:, 1]], -1),
                          torch.stack([zero, zero, one], -1)], -2)
    H = Tq_inv @ Hn @ Tp
    h22 = H[:, 2, 2]
    H = H / torch.where(torch.abs(h22) < 1e-12, 1e-12, h22)[:, None, None]
    return torch.where(bad[:, None, None], float("nan"), H)


def _finite(H: torch.Tensor) -> torch.Tensor:
    return torch.isfinite(H).all(dim=-1).all(dim=-1)


MODELS = {"similarity": (2, _solve_2pt, _refit_similarity), "perspective": (4, _solve_4pt, _refit_homography)}


def ransac(keys, p, q, valid, model: str, thresh: float, n_hyp: int = HYPOTHESES):
    """(matrices (B, 3, 3), inlier counts (B,), valid counts (B,)) of ``model``."""
    m, solver, refit = MODELS[model]
    B, P = valid.shape
    dev = p.device
    vcount = valid.sum(1)
    vi = valid.to(torch.int64)
    slots = torch.where(valid, torch.cumsum(vi, 1) - vi, P)
    src = torch.arange(P, device=dev).expand(B, P)
    lookup = torch.zeros((B, P + 1), dtype=torch.int64, device=dev).scatter_(1, slots, src)[:, :P]
    u = uniform(keys, n_hyp * m).reshape(B, n_hyp, m)
    denom = torch.clamp(vcount, min=1)
    r = torch.minimum((u * denom.to(torch.float32)[:, None, None]).to(torch.int64), (denom - 1)[:, None, None])
    idx = torch.gather(lookup, 1, r.reshape(B, -1)).reshape(B, n_hyp, m)
    ps = torch.gather(p, 1, idx.reshape(B, -1, 1).expand(-1, -1, 2)).reshape(B, n_hyp, m, 2)
    qs = torch.gather(q, 1, idx.reshape(B, -1, 1).expand(-1, -1, 2)).reshape(B, n_hyp, m, 2)
    draw_ok = torch.gather(valid, 1, idx.reshape(B, -1)).reshape(B, n_hyp, m).all(-1) & (vcount >= m)[:, None]
    if m > 2:  # a repeated point leaves the system singular but for the ridge
        draw_ok = draw_ok & ((idx[..., :, None] == idx[..., None, :]).sum((-1, -2)) == m)
    hyps = solver(ps, qs)
    hyp_ok = draw_ok & _finite(hyps)
    hyps = torch.where(hyp_ok[..., None, None], hyps, torch.eye(3, dtype=torch.float32, device=dev))

    thresh_sq = thresh * thresh
    n_score = min(P, _N_SCORE)
    xs, ys = p[:, None, :n_score, 0], p[:, None, :n_score, 1]
    qx, qy = q[:, None, :n_score, 0], q[:, None, :n_score, 1]
    score_valid = valid[:, None, :n_score].to(torch.float32)
    n_chunks = max(1, n_hyp // _CHUNK)
    counts = []
    for c in range(n_chunks):
        u_, v_ = _apply(hyps[:, c * _CHUNK:(c + 1) * _CHUNK], xs, ys)
        counts.append((((u_ - qx) ** 2 + (v_ - qy) ** 2 < thresh_sq) * score_valid).sum(-1))
    counts = torch.cat(counts, 1) * hyp_ok[:, : n_chunks * _CHUNK].to(torch.float32)
    H_best = hyps[torch.arange(B, device=dev), torch.argmax(counts, dim=1)]

    def refine(H):
        u_, v_ = _apply(H, p[..., 0], p[..., 1])
        inlier = ((u_ - q[..., 0]) ** 2 + (v_ - q[..., 1]) ** 2 < thresh_sq) & valid
        H2 = refit(p, q, inlier.to(torch.float32))
        return torch.where(_finite(H2)[:, None, None], H2, H), inlier

    H1, _ = refine(H_best)
    H2, inliers = refine(H1)
    n_in = inliers.sum(1)
    return torch.where((n_in >= m)[:, None, None], H2, H_best), n_in, vcount


def median_shift(p: torch.Tensor, q: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The median of the valid point shifts per pair (mean of the two middle ones)."""
    masked = torch.where(valid[..., None], q - p, 3.0e38)
    v = valid.sum(1)
    lo_k = torch.clamp(torch.div(v - 1, 2, rounding_mode="floor"), min=0)
    hi_k = torch.div(v, 2, rounding_mode="floor")
    srt = torch.sort(masked, dim=1).values
    P = srt.shape[1]
    a = torch.gather(srt, 1, lo_k.clamp(max=P - 1)[:, None, None].expand(-1, 1, 2))[:, 0]
    b = torch.gather(srt, 1, hi_k.clamp(max=P - 1)[:, None, None].expand(-1, 1, 2))[:, 0]
    return torch.where((v > 0)[:, None], 0.5 * (a + b), 0.0)
