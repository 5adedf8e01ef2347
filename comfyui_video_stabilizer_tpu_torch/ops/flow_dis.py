"""DIS-style coarse-to-fine flow on the fit grid (PyTorch).

Counterpart of the fit path of ``comfyui_video_stabilizer_tpu/ops/
flow_dis.py`` (``dis_flow_fit`` -> ``_dis_flow_fit_fused`` ->
``_dis_levels`` with ``lk_mid=True``): a 2x area pyramid; per level a
global similarity pre-warp of J, the residual cost volume (K2, through
ops/cv_cuda.py), a dense one-step Lucas-Kanade blended in where the
residual is sub-pixel, confidence-weighted densification, and an IRLS
similarity (or, for perspective, homography) fit that seeds the next
level.  The result is the finest level's flow sampled on the
working-resolution fit grid.

The arithmetic follows the reference op for op, including the
separable masked-shift pre-warp (not exact bilinear) of
``_warp_similarity_device``, which honours the projective row.  The
homography fit's 8x8 normal equations are solved by K11 (ops/
linalg_cuda.py::solve8; its plain twin on the CPU), which a CUDA graph
can hold.

The dense API, :func:`dis_flow`, runs three
refine rounds at radius 3 (K2 at r = 3), then an LK-only polish at
level ``finest - 1`` and bilinear upsampling to the input resolution.
The TV-L1 tier (ops/tvl1.py) shares the pyramid, the pre-warp, the
fits and the upsampling.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

from ..utils import profiling as P
from ..utils.device import device_constant
from . import cv_cuda as CV
from . import linalg_cuda as LA
from .cv_cuda import edge_pad

FINEST_SCALE = 2   # stop refining at quarter resolution (DIS MEDIUM parity)
RADIUS = 3         # residual search window per level (px)
PATCH = 8          # aggregation window (DIS patch size)


# ---------------------------------------------------------------------------
# Pyramid
# ---------------------------------------------------------------------------

def _down2(stack: torch.Tensor) -> torch.Tensor:
    """2x area downsample of (B, H, W); odd trailing row/col dropped."""
    B, H, W = stack.shape
    h2, w2 = H // 2, W // 2
    return stack[:, : h2 * 2, : w2 * 2].reshape(B, h2, 2, w2, 2).mean(dim=(2, 4))


def build_pyramid(stack: torch.Tensor, coarsest: int) -> List[torch.Tensor]:
    pyr = [stack.to(torch.float32)]
    for _ in range(coarsest):
        pyr.append(_down2(pyr[-1]))
    return pyr


def num_levels(h: int, w: int, min_dim: int = 12) -> int:
    lvl = 0
    while min(h >> (lvl + 1), w >> (lvl + 1)) >= min_dim and lvl < 6:
        lvl += 1
    return lvl


def level_range(h: int, w: int, finest_scale: int = FINEST_SCALE) -> Tuple[int, int]:
    """(coarsest, finest): the pyramid levels DIS refines for h x w grays,
    down to ``finest_scale`` or the coarsest level, if that is coarser."""
    coarsest = num_levels(h, w)
    return coarsest, min(finest_scale, coarsest)


# ---------------------------------------------------------------------------
# Residual matching
# ---------------------------------------------------------------------------

def _make_agg(patch: int):
    """Patch box mean over the last two axes: edge pad (patch//2,
    patch//2 - 1), then the shift-add tree."""
    pt, pb = patch // 2, patch // 2 - 1

    def agg(x):
        return CV.tree(edge_pad(x, pt, pb, pt, pb), patch)

    return agg


def _weighted_flow(flow_x, flow_y, conf, agg):
    num = agg(torch.stack([flow_x * conf, flow_y * conf, conf], dim=1))
    den = torch.clamp(num[:, 2], min=1e-9)
    return torch.stack([num[:, 0] / den, num[:, 1] / den], dim=-1)


def _residual_flow(I: torch.Tensor, Jw: torch.Tensor, radius: int, patch: int,
                   lk_only: bool = False):
    """Sub-pixel residual flow between I and pre-warped Jw.

    Returns (flow (B, H, W, 2), conf (B, H, W)).  With ``lk_only`` the
    cost volume is skipped (the finest-level polish rounds).
    """
    agg = _make_agg(patch)
    In = I * (1.0 / 255.0)
    Jn = Jw * (1.0 / 255.0)
    if lk_only:
        return _lk_refine(In, Jn, agg)

    fx, fy, cmin = CV.cost_volume_subpixel(I, Jw, radius, patch)
    conf = 1.0 / (1.0 + cmin * 65025.0)
    (lk_x, lk_y), lk_mag, det_ok = _lk_step(In, Jn, agg)
    cv_mag = torch.sqrt(fx * fx + fy * fy)
    use_lk = (cv_mag <= 1.0) & (lk_mag <= 1.5) & det_ok
    flow_x = torch.where(use_lk, lk_x, fx)
    flow_y = torch.where(use_lk, lk_y, fy)
    return _weighted_flow(flow_x, flow_y, conf, agg), conf


def _lk_step(I, Jw, agg):
    """Dense one-step Gauss-Newton flow at u=0 (patch-aggregated)."""
    gx = 0.5 * (edge_pad(Jw, 0, 0, 0, 2)[:, :, 2:] - edge_pad(Jw, 0, 0, 2, 0)[:, :, :-2])
    gy = 0.5 * (edge_pad(Jw, 0, 2, 0, 0)[:, 2:, :] - edge_pad(Jw, 2, 0, 0, 0)[:, :-2, :])
    e = Jw - I
    fields = torch.stack([gx * gx, gx * gy, gy * gy, gx * e, gy * e], dim=1)
    a11, a12, a22, b1, b2 = agg(fields).unbind(1)
    det = a11 * a22 - a12 * a12
    det_ok = det > 1e-6
    inv_det = torch.where(det_ok, 1.0 / torch.where(det_ok, det, 1.0), 0.0)
    ux = -(a22 * b1 - a12 * b2) * inv_det
    uy = -(-a12 * b1 + a11 * b2) * inv_det
    lk_mag = torch.sqrt(ux * ux + uy * uy)
    return (torch.clamp(ux, -1.5, 1.5), torch.clamp(uy, -1.5, 1.5)), lk_mag, det_ok


def _lk_refine(I, Jw, agg):
    """LK-only refinement: flow + confidence without a cost volume."""
    (lk_x, lk_y), _, _ = _lk_step(I, Jw, agg)
    cmin = agg((I - Jw) ** 2)
    conf = 1.0 / (1.0 + cmin * 65025.0)
    return _weighted_flow(lk_x, lk_y, conf, agg), conf


# ---------------------------------------------------------------------------
# Global similarity fit (IRLS) of a dense flow field
# ---------------------------------------------------------------------------

def _approx_median(x: torch.Tensor, iters: int = 10) -> torch.Tensor:
    """Per-row approximate median of (B, P) by counting bisection.

    ``count / P < 0.5`` of the reference is tested as ``2 * count < P``,
    which is the same predicate for any P below 2**24 and needs no
    rounding.
    """
    P = x.shape[-1]
    lo = torch.zeros((x.shape[0], 1), dtype=x.dtype, device=x.device)
    hi = x.max(dim=-1, keepdim=True).values
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        go_up = 2 * (x <= mid).sum(dim=-1, keepdim=True) < P
        lo = torch.where(go_up, mid, lo)
        hi = torch.where(go_up, hi, mid)
    return 0.5 * (lo + hi)


def _pairwise_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in a fixed pairwise order: zero-padded to a
    power of two, then the upper half added to the lower until one column
    is left.

    The order depends on the axis length only, so a row sums the same
    whatever the batch and on every device.  A library reduction picks
    its split of the axis by the whole launch's shape (on the card, a
    (20, P, 2) sum over P adds in another order than a (79, P, 2) one), so
    a pair's fit would change with the number of pairs beside it: a
    sharded run (parallel/) could not equal an unsharded one."""
    n = x.shape[-1]
    width = 1 << max(0, (n - 1).bit_length())
    if width != n:
        x = F.pad(x, (0, width - n))
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def _fit_similarity_dense(flow: torch.Tensor, conf: torch.Tensor, stride: int) -> torch.Tensor:
    """Weighted IRLS similarity fit: flow (B,H,W,2) -> (B,3,3).  Every sum
    over the points is a :func:`_pairwise_sum`, so each pair's fit is
    independent of the batch."""
    B, H, W = flow.shape[:3]
    dev = flow.device
    ys = torch.arange(0, H, stride, dtype=torch.float32, device=dev)
    xs = torch.arange(0, W, stride, dtype=torch.float32, device=dev)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    p = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)        # (P, 2)
    f = flow[:, ::stride, ::stride].reshape(B, -1, 2)
    w0 = conf[:, ::stride, ::stride].reshape(B, -1)
    # discount a border band: the pre-warp edge-replicates there
    margin = float(min(8, min(H, W) // 8))
    inside = (
        (p[:, 0] >= margin) & (p[:, 0] <= W - 1 - margin)
        & (p[:, 1] >= margin) & (p[:, 1] <= H - 1 - margin)
    ).to(torch.float32)
    w0 = w0 * inside[None]
    q = p[None] + f                                                  # (B, P, 2)
    pd = p[None]

    def solve(weight):
        sums = _pairwise_sum(torch.stack(
            [weight, pd[..., 0] * weight, pd[..., 1] * weight, q[..., 0] * weight, q[..., 1] * weight], dim=1))
        wsum = torch.clamp(sums[:, 0:1], min=1e-6)
        pm = sums[:, 1:3] / wsum
        qm = sums[:, 3:5] / wsum
        pr = pd - pm[:, None]
        pc = pr * weight[..., None]
        qc = (q - qm[:, None]) * weight[..., None]
        sums = _pairwise_sum(torch.stack(
            [pc[..., 0] * pr[..., 0] + pc[..., 1] * pr[..., 1],
             pr[..., 0] * qc[..., 0] + pr[..., 1] * qc[..., 1],
             pr[..., 0] * qc[..., 1] - pr[..., 1] * qc[..., 0]], dim=1))
        den = torch.clamp(sums[:, 0], min=1e-9)
        a = sums[:, 1] / den
        b = sums[:, 2] / den
        tx = qm[:, 0] - (a * pm[:, 0] - b * pm[:, 1])
        ty = qm[:, 1] - (b * pm[:, 0] + a * pm[:, 1])
        return a, b, tx, ty

    weight = w0
    for _ in range(3):
        a, b, tx, ty = solve(weight)
        proj_x = a[:, None] * p[None, :, 0] - b[:, None] * p[None, :, 1] + tx[:, None]
        proj_y = b[:, None] * p[None, :, 0] + a[:, None] * p[None, :, 1] + ty[:, None]
        res = torch.sqrt((proj_x - q[..., 0]) ** 2 + (proj_y - q[..., 1]) ** 2)
        med = _approx_median(res)
        scale = torch.clamp(2.0 * med, min=0.5)
        weight = w0 * (1.0 / (1.0 + (res / scale) ** 2))            # Cauchy

    M = torch.zeros((B, 3, 3), dtype=torch.float32, device=dev)
    M[:, 0, 0] = a
    M[:, 0, 1] = -b
    M[:, 0, 2] = tx
    M[:, 1, 0] = b
    M[:, 1, 1] = a
    M[:, 1, 2] = ty
    M[:, 2, 2] = 1.0
    return M


def _fit_homography_dense(flow: torch.Tensor, conf: torch.Tensor, stride: int) -> torch.Tensor:
    """Weighted IRLS homography fit: flow (B,H,W,2) -> (B,3,3).

    DLT normal equations on coordinates centred at the frame middle and
    scaled to ~[-1, 1], three solves with Cauchy reweighting between
    them, as the similarity fit.
    """
    B, H, W = flow.shape[:3]
    dev = flow.device
    ys = torch.arange(0, H, stride, dtype=torch.float32, device=dev)
    xs = torch.arange(0, W, stride, dtype=torch.float32, device=dev)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    p = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)        # (P, 2)
    f = flow[:, ::stride, ::stride].reshape(B, -1, 2)
    w0 = conf[:, ::stride, ::stride].reshape(B, -1)
    margin = float(min(8, min(H, W) // 8))
    inside = (
        (p[:, 0] >= margin) & (p[:, 0] <= W - 1 - margin)
        & (p[:, 1] >= margin) & (p[:, 1] <= H - 1 - margin)
    ).to(torch.float32)
    w0 = w0 * inside[None]
    q = p[None] + f                                                  # (B, P, 2)

    cx, cy = (W - 1) * 0.5, (H - 1) * 0.5
    s = 2.0 / float(max(H, W))
    f32 = dict(dtype=torch.float32, device=dev)
    T = device_constant((s, 0.0, -s * cx, 0.0, s, -s * cy, 0.0, 0.0, 1.0), dev, shape=(3, 3))
    Tinv = device_constant((1.0 / s, 0.0, cx, 0.0, 1.0 / s, cy, 0.0, 0.0, 1.0), dev, shape=(3, 3))
    centre = device_constant((cx, cy), dev)
    pn = (p - centre) * s                                            # (P, 2)
    qn = (q - centre) * s                                            # (B, P, 2)
    px, py = pn[None, :, 0].expand(B, -1), pn[None, :, 1].expand(B, -1)
    ones, zeros = torch.ones_like(px), torch.zeros_like(px)
    eye8 = torch.eye(8, **f32)

    def solve(weight):
        qx, qy = qn[..., 0], qn[..., 1]
        # rows for x': [x, y, 1, 0, 0, 0, -x qx, -y qx] . p8 = qx
        A1 = torch.stack([px, py, ones, zeros, zeros, zeros, -px * qx, -py * qx], dim=-1)
        A2 = torch.stack([zeros, zeros, zeros, px, py, ones, -px * qy, -py * qy], dim=-1)
        A = torch.cat([A1, A2], dim=1)                               # (B, 2P, 8)
        rhs = torch.cat([qx, qy], dim=1)                             # (B, 2P)
        ww = torch.cat([weight, weight], dim=1)
        AtA = torch.einsum("bpi,bp,bpj->bij", A, ww, A) + 1e-6 * eye8
        Atb = torch.einsum("bpi,bp,bp->bi", A, ww, rhs)
        sol = LA.solve8(AtA, Atb)
        return torch.cat([sol, torch.ones((B, 1), **f32)], dim=1).reshape(B, 3, 3)

    def col(i, j):
        return Hn[:, i, j][:, None]

    weight = w0
    Hn = solve(weight)
    for _ in range(2):
        # residuals in normalized space -> pixel units via 1/s
        den = col(2, 0) * px + col(2, 1) * py + col(2, 2)
        den = torch.where(torch.abs(den) > 1e-9, den, 1.0)
        prx = (col(0, 0) * px + col(0, 1) * py + col(0, 2)) / den
        pry = (col(1, 0) * px + col(1, 1) * py + col(1, 2)) / den
        res = torch.sqrt((prx - qn[..., 0]) ** 2 + (pry - qn[..., 1]) ** 2) * (1.0 / s)
        med = _approx_median(res)
        scale = torch.clamp(2.0 * med, min=0.5)
        weight = w0 * (1.0 / (1.0 + (res / scale) ** 2))            # Cauchy
        Hn = solve(weight)

    M = Tinv @ Hn @ T
    return M / M[:, 2:3, 2:3]


# ---------------------------------------------------------------------------
# Matrix warps of the level grays and flows
# ---------------------------------------------------------------------------

def _safe_inv(x: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    ok = torch.abs(x) > eps
    return torch.where(ok, 1.0 / torch.where(ok, x, 1.0), 0.0)


def _normalized_coeffs(M: torch.Tensor):
    """(a, b, c, d, e, f, g, h) of M / M[2, 2], each (B, 1, 1)."""
    Mn = M * _safe_inv(M[:, 2, 2])[:, None, None]
    return tuple(Mn[:, i, j, None, None] for i, j in
                 ((0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (1, 2), (2, 0), (2, 1)))


def _compose_flow(M: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
    """Total flow u(x) = (M @ x - x) + r(x) for global M (B,3,3)."""
    B, H, W = residual.shape[:3]
    dev = residual.device
    xx = torch.arange(W, dtype=torch.float32, device=dev)[None, None, :]
    yy = torch.arange(H, dtype=torch.float32, device=dev)[None, :, None]
    a, nb, tx, b, d, ty, g, h = _normalized_coeffs(M)
    denom = 1.0 + g * xx + h * yy
    inv_d = _safe_inv(denom)
    qx = (a - 1.0) * xx + nb * yy + tx - (g * xx) * xx - (h * xx) * yy
    qy = b * xx + (d - 1.0) * yy + ty - (g * yy) * xx - (h * yy) * yy
    return residual + torch.stack([qx * inv_d, qy * inv_d], dim=-1)


def _warp_similarity_device(img: torch.Tensor, M: torch.Tensor, pad_t: int, radius: int) -> torch.Tensor:
    """Pre-warp of (B, H, W) by per-frame global matrices: out(x) = img(M @ x).

    The per-frame integer centre displacement (round half to even,
    clipped to +-pad_t) is removed by an edge-clamped shift; the
    remaining near-identity warp is sampled by a separable masked-shift
    window of +-radius: a vertical pass whose weights are evaluated at
    the SOURCE column, then a horizontal pass.  That is deliberately not
    exact bilinear; it is the reference's sampler.
    """
    B, H, W = img.shape
    dev = img.device
    Minv = M.to(torch.float32)
    cx, cy = (W - 1) * 0.5, (H - 1) * 0.5
    dc_inv = _safe_inv(Minv[:, 2, 0] * cx + Minv[:, 2, 1] * cy + Minv[:, 2, 2])
    dcx = (Minv[:, 0, 0] * cx + Minv[:, 0, 1] * cy + Minv[:, 0, 2]) * dc_inv - cx
    dcy = (Minv[:, 1, 0] * cx + Minv[:, 1, 1] * cy + Minv[:, 1, 2]) * dc_inv - cy
    tix = torch.clamp(torch.round(dcx), -pad_t, pad_t).to(torch.int64)
    tiy = torch.clamp(torch.round(dcy), -pad_t, pad_t).to(torch.int64)

    # edge pad by pad_t, then a (H, W) window at (pad_t + ty, pad_t + tx):
    # with |t| <= pad_t that is an index clamp of the unpadded frame
    rows = (torch.arange(H, device=dev)[None, :] + tiy[:, None]).clamp(0, H - 1)
    cols = (torch.arange(W, device=dev)[None, :] + tix[:, None]).clamp(0, W - 1)
    bidx = torch.arange(B, device=dev)[:, None, None]
    shifted = img[bidx, rows[:, :, None], cols[:, None, :]]

    xx = torch.arange(W, dtype=torch.float32, device=dev)[None, None, :]
    yy = torch.arange(H, dtype=torch.float32, device=dev)[None, :, None]
    a, bq, c, d, e, f, g, h = _normalized_coeffs(Minv)
    tixf = tix.to(torch.float32)[:, None, None]
    tiyf = tiy.to(torch.float32)[:, None, None]
    inv_d = _safe_inv(1.0 + g * xx + h * yy)
    qx = (a - 1.0) * xx + bq * yy + c - (g * xx) * xx - (h * xx) * yy
    lim = radius - 1.0
    dx = torch.clamp(qx * inv_d - tixf, -lim, lim)
    fdx = torch.floor(dx)
    fx = dx - fdx
    ex = fdx.to(torch.int32) + radius

    kx_n = 2 * radius + 1
    xxe = torch.arange(W + kx_n, dtype=torch.float32, device=dev)[None, None, :] - float(radius)
    yye = torch.arange(H, dtype=torch.float32, device=dev)[None, :, None]
    inv_de = _safe_inv(1.0 + g * xxe + h * yye)
    qy_e = d * xxe + (e - 1.0) * yye + f - (g * yye) * xxe - (h * yye) * yye
    dy_e = torch.clamp(qy_e * inv_de - tiyf, -lim, lim)
    fdy_e = torch.floor(dy_e)
    fy_e = dy_e - fdy_e
    ey_e = fdy_e.to(torch.int32) + radius

    spc = edge_pad(shifted, radius, radius + 1, radius, radius + 1)
    tmp_v = torch.zeros((B, H, W + kx_n), dtype=img.dtype, device=dev)
    for ky in range(kx_n):
        wy0 = torch.where(ey_e == ky, 1.0 - fy_e, 0.0) + torch.where(ey_e + 1 == ky, fy_e, 0.0)
        tmp_v = tmp_v + wy0 * spc[:, ky: ky + H, : W + kx_n]
    out = torch.zeros_like(img)
    for kx in range(kx_n):
        wx0 = torch.where(ex == kx, 1.0 - fx, 0.0) + torch.where(ex + 1 == kx, fx, 0.0)
        out = out + wx0 * tmp_v[:, :, kx: kx + W]
    return out


def _upsample2_flow(flow: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(B, h, w, 2) flow resized bilinearly to (B, out_h, out_w, 2), x 2.

    ``jax.image.resize(..., "bilinear")`` samples at half-pixel centres
    and renormalises the weights that fall off the edge, which equals
    ``F.interpolate``'s edge clamp; out_h may be 2h or 2h + 1.
    """
    up = F.interpolate(flow.permute(0, 3, 1, 2), size=(out_h, out_w), mode="bilinear",
                       align_corners=False)
    return up.permute(0, 2, 3, 1) * 2.0


def _scale_up_matrix(M: torch.Tensor) -> torch.Tensor:
    """diag(2, 2, 1) @ M @ diag(0.5, 0.5, 1), written out (exact)."""
    out = M.clone()
    out[:, :2, :] = out[:, :2, :] * 2.0
    out[:, :, :2] = out[:, :, :2] * 0.5
    return out


def _guarded_fit(flow_level, conf, M_prev, model):
    """Fit, but keep the previous estimate where the fit is insane.

    The homography fit must also keep its projective terms within
    2 / level size: more bends the pre-warp than camera motion between
    adjacent frames can.
    """
    hl, wl = flow_level.shape[1], flow_level.shape[2]
    if model == "homography":
        Mn = _fit_homography_dense(flow_level, conf, 4)
        proj_ok = (torch.abs(Mn[:, 2, 0]) < 2.0 / wl) & (torch.abs(Mn[:, 2, 1]) < 2.0 / hl)
    elif model == "similarity":
        Mn = _fit_similarity_dense(flow_level, conf, 4)
        proj_ok = torch.ones(Mn.shape[0], dtype=torch.bool, device=Mn.device)
    else:
        raise ValueError(f"Unknown pre-warp model {model!r}.")
    sc2 = Mn[:, 0, 0] ** 2 + Mn[:, 1, 0] ** 2
    ok = (
        torch.isfinite(Mn).all(dim=-1).all(dim=-1)
        & (sc2 > 0.25) & (sc2 < 4.0)
        & (torch.abs(Mn[:, 0, 2]) < wl) & (torch.abs(Mn[:, 1, 2]) < hl)
        & proj_ok
    )
    return torch.where(ok[:, None, None], Mn, M_prev)


def _dis_levels(pyr, radius, patch, refine_rounds, model="similarity", lk_mid=False):
    """Coarse-to-fine solve over ``pyr``, the level stacks from the finest
    level refined (``pyr[0]``) to the coarsest (no polish).

    Returns (flow_level, conf_level, M) with flow at ``pyr[0]``'s
    resolution in its pixel units.
    """
    top = len(pyr) - 1
    b = pyr[0].shape[0] - 1
    M = torch.eye(3, dtype=torch.float32, device=pyr[0].device).expand(b, 3, 3).contiguous()

    def refine_at(i, M, lk_only=False, level_radius=None):
        Jw = _warp_similarity_device(pyr[i][1:], M, pad_t=32, radius=4)
        residual, conf = _residual_flow(
            pyr[i][:-1], Jw, radius if level_radius is None else level_radius, patch, lk_only
        )
        return _compose_flow(M, residual), conf

    flow_level = conf_level = None
    for i in range(top, -1, -1):
        if i != top:
            M = _scale_up_matrix(M)
        mid = lk_mid and i != top and i > 0
        flow_level, conf_level = refine_at(i, M, lk_only=mid)
        if i > 0:
            M = _guarded_fit(flow_level, conf_level, M, model)

    # fit -> prewarp -> re-estimate rounds at the finest level
    for rnd in range(refine_rounds):
        M = _guarded_fit(flow_level, conf_level, M, model)
        lk_only = 0 < rnd < refine_rounds - 1
        level_radius = radius if rnd == 0 else min(radius, 2)
        flow_level, conf_level = refine_at(0, M, lk_only=lk_only, level_radius=level_radius)
    return flow_level, conf_level, M


def dis_flow(grays: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense flow for all adjacent pairs of a gray clip.

    grays (N, H, W) float 0..255 on any device.  Returns (flow (N-1, H,
    W, 2) float32 at the input resolution, conf (N-1, Hf, Wf) at the
    last solved level), on the grays' device.  The levels with three
    refine rounds and radius-3 cost volumes, then (the reference's
    ``_dis_flow_fused``) a half-res LK-only polish at level
    ``finest - 1`` behind the refitted pre-warp, the cost-volume flow
    kept where its residual exceeds 1 px, then the upsample chain.  The
    reference's defaults are fixed: FINEST_SCALE, RADIUS, PATCH and the
    similarity pre-warp.  No node calls it; the Flow estimator samples
    :func:`dis_flow_fit`.
    """
    n, h, w = grays.shape
    if n < 2:
        return (torch.zeros((0, h, w, 2), dtype=torch.float32, device=grays.device),
                torch.zeros((0, h, w), dtype=torch.float32, device=grays.device))
    coarsest, finest = level_range(h, w)
    with P.span("flow.dis.pyramid", grays.device):
        pyr = build_pyramid(grays, coarsest)
    flow_level, conf_level, M = _dis_levels(pyr[finest:], RADIUS, PATCH, 3)
    polish = finest - 1
    if polish >= 0:
        M = _scale_up_matrix(_guarded_fit(flow_level, conf_level, M, "similarity"))
        Il = pyr[polish][:-1]
        Jw = _warp_similarity_device(pyr[polish][1:], M, pad_t=32, radius=4)
        r_lk, conf_lk = _lk_refine(Il * (1.0 / 255.0), Jw * (1.0 / 255.0), _make_agg(PATCH))
        f_up = _upsample2_flow(flow_level, Il.shape[1], Il.shape[2])
        glob = _compose_flow(M, torch.zeros_like(f_up))
        r_cv = f_up - glob
        mag = torch.sqrt(r_cv[..., 0] * r_cv[..., 0] + r_cv[..., 1] * r_cv[..., 1])
        flow_level = glob + torch.where((mag <= 1.0)[..., None], r_lk, r_cv)
        conf_level = conf_lk
        finest = polish
    flow = flow_level
    for lvl in range(finest, 0, -1):
        flow = _upsample2_flow(flow, pyr[lvl - 1].shape[1], pyr[lvl - 1].shape[2])
    return flow, conf_level


def dis_flow_fit(
    grays: torch.Tensor,
    step: int,
    finest_scale: int = FINEST_SCALE,
    radius: int = RADIUS,
    patch: int = PATCH,
    model: str = "similarity",
) -> torch.Tensor:
    """Flow sampled on the ``step``-px working-res fit grid.

    grays (N, H, W) float 0..255 on any device.  Returns (N-1, P, 2)
    working-res px flow at the grid of models/flow._grid_points(h, w,
    step), on the grays' device.  Two refine rounds and radius-2 cost
    volumes, as the reference's fit path.  The halvings to the finest
    level refined (:func:`fit_level`), then :func:`dis_flow_fit_level`.
    """
    n, h, w = grays.shape
    if n < 2:
        return torch.zeros((0, 0, 2), dtype=torch.float32, device=grays.device)
    return dis_flow_fit_level(fit_level(grays, finest_scale), (h, w), step, finest_scale, radius, patch, model)


def fit_level(grays: torch.Tensor, finest_scale: int = FINEST_SCALE) -> torch.Tensor:
    """Level ``finest`` of the grays' pyramid, the finest that
    :func:`dis_flow_fit` refines (the float32 grays themselves at
    ``finest_scale`` 0), in span ``flow.dis.pyramid``."""
    _, finest = level_range(int(grays.shape[1]), int(grays.shape[2]), finest_scale)
    with P.span("flow.dis.pyramid", grays.device):
        return build_pyramid(grays, finest)[finest]


def dis_flow_fit_level(
    level: torch.Tensor,
    size: Tuple[int, int],
    step: int,
    finest_scale: int = FINEST_SCALE,
    radius: int = RADIUS,
    patch: int = PATCH,
    model: str = "similarity",
) -> torch.Tensor:
    """:func:`dis_flow_fit` from :func:`fit_level`'s level of (h, w)
    ``size`` grays: the coarser levels, the solve and the sampling, with
    no span and no host read (the fast path captures it as a CUDA
    graph, models/fastpath.py::_dis_from_graph)."""
    h, w = size
    coarsest, finest = level_range(h, w, finest_scale)
    pyr = build_pyramid(level, coarsest - finest)
    flow_level = _dis_levels(pyr, min(radius, 2), patch, 2, model, lk_mid=True)[0]
    scale = float(1 << finest)
    lh, lw = flow_level.shape[1], flow_level.shape[2]
    # level-grid indices of the working-res grid, clamped where
    # floor-halving dropped a trailing row/col
    ys_t = torch.clamp(torch.arange(0, h, step, device=level.device) // (1 << finest), max=lh - 1)
    xs_t = torch.clamp(torch.arange(0, w, step, device=level.device) // (1 << finest), max=lw - 1)
    sub = flow_level.index_select(1, ys_t).index_select(2, xs_t) * scale
    return sub.reshape(sub.shape[0], -1, 2)
