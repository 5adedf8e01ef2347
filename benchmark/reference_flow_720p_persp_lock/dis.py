"""DIS-style coarse-to-fine flow on the fit grid, homography pre-warp.

Plain PyTorch, frozen from the port's plain path: a 2x area pyramid; per
level a global pre-warp of J (a separable masked-shift sampler that
honours the projective row), the residual cost volume with a parabolic
sub-pixel argmin, a dense one-step Lucas-Kanade blended in where the
residual is sub-pixel, confidence-weighted densification, and an IRLS
homography fit on the 4-stride grid that seeds the next level, kept only
where it passes its guard (the perspective call's pre-warp; the default
reference's similarity fit is not here).  Returns the finest level's
flow sampled on the fit grid.  Every op runs on the grays' device.

Departures from the port's order, each with a sound variant in
``engine.VARIANTS``: the homography fit solves its 8x8 normal equations
by the library's LU (``torch.linalg.solve_ex``), the port by its own
partial-pivoting elimination (K11), ``linalg64`` in float64; the normal
equations' sums over the grid run in the library's order, ``reordered``
over the points in reverse order.
"""

from __future__ import annotations

from typing import List

import torch

from . import ransac

FINEST_SCALE = 2
RADIUS = 3
PATCH = 8
REVERSED_SUMS = False  # a sound variant: the fit's sums taken over the samples in reverse order


def edge_pad(x: torch.Tensor, top: int, bottom: int, left: int, right: int) -> torch.Tensor:
    """Replicate-pad the last two axes."""
    H, W = x.shape[-2:]
    ys = torch.arange(-top, H + bottom, device=x.device).clamp_(0, H - 1)
    xs = torch.arange(-left, W + right, device=x.device).clamp_(0, W - 1)
    return x.index_select(-2, ys).index_select(-1, xs)


def tree(xp: torch.Tensor, patch: int) -> torch.Tensor:
    """Overlapping box sums by a shift-add tree (rows, then columns), x1/patch^2."""
    step = 1
    while step < patch:
        xp = xp[..., :-step, :] + xp[..., step:, :]
        step *= 2
    step = 1
    while step < patch:
        xp = xp[..., :-step] + xp[..., step:]
        step *= 2
    return xp * (1.0 / (patch * patch))


def cost_volume(I: torch.Tensor, Jw: torch.Tensor, radius: int, patch: int):
    """(fx, fy, cmin): the patch-mean squared difference of every shift in
    [-r, r]^2 (dy-major, first minimum kept), then a parabola through the
    neighbouring costs, clipped to +-0.5 and zero at the window edge."""
    k = 2 * radius + 1
    pt, pb = patch // 2, patch // 2 - 1
    H, W = I.shape[-2:]
    hp, wp = H + patch - 1, W + patch - 1
    iagg = edge_pad(I.to(torch.float32), pt, pb, pt, pb) * (1.0 / 255.0)
    jbuf = edge_pad(Jw.to(torch.float32), pt + radius, pb + radius, pt + radius, pb + radius)
    costs = []
    cmin = best = None
    shifts = [(dy, dx) for dy in range(-radius, radius + 1) for dx in range(-radius, radius + 1)]
    for i, (dy, dx) in enumerate(shifts):
        sh = jbuf[..., dy + radius: dy + radius + hp, dx + radius: dx + radius + wp] * (1.0 / 255.0)
        d = iagg - sh
        c = tree(d * d, patch)
        costs.append(c)
        if cmin is None:
            cmin = c
            best = torch.zeros(c.shape, dtype=torch.int32, device=c.device)
        else:
            take = c < cmin
            cmin = torch.where(take, c, cmin)
            best = torch.where(take, i, best)
    by = torch.div(best, k, rounding_mode="floor")
    bx = best - by * k
    targets = (torch.clamp(by - 1, min=0) * k + bx, torch.clamp(by + 1, max=k - 1) * k + bx,
               by * k + torch.clamp(bx - 1, min=0), by * k + torch.clamp(bx + 1, max=k - 1))
    cy0, cy1, cx0, cx1 = (torch.zeros_like(cmin) for _ in range(4))
    for i, c in enumerate(costs):
        cy0 = torch.where(targets[0] == i, c, cy0)
        cy1 = torch.where(targets[1] == i, c, cy1)
        cx0 = torch.where(targets[2] == i, c, cx0)
        cx1 = torch.where(targets[3] == i, c, cx1)

    def parab(cm, cl, cr):
        denom = cl + cr - 2.0 * cm
        off = torch.where(denom > 1e-9, 0.5 * (cl - cr) / torch.clamp(denom, min=1e-9), 0.0)
        return torch.clamp(off, -0.5, 0.5)

    suby = torch.where((by == 0) | (by == k - 1), 0.0, parab(cmin, cy0, cy1))
    subx = torch.where((bx == 0) | (bx == k - 1), 0.0, parab(cmin, cx0, cx1))
    return bx.to(torch.float32) - radius + subx, by.to(torch.float32) - radius + suby, cmin


def build_pyramid(stack: torch.Tensor, coarsest: int) -> List[torch.Tensor]:
    pyr = [stack.to(torch.float32)]
    for _ in range(coarsest):
        B, H, W = pyr[-1].shape
        h2, w2 = H // 2, W // 2
        pyr.append(pyr[-1][:, : h2 * 2, : w2 * 2].reshape(B, h2, 2, w2, 2).mean(dim=(2, 4)))
    return pyr


def num_levels(h: int, w: int, min_dim: int = 12) -> int:
    lvl = 0
    while min(h >> (lvl + 1), w >> (lvl + 1)) >= min_dim and lvl < 6:
        lvl += 1
    return lvl


def _agg(patch: int):
    pt, pb = patch // 2, patch // 2 - 1
    return lambda x: tree(edge_pad(x, pt, pb, pt, pb), patch)


def _weighted_flow(flow_x, flow_y, conf, agg):
    num = agg(torch.stack([flow_x * conf, flow_y * conf, conf], dim=1))
    den = torch.clamp(num[:, 2], min=1e-9)
    return torch.stack([num[:, 0] / den, num[:, 1] / den], dim=-1)


def _lk_step(I, Jw, agg):
    """Dense one-step Gauss-Newton flow at u = 0 (patch-aggregated)."""
    gx = 0.5 * (edge_pad(Jw, 0, 0, 0, 2)[:, :, 2:] - edge_pad(Jw, 0, 0, 2, 0)[:, :, :-2])
    gy = 0.5 * (edge_pad(Jw, 0, 2, 0, 0)[:, 2:, :] - edge_pad(Jw, 2, 0, 0, 0)[:, :-2, :])
    e = Jw - I
    a11, a12, a22, b1, b2 = agg(torch.stack([gx * gx, gx * gy, gy * gy, gx * e, gy * e], dim=1)).unbind(1)
    det = a11 * a22 - a12 * a12
    det_ok = det > 1e-6
    inv_det = torch.where(det_ok, 1.0 / torch.where(det_ok, det, 1.0), 0.0)
    ux = -(a22 * b1 - a12 * b2) * inv_det
    uy = -(-a12 * b1 + a11 * b2) * inv_det
    lk_mag = torch.sqrt(ux * ux + uy * uy)
    return (torch.clamp(ux, -1.5, 1.5), torch.clamp(uy, -1.5, 1.5)), lk_mag, det_ok


def _residual_flow(I, Jw, radius, patch, lk_only=False):
    """Sub-pixel residual flow between I and the pre-warped Jw, and its confidence."""
    agg = _agg(patch)
    In = I * (1.0 / 255.0)
    Jn = Jw * (1.0 / 255.0)
    if lk_only:
        (lk_x, lk_y), _, _ = _lk_step(In, Jn, agg)
        conf = 1.0 / (1.0 + agg((In - Jn) ** 2) * 65025.0)
        return _weighted_flow(lk_x, lk_y, conf, agg), conf
    fx, fy, cmin = cost_volume(I, Jw, radius, patch)
    conf = 1.0 / (1.0 + cmin * 65025.0)
    (lk_x, lk_y), lk_mag, det_ok = _lk_step(In, Jn, agg)
    use_lk = (torch.sqrt(fx * fx + fy * fy) <= 1.0) & (lk_mag <= 1.5) & det_ok
    return _weighted_flow(torch.where(use_lk, lk_x, fx), torch.where(use_lk, lk_y, fy), conf, agg), conf


def _approx_median(x: torch.Tensor, iters: int = 10) -> torch.Tensor:
    """Per-row approximate median by counting bisection."""
    P = x.shape[-1]
    lo = torch.zeros((x.shape[0], 1), dtype=x.dtype, device=x.device)
    hi = x.max(dim=-1, keepdim=True).values
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        go_up = 2 * (x <= mid).sum(dim=-1, keepdim=True) < P
        lo = torch.where(go_up, mid, lo)
        hi = torch.where(go_up, hi, mid)
    return 0.5 * (lo + hi)


def _safe_inv(x: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    ok = torch.abs(x) > eps
    return torch.where(ok, 1.0 / torch.where(ok, x, 1.0), 0.0)


def _coeffs(M: torch.Tensor):
    """(a, b, c, d, e, f, g, h) of M / M[2, 2], each (B, 1, 1)."""
    Mn = M * _safe_inv(M[:, 2, 2])[:, None, None]
    return tuple(Mn[:, i, j, None, None] for i, j in
                 ((0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (1, 2), (2, 0), (2, 1)))


def _compose_flow(M: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
    """u(x) = (M @ x - x) + r(x)."""
    B, H, W = residual.shape[:3]
    dev = residual.device
    xx = torch.arange(W, dtype=torch.float32, device=dev)[None, None, :]
    yy = torch.arange(H, dtype=torch.float32, device=dev)[None, :, None]
    a, nb, tx, b, d, ty, g, h = _coeffs(M)
    inv_d = _safe_inv(1.0 + g * xx + h * yy)
    qx = (a - 1.0) * xx + nb * yy + tx - (g * xx) * xx - (h * xx) * yy
    qy = b * xx + (d - 1.0) * yy + ty - (g * yy) * xx - (h * yy) * yy
    return residual + torch.stack([qx * inv_d, qy * inv_d], dim=-1)


def _prewarp(img: torch.Tensor, M: torch.Tensor, pad_t: int, radius: int) -> torch.Tensor:
    """out(x) = img(M @ x): the integer centre shift by an edge clamp, the
    rest by a separable masked-shift window of +-radius (vertical weights
    taken at the source column, then horizontal)."""
    B, H, W = img.shape
    dev = img.device
    cx, cy = (W - 1) * 0.5, (H - 1) * 0.5
    dc_inv = _safe_inv(M[:, 2, 0] * cx + M[:, 2, 1] * cy + M[:, 2, 2])
    dcx = (M[:, 0, 0] * cx + M[:, 0, 1] * cy + M[:, 0, 2]) * dc_inv - cx
    dcy = (M[:, 1, 0] * cx + M[:, 1, 1] * cy + M[:, 1, 2]) * dc_inv - cy
    tix = torch.clamp(torch.round(dcx), -pad_t, pad_t).to(torch.int64)
    tiy = torch.clamp(torch.round(dcy), -pad_t, pad_t).to(torch.int64)
    rows = (torch.arange(H, device=dev)[None, :] + tiy[:, None]).clamp(0, H - 1)
    cols = (torch.arange(W, device=dev)[None, :] + tix[:, None]).clamp(0, W - 1)
    shifted = img[torch.arange(B, device=dev)[:, None, None], rows[:, :, None], cols[:, None, :]]

    xx = torch.arange(W, dtype=torch.float32, device=dev)[None, None, :]
    yy = torch.arange(H, dtype=torch.float32, device=dev)[None, :, None]
    a, bq, c, d, e, f, g, h = _coeffs(M)
    tixf = tix.to(torch.float32)[:, None, None]
    tiyf = tiy.to(torch.float32)[:, None, None]
    inv_d = _safe_inv(1.0 + g * xx + h * yy)
    qx = (a - 1.0) * xx + bq * yy + c - (g * xx) * xx - (h * xx) * yy
    lim = radius - 1.0
    dx = torch.clamp(qx * inv_d - tixf, -lim, lim)
    fdx = torch.floor(dx)
    fx = dx - fdx
    ex = fdx.to(torch.int32) + radius

    k = 2 * radius + 1
    xxe = torch.arange(W + k, dtype=torch.float32, device=dev)[None, None, :] - float(radius)
    inv_de = _safe_inv(1.0 + g * xxe + h * yy)
    qy_e = d * xxe + (e - 1.0) * yy + f - (g * yy) * xxe - (h * yy) * yy
    dy_e = torch.clamp(qy_e * inv_de - tiyf, -lim, lim)
    fdy_e = torch.floor(dy_e)
    fy_e = dy_e - fdy_e
    ey_e = fdy_e.to(torch.int32) + radius

    spc = edge_pad(shifted, radius, radius + 1, radius, radius + 1)
    tmp_v = torch.zeros((B, H, W + k), dtype=img.dtype, device=dev)
    for ky in range(k):
        wy = torch.where(ey_e == ky, 1.0 - fy_e, 0.0) + torch.where(ey_e + 1 == ky, fy_e, 0.0)
        tmp_v = tmp_v + wy * spc[:, ky: ky + H, : W + k]
    out = torch.zeros_like(img)
    for kx in range(k):
        wx = torch.where(ex == kx, 1.0 - fx, 0.0) + torch.where(ex + 1 == kx, fx, 0.0)
        out = out + wx * tmp_v[:, :, kx: kx + W]
    return out


def _scale_up(M: torch.Tensor) -> torch.Tensor:
    """diag(2, 2, 1) @ M @ diag(0.5, 0.5, 1)."""
    out = M.clone()
    out[:, :2, :] = out[:, :2, :] * 2.0
    out[:, :, :2] = out[:, :, :2] * 0.5
    return out


def _fit_homography(flow: torch.Tensor, conf: torch.Tensor, stride: int) -> torch.Tensor:
    """Weighted IRLS homography fit: flow (B,H,W,2) -> (B,3,3).  The DLT's
    normal equations on coordinates centred at the frame middle and scaled
    by 2 / max(H, W), ridged by 1e-6 I; three solves, Cauchy-reweighted
    between them by the residual in px over twice its approximate median
    (at least 0.5)."""
    B, H, W = flow.shape[:3]
    dev = flow.device
    ys = torch.arange(0, H, stride, dtype=torch.float32, device=dev)
    xs = torch.arange(0, W, stride, dtype=torch.float32, device=dev)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    p = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)
    f = flow[:, ::stride, ::stride].reshape(B, -1, 2)
    w0 = conf[:, ::stride, ::stride].reshape(B, -1)
    margin = float(min(8, min(H, W) // 8))
    inside = ((p[:, 0] >= margin) & (p[:, 0] <= W - 1 - margin)
              & (p[:, 1] >= margin) & (p[:, 1] <= H - 1 - margin)).to(torch.float32)
    w0 = w0 * inside[None]
    q = p[None] + f
    cx, cy = (W - 1) * 0.5, (H - 1) * 0.5
    s = 2.0 / float(max(H, W))
    T = torch.tensor([[s, 0.0, -s * cx], [0.0, s, -s * cy], [0.0, 0.0, 1.0]], dtype=torch.float32, device=dev)
    Tinv = torch.tensor([[1.0 / s, 0.0, cx], [0.0, 1.0 / s, cy], [0.0, 0.0, 1.0]], dtype=torch.float32,
                        device=dev)
    centre = torch.tensor([cx, cy], dtype=torch.float32, device=dev)
    pn = (p - centre) * s
    qn = (q - centre) * s
    px, py = pn[None, :, 0].expand(B, -1), pn[None, :, 1].expand(B, -1)
    ones, zeros = torch.ones_like(px), torch.zeros_like(px)
    eye8 = torch.eye(8, dtype=torch.float32, device=dev)

    def solve(weight):
        qx, qy = qn[..., 0], qn[..., 1]
        A = torch.cat([torch.stack([px, py, ones, zeros, zeros, zeros, -px * qx, -py * qx], dim=-1),
                       torch.stack([zeros, zeros, zeros, px, py, ones, -px * qy, -py * qy], dim=-1)], dim=1)
        rhs = torch.cat([qx, qy], dim=1)
        ww = torch.cat([weight, weight], dim=1)
        if REVERSED_SUMS:
            A, rhs, ww = A.flip(1), rhs.flip(1), ww.flip(1)
        AtA = torch.einsum("bpi,bp,bpj->bij", A, ww, A) + 1e-6 * eye8
        Atb = torch.einsum("bpi,bp,bp->bi", A, ww, rhs)
        sol = ransac.solve(AtA, Atb)
        return torch.cat([sol, torch.ones((B, 1), dtype=torch.float32, device=dev)], dim=1).reshape(B, 3, 3)

    weight = w0
    Hn = solve(weight)
    for _ in range(2):
        h = [[Hn[:, i, j, None] for j in range(3)] for i in range(3)]
        den = h[2][0] * px + h[2][1] * py + h[2][2]
        den = torch.where(torch.abs(den) > 1e-9, den, 1.0)
        prx = (h[0][0] * px + h[0][1] * py + h[0][2]) / den
        pry = (h[1][0] * px + h[1][1] * py + h[1][2]) / den
        res = torch.sqrt((prx - qn[..., 0]) ** 2 + (pry - qn[..., 1]) ** 2) * (1.0 / s)
        scale = torch.clamp(2.0 * _approx_median(res), min=0.5)
        weight = w0 * (1.0 / (1.0 + (res / scale) ** 2))
        Hn = solve(weight)
    M = Tinv @ Hn @ T
    return M / M[:, 2:3, 2:3]


def _guarded_fit(flow_level, conf, M_prev):
    """The homography fit, or the previous estimate where the fit is not
    sane: its projective terms must also stay under 2 / the level's size."""
    hl, wl = flow_level.shape[1], flow_level.shape[2]
    Mn = _fit_homography(flow_level, conf, 4)
    sc2 = Mn[:, 0, 0] ** 2 + Mn[:, 1, 0] ** 2
    ok = (torch.isfinite(Mn).all(dim=-1).all(dim=-1) & (sc2 > 0.25) & (sc2 < 4.0)
          & (torch.abs(Mn[:, 0, 2]) < wl) & (torch.abs(Mn[:, 1, 2]) < hl)
          & (torch.abs(Mn[:, 2, 0]) < 2.0 / wl) & (torch.abs(Mn[:, 2, 1]) < 2.0 / hl))
    return torch.where(ok[:, None, None], Mn, M_prev)


def dis_flow_fit(grays: torch.Tensor, step: int, finest_scale: int = FINEST_SCALE) -> torch.Tensor:
    """(N, H, W) 0..255 grays -> (N-1, P, 2) flow on the ``step``-px fit grid.

    Radius-2 cost volumes, an LK-only pass at the middle levels, two
    refine rounds at the finest level."""
    n, h, w = grays.shape
    grays = grays.to(torch.float32)
    coarsest = num_levels(h, w)
    finest = min(finest_scale, coarsest)
    radius = min(RADIUS, 2)
    b = n - 1
    pyr = build_pyramid(grays, coarsest)
    pyr_I = [lvl[:-1] for lvl in pyr]
    pyr_J = [lvl[1:] for lvl in pyr]
    M = torch.eye(3, dtype=torch.float32, device=grays.device).expand(b, 3, 3).contiguous()

    def refine_at(lvl, M, lk_only=False, level_radius=radius):
        Jw = _prewarp(pyr_J[lvl], M, pad_t=32, radius=4)
        residual, conf = _residual_flow(pyr_I[lvl], Jw, level_radius, PATCH, lk_only)
        return _compose_flow(M, residual), conf

    for lvl in range(coarsest, finest - 1, -1):
        if lvl != coarsest:
            M = _scale_up(M)
        flow_level, conf_level = refine_at(lvl, M, lk_only=lvl != coarsest and lvl > finest)
        if lvl > finest:
            M = _guarded_fit(flow_level, conf_level, M)
    for rnd in range(2):
        M = _guarded_fit(flow_level, conf_level, M)
        flow_level, conf_level = refine_at(finest, M, level_radius=radius if rnd == 0 else min(radius, 2))

    scale = float(1 << finest)
    lh, lw = flow_level.shape[1], flow_level.shape[2]
    ys_t = torch.clamp(torch.arange(0, h, step, device=grays.device) // (1 << finest), max=lh - 1)
    xs_t = torch.clamp(torch.arange(0, w, step, device=grays.device) // (1 << finest), max=lw - 1)
    sub = flow_level.index_select(1, ys_t).index_select(2, xs_t) * scale
    return sub.reshape(sub.shape[0], -1, 2)
