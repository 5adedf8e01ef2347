"""TV-L1 dense optical flow: the Flow estimator's middle tier (PyTorch).

Counterpart of ``comfyui_video_stabilizer_tpu/ops/tvl1.py``: the
Zach-Pock-Bischof primal-dual TV-L1 solver, coarse to fine on the DIS
op's 2x area pyramid.  Per level a global similarity pre-warp (the IRLS
fit of ops/flow_dis.py) absorbs the camera motion, so the solver's state
is a small residual field r and the total flow is global(M) + r.  The
data step is the per-pixel thresholding (prox of lambda|rho|), the
regulariser one Chambolle dual step per inner iteration.

The JAX package leaves this stage to XLA (it has no Pallas kernel), so
it is plain PyTorch here on every device.  It is a fallback tier: a
call is ``levels x N_WARPS x N_INNER`` inner steps of small elementwise
ops, tens of thousands of launches on the card.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from . import flow_dis as FD
from .cv_cuda import edge_pad

LAMBDA = 0.4    # data-term weight (cv2's 0.15 raised for a 480-step budget)
THETA = 0.3     # coupling parameter
TAU = 0.25      # dual ascent step (<= 1/4 for convergence)
N_WARPS = 8     # linearizations per level
N_INNER = 60    # Chambolle iterations per linearization
RADIUS = 8      # residual-field warp window: flow clipped to +-(RADIUS - 1)


def _warp_by_field(img: torch.Tensor, flow: torch.Tensor, radius: int = RADIUS) -> torch.Tensor:
    """Sample img at x + flow, the flow clipped to +-(radius - 1).

    img (B, H, W), flow (B, H, W, 2) -> (B, H, W).  The reference's
    separable sampler, read with gathers instead of its 2 (2R + 1)
    masked shift-adds: a vertical pass interpolates rows y + dy at
    every column s of an edge-clamped strip, with the dy of pixel
    (y, s); the horizontal pass interpolates that strip at x + dx.  So
    dy comes from (y, x + dx), not (y, x): equal to a 2-D bilinear
    sample where the flow is locally smooth, not at a motion boundary.
    """
    B, H, W = img.shape
    dev = img.device
    lim = radius - 1.0
    dx = torch.clamp(flow[..., 0], -lim, lim)
    dy = torch.clamp(flow[..., 1], -lim, lim)
    fdx = torch.floor(dx)
    fdy = torch.floor(dy)
    fx = dx - fdx
    fy = (dy - fdy).reshape(B, H * W)
    iy = fdy.to(torch.int64).reshape(B, H * W)
    src = img.reshape(B, H * W)
    rows = torch.arange(H, device=dev)[None, :, None]

    def strip(cols: torch.Tensor) -> torch.Tensor:
        """The vertical pass at strip columns ``cols`` (B, H, W)."""
        cs = cols.clamp(0, W - 1)
        at = (rows * W + cs).reshape(B, H * W)
        fy_s = torch.gather(fy, 1, at)
        r0 = rows + torch.gather(iy, 1, at).reshape(B, H, W)
        top = torch.gather(src, 1, (r0.clamp(0, H - 1) * W + cs).reshape(B, H * W))
        bottom = torch.gather(src, 1, ((r0 + 1).clamp(0, H - 1) * W + cs).reshape(B, H * W))
        return ((1.0 - fy_s) * top + fy_s * bottom).reshape(B, H, W)

    c0 = torch.arange(W, device=dev)[None, None, :] + fdx.to(torch.int64)
    return (1.0 - fx) * strip(c0) + fx * strip(c0 + 1)


def _forward_grad(u: torch.Tensor):
    """Forward differences with Neumann boundary (last row/col zero)."""
    gx = F.pad(u[:, :, 1:] - u[:, :, :-1], (0, 1))
    gy = F.pad(u[:, 1:, :] - u[:, :-1, :], (0, 0, 0, 1))
    return gx, gy


def _divergence(px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """Adjoint of _forward_grad (backward differences)."""
    dx = torch.cat([px[:, :, :1], px[:, :, 1:-1] - px[:, :, :-2], -px[:, :, -2:-1]], dim=2)
    dy = torch.cat([py[:, :1, :], py[:, 1:-1, :] - py[:, :-2, :], -py[:, -2:-1, :]], dim=1)
    return dx + dy


def _tvl1_level(I, Jw, r0, lam=LAMBDA, theta=THETA, tau=TAU, n_warps=N_WARPS, n_inner=N_INNER):
    """TV-L1 residual solve for one level: I, Jw (B, H, W) in 0..255,
    r0 (B, H, W, 2) the initial residual field.  Returns r (B, H, W, 2)."""
    u1 = r0[..., 0]
    u2 = r0[..., 1]
    p11 = torch.zeros_like(u1)
    p12 = torch.zeros_like(u1)
    p21 = torch.zeros_like(u1)
    p22 = torch.zeros_like(u1)
    lt_fac = lam * theta
    tt = tau / theta

    for _ in range(n_warps):
        Jr = _warp_by_field(Jw, torch.stack([u1, u2], dim=-1))
        gx = 0.5 * (edge_pad(Jr, 0, 0, 0, 2)[:, :, 2:] - edge_pad(Jr, 0, 0, 2, 0)[:, :, :-2])
        gy = 0.5 * (edge_pad(Jr, 0, 2, 0, 0)[:, 2:, :] - edge_pad(Jr, 2, 0, 0, 0)[:, :-2, :])
        grad2 = gx * gx + gy * gy
        # rho(u) = Jr + <g, u - u_lin> - I, linearized at the current u
        rho_c = Jr - gx * u1 - gy * u2 - I
        lt = lt_fac * grad2
        denom = torch.clamp(grad2, min=1e-9)
        # the data prox's two saturated branches do not change within a warp
        sat1_lo, sat1_hi = lt_fac * gx, -lt_fac * gx
        sat2_lo, sat2_hi = lt_fac * gy, -lt_fac * gy
        for _ in range(n_inner):
            # data prox: pointwise thresholding of rho
            rho = rho_c + gx * u1 + gy * u2
            lo = rho < -lt
            hi = rho > lt
            d1 = torch.where(lo, sat1_lo, torch.where(hi, sat1_hi, -rho * gx / denom))
            d2 = torch.where(lo, sat2_lo, torch.where(hi, sat2_hi, -rho * gy / denom))
            v1 = u1 + d1
            v2 = u2 + d2
            # TV prox: one Chambolle dual step per component
            u1 = v1 + theta * _divergence(p11, p12)
            u2 = v2 + theta * _divergence(p21, p22)
            g11, g12 = _forward_grad(u1)
            g21, g22 = _forward_grad(u2)
            n1 = torch.clamp(torch.sqrt(g11 * g11 + g12 * g12), min=1.0)
            n2 = torch.clamp(torch.sqrt(g21 * g21 + g22 * g22), min=1.0)
            p11 = (p11 + tt * g11) / n1
            p12 = (p12 + tt * g12) / n1
            p21 = (p21 + tt * g21) / n2
            p22 = (p22 + tt * g22) / n2
    return torch.stack([u1, u2], dim=-1)


def _conf(Jw, r, Il):
    err = torch.abs(_warp_by_field(Jw, r) - Il)
    return 1.0 / (1.0 + (10.0 / 255.0) * err)


def tvl1_flow(grays: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense TV-L1 flow for all adjacent pairs of a gray clip.

    grays (N, H, W) float 0..255 on any device (kept in 0..255: lambda
    is calibrated for it).  Returns (flow (N-1, H, W, 2), conf (N-1, H,
    W)) at the input resolution, on the grays' device, flow mapping
    I-coordinates to J-coordinates (cv2's sign).
    """
    n, h, w = grays.shape
    if n < 2:
        return (torch.zeros((0, h, w, 2), dtype=torch.float32, device=grays.device),
                torch.zeros((0, h, w), dtype=torch.float32, device=grays.device))
    grays = grays.to(torch.float32)
    b = n - 1
    coarsest = FD.num_levels(h, w)
    pyr = FD.build_pyramid(grays, coarsest)
    M = torch.eye(3, dtype=torch.float32, device=grays.device).expand(b, 3, 3).contiguous()
    r = None
    for lvl in range(coarsest, -1, -1):
        if lvl != coarsest:
            M = FD._scale_up_matrix(M)
        Il = pyr[lvl][:-1]
        Jw = FD._warp_similarity_device(pyr[lvl][1:], M, pad_t=32, radius=4)
        if r is None:
            r = torch.zeros(Il.shape + (2,), dtype=torch.float32, device=grays.device)
        else:
            r = FD._upsample2_flow(r, Il.shape[1], Il.shape[2])
        r = _tvl1_level(Il, Jw, r)
        flow_level = FD._compose_flow(M, r)
        if lvl > 0:
            # refit the pre-warp from the composed flow so the next
            # level's residual stays inside the bounded warp window
            M = FD._guarded_fit(flow_level, _conf(Jw, r, Il), M, "similarity")
            # the carried residual is relative to the refit pre-warp
            r = flow_level - FD._compose_flow(M, torch.zeros_like(r))
    return flow_level, _conf(Jw, r, Il)
