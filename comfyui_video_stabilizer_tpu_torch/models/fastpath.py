"""Zero-sync device front end of the stabilizers (crop, crop_and_pad, expand).

Counterpart of ``comfyui_video_stabilizer_tpu/models/fastpath.py``.  The
host engine (models/stabilize.py) fetches the robust fits, solves the
trajectory in float64 numpy and only then queues the warp: one host
round trip sits between estimation and warp.  Here sticky mode
selection, path integration, fps smoothing and the framing solve
(crop_and_pad recentre, expand union canvas, crop keep_fov search and
no-padding refine) run on the device in float32 as tensor programs, the
inverse warp coefficients are made there by a Newton-refined 3x3
inverse, and the padding stats and K1 are queued on those coefficients.
The one host fetch is the diagnostics bundle (matrices, paths,
confidences: a few KB), packed into one tensor and copied after K1 is
queued.  Nothing in between reads a device value on the host: no
``.item()``, no Python branch on a tensor, no index by a 0-d tensor and
no copy of a host constant.

Expand warps into a static bucket canvas, the input grown by
``EXPAND_MARGIN_PX`` a side, while the device computes the true canvas
and whether it fits; after the fetch both outputs are sliced to the
canvas (warped pixels do not depend on the canvas size).  A canvas past
the bucket re-warps once at its exact size from the fetched matrices,
the trajectory kept.  Crop runs the keep_fov search and the no-padding
refine on the device, then, after the fetch, makes its masks and warp
from the fetched matrices as the host engine does.

The crop_and_pad call with no progress observer runs its estimation
from one CUDA graph, the counterpart of the JAX package's fused
programs: for Flow (with integer pool factors, as the JAX package's
``_flow_fused_program`` requires) DIS, the fits, the trajectory and the
inverse coefficients; for Classic (``models/classic.py::
_tracks_and_fits``) GFTT with K4 and the corner greedy K7, the
pyramid, LK with K6 and K5, the fits, the trajectory and the inverse
coefficients.  Each is captured once per static shape and replayed on a
copy of the working-resolution grays.  The gray, the padding stats and
K1 run eagerly after the replay.  Perspective is captured too, as the
JAX package's fused programs hold it: its 8x8 solves (the 4-point
hypotheses and, for Flow, the IRLS pre-warp) run K11 and its DLT refit
K10 (ops/linalg_cuda.py), neither of which reads the card on the host.

A call with a progress observer (the ComfyUI node always passes one)
estimates in 32-pair chunks with a tick and an interrupt poll between
them (models/stabilize.py::chunked_pairs, the loop both estimators
share).  There each of Flow's chunks replays a CUDA graph of
``flow_dis.dis_flow_fit_level`` on the chunk's finest refined level
(:func:`_dis_from_graph`): every chunk has the same frames, so one
graph serves them all; the halvings to that level, the fits and the
trajectory program stay eager.  Classic's chunks run eagerly.
:func:`_route` makes the choice from what the call shows.

Under an active mesh (utils/meshinfo.py) the fast path runs by shard, the
counterpart of the JAX package's ``_mesh_defer`` branch: a clip the
mesh's data axis splits evenly (parallel/mesh.py::FrameShards) makes its
grays and runs its estimation on each shard (K2, or K4-K7), the fits and
the trajectory program run eagerly on the lead device, each shard's rows
of the warp coefficients go back to it, and the padding stats and K1 run
there.  The graph stays single-device: it is not used under a mesh of
more than one shard (a static choice).  An uneven clip (the "rows" or
"replicated" outcome) and crop framing defer to the host engine, as in
the JAX package.

The JAX package's speculative Pallas plan, its tile-span guard and
guard-miss re-warp, and its planar ingest exist for the Pallas warp's
host-planned tiles; K1 needs no plan, so they have no counterpart here.
The fast path runs by default on CUDA frames; the CPU keeps the host
engine unless ``CVST_FASTPATH=1`` (the tests force it).
"""

from __future__ import annotations

import logging
import os
import threading
from collections import OrderedDict
from typing import Dict, Tuple

import numpy as np
import torch

from ..ops import cuda_build
from ..ops import flow_dis as FD
from ..ops import morphology as M
from ..ops import ransac as RS
from ..ops import resize as R
from ..ops import warp as W
from ..parallel.mesh import FrameShards, frame_shards, lead_device
from ..utils import profiling as P
from ..utils.device import device_constant, fetch_packed
from ..utils.meshinfo import active_mesh, data_shards
from . import classic as CL
from . import flow as FL
from . import geometry as G

_MODE_IDX = {"perspective": 0, "similarity": 1, "translation": 2}
_MODE_NAMES = ("perspective", "similarity", "translation")

# expand bucket slack per side: covers the corrections real smoothing
# makes (tens of px); a larger canvas re-warps at its exact size
EXPAND_MARGIN_PX = 64

# captured estimation graphs kept at once (all of a device's share one
# memory pool: _FusedGraph.capture)
GRAPH_CACHE_SIZE = 4

# a capture that grows the shared pool by more than this rebuilds the pool
# with the new graph first (_rebuild_pool)
POOL_REBUILD_BYTES = 256 * 2**20

# since import: graphs captured for a new key, pool rebuilds, cached
# graphs recaptured by a rebuild (its new key's included) and replays
# (chip_smoke.py and the tests read them to show which calls ran from a
# graph)
GRAPH_STATS = {"captures": 0, "rebuilds": 0, "recaptures": 0, "replays": 0}

# calls each estimator's fast path served (returned a result rather than
# leaving the call to the host engine), and of those the ones that ran by
# shard on a mesh ("mesh"); chip_smoke.py checks them
SERVED = {"flow": 0, "classic": 0, "mesh": 0}

# a call's growth of these, on its root span (utils/profiling.py)
P.watch("fastpath.captures", lambda: GRAPH_STATS["captures"])
P.watch("fastpath.recaptures", lambda: GRAPH_STATS["recaptures"])
P.watch("fastpath.replays", lambda: GRAPH_STATS["replays"])
P.watch("fastpath.served", lambda: SERVED["flow"] + SERVED["classic"])

# set while a graph is captured, so offer() raises what the capture raised
_CAPTURE = threading.local()

_F32 = torch.float32

logger = logging.getLogger(__name__)


def offer(kind: str, *args, **kwargs):
    """The estimators' ``fast_path`` hooks: :func:`run_fast` of ``kind``
    ('flow' or 'classic').  None leaves the call to the host engine,
    whose backend chain then runs; so does any exception but a kernel's
    or the card's (models/flow.py::NOT_DEGRADED, re-raised), unless
    ``CVST_FASTPATH_STRICT`` is set.  An exception from a graph's capture
    is raised too: whether a call is captured is static, so a capture
    that fails is a fault, not a reason to fall back.  An interrupt from
    a progress tick is a BaseException and passes.  ``SERVED[kind]``
    counts the calls that returned a result."""
    _CAPTURE.open = False
    try:
        out = run_fast(kind, *args, **kwargs)
    except FL.NOT_DEGRADED:
        raise
    except Exception as exc:
        if _CAPTURE.open or os.environ.get("CVST_FASTPATH_STRICT"):
            raise
        logger.warning("%s fast path failed (%s: %s); using the host engine", kind, type(exc).__name__, exc)
        logger.debug("the %s fast path's failure", kind, exc_info=True)
        return None
    if out is not None:
        SERVED[kind] += 1
        if isinstance(out.get("stabilized"), FrameShards):
            SERVED["mesh"] += 1
    return out


def enabled(frames) -> bool:
    """The fast path runs for frames on a CUDA device; ``CVST_FASTPATH=0/1``
    overrides (the CPU tests force it on)."""
    flag = os.environ.get("CVST_FASTPATH")
    if flag is not None:
        return flag not in ("0", "false", "")
    device = frames.lead if isinstance(frames, FrameShards) else getattr(frames, "device", None)
    return device is not None and device.type == "cuda"


# ---------------------------------------------------------------------------
# Device math (float32 counterparts of models/geometry.py)
# ---------------------------------------------------------------------------

def _mm(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Batched 3x3 products x @ y, written out in float32 (k summed in
    order 0, 1, 2): no library GEMM, so no TF32 and one op order on
    every device."""
    return (x[..., :, 0, None] * y[..., None, 0, :] + x[..., :, 1, None] * y[..., None, 1, :]
            + x[..., :, 2, None] * y[..., None, 2, :])


def _eye(device) -> torch.Tensor:
    return torch.eye(3, dtype=_F32, device=device)


def _params_from_mats(m: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "translation":
        return torch.stack([m[:, 0, 2], m[:, 1, 2]], dim=-1)
    if mode == "similarity":
        a, c = m[:, 0, 0], m[:, 1, 0]
        scale = torch.sqrt(torch.clamp(a * a + c * c, min=1e-10))
        theta = torch.atan2(c, a)
        return torch.stack([m[:, 0, 2], m[:, 1, 2], theta, torch.log(scale)], dim=-1)
    return torch.stack(
        [m[:, 0, 0] - 1.0, m[:, 0, 1], m[:, 0, 2],
         m[:, 1, 0], m[:, 1, 1] - 1.0, m[:, 1, 2],
         m[:, 2, 0], m[:, 2, 1]],
        dim=-1,
    )


def _mats_from_params(p: torch.Tensor, mode: str) -> torch.Tensor:
    n = p.shape[0]
    one = torch.ones(n, dtype=_F32, device=p.device)
    zero = torch.zeros(n, dtype=_F32, device=p.device)
    if mode == "translation":
        rows = [one, zero, p[:, 0], zero, one, p[:, 1], zero, zero, one]
    elif mode == "similarity":
        s = torch.exp(p[:, 3])
        ct = s * torch.cos(p[:, 2])
        st = s * torch.sin(p[:, 2])
        rows = [ct, -st, p[:, 0], st, ct, p[:, 1], zero, zero, one]
    else:
        rows = [p[:, 0] + 1.0, p[:, 1], p[:, 2],
                p[:, 3], p[:, 4] + 1.0, p[:, 5],
                p[:, 6], p[:, 7], one]
    return torch.stack(rows, dim=-1).reshape(n, 3, 3)


def _inverse_coeffs_device(m: torch.Tensor) -> torch.Tensor:
    """(N, 3, 3) -> (N, 8) normalized inverse-map coefficients, float32.

    Adjugate / determinant start and one Newton step X <- X (2I - M X),
    the 3x3 products in full float32 (:func:`_mm`); the identity where
    |det| <= 1e-20; normalized by the (2, 2) entry where that is finite
    and non-zero."""
    a, b, c = m[:, 0, 0], m[:, 0, 1], m[:, 0, 2]
    d, e, f = m[:, 1, 0], m[:, 1, 1], m[:, 1, 2]
    g, h, i = m[:, 2, 0], m[:, 2, 1], m[:, 2, 2]
    adj = torch.stack(
        [e * i - f * h, c * h - b * i, b * f - c * e,
         f * g - d * i, a * i - c * g, c * d - a * f,
         d * h - e * g, b * g - a * h, a * e - b * d],
        dim=-1,
    ).reshape(-1, 3, 3)
    det = a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)
    ok = torch.abs(det) > 1e-20
    inv = adj / torch.where(ok, det, 1.0)[:, None, None]
    eye = _eye(m.device)
    inv = _mm(inv, 2.0 * eye - _mm(m, inv))
    inv = torch.where(ok[:, None, None], inv, eye)
    w0 = inv[:, 2, 2]
    w_ok = (w0 != 0.0) & torch.isfinite(w0)
    inv = inv / torch.where(w_ok, w0, 1.0)[:, None, None]
    return torch.stack(
        [inv[:, 0, 0], inv[:, 0, 1], inv[:, 0, 2],
         inv[:, 1, 0], inv[:, 1, 1], inv[:, 1, 2],
         inv[:, 2, 0], inv[:, 2, 1]],
        dim=-1,
    )


def _translation(tx: torch.Tensor, ty: torch.Tensor) -> torch.Tensor:
    """[[1, 0, tx], [0, 1, ty], [0, 0, 1]] from 0-d tensors."""
    one, zero = torch.ones_like(tx), torch.zeros_like(tx)
    return torch.stack([one, zero, tx, zero, one, ty, zero, zero, one]).reshape(3, 3)


def _scaled_crop(scale: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor) -> torch.Tensor:
    """[[s, 0, -s x0], [0, s, -s y0], [0, 0, 1]] from 0-d tensors."""
    one, zero = torch.ones_like(scale), torch.zeros_like(scale)
    return torch.stack([scale, zero, -scale * x0, zero, scale, -scale * y0, zero, zero, one]).reshape(3, 3)


def _corner_xy(mats: torch.Tensor, corners: torch.Tensor) -> torch.Tensor:
    """(N, 4, 2) images of the four (4, 3) homogeneous frame corners."""
    wc = (mats[:, None, :, 0] * corners[None, :, None, 0] + mats[:, None, :, 1] * corners[None, :, None, 1]
          + mats[:, None, :, 2] * corners[None, :, None, 2])
    return wc[..., :2] / wc[..., 2:3]


# ---------------------------------------------------------------------------
# The trajectory program: sticky select -> path -> framing -> coeffs
# ---------------------------------------------------------------------------

def _sticky_modes(acc3: torch.Tensor, deg: torch.Tensor, requested: int) -> torch.Tensor:
    """The sticky mode of every pair, (B,) int64, without a host loop.

    Pair i maps the active mode a to f_i(a): 2 when degenerate, else the
    first accepted mode at or below a (translation always is).  The
    chosen modes are the prefix compositions f_i o ... o f_0 applied to
    the requested mode, formed by doubling: log2(B) gathers of (B, 3)
    tables, exact since the maps take values in {0, 1, 2}."""
    b = acc3.shape[0]
    dev = acc3.device
    modes = torch.arange(3, device=dev)
    can = acc3[:, None, :] & (modes[None, None, :] >= modes[None, :, None])   # (B, active, mode)
    first = torch.where(can[..., 0], 0, torch.where(can[..., 1], 1, 2))
    g = torch.where(deg[:, None], 2, first)
    step = 1
    while step < b:
        prev = torch.cat([modes.expand(step, 3), g[:-step]], dim=0)
        g = torch.gather(g, 1, prev)
        step *= 2
    return g[:, requested]


def _traj_program(
    strength, keep_fov, *fits,
    kind, mode, want_persp, camera_lock, window, width, height, scale_xy,
    total_pts, framing="crop_and_pad", bucket=None,
):
    """Counterpart of the JAX package's ``_traj_program`` (its tile-span
    guard reduces to finiteness).  ``strength`` and ``keep_fov`` are 0-d
    float32 device tensors; ``fits`` are the device fits in the order of
    models/flow.py::_fused_fits_device (``kind`` 'flow') or the detected
    counts then models/classic.py::_fused_classic_fits_device ('classic').
    Returns a dict of device tensors."""
    it = iter(fits)
    if kind == "flow":
        gate_counts = next(it)  # valid grid samples per pair
        b = gate_counts.shape[0]
        deg = gate_counts < FL.MIN_VALID
        n_per_fit = 4  # (M, n_inliers, n_valid, residual)
    else:  # classic (sparse tracks); no residual diagnostics
        det_counts = next(it)
        gate_counts = next(it)  # surviving tracks per pair
        b = gate_counts.shape[0]
        deg = (det_counts < CL.MIN_FEATURES) | (gate_counts < CL.MIN_TRACKS)
        n_per_fit = 3
    dev = gate_counts.device
    eye = _eye(dev)
    zeros_b = torch.zeros(b, dtype=_F32, device=dev)

    def fit_block(thresh_pts, min_ratio):
        M, n_in, n_valid = next(it), next(it), next(it)
        r = next(it) if n_per_fit == 4 else zeros_b
        conf = torch.where(n_valid > 0, n_in / torch.clamp(n_valid, min=1), 0.0)
        ok = (torch.isfinite(M).all(dim=-1).all(dim=-1)
              & (gate_counts >= thresh_pts) & (conf >= min_ratio))
        return M.to(_F32), conf.to(_F32), r.to(_F32), ok

    if want_persp:
        Mp, cp, rp, op_ = fit_block(4, FL.PERSP_MIN_RATIO)
    else:
        Mp = eye.expand(b, 3, 3)
        cp = rp = zeros_b
        op_ = torch.zeros(b, dtype=torch.bool, device=dev)
    Ms, cs, rs, os_ = fit_block(3, FL.SIM_MIN_RATIO)
    Mt = next(it).to(_F32)
    if kind == "flow":
        rt = next(it).to(_F32)
        ct = gate_counts.to(_F32) / max(total_pts, 1)
    else:
        rt = zeros_b
        ct = torch.where(det_counts > 0, gate_counts.to(_F32) / torch.clamp(det_counts, min=1), 0.0)

    acc3 = torch.stack([op_, os_, torch.ones(b, dtype=torch.bool, device=dev)], dim=1)  # (B, 3)
    chosen = _sticky_modes(acc3, deg, _MODE_IDX[mode])

    def sel(v0, v1, v2):
        tail = (None,) * (v0.dim() - 1)
        return torch.where((chosen == 0)[(...,) + tail], v0,
                           torch.where((chosen == 1)[(...,) + tail], v1, v2))

    Msel = torch.where(deg[:, None, None], eye, sel(Mp, Ms, Mt))
    conf = torch.where(deg, 0.0, sel(cp, cs, ct))
    resid = torch.where(deg, 0.0, sel(rp, rs, rt))

    # working-res transforms to full res: S^-1 M S
    sx, sy = scale_xy
    if (sx, sy) != (1.0, 1.0):
        s_vec = device_constant((sx, sy, 1.0), dev)
        Mf = (Msel * s_vec[None, None, :]) / s_vec[None, :, None]
    else:
        Mf = Msel

    # path integration + fps-aware smoothing (float32 on the device)
    P = _params_from_mats(Mf, mode)
    d_dim = P.shape[1]
    zero_row = torch.zeros((1, d_dim), dtype=_F32, device=dev)
    path = torch.cat([zero_row, torch.cumsum(P, dim=0)], dim=0)
    n = b + 1
    if camera_lock:
        target = torch.zeros_like(path)
    elif window >= 3 and n > 2:
        pad = window // 2
        padded = torch.cat([path[:1].expand(pad, d_dim), path, path[-1:].expand(pad, d_dim)], dim=0)
        cs_ = torch.cumsum(padded, dim=0)
        sums = cs_[window - 1:] - torch.cat([zero_row, cs_[: n - 1 + 2 * pad - window + 1]], dim=0)
        smoothed = sums * (1.0 / window)
        target = path + strength * (smoothed - path)
    else:
        target = path
    diffs = target - path
    apply_m = _mats_from_params(diffs, mode)
    corners = device_constant((0.0, 0.0, 1.0, float(width), 0.0, 1.0,
                               0.0, float(height), 1.0, float(width), float(height), 1.0), dev, shape=(4, 3))

    if framing == "crop":
        # keep_fov solver (models/framing.py::compute_crop_with_keep_fov_
        # parametric): 18 bisection steps over the stabilization scale.
        # The midpoints are dyadic, exact in float32, so the search visits
        # the host's scales; only the ratio tests round in float32.
        eps = 1e-4
        margin_px = max(0.5, 0.02 * max(width, height))

        def eval_candidate(scale):
            mats = _mats_from_params(diffs * scale, mode)
            cxy = _corner_xy(mats, corners)
            mn = cxy.amin(dim=1)
            mx = cxy.amax(dim=1)
            x0, y0 = mn[:, 0].amax(), mn[:, 1].amax()
            x1, y1 = mx[:, 0].amin(), mx[:, 1].amin()
            safe_w = torch.clamp(x1 - x0, min=0.0)
            safe_h = torch.clamp(y1 - y0, min=0.0)
            margin = torch.clamp(torch.minimum(safe_w * 0.25, safe_h * 0.25), max=margin_px)
            sx0, sy0 = x0 + margin, y0 + margin
            sw = torch.clamp(safe_w - 2.0 * margin, min=0.0)
            sh = torch.clamp(safe_h - 2.0 * margin, min=0.0)
            overlap = (sw > 0.0) & (sh > 0.0)
            ratio = torch.where(overlap, torch.clamp(torch.minimum(sw / width, sh / height), max=1.0), 0.0)
            return ratio, overlap, (mats, mn, mx, sx0, sy0, sw, sh)

        zero = torch.zeros((), dtype=_F32, device=dev)
        one = torch.ones((), dtype=_F32, device=dev)
        ratio_full, overlap_full, _ = eval_candidate(one)
        low, high, best = zero, one, zero
        found = torch.zeros((), dtype=torch.bool, device=dev)
        for _ in range(18):
            mid = 0.5 * (low + high)
            ok = eval_candidate(mid)[0] >= keep_fov - eps
            low, high = torch.where(ok, mid, low), torch.where(ok, high, mid)
            found, best = found | ok, torch.where(ok, mid, best)
        # the host's order: disabled (keep_fov <= eps) -> met at full
        # scale -> best search candidate -> failed (scale 0)
        s_star = torch.where(
            keep_fov <= eps,
            torch.where(overlap_full, one, zero),
            torch.where(ratio_full >= keep_fov - eps, one, torch.where(found, best, zero)),
        )
        _, overlap_c, (mats_c, mn_c, mx_c, sx0, sy0, sw, sh) = eval_candidate(s_star)
        crop_ratio = torch.clamp(torch.minimum(sw / width, sh / height), max=1.0)
        crop_w = width * crop_ratio
        crop_h = height * crop_ratio
        cx0 = sx0 + (sw - crop_w) * 0.5
        cy0 = sy0 + (sh - crop_h) * 0.5
        cscale = torch.where(overlap_c, width / torch.clamp(crop_w, min=1e-6), 1.0)
        cmat = torch.where(overlap_c, _scaled_crop(cscale, cx0, cy0), eye)
        final = _mm(cmat, mats_c)
        finite = torch.isfinite(final).all()
        return dict(
            chosen=chosen, conf=conf, resid=resid, matrices=Mf,
            path=path, target=target, diffs=diffs,
            apply=mats_c, final=final, coeffs=_inverse_coeffs_device(final),
            mins=mn_c, maxs=mx_c, offsets=torch.zeros(2, dtype=_F32, device=dev),
            degenerate=deg, fit=finite,
            out_wh=device_constant((width, height), dev, torch.int32),
            crop_ratio_full=ratio_full, crop_overlap_full=overlap_full,
            crop_found=found, crop_best_scale=best, crop_s_star=s_star,
        )

    xy = _corner_xy(apply_m, corners)
    mins = xy.amin(dim=1)
    maxs = xy.amax(dim=1)
    if framing == "expand":
        # union canvas: a global translation puts the min corner at (0, 0)
        # (models/geometry.py::prepare_expand_transform)
        ex0, ey0 = mins[:, 0].amin(), mins[:, 1].amin()
        ex1, ey1 = maxs[:, 0].amax(), maxs[:, 1].amax()
        out_w = torch.clamp(torch.ceil(ex1 - ex0), min=1.0).to(torch.int32)
        out_h = torch.clamp(torch.ceil(ey1 - ey0), min=1.0).to(torch.int32)
        trans = _translation(-ex0, -ey0)
        offsets = torch.stack([-ex0, -ey0])
        out_wh = torch.stack([out_w, out_h])
        bucket_h, bucket_w = bucket
        fit = (out_w <= bucket_w) & (out_h <= bucket_h)
    else:  # crop_and_pad recentre
        x0, y0 = mins[:, 0].amax(), mins[:, 1].amax()
        x1, y1 = maxs[:, 0].amin(), maxs[:, 1].amin()
        off_x = 0.5 * width - 0.5 * (x0 + x1)
        off_y = 0.5 * height - 0.5 * (y0 + y1)
        trans = _translation(off_x, off_y)
        offsets = torch.stack([off_x, off_y])
        out_wh = device_constant((width, height), dev, torch.int32)
        fit = torch.ones((), dtype=torch.bool, device=dev)
    final = _mm(trans, apply_m)
    finite = torch.isfinite(final).all()
    return dict(
        chosen=chosen, conf=conf, resid=resid, matrices=Mf,
        path=path, target=target, diffs=diffs,
        apply=apply_m, final=final, coeffs=_inverse_coeffs_device(final),
        mins=mins, maxs=maxs, offsets=offsets,
        degenerate=deg, fit=fit & finite, out_wh=out_wh,
    )


# ---------------------------------------------------------------------------
# Crop framing: mask finalize + no-padding refine on the device
# ---------------------------------------------------------------------------

def _round_half_even_half(v: torch.Tensor) -> torch.Tensor:
    """round(v / 2), ties to even, of a non-negative integer tensor: Python's
    round((height - crop_h) * 0.5) in ops/morphology.py::
    largest_aspect_ratio_rectangle (the .5 ties are exact)."""
    half = torch.div(v, 2, rounding_mode="floor")
    return torch.where(v % 2 == 0, half, torch.where(half % 2 == 0, half, half + 1))


def _crop_w_table(width: int, height: int, device) -> torch.Tensor:
    """ceil(aspect * crop_h) for crop_h = 0..height, int64 on ``device``, in
    the host's float64 expression (ops/morphology.py); IEEE float64 rounds
    the product alike on every device."""
    aspect = float(np.float64(width) / np.float64(height))
    h = torch.arange(height + 1, dtype=torch.float64, device=device)
    return torch.ceil(aspect * h).to(torch.int64)


def _crop_search_iters(width: int, height: int) -> Tuple[int, int]:
    """(first upper bound of the crop height, bisection steps that cover it)."""
    hi0 = min(height, int(np.floor(width / (np.float64(width) / np.float64(height)))))
    return hi0, max(1, hi0).bit_length() + 1


def _take(t: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """t.reshape(-1)[index] for a 0-d int64 device ``index``, as a 0-d
    tensor, with no host read (a 0-d tensor used as an index is read on
    the host)."""
    return t.reshape(-1).index_select(0, index.reshape(1))[0]


def _crop_finalize(final_pre: torch.Tensor, crop_w_table: torch.Tensor, *, width: int, height: int,
                   iters: int) -> Dict[str, torch.Tensor]:
    """Counterpart of the JAX package's ``_crop_finalize``:
    models/framing.py's finalize_with_masks and refine_no_padding_crop on
    the device.  One pass of nearest coverage (per mask chunk of frames)
    feeds both the per-frame 3x3-close bounding-box ratio (met / clamped)
    and the all-frames AND mask, whose integral image drives a fixed
    ``iters``-step bisection over the crop height.  The rectangle test
    reads the integral image at shifted indices directly, in int64, with
    the host's row-major first match and half-to-even centring."""
    dev = final_pre.device
    coeffs_pre = _inverse_coeffs_device(final_pre)
    n = coeffs_pre.shape[0]
    big = np.iinfo(np.int32).max
    y_idx = torch.arange(height, device=dev)[None, :]
    x_idx = torch.arange(width, device=dev)[None, :]
    common = torch.ones((height, width), dtype=_F32, device=dev)
    ratios = []
    chunk = W._mask_chunk(height, width)
    for s in range(0, n, chunk):
        cover = W._inside(coeffs_pre[s:s + chunk], height, width, height, width).to(_F32)
        # keep_fov ratio_final: per-frame 3x3 close -> bounding-box ratio
        closed = M.erode(M.dilate(cover, 1), 1) > 0.5
        rows_any, cols_any = closed.any(dim=2), closed.any(dim=1)
        y_min = torch.where(rows_any, y_idx, big).amin(dim=1)
        y_max = torch.where(rows_any, y_idx, -1).amax(dim=1)
        x_min = torch.where(cols_any, x_idx, big).amin(dim=1)
        x_max = torch.where(cols_any, x_idx, -1).amax(dim=1)
        ratios.append(torch.where(
            x_max >= 0,
            torch.minimum(torch.clamp((x_max - x_min + 1).to(_F32), min=1.0) / width,
                          torch.clamp((y_max - y_min + 1).to(_F32), min=1.0) / height),
            0.0,
        ))
        common = torch.minimum(common, cover.amin(dim=0))
    ratio_final = torch.cat(ratios).amin()

    # no-padding refine: AND mask, erode 1, integral image, rectangle search
    cnt = (M.erode(common[None], 1)[0] > 0.5).to(torch.int64)
    integral = torch.zeros((height + 1, width + 1), dtype=torch.int64, device=dev)
    integral[1:, 1:] = torch.cumsum(torch.cumsum(cnt, dim=0), dim=1)
    yy = torch.arange(height + 1, device=dev)[:, None]
    xx = torch.arange(width + 1, device=dev)[None, :]
    flat_ids = torch.arange((height + 1) * (width + 1), device=dev)
    n_flat = (height + 1) * (width + 1)

    def scalar(v):
        return torch.full((), v, dtype=torch.int64, device=dev)

    hi0, _ = _crop_search_iters(width, height)
    low, high = scalar(1), scalar(hi0)
    bx = by = bh = scalar(0)
    refine_ok = torch.zeros((), dtype=torch.bool, device=dev)
    for _ in range(iters):
        cont = low <= high
        ch = torch.div(low + high, 2, rounding_mode="floor")
        cw = _take(crop_w_table, torch.clamp(ch, 0, height))
        size_ok = (ch >= 1) & (ch <= height) & (cw <= width) & (cw >= 1)
        ys = torch.clamp(yy + ch, 0, height)
        xs = torch.clamp(xx + cw, 0, width)
        sums = integral[ys, xs] - integral[ys, xx] - integral[yy, xs] + integral
        in_range = (yy <= height - ch) & (xx <= width - cw)
        matches = in_range & (sums == ch * cw) & size_ok
        any_fit = matches.any()
        # centred placement preferred; else the first match in row-major order
        y0c = torch.clamp(_round_half_even_half(height - ch), 0, height)
        x0c = torch.clamp(_round_half_even_half(width - cw), 0, width)
        centered = _take(matches, y0c * (width + 1) + x0c)
        first = torch.where(matches.reshape(-1), flat_ids, n_flat).amin()
        x0 = torch.where(centered, x0c, first % (width + 1))
        y0 = torch.where(centered, y0c, torch.div(first, width + 1, rounding_mode="floor"))
        ok = cont & any_fit
        low = torch.where(ok, ch + 1, low)
        high = torch.where(cont & ~any_fit, ch - 1, high)
        refine_ok = refine_ok | ok
        bx, by, bh = torch.where(ok, x0, bx), torch.where(ok, y0, by), torch.where(ok, ch, bh)

    # crop matrix: scale = width / (aspect * crop_h) == height / crop_h
    cscale = torch.where(refine_ok, height / torch.clamp(bh.to(_F32), min=1.0), 1.0)
    refined = _mm(_scaled_crop(cscale, bx.to(_F32), by.to(_F32)), final_pre)
    final_out = torch.where(refine_ok, refined, final_pre)
    return dict(
        final=final_out,
        coeffs=_inverse_coeffs_device(final_out),
        ratio_final=ratio_final,
        refine_ok=refine_ok,
        rect=torch.stack([bx, by, bh]),
    )


# ---------------------------------------------------------------------------
# Host orchestration
# ---------------------------------------------------------------------------

def _out_dims(framing: str, height: int, width: int) -> Tuple[int, int]:
    """Static warp canvas (h, w): exact for crop and crop_and_pad, the
    bucket for expand."""
    if framing != "expand":
        return height, width
    return height + 2 * EXPAND_MARGIN_PX, width + 2 * EXPAND_MARGIN_PX


def _crop_gate(framing: str, keep_fov: float) -> bool:
    """True when crop framing must go to the host engine: its keep_fov ~= 1
    bypass returns the original frames without a warp."""
    return framing == "crop" and float(np.clip(keep_fov, 0.0, 1.0)) >= 0.9999


def _gray_pool_factors(width, height, working_size, decimation):
    """Integer pool factors (fy, fx) of the working gray, or None when the
    working resize is not an exact box factor (the area-matrix path).
    The fused Flow program is used only with such factors, as in the JAX
    package (``_gray_pool_factors``)."""
    if not R.can_decimate(width, height, working_size, max(int(decimation), 1)):
        return None
    if working_size is None:
        gw, gh = int(width), int(height)
    else:
        gw, gh = int(working_size[0]), int(working_size[1])
        if int(width) % gw or int(height) % gh:
            return None
    gw //= decimation
    gh //= decimation
    if gw <= 0 or gh <= 0 or width % gw or height % gh:
        return None
    return height // gh, width // gw


def _mesh_defer(frames, n: int, framing: str) -> bool:
    """True when the fast path must leave a call to the host engine for
    its mesh layout (the JAX package's ``_mesh_defer`` and crop gate):
    under an active mesh, a clip its data axis does not split evenly, or
    crop framing; with no mesh, frame shards."""
    if active_mesh() is None:
        return isinstance(frames, FrameShards)
    return framing == "crop" or data_shards(n) is None


def _gates(frames, framing: str, size, keep_fov: float):
    """(frames, n, out_h_b, out_w_b) when the fast path takes this call,
    else None: crop, crop_and_pad or expand framing of >= 2 NHWC RGB
    frames whose warp does not stream, not the crop keep_fov ~= 1 bypass,
    and not a mesh layout that defers (:func:`_mesh_defer`).  Under a
    mesh the frames come back as frame shards (split over the data axis
    when they were one tensor)."""
    if not enabled(frames) or framing not in ("crop", "crop_and_pad", "expand"):
        return None
    width, height = int(size[0]), int(size[1])
    if getattr(frames, "ndim", 0) != 4 or frames.shape[-1] != 3:
        return None
    n = int(frames.shape[0])
    out_h_b, out_w_b = _out_dims(framing, height, width)
    if n < 2 or W.will_stream(n, height, width, out_h_b, out_w_b):
        return None
    if _crop_gate(framing, keep_fov) or _mesh_defer(frames, n, framing):
        return None
    if active_mesh() is not None:
        frames = frame_shards(frames)
        if frames is None:
            return None
    return frames, n, out_h_b, out_w_b


def _trajectory_args(strength, smooth, fps, camera_lock, keep_fov, width, height, working_size):
    """The clamped (strength, smooth, keep_fov), the smoothing window and the
    working-to-full scale, as the host engine derives them."""
    strength_c = float(np.clip(strength, 0.0, 1.0))
    smooth_c = float(np.clip(smooth, 0.0, 1.0))
    if camera_lock:
        smooth_c = max(smooth_c, 0.85)
    window = G.smoothing_window(smooth_c, fps) if smooth_c > 0.0 else 0
    scale_xy = ((working_size[0] / float(width), working_size[1] / float(height))
                if working_size is not None else (1.0, 1.0))
    keep_fov_c = float(np.clip(keep_fov, 0.0, 1.0))
    return strength_c, smooth_c, keep_fov_c, window, scale_xy


def _scalar(v: float, device) -> torch.Tensor:
    return torch.full((), v, dtype=_F32, device=device)


def _route(kind: str, frames, framing: str, tick_pairs, size, working_size, decimation: int) -> str:
    """How a call's estimation runs, from what the call shows: "graph", the
    whole estimation replayed from one CUDA graph (crop_and_pad with no
    progress observer; Flow only with integer pool factors, as the JAX
    package's fused program requires); "chunks", Flow under an observer,
    each chunk's DIS from one graph (:func:`_dis_from_graph`); else
    "eager".  A graph needs one CUDA device (not frame shards: a graph
    stays single-device) and ``CVST_FUSED`` not 0."""
    if (isinstance(frames, FrameShards) or frames.device.type != "cuda"
            or os.environ.get("CVST_FUSED", "1") in ("0", "false")):
        return "eager"
    if tick_pairs is not None:
        return "chunks" if kind == "flow" else "eager"
    pooled = kind != "flow" or _gray_pool_factors(int(size[0]), int(size[1]), working_size, decimation) is not None
    return "graph" if framing == "crop_and_pad" and pooled else "eager"


def _flow_estimate(grays, strength, keep_fov, *, decimation, seed, mode, camera_lock, window,
                   width, height, scale_xy, tick_pairs=None, per_chunk=None, framing="crop_and_pad", bucket=None):
    """DIS on the working grays through the shared chunk loop, each
    chunk's dispatch by ``per_chunk`` (``FD.dis_flow_fit``'s arguments;
    that function when None), the device fits and the trajectory
    program: the whole Flow estimation, with no host read.  With no
    ``tick_pairs`` it is what the fused graph captures."""
    want_persp = mode == "perspective"
    gh, gw = int(grays.shape[1]), int(grays.shape[2])
    h_work, w_work = gh * decimation, gw * decimation
    samples = FL._dis_samples_chunked(
        grays, FL.SAMPLE_STEP // decimation, FL.finest_scale(decimation),
        "homography" if want_persp else "similarity", tick_pairs, per_chunk,
    )
    if decimation > 1:
        samples = samples * float(decimation)  # back to working px units
    dev = lead_device(grays)
    pts = FL._grid_points(h_work, w_work, FL.SAMPLE_STEP, dev)
    with P.span("fastpath.fits", dev):  # eager routes only: no span opens inside a capture
        fits = FL._fused_fits_device(samples, pts, seed, want_persp, RS.DEFAULT_HYPOTHESES)
    total_pts = (((h_work + FL.SAMPLE_STEP - 1) // FL.SAMPLE_STEP)
                 * ((w_work + FL.SAMPLE_STEP - 1) // FL.SAMPLE_STEP))
    return _traj_program(
        strength, keep_fov, *fits,
        kind="flow", mode=mode, want_persp=want_persp, camera_lock=camera_lock, window=window,
        width=width, height=height, scale_xy=scale_xy, total_pts=total_pts,
        framing=framing, bucket=bucket,
    )


def _classic_estimate(grays, strength, keep_fov, *, seed, mode, camera_lock, window, width, height, scale_xy,
                      tick_pairs=None, per_chunk=None, framing="crop_and_pad", bucket=None):
    """GFTT, LK and the fits (models/classic.py::_tracks_and_fits, each
    chunk's tracks by ``per_chunk``, ``CL._tracks`` when None), then the
    trajectory program: the whole Classic estimation, with no host read.
    With no ``tick_pairs`` it is what the fused graph captures."""
    want_persp = mode == "perspective"
    (_, det_counts, _, _), fits = CL._tracks_and_fits(grays, tick_pairs, seed, want_persp, per_chunk=per_chunk)
    return _traj_program(
        strength, keep_fov, det_counts, *fits,
        kind="classic", mode=mode, want_persp=want_persp, camera_lock=camera_lock, window=window,
        width=width, height=height, scale_xy=scale_xy, total_pts=1, framing=framing, bucket=bucket,
    )


# the estimation program each kind's graph captures
_PROGRAMS = {"flow": _flow_estimate, "classic": _classic_estimate}


class _FusedGraph:
    """One captured ``program(*inputs, **kw)``: static inputs of the
    example's shapes and dtypes in (a float is a 0-d float32 tensor), the
    program's tensor or dict of tensors out, and the kernel launches the
    capture recorded, added to ``cuda_build.LAUNCHES`` on every replay.

    The static inputs are allocated inside the capture, in the shared
    pool, as the outputs are: a long-lived input made outside it could
    land in a large free block of the allocator's own pool (the last
    call's frames) and keep that whole segment reserved."""

    def __init__(self, program, example: tuple, kw: dict):
        self.program = program
        self.device = example[0].device
        self.specs = [(tuple(v.shape), v.dtype) if torch.is_tensor(v) else ((), _F32) for v in example]
        self.kw = kw
        self.inputs = None
        self.graph = None
        self.out = None
        self.launches = {}
        self.pool_growth = 0

    def capture(self, *args) -> None:
        """Run the program once eagerly on the device's warm-up stream (so
        cuBLAS handles and the allocator's state exist, as PyTorch's graph
        guide asks), then capture it."""
        dev = self.device
        side = _warmup_stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.program(*(v if torch.is_tensor(v) else _scalar(v, dev) for v in args), **self.kw)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.record()
        GRAPH_STATS["captures"] += 1

    def record(self) -> None:
        """Capture the program into the device's shared pool (a recapture
        calls this alone).  ``pool_growth`` is what the capture added to
        the device's reserved bytes: the pool's new segments."""
        dev = self.device
        # torch.cuda.graph empties the allocator's cache as it begins (the
        # segments of a pool no graph uses go too); count from there
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph()
        before = dict(cuda_build.LAUNCHES)
        _CAPTURE.open = True
        # Every cached graph of a device records into one shared pool, so
        # the cache keeps about the largest graph's pool, not the sum.
        # Sharing is safe here: the graphs replay one at a time on one
        # stream; a graph's static inputs and outputs are live blocks no
        # later capture takes, though they may lie in an earlier graph's
        # scratch; replay() writes the inputs just before it replays and
        # clones every output at once, so another graph's replay in
        # between harms no result.
        with torch.cuda.device(dev), torch.cuda.graph(graph, pool=_graph_pool(dev)):
            # torch.empty records no kernel: replay() alone writes them
            self.inputs = [torch.empty(shape, dtype=dtype, device=dev) for shape, dtype in self.specs]
            out = self.program(*self.inputs, **self.kw)
        _CAPTURE.open = False
        # the wrappers counted the captured launches, which ran nothing
        self.launches = {k: cuda_build.LAUNCHES[k] - before[k] for k in before}
        cuda_build.LAUNCHES.update(before)
        self.graph, self.out = graph, out
        self.pool_growth = torch.cuda.memory_reserved(dev) - reserved

    def release(self) -> None:
        """Drop the captured graph, its static inputs and its outputs (its
        share of the pool)."""
        self.graph = self.out = self.inputs = None

    def replay(self, *args):
        """The program on these inputs; every output copied out of the
        graph's memory, so two calls never share a result."""
        for static, v in zip(self.inputs, args):
            if torch.is_tensor(v):
                static.copy_(v)
            else:
                static.fill_(v)
        with torch.cuda.device(self.device):
            self.graph.replay()
        for k, v in self.launches.items():
            cuda_build.LAUNCHES[k] += v
        GRAPH_STATS["replays"] += 1
        if torch.is_tensor(self.out):
            return self.out.clone()
        return {k: v.clone() for k, v in self.out.items()}


_GRAPHS: "OrderedDict[tuple, _FusedGraph]" = OrderedDict()

# the pool handle each device's graphs share, while one of them lives
_POOLS: Dict[str, tuple] = {}

# one side stream a device for the graphs' eager warm-ups: cuBLAS keeps a
# workspace for every stream it has run on, so a new stream a capture
# would add one a capture
_WARMUP_STREAMS: Dict[str, torch.cuda.Stream] = {}


def _warmup_stream(dev: torch.device) -> torch.cuda.Stream:
    key = str(dev)
    if key not in _WARMUP_STREAMS:
        _WARMUP_STREAMS[key] = torch.cuda.Stream(dev)
    return _WARMUP_STREAMS[key]


def _graph_pool(dev: torch.device) -> tuple:
    """The memory pool handle the cached graphs of ``dev`` share."""
    key = str(dev)
    if key not in _POOLS:
        _POOLS[key] = torch.cuda.graph_pool_handle()
    return _POOLS[key]


def _drop_unused_pools() -> None:
    """Forget the handle of a device that has no cached graph left.  Its
    pool is then free for ``torch.cuda.empty_cache()`` to return, and the
    next capture opens a new one: the allocator refuses to reuse the
    handle of a pool whose last graph is gone."""
    live = {str(entry.device) for entry in _GRAPHS.values()}
    for key in [k for k in _POOLS if k not in live]:
        del _POOLS[key]


def clear_graph_cache() -> None:
    """Drop every captured graph and the pool they share."""
    _GRAPHS.clear()
    _drop_unused_pools()


def _rebuild_pool(key: tuple) -> None:
    """Recapture the cached graphs of ``key``'s device into a new pool,
    ``key``'s graph first.

    A pool in use never shrinks, and a graph captured after smaller ones
    reuses little of their scratch (its blocks are larger than theirs):
    a Flow graph then a Classic one kept about the sum of their pools.
    Captured first, the largest graph leaves free blocks the smaller ones
    fit in, so the cache keeps about the largest graph's pool.  The old
    pool, used by no graph once they are released, is returned by the
    cache emptying the first recapture begins with."""
    dev = _GRAPHS[key].device
    keys = [key] + [k for k, e in _GRAPHS.items() if k != key and e.device == dev]
    entries = {k: _GRAPHS.pop(k) for k in keys}
    for entry in entries.values():
        entry.release()
    _drop_unused_pools()
    GRAPH_STATS["rebuilds"] += 1
    try:
        for k in keys:
            entries[k].record()
            GRAPH_STATS["recaptures"] += 1
            _GRAPHS[k] = entries[k]
    except BaseException:
        _drop_unused_pools()
        raise
    _GRAPHS.move_to_end(key)


def _cached_graph(key: tuple, program, example: tuple, kw: dict) -> _FusedGraph:
    """The cached graph of ``key`` (every static argument, the shapes, the
    device), captured from ``example`` on its first call."""
    entry = _GRAPHS.get(key)
    if entry is None:
        P.count("fastpath.capture", 1)
        entry = _FusedGraph(program, example, kw)
        try:
            entry.capture(*example)
        except BaseException:
            _drop_unused_pools()
            raise
        _GRAPHS[key] = entry
        while len(_GRAPHS) > GRAPH_CACHE_SIZE:
            _GRAPHS.popitem(last=False)
        _drop_unused_pools()
        others = sum(e.device == entry.device for e in _GRAPHS.values()) > 1
        if others and entry.pool_growth > POOL_REBUILD_BYTES:
            _rebuild_pool(key)
    else:
        _GRAPHS.move_to_end(key)
    return entry


def _fused_estimate(kind: str, grays, strength: float, keep_fov: float, kw: dict) -> Dict[str, torch.Tensor]:
    """``kind``'s estimation from its CUDA graph, captured at the first call
    of each static key (the kind, the shapes, every static argument, the
    device)."""
    key = (kind, tuple(grays.shape), str(grays.device)) + tuple(sorted(kw.items()))
    args = (grays, strength, keep_fov)
    return _cached_graph(key, _PROGRAMS[kind], args, kw).replay(*args)


def _dis_from_graph(grays, step: int, finest_scale: int, model: str) -> torch.Tensor:
    """``FD.dis_flow_fit`` of one chunk of grays, from a CUDA graph: the
    halvings to the finest level refined run eagerly (``FD.fit_level``,
    its span outside any capture), then the graph of
    ``FD.dis_flow_fit_level`` replays on that level.  The graph keeps the
    level and the samples."""
    level = FD.fit_level(grays, finest_scale)
    kw = dict(size=(int(grays.shape[1]), int(grays.shape[2])), step=step, finest_scale=finest_scale, model=model)
    key = ("flow_dis", tuple(level.shape), str(level.device)) + tuple(sorted(kw.items()))
    return _cached_graph(key, FD.dis_flow_fit_level, (level,), kw).replay(level)


def run_fast(
    kind: str,
    frames,
    framing: str,
    transform_mode: str,
    camera_lock: bool,
    strength: float,
    smooth: float,
    fps: float,
    size: Tuple[int, int],
    working_size,
    decimation: int,
    padding_rgb: Tuple[int, int, int],
    seed: int = 0,
    tick_pairs=None,
    keep_fov: float = 1.0,
) -> Dict | None:
    """The ``kind`` ('flow' or 'classic') crop / crop_and_pad / expand
    pipeline with no host read before K1: the gray, the kind's estimation
    program (``_PROGRAMS``) by its :func:`_route`, then K8's stats, K1 and
    the one fetch.  Returns the host-value dict models/stabilize.py's meta
    assembly consumes, or None to leave the call to the host engine."""
    gated = _gates(frames, framing, size, keep_fov)
    if gated is None:
        return None
    frames, _, out_h_b, out_w_b = gated
    dev = lead_device(frames)
    width, height = int(size[0]), int(size[1])
    flow = kind == "flow"
    strength_c, smooth_c, keep_fov_c, window, scale_xy = _trajectory_args(
        strength, smooth, fps, camera_lock, keep_fov, width, height, working_size)
    with P.span("fastpath.gray", dev):
        grays = R.gray_for_estimation(frames, working_size, decimation=decimation)
    kw = dict(seed=seed, mode=transform_mode, camera_lock=camera_lock, window=window, width=width,
              height=height, scale_xy=scale_xy)
    if flow:
        kw["decimation"] = decimation
    route = _route(kind, frames, framing, tick_pairs, size, working_size, decimation)
    with P.span("fastpath.estimate", dev):
        if route == "graph":
            out = _fused_estimate(kind, grays, strength_c, keep_fov_c, kw)
        else:
            out = _PROGRAMS[kind](grays, _scalar(strength_c, dev), _scalar(keep_fov_c, dev), tick_pairs=tick_pairs,
                                  per_chunk=_dis_from_graph if route == "chunks" else None, framing=framing,
                                  bucket=(out_h_b, out_w_b), **kw)
    del grays
    return _dispatch_and_collect(
        frames, out, width, height, padding_rgb,
        extra_meta={"flow_backend": "DIS", "flow_fallback_reason": None} if flow else {},
        strength_c=strength_c, smooth_c=smooth_c, has_resid=flow,
        framing=framing, out_dims=(out_h_b, out_w_b), keep_fov_c=keep_fov_c,
    )


# the trajectory program's outputs the diagnostics fetch brings to the host
DIAG_KEYS = ("fit", "out_wh", "chosen", "conf", "resid", "matrices", "path", "target", "diffs",
             "apply", "final", "mins", "maxs", "offsets", "degenerate")


def _dispatch_and_collect(
    frames, out, width, height, padding_rgb, *, extra_meta, strength_c, smooth_c, has_resid,
    framing, out_dims, keep_fov_c,
):
    """Queue the padding stats and K1 on the device coefficients, then make
    the one diagnostics fetch and build the host-value dict the engine's
    meta assembly consumes (None sends the call to the host engine).
    Frame shards run the stats and K1 on each shard with its rows of the
    coefficients; their frames and masks stay there (one tensor is one
    shard, and its results come back as tensors)."""
    dev = lead_device(frames)
    sharded = isinstance(frames, FrameShards)
    with P.span("fastpath.warp", dev):  # K8's stats and K1 queued
        shards = (frames if sharded else FrameShards([frames])).map(lambda f: f.to(_F32).contiguous())
        out_h_b, out_w_b = out_dims
        n = int(frames.shape[0])
        crop_fin = None
        if framing == "crop":
            _, iters = _crop_search_iters(width, height)
            crop_fin = _crop_finalize(out["final"], _crop_w_table(width, height, dev),
                                      width=width, height=height, iters=iters)
            out = {**out, "final": crop_fin["final"], "coeffs": crop_fin["coeffs"]}
        border = np.asarray(padding_rgb, np.float32) / 255.0
        border_t = device_constant([float(v) for v in border], dev)
        src = shards if sharded else shards.shards[0]
        masks = stabilized = None
        ratios = torch.zeros(n, dtype=_F32, device=dev)  # crop: made after the fetch
        if framing == "crop_and_pad":
            # the stats are queued before K1, so the fetch waits for them only
            masks, ratios = W.padding_stats_sharded(out["coeffs"], shards, height, width, height, width)
            stabilized = W.warp_frames_sharded(shards, out["coeffs"], border_t, height, width, "bilinear")
        elif framing == "expand":
            stabilized = W.warp_frames_sharded(shards, out["coeffs"], border_t, out_h_b, out_w_b, "bilinear")
            masks, ratios = W.padding_stats_bucket_sharded(out["coeffs"], out["out_wh"], shards, out_h_b, out_w_b,
                                                           height, width)
        if not sharded and stabilized is not None:
            stabilized, masks = stabilized.shards[0], masks.shards[0]

    # ONE host fetch, after K1 is queued
    bundle = {k: out[k] for k in DIAG_KEYS}
    bundle["ratios"] = ratios
    if crop_fin is not None:
        bundle.update({k: out[k] for k in ("crop_ratio_full", "crop_overlap_full", "crop_found",
                                           "crop_best_scale", "crop_s_star")})
        bundle.update(ratio_final=crop_fin["ratio_final"], refine_ok=crop_fin["refine_ok"],
                      rect=crop_fin["rect"])
    with P.span("fastpath.fetch", dev):
        diag = fetch_packed(bundle)
        P.count("fastpath.persp_transitions", int(np.count_nonzero(diag["chosen"] == _MODE_IDX["perspective"])))
    final = diag["final"]
    if not np.isfinite(final).all():
        return None  # the engine re-runs the host path
    ratios_np = diag["ratios"]

    output_size = None
    if framing == "crop":
        # stats and warp from the fetched matrices, as the host engine
        with P.span("fastpath.warp", dev):
            stabilized, masks, ratios_dev = W.warp_clip_with_mask(
                src, np.asarray(final, np.float64), (width, height), "bilinear", border, device=dev)
            ratios_np = ratios_dev.cpu().numpy()
    elif framing == "expand":
        out_w_e, out_h_e = int(diag["out_wh"][0]), int(diag["out_wh"][1])
        if out_w_e <= 0 or out_h_e <= 0:
            return None
        output_size = (out_w_e, out_h_e)
        if bool(diag["fit"]):
            # the bucket held: slice to the true canvas
            def canvas(t):
                return t[:, :out_h_e, :out_w_e].contiguous()

            stabilized = stabilized.map(canvas) if sharded else canvas(stabilized)
            masks = masks.map(canvas) if sharded else canvas(masks)
        else:
            # the canvas is past the bucket: re-warp at its exact size,
            # the trajectory kept (the bucket outputs released first)
            stabilized = masks = None
            with P.span("fastpath.warp", dev):
                stabilized, masks, ratios_dev = W.warp_clip_with_mask(
                    src, np.asarray(final, np.float64), output_size, "bilinear", border, device=dev)
                ratios_np = ratios_dev.cpu().numpy()

    result = dict(
        matrices=np.asarray(diag["matrices"], np.float32),
        modes_used=[_MODE_NAMES[int(i)] for i in diag["chosen"]],
        confidences=[float(v) for v in diag["conf"]],
        residuals=[float(v) for v in diag["resid"]] if has_resid else None,
        path=np.asarray(diag["path"], np.float64),
        target_path=np.asarray(diag["target"], np.float64),
        diffs=np.asarray(diag["diffs"], np.float64),
        apply_matrices=np.asarray(diag["apply"], np.float32),
        final_matrices=np.asarray(final, np.float32),
        mins=np.asarray(diag["mins"], np.float64),
        maxs=np.asarray(diag["maxs"], np.float64),
        center_offset=[float(diag["offsets"][0]), float(diag["offsets"][1])],
        stabilized=stabilized,
        padding_masks=masks,
        padded_ratios=np.asarray(ratios_np),
        extra_meta=extra_meta,
        strength=strength_c,
        smooth=smooth_c,
    )
    if output_size is not None:
        result["output_size"] = output_size
    if crop_fin is not None:
        result.update(_crop_status(diag, keep_fov_c, width, height))
    return result


def _crop_status(diag: Dict[str, np.ndarray], keep_fov_c: float, width: int, height: int) -> Dict:
    """keep_fov status, note, scale and crop rectangle rebuilt from the
    fetched codes, byte for byte as models/framing.py::
    compute_crop_with_keep_fov_parametric and refine_no_padding_crop."""
    eps = 1e-4
    kf = keep_fov_c
    if kf <= eps:
        status = "disabled"
        note = (None if bool(diag["crop_overlap_full"]) else
                "No common crop region at full stabilization; stabilization was disabled.")
        scale = float(diag["crop_s_star"])
    elif float(diag["crop_ratio_full"]) >= kf - eps:
        status, note, scale = "met", None, 1.0
    elif not bool(diag["crop_found"]):
        status = "failed"
        note = (f"keep_fov target {kf:.3f} could not be satisfied "
                f"even with zero stabilisation.")
        scale = 0.0
    else:
        scale = float(diag["crop_best_scale"])
        ratio_final = float(diag["ratio_final"])
        if ratio_final >= kf - eps:
            status, note = "met", None
        else:
            status = "clamped"
            note = (f"keep_fov target {kf:.3f} reduced to "
                    f"{ratio_final:.3f} at stabilisation scale "
                    f"{scale:.3f}.")
    rect = diag["rect"]
    if bool(diag["refine_ok"]):
        aspect = np.float64(width) / np.float64(height)
        crop_origin = [float(rect[0]), float(rect[1])]
        crop_size = [float(aspect * np.float64(int(rect[2]))), float(rect[2])]
        kfe = 1.0
    else:
        crop_origin = [0.0, 0.0]
        crop_size = [float(width), float(height)]
        kfe = 0.0
    return dict(keep_fov_status=status, keep_fov_note=note, keep_fov_effective=kfe,
                stabilization_scale=scale, crop_origin=crop_origin, crop_size=crop_size)
