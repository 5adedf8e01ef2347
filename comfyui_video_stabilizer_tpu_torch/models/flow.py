"""Flow (dense optical flow) estimator + stabilizer.

Counterpart of ``comfyui_video_stabilizer_tpu/models/flow.py``: DIS
flow (ops/flow_dis.py) sampled on the 8-px working-res grid, then the
robust fits for the whole fallback chain in one batched pass
(perspective RANSAC when asked for, similarity RANSAC, median
translation, residual diagnostics).  Perspective drives the
coarse-to-fine pre-warp with the IRLS homography fit.

The backend degrades as the JAX package's does: when the DIS tier
(DIS and the fits) raises, TV-L1 (ops/tvl1.py) feeds the same fits;
when that raises too, phase correlation (ops/phase_corr.py) gives
translation-only fits.  ``flow_backend`` and ``flow_fallback_reason``
say which tier ran and why.  Two kinds of exception are never degraded
and propagate from any tier: ``cuda_build.KernelError`` (a hand kernel
that does not build, load or launch, or whose wrapper refuses its
arguments) and ``torch.AcceleratorError`` (a CUDA runtime error), so a
broken or refused kernel never passes as a degraded run.
Every other exception, out-of-memory included, degrades as in the
reference.  An interrupt raised in a progress tick arrives as the
engine's ``EstimationInterrupted``, a BaseException, and passes
through.

On the card (and on the CPU with ``CVST_FASTPATH=1``) the engine first
offers crop, crop_and_pad and expand calls to the zero-sync fast path
(``flow_estimator.fast_path``, models/fastpath.py), which runs the same
DIS and fits with the trajectory on the device; a fast path that gives
up leaves the call to this estimator.

Under an active mesh (utils/meshinfo.py) the engine hands the estimator
frame-sharded grays (parallel/mesh.py::FrameShards): DIS (K2) runs over
each shard's pairs on the shard's device, the pair that crosses into the
next shard with a one-frame halo of that shard's gray, and the sampled
flow is gathered to the lead device, where the fits run as without a
mesh.  The RANSAC keys fold in the global pair index, so each pair is
fitted with the key an unsharded call gives it.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..ops import flow_dis as FD
from ..ops import phase_corr as PC
from ..ops import prng
from ..ops import ransac as RS
from ..ops import tvl1 as TV
from ..ops.cuda_build import KernelError
from ..ops.resize import can_decimate
from ..parallel.mesh import FrameShards, lead_device
from ..utils import profiling as P
from ..utils.video_io import VideoContext
from . import geometry as G
from .stabilize import PairFits, StabilizationResult, chunked_pairs, stabilize_clip

SAMPLE_STEP = 8
MIN_VALID = 12
PERSP_MIN_RATIO = 0.15
SIM_MIN_RATIO = 0.1

# failures of the kernels or the card, which the backend chain re-raises
NOT_DEGRADED = (KernelError, torch.AcceleratorError)


def _grid_points(h: int, w: int, step: int, device: torch.device | str) -> torch.Tensor:
    """(P, 2) float32 (x, y) of the ``step``-px grid, row-major."""
    ys = torch.arange(0, h, step, dtype=torch.float32, device=device)
    xs = torch.arange(0, w, step, dtype=torch.float32, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=1)


def _fused_fits_device(samples: torch.Tensor, pts: torch.Tensor, seed: int, want_persp: bool,
                       n_hyp: int) -> Tuple[torch.Tensor, ...]:
    """Perspective RANSAC (key salt 0, with ``want_persp``), similarity
    RANSAC (salt 1), median translation and residuals, all pairs at
    once, as device tensors in the order the fast path's trajectory
    program unpacks them: valid counts, [H, its inliers, valid counts,
    residuals,] S, its inliers, valid counts, residuals, T, residuals."""
    b = samples.shape[0]
    dev = samples.device
    prev_pts = pts[None].expand(samples.shape)
    curr_pts = prev_pts + samples
    valid = torch.isfinite(curr_pts).all(dim=2)

    def keys(salt):
        # the global pair index: a sharded run gathers every pair's samples
        # here, so a pair's key never depends on the shard it came from
        return prng.fold_in(prng.PRNGKey(seed + salt, device=dev), torch.arange(b, device=dev))

    out = [valid.sum(1)]
    if want_persp:
        H, n_in, n_valid = RS.ransac_fit(keys(0), prev_pts, curr_pts, valid, "perspective", n_hyp,
                                         RS.PERSP_THRESH)
        out += [H, n_in, n_valid, RS.residuals(H, prev_pts, curr_pts, valid)]
    S, n_in, n_valid = RS.ransac_fit(keys(1), prev_pts, curr_pts, valid, "similarity", n_hyp, RS.SIM_THRESH)
    med = RS.masked_median_shift(prev_pts, curr_pts, valid)
    T = torch.eye(3, dtype=torch.float32, device=dev).repeat(b, 1, 1)
    T[:, 0, 2] = med[:, 0]
    T[:, 1, 2] = med[:, 1]
    out += [S, n_in, n_valid, RS.residuals(S, prev_pts, curr_pts, valid),
            T, RS.residuals(T, prev_pts, curr_pts, valid)]
    return tuple(out)


def _fused_fits_sampled(samples: torch.Tensor, pts: torch.Tensor, seed: int, want_persp: bool,
                        n_hyp: int) -> Dict[str, np.ndarray]:
    """:func:`_fused_fits_device`, brought to the host as numpy arrays
    keyed valid_counts, [H, nH, vH, rH,] S, nS, vS, rS, T, rT."""
    names = (("valid_counts",) + (("H", "nH", "vH", "rH") if want_persp else ())
             + ("S", "nS", "vS", "rS", "T", "rT"))
    fits = _fused_fits_device(samples, pts, seed, want_persp, n_hyp)
    return {k: v.cpu().numpy() for k, v in zip(names, fits)}


def _gray_decimation(width: int, height: int, working_size) -> int:
    """Decimation factor the fit path absorbs into gray production: the
    solve never reads levels finer than working-res / 2**FINEST_SCALE."""
    dec = 1 << FD.FINEST_SCALE
    if SAMPLE_STEP % dec:
        return 1
    tw, th = working_size if working_size is not None else (int(width), int(height))
    if FD.num_levels(th, tw) < FD.FINEST_SCALE:
        return 1
    return dec if can_decimate(width, height, working_size, dec) else 1


def _dis_samples_chunked(grays, step_local, finest_scale, model, tick_pairs, dis=None):
    """DIS flow over all adjacent pairs through the shared chunk loop
    (models/stabilize.py::chunked_pairs: 32-pair chunks with a progress
    tick + interrupt poll between them under an observer, by shard on
    frame shards).  Each chunk's dispatch runs in span ``flow.dis.chunk``
    by ``dis`` (``FD.dis_flow_fit``'s arguments; that function when None;
    the fast path's CUDA graph of a chunk)."""
    def per_chunk(chunk):
        with P.span("flow.dis.chunk", chunk.device):
            return (dis or FD.dis_flow_fit)(chunk, step_local, finest_scale=finest_scale, model=model)

    return chunked_pairs(grays, per_chunk, tick_pairs)


def finest_scale(decimation: int) -> int:
    """The finest level DIS refines: the decimated gray is already that
    level (level 0), the full gray builds it (``FD.FINEST_SCALE``)."""
    return 0 if decimation > 1 else FD.FINEST_SCALE


def flow_estimator(
    grays: torch.Tensor, requested_mode: str, *, seed: int = 0, decimation: int = 1,
    tick_pairs=None,
) -> PairFits:
    """Per-pair fits from dense flow; grays (N, h, w) on the working device."""
    n, h, w = grays.shape
    b = n - 1
    h_work, w_work = h * decimation, w * decimation
    want_persp = requested_mode == "perspective"
    step_local = SAMPLE_STEP // decimation
    pts = _grid_points(h_work, w_work, SAMPLE_STEP, lead_device(grays))
    extra = {"flow_backend": "DIS", "flow_fallback_reason": None}

    try:
        samples = _dis_samples_chunked(
            grays, step_local, finest_scale(decimation),
            "homography" if want_persp else "similarity", tick_pairs,
        )
        if decimation > 1:
            samples = samples * float(decimation)  # back to working px units
        fused = _fused_fits_sampled(samples, pts, seed, want_persp, RS.DEFAULT_HYPOTHESES)
    except NOT_DEGRADED:
        raise
    except Exception as exc:
        if isinstance(grays, FrameShards):
            grays = grays.gather()  # the fallback tiers run on the lead device
        try:
            flow_full, _ = TV.tvl1_flow(grays)
            samples = flow_full[:, ::step_local, ::step_local, :].reshape(b, -1, 2)
            if decimation > 1:
                samples = samples * float(decimation)
            fused = _fused_fits_sampled(samples, pts, seed, want_persp, RS.DEFAULT_HYPOTHESES)
        except NOT_DEGRADED:
            raise
        except Exception as exc2:
            shifts, resp = PC.phase_correlate_batch(grays[:-1], grays[1:])
            mats = np.tile(np.eye(3, dtype=np.float32), (b, 1, 1))
            shifts = shifts * float(decimation)
            mats[:, 0, 2] = shifts[:, 0]
            mats[:, 1, 2] = shifts[:, 1]
            return PairFits(
                degenerate=np.zeros(b, bool),
                matrices={"translation": mats},
                confidences={"translation": resp},
                accepted={"translation": np.ones(b, bool)},
                residuals={"translation": np.zeros(b)},
                extra_meta={
                    "flow_backend": "phase_correlate",
                    "flow_fallback_reason":
                        f"DIS unavailable ({exc}; TV-L1 failed ({exc2})); using phase correlation.",
                },
            )
        extra = {"flow_backend": "TVL1", "flow_fallback_reason": f"DIS unavailable ({exc}); using TV-L1."}

    valid_counts = fused["valid_counts"]
    total_pts = (
        ((h_work + SAMPLE_STEP - 1) // SAMPLE_STEP)
        * ((w_work + SAMPLE_STEP - 1) // SAMPLE_STEP)
    )
    matrices: Dict[str, np.ndarray] = {}
    confidences: Dict[str, np.ndarray] = {}
    accepted: Dict[str, np.ndarray] = {}
    residuals: Dict[str, np.ndarray] = {}
    for mode, key, min_points, min_ratio in (("perspective", "H", 4, PERSP_MIN_RATIO),
                                             ("similarity", "S", 3, SIM_MIN_RATIO)):
        if key not in fused:
            continue
        M, n_in, n_valid = fused[key], fused["n" + key], fused["v" + key]
        conf = np.where(n_valid > 0, n_in / np.maximum(n_valid, 1), 0.0)
        matrices[mode] = M
        confidences[mode] = conf
        accepted[mode] = np.isfinite(M).all(axis=(1, 2)) & (valid_counts >= min_points) & (conf >= min_ratio)
        residuals[mode] = fused["r" + key]
    matrices["translation"] = fused["T"]
    confidences["translation"] = valid_counts / max(total_pts, 1)
    accepted["translation"] = np.ones(b, bool)
    residuals["translation"] = fused["rT"]
    return PairFits(
        degenerate=valid_counts < MIN_VALID,
        matrices=matrices,
        confidences=confidences,
        accepted=accepted,
        residuals=residuals,
        extra_meta=extra,
    )


# engine hook: stabilize_clip consults this to produce pre-decimated grays
flow_estimator.gray_decimation = _gray_decimation


def _flow_fast_path(*args, **kwargs):
    """Engine hook: the device pipeline for crop / crop_and_pad / expand
    (models/fastpath.py); None leaves the call to the host engine."""
    from . import fastpath

    return fastpath.offer("flow", *args, **kwargs)


flow_estimator.fast_path = _flow_fast_path


def stabilize_flow(
    context: VideoContext,
    framing_mode: G.FramingMode,
    transform_mode: G.TransformMode,
    camera_lock: bool,
    strength: float,
    smooth: float,
    keep_fov: float,
    padding_rgb: Tuple[int, int, int],
    frame_rate: float,
    progress=None,
    interrupt_check=None,
    device: str | torch.device = "cuda",
) -> StabilizationResult:
    """Flow stabilizer on ``device`` ('cuda' by default; 'cpu' runs the plain versions)."""
    return stabilize_clip(
        context,
        estimator=flow_estimator,
        source_name="estimated_flow",
        framing_mode=framing_mode,
        transform_mode=transform_mode,
        camera_lock=camera_lock,
        strength=strength,
        smooth=smooth,
        keep_fov=keep_fov,
        padding_rgb=padding_rgb,
        frame_rate=frame_rate,
        extra_meta={"flow_backend": "DIS", "flow_fallback_reason": None},
        progress=progress,
        interrupt_check=interrupt_check,
        device=device,
    )
