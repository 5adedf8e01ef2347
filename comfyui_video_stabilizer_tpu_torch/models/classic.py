"""Classic (sparse feature tracking) estimator + stabilizer.

Counterpart of ``comfyui_video_stabilizer_tpu/models/classic.py``: GFTT
corners on every pair's leading frame, pyramidal LK tracks to the next
frame (ops/lk.py, kernels K4, K5 and K6), then the robust fits for the
similarity -> translation fallback chain of all pairs at once.  The
sticky mode degradation is the shared engine's host scan.

Acceptance contract (the reference's thresholds):
  <12 detected features or <8 surviving tracks -> degenerate pair
  perspective: >=4 points, RANSAC inlier ratio >= 0.15
  similarity:  >=3 points, RANSAC inlier ratio >= 0.1
  translation: always accepted; confidence = survivors / detected

GFTT (K4, then K7 for the corner greedy), the pyramid, LK (K6, K5) and
the fits run on the grays' device with no host read in between, as the
JAX package's ``_classic_estimate_fused`` does; ``classic_estimator``
then brings the detected counts and the fits to the host in one copy.

On the card (and on the CPU with ``CVST_FASTPATH=1``) the engine first
offers crop, crop_and_pad and expand calls to the zero-sync fast path
(``classic_estimator.fast_path``, models/fastpath.py): the same tracks
and fits, the trajectory on the device, crop_and_pad's estimation
replayed from one CUDA graph.

Under an active mesh the engine hands the estimator frame-sharded grays
(parallel/mesh.py::FrameShards): GFTT (K4, K7), the pyramids and LK
(K6, K5) run over each shard's pairs on the shard's device, with a
one-frame halo for the pair that crosses into the next shard
(parallel/mesh.py::sharded_pairs); the tracks are gathered to the lead
device, where the fits run as without a mesh.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..ops import lk as LK
from ..ops import prng
from ..ops import ransac as RS
from ..utils.device import fetch_packed
from ..utils.video_io import VideoContext
from . import geometry as G
from .stabilize import PairFits, StabilizationResult, chunked_pairs, stabilize_clip

MIN_FEATURES = 12
MIN_TRACKS = 8
PERSP_MIN_RATIO = 0.15
SIM_MIN_RATIO = 0.1


def _fused_classic_fits_device(pts, tracked, status, seed: int, want_persp: bool,
                               n_hyp: int) -> Tuple[torch.Tensor, ...]:
    """Survivor counts, the perspective RANSAC (key salt 0, with
    ``want_persp``), the similarity RANSAC (salt 1) and the median
    translation of every pair, as device tensors in the order the fast
    path's trajectory program unpacks them: survivors, [H, its inliers,
    valid counts,] S, its inliers, valid counts, T."""
    b = pts.shape[0]
    dev = pts.device

    def keys(salt):
        return prng.fold_in(prng.PRNGKey(seed + salt, device=dev), torch.arange(b, device=dev))

    out = [status.sum(1)]
    if want_persp:
        out += list(RS.ransac_fit(keys(0), pts, tracked, status, "perspective", n_hyp, RS.PERSP_THRESH))
    out += list(RS.ransac_fit(keys(1), pts, tracked, status, "similarity", n_hyp, RS.SIM_THRESH))
    med = RS.masked_median_shift(pts, tracked, status)
    T = torch.eye(3, dtype=torch.float32, device=dev).repeat(b, 1, 1)
    T[:, 0, 2] = med[:, 0]
    T[:, 1, 2] = med[:, 1]
    out.append(T)
    return tuple(out)


def _tracks(grays: torch.Tensor):
    """GFTT on the leading frames, the clip pyramid, LK over all pairs."""
    pts, det_counts = LK.gftt_batch(grays[:-1])
    pyr = LK.gaussian_pyramid(grays)
    tracked, status = LK.lk_track([lvl[:-1] for lvl in pyr], [lvl[1:] for lvl in pyr],
                                  pts, det_counts)
    return pts, det_counts, tracked, status


def _tracks_and_fits(grays, tick_pairs, seed: int, want_persp: bool,
                     n_hyp: int = RS.DEFAULT_HYPOTHESES, per_chunk=None):
    """((pts, det_counts, tracked, status), fits) on the device, with no
    host read: the tracks of every pair by ``per_chunk`` (:func:`_tracks`
    when None) through the shared chunk loop (models/stabilize.py::
    chunked_pairs; GFTT is per frame and LK per pair, so the chunks equal
    one whole-clip call), then the fits of
    :func:`_fused_classic_fits_device`."""
    pts, det_counts, tracked, status = chunked_pairs(grays, per_chunk or _tracks, tick_pairs)
    fits = _fused_classic_fits_device(pts, tracked, status, seed, want_persp, n_hyp)
    return (pts, det_counts, tracked, status), fits


def _classic_estimate_fused(grays: torch.Tensor, seed: int, want_persp: bool, n_hyp: int):
    """The JAX package's whole-clip program under its name: (pts,
    det_counts, tracked, status) + the fits, with no observer."""
    tracks, fits = _tracks_and_fits(grays, None, seed, want_persp, n_hyp)
    return tracks + fits


def _fetch_fits(det_counts: torch.Tensor, fits, want_persp: bool) -> Dict[str, np.ndarray]:
    """The detected counts and the fits to the host in ONE copy, as numpy
    arrays keyed det, surv, [H, nH, vH,] S, nS, vS, T (the host engine's
    one read of the estimation)."""
    names = ("det", "surv") + (("H", "nH", "vH") if want_persp else ()) + ("S", "nS", "vS", "T")
    return fetch_packed(dict(zip(names, (det_counts,) + tuple(fits))))


def classic_estimator(grays: torch.Tensor, requested_mode: str, *, seed: int = 0,
                      decimation: int = 1, tick_pairs=None) -> PairFits:
    """Per-pair fits from GFTT + LK tracks; grays (N, h, w) on the working device.

    Classic estimates at the working size itself: ``decimation`` is
    accepted from the engine and must be 1.
    """
    if decimation != 1:
        raise ValueError(f"the Classic estimator takes no gray decimation, got {decimation}")
    b = grays.shape[0] - 1
    want_persp = requested_mode == "perspective"
    (_, det_counts, _, _), fits = _tracks_and_fits(grays, tick_pairs, seed, want_persp)
    fused = _fetch_fits(det_counts, fits, want_persp)
    det_counts = fused["det"]
    surv = fused["surv"]
    matrices: Dict[str, np.ndarray] = {}
    confidences: Dict[str, np.ndarray] = {}
    accepted: Dict[str, np.ndarray] = {}
    for mode, key, min_points, min_ratio in (("perspective", "H", 4, PERSP_MIN_RATIO),
                                             ("similarity", "S", 3, SIM_MIN_RATIO)):
        if key not in fused:
            continue
        M, n_in, n_valid = fused[key], fused["n" + key], fused["v" + key]
        conf = np.where(n_valid > 0, n_in / np.maximum(n_valid, 1), 0.0)
        matrices[mode] = M
        confidences[mode] = conf
        accepted[mode] = np.isfinite(M).all(axis=(1, 2)) & (surv >= min_points) & (conf >= min_ratio)
    matrices["translation"] = fused["T"]
    confidences["translation"] = np.where(det_counts > 0, surv / np.maximum(det_counts, 1), 0.0)
    accepted["translation"] = np.ones(b, bool)
    return PairFits(
        degenerate=(det_counts < MIN_FEATURES) | (surv < MIN_TRACKS),
        matrices=matrices,
        confidences=confidences,
        accepted=accepted,
        residuals=None,
    )


def _classic_fast_path(*args, **kwargs):
    """Engine hook: the device pipeline for crop / crop_and_pad / expand
    (models/fastpath.py); None leaves the call to the host engine."""
    from . import fastpath

    return fastpath.offer("classic", *args, **kwargs)


classic_estimator.fast_path = _classic_fast_path


def stabilize_classic(
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
    """Classic stabilizer on ``device`` ('cuda' by default; 'cpu' runs the plain versions)."""
    return stabilize_clip(
        context,
        estimator=classic_estimator,
        source_name="estimated_classic",
        framing_mode=framing_mode,
        transform_mode=transform_mode,
        camera_lock=camera_lock,
        strength=strength,
        smooth=smooth,
        keep_fov=keep_fov,
        padding_rgb=padding_rgb,
        frame_rate=frame_rate,
        progress=progress,
        interrupt_check=interrupt_check,
        device=device,
    )
