"""Stabilization engine (host trajectory, device pixels).

Counterpart of the host engine of
``comfyui_video_stabilizer_tpu/models/stabilize.py``:

  1. fps resolution + empty/single-frame early-outs
  2. grayscale at <=960 px working size, on the device
  3. estimator: per-pair fits for the whole fallback chain, all pairs
     batched, in 32-pair chunks with a progress tick and interrupt poll
     between chunks when anyone observes them; an exception raised by a
     tick reaches the caller as itself (``EstimationInterrupted``)
  4. sticky mode selection (host scan over per-pair acceptance flags)
  5. path integration, 6. target path (camera_lock or fps smoothing)
  7. framing: crop (keep_fov solver + no-padding refine, models/
     framing.py), crop_and_pad (recenter) or expand (union canvas)
  8. one batched warp (K1) + closed-form padding masks, on the device
  9. meta assembly + motion_meta v2 attach

Geometry and motion_meta are the port's copies of the JAX package's
host modules (numpy, the same code), so the meta contract is
identical.

Before step 2 the engine offers crop, crop_and_pad and expand calls to
the estimator's ``fast_path`` (models/fastpath.py), as the JAX engine
does: steps 2-8 on the device with one diagnostics fetch, returning the
host values the meta assembly below needs.  It runs by default on CUDA
frames (``CVST_FASTPATH=0/1`` overrides); when it declines or gives up
(None), the host engine above runs the call.

A clip whose warp-stage live set exceeds ``ops/warp.py``'s
``CHUNK_BUDGET_BYTES`` is never uploaded whole: its grays are made 16
frames at a time and its warp and masks stream through time chunks, as
the JAX package's engine does; the result's frames and masks are then
host (CPU) tensors, where an unstreamed result's stay on the device.

Under an active mesh (utils/meshinfo.py; parallel/production.py sets
one) the same code runs by shard: a frame-sharded clip
(parallel/mesh.py::FrameShards) makes its grays on each shard, the
estimator runs each shard's pairs there (parallel/mesh.py::
sharded_pairs) and
fits on the lead device, the trajectory stays on the host, and the warp
and padding stats run on each shard (ops/warp.py); a clip the data axis
does not split evenly estimates on the lead device and, in the "rows"
outcome, warps one band of output rows a device.  The frames and masks
then come back as FrameShards.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from ..meta.motion_meta import (
    applied_motion_meta_from_stabilization_warp,
    build_stabilization_warp_meta,
)
from ..ops import resize as R
from ..ops import warp as W
from ..parallel.mesh import FrameShards, sharded_pairs
from ..utils import profiling as P
from ..utils.device import resolve_device, strict_fp32
from ..utils.video_io import VideoContext
from . import framing as F
from . import geometry as G

logger = logging.getLogger(__name__)

ProgressCallback = Callable[[int, int], None]  # (done, total)
InterruptCheck = Callable[[], None]

MODE_PRIORITY: Dict[str, List[str]] = {
    "perspective": ["perspective", "similarity", "translation"],
    "similarity": ["similarity", "translation"],
    "translation": ["translation"],
}

# Estimation dispatch granularity: pairs per chunk, with a progress
# tick + interrupt poll between chunks.
ESTIMATION_CHUNK_PAIRS = 32


class EstimationInterrupted(BaseException):
    """An exception raised by a progress tick inside estimation, carried
    past the estimator's backend chain.

    The Flow estimator degrades DIS -> TV-L1 -> phase correlation on
    ``except Exception``; a cancellation raised in a tick must not pass
    for a failed backend, so the engine's tick re-raises it as this
    BaseException and the engine unwraps it around the estimator call.
    """

    @property
    def original(self) -> BaseException:
        return self.args[0]


def estimation_chunk_spans(n_frames: int, chunk: int = ESTIMATION_CHUNK_PAIRS):
    """Frame-slice plan [(start, end, drop_leading_pairs)] covering all
    n_frames-1 adjacent pairs in ``chunk``-pair chunks.

    Every chunk spans chunk+1 frames; the last one is anchored at the
    clip's end and overlaps its predecessor, with the duplicated leading
    pairs dropped, so each pair is estimated from the same inputs as in
    one whole-clip dispatch.
    """
    b = n_frames - 1
    if b <= chunk:
        return [(0, n_frames, 0)]
    spans = []
    s = 0
    while s + chunk < b:
        spans.append((s, s + chunk + 1, 0))
        s += chunk
    start = b - chunk
    spans.append((start, n_frames, s - start))
    return spans


def _cat(parts):
    """Per-chunk results joined along the pair axis: tensors, or tuples of
    tensors element by element."""
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(xs, dim=0) for xs in zip(*parts))
    return torch.cat(parts, dim=0)


def chunked_pairs(grays, per_chunk, tick_pairs):
    """``per_chunk(frames)`` over every adjacent pair of ``grays``: in the
    chunks of :func:`estimation_chunk_spans`, the leading pairs a chunk
    recomputes dropped and ``tick_pairs(end - 1)`` after each, the results
    (a tensor, or a tuple of tensors, per pair along dim 0) concatenated.
    An estimator's work is per pair, so this equals one whole-clip
    dispatch, which runs when nobody observes (no ``tick_pairs``) or the
    clip is one chunk.  Frame-sharded grays run by shard
    (parallel/mesh.py::sharded_pairs), gathered to the lead device."""
    if isinstance(grays, FrameShards):
        return _cat(sharded_pairs(grays, lambda g, tick: chunked_pairs(g, per_chunk, tick), tick_pairs))
    spans = estimation_chunk_spans(int(grays.shape[0]))
    if tick_pairs is None or len(spans) == 1:
        return per_chunk(grays)
    parts = []
    for s, e, drop in spans:
        part = per_chunk(grays[s:e])
        if drop:
            part = tuple(x[drop:] for x in part) if isinstance(part, tuple) else part[drop:]
        parts.append(part)
        tick_pairs(e - 1)
    return _cat(parts)


@dataclass
class PairFits:
    """Batched per-pair estimation results for the full fallback chain
    (host numpy arrays of length B = N - 1)."""

    degenerate: np.ndarray
    matrices: Dict[str, np.ndarray]
    confidences: Dict[str, np.ndarray]
    accepted: Dict[str, np.ndarray]
    residuals: Dict[str, np.ndarray] | None = None
    extra_meta: Dict[str, Any] = field(default_factory=dict)


@dataclass
class StabilizationResult:
    frames: torch.Tensor | FrameShards | List[torch.Tensor]
    masks: torch.Tensor | FrameShards | List[torch.Tensor]
    meta: Dict[str, Any]


Estimator = Callable[..., PairFits]
# (gray_frames (N, h, w) tensor, requested_mode, **kw) -> PairFits


def sticky_select(requested_mode: str, fits: PairFits) -> Tuple[np.ndarray, List[str], List[float], List[float] | None]:
    """The reference's loop-carried mode degradation.

    active_mode starts at the requested mode; each pair tries the
    fallback chain from the *current* active mode and the first
    accepted model wins; a pair whose winning mode differs from
    active_mode re-points active_mode for all later pairs.
    """
    b = fits.degenerate.shape[0]
    out_mats = np.tile(np.eye(3, dtype=np.float32), (b, 1, 1))
    out_modes: List[str] = []
    out_confs: List[float] = []
    out_res: List[float] | None = [] if fits.residuals is not None else None

    active = requested_mode
    for i in range(b):
        if fits.degenerate[i]:
            used, conf, res = "translation", 0.0, 0.0
            mat = np.eye(3, dtype=np.float32)
        else:
            used = None
            for mode in MODE_PRIORITY[active]:
                if mode in fits.accepted and fits.accepted[mode][i]:
                    used = mode
                    mat = fits.matrices[mode][i]
                    conf = float(fits.confidences[mode][i])
                    res = float(fits.residuals[mode][i]) if fits.residuals is not None else 0.0
                    break
            if used is None:
                used, conf, res = "translation", 0.0, 0.0
                mat = np.eye(3, dtype=np.float32)
        if used != active:
            active = used
        out_mats[i] = mat
        out_modes.append(used)
        out_confs.append(conf)
        if out_res is not None:
            out_res.append(res)
    return out_mats, out_modes, out_confs, out_res


def estimation_plan(width: int, height: int, estimator: Estimator) -> Tuple[Tuple[int, int] | None, int]:
    """(working size or None, gray decimation) the engine estimates at."""
    working_size = G.working_estimation_size(width, height)
    dec_fn = getattr(estimator, "gray_decimation", None)
    decimation = dec_fn(width, height, working_size) if dec_fn is not None else 1
    return working_size, decimation


def _resolve_fps_pair(frame_rate: float, context_fps) -> Tuple[float, float | None]:
    fps_candidate = frame_rate
    if not isinstance(fps_candidate, (int, float)) or not np.isfinite(fps_candidate) or fps_candidate <= 0.0:
        fps_candidate = (
            context_fps
            if isinstance(context_fps, (int, float)) and np.isfinite(context_fps) and context_fps > 0.0
            else 16.0
        )
    fps_effective = float(max(1.0, fps_candidate))
    fps_requested = float(frame_rate) if isinstance(frame_rate, (int, float)) and frame_rate > 0.0 else None
    return fps_effective, fps_requested


def stabilize_clip(
    context: VideoContext,
    *,
    estimator: Estimator,
    source_name: str,
    framing_mode: G.FramingMode,
    transform_mode: G.TransformMode,
    camera_lock: bool,
    strength: float,
    smooth: float,
    keep_fov: float,
    padding_rgb: Tuple[int, int, int],
    frame_rate: float,
    extra_meta: Dict[str, Any] | None = None,
    progress: ProgressCallback | None = None,
    interrupt_check: InterruptCheck | None = None,
    device: str | torch.device = "cuda",
) -> StabilizationResult:
    dev = resolve_device(device)
    with P.span("engine.call", dev) as call:
        result = _stabilize_clip(
            context, dev, estimator=estimator, source_name=source_name, framing_mode=framing_mode,
            transform_mode=transform_mode, camera_lock=camera_lock, strength=strength, smooth=smooth,
            keep_fov=keep_fov, padding_rgb=padding_rgb, frame_rate=frame_rate, extra_meta=extra_meta,
            progress=progress, interrupt_check=interrupt_check,
        )
    # the call's root when no node is above it: its spans whose events have
    # completed (the rest stay in the ring for profiling.drain())
    P.attach(result.meta, call)
    return result


def _stabilize_clip(
    context: VideoContext,
    dev: torch.device,
    *,
    estimator: Estimator,
    source_name: str,
    framing_mode: G.FramingMode,
    transform_mode: G.TransformMode,
    camera_lock: bool,
    strength: float,
    smooth: float,
    keep_fov: float,
    padding_rgb: Tuple[int, int, int],
    frame_rate: float,
    extra_meta: Dict[str, Any] | None,
    progress: ProgressCallback | None,
    interrupt_check: InterruptCheck | None,
) -> StabilizationResult:
    strict_fp32()
    total_frames = context.frame_count
    width, height = context.width, context.height
    channels = int(context.frames.shape[-1])
    # a clip that streams stays where it is; the warp uploads it chunk by chunk
    streams_in = W.will_stream(total_frames, height, width, height, width, channels)
    if streams_in or isinstance(context.frames, FrameShards):
        frames = context.frames  # streamed chunk by chunk, or already on its shards
    else:
        frames = context.frames.to(dev)
    fps_effective, fps_requested = _resolve_fps_pair(frame_rate, context.fps)
    extra_meta = dict(extra_meta or {})

    def _attach_motion_meta(meta: Dict[str, Any]) -> Dict[str, Any]:
        try:
            meta["motion_meta"] = applied_motion_meta_from_stabilization_warp(
                meta["stabilization_warp"], fps=fps_effective, source=source_name
            )
        except (KeyError, TypeError, ValueError, np.linalg.LinAlgError):
            logger.debug("Failed to derive motion_meta from stabilization_warp.", exc_info=True)
        return meta

    def _tick(done: int, total: int) -> None:
        if progress is not None:
            progress(done, total)
        if interrupt_check is not None:
            interrupt_check()

    estimation_steps = max(0, total_frames - 1)
    progress_total = estimation_steps + total_frames

    if total_frames == 0:
        meta = {
            "frames": 0,
            "note": "Empty frame sequence; nothing to stabilise.",
            "transform_mode_requested": transform_mode,
            "transform_mode_applied": "identity",
            "camera_lock": camera_lock,
            "strength": strength,
            "strength_effective": 0.0,
            "smooth": smooth,
            "fps_requested": fps_requested,
            "fps_effective": fps_effective,
            "framing": {
                "mode": framing_mode,
                "input_size": [width, height],
                "padding_color_rgb": [int(c) for c in padding_rgb],
            },
            "keep_fov_applied": False,
            "padding_color_rgb": [int(c) for c in padding_rgb],
            **extra_meta,
            "stabilization_warp": build_stabilization_warp_meta(
                source_size=(width, height),
                output_size=(width, height),
                framing_mode=framing_mode,
                applied_matrices=[],
            ),
            "estimated_motion": {"per_transition": [], "path": [], "target_path": [], "target_path_effective": []},
            "padding_fraction_mean": 0.0,
            "padding_fraction_max": 0.0,
        }
        return StabilizationResult([], [], _attach_motion_meta(meta))

    if total_frames == 1:
        zero_mask = torch.zeros((1, height, width), dtype=torch.float32, device=dev)
        meta = {
            "frames": 1,
            "note": "Single-frame input; bypassed stabilization.",
            "transform_mode": transform_mode,
            "framing_mode": framing_mode,
            **extra_meta,
            "stabilization_warp": build_stabilization_warp_meta(
                source_size=(width, height),
                output_size=(width, height),
                framing_mode=framing_mode,
                applied_matrices=[np.eye(3, dtype=np.float32)],
            ),
            "fps_requested": fps_requested,
            "fps_effective": fps_effective,
        }
        _tick(progress_total, progress_total)
        return StabilizationResult(frames.clone(), zero_mask, _attach_motion_meta(meta))

    # ---- estimation at working resolution (batched, on the device) ----
    working_size, decimation = estimation_plan(width, height, estimator)
    base_mode = transform_mode

    def _tick_pairs(done_pairs: int) -> None:
        try:
            _tick(min(int(done_pairs), estimation_steps), progress_total)
        except BaseException as exc:
            raise EstimationInterrupted(exc) from exc

    # chunked dispatch only when an observer exists
    tick_pairs_cb = _tick_pairs if (progress is not None or interrupt_check is not None) else None

    fast = None
    fast_fn = getattr(estimator, "fast_path", None)
    if fast_fn is not None and framing_mode in ("crop", "crop_and_pad", "expand"):
        try:
            fast = fast_fn(
                frames, framing_mode, transform_mode, camera_lock, strength, smooth,
                fps_effective, (width, height), working_size, decimation, padding_rgb,
                tick_pairs=tick_pairs_cb, keep_fov=keep_fov,
            )
        except EstimationInterrupted as ei:
            raise ei.original
    if fast is not None:
        matrices = fast["matrices"]
        modes_used = fast["modes_used"]
        confidences = fast["confidences"]
        residuals = fast["residuals"]
        extra_meta.update(fast["extra_meta"])
        active_mode = modes_used[-1] if modes_used else transform_mode
        _tick(estimation_steps, progress_total)
        strength = fast["strength"]
        smooth = fast["smooth"]
        path = fast["path"]
        target_path = fast["target_path"]
        delta_params_full = fast["diffs"]
    else:
        with P.span("engine.gray", dev):
            grays = R.gray_for_estimation(frames, working_size, decimation=decimation, device=dev)
        with P.span("engine.estimate", dev):
            try:
                fits = estimator(grays, transform_mode, decimation=decimation, tick_pairs=tick_pairs_cb)
            except EstimationInterrupted as ei:
                raise ei.original
        del grays
        matrices, modes_used, confidences, residuals = sticky_select(transform_mode, fits)
        if working_size is not None:
            matrices = G.rescale_transforms_to_full(matrices, (width, height), working_size)
        extra_meta.update(fits.extra_meta)
        active_mode = modes_used[-1] if modes_used else transform_mode
        _tick(estimation_steps, progress_total)

        delta_params = G.matrices_to_params(matrices, base_mode)
        path = G.integrate_path(delta_params)

        strength = float(np.clip(strength, 0.0, 1.0))
        smooth = float(np.clip(smooth, 0.0, 1.0))

        if camera_lock:
            smooth = max(smooth, 0.85)
            target_path = np.zeros_like(path)
        else:
            smoothed = G.smooth_path(path, smooth, fps_effective)
            target_path = path + strength * (smoothed - path)

        delta_params_full = target_path - path
    keep_fov_clamped = float(np.clip(keep_fov, 0.0, 1.0))
    keep_fov_applied = framing_mode == "crop" and keep_fov_clamped > 1e-6
    stabilization_scale = 1.0
    output_size = (width, height)

    if framing_mode == "crop":
        if keep_fov_clamped >= 0.9999:
            meta = {
                "frames": total_frames,
                "note": "keep_fov~=1.0 in crop mode; returning original frames.",
                "transform_mode_requested": transform_mode,
                "transform_mode_applied": "identity",
                "camera_lock": camera_lock,
                "strength": strength,
                "strength_effective": 0.0,
                "smooth": smooth,
                "fps_requested": fps_requested,
                "fps_effective": fps_effective,
                "framing": {
                    "mode": framing_mode,
                    "input_size": [width, height],
                    "keep_fov_requested": keep_fov_clamped,
                    "keep_fov_effective": 1.0,
                    "min_content_ratio": 1.0,
                    "padding_color_rgb": [int(c) for c in padding_rgb],
                    "stabilization_scale": 0.0,
                },
                "keep_fov_applied": False,
                **extra_meta,
                "stabilization_warp": build_stabilization_warp_meta(
                    source_size=(width, height),
                    output_size=(width, height),
                    framing_mode=framing_mode,
                    applied_matrices=[np.eye(3, dtype=np.float32)] * total_frames,
                ),
                "estimated_motion": {
                    "per_transition": [],
                    "path": path.tolist(),
                    "target_path": target_path.tolist(),
                    "target_path_effective": path.tolist(),
                },
                "padding_fraction_mean": 0.0,
                "padding_fraction_max": 0.0,
            }
            _tick(progress_total, progress_total)
            if isinstance(frames, FrameShards):
                return StabilizationResult(
                    frames.map(torch.clone),
                    frames.map(lambda f: torch.zeros(f.shape[:3], dtype=torch.float32, device=f.device)),
                    _attach_motion_meta(meta),
                )
            zero_masks = torch.zeros((total_frames, height, width), dtype=torch.float32, device=frames.device)
            return StabilizationResult(frames.clone(), zero_masks, _attach_motion_meta(meta))

        if fast is not None:
            # the keep_fov search and the no-padding refine ran on the
            # device (models/fastpath.py); the statuses were rebuilt there
            apply_matrices = fast["apply_matrices"]
            final_matrices = fast["final_matrices"]
            keep_fov_status = fast["keep_fov_status"]
            keep_fov_note = fast["keep_fov_note"]
            keep_fov_effective_value = fast["keep_fov_effective"]
            stabilization_scale = fast["stabilization_scale"]
            crop_origin = list(fast["crop_origin"])
            crop_size = list(fast["crop_size"])
        else:
            with P.span("engine.framing", dev):
                safety_margin_px = max(0.5, 0.02 * max(width, height))
                (
                    final_matrices,
                    apply_matrices,
                    keep_fov_effective_value,
                    keep_fov_status,
                    keep_fov_note,
                    stabilization_scale,
                    crop_origin,
                    crop_size,
                ) = F.compute_crop_with_keep_fov_parametric(
                    base_mode, delta_params_full, width, height, keep_fov_clamped, safety_margin_px, dev,
                    interrupt_check=interrupt_check,
                )
                final_matrices, crop_origin, crop_size, keep_fov_effective_value = F.refine_no_padding_crop(
                    final_matrices, width, height, dev, safety_shrink_px=1, interrupt_check=interrupt_check,
                )
    elif fast is not None:
        apply_matrices = fast["apply_matrices"]
        final_matrices = fast["final_matrices"]
    else:
        apply_matrices = G.params_to_matrices(delta_params_full, base_mode)
    if fast is not None:
        mins, maxs = fast["mins"], fast["maxs"]
    else:
        mins, maxs = G.compute_bounding_boxes(apply_matrices, width, height)

    framing_meta: Dict[str, Any] = {
        "mode": framing_mode,
        "input_size": [width, height],
        "padding_color_rgb": [int(c) for c in padding_rgb],
        "min_content_ratio": G.min_content_ratio(mins, maxs, width, height),
    }
    if framing_mode == "crop":
        framing_meta.update(
            {
                "keep_fov_status": keep_fov_status,
                "keep_fov_effective": keep_fov_effective_value,
                "crop_origin": list(crop_origin),
                "crop_size": list(crop_size),
                "actual_content_ratio": keep_fov_effective_value,
                "stabilization_scale": float(stabilization_scale),
            }
        )
        if keep_fov_applied:
            framing_meta["keep_fov_requested"] = keep_fov_clamped
        if keep_fov_note:
            framing_meta["keep_fov_note"] = keep_fov_note
    elif framing_mode == "crop_and_pad":
        x0, y0, x1, y1 = G.intersection_box(mins, maxs)
        intersection_w = max(1.0, x1 - x0)
        intersection_h = max(1.0, y1 - y0)
        if fast is not None:
            offset_x, offset_y = fast["center_offset"]
        else:
            offset_x = width * 0.5 - (x0 + x1) * 0.5
            offset_y = height * 0.5 - (y0 + y1) * 0.5
            translate = G.translation_matrix(offset_x, offset_y).astype(np.float64)
            final_matrices = np.einsum(
                "ij,njk->nik", translate, np.asarray(apply_matrices, np.float64)
            ).astype(np.float32)
        framing_meta.update(
            {
                "safe_region_origin": [x0, y0],
                "safe_region_size": [intersection_w, intersection_h],
                "actual_content_ratio": min(intersection_w / width, intersection_h / height),
                "center_offset": [offset_x, offset_y],
            }
        )
    elif framing_mode == "expand":
        if fast is not None:
            # the union canvas and its translation were composed on the device
            output_size = fast["output_size"]
        else:
            translate, output_size = G.prepare_expand_transform(mins, maxs)
            final_matrices = np.einsum(
                "ij,njk->nik", translate.astype(np.float64), np.asarray(apply_matrices, np.float64)
            ).astype(np.float32)
        framing_meta["expanded_size"] = list(output_size)
    else:
        raise ValueError(f"Unknown framing_mode {framing_mode!r}.")

    effective_diffs = (
        G.matrices_to_params(apply_matrices, base_mode) if framing_mode == "crop" else delta_params_full
    )
    stabilization_scale = float(np.clip(stabilization_scale, 0.0, 1.0))
    strength_effective = strength * stabilization_scale
    effective_target_path = path + effective_diffs

    # ---- warp pass: one batched kernel + closed-form masks ----
    border = np.asarray(padding_rgb, np.float32) / 255.0
    if W.will_stream(total_frames, height, width, int(output_size[1]), int(output_size[0]), channels):
        frames = context.frames  # drop the engine's own upload, if any: the warp streams
    if fast is not None:
        # queued (and its ratios fetched) by the fast path
        stabilized, padding_masks = fast["stabilized"], fast["padding_masks"]
        padded_ratios = fast["padded_ratios"]
    else:
        with P.span("engine.warp", dev):
            # unstreamed, the ratio fetch waits for the mask pass only; the
            # frame warp is queued after it and runs while the host
            # assembles the meta
            stabilized, padding_masks, ratios = W.warp_clip_with_mask(
                frames, final_matrices, output_size, "bilinear", border, device=dev
            )
            padded_ratios = ratios.cpu().numpy()
    framing_meta["padding_detected"] = bool((padded_ratios > 0).any())
    _tick(progress_total, progress_total)
    with P.span("engine.meta"):
        per_transition = []
        for idx, (mode, confidence) in enumerate(zip(modes_used, confidences)):
            entry = {
                "index": idx,
                "mode": mode,
                "confidence": confidence,
                "matrix": matrices[idx].astype(np.float32).tolist(),
            }
            if residuals is not None:
                entry["residual"] = residuals[idx]
            per_transition.append(entry)

        meta = {
            "frames": total_frames,
            "transform_mode_requested": transform_mode,
            "transform_mode_applied": active_mode,
            "camera_lock": camera_lock,
            "strength": strength,
            "strength_effective": strength_effective,
            "smooth": smooth,
            "fps_requested": fps_requested,
            "fps_effective": fps_effective,
            "framing": framing_meta,
            "keep_fov_applied": keep_fov_applied,
            "padding_color_rgb": [int(c) for c in padding_rgb],
            **extra_meta,
            "stabilization_warp": build_stabilization_warp_meta(
                source_size=(width, height),
                output_size=output_size,
                framing_mode=framing_mode,
                applied_matrices=final_matrices,
            ),
            "estimated_motion": {
                "per_transition": per_transition,
                "path": path.tolist(),
                "target_path": target_path.tolist(),
                "target_path_effective": effective_target_path.tolist(),
            },
            "padding_fraction_mean": float(padded_ratios.mean()),
            "padding_fraction_max": float(padded_ratios.max()),
        }
        meta = _attach_motion_meta(meta)
    return StabilizationResult(stabilized, padding_masks, meta)
