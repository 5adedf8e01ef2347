"""Framing solvers: the keep_fov crop search and the no-padding refine.

Counterpart of ``comfyui_video_stabilizer_tpu/models/framing.py``.  The
18-iteration binary search over the stabilization scale is host numpy
(corner projections only), as there.  Every mask pass is a closed-form
coverage computation on ``device`` (``ops/warp.py``), taken a mask
chunk at a time: the 3x3 close and the bounding boxes run there and
only the per-frame boxes, and the refine's (H, W) common mask, come to
the host.  The engine discards the content masks the JAX functions can
return, so these return none; the rest of each result, the status
strings and notes included, is the JAX package's.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from ..ops import morphology as M
from ..ops import warp as W
from . import geometry as G

InterruptCheck = Callable[[], None] | None


def scale_deltas_parametric(
    base_mode: G.TransformMode,
    deltas: np.ndarray,
    scale: float,
) -> np.ndarray:
    """Per-frame parameter deltas scaled by ``scale`` -> (N, 3, 3)."""
    scale = float(np.clip(scale, 0.0, 1.0))
    return G.params_to_matrices(np.asarray(deltas, np.float64) * scale, base_mode)


def _closed_content_masks(matrices: np.ndarray, width: int, height: int,
                          device: torch.device | str) -> torch.Tensor:
    """Binary content masks of the final matrices with a 3x3 close, on ``device``."""
    cover = W.coverage_mask(matrices, (width, height), (width, height), device)
    return M.erode(M.dilate(cover, 1), 1)


def _masked_min_ratio(matrices: np.ndarray, width: int, height: int,
                      device: torch.device | str) -> float:
    """Smallest per-frame content-box ratio of the closed content masks,
    computed a mask chunk at a time (the close is per frame)."""
    chunk = W._mask_chunk(height, width)
    boxes = [M.content_bboxes(_closed_content_masks(matrices[s:s + chunk], width, height, device))
             for s in range(0, matrices.shape[0], chunk)]
    if not boxes:
        return 1.0
    x_min, y_min, x_max, y_max = (np.concatenate(b) for b in zip(*boxes))
    ratios = np.where(
        x_max >= 0,
        np.minimum(
            np.maximum(1.0, x_max - x_min + 1.0) / width,
            np.maximum(1.0, y_max - y_min + 1.0) / height,
        ),
        0.0,
    )
    return float(ratios.min()) if ratios.size else 1.0


def compute_crop_with_keep_fov_parametric(
    base_mode: G.TransformMode,
    delta_params: np.ndarray,
    width: int,
    height: int,
    keep_fov_target: float,
    safety_margin_px: float,
    device: torch.device | str,
    max_iterations: int = 18,
    interrupt_check: InterruptCheck = None,
) -> Tuple[
    np.ndarray,  # final matrices (crop pre-multiplied)
    np.ndarray,  # pre-crop apply matrices
    float,  # effective keep_fov ratio
    str,  # status: met | clamped | failed | disabled
    str | None,  # note
    float,  # stabilization scale
    List[float],  # crop origin
    List[float],  # crop size
]:
    """Binary-search the stabilization scale satisfying ``keep_fov``.

    Scale s in [0, 1] multiplies the correction deltas; for each
    candidate the intersection of warped bounds (minus a safety margin
    capped at 25% of the safe region) yields an aspect-preserving
    centred crop whose ratio is compared to the target.
    """
    keep_fov_clamped = float(np.clip(keep_fov_target, 0.0, 1.0))
    target_ratio = keep_fov_clamped
    eps = 1e-4

    def evaluate_bbox_only(scale: float) -> Tuple[float, Dict[str, object]]:
        if interrupt_check is not None:
            interrupt_check()
        mats = scale_deltas_parametric(base_mode, delta_params, scale)
        mins, maxs = G.compute_bounding_boxes(mats, width, height)
        x0, y0, x1, y1 = G.intersection_box(mins, maxs)
        safe_w = max(0.0, x1 - x0)
        safe_h = max(0.0, y1 - y0)
        margin = min(safety_margin_px, safe_w * 0.25, safe_h * 0.25)
        safe_x0 = x0 + margin
        safe_y0 = y0 + margin
        safe_w = max(0.0, safe_w - 2.0 * margin)
        safe_h = max(0.0, safe_h - 2.0 * margin)

        if safe_w <= 0.0 or safe_h <= 0.0:
            return 0.0, {
                "scale": scale,
                "pre_crop": mats,
                "final": mats,
                "crop_origin": [0.0, 0.0],
                "crop_size": [float(width), float(height)],
                "has_overlap": False,
            }

        crop_ratio = min(1.0, safe_w / width, safe_h / height)
        crop_w = width * crop_ratio
        crop_h = height * crop_ratio
        crop_x0 = safe_x0 + (safe_w - crop_w) * 0.5
        crop_y0 = safe_y0 + (safe_h - crop_h) * 0.5
        crop_scale = width / crop_w  # one uniform scale keeps the aspect
        crop_matrix = np.array(
            [
                [crop_scale, 0.0, -crop_scale * crop_x0],
                [0.0, crop_scale, -crop_scale * crop_y0],
                [0.0, 0.0, 1.0],
            ],
            dtype=np.float64,
        )
        final_mats = np.einsum("ij,njk->nik", crop_matrix, mats.astype(np.float64)).astype(np.float32)
        return crop_ratio, {
            "scale": scale,
            "pre_crop": mats,
            "final": final_mats,
            "crop_origin": [crop_x0, crop_y0],
            "crop_size": [crop_w, crop_h],
            "has_overlap": True,
        }

    def finalize_with_masks(candidate: Dict[str, object]) -> Dict[str, object]:
        if interrupt_check is not None:
            interrupt_check()
        out = dict(candidate)
        out["ratio_final"] = _masked_min_ratio(np.asarray(candidate["final"]), width, height, device)
        return out

    def result(cand, raw, status, note, scale):
        return (
            np.asarray(cand["final"]),
            np.asarray(raw["pre_crop"]),
            cand["ratio_final"],
            status,
            note,
            scale,
            list(cand["crop_origin"]),
            list(cand["crop_size"]),
        )

    ratio_full, raw_full = evaluate_bbox_only(1.0)
    if keep_fov_clamped <= eps:
        if bool(raw_full["has_overlap"]):
            raw = raw_full
            stabilization_scale = 1.0
            note = None
        else:
            _, raw = evaluate_bbox_only(0.0)
            stabilization_scale = 0.0
            note = "No common crop region at full stabilization; stabilization was disabled."
        return result(finalize_with_masks(raw), raw, "disabled", note, stabilization_scale)

    if ratio_full >= target_ratio - eps:
        return result(finalize_with_masks(raw_full), raw_full, "met", None, 1.0)

    low, high = 0.0, 1.0
    best_candidate: Dict[str, object] | None = None
    for _ in range(max_iterations):
        mid = 0.5 * (low + high)
        ratio_mid, raw_mid = evaluate_bbox_only(mid)
        if ratio_mid >= target_ratio - eps:
            best_candidate = raw_mid
            low = mid
        else:
            high = mid

    if best_candidate is None:
        _, raw_zero = evaluate_bbox_only(0.0)
        note = f"keep_fov target {keep_fov_clamped:.3f} could not be satisfied even with zero stabilisation."
        return result(finalize_with_masks(raw_zero), raw_zero, "failed", note, 0.0)

    cand = finalize_with_masks(best_candidate)
    status = "met" if cand["ratio_final"] >= target_ratio - eps else "clamped"
    note = None
    scale_best = float(best_candidate["scale"])
    if status == "clamped":
        note = (
            f"keep_fov target {keep_fov_clamped:.3f} reduced to {cand['ratio_final']:.3f} "
            f"at stabilisation scale {scale_best:.3f}."
        )
    return result(cand, best_candidate, status, note, scale_best)


def refine_no_padding_crop(
    final_matrices: np.ndarray,
    width: int,
    height: int,
    device: torch.device | str,
    safety_shrink_px: int = 1,
    interrupt_check: InterruptCheck = None,
) -> Tuple[np.ndarray, List[float], List[float], float]:
    """Guarantee padding-free crop output.

    The AND of all per-frame coverage masks (a min on ``device``),
    eroded by ``safety_shrink_px``, comes to the host once; the largest
    aspect-preserving all-valid rectangle in it pre-multiplies a uniform
    crop onto every frame matrix.  Returns (matrices, crop origin, crop
    size, effective keep_fov): 1.0 after a crop, 0.0 where no rectangle
    fits and the matrices are returned unchanged.
    """
    final_matrices = np.asarray(final_matrices, np.float64)
    if interrupt_check is not None:
        interrupt_check()
    common = W.common_coverage(final_matrices, (width, height), (width, height), device)
    if safety_shrink_px > 0:
        common = M.erode(common[None], safety_shrink_px)[0]
    common = common.cpu().numpy()  # host copy for the rectangle search

    aspect_crop = M.largest_aspect_ratio_rectangle(common > 0.5, width, height) if common.max() > 0 else None
    if aspect_crop is None:
        return final_matrices.astype(np.float32), [0.0, 0.0], [float(width), float(height)], 0.0

    x0, y0, crop_w, crop_h = aspect_crop
    crop_scale = width / crop_w
    crop_matrix = np.array(
        [
            [crop_scale, 0.0, -crop_scale * x0],
            [0.0, crop_scale, -crop_scale * y0],
            [0.0, 0.0, 1.0],
        ],
        dtype=np.float64,
    )
    refined = np.einsum("ij,njk->nik", crop_matrix, final_matrices).astype(np.float32)
    return refined, [x0, y0], [crop_w, crop_h], 1.0
