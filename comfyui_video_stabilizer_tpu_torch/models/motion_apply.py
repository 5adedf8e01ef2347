"""Motion Apply engine: consume motion_meta, move pixels on the card.

Counterpart of ``comfyui_video_stabilizer_tpu/models/motion_apply.py``:
ONE warp call per clip (K1, or K3 with shutter blur), coverage masks in
closed form, and the crop-mode common-valid mask as a single min over
the coverage stack with one fetch to the host.  Matrices, the crop
search and the expand canvas stay host float64 numpy, as there.

Framing semantics:
  crop_and_pad  warp straight to motion.output_size (``pad`` alias).
  crop          AND all coverage masks -> largest centered aspect crop
                found by a 32-iteration binary search capped at 4x
                zoom; degenerate -> fall back to crop_and_pad and
                record ``framing_fallback``. Masks are all-zero.
  expand        union bounding box -> translated matrices + enlarged
                canvas.
Motion blur: per frame the matrix is lerped toward the next frame's
matrix (last frame extrapolates backwards) over shutter fraction
``motion_blur`` with 3..33 samples; output = mean of sample warps (K3),
soft mask = 1 - mean coverage.  ``motion_blur == 0`` takes the plain
warp (K1), bit-identical to it.

The work runs on ``device`` (default ``"cuda"``, raising without a
card); frames and masks are returned on it, unless the clip's warp
live set exceeds ``ops/warp.py``'s ``CHUNK_BUDGET_BYTES``: then the
clip is never uploaded whole, the warp streams through time chunks and
frames and masks are returned as host (CPU) tensors, as the JAX
package returns host arrays when it streams.  Under an active mesh
(utils/meshinfo.py) the unblurred warp (K1) splits over it as
ops/warp.py::warp_clip says, and frames and masks come back as
FrameShards; the shutter blur (K3) stays on one device, as in the JAX
package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Literal, Tuple

import numpy as np
import torch

from ..meta.motion_meta import (
    MotionMeta,
    motion_meta_from_stabilization_warp,
    resolve_motion_meta,
)
from ..ops import warp as W
from ..parallel.mesh import FrameShards
from ..utils import profiling as P
from ..utils.device import resolve_device
from ..utils.video_io import VideoContext
from . import geometry as G

ApplyFramingMode = Literal["crop_and_pad", "crop", "expand", "pad"]
ApplyInterpolation = Literal["bilinear", "bicubic"]
ProgressCallback = Callable[[], None]


@dataclass
class MotionApplyResult:
    frames: torch.Tensor  # (N, H, W, 3) float32, on the device (the host when streamed)
    masks: torch.Tensor   # (N, H, W) float32, beside the frames
    meta: Dict[str, Any]


def _check_interpolation(interpolation: ApplyInterpolation) -> str:
    if interpolation in ("bilinear", "bicubic"):
        return interpolation
    raise ValueError(f"Unsupported interpolation {interpolation!r}; expected 'bilinear' or 'bicubic'.")


def _validate_context(context: VideoContext, motion: MotionMeta) -> None:
    if (context.width, context.height) != motion.input_size:
        raise ValueError(
            "Input frames must match motion_meta.input_size "
            f"{motion.input_size}, got {(context.width, context.height)}."
        )
    if context.frame_count != motion.frame_count:
        raise ValueError(
            "Frame count mismatch: "
            f"got {context.frame_count} frame(s), metadata has {motion.frame_count} matrix entry/entries."
        )


def resolve_motion_for_context(meta: Dict[str, Any], context: VideoContext) -> MotionMeta:
    """Pick the motion block whose input_size matches the connected frames.

    One node serves both forward-replay (motion_meta matches) and
    restore (legacy stabilization_warp inverted matches) workflows.
    """
    if not isinstance(meta, dict):
        return resolve_motion_meta(meta)

    motion_block = meta.get("motion_meta")
    if isinstance(motion_block, dict):
        motion = resolve_motion_meta({"motion_meta": motion_block})
        if (context.width, context.height) == motion.input_size:
            return motion

    warp_meta = meta.get("stabilization_warp")
    if isinstance(warp_meta, dict):
        inverse_block = motion_meta_from_stabilization_warp(
            warp_meta,
            fps=float(motion_block.get("fps", 16.0)) if isinstance(motion_block, dict) else 16.0,
            source="legacy_stabilization",
        )
        if inverse_block is not None:
            inverse_motion = resolve_motion_meta({"motion_meta": inverse_block})
            if (context.width, context.height) == inverse_motion.input_size:
                return inverse_motion

    return resolve_motion_meta(meta)


def _border_rgb(context: VideoContext, padding_rgb: Tuple[int, int, int]) -> np.ndarray:
    padding = np.asarray(padding_rgb, dtype=np.float32) / 255.0
    if context.channels == 1:
        return np.full((context.frames.shape[-1],), float(padding.mean()), np.float32)
    return padding


def blurred_sample_matrices(matrices: np.ndarray, motion_blur: float, sample_count: int) -> np.ndarray:
    """(N, 3, 3) -> (N, S, 3, 3) linear shutter interpolation.

    M_i(t) = M_i + (M_{i+1} - M_i) * t over t in linspace(0, blur, S);
    the last frame extrapolates backwards from its predecessor.
    """
    mats = np.asarray(matrices, dtype=np.float64)
    n = mats.shape[0]
    if n <= 1:
        return np.repeat(mats[:, None], max(sample_count, 1), axis=1)
    delta = np.empty_like(mats)
    delta[:-1] = mats[1:] - mats[:-1]
    delta[-1] = mats[-1] - mats[-2]
    ts = np.linspace(0.0, float(motion_blur), int(sample_count))
    return mats[:, None] + delta[:, None] * ts[None, :, None, None]


def _warp_plain(frames, context, matrices, output_size, interp, padding_rgb, masks_zero, progress, dev):
    border = _border_rgb(context, padding_rgb)
    out_w, out_h = output_size
    if masks_zero:
        out = W.warp_clip(frames, matrices, output_size, interp, border, device=dev)
        if isinstance(out, FrameShards):  # warped by shard under a mesh: each mask beside its frames
            masks = out.map(lambda f: torch.zeros(f.shape[:3], dtype=torch.float32, device=f.device))
        else:
            masks = torch.zeros((out.shape[0], out_h, out_w), dtype=torch.float32, device=out.device)
    else:  # 1 - nearest coverage: binary, so zero_small is the identity on it
        out, masks, _ = W.warp_clip_with_mask(frames, matrices, output_size, interp, border, device=dev)
    if progress is not None:
        for _ in range(out.shape[0]):
            progress()
    return out, masks


def _warp_blur(frames, context, matrices, output_size, interp, padding_rgb,
               motion_blur, motion_blur_samples, masks_zero, progress, dev):
    if motion_blur <= 0.0 or motion_blur_samples <= 1:
        return _warp_plain(frames, context, matrices, output_size, interp, padding_rgb, masks_zero, progress, dev)
    sample_count = int(np.clip(motion_blur_samples, 3, 33))
    samples = blurred_sample_matrices(matrices, motion_blur, sample_count)
    border = _border_rgb(context, padding_rgb)
    out, mask = W.warp_clip_blur(
        frames, samples, output_size, interp, border, with_mask=not masks_zero, device=dev
    )
    out_w, out_h = output_size
    if masks_zero or mask is None:
        mask = torch.zeros((out.shape[0], out_h, out_w), dtype=torch.float32, device=out.device)
    if progress is not None:
        for _ in range(out.shape[0] * sample_count):
            progress()
    return out, mask


def common_valid_mask(
    input_size: Tuple[int, int],
    output_size: Tuple[int, int],
    matrices: np.ndarray,
    device: torch.device | str,
    progress_callback: ProgressCallback | None = None,
) -> np.ndarray:
    """AND of all per-frame coverage masks: a min on the device, then one
    fetch of the (H, W) result."""
    common = (W.common_coverage(matrices, input_size, output_size, device) > 0.5).cpu().numpy()
    if progress_callback is not None:
        for _ in range(len(matrices)):
            progress_callback()
    return common


def center_crop_matrix_from_common(common: np.ndarray, output_size: Tuple[int, int]) -> np.ndarray | None:
    """Largest centered aspect-preserving crop fully inside ``common``.

    32-iteration binary search over zoom scale, capped at 4x; O(1)
    rectangle validity queries via a summed-area table.
    """
    out_w, out_h = output_size
    center_x = (out_w - 1) * 0.5
    center_y = (out_h - 1) * 0.5
    target_aspect = out_w / float(out_h)

    integral = np.zeros((out_h + 1, out_w + 1), np.int64)
    np.cumsum(np.cumsum(common.astype(np.int64), axis=0), axis=1, out=integral[1:, 1:])

    def all_valid(y0: int, x0: int, y1: int, x1: int) -> bool:
        # inclusive rect
        total = (
            integral[y1 + 1, x1 + 1]
            - integral[y0, x1 + 1]
            - integral[y1 + 1, x0]
            + integral[y0, x0]
        )
        return total == (y1 - y0 + 1) * (x1 - x0 + 1)

    def fits(scale: float) -> bool:
        crop_w = max(1.0, out_w / scale)
        crop_h = crop_w / target_aspect
        if crop_h > out_h:
            crop_h = out_h / scale
            crop_w = crop_h * target_aspect
        x0 = int(np.ceil(center_x - crop_w * 0.5))
        y0 = int(np.ceil(center_y - crop_h * 0.5))
        x1 = int(np.floor(center_x + crop_w * 0.5))
        y1 = int(np.floor(center_y + crop_h * 0.5))
        if x0 < 0 or y0 < 0 or x1 >= out_w or y1 >= out_h or x1 <= x0 or y1 <= y0:
            return False
        return all_valid(y0, x0, y1, x1)

    lo = 0.0
    hi = 1.0
    if not fits(1.0):
        while hi <= 4.0 and not fits(hi):
            hi *= 1.25
        if hi > 4.0:
            return None

    for _ in range(32):
        mid = max(1.0, (lo + hi) * 0.5)
        if fits(mid):
            hi = mid
        else:
            lo = mid

    scale = float(hi)
    crop_w = out_w / scale
    crop_h = crop_w / target_aspect
    if crop_h > out_h:
        crop_h = out_h / scale
        crop_w = crop_h * target_aspect
    x0 = center_x - crop_w * 0.5
    y0 = center_y - crop_h * 0.5
    return np.array(
        [[scale, 0.0, -scale * x0], [0.0, scale, -scale * y0], [0.0, 0.0, 1.0]],
        dtype=np.float64,
    )


def expand_matrices(
    matrices: np.ndarray, input_size: Tuple[int, int]
) -> tuple[np.ndarray, Tuple[int, int]]:
    mins, maxs = G.compute_bounding_boxes(matrices, input_size[0], input_size[1])
    translate, output_size = G.prepare_expand_transform(mins, maxs)
    shifted = np.einsum("ij,njk->nik", translate.astype(np.float64), np.asarray(matrices, np.float64))
    return shifted, output_size


def apply_motion(
    context: VideoContext,
    meta: Dict[str, Any],
    padding_rgb: Tuple[int, int, int],
    *,
    framing_mode: ApplyFramingMode = "crop_and_pad",
    interpolation: ApplyInterpolation = "bilinear",
    motion_blur: float = 0.0,
    motion_blur_samples: int = 9,
    progress_callback: ProgressCallback | None = None,
    device: str | torch.device = "cuda",
) -> MotionApplyResult:
    dev = resolve_device(device)
    with P.span("motion_apply.call", dev) as call:
        result = _apply_motion(context, meta, padding_rgb, framing_mode, interpolation, motion_blur,
                               motion_blur_samples, progress_callback, dev)
    P.attach(result.meta, call)
    return result


def _apply_motion(context, meta, padding_rgb, framing_mode, interpolation, motion_blur, motion_blur_samples,
                  progress_callback, dev) -> MotionApplyResult:
    with P.span("motion_apply.resolve_meta", dev):
        motion = resolve_motion_for_context(meta, context)
    _validate_context(context, motion)

    matrices = motion.matrices()
    output_size = motion.output_size
    interp = _check_interpolation(interpolation)
    result_meta = dict(meta)
    requested_framing = "crop_and_pad" if framing_mode == "pad" else framing_mode
    effective_framing = requested_framing
    motion_blur = float(np.clip(motion_blur, 0.0, 1.0))
    motion_blur_samples = int(np.clip(motion_blur_samples, 3, 33))

    def run(mats, out_size, masks_zero=False):
        # the clip is uploaded whole unless its warp streams through time chunks
        n, h, w, c = context.frames.shape
        streams = W.will_stream(n, h, w, int(out_size[1]), int(out_size[0]), c)
        frames = context.frames if streams else context.frames.to(dev)
        with P.span("motion_apply.warp", dev):
            return _warp_blur(
                frames, context, mats, out_size, interp, padding_rgb,
                motion_blur, motion_blur_samples, masks_zero, progress_callback, dev,
            )

    if requested_framing == "crop_and_pad":
        out, masks = run(matrices, output_size)
    elif requested_framing == "crop":
        common = common_valid_mask(
            motion.input_size, output_size, matrices, dev, progress_callback=progress_callback
        )
        crop_matrix = center_crop_matrix_from_common(common, output_size)
        if crop_matrix is None:
            out, masks = run(matrices, output_size)
            result_meta["framing_fallback"] = "crop_and_pad"
            effective_framing = "crop_and_pad"
        else:
            cropped = np.einsum("ij,njk->nik", crop_matrix, matrices)
            out, masks = run(cropped, output_size, masks_zero=True)
    elif requested_framing == "expand":
        expanded, output_size = expand_matrices(matrices, motion.input_size)
        out, masks = run(expanded, output_size)
    else:
        raise ValueError(
            f"Unsupported framing_mode {framing_mode!r}; expected 'crop_and_pad', 'crop', or 'expand'."
        )

    result_meta["motion_apply"] = {
        "input_size": [int(motion.input_size[0]), int(motion.input_size[1])],
        "output_size": [int(output_size[0]), int(output_size[1])],
        "framing_mode": effective_framing,
        "interpolation": interpolation,
        "motion_blur": motion_blur,
        "motion_blur_samples": motion_blur_samples,
        "source": motion.source,
    }
    return MotionApplyResult(out, masks, result_meta)
