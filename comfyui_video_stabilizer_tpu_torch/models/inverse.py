"""Legacy inverse-stabilization engine.

Counterpart of ``comfyui_video_stabilizer_tpu/models/inverse.py``:
restores stabilized frames to the original canvas by inverting the
exact per-frame matrices recorded in ``stabilization_warp``, as one
batched warp (K1 on the card) plus a closed-form coverage stack.  The
inverse is taken in float64 and handed on as float32, as the reference
hands cv2 a float32 inverse.

``apply_inverse_stabilization`` is the exported round-trip engine; the
deprecated Inverse NODE routes through Motion Apply instead
(``nodes/inverse_node.py``), as in the JAX package, because the
contract pins that node bit-identical to Motion Apply on legacy meta.
The work runs on ``device`` (default ``"cuda"``, raising without a
card); frames and masks are returned on it, or on the host when the
warp streams through time chunks (``ops/warp.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..ops import warp as W
from ..utils.device import resolve_device
from ..utils.video_io import VideoContext


@dataclass
class InverseStabilizationResult:
    frames: torch.Tensor  # on the device (the host when streamed)
    masks: torch.Tensor
    meta: Dict[str, Any]


def _size_pair(meta: Dict[str, Any], key: str) -> Tuple[int, int]:
    value = meta.get(key)
    if not isinstance(value, (list, tuple)) or len(value) != 2:
        raise ValueError(f"stabilization_warp.{key} must be [width, height].")
    try:
        width, height = int(value[0]), int(value[1])
    except (TypeError, ValueError) as exc:
        raise ValueError(f"stabilization_warp.{key} must contain integer width/height.") from exc
    if width <= 0 or height <= 0:
        raise ValueError(f"stabilization_warp.{key} must contain positive width/height.")
    return width, height


def _applied_matrix(entry: Any, expected_index: int) -> np.ndarray:
    if not isinstance(entry, dict):
        raise ValueError(f"stabilization_warp.per_frame[{expected_index}] must be an object.")
    if entry.get("index") != expected_index:
        raise ValueError(
            f"stabilization_warp.per_frame[{expected_index}].index must be {expected_index}, "
            f"got {entry.get('index')!r}."
        )
    if "applied_matrix" not in entry:
        raise ValueError(f"stabilization_warp.per_frame[{expected_index}].applied_matrix is missing.")
    matrix = np.asarray(entry["applied_matrix"], dtype=np.float64)
    if matrix.shape != (3, 3):
        raise ValueError(f"stabilization_warp.per_frame[{expected_index}].applied_matrix must be 3x3.")
    return matrix


def apply_inverse_stabilization(
    context: VideoContext,
    meta: Dict[str, Any],
    padding_rgb: Tuple[int, int, int],
    device: str | torch.device = "cuda",
) -> InverseStabilizationResult:
    dev = resolve_device(device)
    if not isinstance(meta, dict):
        raise ValueError("meta must be a dictionary containing stabilization_warp.")
    warp_meta = meta.get("stabilization_warp")
    if not isinstance(warp_meta, dict):
        raise ValueError("meta.stabilization_warp is required for inverse stabilization.")
    if warp_meta.get("matrix_convention") != "source_to_stabilized":
        raise ValueError(
            "stabilization_warp.matrix_convention must be 'source_to_stabilized' "
            f"for inverse stabilization, got {warp_meta.get('matrix_convention')!r}."
        )

    source_size = _size_pair(warp_meta, "source_size")
    output_size = _size_pair(warp_meta, "output_size")
    if (context.width, context.height) != output_size:
        raise ValueError(
            "Input frames must match stabilization_warp.output_size "
            f"{output_size}, got {(context.width, context.height)}."
        )

    per_frame = warp_meta.get("per_frame")
    if not isinstance(per_frame, list):
        raise ValueError("stabilization_warp.per_frame must be a list.")
    if len(per_frame) != context.frame_count:
        raise ValueError(
            "Frame count mismatch: "
            f"got {context.frame_count} frame(s), metadata has {len(per_frame)} matrix entry/entries."
        )

    inverses = np.empty((len(per_frame), 3, 3), np.float64)
    for idx, entry in enumerate(per_frame):
        matrix = _applied_matrix(entry, idx)
        try:
            inverses[idx] = np.linalg.inv(matrix)
        except np.linalg.LinAlgError as exc:
            raise ValueError(
                f"stabilization_warp.per_frame[{idx}].applied_matrix is not invertible."
            ) from exc
    # Match the reference bit pattern: it hands cv2 a float32 inverse.
    inverses = inverses.astype(np.float32)

    padding = np.asarray(padding_rgb, dtype=np.float32) / 255.0
    border = (
        np.full((context.frames.shape[-1],), float(padding.mean()), np.float32)
        if context.channels == 1
        else padding
    )
    restored, masks, _ = W.warp_clip_with_mask(context.frames, inverses, source_size, "bilinear", border,
                                               device=dev)

    result_meta = dict(meta)
    result_meta["inverse_stabilization"] = {
        "source_size": [int(source_size[0]), int(source_size[1])],
        "input_size": [int(output_size[0]), int(output_size[1])],
        "output_size": [int(source_size[0]), int(source_size[1])],
        "matrix_convention": "stabilized_to_source",
        "source_matrix_convention": warp_meta.get("matrix_convention"),
        "framing_mode": warp_meta.get("framing_mode"),
        "note": "Restores original motion/canvas; pixels discarded by crop framing cannot be recovered.",
    }
    return InverseStabilizationResult(restored, masks, result_meta)
