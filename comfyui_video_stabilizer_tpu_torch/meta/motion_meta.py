"""motion_meta v2 — the portable JSON motion contract.

A copy of ``comfyui_video_stabilizer_tpu/meta/motion_meta.py`` (numpy
only; the code, its float64 arithmetic and its error strings are the
same line for line, and tests/test_torch_host_copies.py holds the two
equal).  Copied rather than imported so the port loads nothing of the
JAX package.

This module is the keystone of cross-node portability: Classic/Flow and
the shake generators *produce* a ``motion_meta`` block, Motion Apply
*consumes* it, and the legacy ``stabilization_warp`` block can be lifted
into the same shape.  It is deliberately host-side pure Python/numpy:
the block is a serializable artifact (the durable "checkpoint" of an
estimation run), not device data.

Contract parity with the original reference implementation (its
nodes/motion_meta.py and docs/requirements/003-motion-meta-and-apply.md):

* schema: ``{version: 2, source, frame_count, fps, input_size: [w, h],
  output_size: [w, h], matrix_convention: "input_to_output",
  per_frame: [{index, matrix: 3x3}], generator?}``
* validation requires finite AND invertible matrices, exact per_frame
  length, positive sizes/fps, and a ``generator`` dict iff
  ``source == "generated_shake"``.
* legacy lift: ``stabilization_warp`` (convention
  ``source_to_stabilized``) inverts per-frame ``applied_matrix`` and
  swaps input/output sizes; the non-inverting variant is what the
  stabilizers attach so that original frames + meta replay exactly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Sequence, Tuple

import numpy as np

MOTION_META_VERSION = 2
MOTION_CONVENTION = "input_to_output"
WARP_CONVENTION = "source_to_stabilized"


@dataclass(frozen=True)
class FrameTransform:
    """One per-frame 3x3 homography, input->output convention."""

    index: int
    matrix: np.ndarray


@dataclass(frozen=True)
class MotionMeta:
    """Resolved, validated in-memory view of a motion_meta block."""

    source: str
    frame_count: int
    fps: float
    input_size: Tuple[int, int]
    output_size: Tuple[int, int]
    per_frame: list[FrameTransform]
    generator: Dict[str, Any] | None = None

    def matrices(self) -> np.ndarray:
        """Stacked (N, 3, 3) float64 matrices for the device pipeline."""
        if not self.per_frame:
            return np.zeros((0, 3, 3), dtype=np.float64)
        return np.stack([t.matrix for t in self.per_frame]).astype(np.float64)


def _size_pair(block_name: str, block: Dict[str, Any], key: str) -> Tuple[int, int]:
    value = block.get(key)
    if not isinstance(value, (list, tuple)) or len(value) != 2:
        raise ValueError(f"{block_name}.{key} must be [width, height].")
    try:
        width, height = int(value[0]), int(value[1])
    except (TypeError, ValueError) as exc:
        raise ValueError(f"{block_name}.{key} must contain integer width/height.") from exc
    if width <= 0 or height <= 0:
        raise ValueError(f"{block_name}.{key} must contain positive width/height.")
    return width, height


def _frame_matrix(block_name: str, entry: Any, expected_index: int, key: str) -> np.ndarray:
    if not isinstance(entry, dict):
        raise ValueError(f"{block_name}.per_frame[{expected_index}] must be an object.")
    if entry.get("index") != expected_index:
        raise ValueError(
            f"{block_name}.per_frame[{expected_index}].index must be {expected_index}, "
            f"got {entry.get('index')!r}."
        )
    if key not in entry:
        raise ValueError(f"{block_name}.per_frame[{expected_index}].{key} is missing.")
    matrix = np.asarray(entry[key], dtype=np.float64)
    if matrix.shape != (3, 3):
        raise ValueError(f"{block_name}.per_frame[{expected_index}].{key} must be 3x3.")
    if not np.isfinite(matrix).all():
        raise ValueError(
            f"{block_name}.per_frame[{expected_index}].{key} must contain finite numbers."
        )
    try:
        np.linalg.inv(matrix)
    except np.linalg.LinAlgError as exc:
        raise ValueError(f"{block_name}.per_frame[{expected_index}].{key} is not invertible.") from exc
    return matrix


def validate_motion_meta(block: Dict[str, Any]) -> None:
    """Raise ValueError unless ``block`` is a well-formed motion_meta v2."""
    if not isinstance(block, dict):
        raise ValueError("motion_meta must be an object.")
    if block.get("version") != MOTION_META_VERSION:
        raise ValueError(f"motion_meta.version must be 2, got {block.get('version')!r}.")
    if block.get("matrix_convention") != MOTION_CONVENTION:
        raise ValueError(
            "motion_meta.matrix_convention must be 'input_to_output', "
            f"got {block.get('matrix_convention')!r}."
        )
    source = block.get("source")
    if not isinstance(source, str) or not source:
        raise ValueError("motion_meta.source must be a non-empty string.")
    try:
        frame_count = int(block.get("frame_count"))
    except (TypeError, ValueError) as exc:
        raise ValueError("motion_meta.frame_count must be an integer.") from exc
    if frame_count < 0:
        raise ValueError("motion_meta.frame_count must be non-negative.")
    try:
        fps = float(block.get("fps"))
    except (TypeError, ValueError) as exc:
        raise ValueError("motion_meta.fps must be a positive number.") from exc
    if not np.isfinite(fps) or fps <= 0.0:
        raise ValueError("motion_meta.fps must be a positive number.")
    _size_pair("motion_meta", block, "input_size")
    _size_pair("motion_meta", block, "output_size")
    per_frame = block.get("per_frame")
    if not isinstance(per_frame, list):
        raise ValueError("motion_meta.per_frame must be a list.")
    if len(per_frame) != frame_count:
        raise ValueError(
            "motion_meta.frame_count mismatch: "
            f"frame_count is {frame_count}, per_frame has {len(per_frame)} entry/entries."
        )
    for idx, entry in enumerate(per_frame):
        _frame_matrix("motion_meta", entry, idx, "matrix")
    if source == "generated_shake" and not isinstance(block.get("generator"), dict):
        raise ValueError("motion_meta.generator is required when source is 'generated_shake'.")


def _meta_from_block(block: Dict[str, Any]) -> MotionMeta:
    validate_motion_meta(block)
    per_frame = [
        FrameTransform(index=idx, matrix=np.asarray(entry["matrix"], dtype=np.float64))
        for idx, entry in enumerate(block["per_frame"])
    ]
    return MotionMeta(
        source=str(block["source"]),
        frame_count=int(block["frame_count"]),
        fps=float(block["fps"]),
        input_size=_size_pair("motion_meta", block, "input_size"),
        output_size=_size_pair("motion_meta", block, "output_size"),
        per_frame=per_frame,
        generator=dict(block["generator"]) if isinstance(block.get("generator"), dict) else None,
    )


def build_motion_meta_v2(
    *,
    source: str,
    frame_count: int,
    fps: float,
    input_size: Tuple[int, int],
    output_size: Tuple[int, int],
    matrices: Sequence[np.ndarray],
    generator: Dict[str, Any] | None = None,
) -> Dict[str, Any]:
    """Assemble and validate a motion_meta v2 JSON block."""
    block: Dict[str, Any] = {
        "version": MOTION_META_VERSION,
        "source": source,
        "frame_count": int(frame_count),
        "fps": float(fps),
        "input_size": [int(input_size[0]), int(input_size[1])],
        "output_size": [int(output_size[0]), int(output_size[1])],
        "matrix_convention": MOTION_CONVENTION,
        "per_frame": [
            {"index": int(idx), "matrix": np.asarray(matrix, dtype=np.float64).tolist()}
            for idx, matrix in enumerate(matrices)
        ],
    }
    if generator is not None:
        block["generator"] = dict(generator)
    validate_motion_meta(block)
    return block


def _warp_meta_sizes(warp_meta: Dict[str, Any]) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    if not isinstance(warp_meta, dict):
        raise ValueError("stabilization_warp must be an object.")
    if warp_meta.get("matrix_convention") != WARP_CONVENTION:
        raise ValueError(
            "stabilization_warp.matrix_convention must be 'source_to_stabilized', "
            f"got {warp_meta.get('matrix_convention')!r}."
        )
    source_size = _size_pair("stabilization_warp", warp_meta, "source_size")
    output_size = _size_pair("stabilization_warp", warp_meta, "output_size")
    return source_size, output_size


def motion_meta_from_stabilization_warp(
    warp_meta: Dict[str, Any],
    fps: float,
    source: str,
) -> Dict[str, Any] | None:
    """Lift a legacy stabilization_warp into motion_meta by inversion.

    The inverted block maps *stabilized* frames back to the source
    canvas (the old Inverse node's semantics).  Returns None when any
    applied_matrix is singular.
    """
    source_size, output_size = _warp_meta_sizes(warp_meta)
    per_frame = warp_meta.get("per_frame")
    if not isinstance(per_frame, list):
        raise ValueError("stabilization_warp.per_frame must be a list.")

    matrices: list[np.ndarray] = []
    for idx, entry in enumerate(per_frame):
        matrix = _frame_matrix("stabilization_warp", entry, idx, "applied_matrix")
        try:
            matrices.append(np.linalg.inv(matrix))
        except np.linalg.LinAlgError:
            return None

    return build_motion_meta_v2(
        source=source,
        frame_count=len(matrices),
        fps=fps,
        input_size=output_size,
        output_size=source_size,
        matrices=matrices,
    )


def applied_motion_meta_from_stabilization_warp(
    warp_meta: Dict[str, Any],
    fps: float,
    source: str,
) -> Dict[str, Any]:
    """Lift stabilization_warp verbatim (no inversion).

    This is what Classic/Flow attach: original frames + this block fed
    to Motion Apply replay the stabilization exactly.
    """
    source_size, output_size = _warp_meta_sizes(warp_meta)
    per_frame = warp_meta.get("per_frame")
    if not isinstance(per_frame, list):
        raise ValueError("stabilization_warp.per_frame must be a list.")

    matrices = [
        _frame_matrix("stabilization_warp", entry, idx, "applied_matrix")
        for idx, entry in enumerate(per_frame)
    ]
    return build_motion_meta_v2(
        source=source,
        frame_count=len(matrices),
        fps=fps,
        input_size=source_size,
        output_size=output_size,
        matrices=matrices,
    )


def resolve_motion_meta(meta: Dict[str, Any]) -> MotionMeta:
    """Resolve a node ``meta`` payload into a validated MotionMeta.

    Preference order: top-level ``motion_meta`` block, else legacy
    ``stabilization_warp`` inverted at the legacy default of 16 fps.
    """
    if not isinstance(meta, dict):
        raise ValueError("meta must be a dictionary containing motion_meta or stabilization_warp.")
    motion_block = meta.get("motion_meta")
    if isinstance(motion_block, dict):
        return _meta_from_block(motion_block)
    warp_meta = meta.get("stabilization_warp")
    if isinstance(warp_meta, dict):
        block = motion_meta_from_stabilization_warp(warp_meta, fps=16.0, source="legacy_stabilization")
        if block is None:
            raise ValueError("stabilization_warp contains a non-invertible applied_matrix.")
        return _meta_from_block(block)
    raise ValueError("meta must contain motion_meta or stabilization_warp.")


def build_stabilization_warp_meta(
    *,
    source_size: Tuple[int, int],
    output_size: Tuple[int, int],
    framing_mode: str,
    applied_matrices: Sequence[np.ndarray],
) -> Dict[str, Any]:
    """Describe the exact per-frame matrices applied during stabilization.

    Mirrors the legacy block emitted by the reference stabilizers
    (their nodes/stabilizer_utils.py).
    """
    return {
        "source_size": [int(source_size[0]), int(source_size[1])],
        "output_size": [int(output_size[0]), int(output_size[1])],
        "framing_mode": framing_mode,
        "matrix_convention": WARP_CONVENTION,
        "per_frame": [
            {"index": int(idx), "applied_matrix": np.asarray(matrix, dtype=np.float32).tolist()}
            for idx, matrix in enumerate(applied_matrices)
        ],
    }
