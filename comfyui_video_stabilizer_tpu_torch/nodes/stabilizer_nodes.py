"""Classic and Flow stabilizer node shells (ComfyUI V3 schema) on the
PyTorch engine.

Each schema equals the JAX package's node of the same name field for
field (node id, display name, widget ids/order, defaults, sockets).
Work runs on ``cuda`` unless ``execute`` is given another ``device``;
the outputs are CPU tensors, as ComfyUI expects.
"""

from __future__ import annotations

from typing import Any

from ..models.classic import stabilize_classic
from ..models.flow import stabilize_flow
from ..utils.color import parse_padding_color
from ..utils.video_io import (
    convert_masks_for_output,
    normalize_video_input,
    reconstruct_video,
)
from .comfy_compat import ComfyExtension, ProgressBar, check_interrupt, io

JSONType = io.Custom("JSON")


def _stabilizer_inputs(estimator_blurb: str, framing_blurb: str):
    return [
        io.Image.Input("frames", display_name="Frames"),
        io.Float.Input(
            "frame_rate",
            default=16.0,
            min=1.0,
            step=0.1,
            display_name="Input FPS",
            tooltip="Frame rate in frames per second used to scale smoothing window.",
        ),
        io.Combo.Input(
            "framing_mode",
            options=["crop", "crop_and_pad", "expand"],
            default="crop_and_pad",
            display_name="Framing Mode",
            tooltip=framing_blurb,
        ),
        io.Combo.Input(
            "transform_mode",
            options=["translation", "similarity", "perspective"],
            default="similarity",
            display_name="Transform Mode",
            tooltip=estimator_blurb,
        ),
        io.Boolean.Input(
            "camera_lock",
            default=False,
            display_name="Camera Lock",
            tooltip="Treat the shot as tripod-like by aggressively damping motion.",
        ),
        io.Float.Input(
            "strength",
            default=0.7,
            min=0.0,
            max=1.0,
            step=0.05,
            display_name="Strength",
            tooltip="Removal gain (0 keeps original motion, 1 removes it based on smoothing).",
            display_mode=io.NumberDisplay.slider,
        ),
        io.Float.Input(
            "smooth",
            default=0.5,
            min=0.0,
            max=1.0,
            step=0.05,
            display_name="Smooth",
            tooltip="Temporal smoothing amount applied to the estimated motion path.",
            display_mode=io.NumberDisplay.slider,
        ),
        io.Float.Input(
            "keep_fov",
            default=0.6,
            min=0.0,
            max=1.0,
            step=0.05,
            display_name="Keep FOV",
            tooltip=(
                "[Crop only] How much of the original FOV to preserve (1.0 = no zoom, 0.0 = maximum zoom). "
                "Ignored when framing_mode is crop_and_pad or expand."
            ),
            display_mode=io.NumberDisplay.slider,
        ),
        io.Color.Input(
            "padding_color",
            default="#7F7F7F",
            display_name="Padding Color",
            tooltip="HEX padding color applied in crop_and_pad / expand (e.g. #404040).",
        ),
    ]


_STAB_OUTPUTS = lambda: [  # noqa: E731
    io.Image.Output("frames_stabilized", display_name="Stabilized Frames"),
    io.Mask.Output("padding_mask", display_name="Padding Mask"),
    JSONType.Output("meta", display_name="Motion Meta"),
]


def _run_stabilizer(engine, frames, frame_rate, framing_mode, transform_mode,
                    camera_lock, strength, smooth, keep_fov, padding_color, device):
    context = normalize_video_input(frames, device=device)
    padding_rgb = parse_padding_color(padding_color)
    n = context.frame_count
    progress_total = max(1, max(0, n - 1) + n)
    pbar = ProgressBar(progress_total)

    def on_progress(done: int, total: int) -> None:
        pbar.update_absolute(min(done, progress_total), progress_total)

    result = engine(
        context,
        framing_mode,
        transform_mode,
        camera_lock,
        strength,
        smooth,
        keep_fov,
        padding_rgb,
        frame_rate,
        progress=on_progress,
        interrupt_check=check_interrupt,
        device=device,
    )
    pbar.update_absolute(progress_total, progress_total)
    video_payload = reconstruct_video(result.frames, context)
    mask_payload = convert_masks_for_output(result.masks)
    return io.NodeOutput(video_payload, mask_payload, result.meta)


class VideoStabilizerClassic(io.ComfyNode):
    """Sparse feature-tracking stabilizer (GFTT + pyramidal LK, CUDA kernels)."""

    @classmethod
    def define_schema(cls) -> io.Schema:
        schema = io.Schema(
            node_id="video_stabilizer_classic",
            display_name="Video Stabilizer Classic",
            category="Video/Stabilization",
            description=(
                "Video stabilization using sparse feature tracking with configurable transforms "
                "and framing, emitting both stabilized frames and a padding mask."
            ),
        )
        schema.inputs = _stabilizer_inputs(
            "Select the geometric model used to estimate camera motion.",
            "Choose how to handle borders produced by stabilization.",
        )
        schema.outputs = _STAB_OUTPUTS()
        return schema

    @classmethod
    def execute(
        cls,
        frames: Any,
        frame_rate: float,
        framing_mode: str,
        transform_mode: str,
        camera_lock: bool,
        strength: float,
        smooth: float,
        keep_fov: float,
        padding_color: str,
        device: str = "cuda",
    ) -> io.NodeOutput:
        return _run_stabilizer(
            stabilize_classic, frames, frame_rate, framing_mode, transform_mode,
            camera_lock, strength, smooth, keep_fov, padding_color, device,
        )


class VideoStabilizerFlow(io.ComfyNode):
    """Dense optical-flow stabilizer (DIS reformulation, CUDA kernels)."""

    @classmethod
    def define_schema(cls) -> io.Schema:
        schema = io.Schema(
            node_id="video_stabilizer_flow",
            display_name="Video Stabilizer Flow",
            category="Video/Stabilization",
            description=(
                "Video stabilization using dense optical flow with configurable transforms "
                "and framing, emitting stabilized frames, a padding mask, and motion diagnostics."
            ),
        )
        schema.inputs = _stabilizer_inputs(
            "Select the geometric model fitted to the optical flow.",
            "Choose how borders produced by stabilization are handled.",
        )
        schema.outputs = _STAB_OUTPUTS()
        return schema

    @classmethod
    def execute(
        cls,
        frames: Any,
        frame_rate: float,
        framing_mode: str,
        transform_mode: str,
        camera_lock: bool,
        strength: float,
        smooth: float,
        keep_fov: float,
        padding_color: str,
        device: str = "cuda",
    ) -> io.NodeOutput:
        return _run_stabilizer(
            stabilize_flow, frames, frame_rate, framing_mode, transform_mode,
            camera_lock, strength, smooth, keep_fov, padding_color, device,
        )


class VideoStabilizerClassicExtension(ComfyExtension):
    async def get_node_list(self) -> list:
        return [VideoStabilizerClassic]


class VideoStabilizerFlowExtension(ComfyExtension):
    async def get_node_list(self) -> list:
        return [VideoStabilizerFlow]
