"""Motion Apply node: consume motion_meta v2, warp frames on the card.

Counterpart of ``comfyui_video_stabilizer_tpu/nodes/motion_apply_node.py``:
the schema equals the JAX node's field for field, including the
Draft/Standard/High/Ultra shutter-sample quality map and the
progress-tick accounting (frames x samples, +frames in crop mode).
Work runs on ``cuda`` unless ``execute`` is given another ``device``;
the outputs are CPU tensors, as ComfyUI expects.
"""

from __future__ import annotations

from typing import Any

from ..models.motion_apply import apply_motion
from ..utils.color import parse_padding_color
from ..utils.video_io import (
    convert_masks_for_output,
    normalize_video_input,
    reconstruct_video,
)
from .comfy_compat import ComfyExtension, ProgressBar, io

JSONType = io.Custom("JSON")
BLUR_QUALITY_SAMPLES = {
    "Draft": 5,
    "Standard": 9,
    "High": 17,
    "Ultra": 33,
}


def _blur_profile(quality: str, motion_blur: float) -> tuple[str, int, int]:
    """Resolve the quality widget to (name, shutter samples, warps-per-frame).

    Unknown quality strings degrade to "Standard"; with blur disabled every
    frame costs exactly one warp regardless of the selected quality.
    """
    name = quality if quality in BLUR_QUALITY_SAMPLES else "Standard"
    samples = BLUR_QUALITY_SAMPLES[name]
    per_frame = min(33, max(3, samples)) if motion_blur > 0.0 else 1
    return name, samples, per_frame


class _Progress:
    """Turn apply_motion's unit ticks into absolute ProgressBar updates."""

    def __init__(self, total: int) -> None:
        self.total = max(1, total)
        self.done = 0
        self.bar = ProgressBar(self.total)

    def tick(self) -> None:
        self.done += 1
        self.bar.update_absolute(min(self.done, self.total), self.total)

    def finish(self) -> None:
        self.bar.update_absolute(self.total, self.total)


class VideoStabilizerMotionApply(io.ComfyNode):
    """Apply motion_meta matrices to a video sequence."""

    @classmethod
    def define_schema(cls) -> io.Schema:
        schema = io.Schema(
            node_id="video_stabilizer_motion_apply",
            display_name="Video Stabilizer Motion Apply",
            category="Video/Stabilization",
            description="Applies motion metadata to frames and emits a padding mask.",
        )
        schema.inputs = [
            io.Image.Input("frames", display_name="Frames"),
            JSONType.Input("motion_meta", display_name="Motion Meta"),
            io.Combo.Input(
                "framing_mode",
                options=["crop_and_pad", "crop", "expand"],
                default="crop_and_pad",
                display_name="Framing Mode",
            ),
            io.Combo.Input(
                "interpolation",
                options=["bilinear", "bicubic"],
                default="bilinear",
                display_name="Interpolation",
            ),
            io.Color.Input(
                "padding_color",
                default="#7F7F7F",
                display_name="Padding Color",
                tooltip="HEX padding color used where warping exposes empty pixels.",
            ),
            io.Float.Input(
                "motion_blur",
                default=0.0,
                min=0.0,
                max=1.0,
                step=0.05,
                display_name="Motion Blur",
                tooltip="Shutter fraction for matrix-sampled motion blur. 0 disables blur.",
                display_mode=io.NumberDisplay.slider,
            ),
            io.Combo.Input(
                "motion_blur_quality",
                options=list(BLUR_QUALITY_SAMPLES.keys()),
                default="Standard",
                display_name="Blur Quality",
                tooltip="Draft is faster. High and Ultra average more shutter samples for smoother blur.",
            ),
        ]
        schema.outputs = [
            io.Image.Output("frames", display_name="Frames"),
            io.Mask.Output("padding_mask", display_name="Padding Mask"),
            JSONType.Output("meta", display_name="Meta"),
        ]
        return schema

    @classmethod
    def execute(
        cls,
        frames: Any,
        motion_meta: dict[str, Any],
        framing_mode: str,
        interpolation: str,
        padding_color: str,
        motion_blur: float,
        motion_blur_quality: str,
        device: str = "cuda",
    ) -> io.NodeOutput:
        context = normalize_video_input(frames, device=device)
        quality_name, samples, warps_per_frame = _blur_profile(motion_blur_quality, motion_blur)
        ticks = context.frame_count * warps_per_frame
        if framing_mode == "crop":
            ticks += context.frame_count  # crop adds a coverage-mask pass over all frames
        progress = _Progress(ticks)
        result = apply_motion(
            context,
            motion_meta,
            parse_padding_color(padding_color),
            framing_mode=framing_mode,
            interpolation=interpolation,
            motion_blur=motion_blur,
            motion_blur_samples=samples,
            progress_callback=progress.tick,
            device=device,
        )
        apply_block = result.meta.setdefault("motion_apply", {})
        apply_block["motion_blur_quality"] = quality_name
        progress.finish()
        return io.NodeOutput(
            reconstruct_video(result.frames, context),
            convert_masks_for_output(result.masks),
            result.meta,
        )


class VideoStabilizerMotionApplyExtension(ComfyExtension):
    async def get_node_list(self) -> list:
        return [VideoStabilizerMotionApply]
