"""Shake Generator nodes (style presets + manual recipe).

Counterpart of ``comfyui_video_stabilizer_tpu/nodes/shake_nodes.py``,
the schemas equal field for field: both read only frame count /
resolution / fps from the connected frames (normalized on the CPU; no
device work) and emit a motion_meta v2 payload; pixels are never
touched.
"""

from __future__ import annotations

from typing import Any

from ..models.shake import STYLES, ShakeRecipe, generate_shake_motion_meta
from ..utils.video_io import normalize_video_input, resolve_fps
from .comfy_compat import ComfyExtension, io

JSONType = io.Custom("JSON")
HANDHELD_DEFAULT = STYLES["handheld"]


class VideoStabilizerShakeGenerator(io.ComfyNode):
    """Generate artificial handheld motion metadata without changing pixels."""

    @classmethod
    def define_schema(cls) -> io.Schema:
        schema = io.Schema(
            node_id="video_stabilizer_shake_generator",
            display_name="Video Stabilizer Shake Generator",
            category="Video/Stabilization",
            description="Generates deterministic shake motion metadata; it does not alter input frames.",
        )
        schema.inputs = [
            io.Image.Input(
                "frames_context",
                display_name="Frames Context",
                tooltip=(
                    "The input frames are used only to read frame count and resolution. This node outputs "
                    "motion metadata only; connect it to Video Stabilizer Motion Apply to move pixels."
                ),
            ),
            io.Float.Input(
                "frame_rate",
                default=16.0,
                min=1.0,
                step=0.1,
                display_name="Input FPS",
                tooltip="Fallback frame rate when the input does not carry fps metadata.",
            ),
            io.Combo.Input(
                "style",
                options=list(STYLES.keys()),
                default="handheld",
                display_name="Style",
            ),
            io.Float.Input(
                "amount",
                default=1.0,
                min=0.0,
                max=3.0,
                step=0.05,
                display_name="Amount",
                display_mode=io.NumberDisplay.slider,
            ),
            io.Float.Input(
                "speed",
                default=1.0,
                min=0.1,
                max=3.0,
                step=0.05,
                display_name="Speed",
                display_mode=io.NumberDisplay.slider,
            ),
            io.Int.Input(
                "seed",
                default=0,
                min=0,
                max=0xFFFFFFFFFFFFFFFF,
                display_name="Seed",
                control_after_generate=io.ControlAfterGenerate.fixed,
            ),
        ]
        schema.outputs = [JSONType.Output("motion_meta", display_name="Motion Meta")]
        return schema

    @classmethod
    def execute(
        cls,
        frames_context: Any,
        frame_rate: float,
        style: str,
        amount: float,
        speed: float,
        seed: int,
    ) -> io.NodeOutput:
        context = normalize_video_input(frames_context, device="cpu")
        fps = resolve_fps(context, frame_rate)
        motion_meta = generate_shake_motion_meta(
            recipe=STYLES[style],
            frame_count=context.frame_count,
            width=context.width,
            height=context.height,
            fps=fps,
            amount=amount,
            speed=speed,
            seed=seed,
            node="shake_generator",
            style=style,
        )
        return io.NodeOutput({"motion_meta": motion_meta})


_RECIPE_LIMITS = {
    "pan": (0.0, 5.0, 0.01, "Pan"),
    "tilt": (0.0, 5.0, 0.01, "Tilt"),
    "roll": (0.0, 5.0, 0.01, "Roll"),
    "zoom": (0.0, 0.05, 0.001, "Zoom"),
    "drift_freq": (0.0, 2.0, 0.05, "Drift Frequency"),
    "tremor": (0.0, 2.0, 0.05, "Tremor"),
    "tremor_freq": (1.0, 15.0, 0.5, "Tremor Frequency"),
    "jitter_rate": (0.0, 3.0, 0.1, "Jitter Rate"),
    "step": (0.0, 2.0, 0.05, "Step"),
    "randomness": (0.0, 1.0, 0.05, "Randomness"),
    "virtual_fov": (10.0, 120.0, 1.0, "Virtual FOV"),
}


class VideoStabilizerShakeGeneratorManual(io.ComfyNode):
    """Generate artificial camera motion metadata from explicit recipe values."""

    @classmethod
    def define_schema(cls) -> io.Schema:
        schema = io.Schema(
            node_id="video_stabilizer_shake_generator_manual",
            display_name="Video Stabilizer Shake Generator Manual",
            category="Video/Stabilization",
            description="Generates deterministic shake motion metadata from manual absolute values.",
        )
        inputs = [
            io.Image.Input(
                "frames_context",
                display_name="Frames Context",
                tooltip=(
                    "The input frames are used only to read frame count and resolution. This node outputs "
                    "motion metadata only; connect it to Video Stabilizer Motion Apply to move pixels."
                ),
            ),
            io.Float.Input(
                "frame_rate",
                default=16.0,
                min=1.0,
                step=0.1,
                display_name="Input FPS",
                tooltip="Fallback frame rate when the input does not carry fps metadata.",
            ),
        ]
        for field, (lo, hi, step, label) in _RECIPE_LIMITS.items():
            kwargs = dict(
                default=getattr(HANDHELD_DEFAULT, field),
                min=lo,
                max=hi,
                step=step,
                display_name=label,
            )
            if field == "randomness":
                kwargs["display_mode"] = io.NumberDisplay.slider
            inputs.append(io.Float.Input(field, **kwargs))
        inputs.extend(
            [
                io.Float.Input(
                    "amount",
                    default=1.0,
                    min=0.0,
                    max=3.0,
                    step=0.05,
                    display_name="Amount",
                    display_mode=io.NumberDisplay.slider,
                ),
                io.Float.Input(
                    "speed",
                    default=1.0,
                    min=0.1,
                    max=3.0,
                    step=0.05,
                    display_name="Speed",
                    display_mode=io.NumberDisplay.slider,
                ),
                io.Int.Input(
                    "seed",
                    default=0,
                    min=0,
                    max=0xFFFFFFFFFFFFFFFF,
                    display_name="Seed",
                    control_after_generate=io.ControlAfterGenerate.fixed,
                ),
            ]
        )
        schema.inputs = inputs
        schema.outputs = [JSONType.Output("motion_meta", display_name="Motion Meta")]
        return schema

    @classmethod
    def execute(
        cls,
        frames_context: Any,
        frame_rate: float,
        pan: float,
        tilt: float,
        roll: float,
        zoom: float,
        drift_freq: float,
        tremor: float,
        tremor_freq: float,
        jitter_rate: float,
        step: float,
        randomness: float,
        virtual_fov: float,
        amount: float,
        speed: float,
        seed: int,
    ) -> io.NodeOutput:
        context = normalize_video_input(frames_context, device="cpu")
        fps = resolve_fps(context, frame_rate)
        recipe = ShakeRecipe(
            pan=pan,
            tilt=tilt,
            roll=roll,
            zoom=zoom,
            drift_freq=drift_freq,
            tremor=tremor,
            tremor_freq=tremor_freq,
            jitter_rate=jitter_rate,
            step=step,
            randomness=randomness,
            virtual_fov=virtual_fov,
        )
        motion_meta = generate_shake_motion_meta(
            recipe=recipe,
            frame_count=context.frame_count,
            width=context.width,
            height=context.height,
            fps=fps,
            amount=amount,
            speed=speed,
            seed=seed,
            node="shake_generator_manual",
            style="manual",
        )
        return io.NodeOutput({"motion_meta": motion_meta})


class VideoStabilizerShakeGeneratorExtension(ComfyExtension):
    async def get_node_list(self) -> list:
        return [VideoStabilizerShakeGenerator]


class VideoStabilizerShakeGeneratorManualExtension(ComfyExtension):
    async def get_node_list(self) -> list:
        return [VideoStabilizerShakeGeneratorManual]
