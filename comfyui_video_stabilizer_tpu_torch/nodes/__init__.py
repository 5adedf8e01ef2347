"""Node registration of the PyTorch package: the six nodes of the JAX
package, plus the Inverse -> Motion Apply node-replacement migration on
load, as in ``comfyui_video_stabilizer_tpu/nodes/__init__.py``.

Both packages register the same node ids, so one ComfyUI install loads
one of them, not both.
"""

from __future__ import annotations

from .comfy_compat import ComfyExtension
from .inverse_node import VideoStabilizerInverse
from .motion_apply_node import VideoStabilizerMotionApply
from .replacements import register_node_replacements
from .shake_nodes import (
    VideoStabilizerShakeGenerator,
    VideoStabilizerShakeGeneratorManual,
)
from .stabilizer_nodes import VideoStabilizerClassic, VideoStabilizerFlow

__all__ = [
    "VideoStabilizerClassic",
    "VideoStabilizerFlow",
    "VideoStabilizerMotionApply",
    "VideoStabilizerShakeGenerator",
    "VideoStabilizerShakeGeneratorManual",
    "VideoStabilizerInverse",
    "VideoStabilizerSuiteExtension",
    "comfy_entrypoint",
    "ALL_NODES",
]

ALL_NODES = [
    VideoStabilizerClassic,
    VideoStabilizerFlow,
    VideoStabilizerMotionApply,
    VideoStabilizerShakeGenerator,
    VideoStabilizerShakeGeneratorManual,
    VideoStabilizerInverse,
]


class VideoStabilizerSuiteExtension(ComfyExtension):
    async def get_node_list(self) -> list:
        return list(ALL_NODES)

    async def on_load(self) -> None:
        await register_node_replacements()


async def comfy_entrypoint() -> VideoStabilizerSuiteExtension:
    """Return the extension instance ComfyUI uses to discover nodes."""
    return VideoStabilizerSuiteExtension()
