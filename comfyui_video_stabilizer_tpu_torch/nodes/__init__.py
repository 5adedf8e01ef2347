"""Node registration of the PyTorch package (the Classic and Flow nodes so far).

Both packages register the same node ids, so one ComfyUI install loads
one of them, not both.
"""

from __future__ import annotations

from .comfy_compat import ComfyExtension
from .stabilizer_nodes import VideoStabilizerClassic, VideoStabilizerFlow

__all__ = [
    "VideoStabilizerClassic",
    "VideoStabilizerFlow",
    "VideoStabilizerSuiteExtension",
    "comfy_entrypoint",
    "ALL_NODES",
]

ALL_NODES = [VideoStabilizerClassic, VideoStabilizerFlow]


class VideoStabilizerSuiteExtension(ComfyExtension):
    async def get_node_list(self) -> list:
        return list(ALL_NODES)


async def comfy_entrypoint() -> VideoStabilizerSuiteExtension:
    """Return the extension instance ComfyUI uses to discover nodes."""
    return VideoStabilizerSuiteExtension()
