"""Video I/O bridge, device policy, and the spans and counters of utils/profiling.py.

Exports the JAX package's ``utils`` names.  The video_io ones load at
first use (PEP 562): an eager import would loop, as ``ops/warp.py``
imports ``utils.meshinfo`` and ``utils/video_io.py`` imports
``ops/warp.py``.
"""

from .color import DEFAULT_PADDING_RGB, parse_padding_color  # noqa: F401

_VIDEO_IO = ("FrameAdapter", "VideoContext", "convert_masks_for_output", "normalize_video_input",
             "reconstruct_video", "resolve_fps")


def __getattr__(name: str):
    if name in _VIDEO_IO:
        from . import video_io

        return getattr(video_io, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
