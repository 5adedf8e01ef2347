"""Tensor ops and the wrappers of the hand-written CUDA kernels.

Exports the JAX package's ``ops`` names, the warps of ``ops/warp.py``,
at first use (PEP 562), so that importing one op does not load the warp
and the modules it imports.
"""

_WARP = ("coverage_mask", "warp_clip", "warp_clip_with_mask", "warp_clip_blur")


def __getattr__(name: str):
    if name in _WARP:
        from . import warp

        return getattr(warp, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
