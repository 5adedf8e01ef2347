"""PyTorch + CUDA port of the video stabilizer, for NVIDIA Hopper (H100).

The JAX package ``comfyui_video_stabilizer_tpu`` beside it is the
reference this package is held against.  The layers mirror it:
``ops/`` (kernel wrappers and tensor ops), ``models/`` (engines),
``nodes/`` (ComfyUI shells), ``meta/`` (motion_meta v2), ``native/``
(the host largest rectangle and corner greedy), ``utils/`` (I/O, device
policy, timing) and ``csrc/`` (the hand-written CUDA kernels).  The JAX
package's host-only modules (``meta.motion_meta``, ``models.geometry``,
``models.shake``, ``utils.color`` and ``native/rectangle.cpp``) are
copied, not imported.  Each ``__init__`` exports the public names of its
JAX counterpart; this one loads only the motion_meta copy (numpy), no
engine and no torch.

Device policy: engine entry points take ``device`` and default to
``"cuda"``; asking for CUDA without a card raises.  Ops follow the
device of the tensors they are given: a CUDA tensor launches the
hand-written kernel (or raises), a CPU tensor takes its plain PyTorch
version.  This package never imports JAX, nor any module of the JAX
package.

The port does everything the JAX package does: the Flow stabilizer
(DIS, TV-L1 and phase-correlation tiers) and the Classic stabilizer
(GFTT + pyramidal LK) in every framing and transform mode, with the
zero-sync fast path; Motion Apply (all three framings, shutter blur),
the shake generators and the legacy inverse engine, with all six nodes;
streaming of clips past the card's memory; and multi-device runs
(``parallel/``: a device mesh, the engines sharded over it, and the
whole-clip sidecar steps).
"""

from __future__ import annotations

__version__ = "0.1.0"

from .meta.motion_meta import (  # noqa: F401
    FrameTransform,
    MotionMeta,
    applied_motion_meta_from_stabilization_warp,
    build_motion_meta_v2,
    motion_meta_from_stabilization_warp,
    resolve_motion_meta,
    validate_motion_meta,
)


def apply_inverse_stabilization(*args, **kwargs):
    """The legacy inverse engine (models/inverse.py), exported lazily as
    in the JAX package: importing this package loads no engine."""
    from .models.inverse import apply_inverse_stabilization as _impl

    return _impl(*args, **kwargs)


async def comfy_entrypoint():
    """ComfyUI extension entrypoint (lazy: the nodes import torch)."""
    from .nodes import comfy_entrypoint as _entry

    return await _entry()
