"""PyTorch + CUDA port of the video stabilizer, for NVIDIA Hopper (H100).

The JAX package ``comfyui_video_stabilizer_tpu`` beside it is the
reference this package is held against.  The layers mirror it:
``ops/`` (kernel wrappers and tensor ops), ``models/`` (engines),
``nodes/`` (ComfyUI shells), ``utils/`` (I/O, device policy, timing)
and ``csrc/`` (the hand-written CUDA kernels).  Host-only modules of
the JAX package that import no JAX (``meta.motion_meta``,
``models.geometry``, ``utils.color``) are used by import.

Device policy: engine entry points take ``device`` and default to
``"cuda"``; asking for CUDA without a card raises.  Ops follow the
device of the tensors they are given: a CUDA tensor launches the
hand-written kernel (or raises), a CPU tensor takes its plain PyTorch
version.  This package never imports JAX.

Ported so far: the Flow stabilizer (DIS tier) and the Classic
stabilizer (GFTT + pyramidal LK) with crop_and_pad and expand framing
and the translation/similarity models.
"""

from __future__ import annotations


async def comfy_entrypoint():
    """ComfyUI extension entrypoint (lazy: the nodes import torch)."""
    from .nodes import comfy_entrypoint as _entry

    return await _entry()
