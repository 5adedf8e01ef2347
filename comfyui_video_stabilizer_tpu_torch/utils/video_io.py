"""Video payload <-> device tensor bridge.

Counterpart of ``comfyui_video_stabilizer_tpu/utils/video_io.py``.
Normalization produces ONE contiguous float32 (N, H, W, 3) RGB 0..1
tensor on the requested device.  A 4-D tensor or array is converted
there with the reference's heuristics (CHW detection on the first
frame, grayscale expanded to 3 channels, extra channels truncated,
uint8 scaled by 1/255, float frames whose max exceeds 1.5 scaled per
frame); a CUDA tensor stays on its card.  Frame sequences take the same
heuristics frame by frame, with the reference's per-frame layout rules
(a leading singleton dim squeezed, 2-D frames given one channel).  A
clip whose warp would stream through time chunks on the device
(``ops/warp.py::will_stream``) is normalized where it lies, on the
host, and the engines upload it chunk by chunk.

At the node boundary the output is what the JAX package emits: a
contiguous float32 BHWC CPU tensor (the dict template refilled) and
(N, H, W) float32 CPU masks.

A context may hold frame shards (parallel/mesh.py::FrameShards, made by
parallel/production.py::sharded_video_context), and a result on a mesh
of more than one shard holds them too; :func:`reconstruct_video` and
:func:`convert_masks_for_output` gather them to the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Literal

import numpy as np
import torch

from ..ops.warp import will_stream
from ..parallel.mesh import FrameShards, lead_device
from . import profiling as P
from .device import resolve_device

_FRAME_KEYS = ("frames", "images", "video")


@dataclass
class FrameAdapter:
    """Context captured from the input, kept for reconstruction."""

    dtype: torch.dtype
    channel_first: bool
    value_range: Literal["0_1", "0_255"]
    origin: Literal["numpy", "torch"]
    squeeze_last_dim: bool


@dataclass
class VideoContext:
    """Normalized clip: frames is a float32 (N, H, W, 3) RGB 0..1 tensor,
    or its frame shards on a mesh."""

    frames: torch.Tensor | FrameShards
    adapter: FrameAdapter
    width: int
    height: int
    channels: int
    fps: float | None
    template_kind: Literal["dict", "sequence"]
    template_meta: Dict[str, Any]

    @property
    def frame_count(self) -> int:
        return int(self.frames.shape[0])


def resolve_fps(context: VideoContext, frame_rate: float, default: float = 16.0) -> float:
    for candidate in (context.fps, frame_rate, default):
        if isinstance(candidate, (int, float)) and np.isfinite(candidate) and candidate > 0.0:
            return float(candidate)
    return float(default)


def _level_count(device: torch.device) -> torch.Tensor:
    """255 as a 0-dim float32 tensor on ``device``: the divisor of the
    0..255 -> 0..1 scaling.  The reference divides in numpy; on the card
    a tensor divided by a Python number (or by a CPU scalar tensor) is
    multiplied by the reciprocal instead, which puts about half of the
    256 uint8 levels one ulp off, so the divisor lives on the device."""
    return torch.full((), 255.0, dtype=torch.float32, device=device)


def _normalize_batch(arr: torch.Tensor, origin: str, detect_chw: bool = True):
    """4-D batch -> (float32 RGB batch, FrameAdapter), on arr's device."""
    first = arr[0]
    channel_first = detect_chw and first.shape[0] in (1, 3, 4) and first.shape[0] < first.shape[-1]
    if channel_first:
        arr = arr.movedim(1, -1)
    squeeze_last_dim = arr.shape[-1] == 1
    src_dtype = arr.dtype
    if src_dtype == torch.uint8:
        batch = arr.to(torch.float32) / _level_count(arr.device)
        value_range = "0_255"
    else:
        batch = arr.to(torch.float32)
        value_range = "0_1"
        if batch.numel():
            needs_scale = batch.reshape(batch.shape[0], -1).amax(dim=1) > 1.5
            if bool(needs_scale.any()):
                batch = torch.where(needs_scale[:, None, None, None], batch / _level_count(batch.device), batch)
                value_range = "0_255" if bool(needs_scale[0]) else "0_1"
    channels = batch.shape[-1]
    if channels == 1:
        batch = batch.expand(*batch.shape[:-1], 3)
    elif channels > 3:
        batch = batch[..., :3]
    elif channels == 2:
        batch = torch.cat([batch, torch.zeros_like(batch[..., :1])], dim=-1)
    adapter = FrameAdapter(src_dtype, channel_first, value_range, origin, squeeze_last_dim)
    return batch.contiguous(), adapter


def _as_tensor(value: Any):
    if isinstance(value, torch.Tensor):
        return value.detach(), "torch"
    return torch.from_numpy(np.ascontiguousarray(np.asarray(value))), "numpy"


def _frame_layout(frame: torch.Tensor):
    """Per-frame layout rules; returns (HWC frame, channel_first, squeeze)."""
    channel_first = False
    if frame.ndim == 3 and frame.shape[0] in (1, 3, 4) and frame.shape[0] < frame.shape[-1]:
        channel_first = True
        frame = frame.movedim(0, -1)
    elif frame.ndim == 4 and frame.shape[0] == 1:
        frame = frame[0]
    squeeze_last_dim = frame.ndim == 2 or (frame.ndim == 3 and frame.shape[2] == 1)
    if frame.ndim == 2:
        frame = frame[..., None]
    return frame, channel_first, squeeze_last_dim


def _normalize_sequence(frames_seq: Any, dev: torch.device):
    """Frame-by-frame normalization of a sequence (or a 3-D stack)."""
    frames: List[torch.Tensor] = []
    adapter = None
    for frame in frames_seq:
        t, origin = _as_tensor(frame)
        hwc, channel_first, squeeze_last_dim = _frame_layout(t)
        rgb, frame_adapter = _normalize_batch(_upload(hwc[None], dev), origin, detect_chw=False)
        frame_adapter.channel_first = channel_first
        frame_adapter.squeeze_last_dim = squeeze_last_dim
        if adapter is None:
            adapter = frame_adapter
        elif (frame_adapter.channel_first != adapter.channel_first
              or frame_adapter.origin != adapter.origin):
            raise ValueError("Mixed tensor layouts within the same video sequence are not supported.")
        frames.append(rgb[0])
    if not frames:
        raise ValueError("The input video sequence is empty.")
    return torch.stack(frames).contiguous(), adapter


def _streams(n: int, first_frame: Any) -> bool:
    """True when n frames shaped like ``first_frame`` stream on the device."""
    hwc, _, _ = _frame_layout(_as_tensor(first_frame)[0])
    return will_stream(n, int(hwc.shape[0]), int(hwc.shape[1]), int(hwc.shape[0]), int(hwc.shape[1]), 3)


def _upload(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``t`` on ``dev``, in an ``io.ingest.copy`` span that counts the bytes
    the copy moves from another device (``io.h2d_bytes``; 0 from ``dev``)."""
    with P.span("io.ingest.copy", dev) as s:
        out = t.to(dev)
        s.count("io.h2d_bytes", t.nbytes if t.device != out.device else 0)
    return out


def normalize_video_input(value: Any, device: str | torch.device = "cuda") -> VideoContext:
    """Normalize any accepted video payload into a VideoContext on ``device``
    (on the host instead for a clip that streams)."""
    dev = resolve_device(device)
    with P.span("io.ingest", dev):
        return _normalize_video_input(value, dev)


def _normalize_video_input(value: Any, dev: torch.device) -> VideoContext:
    if isinstance(value, dict):
        frames_seq = next((value[k] for k in _FRAME_KEYS if k in value), None)
        if frames_seq is None:
            raise ValueError("Video input dictionary must contain 'frames'.")
        template_kind: Literal["dict", "sequence"] = "dict"
        template_meta = {k: v for k, v in value.items() if k not in _FRAME_KEYS}
        fps = template_meta.get("fps")
    else:
        frames_seq = value
        template_kind = "sequence"
        template_meta = {}
        fps = None

    if not isinstance(frames_seq, (list, tuple)):
        frames_seq, origin = _as_tensor(frames_seq)
    if isinstance(frames_seq, torch.Tensor) and frames_seq.ndim == 4:
        if frames_seq.shape[0] and _streams(frames_seq.shape[0], frames_seq[0]):
            dev = frames_seq.device
        uploaded = _upload(frames_seq, dev)
        with P.span("io.ingest.normalize", dev):
            batch, adapter = _normalize_batch(uploaded, origin)
    else:
        if isinstance(frames_seq, torch.Tensor) and frames_seq.ndim < 3:
            raise ValueError("Video input must have at least 3 dimensions (frames, height, width).")
        if len(frames_seq) and _streams(len(frames_seq), frames_seq[0]):
            dev = torch.device("cpu")
        batch, adapter = _normalize_sequence(frames_seq, dev)

    if batch.shape[0] == 0:
        raise ValueError("The input video sequence is empty.")
    height, width, channels = batch.shape[1:]
    return VideoContext(
        frames=batch,
        adapter=adapter,
        width=int(width),
        height=int(height),
        channels=int(channels),
        fps=fps,
        template_kind=template_kind,
        template_meta=template_meta,
    )


def _to_cpu_f32(x: Any) -> torch.Tensor:
    """``x`` as a contiguous float32 CPU tensor, in an ``io.egress.copy``
    span that counts the bytes the copy moves from a device (``io.d2h_bytes``;
    0 from the host)."""
    on_device = isinstance(x, (torch.Tensor, FrameShards)) and lead_device(x).type != "cpu"
    with P.span("io.egress.copy", lead_device(x) if on_device else None) as s:
        if isinstance(x, FrameShards):
            x = x.gather("cpu")
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
        out = t.detach().to("cpu", torch.float32).contiguous()
        s.count("io.d2h_bytes", out.nbytes if on_device else 0)
    return out


def reconstruct_video(frames: Any, context: VideoContext) -> Any:
    """Pack frames into a contiguous float32 BHWC CPU tensor payload."""
    with P.span("io.egress"):
        return _reconstruct_video(frames, context)


def _reconstruct_video(frames: Any, context: VideoContext) -> Any:
    if getattr(frames, "ndim", None) == 4:
        stacked = _to_cpu_f32(frames)
    else:
        frame_list: List[Any] = list(frames)
        stacked = torch.stack([_to_cpu_f32(f) for f in frame_list]) if frame_list else None
    if stacked is None or stacked.shape[0] == 0:
        stacked = torch.zeros((1, context.height, context.width, 3), dtype=torch.float32)
    if context.template_kind == "dict":
        payload = dict(context.template_meta)
        payload["frames"] = stacked
        return payload
    return stacked


def convert_masks_for_output(masks: Any) -> torch.Tensor:
    """Internal masks -> (N, H, W) float32 CPU tensor."""
    with P.span("io.egress"):
        return _convert_masks_for_output(masks)


def _convert_masks_for_output(masks: Any) -> torch.Tensor:
    if getattr(masks, "ndim", None) in (3, 4):
        stacked = _to_cpu_f32(masks)
        if stacked.shape[0] == 0:
            return torch.zeros((1, 1, 1), dtype=torch.float32)
        return (stacked[..., 0] if stacked.ndim == 4 else stacked).contiguous()
    masks_2d = [_to_cpu_f32(m) for m in masks]
    masks_2d = [m[..., 0] if m.ndim == 3 else m for m in masks_2d]
    if not masks_2d:
        return torch.zeros((1, 1, 1), dtype=torch.float32)
    return torch.stack(masks_2d).contiguous()
