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
(N, H, W) float32 CPU masks.  A contiguous float32 CUDA tensor reaches
the host through its device's ring of pinned slots (``RING_SLOTS`` of
``RING_SLOT_BYTES``, made at the device's first egress and kept): chunk
by chunk, each chunk's copy queued on the device's current stream, the
host placing a finished slot into new pageable memory (mapped in one
call, ``_new_host_f32``) on torch's intra-op threads while the next
slots' copies run.  Any other tensor takes one ``.to("cpu",
torch.float32)``.

The stabilizer node's two outputs have the input's shape under ``crop``
and ``crop_and_pad``, so :func:`reserve_host_outputs` has them mapped and
populated on one background thread while the call uploads and computes,
and the ring places the slots into them.

A context may hold frame shards (parallel/mesh.py::FrameShards, made by
parallel/production.py::sharded_video_context), and a result on a mesh
of more than one shard holds them too; :func:`reconstruct_video` and
:func:`convert_masks_for_output` gather them to the host.
"""

from __future__ import annotations

import math
import mmap
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Dict, List, Literal, Optional, Tuple

import numpy as np
import torch

from ..ops.warp import will_stream
from ..parallel.mesh import FrameShards, lead_device
from . import profiling as P
from .device import resolve_device
from .meshinfo import active_mesh

_FRAME_KEYS = ("frames", "images", "video")

# The egress's pinned ring a CUDA device keeps (sizes timed on an H100's
# host: PERF.md section 6).
RING_SLOT_BYTES = 32 << 20
RING_SLOTS = 3


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


def _chw(frame_shape) -> bool:
    """True when a 3-D frame shape reads as channels first."""
    return frame_shape[0] in (1, 3, 4) and frame_shape[0] < frame_shape[-1]


def _normalize_batch(arr: torch.Tensor, origin: str, detect_chw: bool = True):
    """4-D batch -> (float32 RGB batch, FrameAdapter), on arr's device."""
    channel_first = detect_chw and _chw(arr.shape[1:])
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
    if frame.ndim == 3 and _chw(frame.shape):
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


def plan_chunks(n: int, slot_elems: int, slots: int) -> List[Tuple[int, int, int]]:
    """(slot, start, stop) of each chunk of a flat range ``[0, n)`` cut into
    pieces of at most ``slot_elems`` elements, in order, the ``slots``
    slots taken in turn."""
    return [(i % slots, a, min(a + slot_elems, n)) for i, a in enumerate(range(0, n, slot_elems))]


class _PinnedRing:
    """One CUDA device's pinned float32 host slots, each with the event of
    the last copy queued into it; the lock gives them to one egress at a
    time."""

    def __init__(self):
        self.lock = threading.Lock()
        self.slots = [torch.empty(RING_SLOT_BYTES // 4, dtype=torch.float32, pin_memory=True)
                      for _ in range(RING_SLOTS)]
        self.copied = [torch.cuda.Event() for _ in range(RING_SLOTS)]


_RINGS: Dict[torch.device, _PinnedRing] = {}
_RINGS_LOCK = threading.Lock()


def _ring(device: torch.device) -> _PinnedRing:
    with _RINGS_LOCK:
        ring = _RINGS.get(device)
        if ring is None:
            ring = _RINGS[device] = _PinnedRing()
    return ring


_MAP_POPULATE = getattr(mmap, "MAP_POPULATE", None)


def _new_host_f32(shape) -> torch.Tensor:
    """An uninitialised contiguous float32 CPU tensor of ``shape`` in new
    pageable memory whose pages are already mapped: where the platform has
    ``MAP_POPULATE``, one private anonymous mapping that the kernel fills
    in one call (not a page fault a page, as the first write into
    ``torch.empty``'s memory takes), unmapped when the tensor's storage is
    freed (a storage that cannot grow by ``resize_``); elsewhere
    ``torch.empty``."""
    nbytes = 4 * math.prod(shape)
    if _MAP_POPULATE is None or nbytes == 0:
        return torch.empty(shape, dtype=torch.float32)
    buf = mmap.mmap(-1, nbytes, flags=mmap.MAP_PRIVATE | mmap.MAP_ANONYMOUS | _MAP_POPULATE)
    return torch.frombuffer(buf, dtype=torch.float32).view(shape)


_POPULATOR: Optional[ThreadPoolExecutor] = None
_POPULATOR_LOCK = threading.Lock()


def _populator() -> ThreadPoolExecutor:
    """The process's one thread that maps and populates reserved outputs,
    started at the first reservation."""
    global _POPULATOR
    with _POPULATOR_LOCK:
        if _POPULATOR is None:
            _POPULATOR = ThreadPoolExecutor(max_workers=1, thread_name_prefix="cvst-populate")
    return _POPULATOR


def _populate(shape: Tuple[int, ...]) -> Tuple[torch.Tensor, int]:
    """``_new_host_f32(shape)`` and the microseconds it took (on the worker)."""
    start = time.perf_counter_ns()
    out = _new_host_f32(shape)
    return out, (time.perf_counter_ns() - start) // 1000


class ReservedOutput:
    """One float32 host output of a known shape, mapped and populated by
    ``_new_host_f32`` on the populate worker while the caller works.  It
    is spent once: the egress takes it, or it is dropped, and a dropped
    buffer is unmapped as soon as the worker has finished with it (the
    caller never waits for that)."""

    def __init__(self, shape: Tuple[int, ...]):
        self.numel = math.prod(shape)
        self._future: Optional[Future] = _populator().submit(_populate, tuple(shape))

    def take(self, t: torch.Tensor) -> Optional[torch.Tensor]:
        """The buffer viewed as ``t``'s shape, waited for in an
        ``io.egress.reserve_wait`` span that counts the worker's
        ``io.host_populate_us``; None (the buffer dropped) when its element
        count is not ``t``'s or the worker's mapping raised."""
        future, self._future = self._future, None
        if future is None or t.numel() != self.numel:
            if future is not None:
                future.cancel()
            return None
        with P.span("io.egress.reserve_wait", t.device) as s:
            try:
                out, us = future.result()
            except OSError:
                return None  # the egress maps its own output, and raises there if memory is short
            s.count("io.host_populate_us", us)
        return out.view(t.shape)

    def drop(self) -> None:
        future, self._future = self._future, None
        if future is not None:
            future.cancel()  # a population still queued never runs


@dataclass
class HostOutputs:
    """A node call's reserved frames and masks (None: not reserved); as a
    context, it drops on exit whatever the egress did not take."""

    frames: Optional[ReservedOutput] = None
    masks: Optional[ReservedOutput] = None

    def __enter__(self) -> "HostOutputs":
        return self

    def __exit__(self, *exc) -> bool:
        for reserved in (self.frames, self.masks):
            if reserved is not None:
                reserved.drop()
        return False


def _reservable_shape(value: Any, dev: torch.device, framing_mode: str) -> Optional[Tuple[int, int, int]]:
    """(N, H, W) of the stabilizer's outputs for ``value`` when they can be
    reserved before its upload: on a CUDA device with ``MAP_POPULATE``,
    no mesh of more than one device, a 4-D tensor or array that does not
    stream, and a framing that keeps the input's size; else None.  H and W
    follow ``_normalize_batch``'s CHW test (``_chw``) on the first frame's
    shape."""
    if dev.type != "cuda" or framing_mode not in ("crop", "crop_and_pad") or _MAP_POPULATE is None:
        return None
    mesh = active_mesh()
    if mesh is not None and mesh.size > 1:
        return None
    frames = next((value[k] for k in _FRAME_KEYS if k in value), None) if isinstance(value, dict) else value
    if (not isinstance(frames, (torch.Tensor, np.ndarray)) or frames.ndim != 4 or not frames.shape[0]
            or _streams(frames.shape[0], frames[0])):
        return None
    first = tuple(int(d) for d in frames.shape[1:])
    height, width = first[1:] if _chw(first) else first[:2]
    return int(frames.shape[0]), height, width


def reserve_host_outputs(value: Any, device: torch.device, framing_mode: str) -> HostOutputs:
    """The stabilizer node's (N, H, W, 3) frames and (N, H, W) masks for the
    input ``value``, reserved in that order on the populate worker when
    :func:`_reservable_shape` allows, else nothing reserved."""
    shape = _reservable_shape(value, device, framing_mode)
    if shape is None:
        return HostOutputs()
    return HostOutputs(ReservedOutput((*shape, 3)), ReservedOutput(shape))


def _staged_to_cpu(t: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A contiguous float32 CUDA tensor copied through its device's pinned
    ring into ``out`` (a contiguous float32 CPU tensor of ``t``'s shape),
    else into new pageable host memory.  A chunk's copy into its slot is
    queued on the device's current stream, so it follows the work that
    wrote the tensor; the host waits for the chunk's event, places the slot
    into its range of the output (a CPU ``copy_``, which the intra-op
    threads share) and only then queues the copy that refills the slot, so
    the other slots' copies run behind the host's work."""
    if out is None:
        out = _new_host_f32(t.shape)
    src, dst = t.view(-1), out.view(-1)
    ring = _ring(t.device)
    depth = len(ring.slots)
    plan = plan_chunks(src.numel(), ring.slots[0].numel(), depth)
    stream = torch.cuda.current_stream(t.device)

    def queue(i):
        slot, a, b = plan[i]
        ring.slots[slot][:b - a].copy_(src[a:b], non_blocking=True)
        ring.copied[slot].record(stream)

    with ring.lock:
        try:
            for i in range(min(depth, len(plan))):
                queue(i)
            for i, (slot, a, b) in enumerate(plan):
                ring.copied[slot].synchronize()
                dst[a:b].copy_(ring.slots[slot][:b - a])
                if i + depth < len(plan):
                    queue(i + depth)
        except BaseException:
            stream.synchronize()  # no queued copy into a slot outlives the egress that queued it
            raise
    return out


def _to_cpu_f32(x: Any, reserved: Optional[ReservedOutput] = None) -> torch.Tensor:
    """``x`` as a contiguous float32 CPU tensor, in an ``io.egress.copy``
    span that counts the bytes the copy moves from a device (``io.d2h_bytes``;
    0 from the host), those of them staged through the pinned ring
    (``io.d2h_staged_bytes``) and those placed into ``reserved``
    (``io.d2h_reserved_bytes``).  The ring takes ``reserved`` when it has
    ``x``'s element count; otherwise it is dropped."""
    on_device = isinstance(x, (torch.Tensor, FrameShards)) and lead_device(x).type != "cpu"
    with P.span("io.egress.copy", lead_device(x) if on_device else None) as s:
        if isinstance(x, FrameShards):
            x = x.gather("cpu")
        t = (x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))).detach()
        staged = t.is_cuda and t.dtype == torch.float32 and t.is_contiguous()
        if reserved is not None and not staged:
            reserved.drop()
        into = reserved.take(t) if reserved is not None and staged else None
        out = _staged_to_cpu(t, into) if staged else t.to("cpu", torch.float32).contiguous()
        s.count("io.d2h_bytes", out.nbytes if on_device else 0)
        s.count("io.d2h_staged_bytes", out.nbytes if staged else 0)
        s.count("io.d2h_reserved_bytes", out.nbytes if into is not None else 0)
    return out


def reconstruct_video(frames: Any, context: VideoContext, reserved: Optional[ReservedOutput] = None) -> Any:
    """Pack frames into a contiguous float32 BHWC CPU tensor payload (placed
    into ``reserved`` where it serves: ``_to_cpu_f32``)."""
    with P.span("io.egress"):
        return _reconstruct_video(frames, context, reserved)


def _reconstruct_video(frames: Any, context: VideoContext, reserved: Optional[ReservedOutput]) -> Any:
    if getattr(frames, "ndim", None) == 4:
        stacked = _to_cpu_f32(frames, reserved)
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


def convert_masks_for_output(masks: Any, reserved: Optional[ReservedOutput] = None) -> torch.Tensor:
    """Internal masks -> (N, H, W) float32 CPU tensor (placed into
    ``reserved`` where it serves: ``_to_cpu_f32``)."""
    with P.span("io.egress"):
        return _convert_masks_for_output(masks, reserved)


def _convert_masks_for_output(masks: Any, reserved: Optional[ReservedOutput]) -> torch.Tensor:
    if getattr(masks, "ndim", None) in (3, 4):
        stacked = _to_cpu_f32(masks, reserved)
        if stacked.shape[0] == 0:
            return torch.zeros((1, 1, 1), dtype=torch.float32)
        return (stacked[..., 0] if stacked.ndim == 4 else stacked).contiguous()
    masks_2d = [_to_cpu_f32(m) for m in masks]
    masks_2d = [m[..., 0] if m.ndim == 3 else m for m in masks_2d]
    if not masks_2d:
        return torch.zeros((1, 1, 1), dtype=torch.float32)
    return torch.stack(masks_2d).contiguous()
