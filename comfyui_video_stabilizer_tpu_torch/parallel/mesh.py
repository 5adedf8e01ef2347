"""Device meshes, frame shards and the copies between devices.

Counterpart of ``comfyui_video_stabilizer_tpu/parallel/mesh.py``.  The
JAX package shards the frame axis of a clip over the ``data`` axis of a
``jax.sharding.Mesh`` and lets GSPMD partition its programs; the port
carries over the computation, not GSPMD: one controller runs each
device stage once for each shard, on the shard's device and its current
stream, with the hand kernels.

* :class:`DeviceMesh` is a (data, spatial) grid of ``torch.device``\\ s;
  its lead device, ``devices[0, 0]``, runs what is global over the clip
  (the fits, the trajectory).
* :class:`FrameShards` is the counterpart of a sharded ``jax.Array``:
  one clip as per-shard tensors in order, each on its device, split
  along the frame axis (``axis=0``) or into bands of rows (``axis=1``).
* :func:`move` is the one way data crosses devices on the mesh path.  A
  copy between two cards is ``Tensor.to``, which PyTorch orders against
  both devices' current streams (the copy waits for the destination's
  stream and the destination's stream waits for the copy); on a
  repeated device it is the tensor itself, no copy, and is not counted.
  ``TRANSFERS`` counts the copies by kind.

A mesh may repeat a device: ``make_mesh(devices=["cpu"] * 8)`` is the
counterpart of the JAX tests' 8 virtual CPU devices, and
``["cuda:0"] * 4`` runs four shards on one card.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..utils.meshinfo import active_mesh

# cross-device copies on the mesh path since the last reset, by kind:
# "halo" (a neighbour shard's frame), "gather" (to the lead device or
# the host), "scatter" (to a shard's device)
TRANSFERS: Dict[str, int] = {"halo": 0, "gather": 0, "scatter": 0}


def reset_transfers() -> None:
    for kind in TRANSFERS:
        TRANSFERS[kind] = 0


def _device(device) -> torch.device:
    """``device`` as a ``torch.device`` with its index ('cuda' is the
    current card); raises for CUDA without a card."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {str(dev)!r} requested but torch.cuda.is_available() is False")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r}: use 'cuda[:i]' or 'cpu'")
    return dev


def move(t: torch.Tensor, device, kind: str) -> torch.Tensor:
    """``t`` on ``device``: itself when it is there already, else a copy
    ordered against both devices' current streams, counted in
    ``TRANSFERS[kind]``."""
    dev = _device(device)
    if t.device == dev:
        return t
    TRANSFERS[kind] += 1
    return t.to(dev)


class DeviceMesh:
    """A (data, spatial) grid of devices: ``devices`` is an object array of
    ``torch.device``, ``shape`` the axis sizes by name."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str] = ("data", "spatial")):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != 2 or len(axis_names) != 2:
            raise ValueError("a DeviceMesh is a 2-D grid with two axis names")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def lead(self) -> torch.device:
        """The device that runs what is global over the clip."""
        return self.devices[0, 0]

    def __repr__(self) -> str:
        return f"DeviceMesh({self.shape}, devices={[str(d) for d in self.devices.reshape(-1)]})"


def make_mesh(
    n_devices: int | None = None,
    axis_names: Sequence[str] = ("data", "spatial"),
    spatial: int | None = None,
    devices: Sequence | None = None,
) -> DeviceMesh:
    """A (data x spatial) mesh, data-major by default as in the JAX
    package: every device on ``data``, ``spatial`` = 1, unless ``spatial``
    asks for row bands.

    ``devices`` defaults to every card, ``cuda:0`` .. ``cuda:k-1``; with no
    card and no ``devices`` this raises (there is no CPU fallback).  A
    given list may repeat a device.  ``n_devices`` keeps the first n.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh() found no CUDA device; pass devices=[...] to build a mesh "
                               "of explicit devices (the CPU tests pass devices=['cpu'] * 8)")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = [_device(d) for d in devices]
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    if spatial is None:
        spatial = 1
    if n < 1 or spatial < 1 or n % spatial:
        raise ValueError(f"spatial={spatial} must divide the device count {n}")
    grid = np.empty((n // spatial, spatial), dtype=object)
    for i, d in enumerate(devs):
        grid[i // spatial, i % spatial] = d
    return DeviceMesh(grid, axis_names)


def partition_spec(mesh: DeviceMesh, n: int, h: int) -> Tuple:
    """How an (n, h, w, c) clip lies on ``mesh``, as the tuple of the JAX
    package's ``input_partition_spec``: frames when n divides the data
    axis, else rows when h divides the spatial axis, else replicated."""
    if n % int(mesh.shape["data"]) == 0:
        return ("data", None, None, None)
    if "spatial" in mesh.axis_names and h % int(mesh.shape["spatial"]) == 0:
        return (None, "spatial", None, None)
    return (None, None, None, None)


def even_spans(n: int, parts: int) -> List[Tuple[int, int]]:
    """[(start, end)] of ``parts`` near-equal consecutive pieces of 0..n-1."""
    bounds = [n * i // parts for i in range(parts + 1)]
    return list(zip(bounds[:-1], bounds[1:]))


class FrameShards:
    """One clip as per-shard tensors, in order, each on its own device:
    split along the frame axis (``axis=0``) or into row bands
    (``axis=1``).  The counterpart of a sharded ``jax.Array``: ``shape``
    is the whole clip's, ``gather(device)`` (and ``numpy.asarray``) brings
    it together."""

    def __init__(self, shards: Sequence[torch.Tensor], axis: int = 0):
        if not shards:
            raise ValueError("FrameShards needs at least one shard")
        self.shards = tuple(shards)
        self.axis = int(axis)

    @property
    def devices(self) -> List[torch.device]:
        return [s.device for s in self.shards]

    @property
    def lead(self) -> torch.device:
        return self.shards[0].device

    @property
    def shape(self) -> Tuple[int, ...]:
        dims = list(self.shards[0].shape)
        dims[self.axis] = sum(int(s.shape[self.axis]) for s in self.shards)
        return tuple(dims)

    @property
    def ndim(self) -> int:
        return self.shards[0].ndim

    @property
    def spans(self) -> List[Tuple[int, int]]:
        """[(start, end)] of each shard along ``axis``."""
        out, pos = [], 0
        for s in self.shards:
            out.append((pos, pos + int(s.shape[self.axis])))
            pos += int(s.shape[self.axis])
        return out

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "FrameShards":
        """``fn`` on each shard, on its device."""
        return FrameShards([fn(s) for s in self.shards], self.axis)

    def gather(self, device=None) -> torch.Tensor:
        """The whole clip on ``device`` (default: the lead shard's)."""
        dev = self.lead if device is None else device
        return torch.cat([move(s, dev, "gather") for s in self.shards], dim=self.axis)

    def __array__(self, dtype=None, copy=None):
        arr = self.gather("cpu").numpy()
        return arr if dtype is None else arr.astype(dtype)

    def __repr__(self) -> str:
        return f"FrameShards(shape={self.shape}, axis={self.axis}, devices={[str(d) for d in self.devices]})"


def split_frames(frames: torch.Tensor, devices: Sequence) -> FrameShards:
    """``frames`` cut along the frame axis into len(devices) even shards,
    each moved to its device (a view where it lies there already)."""
    spans = even_spans(int(frames.shape[0]), len(devices))
    return FrameShards([move(frames[s:e], d, "scatter") for (s, e), d in zip(spans, devices)])


def _with_halo(shards: FrameShards, k: int) -> torch.Tensor:
    """Shard k of per-frame tensors with the next shard's first frame
    appended (copied from its device when it lies on another): every
    adjacent pair whose leading frame the shard owns, the one that
    crosses into the next shard included."""
    part = shards.shards[k]
    if k + 1 == len(shards.shards):
        return part
    halo = move(shards.shards[k + 1][:1], part.device, "halo")
    return torch.cat([part, halo], dim=0)


def sharded_pairs(shards: FrameShards, per_pair, tick_pairs=None):
    """``per_pair(frames_k, tick_k)`` over each frame shard with its halo,
    on the shard's device, in shard order; ``tick_pairs`` (when given)
    sees global pair counts.  Returns the per-shard results (tuples or
    tensors) gathered to the lead device, shards without a pair left out.
    Each pair is computed once, from the frames an unsharded call gives
    it."""
    lead = shards.lead
    parts, done = [], 0
    sizes = [int(s.shape[0]) for s in shards.shards]
    for k, nxt in enumerate(sizes[1:] + [0]):
        pairs = sizes[k] + min(nxt, 1) - 1  # the halo is the next shard's first frame, if it has one
        if pairs < 1:
            continue
        frames_k = _with_halo(shards, k)
        tick_k = None if tick_pairs is None else (lambda p, base=done: tick_pairs(base + p))
        out = per_pair(frames_k, tick_k)
        if isinstance(out, tuple):
            parts.append(tuple(move(x, lead, "gather") for x in out))
        else:
            parts.append(move(out, lead, "gather"))
        done += pairs
        if tick_pairs is not None:
            tick_pairs(done)
    return parts


def upload_shards(host: torch.Tensor, devices: Sequence) -> FrameShards:
    """A host clip cut along the frame axis into near-even shards, one
    uploaded to each device (a shard left empty is left out)."""
    spans = even_spans(int(host.shape[0]), len(devices))
    return FrameShards([host[s:e].to(d) for (s, e), d in zip(spans, devices) if e > s])


def data_devices(mesh: DeviceMesh) -> List[torch.device]:
    """The devices of the data axis (spatial index 0), in shard order."""
    return list(mesh.devices[:, 0])


def frame_shards(frames):
    """``frames`` as frame shards: a FrameShards as it is; a tensor on the
    host or a device, under an active mesh whose data axis splits it
    evenly, split over the data axis; else None."""
    if isinstance(frames, FrameShards):
        return frames if frames.axis == 0 else None
    mesh = active_mesh()
    if mesh is None or not isinstance(frames, torch.Tensor):
        return None
    n = int(frames.shape[0])
    nd = int(mesh.shape["data"])
    if nd > 1 and partition_spec(mesh, n, int(frames.shape[1]))[0] == "data":
        return split_frames(frames, data_devices(mesh))
    return None


def row_band_devices(n: int, h: int):
    """The devices of the row bands an (n, h, ...) clip takes under the
    active mesh (the "rows" outcome of :func:`partition_spec`, spatial >
    1), else None."""
    mesh = active_mesh()
    if mesh is None or "spatial" not in mesh.axis_names:
        return None
    if partition_spec(mesh, n, h)[1] != "spatial" or int(mesh.shape["spatial"]) < 2:
        return None
    return list(mesh.devices[0, :])


def lead_device(x) -> torch.device:
    """The device of a tensor, or the lead shard's of a FrameShards."""
    return x.lead if isinstance(x, FrameShards) else x.device
