"""Frame-axis sharding of the production engines over a device mesh.

Counterpart of ``comfyui_video_stabilizer_tpu/parallel/production.py``.
The engines (models/stabilize.py, driven by models/flow.py and
models/classic.py) run unchanged under ``utils.meshinfo.set_mesh``; the
clip lies on the mesh as :func:`input_partition_spec` says:

* frames -- n divides the data axis: the clip is cut into frame shards
  (parallel/mesh.py::FrameShards), one a data-axis device.  Each shard
  makes its grays and runs its pairs' estimation (K2, or K4-K7) on its
  device, with a one-frame gray halo for the pair that crosses into the
  next shard; the per-pair samples or tracks are gathered to the lead
  device, where the fits and the trajectory run; each shard's warp
  coefficients go back to it, and the padding stats and K1 run there.
  The frames and masks come back as FrameShards.
* rows -- otherwise, when h divides the spatial axis: estimation runs on
  the lead device and the warp cuts the output canvas into one band of
  rows a spatial-axis device (K1 with the band's ``row0``).
* replicated -- otherwise: the whole call runs on the lead device.

Each pair and each frame is computed from exactly the inputs an
unsharded call uses, and the RANSAC keys fold in the global pair index,
so for the similarity and translation models a sharded call equals the
unsharded call on the same device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..models.classic import stabilize_classic
from ..models.flow import stabilize_flow
from ..models.stabilize import StabilizationResult
from ..ops.warp import will_stream
from ..utils.meshinfo import set_mesh
from ..utils.video_io import FrameAdapter, VideoContext, normalize_video_input
from .mesh import DeviceMesh, data_devices, partition_spec, upload_shards


def input_partition_spec(mesh: DeviceMesh, n: int, h: int) -> Tuple:
    """How an (n, h, w, c) clip lies on ``mesh``, as the tuple of the JAX
    package's ``PartitionSpec``: ("data", None, None, None) when n
    divides the data axis; else (None, "spatial", None, None) when h
    divides the spatial axis; else replicated (all None).

    Padding the clip would change estimation and smoothing near its end,
    so an uneven clip splits its rows instead."""
    return partition_spec(mesh, n, h)


def sharded_video_context(frames: np.ndarray, mesh: DeviceMesh, fps: float = 16.0) -> VideoContext:
    """VideoContext of an (N, H, W, C) clip laid out on ``mesh``: frame
    shards uploaded one to each data-axis device, else the clip on the
    lead device; a clip whose warp streams stays on the host."""
    frames = np.ascontiguousarray(frames, np.float32)
    n, h, w, c = frames.shape
    host = torch.from_numpy(frames)
    if will_stream(n, h, w, h, w, c):
        clip = host
    elif input_partition_spec(mesh, n, h)[0] == "data" and int(mesh.shape["data"]) > 1:
        clip = upload_shards(host, data_devices(mesh))
    else:
        clip = host.to(mesh.lead)
    return VideoContext(
        frames=clip,
        adapter=FrameAdapter(torch.float32, False, "0_1", "numpy", False),
        width=w,
        height=h,
        channels=c,
        fps=fps,
        template_kind="sequence",
        template_meta={},
    )


def stabilize_flow_sharded(
    frames: np.ndarray,
    mesh: DeviceMesh,
    *,
    framing_mode: str = "crop_and_pad",
    transform_mode: str = "similarity",
    camera_lock: bool = False,
    strength: float = 0.9,
    smooth: float = 0.6,
    keep_fov: float = 0.6,
    padding_rgb: Tuple[int, int, int] = (127, 127, 127),
    frame_rate: float = 16.0,
) -> StabilizationResult:
    """Run the production Flow engine with the clip laid out on the mesh."""
    ctx = sharded_video_context(frames, mesh, fps=frame_rate)
    with set_mesh(mesh):
        return stabilize_flow(
            ctx, framing_mode, transform_mode, camera_lock,
            strength, smooth, keep_fov, padding_rgb, frame_rate, device=mesh.lead,
        )


def stabilize_classic_sharded(
    frames: np.ndarray,
    mesh: DeviceMesh,
    *,
    framing_mode: str = "crop_and_pad",
    transform_mode: str = "similarity",
    camera_lock: bool = False,
    strength: float = 0.9,
    smooth: float = 0.6,
    keep_fov: float = 0.6,
    padding_rgb: Tuple[int, int, int] = (127, 127, 127),
    frame_rate: float = 16.0,
) -> StabilizationResult:
    """Run the production Classic engine with the clip laid out on the mesh."""
    ctx = sharded_video_context(frames, mesh, fps=frame_rate)
    with set_mesh(mesh):
        return stabilize_classic(
            ctx, framing_mode, transform_mode, camera_lock,
            strength, smooth, keep_fov, padding_rgb, frame_rate, device=mesh.lead,
        )


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def sharded_stabilize_flow_check(mesh: DeviceMesh) -> None:
    """Dry-run validation: the sharded production engine must run end to
    end on the mesh and agree with the single-device run, by the JAX
    package's gates (identical modes, matrices within 0.05 px and 1e-3
    linear terms, pixels within 0.02 at the 99.999th percentile)."""
    rng = np.random.default_rng(0)
    n, h, w = max(8, mesh.size * 2), 64, 96
    base = rng.random((h + 40, w + 40), np.float32)
    # mild synthetic shake so estimation has real work
    frames = np.empty((n, h, w, 3), np.float32)
    for i in range(n):
        dy, dx = int(3 * np.sin(i / 2.0)), int(4 * np.cos(i / 3.0))
        crop = base[20 + dy: 20 + dy + h, 20 + dx: 20 + dx + w]
        frames[i] = np.stack([crop, crop * 0.8 + 0.1, 1.0 - crop], axis=-1)

    res = stabilize_flow_sharded(frames, mesh)
    out = np.asarray(res.frames)
    masks = np.asarray(res.masks)
    _require(out.shape == frames.shape, f"frames {out.shape}")
    _require(masks.shape == frames.shape[:3], f"masks {masks.shape}")
    _require(bool(np.isfinite(out).all() and np.isfinite(masks).all()), "non-finite output")
    _require(res.meta["flow_backend"] == "DIS", str(res.meta.get("flow_fallback_reason")))

    # parity with the unsharded engine (same code, no mesh)
    ref = stabilize_flow(
        normalize_video_input(frames, device=mesh.lead), "crop_and_pad", "similarity", False,
        0.9, 0.6, 0.6, (127, 127, 127), 16.0, device=mesh.lead,
    )
    pt_s = res.meta["estimated_motion"]["per_transition"]
    pt_r = ref.meta["estimated_motion"]["per_transition"]
    _require([e["mode"] for e in pt_s] == [e["mode"] for e in pt_r], "mode decisions differ")
    ms = np.asarray([e["matrix"] for e in pt_s])
    mr = np.asarray([e["matrix"] for e in pt_r])
    _require(np.abs(ms[:, :2, 2] - mr[:, :2, 2]).max() < 0.05, "translation drift")
    _require(np.abs(ms[:, :2, :2] - mr[:, :2, :2]).max() < 1e-3, "linear drift")
    diff = np.abs(out - np.asarray(ref.frames.cpu()))
    _require(np.quantile(diff, 0.99999) < 0.02, f"pixels {float(np.quantile(diff, 0.99999))}")
