"""Whole-clip stabilization steps, with the clip sharded over a device mesh.

Counterpart of ``comfyui_video_stabilizer_tpu/parallel/pipeline.py``,
the sidecars beside the production engines: one function each for a
translation-only and a similarity-model stabilization of a whole clip,
with no host round trip inside (``jit_stabilize_step`` and
``jit_stabilize_step_similarity`` keep the JAX names; PyTorch runs them
eagerly).  Estimation is the batched FFT phase correlation
(``torch.fft.rfft2``), refined for the similarity model by two rounds of
dense patch-aggregated Gauss-Newton flow behind the integer pre-shift
and a robust similarity fit (ops/flow_dis.py); path integration,
fps-windowed smoothing, the crop_and_pad recentre and the warp follow.
The translation warp clamps its integer shift to +-16 px (the JAX
sidecar's static budget): a clip shakier than that is under-corrected.

``sharded_stabilize`` and ``sharded_stabilize_similarity`` lay the clip
on the mesh's data axis (parallel/mesh.py): the per-frame and per-pair
work (gray, phase correlation, the dense refinement, the warp and its
mask) runs on each shard's device, the pair that crosses into the next
shard with a one-frame gray halo; the global reductions (the path scan,
the smoothing, the recentre, the inverse matrices) run on the lead
device, whose per-frame results go back to the shards.  They return
numpy arrays, as the JAX functions do.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from .mesh import DeviceMesh, FrameShards, data_devices, move, sharded_pairs, upload_shards

_LUMA = np.array([0.299, 0.587, 0.114], np.float32)

# the translation warp's integer shift budget, px
_PAD = 16


def _luma(frames: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) -> (N, H, W): r*L0 + g*L1 + b*L2, each op rounded."""
    l0, l1, l2 = (float(v) for v in _LUMA)
    return frames[..., 0] * l0 + frames[..., 1] * l1 + frames[..., 2] * l2


def _phase_correlate_pairs(grays: torch.Tensor) -> torch.Tensor:
    """(N, H, W) -> per-pair integer translation deltas (N-1, 2) via FFT."""
    prev = grays[:-1]
    curr = grays[1:]
    prev = prev - prev.mean(dim=(1, 2), keepdim=True)
    curr = curr - curr.mean(dim=(1, 2), keepdim=True)
    b, h, w = prev.shape
    cross = torch.fft.rfft2(prev) * torch.conj(torch.fft.rfft2(curr))
    mag = torch.abs(cross)
    r = torch.fft.irfft2(cross / torch.where(mag < 1e-12, 1.0, mag), s=(h, w))
    peak = r.reshape(b, -1).argmax(dim=-1)
    py = torch.div(peak, w, rounding_mode="floor").to(torch.float32)
    px = (peak % w).to(torch.float32)
    py = torch.where(py > h / 2, py - h, py)
    px = torch.where(px > w / 2, px - w, px)
    return -torch.stack([px, py], dim=-1)


def _smooth(path: torch.Tensor, window: int) -> torch.Tensor:
    """Edge-padded box mean of each column over ``window`` (odd) samples."""
    pad = window // 2
    n = path.shape[0]
    padded = torch.cat([path[:1].expand(pad, -1), path, path[-1:].expand(pad, -1)], dim=0)
    k = float(np.float32(1.0 / window))
    acc = padded[:n] * k
    for j in range(1, window):
        acc = acc + padded[j:j + n] * k
    return acc


def _translation_plan(deltas: torch.Tensor, strength: float, window: int, w: int, h: int) -> torch.Tensor:
    """Per-frame (tx, ty) corrections from the pair deltas: path, smoothed
    target, crop_and_pad recentre (global reductions, one device)."""
    zero = torch.zeros((1, 2), dtype=deltas.dtype, device=deltas.device)
    path = torch.cat([zero, torch.cumsum(deltas, dim=0)], dim=0)
    target = path + strength * (_smooth(path, window) - path)
    corrections = target - path
    x0 = (-corrections[:, 0]).amax()
    y0 = (-corrections[:, 1]).amax()
    x1 = (-corrections[:, 0] + w).amin()
    y1 = (-corrections[:, 1] + h).amin()
    offset = torch.stack([w * 0.5 - (x0 + x1) * 0.5, h * 0.5 - (y0 + y1) * 0.5])
    return corrections + offset[None]


def _translation_warp(frames: torch.Tensor, offsets: torch.Tensor, border: torch.Tensor):
    """Warp each frame by its (tx, ty): the integer part as a zero-padded
    shift clamped to +-16 px, the fraction as a 4-tap blend; outside the
    source (or past the shift budget) the border colour, and the mask 1."""
    n, h, w, c = frames.shape
    dev = frames.device
    tx, ty = offsets[:, 0], offsets[:, 1]
    x0, y0 = torch.floor(tx), torch.floor(ty)
    fx = (tx - x0)[:, None, None, None]
    fy = (ty - y0)[:, None, None, None]
    ixc = torch.clamp(x0.to(torch.int64), -_PAD, _PAD)
    iyc = torch.clamp(y0.to(torch.int64), -_PAD, _PAD)
    # the (h+1, w+1) window of the zero-padded frame at (PAD - iy, PAD - ix),
    # its start clamped to stay inside the pad, read by index
    sy = torch.clamp(_PAD - iyc, 0, 2 * _PAD - 1) - _PAD
    sx = torch.clamp(_PAD - ixc, 0, 2 * _PAD - 1) - _PAD
    ys = torch.arange(h + 1, device=dev)[None, :] + sy[:, None]
    xs = torch.arange(w + 1, device=dev)[None, :] + sx[:, None]
    inside_src = (((ys >= 0) & (ys < h))[:, :, None] & ((xs >= 0) & (xs < w))[:, None, :])[..., None]
    bidx = torch.arange(n, device=dev)[:, None, None]
    base = frames[bidx, ys.clamp(0, h - 1)[:, :, None], xs.clamp(0, w - 1)[:, None, :]]
    base = torch.where(inside_src, base, 0.0)
    v = (base[:, :-1, :-1] * (1 - fy) * (1 - fx)
         + base[:, :-1, 1:] * (1 - fy) * fx
         + base[:, 1:, :-1] * fy * (1 - fx)
         + base[:, 1:, 1:] * fy * fx)
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    yy = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    sxx = xx - tx[:, None, None]
    syy = yy - ty[:, None, None]
    shift_ok = (torch.abs(x0) <= _PAD) & (torch.abs(y0) <= _PAD)
    inside = (sxx >= 0) & (sxx <= w - 1) & (syy >= 0) & (syy <= h - 1) & shift_ok[:, None, None]
    warped = torch.where(inside[..., None], v, border.reshape(1, 1, 1, c))
    return warped, 1.0 - inside.to(torch.float32)


def _border(border, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(border, np.float32).reshape(-1), device=device)


def stabilize_step(frames: torch.Tensor, strength: float, window: int, border
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Whole-clip translational stabilization of (N, H, W, 3) float32
    frames: ``(warped, masks, per-frame offsets (N, 2))`` on their device."""
    n, h, w, _ = frames.shape
    deltas = _phase_correlate_pairs(_luma(frames))
    total = _translation_plan(deltas, strength, window, w, h)
    warped, masks = _translation_warp(frames, total, _border(border, frames.device))
    return warped, masks, total


def jit_stabilize_step(frames, strength, window, border):
    """:func:`stabilize_step` (the JAX name; PyTorch runs it eagerly)."""
    return stabilize_step(frames, strength, window, border)


# ---------------------------------------------------------------------------
# Similarity-model step
# ---------------------------------------------------------------------------

def _similarity_from_params(tx, ty, ang, logs):
    """(B,) params -> (B, 3, 3) similarity matrices."""
    s = torch.exp(logs)
    ca = s * torch.cos(ang)
    sa = s * torch.sin(ang)
    z = torch.zeros_like(tx)
    o = torch.ones_like(tx)
    return torch.stack([ca, -sa, tx, sa, ca, ty, z, z, o], dim=-1).reshape(-1, 3, 3)


def _params_from_similarity(m):
    """(B, 3, 3) -> (tx, ty, angle, log-scale), each (B,)."""
    ang = torch.atan2(m[:, 1, 0], m[:, 0, 0])
    s = torch.sqrt(m[:, 0, 0] ** 2 + m[:, 1, 0] ** 2)
    return m[:, 0, 2], m[:, 1, 2], ang, torch.log(torch.clamp(s, min=1e-6))


def _mm3(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """3x3 product x @ y in float32, k summed in order 0, 1, 2."""
    return (x[..., :, 0, None] * y[..., None, 0, :] + x[..., :, 1, None] * y[..., None, 1, :]
            + x[..., :, 2, None] * y[..., None, 2, :])


def _estimate_similarity_pairs(grays: torch.Tensor) -> torch.Tensor:
    """(N, H, W) 0..255 grays -> per-pair similarity (N-1, 3, 3), each
    mapping frame k's coordinates to frame k+1's.

    Phase correlation seeds the translation; then twice: pre-warp the
    next frame by the estimate, one dense patch-aggregated Gauss-Newton
    step, the robust similarity fit of the composed flow, kept unless it
    is degenerate."""
    from ..ops import flow_dis as FD

    deltas = _phase_correlate_pairs(grays)
    b = deltas.shape[0]
    m = torch.eye(3, dtype=torch.float32, device=grays.device).repeat(b, 1, 1)
    m[:, 0, 2] = deltas[:, 0]
    m[:, 1, 2] = deltas[:, 1]
    J = grays[1:]
    I = grays[:-1]
    agg = FD._make_agg(8)
    for _ in range(2):  # fit -> prewarp -> refit
        Jw = FD._warp_similarity_device(J, m, pad_t=32, radius=4)
        flow_lk = torch.stack(FD._lk_step(I * (1.0 / 255.0), Jw * (1.0 / 255.0), agg)[0], dim=-1)
        cmin = agg(((I - Jw) * (1.0 / 255.0)) ** 2)
        conf = 1.0 / (1.0 + cmin * 65025.0)
        mn = FD._fit_similarity_dense(FD._compose_flow(m, flow_lk), conf, 4)
        sc2 = mn[:, 0, 0] ** 2 + mn[:, 1, 0] ** 2
        ok = torch.isfinite(mn).all(dim=2).all(dim=1) & (sc2 > 0.25) & (sc2 < 4.0)
        m = torch.where(ok[:, None, None], mn, m)
    return m


def _similarity_plan(pair_m: torch.Tensor, strength: float, window: int, w: int, h: int):
    """(corrections (N, 3, 3), their inverses) from the pair matrices: the
    camera path P_k = M_{k-1} P_{k-1}, parameter-space smoothing and the
    crop_and_pad recentre (global reductions, one device)."""
    paths = [torch.eye(3, dtype=torch.float32, device=pair_m.device)]
    for k in range(pair_m.shape[0]):
        paths.append(_mm3(pair_m[k], paths[-1]))
    path_m = torch.stack(paths)
    params = torch.stack(_params_from_similarity(path_m), dim=-1)
    target = params + strength * (_smooth(params, window) - params)
    diff = target - params
    corr = _similarity_from_params(diff[:, 0], diff[:, 1], diff[:, 2], diff[:, 3])
    cx, cy = corr[:, 0, 2], corr[:, 1, 2]
    x0, y0 = (-cx).amax(), (-cy).amax()
    x1, y1 = (-cx + w).amin(), (-cy + h).amin()
    corr[:, 0, 2] = cx + (w * 0.5 - (x0 + x1) * 0.5)
    corr[:, 1, 2] = cy + (h * 0.5 - (y0 + y1) * 0.5)
    return corr, torch.linalg.inv(corr)


def _similarity_warp(frames: torch.Tensor, minv: torch.Tensor, border: torch.Tensor):
    """out(x) = frame(minv @ x) per channel through ops/flow_dis.py's
    similarity sampler, the border colour where minv @ x leaves the frame
    (the closed-form mask is 1 there)."""
    from ..ops import flow_dis as FD

    n, h, w, c = frames.shape
    dev = frames.device
    chans = frames.permute(0, 3, 1, 2).reshape(n * c, h, w)
    warped = FD._warp_similarity_device(chans, minv.repeat_interleave(c, dim=0), pad_t=32, radius=4)
    warped = warped.reshape(n, c, h, w).permute(0, 2, 3, 1)
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    yy = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    a = minv[:, :, :, None, None]
    sx = a[:, 0, 0] * xx + a[:, 0, 1] * yy + a[:, 0, 2]
    sy = a[:, 1, 0] * xx + a[:, 1, 1] * yy + a[:, 1, 2]
    inside = (sx >= 0) & (sx <= w - 1) & (sy >= 0) & (sy <= h - 1)
    warped = torch.where(inside[..., None], warped, border.reshape(1, 1, 1, c))
    return warped, 1.0 - inside.to(torch.float32)


def stabilize_step_similarity(frames: torch.Tensor, strength: float, window: int, border
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Whole-clip SIMILARITY stabilization of (N, H, W, 3) float32 frames:
    ``(warped, masks, corrections (N, 3, 3))`` on their device."""
    n, h, w, _ = frames.shape
    pair_m = _estimate_similarity_pairs(_luma(frames) * 255.0)
    corr, minv = _similarity_plan(pair_m, strength, window, w, h)
    warped, masks = _similarity_warp(frames, minv, _border(border, frames.device))
    return warped, masks, corr


def jit_stabilize_step_similarity(frames, strength, window, border):
    """:func:`stabilize_step_similarity` (the JAX name; PyTorch runs it eagerly)."""
    return stabilize_step_similarity(frames, strength, window, border)


# ---------------------------------------------------------------------------
# The steps by shard
# ---------------------------------------------------------------------------

def _clip_shards(frames: np.ndarray, mesh: DeviceMesh) -> FrameShards:
    """The clip cut into near-even frame shards, one a data-axis device."""
    return upload_shards(torch.from_numpy(np.ascontiguousarray(frames, np.float32)), data_devices(mesh))


def _per_shard(shards: FrameShards, per_frame: torch.Tensor, fn, border) -> Tuple[np.ndarray, np.ndarray]:
    """``fn(frames_k, per_frame_k, border_k)`` -> (warped, masks) on each
    shard, with its rows of ``per_frame`` sent to it; gathered to numpy."""
    warped, masks = [], []
    for (s, e), shard in zip(shards.spans, shards.shards):
        dev = shard.device
        wk, mk = fn(shard, move(per_frame[s:e], dev, "scatter"), _border(border, dev))
        warped.append(wk)
        masks.append(mk)
    return np.asarray(FrameShards(warped)), np.asarray(FrameShards(masks))


def sharded_stabilize(
    frames: np.ndarray,
    mesh: DeviceMesh,
    strength: float = 1.0,
    window: int = 5,
    border: Sequence[float] = (0.5, 0.5, 0.5),
):
    """:func:`stabilize_step` with the clip sharded over the mesh's data
    axis; ``(warped, masks, offsets)`` as numpy arrays."""
    shards = _clip_shards(frames, mesh)
    _, h, w, _ = shards.shape
    deltas = torch.cat(sharded_pairs(shards.map(_luma), lambda g, _tick: _phase_correlate_pairs(g)), dim=0)
    total = _translation_plan(deltas, float(strength), int(window), w, h)
    warped, masks = _per_shard(shards, total, _translation_warp, border)
    return warped, masks, total.cpu().numpy()


def sharded_stabilize_similarity(
    frames: np.ndarray,
    mesh: DeviceMesh,
    strength: float = 1.0,
    window: int = 5,
    border: Sequence[float] = (0.5, 0.5, 0.5),
):
    """:func:`stabilize_step_similarity` with the clip sharded over the
    mesh's data axis; ``(warped, masks, corrections)`` as numpy arrays."""
    shards = _clip_shards(frames, mesh)
    _, h, w, _ = shards.shape
    grays = shards.map(lambda f: _luma(f) * 255.0)
    pair_m = torch.cat(sharded_pairs(grays, lambda g, _tick: _estimate_similarity_pairs(g)), dim=0)
    corr, minv = _similarity_plan(pair_m, float(strength), int(window), w, h)
    warped, masks = _per_shard(shards, minv, _similarity_warp, border)
    return warped, masks, corr.cpu().numpy()
