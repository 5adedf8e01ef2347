"""Batched homography warp and closed-form padding masks (PyTorch + K1).

Counterpart of ``comfyui_video_stabilizer_tpu/ops/warp.py``.  Source
coordinates are formed in displacement form, exactly as there: for an
output pixel (x, y) and the normalized inverse coefficients
[a, b, c, d, e, f, g, h] (host float64, shipped as float32)

    D  = 1 + g*x + h*y
    Qx = (a - 1)*x + b*y + c - g*x**2 - h*x*y        # = (sx - x) * D
    dx = Qx / D;   x0 = x + floor(dx);   fx = dx - floor(dx)

so float32 carries only the small displacement, never the absolute
coordinate.  Taps outside the source read the border colour
(BORDER_CONSTANT); bicubic is cv2's A = -0.75 kernel; nearest rounds
half to even.

``warp_frames`` is the kernel wrapper: a CUDA tensor launches the
hand-written kernel K1 (``csrc/warp.cu``), a CPU tensor takes
``warp_plain``, the plain PyTorch version with the same op order.
``warp_blur_frames`` does the same for K3, the shutter-blur warp (the
mean of S sample warps) with its soft mask (1 - mean nearest coverage
over the samples, small values zeroed) in the same launch;
``warp_blur_mask_plain`` is its plain version.  ``padding_counts`` does
the same for K8, the padding mask of the plain warp (1 - nearest
coverage) with each frame's exact padded count, a stage the JAX package
leaves to XLA; ``padding_counts_plain`` is its plain version, and
``padding_counts_affine_plain`` repeats the kernel's route for affine
frames (no denominator) op for op.  The
coverage masks of crop framing stay plain PyTorch.

Clips whose live set on the device exceeds ``CHUNK_BUDGET_BYTES``
stream through time chunks, as in the JAX package: ``warp_clip``,
``warp_clip_with_mask`` and ``warp_clip_blur`` then upload each chunk
of frames to ``device``, warp it there and copy the result into a host
(CPU) tensor, so a streamed result lies on the host while an unstreamed
one stays on the device.  Every frame is computed from its own inputs
only, so a streamed frame is bitwise the unstreamed one.

Under an active mesh (utils/meshinfo.py) the warp and the padding stats
run where the clip lies (parallel/mesh.py): on each frame shard, with
that shard's rows of the coefficients (``warp_frames_sharded``, the
counterpart of the JAX package's ``warp_pallas_sharded``; the
``*_sharded`` stats), or, for the "rows" outcome, one band of output
rows a device, K1 and the stats taking the band's first row ``row0``.
A pixel does not depend on the layout, and the padded ratio of a frame
is its exact padded count over the canvas area (``_ratios``), so every
layout gives the unsharded result bitwise.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..parallel.mesh import (
    FrameShards, data_devices, even_spans, frame_shards, lead_device, move, row_band_devices,
)
from ..utils.meshinfo import active_mesh, data_shards
from . import cuda_build

Interp = str  # 'bilinear' | 'bicubic' | 'nearest'
INTERP_CODES = {"bilinear": 0, "bicubic": 1, "nearest": 2}

_DISP_LIM = 1.0e6  # px; beyond this everything is out of frame anyway

# Device-memory budget of the warp stage.  Its live set per frame is
# the input and output frames (C float32 values a pixel each) plus the
# float32 padding mask: clip_device_bytes(1, ...), 58,060,800 bytes for
# 1080p RGB.  An H100 has 80 GB (79.2 GiB usable); 64 GiB go to that
# live set and the rest to what does not grow with the chunk -- the
# estimation grays and pyramids (0.6 GB for 300 frames at 960x540), the
# mask's coordinate temporaries (~1.6 GB, _MASK_CHUNK_PIXELS) and the
# allocator's slack.  A clip whose live set exceeds the budget streams
# in chunks of CHUNK_BUDGET_BYTES // clip_device_bytes(1, ...) frames:
# a 1080p RGB clip beyond 1,183 frames, a 4K one beyond 295.  A module
# constant, so a test can lower it.
CHUNK_BUDGET_BYTES = 64 << 30

# Padding masks are computed in frame chunks of at most this many
# pixels, bounding the coordinate temporaries (~12 float32 fields).
_MASK_CHUNK_PIXELS = 1 << 25


def clip_device_bytes(n: int, in_h: int, in_w: int, out_h: int, out_w: int, c: int = 3) -> int:
    """Bytes of n frames' warp-stage live set: input, output and mask."""
    return 4 * n * (in_h * in_w * c + out_h * out_w * (c + 1))


def _chunk_frames(n: int, in_h: int, in_w: int, out_h: int, out_w: int, c: int = 3) -> int:
    per_frame = clip_device_bytes(1, in_h, in_w, out_h, out_w, c)
    return max(1, min(n, CHUNK_BUDGET_BYTES // max(per_frame, 1)))


def will_stream(n: int, in_h: int, in_w: int, out_h: int, out_w: int, c: int = 3) -> bool:
    """True when the warp of this clip streams through host time chunks."""
    return _chunk_frames(n, in_h, in_w, out_h, out_w, c) < n


# ---------------------------------------------------------------------------
# Host-side matrix preparation (float64, as in the JAX package)
# ---------------------------------------------------------------------------

def prepare_inverse_coeffs(matrices: np.ndarray) -> np.ndarray:
    """(N, 3, 3) forward src->dst matrices -> (N, 8) displacement coeffs.

    Per-frame [a, b, c, d, e, f, g, h] of the *inverse* map, normalized
    so that the constant denominator term is 1; float64 on the host.
    """
    matrices = np.asarray(matrices, dtype=np.float64)
    if matrices.ndim == 2:
        matrices = matrices[None]
    n = matrices.shape[0]
    coeffs = np.zeros((n, 8), dtype=np.float64)
    for i in range(n):
        try:
            minv = np.linalg.inv(matrices[i])
        except np.linalg.LinAlgError:
            minv = np.eye(3)
        w0 = minv[2, 2]
        if w0 != 0.0 and np.isfinite(w0):
            minv = minv / w0
        coeffs[i] = [
            minv[0, 0], minv[0, 1], minv[0, 2],
            minv[1, 0], minv[1, 1], minv[1, 2],
            minv[2, 0], minv[2, 1],
        ]
    return coeffs


# ---------------------------------------------------------------------------
# Coordinates (plain PyTorch; K1 repeats this arithmetic per pixel)
# ---------------------------------------------------------------------------

def _displacements(coeffs: torch.Tensor, out_h: int, out_w: int, row0: int = 0):
    """Per-pixel (dx, dy, safe) of shape (N, out_h, out_w), for the output
    rows [row0, row0 + out_h)."""
    dev = coeffs.device
    xx = torch.arange(out_w, device=dev, dtype=torch.float32)[None, None, :]
    yy = torch.arange(row0, row0 + out_h, device=dev, dtype=torch.float32)[None, :, None]
    a, b, c, d, e, f, g, h = (coeffs[:, i, None, None] for i in range(8))
    denom = 1.0 + g * xx + h * yy
    qx = (a - 1.0) * xx + b * yy + c - (g * xx) * xx - (h * xx) * yy
    qy = d * xx + (e - 1.0) * yy + f - (g * yy) * xx - (h * yy) * yy
    safe = denom != 0.0
    inv_d = torch.where(safe, 1.0 / torch.where(safe, denom, 1.0), 0.0)
    return qx * inv_d, qy * inv_d, safe


def _split_displacements(dx: torch.Tensor, dy: torch.Tensor, safe: torch.Tensor | None, row0: int = 0):
    """int32 (x0, y0) = floor(source) and float32 fractions (fx, fy) of
    (N, out_h, out_w) displacements; ``safe`` None is a denominator known
    to be 1."""
    dev = dx.device
    out_h, out_w = dx.shape[-2:]
    xi = torch.arange(out_w, device=dev, dtype=torch.int32)[None, None, :]
    yi = torch.arange(row0, row0 + out_h, device=dev, dtype=torch.int32)[None, :, None]
    dx = dx.clamp(-_DISP_LIM, _DISP_LIM)
    dy = dy.clamp(-_DISP_LIM, _DISP_LIM)
    if safe is not None:
        dx = torch.where(safe, dx, -_DISP_LIM)
        dy = torch.where(safe, dy, -_DISP_LIM)
    dxf = torch.floor(dx)
    dyf = torch.floor(dy)
    return xi + dxf.to(torch.int32), yi + dyf.to(torch.int32), dx - dxf, dy - dyf


def _split_coords(coeffs: torch.Tensor, out_h: int, out_w: int, row0: int = 0):
    """int32 (x0, y0) = floor(source) and float32 fractions (fx, fy)."""
    return _split_displacements(*_displacements(coeffs, out_h, out_w, row0), row0)


def _round_half_even(base: torch.Tensor, frac: torch.Tensor) -> torch.Tensor:
    return base + torch.where(frac > 0.5, 1, torch.where(frac < 0.5, 0, base & 1))


def _nearest_coords(coeffs: torch.Tensor, out_h: int, out_w: int, row0: int = 0):
    """Round-half-to-even integer source coords (cv2 INTER_NEAREST)."""
    x0, y0, fx, fy = _split_coords(coeffs, out_h, out_w, row0)
    return _round_half_even(x0, fx), _round_half_even(y0, fy)


def _gather_taps(frames: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """frames (N,H,W,C), ys/xs (N,OH,OW) int32 -> (N,OH,OW,C), indices clipped."""
    n, h, w, c = frames.shape
    lin = (ys.clamp(0, h - 1).long() * w + xs.clamp(0, w - 1).long()).reshape(n, -1, 1)
    out = torch.gather(frames.reshape(n, h * w, c), 1, lin.expand(-1, -1, c))
    return out.reshape(n, ys.shape[1], ys.shape[2], c)


def _cubic_weights(t: torch.Tensor):
    """OpenCV's bicubic kernel (A = -0.75) at offsets -1, 0, 1, 2."""
    A = -0.75
    w0 = ((A * (t + 1) - 5 * A) * (t + 1) + 8 * A) * (t + 1) - 4 * A
    w1 = ((A + 2) * t - (A + 3)) * t * t + 1
    w2 = ((A + 2) * (1 - t) - (A + 3)) * (1 - t) * (1 - t) + 1
    w3 = 1.0 - w0 - w1 - w2
    return (w0, w1, w2, w3)


def warp_plain(frames: torch.Tensor, coeffs: torch.Tensor, border: torch.Tensor,
               out_h: int, out_w: int, interp: Interp, row0: int = 0) -> torch.Tensor:
    """Plain PyTorch version of K1 (same op order; gather based): the
    output rows [row0, row0 + out_h) of the warp."""
    n, h, w, c = frames.shape
    border_vec = border.reshape(1, 1, 1, c)

    def tap(ys, xs):
        valid = ((xs >= 0) & (xs < w) & (ys >= 0) & (ys < h))[..., None]
        return torch.where(valid, _gather_taps(frames, ys, xs), border_vec)

    if interp == "nearest":
        xn, yn = _nearest_coords(coeffs, out_h, out_w, row0)
        return tap(yn, xn)

    x0, y0, fx, fy = _split_coords(coeffs, out_h, out_w, row0)
    acc = torch.zeros((n, out_h, out_w, c), dtype=torch.float32, device=frames.device)
    if interp == "bilinear":
        taps = (
            (0, 0, (1.0 - fy) * (1.0 - fx)),
            (0, 1, (1.0 - fy) * fx),
            (1, 0, fy * (1.0 - fx)),
            (1, 1, fy * fx),
        )
        for dy_t, dx_t, wgt in taps:
            acc = acc + tap(y0 + dy_t, x0 + dx_t) * wgt[..., None]
        return acc
    if interp == "bicubic":
        wxs = _cubic_weights(fx)
        wys = _cubic_weights(fy)
        for iy in range(4):
            for ix in range(4):
                acc = acc + tap(y0 + iy - 1, x0 + ix - 1) * (wys[iy] * wxs[ix])[..., None]
        return acc
    raise ValueError(f"Unsupported interpolation {interp!r}.")


def warp_blur_plain(frames: torch.Tensor, coeffs_s: torch.Tensor, border: torch.Tensor,
                    out_h: int, out_w: int, interp: Interp) -> torch.Tensor:
    """Plain PyTorch version of K3: ``warp_plain`` once per sample,
    summed in sample order, divided by S."""
    s = coeffs_s.shape[1]
    acc = None
    for k in range(s):
        w = warp_plain(frames, coeffs_s[:, k], border, out_h, out_w, interp)
        acc = w if acc is None else acc + w
    # the divisor is a tensor on acc's device: dividing a CUDA tensor by a
    # Python number multiplies by its reciprocal, one ulp off K3's division
    return acc / torch.tensor(float(s), device=acc.device)


def warp_frames(frames: torch.Tensor, coeffs: torch.Tensor, border: torch.Tensor,
                out_h: int, out_w: int, interp: Interp = "bilinear", row0: int = 0) -> torch.Tensor:
    """Warp (N,H,W,C) float32 frames by per-frame (N,8) inverse coeffs.

    The result holds the output rows [row0, row0 + out_h): the whole
    canvas for row0 = 0, else one row band of it, each pixel as in the
    whole canvas.  CUDA tensors launch K1 (raising if it cannot build or
    launch); CPU tensors take :func:`warp_plain`.
    """
    if interp not in INTERP_CODES:
        raise ValueError(f"Unsupported interpolation {interp!r}.")
    if row0 < 0:
        raise ValueError(f"row0 must be >= 0, got {row0}")
    if frames.device.type == "cpu":
        return warp_plain(frames, coeffs, border, out_h, out_w, interp, row0)
    n, h, w, c = frames.shape
    cuda_build.require_cuda_tensor("frames", frames, torch.float32, 4)
    cuda_build.require_cuda_tensor("coeffs", coeffs, torch.float32, 2)
    cuda_build.require_cuda_tensor("border", border, torch.float32, 1)
    if coeffs.shape != (n, 8) or border.shape != (c,):
        raise cuda_build.KernelArgumentError(f"coeffs {tuple(coeffs.shape)} / border {tuple(border.shape)} "
                                             f"do not match {n} frames of {c} channels")
    if not 1 <= c <= 4 or n < 1:
        raise cuda_build.KernelArgumentError(
            f"K1 takes 1..4 channels and at least one frame, got {c} and {n}")
    if coeffs.device != frames.device or border.device != frames.device:
        raise cuda_build.KernelArgumentError("frames, coeffs and border must be on one device")
    out = torch.empty((n, out_h, out_w, c), dtype=torch.float32, device=frames.device)
    with torch.cuda.device(frames.device):
        for s, e in cuda_build.frame_spans(n):
            err = cuda_build.library().cvst_warp(
                frames[s:e].data_ptr(), coeffs[s:e].data_ptr(), border.data_ptr(), out[s:e].data_ptr(),
                e - s, h, w, c, out_h, out_w, row0, INTERP_CODES[interp],
                cuda_build.current_stream(frames.device),
            )
            cuda_build.check_launch(err, "warp")
            cuda_build.LAUNCHES["warp"] += 1
    return out


def warp_blur_mask_plain(frames: torch.Tensor, coeffs_s: torch.Tensor, border: torch.Tensor,
                         out_h: int, out_w: int, interp: Interp) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K3 with its soft mask: ``warp_blur_plain``'s
    frames and ``zero_small(1 - mean nearest coverage)`` over the samples,
    the coverage tested against the frames' own size."""
    in_h, in_w = int(frames.shape[1]), int(frames.shape[2])
    cover = _coverage_mean(coeffs_s, out_h, out_w, in_h, in_w)
    return warp_blur_plain(frames, coeffs_s, border, out_h, out_w, interp), zero_small(1.0 - cover)


def warp_blur_frames(frames: torch.Tensor, coeffs_s: torch.Tensor, border: torch.Tensor,
                     out_h: int, out_w: int, interp: Interp = "bilinear", with_mask: bool = False,
                     *, stats: torch.Tensor | None = None,
                     ) -> Tuple[torch.Tensor, torch.Tensor | None]:
    """Mean of S sample warps of (N,H,W,C) float32 frames by (N,S,8)
    sample-minor inverse coeffs, and with ``with_mask`` the soft mask
    (N,out_h,out_w); ``(frames, mask or None)``.

    CUDA tensors launch K3 once (raising if it cannot build or launch);
    CPU tensors take :func:`warp_blur_mask_plain` (``warp_blur_plain``
    without the mask).  Nearest has no blur and raises.  ``stats``, a
    zeroed (3,) int64 tensor on the frames' device, receives K3's count
    of tiles, of tiles that staged nothing and of pixel-samples whose
    taps were read from device memory.
    """
    if interp not in ("bilinear", "bicubic"):
        raise ValueError(f"Unsupported interpolation {interp!r}; the blur warp takes bilinear or bicubic.")
    if frames.device.type == "cpu":
        if with_mask:
            return warp_blur_mask_plain(frames, coeffs_s, border, out_h, out_w, interp)
        return warp_blur_plain(frames, coeffs_s, border, out_h, out_w, interp), None
    n, h, w, c = frames.shape
    cuda_build.require_cuda_tensor("frames", frames, torch.float32, 4)
    cuda_build.require_cuda_tensor("coeffs_s", coeffs_s, torch.float32, 3)
    cuda_build.require_cuda_tensor("border", border, torch.float32, 1)
    s = coeffs_s.shape[1]
    if coeffs_s.shape != (n, s, 8) or border.shape != (c,):
        raise cuda_build.KernelArgumentError(f"coeffs_s {tuple(coeffs_s.shape)} / border {tuple(border.shape)} "
                                             f"do not match {n} frames of {c} channels")
    if not 1 <= c <= 4 or n < 1 or not 3 <= s <= 33:
        raise cuda_build.KernelArgumentError(f"K3 takes 1..4 channels, at least one frame and 3..33 samples, "
                                             f"got {c}, {n} and {s}")
    if coeffs_s.device != frames.device or border.device != frames.device:
        raise cuda_build.KernelArgumentError("frames, coeffs_s and border must be on one device")
    if stats is not None:
        cuda_build.require_cuda_tensor("stats", stats, torch.int64, 1)
        if stats.shape != (3,) or stats.device != frames.device:
            raise cuda_build.KernelArgumentError(f"stats must be a (3,) int64 tensor on {frames.device}")
    out = torch.empty((n, out_h, out_w, c), dtype=torch.float32, device=frames.device)
    mask = torch.empty((n, out_h, out_w), dtype=torch.float32, device=frames.device) if with_mask else None
    with torch.cuda.device(frames.device):
        for a, e in cuda_build.frame_spans(n):
            err = cuda_build.library().cvst_warp_blur(
                frames[a:e].data_ptr(), coeffs_s[a:e].data_ptr(), border.data_ptr(), out[a:e].data_ptr(),
                None if mask is None else mask[a:e].data_ptr(), None if stats is None else stats.data_ptr(),
                e - a, h, w, c, out_h, out_w, INTERP_CODES[interp], s,
                cuda_build.current_stream(frames.device),
            )
            cuda_build.check_launch(err, "warp_blur")
            cuda_build.LAUNCHES["warp_blur"] += 1
    return out, mask


# ---------------------------------------------------------------------------
# Padding masks (K8) and coverage masks (plain PyTorch)
# ---------------------------------------------------------------------------

def _mask_chunk(out_h: int, out_w: int) -> int:
    return max(1, _MASK_CHUNK_PIXELS // max(out_h * out_w, 1))


def _inside(coeffs: torch.Tensor, out_h: int, out_w: int, in_h: int, in_w: int, row0: int = 0) -> torch.Tensor:
    """Nearest coverage: True where the round-half-even source lies in the frame."""
    return _in_frame(*_nearest_coords(coeffs, out_h, out_w, row0), in_h, in_w)


def _in_frame(xn: torch.Tensor, yn: torch.Tensor, in_h: int, in_w: int) -> torch.Tensor:
    return (xn >= 0) & (xn < in_w) & (yn >= 0) & (yn < in_h)


def _inside_affine(coeffs: torch.Tensor, out_h: int, out_w: int, in_h: int, in_w: int, row0: int = 0) -> torch.Tensor:
    """:func:`_inside` by K8's affine route: no denominator, no g/h terms."""
    dev = coeffs.device
    xx = torch.arange(out_w, device=dev, dtype=torch.float32)[None, None, :]
    yy = torch.arange(row0, row0 + out_h, device=dev, dtype=torch.float32)[None, :, None]
    a, b, c, d, e, f = (coeffs[:, i, None, None] for i in range(6))
    qx = ((a - 1.0) * xx + b * yy) + c
    qy = (d * xx + (e - 1.0) * yy) + f
    x0, y0, fx, fy = _split_displacements(qx, qy, None, row0)
    return _in_frame(_round_half_even(x0, fx), _round_half_even(y0, fy), in_h, in_w)


def affine_route(coeffs: torch.Tensor) -> torch.Tensor:
    """(N,) bool: the frames K8 takes by its affine route (g and h both
    zero, of either sign; a NaN takes the general route)."""
    return (coeffs[:, 6] == 0.0) & (coeffs[:, 7] == 0.0)


def padding_mask_stats(
    matrices: np.ndarray,
    in_size: Tuple[int, int],
    out_size: Tuple[int, int],
    device: torch.device | str,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(padding masks (N, out_h, out_w), padded ratios (N,)) on ``device``.

    The mask is 1 - nearest coverage (binary, so the reference's
    zero-small step is the identity on it); ratios are per-frame means.
    """
    in_w, in_h = int(in_size[0]), int(in_size[1])
    out_w, out_h = int(out_size[0]), int(out_size[1])
    coeffs = torch.as_tensor(
        prepare_inverse_coeffs(matrices).astype(np.float32), device=device
    )
    return padding_stats(coeffs, out_h, out_w, in_h, in_w)


def padding_counts_plain(coeffs: torch.Tensor, out_h: int, out_w: int, in_h: int, in_w: int, row0: int = 0,
                         out_wh: torch.Tensor | None = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K8: (padding masks (N, out_h, out_w),
    padded pixels per frame (N,) int64) of the output rows
    [row0, row0 + out_h).  With ``out_wh`` = (w, h) int32 on the device
    (a bucket's true canvas) only the padded pixels with x < w and row < h
    are counted; the mask is 1 - coverage everywhere."""
    return _padding_counts(_inside, coeffs, out_h, out_w, in_h, in_w, row0, out_wh)


def padding_counts_affine_plain(coeffs: torch.Tensor, out_h: int, out_w: int, in_h: int, in_w: int, row0: int = 0,
                                out_wh: torch.Tensor | None = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8's affine route op for op (``csrc/warp.cu::padding_stats_kernel``):
    :func:`padding_counts_plain`'s result, for frames whose g and h are
    zero (:func:`affine_route`; others raise ValueError).  It holds the
    route's exactness argument in the CPU tests; no caller uses it."""
    if not bool(affine_route(coeffs).all()):
        raise ValueError("the affine route takes frames with g == h == 0 only")
    return _padding_counts(_inside_affine, coeffs, out_h, out_w, in_h, in_w, row0, out_wh)


def _padding_counts(inside_of, coeffs, out_h, out_w, in_h, in_w, row0, out_wh):
    n = coeffs.shape[0]
    dev = coeffs.device
    mask = torch.empty((n, out_h, out_w), dtype=torch.float32, device=dev)
    counts = torch.empty((n,), dtype=torch.int64, device=dev)
    in_canvas = None
    if out_wh is not None:
        in_canvas = ((torch.arange(out_w, dtype=torch.int32, device=dev)[None, :] < out_wh[0])
                     & (torch.arange(row0, row0 + out_h, dtype=torch.int32, device=dev)[:, None] < out_wh[1]))
    chunk = _mask_chunk(out_h, out_w)
    for s in range(0, n, chunk):
        inside = inside_of(coeffs[s:s + chunk], out_h, out_w, in_h, in_w, row0)
        mask[s:s + chunk] = 1.0 - inside.to(torch.float32)
        padded = ~inside if in_canvas is None else ~inside & in_canvas
        counts[s:s + chunk] = padded.reshape(padded.shape[0], -1).sum(dim=1)
    return mask, counts


def padding_counts(coeffs: torch.Tensor, out_h: int, out_w: int, in_h: int, in_w: int, row0: int = 0,
                   out_wh: torch.Tensor | None = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(padding masks, padded pixels per frame int64) of (N, 8) float32
    inverse coefficients: :func:`padding_counts_plain`'s result.  CUDA
    tensors launch K8 (raising if it cannot build or launch); CPU tensors
    take :func:`padding_counts_plain`.  ``out_wh`` stays on the device (no
    host read), so the call may be captured in a CUDA graph."""
    if row0 < 0:
        raise ValueError(f"row0 must be >= 0, got {row0}")
    if coeffs.device.type == "cpu":
        return padding_counts_plain(coeffs, out_h, out_w, in_h, in_w, row0, out_wh)
    cuda_build.require_cuda_tensor("coeffs", coeffs, torch.float32, 2)
    n = coeffs.shape[0]
    if coeffs.shape[1] != 8:
        raise cuda_build.KernelArgumentError(f"coeffs must be (N, 8), got {tuple(coeffs.shape)}")
    if min(out_h, out_w, in_h, in_w) < 1:
        raise cuda_build.KernelArgumentError(f"K8 takes positive sizes, got out {out_h}x{out_w}, in {in_h}x{in_w}")
    if out_wh is not None:
        cuda_build.require_cuda_tensor("out_wh", out_wh, torch.int32, 1)
        if out_wh.shape != (2,) or out_wh.device != coeffs.device:
            raise cuda_build.KernelArgumentError(f"out_wh must be a (2,) int32 tensor on {coeffs.device}")
    mask = torch.empty((n, out_h, out_w), dtype=torch.float32, device=coeffs.device)
    counts = torch.zeros((n,), dtype=torch.int64, device=coeffs.device)
    with torch.cuda.device(coeffs.device):
        for s, e in cuda_build.frame_spans(n):
            err = cuda_build.library().cvst_padding_stats(
                coeffs[s:e].data_ptr(), None if out_wh is None else out_wh.data_ptr(), mask[s:e].data_ptr(),
                counts[s:e].data_ptr(), e - s, out_h, out_w, in_h, in_w, row0,
                cuda_build.current_stream(coeffs.device),
            )
            cuda_build.check_launch(err, "padding_stats")
            cuda_build.LAUNCHES["padding_stats"] += 1
    return mask, counts


def _ratios(counts: torch.Tensor, area: int) -> torch.Tensor:
    """Padded fraction per frame: the exact integer count over the canvas
    area, one rounding (a float32 true division on every device; the
    divisor is a tensor, as a CUDA division by a Python number multiplies
    by its reciprocal).  So the ratio of a frame does not depend on how
    its pixels or the clip's frames were split over devices, and equals
    the mean of the binary mask wherever that sum is exact (below 2**24
    pixels a frame)."""
    return counts.to(torch.float32) / torch.full((), float(area), dtype=torch.float32, device=counts.device)


def padding_stats(coeffs: torch.Tensor, out_h: int, out_w: int, in_h: int, in_w: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`padding_mask_stats` from (N, 8) float32 inverse coefficients
    already on the device (the fast path's, made there)."""
    mask, counts = padding_counts(coeffs, out_h, out_w, in_h, in_w)
    return mask, _ratios(counts, out_h * out_w)


def padding_stats_sharded(coeffs: torch.Tensor, frames: FrameShards, out_h: int, out_w: int,
                          in_h: int, in_w: int) -> Tuple[FrameShards, torch.Tensor]:
    """:func:`padding_stats` on each frame shard's device, the counterpart of
    the JAX package's ``_mesh_frame_axis`` constraint: each shard's rows
    of ``coeffs`` (N, 8) go to its device and its masks stay there; the
    ratios (N,) are gathered to ``coeffs``' device."""
    masks, counts = [], []
    for (s, e), dev in zip(frames.spans, frames.devices):
        mask, cnt = padding_counts(move(coeffs[s:e], dev, "scatter"), out_h, out_w, in_h, in_w)
        masks.append(mask)
        counts.append(move(cnt, coeffs.device, "gather"))
    return FrameShards(masks), _ratios(torch.cat(counts), out_h * out_w)


def warp_frames_sharded(frames: FrameShards, coeffs: torch.Tensor, border: torch.Tensor,
                        out_h: int, out_w: int, interp: Interp = "bilinear") -> FrameShards:
    """:func:`warp_frames` on each frame shard, the counterpart of the JAX
    package's ``warp_pallas_sharded``: K1 runs once per shard, on the
    shard's device, with that shard's rows of ``coeffs`` (N, 8); no frame
    leaves its device."""
    out = []
    for (s, e), shard in zip(frames.spans, frames.shards):
        dev = shard.device
        out.append(warp_frames(shard, move(coeffs[s:e], dev, "scatter"), move(border, dev, "scatter"),
                               out_h, out_w, interp))
    return FrameShards(out)


def padding_stats_bucket(coeffs: torch.Tensor, out_wh: torch.Tensor, out_h: int, out_w: int,
                         in_h: int, in_w: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`padding_stats` over a static bucket canvas (out_h, out_w)
    whose true canvas, ``out_wh`` = (w, h) int32 on the device, is known
    only there (the expand fast path's bucket).  The mask is valid in
    [:h, :w], which the caller slices once it has fetched the size; the
    ratios average over the true canvas only.  Counterpart of the JAX
    package's ``ops/warp.py::_padding_stats_bucket``.  The ratio is the
    exact count over the clamped area, a float32 true division (the sum of
    the binary mask it stands for is exact below 2**24 pixels)."""
    mask, counts = padding_counts(coeffs, out_h, out_w, in_h, in_w, out_wh=out_wh)
    area = torch.clamp((out_wh[0] * out_wh[1]).to(torch.float32), min=1.0)
    return mask, counts.to(torch.float32) / area


def padding_stats_bucket_sharded(coeffs: torch.Tensor, out_wh: torch.Tensor, frames: FrameShards,
                                 out_h: int, out_w: int, in_h: int, in_w: int
                                 ) -> Tuple[FrameShards, torch.Tensor]:
    """:func:`padding_stats_bucket` on each frame shard's device, as
    :func:`padding_stats_sharded`; the ratios are gathered to ``coeffs``'
    device."""
    masks, ratios = [], []
    for (s, e), dev in zip(frames.spans, frames.devices):
        mask, r = padding_stats_bucket(move(coeffs[s:e], dev, "scatter"), move(out_wh, dev, "scatter"),
                                       out_h, out_w, in_h, in_w)
        masks.append(mask)
        ratios.append(move(r, coeffs.device, "gather"))
    return FrameShards(masks), torch.cat(ratios)


def coverage_mask(
    matrices: np.ndarray,
    in_size: Tuple[int, int],
    out_size: Tuple[int, int],
    device: torch.device | str,
) -> torch.Tensor:
    """Closed form of warping an all-ones (in_h, in_w) image with NEAREST:
    float32 (N, out_h, out_w) on ``device``, 1.0 where the output pixel
    lands inside the source image."""
    in_w, in_h = int(in_size[0]), int(in_size[1])
    out_w, out_h = int(out_size[0]), int(out_size[1])
    coeffs = torch.as_tensor(
        prepare_inverse_coeffs(matrices).astype(np.float32), device=device
    )
    n = coeffs.shape[0]
    cover = torch.empty((n, out_h, out_w), dtype=torch.float32, device=device)
    chunk = _mask_chunk(out_h, out_w)
    for s in range(0, n, chunk):
        cover[s:s + chunk] = _inside(coeffs[s:s + chunk], out_h, out_w, in_h, in_w).to(torch.float32)
    return cover


def common_coverage(
    matrices: np.ndarray,
    in_size: Tuple[int, int],
    out_size: Tuple[int, int],
    device: torch.device | str,
) -> torch.Tensor:
    """AND of every frame's nearest coverage: float32 (out_h, out_w) on
    ``device``, 1.0 where all frames cover the pixel (all ones for no
    frames).  The minimum runs per mask chunk, so no (N, out_h, out_w)
    stack is formed."""
    in_w, in_h = int(in_size[0]), int(in_size[1])
    out_w, out_h = int(out_size[0]), int(out_size[1])
    coeffs = torch.as_tensor(
        prepare_inverse_coeffs(matrices).astype(np.float32), device=device
    )
    common = torch.ones((out_h, out_w), dtype=torch.float32, device=device)
    chunk = _mask_chunk(out_h, out_w)
    for s in range(0, coeffs.shape[0], chunk):
        inside = _inside(coeffs[s:s + chunk], out_h, out_w, in_h, in_w)
        common = torch.minimum(common, inside.to(torch.float32).amin(dim=0))
    return common


def _coverage_mean(coeffs_s: torch.Tensor, out_h: int, out_w: int, in_h: int, in_w: int) -> torch.Tensor:
    """Mean nearest coverage over the shutter samples of (N, S, 8) coeffs.

    Per frame chunk, the S coverages accumulate in float32 in sample
    order and the sum is multiplied by 1/S, as the JAX package's scan;
    no (N, S, H, W) stack is ever formed."""
    n, s = coeffs_s.shape[:2]
    mean = torch.empty((n, out_h, out_w), dtype=torch.float32, device=coeffs_s.device)
    chunk = _mask_chunk(out_h, out_w)
    for start in range(0, n, chunk):
        part = coeffs_s[start:start + chunk]
        acc = torch.zeros((part.shape[0], out_h, out_w), dtype=torch.float32, device=coeffs_s.device)
        for k in range(s):
            acc += _inside(part[:, k], out_h, out_w, in_h, in_w).to(torch.float32)
        mean[start:start + chunk] = acc * (1.0 / s)
    return mean


def zero_small(mask: torch.Tensor) -> torch.Tensor:
    """Zero sub-1e-3 mask values (reference mask[mask < 1e-3] = 0)."""
    return torch.where(mask < 1e-3, 0.0, mask)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def _border_tensor(border: Sequence[float] | float, c: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.broadcast_to(np.asarray(border, np.float32), (c,)).copy(), device=device)


def _stream_chunks(frames: torch.Tensor, chunk: int, devices, run, shapes):
    """Time-chunk streaming: for each chunk of ``chunk`` frames, split it
    evenly over ``devices`` (one device when no mesh is active), upload
    each part to its device, call ``run(frames_part, start, end)`` for a
    tuple of device tensors and copy each into a host tensor of
    (N, *shape)."""
    n = frames.shape[0]
    outs = [torch.empty((n, *shape), dtype=torch.float32) for shape in shapes]
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        for (a, b), dev in zip(even_spans(e - s, len(devices)), devices):
            if b == a:
                continue
            parts = run(frames[s + a:s + b].to(dev, torch.float32).contiguous(), s + a, s + b)
            for out, part in zip(outs, parts):
                out[s + a:s + b].copy_(part)
    return outs


def _stream_devices(n: int, device: torch.device):
    """Where a streamed clip's time chunks run: split over the active
    mesh's data axis when it splits the clip evenly, else on ``device``."""
    return data_devices(active_mesh()) if data_shards(n) else [device]


def _warp_bands(frames: torch.Tensor, coeffs: np.ndarray, border, out_h: int, out_w: int, in_h: int, in_w: int,
                interp: Interp, with_mask: bool, devices, ratio_device: torch.device):
    """The "rows" outcome: the output canvas cut into one band of rows a
    device; each band's device receives the source frames and runs K1
    with the band's ``row0`` (and the band's padding stats), so every
    pixel is the whole-canvas warp's.  A frame's padded count is the sum
    of its bands' exact counts.  Returns the tuple of :func:`_warp_clip`
    with row-band FrameShards (``axis=1``)."""
    c = frames.shape[-1]
    bands = [(span, dev) for span, dev in zip(even_spans(out_h, len(devices)), devices) if span[1] > span[0]]
    coeffs_d = [torch.as_tensor(coeffs, device=dev) for _, dev in bands]
    if with_mask:
        masks, total = [], 0
        for ((r0, r1), _), co in zip(bands, coeffs_d):
            mask, cnt = padding_counts(co, r1 - r0, out_w, in_h, in_w, row0=r0)
            masks.append(mask)
            total = total + move(cnt, ratio_device, "gather")
    warped = FrameShards([
        warp_frames(move(frames, dev, "scatter").to(torch.float32).contiguous(), co,
                    _border_tensor(border, c, dev), r1 - r0, out_w, interp, row0=r0)
        for ((r0, r1), dev), co in zip(bands, coeffs_d)
    ], axis=1)
    if not with_mask:
        return (warped,)
    return FrameShards(masks, axis=1), _ratios(total, out_h * out_w), warped


def _warp_clip(frames, matrices: np.ndarray, out_size: Tuple[int, int], interp: Interp, border,
               device, with_mask: bool):
    """:func:`warp_clip` (``(frames,)``) and :func:`warp_clip_with_mask`
    (``(masks, ratios, frames)``), by the clip's layout: streamed through
    time chunks, by row band, or by frame shard (one shard when no mesh
    splits the clip, the result then plain tensors).  The padding stats
    are queued before the warp, so a fetch of the ratios waits for the
    mask passes only."""
    out_w, out_h = int(out_size[0]), int(out_size[1])
    n, h, w, c = frames.shape
    dev = lead_device(frames) if device is None else torch.device(device)
    coeffs = prepare_inverse_coeffs(np.asarray(matrices, np.float64).reshape(n, 3, 3)).astype(np.float32)

    def run(fr, s, e):
        coeffs_t = torch.as_tensor(coeffs[s:e], device=fr.device)
        warped = warp_frames(fr, coeffs_t, _border_tensor(border, c, fr.device), out_h, out_w, interp)
        if not with_mask:
            return (warped,)
        masks, counts = padding_counts(coeffs_t, out_h, out_w, h, w)
        return masks, _ratios(counts, out_h * out_w), warped

    chunk = _chunk_frames(n, h, w, out_h, out_w, c)
    if chunk < n:
        shapes = ([(out_h, out_w), ()] if with_mask else []) + [(out_h, out_w, c)]
        return _stream_chunks(frames, chunk, _stream_devices(n, dev), run, shapes)
    bands = row_band_devices(n, h)
    if bands is not None:
        return _warp_bands(frames, coeffs, border, out_h, out_w, h, w, interp, with_mask, bands, dev)
    shards = frame_shards(frames)
    whole = shards is None
    if whole:
        shards = FrameShards([frames.to(dev)])
    shards = shards.map(lambda f: f.to(torch.float32).contiguous())
    coeffs_t = torch.as_tensor(coeffs, device=dev)
    out = list(padding_stats_sharded(coeffs_t, shards, out_h, out_w, h, w)) if with_mask else []
    out.append(warp_frames_sharded(shards, coeffs_t, _border_tensor(border, c, dev), out_h, out_w, interp))
    return tuple(x.shards[0] if whole and isinstance(x, FrameShards) else x for x in out)


def warp_clip(
    frames,
    matrices: np.ndarray,
    out_size: Tuple[int, int],
    interp: Interp = "bilinear",
    border: Sequence[float] | float = (0.0, 0.0, 0.0),
    device: torch.device | str | None = None,
):
    """Warp a whole clip: frames (N,H,W,C) by per-frame src->dst matrices.

    ``out_size`` is (width, height), the cv2 convention; matrices are
    host values.  The warp runs on ``device`` (default: the frames'
    own), where the result stays -- unless the clip's live set exceeds
    ``CHUNK_BUDGET_BYTES``: then it streams in time chunks and the
    result is a host (CPU) tensor.

    Under an active mesh (utils/meshinfo.py) the warp splits over it as
    the clip lies there (parallel/mesh.py::partition_spec): frame shards
    (a FrameShards, or a clip the data axis splits evenly) warp on their
    own devices, one K1 launch a shard; the "rows" outcome warps one band
    of output rows a device; the result is then a FrameShards.  A
    streamed clip keeps its rule (``will_stream`` on the whole clip) and
    splits each time chunk over the data axis.
    """
    out_w, out_h = int(out_size[0]), int(out_size[1])
    n, c = frames.shape[0], frames.shape[-1]
    if n == 0:
        dev = lead_device(frames) if device is None else torch.device(device)
        return torch.zeros((0, out_h, out_w, c), dtype=torch.float32, device=dev)
    return _warp_clip(frames, matrices, out_size, interp, border, device, with_mask=False)[0]


def warp_clip_with_mask(
    frames,
    matrices: np.ndarray,
    out_size: Tuple[int, int],
    interp: Interp = "bilinear",
    border: Sequence[float] | float = (0.0, 0.0, 0.0),
    device: torch.device | str | None = None,
):
    """:func:`warp_clip` with the padding masks and their per-frame ratios
    (:func:`padding_mask_stats`): ``(frames, masks, ratios)``.

    Unstreamed, all three stay on ``device`` and the masks are queued
    before the frame warp, so a caller that fetches the ratios waits for
    the mask pass only.  Streamed, each time chunk's masks and ratios are
    computed beside its frames and all three are host tensors.  Under an
    active mesh the frames and masks split as in :func:`warp_clip`, each
    mask beside its frames, and the ratios are gathered to ``device``.
    """
    masks, ratios, warped = _warp_clip(frames, matrices, out_size, interp, border, device, with_mask=True)
    return warped, masks, ratios


def warp_clip_blur(
    frames: torch.Tensor,
    sample_matrices: np.ndarray,
    out_size: Tuple[int, int],
    interp: Interp = "bilinear",
    border: Sequence[float] | float = (0.0, 0.0, 0.0),
    with_mask: bool = True,
    device: torch.device | str | None = None,
) -> Tuple[torch.Tensor, torch.Tensor | None]:
    """Shutter-sampled motion blur: the mean of S warps per frame.

    ``sample_matrices`` has shape (N, S, 3, 3).  The warp and the soft
    mask (1 - mean coverage, small values zeroed) go through
    :func:`warp_blur_frames`: one K3 launch on a CUDA tensor, which reads
    the frames once, never replicated S-fold.  Both run on ``device``
    (default: the frames' own) and stay there, unless the clip streams
    through time chunks as in :func:`warp_clip`; then both are host
    tensors.
    """
    n, s = sample_matrices.shape[:2]
    out_w, out_h = int(out_size[0]), int(out_size[1])
    _, h, w, c = frames.shape
    dev = frames.device if device is None else torch.device(device)
    if n == 0:
        empty = torch.zeros((0, out_h, out_w, c), dtype=torch.float32, device=dev)
        mask = torch.zeros((0, out_h, out_w), dtype=torch.float32, device=dev) if with_mask else None
        return empty, mask
    # one (N*S)-coefficient host pass feeds both the warp and the mask
    sample_coeffs = prepare_inverse_coeffs(
        np.asarray(sample_matrices, np.float64).reshape(n * s, 3, 3)
    ).reshape(n, s, 8).astype(np.float32)
    border_t = _border_tensor(border, c, dev)

    def run(fr, a, e):
        out, mask = warp_blur_frames(fr, torch.as_tensor(sample_coeffs[a:e], device=dev), border_t,
                                     out_h, out_w, interp, with_mask)
        return (out,) if mask is None else (out, mask)

    chunk = _chunk_frames(n, h, w, out_h, out_w, c)
    if chunk >= n:
        parts = run(frames.to(dev, torch.float32).contiguous(), 0, n)
    else:
        shapes = [(out_h, out_w, c)] + ([(out_h, out_w)] if with_mask else [])
        parts = _stream_chunks(frames, chunk, [dev], run, shapes)
    return parts[0], (parts[1] if with_mask else None)
