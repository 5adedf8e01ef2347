"""Grayscale and area resize for the estimation path.

Counterpart of ``comfyui_video_stabilizer_tpu/ops/resize.py``.  Gray is
the Rec.601 luma dot followed by the reference's "x255 -> uint8"
quantization (floor).  Integer shrink factors mean-pool (the area
weights are uniform there); other factors apply the separable
INTER_AREA weights as two float32 matrix products.

The luma dot is evaluated as the fused multiply-add chain that XLA's
CPU backend emits for the JAX reference: products are exact in float64
and each step is rounded once to float32.  With a different rounding
one pixel in a few thousand lands one grey level off after the floor.

``gray_pool`` is the kernel wrapper of the gray and its integer pool: a
CUDA tensor launches the hand-written kernel K9 (``csrc/gray.cu``), a
CPU tensor takes ``gray_pool_plain``, the plain PyTorch version with the
same op order.  ``make_gray`` and ``gray_for_estimation`` go through it.

``gray_for_estimation`` turns a clip already on the estimation device
into grays in one call.  A clip held on the host (because it streams)
is uploaded 16 frames at a time, and each chunk is turned to gray and
resized on the device; only the small grays stay there.  A gray pixel
depends on its own source patch only, so the chunking never changes a
bit.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..parallel.mesh import FrameShards
from ..utils import profiling as P
from . import cuda_build

_LUMA = np.array([0.299, 0.587, 0.114], np.float32)

# Frames per gray chunk: bounds the upload of a clip held on the host and
# the plain version's float64 temporaries of the luma chain (~1.3 GB for
# 80 frames of 1080p unchunked).
_GRAY_CHUNK_FRAMES = 16


def area_weights(src: int, dst: int) -> np.ndarray:
    """(dst, src) area-overlap weights for 1-D INTER_AREA downscale."""
    scale = src / dst
    w = np.zeros((dst, src), np.float64)
    for i in range(dst):
        lo = i * scale
        hi = (i + 1) * scale
        j0 = int(np.floor(lo))
        j1 = int(np.ceil(hi))
        for j in range(j0, min(j1, src)):
            overlap = min(hi, j + 1) - max(lo, j)
            if overlap > 0:
                w[i, j] = overlap
        w[i] /= w[i].sum()
    return w.astype(np.float32)


def _luma(frames: torch.Tensor) -> torch.Tensor:
    """(N,H,W,3) float32 -> (N,H,W) float32: r*L0, then fma(g, L1, .), fma(b, L2, .)."""
    l0, l1, l2 = (float(v) for v in _LUMA)
    acc = (frames[..., 0].double() * l0).float()
    acc = (frames[..., 1].double() * l1 + acc.double()).float()
    return (frames[..., 2].double() * l2 + acc.double()).float()


def _quantize(gray: torch.Tensor) -> torch.Tensor:
    return torch.floor(torch.clamp(gray * 255.0, 0.0, 255.0))


def _as_frames(frames: torch.Tensor) -> torch.Tensor:
    """float32 (N, H, W, C) frames, contiguous; an (N, H, W) stack is one channel."""
    frames = frames.to(torch.float32)
    if frames.ndim == 3:
        frames = frames[..., None]
    return frames.contiguous()


def _gray_plain(frames: torch.Tensor, quantize: bool) -> torch.Tensor:
    gray = frames[..., 0] if frames.shape[-1] == 1 else _luma(frames)
    return _quantize(gray) if quantize else gray


def box_pool(stack: torch.Tensor, fy: int, fx: int) -> torch.Tensor:
    """fy x fx mean pool as the reference's XLA mean computes it: each
    patch summed in float32 in row-major order, the order of XLA's CPU
    reduce (exact on quantized grays), times the float32 reciprocal of
    fy * fx.  ``Tensor.mean`` divides on the CPU and multiplies on the
    card, so for a factor that is not a power of two the two devices would
    differ by an ulp; the factor is a 0-dim tensor on the stack's device,
    so both multiply."""
    n, h, w = stack.shape
    inv = torch.full((), float(np.float32(1.0) / np.float32(fy * fx)), dtype=torch.float32, device=stack.device)
    patches = stack.reshape(n, h // fy, fy, w // fx, fx)
    acc = patches[:, :, 0, :, 0]
    for i in range(fy):
        for j in range(fx):
            if i or j:
                acc = acc + patches[:, :, i, :, j]
    return acc * inv


def gray_pool_plain(frames: torch.Tensor, fy: int, fx: int, quantize: bool = True) -> torch.Tensor:
    """Plain PyTorch version of K9: the gray of (N, H, W, C) float32 frames
    (channel 0 of a 1-channel clip, else the luma of channels 0-2),
    quantized when ``quantize``, then :func:`box_pool` by fy x fx (none at
    1 x 1); 16 frames at a time, bounding the luma's float64 temporaries."""
    parts = []
    for s in range(0, max(frames.shape[0], 1), _GRAY_CHUNK_FRAMES):  # one empty part for no frames
        gray = _gray_plain(frames[s:s + _GRAY_CHUNK_FRAMES], quantize)
        parts.append(gray if fy == fx == 1 else box_pool(gray, fy, fx))
    return torch.cat(parts, dim=0)


def gray_pool(frames: torch.Tensor, fy: int, fx: int, quantize: bool = True) -> torch.Tensor:
    """(N, H, W, C) float32 frames -> (N, H / fy, W / fx) float32 gray
    pooled by fy x fx: :func:`gray_pool_plain`'s result.  CUDA tensors
    launch K9 (raising if it cannot build or launch; it takes 1 or 3
    channels); CPU tensors take :func:`gray_pool_plain`."""
    if frames.device.type == "cpu":
        return gray_pool_plain(frames, fy, fx, quantize)
    cuda_build.require_cuda_tensor("frames", frames, torch.float32, 4)
    n, h, w, c = frames.shape
    if c not in (1, 3):
        raise cuda_build.KernelArgumentError(f"K9 takes 1 or 3 channels, got {c}")
    if fy < 1 or fx < 1 or h % fy or w % fx:
        raise cuda_build.KernelArgumentError(f"K9's pool {fy} x {fx} does not divide the frame {h} x {w}")
    out = torch.empty((n, h // fy, w // fx), dtype=torch.float32, device=frames.device)
    with torch.cuda.device(frames.device):
        for s, e in cuda_build.frame_spans(n):
            err = cuda_build.library().cvst_gray_pool(
                frames[s:e].data_ptr(), out[s:e].data_ptr(), e - s, h, w, c, fy, fx, int(quantize),
                cuda_build.current_stream(frames.device),
            )
            cuda_build.check_launch(err, "gray_pool")
            cuda_build.LAUNCHES["gray_pool"] += 1
    return out


def make_gray(frames: torch.Tensor, quantize: bool = True) -> torch.Tensor:
    """(N,H,W,3) float 0..1 -> (N,H,W) float gray (integers 0..255 when quantized)."""
    return gray_pool(_as_frames(frames), 1, 1, quantize)


def _area_matrices(h: int, w: int, out_w: int, out_h: int, device: torch.device):
    """The (out_h, h) row and (out_w, w) column INTER_AREA weights on ``device``."""
    return (torch.as_tensor(area_weights(h, out_h), device=device),
            torch.as_tensor(area_weights(w, out_w), device=device))


def area_resize(stack: torch.Tensor, out_size: Tuple[int, int], weights=None) -> torch.Tensor:
    """INTER_AREA downscale of an (N, H, W) stack to (w, h).  ``weights``
    are :func:`_area_matrices`' for these sizes, made here when None."""
    out_w, out_h = int(out_size[0]), int(out_size[1])
    n, h, w = stack.shape
    stack = stack.to(torch.float32)
    if (out_w, out_h) == (w, h):
        return stack
    if h % out_h == 0 and w % out_w == 0:
        return box_pool(stack, h // out_h, w // out_w)
    wr, wc = weights if weights is not None else _area_matrices(h, w, out_w, out_h, stack.device)
    return torch.matmul(torch.matmul(wr, stack), wc.T)


def can_decimate(
    width: int, height: int, working_size: Tuple[int, int] | None, decimation: int
) -> bool:
    """True when one fused gray+pool reproduces working-res gray followed
    by ``log2(decimation)`` exact 2x area halvings."""
    if decimation <= 1:
        return True
    tw, th = working_size if working_size is not None else (int(width), int(height))
    if int(width) % tw or int(height) % th:
        return False
    return th % decimation == 0 and tw % decimation == 0


def gray_for_estimation(
    frames: torch.Tensor,
    working_size: Tuple[int, int] | None,
    quantize: bool = True,
    decimation: int = 1,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """Gray at the working size (divided by ``decimation``) on ``device``
    (default: the frames' own); a clip on the host for a device elsewhere
    is uploaded 16 frames at a time.

    Frame shards (parallel/mesh.py::FrameShards) give frame shards: each
    shard's gray is made on its own device (``device`` is not used).

    The caller must have checked :func:`can_decimate` for
    ``decimation`` > 1.  Integer factors (and no resize) are one
    :func:`gray_pool` call; other factors pool the gray by the area
    matrices, in span ``gray.area_resize`` (one a chunk of a host clip).
    """
    if isinstance(frames, FrameShards):
        return frames.map(lambda f: gray_for_estimation(f, working_size, quantize, decimation))
    dev = frames.device if device is None else torch.device(device)
    h_in, w_in = int(frames.shape[1]), int(frames.shape[2])
    if decimation > 1:
        if not can_decimate(w_in, h_in, working_size, decimation):
            raise ValueError(f"decimation {decimation} does not divide the working size")
        tw, th = working_size if working_size is not None else (w_in, h_in)
        working_size = (tw // decimation, th // decimation)

    weights = None
    if working_size is not None:
        out_w, out_h = int(working_size[0]), int(working_size[1])
        if h_in % out_h or w_in % out_w:
            # once a clip, not once a chunk: area_weights loops on the host
            weights = _area_matrices(h_in, w_in, out_w, out_h, dev)

    fy, fx = (1, 1) if working_size is None or weights is not None else (h_in // out_h, w_in // out_w)

    def one(chunk: torch.Tensor) -> torch.Tensor:
        gray = gray_pool(_as_frames(chunk), fy, fx, quantize)
        if weights is None:
            return gray
        with P.span("gray.area_resize", dev):
            return area_resize(gray, working_size, weights)

    if frames.device.type != "cpu" or dev.type == "cpu":
        return one(frames.to(dev))
    parts = [one(frames[s:s + _GRAY_CHUNK_FRAMES].to(dev)) for s in range(0, frames.shape[0], _GRAY_CHUNK_FRAMES)]
    return torch.cat(parts, dim=0)
