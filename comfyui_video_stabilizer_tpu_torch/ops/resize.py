"""Grayscale and area resize for the estimation path (plain PyTorch).

Counterpart of ``comfyui_video_stabilizer_tpu/ops/resize.py``.  Gray is
the Rec.601 luma dot followed by the reference's "x255 -> uint8"
quantization (floor).  Integer shrink factors mean-pool (the area
weights are uniform there); other factors apply the separable
INTER_AREA weights as two float32 matrix products.

The luma dot is evaluated as the fused multiply-add chain that XLA's
CPU backend emits for the JAX reference: products are exact in float64
and each step is rounded once to float32.  With a different rounding
one pixel in a few thousand lands one grey level off after the floor.

``gray_for_estimation`` takes the clip in chunks of 16 frames: each is
moved to the estimation device (an upload when the clip is held on the
host because it streams), turned to gray and resized there; only the
small grays stay on the device.  Every path computes the same 16-frame
chunks, so a streamed clip gets the grays of an uploaded one bitwise.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..parallel.mesh import FrameShards

_LUMA = np.array([0.299, 0.587, 0.114], np.float32)

# Frames per gray chunk: bounds the float64 temporaries of the luma
# chain (~1.3 GB for 80 frames of 1080p unchunked) and the upload of a
# clip held on the host.
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


def make_gray(frames: torch.Tensor, quantize: bool = True) -> torch.Tensor:
    """(N,H,W,3) float 0..1 -> (N,H,W) float gray (integers 0..255 when quantized)."""
    frames = frames.to(torch.float32)
    if frames.ndim == 3:
        frames = frames[..., None]
    gray = frames[..., 0] if frames.shape[-1] == 1 else _luma(frames)
    return _quantize(gray) if quantize else gray


def box_pool(stack: torch.Tensor, fy: int, fx: int) -> torch.Tensor:
    """fy x fx mean pool as the reference's XLA mean computes it: the sum
    times the float32 reciprocal of fy * fx.  ``Tensor.mean`` divides on
    the CPU and multiplies on the card, so for a factor that is not a
    power of two the two devices would differ by an ulp; the factor is a
    0-dim tensor on the stack's device, so both multiply."""
    n, h, w = stack.shape
    inv = torch.full((), float(np.float32(1.0) / np.float32(fy * fx)), dtype=torch.float32, device=stack.device)
    return stack.reshape(n, h // fy, fy, w // fx, fx).sum(dim=(2, 4)) * inv


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
    (default: the frames' own), taken 16 frames at a time.

    Frame shards (parallel/mesh.py::FrameShards) give frame shards: each
    shard's gray is made on its own device (``device`` is not used).

    The caller must have checked :func:`can_decimate` for
    ``decimation`` > 1.
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

    def one(chunk: torch.Tensor) -> torch.Tensor:
        gray = make_gray(chunk, quantize)
        if working_size is None:
            return gray
        if weights is None and chunk.ndim == 4 and chunk.shape[-1] == 3:
            return box_pool(gray, h_in // out_h, w_in // out_w)
        return area_resize(gray, working_size, weights)

    parts = [one(frames[s:s + _GRAY_CHUNK_FRAMES].to(dev)) for s in range(0, frames.shape[0], _GRAY_CHUNK_FRAMES)]
    return torch.cat(parts, dim=0)
