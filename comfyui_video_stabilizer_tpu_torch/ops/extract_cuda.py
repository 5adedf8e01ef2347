"""Per-feature window extraction (PyTorch + K6).

Counterpart of ``comfyui_video_stabilizer_tpu/ops/lk.py::
_extract_windows_batched`` and of the Pallas DMA kernel
``ops/extract_pallas.py::extract_windows_dma`` behind it: for a (B, H,
W) stack and (B, F, 2) integer (x, y) corners, the window of feature f
is an exact copy of ``padded[cy:cy + wext, cx:cx + wext]``, where
``padded`` is the stack zero-padded by ``wext`` a side and the corner
``(y + wext, x + wext)`` is clamped to ``[0, Hp - wext]`` x ``[0, Wp -
wext]`` (dynamic_slice semantics).

The one-hot selection matmuls and their bf16 mode are TPU workarounds
for a missing gather and are not ported.  ``extract_windows`` is the
kernel wrapper: a CUDA tensor launches K6 (``csrc/extract.cu``), which
reads the unpadded stack and applies the pad by index arithmetic; a CPU
tensor takes ``extract_plain`` (pad, clamp, one index gather).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cuda_build


def extract_plain(stack: torch.Tensor, corners: torch.Tensor, wext: int) -> torch.Tensor:
    """Plain PyTorch version of K6: (B, F, wext, wext) float32 windows."""
    B, H, W = stack.shape
    padded = F.pad(stack.to(torch.float32), (wext, wext, wext, wext))
    hp, wp = H + 2 * wext, W + 2 * wext
    # corners in padded coordinates, clamped so the window fits
    cy = torch.clamp(corners[..., 1].to(torch.int64) + wext, 0, H + wext)
    cx = torch.clamp(corners[..., 0].to(torch.int64) + wext, 0, W + wext)
    ar = torch.arange(wext, device=stack.device)
    rows = (torch.arange(B, device=stack.device)[:, None, None] * hp + cy[..., None] + ar)
    cols = cx[..., None] + ar
    flat = rows[..., :, None] * wp + cols[..., None, :]
    return padded.reshape(-1)[flat]


def extract_windows(stack: torch.Tensor, corners: torch.Tensor, wext: int) -> torch.Tensor:
    """(B, H, W) float32 stack + (B, F, 2) int32 (x, y) corners ->
    (B, F, wext, wext) float32 windows, exact copies.

    CUDA tensors launch K6 (raising if it cannot build or launch); CPU
    tensors take the plain version.
    """
    if stack.device.type == "cpu":
        return extract_plain(stack, corners, wext)
    cuda_build.require_cuda_tensor("stack", stack, torch.float32, 3)
    cuda_build.require_cuda_tensor("corners", corners, torch.int32, 3)
    B, H, W = stack.shape
    if corners.shape[0] != B or corners.shape[2] != 2 or corners.device != stack.device:
        raise cuda_build.KernelArgumentError(
            f"corners {tuple(corners.shape)} must be ({B}, F, 2) on {stack.device}"
        )
    F_ = corners.shape[1]
    if B < 1 or F_ < 1 or not 1 <= wext <= 1024:
        raise cuda_build.KernelArgumentError(f"K6 takes B >= 1 frames, F >= 1 and 1 <= wext <= 1024, got "
                                             f"{B}, {F_}, {wext}")
    out = torch.empty((B, F_, wext, wext), dtype=torch.float32, device=stack.device)
    with torch.cuda.device(stack.device):
        for s, e in cuda_build.frame_spans(B):
            err = cuda_build.library().cvst_extract_windows(
                stack[s:e].data_ptr(), corners[s:e].data_ptr(), out[s:e].data_ptr(),
                e - s, H, W, F_, wext, cuda_build.current_stream(stack.device),
            )
            cuda_build.check_launch(err, "extract_windows")
            cuda_build.LAUNCHES["extract_windows"] += 1
    return out
