"""FFT phase correlation: the Flow estimator's last-resort tier (PyTorch).

Counterpart of ``comfyui_video_stabilizer_tpu/ops/phase_corr.py``
(cv2.phaseCorrelate's semantics): the normalised cross-power spectrum's
peak, refined by a 5x5 weighted centroid with wrap-around, the peak
region's energy as the response.  The shift maps prev to curr (curr =
shift(prev)), cv2's sign.  The JAX package uses XLA's FFT here, not a
Pallas kernel; this uses ``torch.fft`` on the grays' device.
"""

from __future__ import annotations

import numpy as np
import torch


def _phase_correlate(prev: torch.Tensor, curr: torch.Tensor):
    """prev/curr (B, H, W) float32 -> shifts (B, 2) as (x, y), responses (B,)."""
    B, H, W = prev.shape
    cross = torch.fft.rfft2(prev) * torch.conj(torch.fft.rfft2(curr))
    mag = torch.abs(cross)
    cross = cross / torch.where(mag < 1e-12, 1.0, mag)
    flat = torch.fft.irfft2(cross, s=(H, W)).reshape(B, -1)

    peak = torch.argmax(flat, dim=-1)        # the first index of the maximum
    py = torch.div(peak, W, rounding_mode="floor")
    px = peak - py * W
    # 5x5 weighted centroid around the peak, wrapping at the borders
    offs = torch.arange(-2, 3, device=prev.device)
    oy = (py[:, None, None] + offs[None, :, None]) % H
    ox = (px[:, None, None] + offs[None, None, :]) % W
    vals = torch.gather(flat, 1, (oy * W + ox).reshape(B, 25)).reshape(B, 5, 5)
    vals = torch.clamp(vals, min=0.0)
    wsum = torch.clamp(vals.sum(dim=(1, 2)), min=1e-12)
    offs_f = offs.to(torch.float32)
    cy = (vals.sum(dim=2) * offs_f[None]).sum(dim=1) / wsum
    cx = (vals.sum(dim=1) * offs_f[None]).sum(dim=1) / wsum
    sy = py + cy
    sx = px + cx
    sy = torch.where(sy > H / 2, sy - H, sy)  # wrap to the signed range
    sx = torch.where(sx > W / 2, sx - W, sx)
    # the inverse FFT of a unit-magnitude spectrum: a perfect match puts
    # (nearly) all energy at the peak, so the 5x5 sum is a 0..1 response
    return torch.stack([sx, sy], dim=-1), vals.sum(dim=(1, 2))


def phase_correlate_batch(prev, curr):
    """(B, H, W) gray pairs -> (shifts (B, 2) prev->curr, responses (B,)),
    float64 numpy.

    prev and curr are tensors (computed on their device) or arrays.  The
    translation matrix of a pair is T(shift): warping prev by it aligns
    it with curr.
    """
    prev = torch.as_tensor(prev).to(torch.float32)
    curr = torch.as_tensor(curr).to(torch.float32)
    # remove DC so an untextured border's constant does not dominate
    p = prev - prev.mean(dim=(1, 2), keepdim=True)
    c = curr - curr.mean(dim=(1, 2), keepdim=True)
    shifts, resp = _phase_correlate(p, c)
    shifts = shifts.cpu().numpy().astype(np.float64)
    resp = resp.cpu().numpy().astype(np.float64)
    # cv2 returns the displacement of src2 relative to src1
    shifts = -shifts
    bad = ~np.isfinite(shifts).all(axis=1) | ~np.isfinite(resp)
    shifts[bad] = 0.0
    resp[bad] = 0.0
    return shifts, np.clip(resp, 0.0, 1.0)
