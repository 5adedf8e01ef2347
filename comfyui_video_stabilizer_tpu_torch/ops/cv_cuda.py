"""DIS residual cost volume + sub-pixel argmin (PyTorch + K2).

Counterpart of ``comfyui_video_stabilizer_tpu/ops/cv_pallas.py``.  For
level grays I and the pre-warped Jw, each shift in [-r, r]^2 gets the
8x8-patch mean of the squared difference (inputs scaled to 0..1),
summed by the shift-add tree ``tree`` (rows pairwise at steps 1, 2, 4,
then columns, then x1/64).  A dy-major scan with a strict ``<`` keeps
the first candidate on ties; a parabola through the neighbour costs
gives the sub-pixel offset, clipped to +-0.5 and zero at the window
edge.  Borders come from one edge pad of the inputs: (4, 3) per axis
for I, plus r for Jw.

``cost_volume_subpixel`` is the kernel wrapper: a CUDA tensor launches
K2 (``csrc/cost_volume.cu``), a CPU tensor takes
``cost_volume_plain``, which mirrors ``cost_volume_subpixel_xla`` op
for op.  Every level goes to the kernel; the TPU's whole-level-in-VMEM
gate does not apply.
"""

from __future__ import annotations

import torch

from . import cuda_build


def edge_pad(x: torch.Tensor, top: int, bottom: int, left: int, right: int) -> torch.Tensor:
    """Replicate-pad the last two axes (jnp.pad mode='edge')."""
    H, W = x.shape[-2:]
    ys = torch.arange(-top, H + bottom, device=x.device).clamp_(0, H - 1)
    xs = torch.arange(-left, W + right, device=x.device).clamp_(0, W - 1)
    return x.index_select(-2, ys).index_select(-1, xs)


def tree(xp: torch.Tensor, patch: int) -> torch.Tensor:
    """Overlapping box-sum shift-add tree over the last two axes (shrinks
    by patch-1 per axis), then x1/patch^2; the op order of _tree."""
    step = 1
    while step < patch:
        xp = xp[..., :-step, :] + xp[..., step:, :]
        step *= 2
    step = 1
    while step < patch:
        xp = xp[..., :-step] + xp[..., step:]
        step *= 2
    return xp * (1.0 / (patch * patch))


def cost_volume_plain(I: torch.Tensor, Jw: torch.Tensor, radius: int, patch: int):
    """Plain PyTorch version of K2: (fx, fy, cmin), each (B, H, W) float32."""
    B, H, W = I.shape
    k = 2 * radius + 1
    pt, pb = patch // 2, patch // 2 - 1
    hp, wp = H + patch - 1, W + patch - 1
    iagg = edge_pad(I.to(torch.float32), pt, pb, pt, pb) * (1.0 / 255.0)
    jbuf = edge_pad(Jw.to(torch.float32), pt + radius, pb + radius, pt + radius, pb + radius)

    costs = []
    cmin = best = None
    for i, (dy, dx) in enumerate(
        (dy, dx) for dy in range(-radius, radius + 1) for dx in range(-radius, radius + 1)
    ):
        sh = jbuf[..., dy + radius: dy + radius + hp, dx + radius: dx + radius + wp] * (1.0 / 255.0)
        d = iagg - sh
        c = tree(d * d, patch)
        costs.append(c)
        if cmin is None:
            cmin = c
            best = torch.zeros(c.shape, dtype=torch.int32, device=c.device)
        else:
            take = c < cmin
            cmin = torch.where(take, c, cmin)
            best = torch.where(take, i, best)

    by = torch.div(best, k, rounding_mode="floor")
    bx = best - by * k
    tgt_y0 = torch.clamp(by - 1, min=0) * k + bx
    tgt_y1 = torch.clamp(by + 1, max=k - 1) * k + bx
    tgt_x0 = by * k + torch.clamp(bx - 1, min=0)
    tgt_x1 = by * k + torch.clamp(bx + 1, max=k - 1)
    cy0 = torch.zeros_like(cmin)
    cy1 = torch.zeros_like(cmin)
    cx0 = torch.zeros_like(cmin)
    cx1 = torch.zeros_like(cmin)
    for i, c in enumerate(costs):
        cy0 = torch.where(tgt_y0 == i, c, cy0)
        cy1 = torch.where(tgt_y1 == i, c, cy1)
        cx0 = torch.where(tgt_x0 == i, c, cx0)
        cx1 = torch.where(tgt_x1 == i, c, cx1)

    def parab(cm, cl, cr):
        denom = cl + cr - 2.0 * cm
        off = torch.where(denom > 1e-9, 0.5 * (cl - cr) / torch.clamp(denom, min=1e-9), 0.0)
        return torch.clamp(off, -0.5, 0.5)

    suby = torch.where((by == 0) | (by == k - 1), 0.0, parab(cmin, cy0, cy1))
    subx = torch.where((bx == 0) | (bx == k - 1), 0.0, parab(cmin, cx0, cx1))
    fy = by.to(torch.float32) - radius + suby
    fx = bx.to(torch.float32) - radius + subx
    return fx, fy, cmin


def cost_volume_subpixel(I: torch.Tensor, Jw: torch.Tensor, radius: int, patch: int):
    """Residual cost volume + parabolic sub-pixel argmin.

    I, Jw: (B, H, W) float32 grays in 0..255 units.  Returns (fx, fy,
    cmin), each (B, H, W) float32.  CUDA tensors launch K2 (raising if
    it cannot build or launch); CPU tensors take the plain version.
    """
    if I.device.type == "cpu":
        return cost_volume_plain(I, Jw, radius, patch)
    cuda_build.require_cuda_tensor("I", I, torch.float32, 3)
    cuda_build.require_cuda_tensor("Jw", Jw, torch.float32, 3)
    if I.shape != Jw.shape or I.device != Jw.device:
        raise cuda_build.KernelArgumentError(
            f"I {tuple(I.shape)} and Jw {tuple(Jw.shape)} must match in shape and device")
    if radius not in (2, 3) or patch != 8:
        raise cuda_build.KernelArgumentError(f"K2 takes radius 2 or 3 and patch 8, got {radius} and {patch}")
    B, H, W = I.shape
    if B < 1:
        raise cuda_build.KernelArgumentError(f"K2 takes at least one pair, got {B}")
    fx = torch.empty_like(I)
    fy = torch.empty_like(I)
    cmin = torch.empty_like(I)
    with torch.cuda.device(I.device):
        for s, e in cuda_build.frame_spans(B):
            err = cuda_build.library().cvst_cost_volume(
                I[s:e].data_ptr(), Jw[s:e].data_ptr(), fx[s:e].data_ptr(), fy[s:e].data_ptr(),
                cmin[s:e].data_ptr(), e - s, H, W, radius, patch, cuda_build.current_stream(I.device),
            )
            cuda_build.check_launch(err, "cost_volume")
            cuda_build.LAUNCHES["cost_volume"] += 1
    return fx, fy, cmin
