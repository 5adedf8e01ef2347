"""The plain reference stabilizer of ``flow_720p_persp_lock``: Flow,
perspective, camera lock, crop_and_pad.

Plain PyTorch and NumPy, a copy of the default reference (``benchmark/
reference/``) extended to this configuration's modes, frozen from the
port's plain path (the fast path's float32 trajectory and framing, as
the card runs them) and run on whatever device its input clip lies on.
It imports nothing of the program and takes only the clip and the node
settings; it works out the grays, the motion, the trajectory, the
framing, the warp and the padding masks again.  What it adds to the
default:

- the working gray of a size that is no integer pool of the clip (1280x720
  -> 960x540): the floored luma at full size, then the separable
  INTER_AREA weights as two float32 products, rows then columns; Flow's
  decimation is then 1;
- DIS's homography pre-warp (``dis.py``: the IRLS fit of the dense flow
  on the 4-stride grid, with its guard);
- perspective RANSAC (``ransac.py``: 4-point hypotheses under the same
  threefry keys, key salt 0; refits by the DLT's smallest eigenvector)
  accepted at an inlier ratio of ``PERSP_MIN_RATIO``, and the sticky
  selection perspective -> similarity -> translation;
- the 8-parameter path ``[a-1, b, tx, c, d-1, ty, g, h]`` and its
  integration; camera lock's zero target, with smooth raised to 0.85;
- the bilinear warp and the padding mask on projective coefficients
  (the division by the third row), and crop_and_pad's recentring of
  perspective corrections (the corners divided by their third row).

Only the modes this configuration runs are here: the Flow estimator,
crop_and_pad, perspective with camera lock; anything else raises.

Departures from the port's order (``dis.py``, ``ransac.py`` name each):
the library's LU for the 8x8 solves and ``torch.linalg.eigh`` for the
DLT's eigenvector, where the port runs its own elimination (K11) and
Jacobi (K10); the library's order for the homography fits' sums.  Each
has a sound variant below.

The contract of a reference (the names the harness calls, ``Result``'s
fields) is stated in the default's ``benchmark/reference/engine.py``;
this package keeps it, and its ``to_matrices`` reads the 8-parameter
paths it writes.

``store`` is the control: a dtype every tensor is rounded through where
one stage hands it to the next (the input clip, the flow samples, the
per-transition matrices, the camera path and its target, the applied
warp, the output frames), as a program that kept
its images, motion and trajectory in that precision would.  None keeps
float32 throughout.

``variant`` names a sound way of computing the same thing that the
program could take and the reference does not: ``reordered`` takes the
sums of DIS's homography IRLS and of the RANSAC refits (the similarity's
and the perspective DLT's) over the points in reverse order, ``trajectory64`` works out the trajectory in
float64 (as the port's host engine does), ``linalg64`` makes the 8x8
solves (the 4-point hypotheses, the IRLS normal equations) and the DLT's
eigenvector in float64.  Their gaps to the reference are readings of
sound arithmetic, which the limits have to leave room for.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from . import dis, ransac

VARIANTS = ("reordered", "trajectory64", "linalg64")

SAMPLE_STEP = 8
MIN_VALID = 12
PERSP_MIN_RATIO = 0.15
SIM_MIN_RATIO = 0.1
ESTIMATION_MAX_SIDE = 960
_LUMA = np.array([0.299, 0.587, 0.114], np.float32)
_GRAY_CHUNK = 16
_WARP_CHUNK = 8
_DISP_LIM = 1.0e6


@dataclass
class Result:
    """What the reference works out for one clip."""

    modes: List[str]
    motion: np.ndarray          # (N-1, 3, 3) per-transition matrices, full resolution
    path: np.ndarray            # (N, D) integrated parameters, D as ``to_matrices`` reads them
    target_path: np.ndarray     # (N, D)
    final: np.ndarray           # (N, 3, 3) float32 applied warp
    frames: torch.Tensor        # (N, H, W, 3) float32
    masks: torch.Tensor         # (N, H, W) float32, 1 where padded
    ratios: np.ndarray          # (N,) padded share a frame
    framing: Dict[str, object]  # the framing fields of the node's meta


def _held(x: torch.Tensor, store) -> torch.Tensor:
    return x if store is None else x.to(store).to(x.dtype)


# ---------------------------------------------------------------------------
# Grays at the working size
# ---------------------------------------------------------------------------

def working_size(width: int, height: int) -> Tuple[int, int] | None:
    longest = max(width, height)
    if longest <= ESTIMATION_MAX_SIDE:
        return None
    scale = ESTIMATION_MAX_SIDE / float(longest)
    small_w, small_h = max(1, int(round(width * scale))), max(1, int(round(height * scale)))
    if small_w >= width or small_h >= height:
        return None
    return small_w, small_h


def flow_decimation(width: int, height: int, work) -> int:
    """The gray decimation of the Flow fit path (its finest level is a quarter)."""
    dec = 1 << dis.FINEST_SCALE
    if SAMPLE_STEP % dec:
        return 1
    tw, th = work if work is not None else (width, height)
    if dis.num_levels(th, tw) < dis.FINEST_SCALE:
        return 1
    if width % tw or height % th:
        return 1
    return dec if th % dec == 0 and tw % dec == 0 else 1


def _luma(frames: torch.Tensor) -> torch.Tensor:
    """r*L0, then each further product added in float64 and rounded to float32."""
    l0, l1, l2 = (float(v) for v in _LUMA)
    acc = (frames[..., 0].double() * l0).float()
    acc = (frames[..., 1].double() * l1 + acc.double()).float()
    return (frames[..., 2].double() * l2 + acc.double()).float()


def area_weights(src: int, dst: int) -> np.ndarray:
    """(dst, src) float32 INTER_AREA weights: output cell i covers source
    [i s, (i + 1) s) with s = src / dst, each source pixel weighted by its
    overlap with that cell, the row normalized to sum 1."""
    edges = np.arange(dst + 1, dtype=np.float64) * (src / dst)
    j = np.arange(src, dtype=np.float64)[None, :]
    overlap = np.clip(np.minimum(edges[1:, None], j + 1.0) - np.maximum(edges[:-1, None], j), 0.0, None)
    return (overlap / overlap.sum(axis=1, keepdims=True)).astype(np.float32)


def grays(frames: torch.Tensor, out_w: int, out_h: int) -> torch.Tensor:
    """floor(255 x luma) at (N, out_h, out_w): pooled by integer factors
    where they divide the clip, else the full-size gray of the whole clip
    through the INTER_AREA weights, rows then columns (two float32
    products)."""
    n, h, w, _ = frames.shape
    pooled = h % out_h == 0 and w % out_w == 0
    fy, fx = (h // out_h, w // out_w) if pooled else (1, 1)
    inv = torch.full((), float(np.float32(1.0) / np.float32(fy * fx)), dtype=torch.float32, device=frames.device)
    parts = []
    for s in range(0, n, _GRAY_CHUNK):
        g = torch.floor(torch.clamp(_luma(frames[s:s + _GRAY_CHUNK]) * 255.0, 0.0, 255.0))
        if fy > 1 or fx > 1:
            patches = g.reshape(g.shape[0], out_h, fy, out_w, fx)
            acc = patches[:, :, 0, :, 0]
            for i in range(fy):
                for j in range(fx):
                    if i or j:
                        acc = acc + patches[:, :, i, :, j]
            g = acc * inv
        parts.append(g)
    g = torch.cat(parts, dim=0)
    if pooled:
        return g
    rows = torch.as_tensor(area_weights(h, out_h), device=frames.device)
    cols = torch.as_tensor(area_weights(w, out_w), device=frames.device)
    return torch.matmul(torch.matmul(rows, g), cols.T)


# ---------------------------------------------------------------------------
# Per-pair fits (on the clip's device)
# ---------------------------------------------------------------------------

@dataclass
class Fits:
    """Per pair, each mode's fit and whether it is accepted (perspective,
    similarity; translation, the median shift, always is), and whether the
    pair is degenerate (device tensors)."""

    H: torch.Tensor
    H_ok: torch.Tensor
    S: torch.Tensor
    S_ok: torch.Tensor
    T: torch.Tensor
    degenerate: torch.Tensor
    work: Tuple[int, int] | None


def _accepted(M, n_in, n_valid, gate_counts, min_points, min_ratio):
    conf = torch.where(n_valid > 0, n_in / torch.clamp(n_valid, min=1), 0.0)
    return torch.isfinite(M).all(dim=-1).all(dim=-1) & (gate_counts >= min_points) & (conf >= min_ratio)


def _median_translation(p, q, valid):
    T = torch.eye(3, dtype=torch.float32, device=p.device).repeat(p.shape[0], 1, 1)
    med = ransac.median_shift(p, q, valid)
    T[:, 0, 2] = med[:, 0]
    T[:, 1, 2] = med[:, 1]
    return T


def _flow_fits(frames, width, height, store, seed: int = 0) -> Fits:
    """Dense flow on the fit grid (the homography pre-warp), then the
    perspective RANSAC (key salt 0), the similarity RANSAC (salt 1) and the
    median translation of every pair."""
    work = working_size(width, height)
    dec = flow_decimation(width, height, work)
    tw, th = work if work is not None else (width, height)
    g = grays(frames, tw // dec, th // dec)
    samples = dis.dis_flow_fit(g, SAMPLE_STEP // dec, 0 if dec > 1 else dis.FINEST_SCALE)
    if dec > 1:
        samples = samples * float(dec)
    samples = _held(samples, store)
    b = samples.shape[0]
    ys = torch.arange(0, th, SAMPLE_STEP, dtype=torch.float32, device=frames.device)
    xs = torch.arange(0, tw, SAMPLE_STEP, dtype=torch.float32, device=frames.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    p = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=1)[None].expand(samples.shape)
    q = p + samples
    valid = torch.isfinite(q).all(dim=2)
    counts = valid.sum(1)
    H, h_in, h_valid = ransac.ransac(ransac.pair_keys(seed, b, frames.device), p, q, valid, "perspective",
                                     ransac.PERSP_THRESH)
    S, s_in, s_valid = ransac.ransac(ransac.pair_keys(seed + 1, b, frames.device), p, q, valid, "similarity",
                                     ransac.SIM_THRESH)
    return Fits(H, _accepted(H, h_in, h_valid, counts, 4, PERSP_MIN_RATIO),
                S, _accepted(S, s_in, s_valid, counts, 3, SIM_MIN_RATIO),
                _median_translation(p, q, valid), counts < MIN_VALID, work)


MODES = ("perspective", "similarity", "translation")


def _sticky(fits: Fits, requested: str) -> Tuple[torch.Tensor, List[str]]:
    """Per pair the first accepted mode from the active one down
    (perspective, similarity, translation); a degenerate pair is the
    identity in translation mode; a pair that falls back re-points the
    active mode for every later pair.  Returns the chosen matrices (on the
    fits' device) and modes."""
    ok = list(zip(fits.H_ok.cpu().tolist(), fits.S_ok.cpu().tolist(), [True] * fits.H_ok.shape[0]))
    deg = fits.degenerate.cpu().tolist()
    modes, active = [], MODES.index(requested)
    for i in range(len(deg)):
        active = 2 if deg[i] else next(m for m in range(active, 3) if ok[i][m])
        modes.append(MODES[active])
    dev = fits.S.device
    pick = torch.tensor([MODES.index(m) for m in modes], device=dev)[:, None, None]
    chosen = torch.where(pick == 0, fits.H, torch.where(pick == 1, fits.S, fits.T)).to(torch.float32)
    return torch.where(fits.degenerate[:, None, None], torch.eye(3, dtype=torch.float32, device=dev), chosen), modes


# ---------------------------------------------------------------------------
# Trajectory and framing (float32 on the device)
# ---------------------------------------------------------------------------

def _mm(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Batched 3x3 products, k summed in order 0, 1, 2."""
    return (x[..., :, 0, None] * y[..., None, 0, :] + x[..., :, 1, None] * y[..., None, 1, :]
            + x[..., :, 2, None] * y[..., None, 2, :])


def _params(m: torch.Tensor) -> torch.Tensor:
    """(N, 3, 3) -> (N, 8) [a-1, b, tx, c, d-1, ty, g, h]."""
    return torch.stack([m[:, 0, 0] - 1.0, m[:, 0, 1], m[:, 0, 2], m[:, 1, 0], m[:, 1, 1] - 1.0, m[:, 1, 2],
                        m[:, 2, 0], m[:, 2, 1]], dim=-1)


def _matrices(p: torch.Tensor) -> torch.Tensor:
    """(N, 8) -> (N, 3, 3) perspective matrices, [2, 2] = 1."""
    one = torch.ones(p.shape[0], dtype=p.dtype, device=p.device)
    return torch.stack([p[:, 0] + 1.0, p[:, 1], p[:, 2], p[:, 3], p[:, 4] + 1.0, p[:, 5], p[:, 6], p[:, 7], one],
                       dim=-1).reshape(-1, 3, 3)


def _inverse_coeffs(m: torch.Tensor) -> torch.Tensor:
    """(N, 3, 3) -> (N, 8) [a..h] of the inverse normalized by its [2, 2]:
    adjugate over determinant, one Newton step X (2I - M X), the identity
    where |det| <= 1e-20."""
    a, b, c = m[:, 0, 0], m[:, 0, 1], m[:, 0, 2]
    d, e, f = m[:, 1, 0], m[:, 1, 1], m[:, 1, 2]
    g, h, i = m[:, 2, 0], m[:, 2, 1], m[:, 2, 2]
    adj = torch.stack([e * i - f * h, c * h - b * i, b * f - c * e, f * g - d * i, a * i - c * g, c * d - a * f,
                       d * h - e * g, b * g - a * h, a * e - b * d], dim=-1).reshape(-1, 3, 3)
    det = a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)
    ok = torch.abs(det) > 1e-20
    inv = adj / torch.where(ok, det, 1.0)[:, None, None]
    eye = torch.eye(3, dtype=torch.float32, device=m.device)
    inv = torch.where(ok[:, None, None], _mm(inv, 2.0 * eye - _mm(m, inv)), eye)
    w0 = inv[:, 2, 2]
    inv = inv / torch.where((w0 != 0.0) & torch.isfinite(w0), w0, 1.0)[:, None, None]
    return inv.reshape(-1, 9)[:, :8].contiguous()


def _trajectory(motion_work: torch.Tensor, settings, width: int, height: int, work, store=None,
                dtype=torch.float32):
    """The camera path (cumulative per-transition parameters), camera lock's
    zero target, and the crop_and_pad warp: the correction re-centred on
    the intersection of every frame's corrected corners.  (The node raises
    smooth to 0.85 under the lock and sizes its moving average at the
    clip's fps; a locked target reads neither.)  Worked out in ``dtype``;
    the warp is float32."""
    dev = motion_work.device
    sx, sy = (work[0] / float(width), work[1] / float(height)) if work is not None else (1.0, 1.0)
    s_vec = torch.tensor([sx, sy, 1.0], dtype=torch.float32, device=dev)
    motion = (motion_work * s_vec[None, None, :]) / s_vec[None, :, None]
    P = _params(motion.to(dtype))
    zero_row = torch.zeros((1, P.shape[1]), dtype=dtype, device=dev)
    path = _held(torch.cat([zero_row, torch.cumsum(P, dim=0)], dim=0), store)
    target = torch.zeros_like(path)
    apply = _matrices(target - path)
    corners = torch.tensor([[0.0, 0.0, 1.0], [width, 0.0, 1.0], [0.0, height, 1.0], [width, height, 1.0]],
                           dtype=dtype, device=dev)
    wc = (apply[:, None, :, 0] * corners[None, :, None, 0] + apply[:, None, :, 1] * corners[None, :, None, 1]
          + apply[:, None, :, 2] * corners[None, :, None, 2])
    xy = wc[..., :2] / wc[..., 2:3]
    mins, maxs = xy.amin(dim=1), xy.amax(dim=1)
    x0, y0 = mins[:, 0].amax(), mins[:, 1].amax()
    x1, y1 = maxs[:, 0].amin(), maxs[:, 1].amin()
    off_x = 0.5 * width - 0.5 * (x0 + x1)
    off_y = 0.5 * height - 0.5 * (y0 + y1)
    one, zero = torch.ones_like(off_x), torch.zeros_like(off_x)
    shift = torch.stack([one, zero, off_x, zero, one, off_y, zero, zero, one]).reshape(3, 3)
    final = _held(_mm(shift, apply).to(torch.float32), store)
    return motion, path, target, final, mins, maxs, (off_x, off_y)


# ---------------------------------------------------------------------------
# Warp and padding masks
# ---------------------------------------------------------------------------

def _source(coeffs: torch.Tensor, out_h: int, out_w: int):
    """int32 floor of the source coordinates and their fractions, in
    displacement form: D = 1 + gx + hy, dx = ((a-1)x + by + c - gx^2 - hxy) / D."""
    dev = coeffs.device
    xx = torch.arange(out_w, device=dev, dtype=torch.float32)[None, None, :]
    yy = torch.arange(out_h, device=dev, dtype=torch.float32)[None, :, None]
    a, b, c, d, e, f, g, h = (coeffs[:, i, None, None] for i in range(8))
    denom = 1.0 + g * xx + h * yy
    qx = (a - 1.0) * xx + b * yy + c - (g * xx) * xx - (h * xx) * yy
    qy = d * xx + (e - 1.0) * yy + f - (g * yy) * xx - (h * yy) * yy
    safe = denom != 0.0
    inv_d = torch.where(safe, 1.0 / torch.where(safe, denom, 1.0), 0.0)
    dx = torch.where(safe, (qx * inv_d).clamp(-_DISP_LIM, _DISP_LIM), -_DISP_LIM)
    dy = torch.where(safe, (qy * inv_d).clamp(-_DISP_LIM, _DISP_LIM), -_DISP_LIM)
    dxf, dyf = torch.floor(dx), torch.floor(dy)
    xi = torch.arange(out_w, device=dev, dtype=torch.int32)[None, None, :]
    yi = torch.arange(out_h, device=dev, dtype=torch.int32)[None, :, None]
    return xi + dxf.to(torch.int32), yi + dyf.to(torch.int32), dx - dxf, dy - dyf


def warp_bilinear(frames: torch.Tensor, coeffs: torch.Tensor, border: torch.Tensor) -> torch.Tensor:
    """Bilinear warp, taps outside the source read ``border``."""
    n, h, w, c = frames.shape
    x0, y0, fx, fy = _source(coeffs, h, w)
    flat = frames.reshape(n, h * w, c)
    acc = torch.zeros((n, h, w, c), dtype=torch.float32, device=frames.device)
    for dy_t, dx_t, wgt in ((0, 0, (1.0 - fy) * (1.0 - fx)), (0, 1, (1.0 - fy) * fx),
                            (1, 0, fy * (1.0 - fx)), (1, 1, fy * fx)):
        ys, xs = y0 + dy_t, x0 + dx_t
        inside = ((xs >= 0) & (xs < w) & (ys >= 0) & (ys < h))[..., None]
        lin = (ys.clamp(0, h - 1).long() * w + xs.clamp(0, w - 1).long()).reshape(n, -1, 1)
        tap = torch.gather(flat, 1, lin.expand(-1, -1, c)).reshape(n, h, w, c)
        acc = acc + torch.where(inside, tap, border.reshape(1, 1, 1, c)) * wgt[..., None]
    return acc


def padding_mask(coeffs: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """1 where the round-half-even nearest source lies outside the frame."""
    x0, y0, fx, fy = _source(coeffs, h, w)
    xn = x0 + torch.where(fx > 0.5, 1, torch.where(fx < 0.5, 0, x0 & 1))
    yn = y0 + torch.where(fy > 0.5, 1, torch.where(fy < 0.5, 0, y0 & 1))
    return 1.0 - ((xn >= 0) & (xn < w) & (yn >= 0) & (yn < h)).to(torch.float32)


# ---------------------------------------------------------------------------
# The stabilizer
# ---------------------------------------------------------------------------

def stabilize(frames: torch.Tensor, estimator: str, settings: Dict[str, object], store=None,
              tf32: bool = False, variant=None) -> Result:
    """The reference of one node call: ``frames`` (N, H, W, 3) float32 in 0..1.
    Float32 products and convolutions run in full float32 unless ``tf32``."""
    if variant not in (None,) + VARIANTS:
        raise ValueError(f"no variant {variant!r}; variants: {VARIANTS}")
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    dis.REVERSED_SUMS = ransac.REVERSED_SUMS = variant == "reordered"
    ransac.LINALG64 = variant == "linalg64"
    try:
        return _stabilize(frames, estimator, settings, store,
                          torch.float64 if variant == "trajectory64" else torch.float32)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
        dis.REVERSED_SUMS = ransac.REVERSED_SUMS = ransac.LINALG64 = False


def _stabilize(frames: torch.Tensor, estimator: str, settings: Dict[str, object], store, dtype) -> Result:
    if estimator != "flow" or settings["framing_mode"] != "crop_and_pad" \
            or settings["transform_mode"] != "perspective" or not settings["camera_lock"]:
        raise NotImplementedError("this reference runs Flow, crop_and_pad, perspective with camera lock")
    n, height, width, _ = frames.shape
    frames = _held(frames.to(torch.float32), store)
    fits = _flow_fits(frames, width, height, store)
    chosen, modes = _sticky(fits, settings["transform_mode"])
    motion, path, target, final, mins, maxs, (off_x, off_y) = _trajectory(_held(chosen, store), settings, width,
                                                                          height, fits.work, store, dtype)
    coeffs = _inverse_coeffs(final)
    color = [int(c) for c in settings["padding_rgb"]]
    border = torch.as_tensor(np.asarray(color, np.float32) / 255.0, device=frames.device)
    out = torch.empty_like(frames)
    masks = torch.empty((n, height, width), dtype=torch.float32, device=frames.device)
    for s in range(0, n, _WARP_CHUNK):
        out[s:s + _WARP_CHUNK] = warp_bilinear(frames[s:s + _WARP_CHUNK], coeffs[s:s + _WARP_CHUNK], border)
        masks[s:s + _WARP_CHUNK] = padding_mask(coeffs[s:s + _WARP_CHUNK], height, width)
    area = torch.full((), float(height * width), dtype=torch.float32, device=frames.device)
    ratios = ((masks.reshape(n, -1) != 0).sum(1).to(torch.float32) / area).cpu().numpy()

    mins, maxs = mins.cpu().numpy().astype(np.float64), maxs.cpu().numpy().astype(np.float64)
    x0, y0 = float(np.max(mins[:, 0])), float(np.max(mins[:, 1]))
    x1, y1 = float(np.min(maxs[:, 0])), float(np.min(maxs[:, 1]))
    iw, ih = max(1.0, x1 - x0), max(1.0, y1 - y0)
    cw, ch = max(0.0, x1 - x0), max(0.0, y1 - y0)
    framing = {
        "mode": "crop_and_pad",
        "input_size": [width, height],
        "padding_color_rgb": color,
        "min_content_ratio": 1e-6 if cw <= 0.0 or ch <= 0.0 else max(1e-6, min(cw / width, ch / height)),
        "safe_region_origin": [x0, y0],
        "safe_region_size": [iw, ih],
        "actual_content_ratio": min(iw / width, ih / height),
        "center_offset": [float(off_x), float(off_y)],
        "padding_detected": bool((ratios > 0).any()),
    }
    return Result(modes, motion.cpu().numpy(), path.cpu().numpy().astype(np.float64),
                  target.cpu().numpy().astype(np.float64), final.cpu().numpy(), _held(out, store), masks,
                  ratios, framing)


def as_node_outputs(res: Result, estimator: str, settings: Dict[str, object]):
    """(frames, masks, meta) laid out as the node returns them, for a
    reference put in the program's place (the control)."""
    n, h, w = res.masks.shape
    final = [m.tolist() for m in res.final]
    meta = {
        "frames": n,
        "transform_mode_requested": settings["transform_mode"],
        "transform_mode_applied": res.modes[-1],
        "framing": dict(res.framing),
        "stabilization_warp": {"source_size": [w, h], "output_size": [w, h], "framing_mode": res.framing["mode"],
                               "matrix_convention": "source_to_stabilized",
                               "per_frame": [{"index": i, "applied_matrix": m} for i, m in enumerate(final)]},
        "motion_meta": {"version": 2, "source": f"estimated_{estimator}", "frame_count": n,
                        "fps": float(settings["frame_rate"]), "input_size": [w, h], "output_size": [w, h],
                        "matrix_convention": "input_to_output",
                        "per_frame": [{"index": i, "matrix": m} for i, m in enumerate(final)]},
        "estimated_motion": {"per_transition": [{"index": i, "mode": mode, "matrix": res.motion[i].tolist()}
                                                for i, mode in enumerate(res.modes)],
                             "path": res.path.tolist(), "target_path": res.target_path.tolist()},
        "padding_fraction_mean": float(res.ratios.mean()),
        "padding_fraction_max": float(res.ratios.max()),
    }
    if estimator == "flow":
        meta["flow_backend"] = "DIS"
    return res.frames, res.masks, meta


def settings_of(config: Dict[str, object]) -> Dict[str, object]:
    """The node settings of a configuration, with the padding colour as RGB."""
    node = dict(config["node"])
    hexcode = str(node["padding_color"]).lstrip("#")
    node["padding_rgb"] = tuple(int(hexcode[i:i + 2], 16) for i in (0, 2, 4))
    return node


def to_matrices(p: np.ndarray) -> np.ndarray:
    """(..., D) path parameters -> (..., 3, 3) float64 matrices, by the width D:
    2 [tx, ty] translation, 4 [tx, ty, theta, log scale] similarity,
    8 [a-1, b, tx, c, d-1, ty, g, h] perspective."""
    p = np.asarray(p, np.float64)
    out = np.zeros(p.shape[:-1] + (3, 3))
    out[..., 2, 2] = 1.0
    if p.shape[-1] == 2:
        out[..., 0, 0] = out[..., 1, 1] = 1.0
        out[..., 0, 2], out[..., 1, 2] = p[..., 0], p[..., 1]
    elif p.shape[-1] == 4:
        s, ct, st = np.exp(p[..., 3]), np.cos(p[..., 2]), np.sin(p[..., 2])
        out[..., 0, 0], out[..., 0, 1], out[..., 0, 2] = s * ct, -s * st, p[..., 0]
        out[..., 1, 0], out[..., 1, 1], out[..., 1, 2] = s * st, s * ct, p[..., 1]
    elif p.shape[-1] == 8:
        out[..., :2, :] = p[..., :6].reshape(p.shape[:-1] + (2, 3))
        out[..., 0, 0] += 1.0
        out[..., 1, 1] += 1.0
        out[..., 2, 0], out[..., 2, 1] = p[..., 6], p[..., 7]
    else:
        raise ValueError(f"no transform has {p.shape[-1]} path parameters")
    return out


def _corners(mats, width: int, height: int) -> np.ndarray:
    """(N, 4, 2): where each matrix puts the frame's four corners."""
    corners = np.array([[0.0, 0.0, 1.0], [width, 0.0, 1.0], [0.0, height, 1.0], [width, height, 1.0]])
    warped = np.einsum("nij,kj->nki", np.asarray(mats, np.float64), corners)
    return warped[..., :2] / warped[..., 2:3]


def corner_gap_px(a, b, width: int, height: int) -> float:
    """The widest distance, in px, between where two stacks of matrices put
    the frame's corners; infinite where either is not finite."""
    gap = np.sqrt(((_corners(a, width, height) - _corners(b, width, height)) ** 2).sum(-1))
    return float(gap.max()) if gap.size and np.isfinite(gap).all() else math.inf
