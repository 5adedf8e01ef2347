#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. setup report: torch / CUDA versions, the card, nvidia-smi's name and
     power limit, whether triton imports; TF32 off
  2. build the CUDA kernels from csrc/ with nvcc (timed)
  3. K1 (warp) against its plain PyTorch version at 1080p
  4. K2 (cost volume) against its plain version at the slice's level shapes
  5. the slice: stabilize_flow on a synthetic shaken 1080p x 80-frame clip,
     with launch counts, output checks, a CPU-path reference on a small
     clip, and the warm frames/s
  6. the Flow node on a CPU tensor of 16 frames at 1080p
  7. K4 (GFTT scores) against its plain version on the Classic slice's
     Sobel products, (79, 540, 960)
  8. K6 (window extraction) against its plain version at (79, 400, 49)
     and (79, 400, 36) on the level-0 stack with the real GFTT corners
  9. K5 (LK Gauss-Newton) against its plain version: one level-0 solve
     on the real clip's windows, with the iteration histogram
 10. the Classic slice: stabilize_classic on the same 1080p x 80 clip,
     with launch counts, output checks, the warm frames/s, a stage split,
     and BASELINE config 1 (854x480, 64 frames) once
 11. Classic, CUDA path against CPU path on a small clip; the Classic
     node on a CPU tensor of 16 frames at 1080p
 12. a JSON line per kernel, the card line, then {"ok": true, ...} last

Exits 2 without printing a result when torch.cuda.is_available() is false.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CLIP_FRAMES = 80
HEIGHT, WIDTH = 1080, 1920
K1_TOL = 1e-6          # expected bitwise: -fmad=false, same op order
K2_CMIN_RTOL = 1e-6
K2_EQUAL_FRAC = 0.9999  # a one-ulp cost difference may flip a tie
SMALL_MAT_TOL = 1e-3    # CUDA path vs CPU path on the small clip
SMALL_FRAME_P99 = 1e-3
K4_RTOL = 1e-6          # expected bitwise: the same doubling-tree order
K5_STATUS_EQUAL = 0.999  # expected bitwise: the same op and reduction order
K5_TRACK_TOL = 1e-3     # px, live tracks
BASELINE1 = (64, 480, 854)  # BASELINE.json config 1: Classic 480p / 64 frames


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn() on the current stream (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def shake_matrices(n: int, seed: int, rot: float, trans: float):
    """Per-frame source->frame view matrices of a shaken camera."""
    rng = np.random.default_rng(seed)
    mats = [np.eye(3)]
    for i in range(1, n):
        th = rot * np.sin(i / 3.0) + rng.uniform(-rot / 2, rot / 2)
        t = rng.uniform(-trans, trans, 2) + [5 * np.sin(i / 2.5), 3.5 * np.cos(i / 3.5)]
        d = np.array([[np.cos(th), -np.sin(th), t[0]], [np.sin(th), np.cos(th), t[1]], [0, 0, 1.0]])
        mats.append(d @ mats[-1])
    return mats


def synth_clip(n: int, h: int, w: int, seed: int, device):
    """Shaken clip of multi-octave value noise, warped on the device."""
    import torch
    import torch.nn.functional as F

    from comfyui_video_stabilizer_tpu_torch.ops import warp as W

    gen = torch.Generator().manual_seed(seed)
    margin = 64
    hp, wp = h + 2 * margin, w + 2 * margin
    base = torch.zeros((hp, wp))
    for octave, amp in ((4, 0.35), (16, 0.3), (64, 0.2), (256, 0.15)):
        coarse = torch.rand((hp // octave + 2, wp // octave + 2), generator=gen)
        base += amp * F.interpolate(coarse[None, None], size=(hp, wp), mode="bilinear",
                                    align_corners=False)[0, 0]
    base = (base - base.min()) / (base.max() - base.min())
    rgb = torch.stack([base, base * 0.7 + 0.1, 1.0 - base], dim=-1).to(device)
    crop = np.eye(3)
    crop[0, 2] = crop[1, 2] = -margin
    view = np.stack([crop @ np.linalg.inv(m) for m in shake_matrices(n, seed, 0.003, 3.0)])
    src = rgb[None].expand(n, *rgb.shape).contiguous()
    return W.warp_clip(src, view, (w, h), "bilinear", (0.5, 0.5, 0.5))


def interior_motion(frames, margin: int) -> float:
    """Mean |frame[i+1] - frame[i]| over the interior, frame by frame."""
    total = 0.0
    for i in range(frames.shape[0] - 1):
        a = frames[i, margin:-margin, margin:-margin]
        b = frames[i + 1, margin:-margin, margin:-margin]
        total += float((b - a).abs().mean())
    return total / (frames.shape[0] - 1)


def phase_setup():
    import torch

    log(f"[setup] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}")
    try:
        import triton  # noqa: F401  (recorded only; the kernels are CUDA C++)

        triton_state = f"imports ({triton.__version__})"
    except ImportError as exc:
        triton_state = f"does not import ({exc})"
    log(f"[setup] triton {triton_state}")
    smi = nvidia_smi_line()
    log(f"[setup] nvidia-smi: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build():
    from comfyui_video_stabilizer_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    path = cuda_build.build()
    cuda_build.library()
    secs = time.perf_counter() - t0
    log(f"[build] {path.name} in {secs:.2f} s")
    report = path.with_suffix(".log")
    if report.exists():
        for line in ptxas_summary(report.read_text()):
            log(f"[build] {line}")
    return secs


def ptxas_summary(text: str):
    """One line per compiled kernel from nvcc's -Xptxas=-v report."""
    lines, name, spill = [], None, 0
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            t = re.search(r"\d([a-z][a-z_]*_kernel)(?:I((?:Li\d+E)+)E)?", m.group(1))
            name = m.group(1) if not t else t.group(1) if not t.group(2) else \
                f"{t.group(1)}<{','.join(re.findall(r'Li(\d+)E', t.group(2)))}>"
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and name:
            lines.append(f"{name}: {m.group(1)} registers, {spill} spill bytes, {m.group(2) or 0} bytes static smem")
            name = None
    return lines


def phase_k1(device):
    import torch

    from comfyui_video_stabilizer_tpu_torch.ops import warp as W

    gen = torch.Generator().manual_seed(1)
    n = 8
    frames = torch.rand((n, HEIGHT, WIDTH, 3), generator=gen).to(device)
    border = torch.tensor([0.2, 0.4, 0.6], device=device)
    rng = np.random.default_rng(2)

    def sim(i, persp=0.0, shift=(0.0, 0.0)):
        th = rng.uniform(-0.01, 0.01)
        s = np.exp(rng.uniform(-0.01, 0.01))
        tx, ty = rng.uniform(-8, 8, 2) + np.asarray(shift)
        return np.array([[s * np.cos(th), -s * np.sin(th), tx],
                         [s * np.sin(th), s * np.cos(th), ty], [persp, -persp / 2, 1.0]])

    cases = {
        "similarity": np.stack([sim(i) for i in range(n)]),
        "perspective": np.stack([sim(i, persp=2e-5) for i in range(n)]),
        "past_edge": np.stack([sim(i, shift=(1500.0 * (-1) ** i, 700.0)) for i in range(n)]),
    }
    max_err = 0.0
    for name, mats in cases.items():
        coeffs = torch.as_tensor(W.prepare_inverse_coeffs(mats).astype(np.float32), device=device)
        for interp in ("bilinear", "bicubic", "nearest"):
            out = W.warp_frames(frames, coeffs, border, HEIGHT, WIDTH, interp)
            ref = W.warp_plain(frames, coeffs, border, HEIGHT, WIDTH, interp)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            log(f"[K1] {name:11s} {interp:8s} max|kernel - plain| = {err:.3e}")
            check(bool(torch.isfinite(out).all()), f"K1 {name} {interp}: non-finite output")
            check(err <= K1_TOL, f"K1 {name} {interp}: {err} > {K1_TOL}")
            max_err = max(max_err, err)
    del frames

    # timing at the slice's shape: 80 frames of 1080p RGB, bilinear, similarity
    big = torch.rand((CLIP_FRAMES, HEIGHT, WIDTH, 3), generator=gen).to(device)
    mats = np.stack([sim(i) for i in range(CLIP_FRAMES)])
    coeffs = torch.as_tensor(W.prepare_inverse_coeffs(mats).astype(np.float32), device=device)
    out = W.warp_frames(big, coeffs, border, HEIGHT, WIDTH, "bilinear")
    ref = W.warp_plain(big, coeffs, border, HEIGHT, WIDTH, "bilinear")
    err = float((out - ref).abs().max())
    check(err <= K1_TOL, f"K1 at the slice shape: {err} > {K1_TOL}")
    max_err = max(max_err, err)
    del out, ref
    # plain, kernel, kernel, plain
    t_plain = [cuda_ms(lambda: W.warp_plain(big, coeffs, border, HEIGHT, WIDTH, "bilinear"), 3)]
    t_kern = [cuda_ms(lambda: W.warp_frames(big, coeffs, border, HEIGHT, WIDTH, "bilinear"), 10)
              for _ in range(2)]
    t_plain.append(cuda_ms(lambda: W.warp_plain(big, coeffs, border, HEIGHT, WIDTH, "bilinear"), 3))
    ms, plain_ms = min(t_kern), min(t_plain)
    log(f"[K1] {tuple(big.shape)} bilinear: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms "
        f"(runs {t_kern}, {t_plain})")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}


def phase_k2(device, frames):
    import torch

    from comfyui_video_stabilizer_tpu_torch.models.flow import flow_estimator
    from comfyui_video_stabilizer_tpu_torch.models.stabilize import estimation_plan
    from comfyui_video_stabilizer_tpu_torch.ops import cv_cuda as CV
    from comfyui_video_stabilizer_tpu_torch.ops import flow_dis as FD
    from comfyui_video_stabilizer_tpu_torch.ops import resize as R

    working, dec = estimation_plan(WIDTH, HEIGHT, flow_estimator)
    grays = R.gray_for_estimation(frames, working, decimation=dec)
    coarsest = FD.num_levels(*grays.shape[1:])
    pyr = FD.build_pyramid(grays, coarsest)
    result = {"max_abs_err": 0.0}
    for level in (pyr[0], pyr[coarsest]):
        I, J = level[:-1].contiguous(), level[1:].contiguous()
        shape = tuple(I.shape)
        out = CV.cost_volume_subpixel(I, J, 2, 8)
        ref = CV.cost_volume_plain(I, J, 2, 8)
        torch.cuda.synchronize()
        fx, fy, cmin = out
        rfx, rfy, rcmin = ref
        rel = float(((cmin - rcmin).abs() / rcmin.abs().clamp(min=1e-12)).max())
        neq = int(((fx != rfx) | (fy != rfy)).sum())
        frac_eq = 1.0 - neq / fx.numel()
        err = max(float((fx - rfx).abs().max()), float((fy - rfy).abs().max()),
                  float((cmin - rcmin).abs().max()))
        log(f"[K2] {shape}: cmin max rel {rel:.3e}, unequal fx/fy pixels {neq} of {fx.numel()}, "
            f"max|kernel - plain| {err:.3e}")
        check(rel <= K2_CMIN_RTOL, f"K2 {shape}: cmin rel {rel} > {K2_CMIN_RTOL}")
        check(frac_eq >= K2_EQUAL_FRAC, f"K2 {shape}: fx/fy equal on {frac_eq} < {K2_EQUAL_FRAC}")
        result["max_abs_err"] = max(result["max_abs_err"], err)
        t_plain = [cuda_ms(lambda: CV.cost_volume_plain(I, J, 2, 8), 5)]
        t_kern = [cuda_ms(lambda: CV.cost_volume_subpixel(I, J, 2, 8), 20) for _ in range(2)]
        t_plain.append(cuda_ms(lambda: CV.cost_volume_plain(I, J, 2, 8), 5))
        log(f"[K2] {shape} r=2: kernel {min(t_kern):.4f} ms, plain {min(t_plain):.4f} ms "
            f"(runs {t_kern}, {t_plain})")
        if level is pyr[0]:
            result["ms"], result["plain_ms"] = min(t_kern), min(t_plain)
    return result


def make_context(frames):
    from comfyui_video_stabilizer_tpu_torch.utils.video_io import FrameAdapter, VideoContext

    return VideoContext(
        frames=frames,
        adapter=FrameAdapter(frames.dtype, False, "0_1", "torch", False),
        width=int(frames.shape[2]), height=int(frames.shape[1]), channels=3,
        fps=30.0, template_kind="sequence", template_meta={},
    )


def run_slice(ctx, device):
    from comfyui_video_stabilizer_tpu_torch.models.flow import stabilize_flow

    return stabilize_flow(ctx, "crop_and_pad", "similarity", False, 0.8, 0.6, 0.6,
                          (127, 127, 127), 30.0, device=device)


def run_classic(ctx, device):
    from comfyui_video_stabilizer_tpu_torch.models.classic import stabilize_classic

    return stabilize_classic(ctx, "crop_and_pad", "similarity", False, 0.8, 0.6, 0.6,
                             (127, 127, 127), 30.0, device=device)


def phase_slice(device, frames):
    import torch

    from comfyui_video_stabilizer_tpu_torch.ops import cuda_build

    ctx = make_context(frames)
    torch.cuda.synchronize()
    cuda_build.reset_launches()
    res = run_slice(ctx, device)
    torch.cuda.synchronize()
    launches = dict(cuda_build.LAUNCHES)
    log(f"[slice] launches in one stabilize_flow call: {launches}")
    check(launches["warp"] >= 1, "K1 was not launched by the slice")
    check(launches["cost_volume"] >= 4, "K2 was launched fewer than 4 times by the slice")
    meta = res.meta
    check(meta["transform_mode_applied"] == "similarity",
          f"transform_mode_applied {meta['transform_mode_applied']!r}")
    check(meta["flow_backend"] == "DIS", f"flow_backend {meta['flow_backend']!r}")
    check(tuple(res.frames.shape) == (CLIP_FRAMES, HEIGHT, WIDTH, 3), f"frames {tuple(res.frames.shape)}")
    check(tuple(res.masks.shape) == (CLIP_FRAMES, HEIGHT, WIDTH), f"masks {tuple(res.masks.shape)}")
    check(res.frames.device.type == "cuda" and res.masks.device.type == "cuda", "outputs left the card")
    check(bool(torch.isfinite(res.frames).all()) and bool(torch.isfinite(res.masks).all()),
          "non-finite outputs")
    orig = interior_motion(frames, 100)
    stab = interior_motion(res.frames, 100)
    log(f"[slice] mean interior inter-frame difference: input {orig:.5f}, stabilized {stab:.5f}")
    check(stab < 0.8 * orig, "stabilization did not lower the inter-frame difference")
    del res

    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_slice(ctx, device)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        del out
    fps = [CLIP_FRAMES / t for t in times]
    log(f"[slice] warm stabilize_flow 1080p x {CLIP_FRAMES}: "
        f"{', '.join(f'{f:.1f}' for f in fps)} f/s; best {max(fps):.1f}, median {float(np.median(fps)):.1f}; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches, fps


def phase_small_reference(device, run=run_slice, name="reference"):
    """The CUDA path against the CPU path (the plain versions, which the
    CPU tests hold to the JAX reference) on a small shaken clip."""
    import torch

    frames = synth_clip(8, 144, 192, seed=9, device="cpu")
    cpu = run(make_context(frames), "cpu")
    gpu = run(make_context(frames.to(device)), device)
    pc = [t["mode"] for t in cpu.meta["estimated_motion"]["per_transition"]]
    pg = [t["mode"] for t in gpu.meta["estimated_motion"]["per_transition"]]
    check(pc == pg, f"per-pair modes differ: {pc} vs {pg}")
    mc = np.array([t["matrix"] for t in cpu.meta["estimated_motion"]["per_transition"]])
    mg = np.array([t["matrix"] for t in gpu.meta["estimated_motion"]["per_transition"]])
    mat_err = float(np.abs(mc - mg).max())
    d = (cpu.frames - gpu.frames.cpu()).abs().flatten()
    p99 = float(torch.quantile(d[:: max(1, d.numel() // 1_000_000)], 0.99))
    log(f"[{name}] 8x144x192 clip, CUDA vs CPU path: modes equal, matrices max|d| {mat_err:.3e}, "
        f"frames p99 {p99:.3e}, max {float(d.max()):.3e}")
    check(mat_err <= SMALL_MAT_TOL, f"matrices differ by {mat_err}")
    check(p99 <= SMALL_FRAME_P99, f"frames p99 {p99}")


def phase_node(frames_cpu, node_name="VideoStabilizerFlow"):
    import torch

    from comfyui_video_stabilizer_tpu_torch import nodes

    node = getattr(nodes, node_name)
    t0 = time.perf_counter()
    out = node.execute(frames_cpu, 30.0, "crop_and_pad", "similarity", False,
                       0.8, 0.6, 0.6, "#7F7F7F")
    secs = time.perf_counter() - t0
    video, mask, meta = out[0], out[1], out[2]
    n = frames_cpu.shape[0]
    check(isinstance(video, torch.Tensor) and video.device.type == "cpu", "node frames not a CPU tensor")
    check(video.dtype == torch.float32 and video.is_contiguous(), "node frames not contiguous float32")
    check(tuple(video.shape) == (n, HEIGHT, WIDTH, 3), f"node frames {tuple(video.shape)}")
    check(tuple(mask.shape) == (n, HEIGHT, WIDTH) and mask.device.type == "cpu", f"node masks {tuple(mask.shape)}")
    check(meta["frames"] == n and "motion_meta" in meta, "node meta incomplete")
    check(bool(torch.isfinite(video).all()), "node frames not finite")
    log(f"[node] {node_name}.execute on a CPU tensor ({n}, {HEIGHT}, {WIDTH}, 3): "
        f"{secs:.3f} s, mode {meta['transform_mode_applied']}")


def classic_grays(frames):
    """The Classic slice's working grays: (80, 540, 960), no decimation."""
    from comfyui_video_stabilizer_tpu_torch.models.classic import classic_estimator
    from comfyui_video_stabilizer_tpu_torch.models.stabilize import estimation_plan
    from comfyui_video_stabilizer_tpu_torch.ops import resize as R

    working, dec = estimation_plan(WIDTH, HEIGHT, classic_estimator)
    check(dec == 1, f"Classic decimation {dec}")
    return R.gray_for_estimation(frames, working, decimation=dec)


def timed_pair(kernel, plain, kernel_reps: int, plain_reps: int):
    """(kernel ms, plain ms) in the order plain, kernel, kernel, plain; best of each."""
    t_plain = [cuda_ms(plain, plain_reps)]
    t_kern = [cuda_ms(kernel, kernel_reps) for _ in range(2)]
    t_plain.append(cuda_ms(plain, plain_reps))
    return min(t_kern), min(t_plain), t_kern, t_plain


def phase_k4(grays):
    import torch

    from comfyui_video_stabilizer_tpu_torch.ops import gftt_cuda as GF
    from comfyui_video_stabilizer_tpu_torch.ops import lk as LK

    g = grays[:-1]
    dx, dy = LK._conv2(g, LK._SOBEL_X), LK._conv2(g, LK._SOBEL_Y)
    prods = [(dx * dx).contiguous(), (dx * dy).contiguous(), (dy * dy).contiguous()]
    del dx, dy
    out = GF.gftt_scores(*prods)
    ref = GF.gftt_plain(*prods)
    torch.cuda.synchronize()
    keep, keep_ref = torch.isfinite(out), torch.isfinite(ref)
    check(bool(torch.equal(keep, keep_ref)), "K4: NMS masks differ")
    diff = (out[keep] - ref[keep]).abs()
    rel = float((diff / ref[keep].abs().clamp(min=1e-30)).max())
    unequal = int((out[keep] != ref[keep]).sum())
    log(f"[K4] {tuple(g.shape)}: NMS masks equal ({int(keep.sum())} kept), unequal scores {unequal}, "
        f"max rel diff {rel:.3e}")
    check(rel <= K4_RTOL, f"K4: max rel diff {rel} > {K4_RTOL}")
    ms, plain_ms, tk, tp = timed_pair(lambda: GF.gftt_scores(*prods), lambda: GF.gftt_plain(*prods), 20, 3)
    log(f"[K4] {tuple(g.shape)}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (runs {tk}, {tp})")
    return {"max_abs_err": float(diff.max()) if diff.numel() else 0.0, "ms": ms, "plain_ms": plain_ms}


def phase_k6(grays):
    import torch

    from comfyui_video_stabilizer_tpu_torch.ops import extract_cuda as EX
    from comfyui_video_stabilizer_tpu_torch.ops import lk as LK
    from comfyui_video_stabilizer_tpu_torch.ops.pad import reflect_pad

    I, J = grays[:-1], grays[1:].contiguous()
    pts, _ = LK.gftt_batch(I)
    half = LK.WIN // 2
    cur = (torch.floor(pts).to(torch.int32) - half - LK.TRAVEL).contiguous()
    tpl = (torch.floor(pts).to(torch.int32) - half - 1).contiguous()
    Ir = reflect_pad(I, 1, 1).contiguous()
    result = {"max_abs_err": 0.0}
    for name, src, corners, wext in (("search", J, cur, LK.WEXT), ("template", Ir, tpl, LK.WIN + 5)):
        out = EX.extract_windows(src, corners, wext)
        ref = EX.extract_plain(src, corners, wext)
        torch.cuda.synchronize()
        check(bool(torch.equal(out, ref)), f"K6 {name} windows differ from the plain version")
        ms, plain_ms, tk, tp = timed_pair(lambda: EX.extract_windows(src, corners, wext),
                                          lambda: EX.extract_plain(src, corners, wext), 20, 3)
        log(f"[K6] {name} {tuple(out.shape)}: bitwise equal; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
            f"(runs {tk}, {tp})")
        if name == "search":
            result["ms"], result["plain_ms"] = ms, plain_ms
        del out, ref
    return result


def phase_k5(grays):
    import torch

    from comfyui_video_stabilizer_tpu_torch.ops import lk as LK
    from comfyui_video_stabilizer_tpu_torch.ops import lk_cuda as LKC

    pts, counts = LK.gftt_batch(grays[:-1])
    pyr = LK.gaussian_pyramid(grays)
    F = pts.shape[1]
    valid = torch.arange(F, device=pts.device)[None, :] < counts[:, None]
    g = pts / (2.0 ** LK.MAX_LEVEL)
    for lvl in range(LK.MAX_LEVEL, 0, -1):   # the coarse levels give the level-0 guesses
        g, status = LK.lk_level(pyr[lvl][:-1], pyr[lvl][1:], pts / (2.0 ** lvl), g, valid)
        g, valid = g * 2.0, valid & status
    I, J = pyr[0][:-1], pyr[0][1:]
    B, H, W = I.shape
    prep = LK._lk_prep(I, J, pts, g, LK.WIN)
    runnable = prep[8]
    n = B * F
    args = LK.gn_inputs(prep, g)
    del prep
    out, iters = LKC.lk_gn_iterate(*args, LK.MAX_ITERS, LK.EPS)
    ref, iters_ref = LKC.lk_gn_plain(*args, LK.MAX_ITERS, LK.EPS)
    torch.cuda.synchronize()
    t_out, s_out = LK._lk_post(out.reshape(B, F, 2), g, valid, runnable, LK.WIN, H, W, True)
    t_ref, s_ref = LK._lk_post(ref.reshape(B, F, 2), g, valid, runnable, LK.WIN, H, W, True)
    eq = float((s_out == s_ref).float().mean())
    live = s_out & s_ref
    err = float((t_out - t_ref).abs()[live].max()) if bool(live.any()) else 0.0
    hist = torch.bincount(iters[runnable.reshape(-1)].long(), minlength=LK.MAX_ITERS + 1).tolist()
    log(f"[K5] level 0, {B} pairs x {F} features ({int(valid.sum())} valid, {int(runnable.sum())} runnable): "
        f"status equal {eq:.6f}, live tracks {int(live.sum())}, max|kernel - plain| {err:.3e} px, "
        f"iterations equal {bool(torch.equal(iters, iters_ref))}, bitwise {bool(torch.equal(out, ref))}")
    log(f"[K5] iteration histogram of runnable features (index = iterations): {hist}")
    check(eq >= K5_STATUS_EQUAL, f"K5: status equal on {eq} < {K5_STATUS_EQUAL}")
    check(err <= K5_TRACK_TOL, f"K5: live tracks differ by {err} px > {K5_TRACK_TOL}")
    ms, plain_ms, tk, tp = timed_pair(lambda: LKC.lk_gn_iterate(*args, LK.MAX_ITERS, LK.EPS),
                                      lambda: LKC.lk_gn_plain(*args, LK.MAX_ITERS, LK.EPS), 10, 1)
    log(f"[K5] level 0 {n} features: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (runs {tk}, {tp})")
    return {"max_abs_err": float((out - ref).abs().max()), "ms": ms, "plain_ms": plain_ms}


def classic_stage_split(frames, device):
    """One Classic estimation stage by stage, a synchronize after each (ms)."""
    import torch

    from comfyui_video_stabilizer_tpu_torch.models import classic as CL
    from comfyui_video_stabilizer_tpu_torch.ops import lk as LK
    from comfyui_video_stabilizer_tpu_torch.ops import lk_cuda as LKC
    from comfyui_video_stabilizer_tpu_torch.ops import ransac as RS
    from comfyui_video_stabilizer_tpu_torch.ops import warp as W

    ms = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms[name] = ms.get(name, 0.0) + 1e3 * (time.perf_counter() - t0)
        return out

    grays = stage("gray", lambda: classic_grays(frames))
    stage("GFTT scores + top-k", lambda: LK._topk_packed(grays[:-1], LK.TOP_K))
    pts, counts = stage("gftt_batch", lambda: LK.gftt_batch(grays[:-1]))
    # gftt_batch = scores + top-k, then the (B, 2048) fetch and the host greedy
    ms["greedy fetch + host greedy"] = ms.pop("gftt_batch") - ms["GFTT scores + top-k"]
    pyr = stage("pyramid", lambda: LK.gaussian_pyramid(grays))
    F = pts.shape[1]
    valid = torch.arange(F, device=device)[None, :] < counts[:, None]
    g = pts / (2.0 ** LK.MAX_LEVEL)
    for lvl in range(LK.MAX_LEVEL, -1, -1):
        I, J = pyr[lvl][:-1], pyr[lvl][1:]
        B, H, W_ = I.shape
        pl = pts / (2.0 ** lvl)
        prep = stage("LK prep (incl. K6)", lambda: LK._lk_prep(I, J, pl, g, LK.WIN))
        args = LK.gn_inputs(prep, g)
        res, _ = stage("K5", lambda: LKC.lk_gn_iterate(*args, LK.MAX_ITERS, LK.EPS))
        g, status = LK._lk_post(res.reshape(B, F, 2), g, valid, prep[8], LK.WIN, H, W_, lvl == 0)
        if lvl > 0:
            g = g * 2.0
        valid = valid & status
    stage("fits + host fetch", lambda: CL._fused_classic_fits(pts, g, valid, 0, RS.DEFAULT_HYPOTHESES))
    mats = np.tile(np.eye(3, dtype=np.float32), (frames.shape[0], 1, 1))
    stage("padding mask", lambda: W.padding_mask_stats(mats, (WIDTH, HEIGHT), (WIDTH, HEIGHT), device)[1].cpu())
    stage("warp (K1)", lambda: W.warp_clip(frames, mats, (WIDTH, HEIGHT), "bilinear", (0.5, 0.5, 0.5)))
    return ms


def profile_call(fn):
    """torch.profiler over one call: (device events -- kernels and copies --,
    device busy ms, wall ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in device) / 1e3
    return len(device), busy, wall


def phase_classic(device, frames):
    import torch

    from comfyui_video_stabilizer_tpu_torch.ops import cuda_build

    ctx = make_context(frames)
    torch.cuda.synchronize()
    cuda_build.reset_launches()
    res = run_classic(ctx, device)
    torch.cuda.synchronize()
    launches = dict(cuda_build.LAUNCHES)
    log(f"[classic] launches in one stabilize_classic call: {launches}")
    check(launches["gftt"] >= 1, "K4 was not launched by the Classic slice")
    check(launches["lk_gn"] >= 4, "K5 was launched fewer than 4 times by the Classic slice")
    check(launches["extract_windows"] >= 8, "K6 was launched fewer than 8 times by the Classic slice")
    check(launches["warp"] >= 1, "K1 was not launched by the Classic slice")
    meta = res.meta
    trans = meta["estimated_motion"]["per_transition"]
    modes = [t["mode"] for t in trans]
    confs = [t["confidence"] for t in trans]
    log(f"[classic] modes {sorted(set(modes))}, similarity confidence min {min(confs):.4f}, "
        f"median {float(np.median(confs)):.4f}")
    check(meta["transform_mode_applied"] == "similarity",
          f"transform_mode_applied {meta['transform_mode_applied']!r}")
    check(all(m == "similarity" for m in modes) and min(confs) > 0.0,
          "a pair fell back (degenerate or rejected similarity)")
    check(tuple(res.frames.shape) == (CLIP_FRAMES, HEIGHT, WIDTH, 3), f"frames {tuple(res.frames.shape)}")
    check(tuple(res.masks.shape) == (CLIP_FRAMES, HEIGHT, WIDTH), f"masks {tuple(res.masks.shape)}")
    check(res.frames.device.type == "cuda" and res.masks.device.type == "cuda", "outputs left the card")
    check(bool(torch.isfinite(res.frames).all()) and bool(torch.isfinite(res.masks).all()),
          "non-finite outputs")
    orig = interior_motion(frames, 100)
    stab = interior_motion(res.frames, 100)
    log(f"[classic] mean interior inter-frame difference: input {orig:.5f}, stabilized {stab:.5f}")
    check(stab < 0.8 * orig, "Classic did not lower the inter-frame difference")
    del res

    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_classic(ctx, device)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        del out
    fps = [CLIP_FRAMES / t for t in times]
    log(f"[classic] warm stabilize_classic 1080p x {CLIP_FRAMES}: "
        f"{', '.join(f'{f:.1f}' for f in fps)} f/s; best {max(fps):.1f}, median {float(np.median(fps)):.1f}; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    n_kernels, busy, wall = profile_call(lambda: run_classic(ctx, device))
    log(f"[classic] torch.profiler over one call: {n_kernels} device events, device busy {busy:.1f} ms "
        f"of {wall:.1f} ms wall (busy share {busy / wall:.2f} under the profiler)")
    split = [classic_stage_split(frames, device) for _ in range(3)]
    log("[classic] stage split, ms (median of 3, synchronize after each stage): " + ", ".join(
        f"{k} {float(np.median([s[k] for s in split])):.2f}" for k in split[0]))

    n, h, w = BASELINE1
    small = synth_clip(n, h, w, seed=1, device=device)
    sctx = make_context(small)
    run_classic(sctx, device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run_classic(sctx, device)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    modes = {t["mode"] for t in out.meta["estimated_motion"]["per_transition"]}
    check(bool(torch.isfinite(out.frames).all()), "BASELINE config 1: non-finite frames")
    log(f"[classic] BASELINE config 1 ({w}x{h}, {n} frames, similarity, crop_and_pad): warm call "
        f"{1e3 * secs:.1f} ms, {n / secs:.1f} f/s; modes {sorted(modes)}")
    return launches, fps


def main() -> int:
    try:
        import torch
    except ImportError as exc:
        print(f"chip_smoke: torch does not import ({exc})", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke run needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from comfyui_video_stabilizer_tpu_torch.ops import cuda_build
    except ImportError as exc:
        print(f"chip_smoke: the port does not import from {ROOT} ({exc})", file=sys.stderr)
        return 1

    device = torch.device("cuda", 0)
    smi = phase_setup()
    phase_build()
    k1 = phase_k1(device)
    frames = synth_clip(CLIP_FRAMES, HEIGHT, WIDTH, seed=0, device=device)
    torch.cuda.synchronize()
    k2 = phase_k2(device, frames)
    launches, _fps = phase_slice(device, frames)
    phase_small_reference(device)
    phase_node(frames[:16].cpu())

    grays = classic_grays(frames)
    torch.cuda.synchronize()
    k4 = phase_k4(grays)
    k6 = phase_k6(grays)
    k5 = phase_k5(grays)
    del grays
    classic_launches, _ = phase_classic(device, frames)
    phase_small_reference(device, run_classic, "classic reference")
    phase_node(frames[:16].cpu(), "VideoStabilizerClassic")
    check("jax" not in sys.modules, "jax was imported")

    kernels = [
        {"name": "warp", "route": "cuda",
         "source": "comfyui_video_stabilizer_tpu_torch/csrc/warp.cu",
         "replaces": "comfyui_video_stabilizer_tpu/ops/warp_pallas.py:525",
         "launches": launches["warp"], **k1},
        {"name": "cost_volume", "route": "cuda",
         "source": "comfyui_video_stabilizer_tpu_torch/csrc/cost_volume.cu",
         "replaces": "comfyui_video_stabilizer_tpu/ops/cv_pallas.py:178",
         "launches": launches["cost_volume"], **k2},
        {"name": "gftt", "route": "cuda",
         "source": "comfyui_video_stabilizer_tpu_torch/csrc/gftt.cu",
         "replaces": "comfyui_video_stabilizer_tpu/ops/gftt_pallas.py:151",
         "launches": classic_launches["gftt"], **k4},
        {"name": "lk_gn", "route": "cuda",
         "source": "comfyui_video_stabilizer_tpu_torch/csrc/lk.cu",
         "replaces": "comfyui_video_stabilizer_tpu/ops/lk_pallas.py:177",
         "launches": classic_launches["lk_gn"], **k5},
        {"name": "extract_windows", "route": "cuda",
         "source": "comfyui_video_stabilizer_tpu_torch/csrc/extract.cu",
         "replaces": "comfyui_video_stabilizer_tpu/ops/extract_pallas.py:133",
         "launches": classic_launches["extract_windows"], **k6},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
