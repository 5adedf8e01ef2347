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
  7. a JSON line per kernel, the card line, then {"ok": true, ...} last

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
            t = re.search(r"\d([a-z][a-z_]*_kernel)I((?:Li\d+E)+)E", m.group(1))
            name = f"{t.group(1)}<{','.join(re.findall(r'Li(\d+)E', t.group(2)))}>" if t else m.group(1)
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


def phase_small_reference(device):
    """The CUDA path against the CPU path (the plain versions, which the
    CPU tests hold to the JAX reference) on a small shaken clip."""
    import torch

    frames = synth_clip(8, 144, 192, seed=9, device="cpu")
    cpu = run_slice(make_context(frames), "cpu")
    gpu = run_slice(make_context(frames.to(device)), device)
    pc = [t["mode"] for t in cpu.meta["estimated_motion"]["per_transition"]]
    pg = [t["mode"] for t in gpu.meta["estimated_motion"]["per_transition"]]
    check(pc == pg, f"per-pair modes differ: {pc} vs {pg}")
    mc = np.array([t["matrix"] for t in cpu.meta["estimated_motion"]["per_transition"]])
    mg = np.array([t["matrix"] for t in gpu.meta["estimated_motion"]["per_transition"]])
    mat_err = float(np.abs(mc - mg).max())
    d = (cpu.frames - gpu.frames.cpu()).abs().flatten()
    p99 = float(torch.quantile(d[:: max(1, d.numel() // 1_000_000)], 0.99))
    log(f"[reference] 8x144x192 clip, CUDA vs CPU path: modes equal, matrices max|d| {mat_err:.3e}, "
        f"frames p99 {p99:.3e}, max {float(d.max()):.3e}")
    check(mat_err <= SMALL_MAT_TOL, f"matrices differ by {mat_err}")
    check(p99 <= SMALL_FRAME_P99, f"frames p99 {p99}")


def phase_node(frames_cpu):
    import torch

    from comfyui_video_stabilizer_tpu_torch.nodes import VideoStabilizerFlow

    t0 = time.perf_counter()
    out = VideoStabilizerFlow.execute(frames_cpu, 30.0, "crop_and_pad", "similarity", False,
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
    log(f"[node] VideoStabilizerFlow.execute on a CPU tensor ({n}, {HEIGHT}, {WIDTH}, 3): "
        f"{secs:.3f} s, mode {meta['transform_mode_applied']}")


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
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
