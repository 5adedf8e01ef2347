#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. setup report: torch / CUDA versions, the card, nvidia-smi's name and
     power limit, whether triton imports; TF32 off
  2. build the CUDA kernels from csrc/ with nvcc (timed)
  3. K1 (warp) against its plain PyTorch version at 1080p
  4. K2 (cost volume) against its plain version at the slice's level shapes,
     bitwise
  5. the slice: stabilize_flow on a synthetic shaken 1080p x 80-frame clip,
     which takes the fast path (models/fastpath.py) with its estimation
     from one CUDA graph: the first call's launches (the graph's eager
     warm-up, its capture and one replay) on a line of their own, then a
     warm call's launch counts (the kernels line's), the replay, output
     checks, a CPU-path reference on a small clip (the fast path on both
     devices), and the warm frames/s; a warm call launches K8 and K9
     once each
  6. the Flow node on a CPU tensor of 16 frames at 1080p
 6a. K8 (padding stats) against its plain version, mask and counts
     torch.equal: on the Flow slice's 1080p x 80 coefficients (every
     frame must take the affine route; whole, and two row bands that
     concatenate and sum to it), on a batch mixing affine frames (signed
     zeros too) with perspective ones, on perspective coefficients and on
     a 4K expand bucket (80 frames, a 2288x3968 static canvas, a smaller
     true canvas on the device); timed in turns with the plain version,
     and similarity beside perspective coefficients
 6b. K9 (gray + integer pool) against its plain version, torch.equal: x4
     (Flow) and x2 (Classic) on the 1080p x 80 clip, timed in turns with
     the plain version; the gray alone, quantized and not, and x2 on every
     uint8 (r, g, b) triple / 255 (16 frames of 1024 x 1024)
  7. K4 (GFTT scores from the gray) against its plain version on the
     Classic slice's grays, (79, 540, 960), bitwise, beside the plain
     Sobel and products it replaces; then K7 (the corner greedy) on
     those grays' (79, 2048) candidates from _topk_packed, on clustered
     candidates that fill max_corners = 23, on the candidates with every
     tenth a repeat and on a grid that fills max_corners = 6144 inside a
     block, torch.equal to its plain version and to the native greedy,
     timed beside the plain version, with its byte and operation counts
  8. K6 (window extraction) against its plain version at (79, 400, 49)
     and (79, 400, 36) on the level-0 stack with the real GFTT corners
  9. K5 (LK Gauss-Newton) against its plain version: one level-0 solve
     on the real clip's windows, with the iteration histogram
 10. the Classic slice: stabilize_classic (its fast path, the estimation
     from one CUDA graph) on the same 1080p x 80 clip: the first call's
     launches (warm-up, capture, replay), then a warm call's (the
     kernels line's), output checks, the warm frames/s, the peak device
     memory, the device events of one call under torch.profiler, an
     eager stage split (K4, the threshold and sort, K7 apart), and
     BASELINE config 1 (854x480, 64 frames) once; then the Classic graph
     as phase 26 takes Flow's (the whole meta equal to CVST_FUSED=0, and
     no device-to-host copy before K1) and its split as phase 27
 11. Classic, CUDA path against CPU path on a small clip; the Classic
     node on a CPU tensor of 16 frames at 1080p
 12. the Motion Apply slice, BASELINE config 4: apply_motion (bicubic,
     blur 0.5, 33 samples, crop_and_pad) on the 1080p x 80 clip with the
     action shake of seed 3 at 24 fps: launch counts, no separate
     soft-mask pass, output checks, the warm frames/s, the device events
     of one call under torch.profiler, a stage split and the peak device
     memory; then crop and expand once each
 13. K3 (shutter-blur warp with its soft mask) against its plain version
     at 1080p, frames and mask bitwise: 8 frames, bicubic S = 33 and
     bilinear S = 5, then once at the Motion Apply slice's shape (80
     frames, bicubic, S = 33), with and without the mask; the share of
     K3's tiles and pixel-samples that read device memory at config 4
     with crop_and_pad, crop and expand
 14. BASELINE config 2: the handheld shake of seed 7 at 1280x720 x 80,
     bilinear, no blur (K1), run twice and compared bitwise
 15. Motion Apply, CUDA path against CPU path on a small clip, with and
     without blur; the Motion Apply, Inverse and both Shake Generator
     nodes on CPU tensors of 16 frames at 1080p
 16. crop framing (keep_fov 0.6) of Flow and Classic on the 1080p x 80
     clip, through the fast path and through the host engine
     (CVST_FASTPATH=0): status, scale, crop and no padding after a
     successful refine; the CUDA path against the CPU path on a small
     clip, crop and perspective, each engine on both devices, statuses,
     notes and scale equal
 17. BASELINE config 3: Flow, 1280x720 x 128, crop_and_pad, perspective,
     camera_lock, 24 fps, once through the host engine and once through
     the fast path: per-pair modes, K1 / K2 launches; the fast path's warm
     frames/s (median of 3); Classic perspective once on the 1080p clip
     through each engine
 17a. K10 (the DLT refit's smallest eigenvector) and K11's two entries
     (the 4-point hypotheses, which build their own systems, and the
     general 8x8 solve) against their plain versions, torch.equal (NaN
     where NaN), on every input the perspective paths give them, recorded
     from one eager call each of Flow and Classic 1080p x 80 crop_and_pad
     perspective and of config 3 ((79, 9, 9) and (127, 9, 9); 40,448 and
     65,024 4-point sets; the IRLS pre-warp's (B, 8, 8) systems; the
     general entry also on the 4-point sets' systems); each timed at the
     main shapes in turns with its plain version, beside
     torch.linalg.eigh / solve_ex on the same inputs
 18. forced streaming: Flow, Classic and config 4 on the 1080p clip held
     on the host, the chunk budget lowered to 20 frames, frames and masks
     bitwise equal to the unstreamed calls (Flow and Classic through the
     host engine, which a streamed call takes)
 19. Motion Apply on 65,536 frames of 64x64 RGB: K1 splits its launch at
     65,535 frames; the result against the CPU path
 20. BASELINE config 5: Flow, 3840x2160 x 300, expand, the clip held on
     the host (cut to what the host's free memory holds, and said so):
     whether it streamed, the chunk, the stage split, the host<->device
     copies, wall frames/s, the peak device memory, K1 at the 4K canvas
 21. dense dis_flow on the 1080p clip's 960x540 grays: K2 at r = 3 at
     (79, 135, 240) against its plain version, bitwise, and timed; K2's
     launches in one dense call and the call's time; the CUDA path
     against the CPU path on a small clip
 22. the 1080p x 80 Flow call with DIS forced to raise (TV-L1 tier), then
     with TV-L1 too (phase correlation), the graph cache cleared (the
     fast path then fails and leaves the call to the host engine):
     backend, reason string, modes, launches, ms a call, device events
     and busy share under torch.profiler
 23. K2's launch refused (error 9), through the fast path (the graph
     captured anew) and through the host engine: stabilize_flow raises
     KernelError and no fallback tier runs; then K7's: stabilize_classic
     raises KernelError and the native greedy never runs
 24. the host engine's (CVST_FASTPATH=0) 1080p x 80 Flow call's time
     split: the device stages with a synchronize after each, the host
     trajectory + meta between the fits' fetch and K1's launch, the tail
     after the warp, and one call's device events and busy share under
     torch.profiler
 25. the 1080p x 80 Flow call through the host engine against the fast
     path, to the docs/parity.md contract, and the warm calls of both
 26. the fused Flow graph: the first call (warm-up + capture) apart from
     warm calls, the replay alone, bitwise equality with CVST_FUSED=0
     (the whole meta too), the launches of a warm call, its device
     events under torch.profiler (and the replay's alone) and its
     device-to-host copies (none before K1), the device memory the
     cached graph keeps, and the host time the estimation holds the
     calling thread, from the graph and eagerly
 27. the fast path's Flow split: gray, graph replay, padding stats, K1
     and the fetch, a synchronize after each; then, after every profiled
     phase (torch.profiler has lost a later call's device events once
     these phases' many graph captures had run ahead of it):
     perspective graph: Flow and Classic 1080p x 80 crop_and_pad
     perspective from their CUDA graphs: one capture each, a warm
     replay's launches (the kernels line's K10 and K11 counts), frames,
     masks and meta torch.equal to CVST_FUSED=0 in turns, no host sync
     in the estimation (set_sync_debug_mode("error")), no device-to-host
     copy before K1, the memory each graph keeps alone and the two
     together; then each one's split as above;
     normalize: a uint8 clip and a 0..255 float clip (1080p x 80, from a
     seed) normalized on the card, torch.equal to the CPU normalization
     with equal 960x540 grays, and the values and gray pixels the
     unrepaired division by the Python number 255.0 would move;
     the graph cache shared by Flow and Classic, its graphs in one
     memory pool: what each key's graph keeps alone, four static keys in
     three rounds (captures, pool rebuilds, ms, the bytes each key adds
     and the four keep, at most the largest alone + 0.5 GiB), the four
     replayed interleaved (each torch.equal to CVST_FUSED=0), the memory
     after clear_graph_cache() (the baseline within 0.05 GiB), and five
     keys cycled through the four entries (a capture every call);
     host fits: fit_model_batch, median_translation_batch and
     reprojection_residuals on the card at Classic's (79 x 400) and
     Flow's (79 x 8160) shapes against device="cpu", timed;
     rectangle: the largest all-ones rectangle of the Flow call's closed
     1080p content mask, native and numpy, equal, timed
 28. the multi-device layer on four shards of one card
     (``make_mesh(devices=["cuda:0"] * 4)``): the 1080p x 80 Flow slice
     through stabilize_flow_sharded (the fast path's mesh branch), torch.equal
     to the unsharded eager call (CVST_FUSED=0) in frames, masks and
     matrices, K2 launched 4 x its unsharded count and K1 once a shard,
     no copy between the shards of one card, five warm calls in turns
     with the unsharded graph call; Classic through
     stabilize_classic_sharded against the unsharded eager call, K4-K7 by
     shard;
     79 frames on a (2, 2) mesh (the rows outcome: two bands, K1 with
     row0) against the unsharded host engine, and K1 with row0 bitwise
     its plain version at 1080p; both sidecars at 1080p x 80 and, on a
     small clip, against their CPU runs; with more than one card the Flow
     check on distinct cards (else a line says so)
 29. a JSON line per kernel (its time, its plain version's, its bound
     and the time of a PyTorch call that computes the same function,
     where one exists; K2 adds its r = 3 figures and the dense call's
     launches), the card line, then {"ok": true, ...} last

Phases 16-17 run after phase 11, 21-27 after phase 12 and ahead of
phase 13 (once K3's plain version has run, torch.profiler records no
device event), 18-20 after phase 15 (config 5 alone on the card), and 28
after config 5.  Each phase's wall time is printed on a line of its own
("[time]").  The card's calls take the fast path by default, as a user's
do; phases that compare with the host engine say so.  Every phase that
claims the fast path checks fastpath.SERVED, the count of calls it
served, so a call that fell back to the host engine fails the phase.

Every kernel's bound is the larger of its bytes over 3.35 TB/s and its
float32 operations over 67 TFLOP/s (the H100 SXM data sheet), counted
from this run's inputs.  K3's line also gives the ceiling at 33.5
TFLOP/s, the rate a -fmad=false build can reach (every multiply and add
issues on its own).

Exits 2 without printing a result when torch.cuda.is_available() is false.
"""

from __future__ import annotations

import contextlib
import itertools
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
SMALL_MAT_TOL = 1e-3    # CUDA path vs CPU path on the small clip
SMALL_FRAME_P99 = 1e-3
# perspective fits, card vs CPU at the 1080p shapes: the frame corners'
# projections (px).  The DLT refit's A^T A sums 2P float32 rows in another
# order on the card (a library matmul; K10 and K11 do their twins'
# arithmetic), so the translations differ by ~2e-3 px at P = 8160
# (SMALL_MAT_TOL holds for the similarity fits)
PERSP_FIT_TOL_PX = 0.05
BASELINE1 = (64, 480, 854)  # BASELINE.json config 1: Classic 480p / 64 frames
BASELINE2 = (80, 720, 1280)  # BASELINE.json config 2: shake -> Motion Apply 720p, bilinear
BASELINE3 = (128, 720, 1280)  # BASELINE.json config 3: Flow 720p / 128, perspective + camera_lock
BASELINE5 = (300, 2160, 3840)  # BASELINE.json config 5: Flow 4K / 300, expand, streams past the budget
K3_TOL = 0.0            # expected bitwise: K1's per-sample arithmetic, the same sum and division
APPLY_FRAME_P99 = 1e-6  # Motion Apply, CUDA path vs CPU path: the same matrices, no reductions
APPLY_MASK_UNEQUAL = 1e-3  # a coverage tie may flip on a one-ulp coordinate
PEAK_BYTES = 3.35e12    # H100 SXM HBM3, bytes/s (NVIDIA data sheet)
PEAK_FLOPS = 67e12      # H100 SXM float32 outside the tensor cores, FLOP/s (data sheet)
NO_FMA_FLOPS = PEAK_FLOPS / 2  # the same with every multiply and add issued alone (-fmad=false)
PROFILE_PAD = 4096      # spin kernels that open each profiler session (device_events)
PAD_CYCLES = 12_500     # each a ~6-7 us spin at the H100's 1.7-2.0 GHz: ~26-30 ms a session


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def env(**values):
    """Set environment variables (the fast-path switches) for a block."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def served(kind: str, calls: int, what: str):
    """Fails unless the fast path served exactly ``calls`` of the block's
    ``kind`` ("flow" or "classic") calls (0: the host engine ran them all),
    so a fast path that falls back cannot pass for one that ran."""
    from comfyui_video_stabilizer_tpu_torch.models import fastpath as FP

    before = FP.SERVED[kind]
    yield
    got = FP.SERVED[kind] - before
    check(got == calls, f"{what}: the fast path served {got} {kind} calls, not {calls}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warm: bool = True) -> float:
    """Mean milliseconds per call of fn() on the current stream (CUDA events);
    one untimed call first unless warm is False."""
    import torch

    if warm:
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


def graph_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() captured ``reps`` times in one CUDA
    graph, the best of three replays (CUDA events) after a warm one: the
    kernels alone, without the host's issue time (a small kernel's
    wrapper takes longer to issue than the kernel to run, so an eager
    loop of launches times the host).  fn must be capturable."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return min(times)


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the float32 rate, whichever is larger."""
    t_bytes = 1e3 * nbytes / PEAK_BYTES
    t_ops = 1e3 * flops / PEAK_FLOPS
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def warp_ops_per_sample(interp: str, c: int) -> int:
    """float32 operations of one output pixel of one sample in csrc/warp.cu:
    33 for the displacement, the clip and the split, then the weights
    (bilinear 6; bicubic 2 x 21 for cubic_weights and 16 products) and a
    multiply and an add per tap and channel."""
    if interp == "bilinear":
        return 33 + 6 + 4 * 2 * c
    return 33 + 2 * 21 + 16 + 16 * 2 * c


def warp_ops(n, out_h, out_w, c, interp, samples=1, mask=False) -> int:
    """K1 (samples 1) or K3: the S samples' arithmetic, their running sum
    and the division; with the mask, per sample 2 x 3 for the
    round-half-even nearest source, 4 bound tests and the count, and 4
    per pixel to finish (scale, 1 - cover, the small-value test)."""
    per_sample = warp_ops_per_sample(interp, c) + (11 if mask else 0)
    per_pixel = samples * per_sample + ((samples - 1) * c + c if samples > 1 else 0) + (4 if mask else 0)
    return n * out_h * out_w * per_pixel


def warp_bound(n, h, w, c, out_h, out_w, interp, samples=1, mask=False) -> dict:
    """K1 or K3: frames read once, output (and mask) written once."""
    nbytes = 4 * (n * h * w * c + n * out_h * out_w * (c + int(mask)) + n * samples * 8 + c)
    return bound(nbytes, warp_ops(n, out_h, out_w, c, interp, samples, mask))


def grid_sample_ms(frames_nchw, coeffs, out_h: int, out_w: int, reps: int, mode: str = "bilinear") -> float:
    """One torch.nn.functional.grid_sample call (``mode``, zero padding,
    align_corners=True) at the warp's source coordinates; the grid is
    built beforehand and not timed."""
    import torch
    import torch.nn.functional as F

    from comfyui_video_stabilizer_tpu_torch.ops import warp as W

    h, w = frames_nchw.shape[2], frames_nchw.shape[3]
    dx, dy, _ = W._displacements(coeffs, out_h, out_w)
    xs = torch.arange(out_w, device=coeffs.device, dtype=torch.float32)[None, None, :] + dx
    ys = torch.arange(out_h, device=coeffs.device, dtype=torch.float32)[None, :, None] + dy
    del dx, dy
    grid = torch.stack([xs * (2.0 / (w - 1)) - 1.0, ys * (2.0 / (h - 1)) - 1.0], dim=-1)
    del xs, ys
    return cuda_ms(lambda: F.grid_sample(frames_nchw, grid, mode=mode, padding_mode="zeros",
                                         align_corners=True), reps)


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


def synth_clip(n: int, h: int, w: int, seed: int, device, on_host: bool = False):
    """Shaken clip of multi-octave value noise, warped on the device; with
    ``on_host`` it is warped 16 frames at a time into a host tensor."""
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
    if not on_host:
        src = rgb[None].expand(n, *rgb.shape).contiguous()
        return W.warp_clip(src, view, (w, h), "bilinear", (0.5, 0.5, 0.5))
    out = torch.empty((n, h, w, 3), dtype=torch.float32)
    for s in range(0, n, 16):
        e = min(n, s + 16)
        src = rgb[None].expand(e - s, *rgb.shape).contiguous()
        out[s:e].copy_(W.warp_clip(src, view[s:e], (w, h), "bilinear", (0.5, 0.5, 0.5)))
    return out


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
            t = re.search(r"\d([a-z][a-z_]*\d*_kernel)(?:I((?:Li\d+E)+)E)?", m.group(1))
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
            equal = bool(torch.equal(out, ref))
            log(f"[K1] {name:11s} {interp:8s} bitwise equal {equal}; max|kernel - plain| = {err:.3e}")
            check(bool(torch.isfinite(out).all()), f"K1 {name} {interp}: non-finite output")
            check(equal, f"K1 {name} {interp}: the frames differ from the plain version (max {err})")
            max_err = max(max_err, err)
    del frames

    # timing at the slice's shape: 80 frames of 1080p RGB, bilinear, similarity
    big = torch.rand((CLIP_FRAMES, HEIGHT, WIDTH, 3), generator=gen).to(device)
    mats = np.stack([sim(i) for i in range(CLIP_FRAMES)])
    coeffs = torch.as_tensor(W.prepare_inverse_coeffs(mats).astype(np.float32), device=device)
    out = W.warp_frames(big, coeffs, border, HEIGHT, WIDTH, "bilinear")
    ref = W.warp_plain(big, coeffs, border, HEIGHT, WIDTH, "bilinear")
    err = float((out - ref).abs().max())
    check(bool(torch.equal(out, ref)), f"K1 at the slice shape: the frames differ from the plain version ({err})")
    max_err = max(max_err, err)
    del out, ref
    # plain, kernel, kernel, plain
    t_plain = [cuda_ms(lambda: W.warp_plain(big, coeffs, border, HEIGHT, WIDTH, "bilinear"), 3)]
    t_kern = [cuda_ms(lambda: W.warp_frames(big, coeffs, border, HEIGHT, WIDTH, "bilinear"), 10)
              for _ in range(2)]
    t_plain.append(cuda_ms(lambda: W.warp_plain(big, coeffs, border, HEIGHT, WIDTH, "bilinear"), 3))
    ms, plain_ms = min(t_kern), min(t_plain)
    nchw = big.permute(0, 3, 1, 2).contiguous()
    del big
    library_ms = grid_sample_ms(nchw, coeffs, HEIGHT, WIDTH, 10)
    del nchw
    b = warp_bound(CLIP_FRAMES, HEIGHT, WIDTH, 3, HEIGHT, WIDTH, "bilinear")
    log(f"[K1] ({CLIP_FRAMES}, {HEIGHT}, {WIDTH}, 3) bilinear: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms "
        f"(runs {t_kern}, {t_plain}); grid_sample {library_ms:.3f} ms; bound {b['bound_ms']:.3f} ms "
        f"({b['bound_by']})")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, **b, "library_ms": library_ms}


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
        equal = [bool(torch.equal(a, b)) for a, b in zip(out, ref)]
        err = max(float((a - b).abs().max()) for a, b in zip(out, ref))
        log(f"[K2] {shape}: fx, fy, cmin bitwise equal {equal}; max|kernel - plain| {err:.3e}")
        check(all(equal), f"K2 {shape}: outputs differ from the plain version (fx, fy, cmin equal: {equal})")
        result["max_abs_err"] = max(result["max_abs_err"], err)
        t_plain = [cuda_ms(lambda: CV.cost_volume_plain(I, J, 2, 8), 5)]
        t_kern = [cuda_ms(lambda: CV.cost_volume_subpixel(I, J, 2, 8), 20) for _ in range(2)]
        t_plain.append(cuda_ms(lambda: CV.cost_volume_plain(I, J, 2, 8), 5))
        log(f"[K2] {shape} r=2: kernel {min(t_kern):.4f} ms, plain {min(t_plain):.4f} ms "
            f"(runs {t_kern}, {t_plain})")
        if level is pyr[0]:
            result["ms"], result["plain_ms"] = min(t_kern), min(t_plain)
            result.update(k2_bound(I.numel(), 2), library_ms=None)
            log(f"[K2] {shape}: bound {result['bound_ms']:.4f} ms ({result['bound_by']}); "
                "no single PyTorch call computes it")
    return result


def make_context(frames):
    from comfyui_video_stabilizer_tpu_torch.utils.video_io import FrameAdapter, VideoContext

    return VideoContext(
        frames=frames,
        adapter=FrameAdapter(frames.dtype, False, "0_1", "torch", False),
        width=int(frames.shape[2]), height=int(frames.shape[1]), channels=3,
        fps=30.0, template_kind="sequence", template_meta={},
    )


def run_slice(ctx, device, backend="DIS", transform="similarity"):
    """The Flow slice's call (``transform`` similarity, or perspective for
    the perspective graph's phase); fails unless ``backend`` ran it."""
    from comfyui_video_stabilizer_tpu_torch.models.flow import stabilize_flow

    res = stabilize_flow(ctx, "crop_and_pad", transform, False, 0.8, 0.6, 0.6,
                         (127, 127, 127), 30.0, device=device)
    check(res.meta["flow_backend"] == backend,
          f"flow_backend {res.meta['flow_backend']!r} ({res.meta['flow_fallback_reason']}), not {backend!r}")
    return res


def run_classic(ctx, device, transform="similarity"):
    from comfyui_video_stabilizer_tpu_torch.models.classic import stabilize_classic

    return stabilize_classic(ctx, "crop_and_pad", transform, False, 0.8, 0.6, 0.6,
                             (127, 127, 127), 30.0, device=device)


def phase_slice(device, frames):
    import torch

    from comfyui_video_stabilizer_tpu_torch.ops import cuda_build

    from comfyui_video_stabilizer_tpu_torch.models import fastpath as FP

    ctx = make_context(frames)
    torch.cuda.synchronize()
    captures = FP.GRAPH_STATS["captures"]
    cuda_build.reset_launches()
    with served("flow", 1, "the slice's first call"):
        run_slice(ctx, device)
    torch.cuda.synchronize()
    log(f"[slice] launches in the first stabilize_flow call (the graph's eager warm-up, its capture and one "
        f"replay): {dict(cuda_build.LAUNCHES)}")
    check(FP.GRAPH_STATS["captures"] == captures + 1, "the slice's first call did not capture its CUDA graph")
    replays = FP.GRAPH_STATS["replays"]
    cuda_build.reset_launches()
    with served("flow", 1, "the slice"):
        res = run_slice(ctx, device)
    torch.cuda.synchronize()
    launches = dict(cuda_build.LAUNCHES)
    log(f"[slice] launches in one warm stabilize_flow call (one graph replay): {launches}; graph {FP.GRAPH_STATS}")
    check(FP.GRAPH_STATS["replays"] == replays + 1, "the slice's estimation did not run from its CUDA graph")
    check(launches["warp"] >= 1, "K1 was not launched by the slice")
    check(launches["cost_volume"] >= 4, "K2 was launched fewer than 4 times by the slice")
    check(launches["padding_stats"] == 1 and launches["gray_pool"] == 1,
          f"the slice's warm call launched K8 {launches['padding_stats']} and K9 {launches['gray_pool']} times, not once")
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
    with served("flow", 5, "the slice's warm calls"):
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
    CPU tests hold to the JAX reference) on a small shaken clip, the fast
    path on both."""
    import torch

    frames = synth_clip(8, 144, 192, seed=9, device="cpu")
    kind = "flow" if run is run_slice else "classic"
    with served(kind, 2, name):
        with env(CVST_FASTPATH="1"):  # the CPU takes the fast path too, as the card does
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
    if node_name == "VideoStabilizerFlow":
        check(meta["flow_backend"] == "DIS", f"node flow_backend {meta['flow_backend']!r}")
    check(bool(torch.isfinite(video).all()), "node frames not finite")
    log(f"[node] {node_name}.execute on a CPU tensor ({n}, {HEIGHT}, {WIDTH}, 3): "
        f"{secs:.3f} s, mode {meta['transform_mode_applied']}")


def perspective_copy(coeffs, seed: int, every: int = 1):
    """The coefficients with g, h set to small nonzero values (a
    perspective frame) on every ``every``-th frame."""
    rng = np.random.default_rng(seed)
    out = coeffs.cpu().numpy().copy()
    rows = np.arange(0, len(out), every)
    out[rows, 6:] = rng.uniform(-2e-5, 2e-5, (len(rows), 2)).astype(np.float32)
    return out


def phase_k8(device, frames):
    """K8 against its plain version, mask and counts torch.equal: the Flow
    slice's 1080p x 80 coefficients (from its graph; every frame must take
    the affine route) over the whole canvas and as two row bands, a mixed
    affine + perspective batch with signed zeros, and a 4K expand bucket;
    timed in turns at 1080p, similarity and perspective."""
    import torch

    from comfyui_video_stabilizer_tpu_torch.models import fastpath as FP
    from comfyui_video_stabilizer_tpu_torch.ops import resize as R
    from comfyui_video_stabilizer_tpu_torch.ops import warp as W

    working, dec, est_args = fast_estimate_args("flow")
    coeffs = FP._fused_estimate("flow", R.gray_for_estimation(frames, working, decimation=dec), *est_args)["coeffs"]
    n = coeffs.shape[0]
    affine = int(W.affine_route(coeffs).sum())
    log(f"[K8] routes of the Flow slice's {n} frames: affine {affine}, general {n - affine}")
    check(affine == n, f"K8: {n - affine} of the Flow slice's similarity frames take the general route")

    def same(kernel, plain, what):
        torch.cuda.synchronize()
        equal = all(bool(torch.equal(a, b)) for a, b in zip(kernel, plain))
        err = float((kernel[0] - plain[0]).abs().max())
        log(f"[K8] {what}: mask and counts torch.equal {equal}; padded pixels {int(kernel[1].sum())}")
        check(equal, f"K8 {what}: the mask or the counts differ from the plain version (max {err})")
        return err

    whole = W.padding_counts(coeffs, HEIGHT, WIDTH, HEIGHT, WIDTH)
    err = same(whole, W.padding_counts_plain(coeffs, HEIGHT, WIDTH, HEIGHT, WIDTH), f"({n}, {HEIGHT}, {WIDTH})")
    bands = [W.padding_counts(coeffs, r1 - r0, WIDTH, HEIGHT, WIDTH, row0=r0) for r0, r1 in ((0, 540), (540, HEIGHT))]
    err = max(err, same(bands[1], W.padding_counts_plain(coeffs, HEIGHT - 540, WIDTH, HEIGHT, WIDTH, row0=540),
                        "the band row0 = 540"))
    joined = bool(torch.equal(torch.cat([m for m, _ in bands], dim=1), whole[0])) and bool(
        torch.equal(bands[0][1] + bands[1][1], whole[1]))
    log(f"[K8] two row bands: masks concatenate and counts sum to the whole canvas's {joined}")
    check(joined, "K8: the row bands do not make up the whole canvas")
    del bands

    # one launch of both routes: every other frame perspective, and signed
    # zeros in c, f, g, h of every fourth
    mixed = perspective_copy(coeffs, 13, every=2)
    mixed[1::4, [2, 5, 6, 7]] = np.float32(-0.0)
    mixed = torch.from_numpy(mixed).to(device)
    routes = W.affine_route(mixed)
    err = max(err, same(W.padding_counts(mixed, HEIGHT, WIDTH, HEIGHT, WIDTH),
                        W.padding_counts_plain(mixed, HEIGHT, WIDTH, HEIGHT, WIDTH),
                        f"mixed batch, affine {int(routes.sum())} + general {int((~routes).sum())} frames"))
    persp = torch.from_numpy(perspective_copy(coeffs, 17)).to(device)
    err = max(err, same(W.padding_counts(persp, HEIGHT, WIDTH, HEIGHT, WIDTH),
                        W.padding_counts_plain(persp, HEIGHT, WIDTH, HEIGHT, WIDTH),
                        f"perspective, general route {int((~W.affine_route(persp)).sum())} frames"))
    del mixed, whole

    # the 4K expand bucket: a 2288x3968 static canvas (fastpath._out_dims),
    # a 3890x2224 true canvas on the device, the source shaken inside it
    bh, bw = 2160 + 128, 3840 + 128
    shift = np.array([[1.0, 0, 25.0], [0, 1.0, 32.0], [0, 0, 1.0]])
    mats = np.stack([shift @ m for m in shake_matrices(CLIP_FRAMES, 5, 0.003, 3.0)])
    c4k = torch.as_tensor(W.prepare_inverse_coeffs(mats).astype(np.float32), device=device)
    out_wh = torch.tensor([3890, 2224], dtype=torch.int32, device=device)
    err = max(err, same(W.padding_counts(c4k, bh, bw, 2160, 3840, out_wh=out_wh),
                        W.padding_counts_plain(c4k, bh, bw, 2160, 3840, out_wh=out_wh),
                        f"4K expand bucket ({CLIP_FRAMES}, {bh}, {bw}), true canvas 3890x2224, affine "
                        f"{int(W.affine_route(c4k).sum())} frames"))
    ms_4k = cuda_ms(lambda: W.padding_counts(c4k, bh, bw, 2160, 3840, out_wh=out_wh), 10)
    del c4k
    torch.cuda.empty_cache()

    ms, plain_ms, tk, tp = timed_pair(lambda: W.padding_counts(coeffs, HEIGHT, WIDTH, HEIGHT, WIDTH),
                                      lambda: W.padding_counts_plain(coeffs, HEIGHT, WIDTH, HEIGHT, WIDTH), 20, 3)
    # in turns: similarity, perspective, perspective, similarity
    turns = [cuda_ms(lambda c=c: W.padding_counts(c, HEIGHT, WIDTH, HEIGHT, WIDTH), 20)
             for c in (coeffs, persp, persp, coeffs)]
    # the mask written once, the coefficients read and the counts written
    # once; per pixel 42 operations, fixed by the first design: 33 for the
    # displacement and the split (as K1), 4 for the round-half-even, 4
    # bound tests, 1 for 1 - inside
    px = n * HEIGHT * WIDTH
    b = bound(4 * px + 32 * n + 8 * n, 42 * px)
    px_4k = CLIP_FRAMES * bh * bw
    b_4k = bound(4 * px_4k + 32 * CLIP_FRAMES + 8 * CLIP_FRAMES + 8, 42 * px_4k)
    log(f"[K8] ({n}, {HEIGHT}, {WIDTH}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (runs {tk}, {tp}); "
        f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}; the operations {1e3 * 42 * px / PEAK_FLOPS:.4f} ms, "
        f"{1e3 * 42 * px / NO_FMA_FLOPS:.4f} at the no-FMA rate); in turns similarity / perspective / "
        f"perspective / similarity {[round(t, 4) for t in turns]} ms; 4K bucket ({CLIP_FRAMES}, {bh}, {bw}) "
        f"kernel {ms_4k:.4f} ms, bound {b_4k['bound_ms']:.4f} ms ({b_4k['bound_by']}; the operations "
        f"{1e3 * 42 * px_4k / NO_FMA_FLOPS:.4f} ms at the no-FMA rate); no single PyTorch call computes it")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **b, "library_ms": None}


def triple_frames(device):
    """Every uint8 (r, g, b) triple / 255 as 16 frames of 1024 x 1024 RGB."""
    import torch

    levels = torch.arange(256, dtype=torch.float32, device=device) / torch.full(
        (), 255.0, dtype=torch.float32, device=device)
    idx = torch.arange(1 << 24, dtype=torch.int64, device=device)
    return torch.stack([levels[idx >> 16], levels[(idx >> 8) & 255], levels[idx & 255]], -1).reshape(
        16, 1024, 1024, 3)


def phase_k9(device, frames):
    """K9 against its plain version, torch.equal: x4 (Flow) and x2 (Classic)
    on the 1080p x 80 clip, timed in turns; the gray alone (quantized and
    not) and x2 on every uint8 triple."""
    import torch

    from comfyui_video_stabilizer_tpu_torch.ops import resize as R

    result = {"max_abs_err": 0.0}
    for f in (4, 2):
        out = R.gray_pool(frames, f, f)
        ref = R.gray_pool_plain(frames, f, f)
        torch.cuda.synchronize()
        equal = bool(torch.equal(out, ref))
        err = float((out - ref).abs().max())
        result["max_abs_err"] = max(result["max_abs_err"], err)
        log(f"[K9] x{f} {tuple(frames.shape)} -> {tuple(out.shape)}: torch.equal {equal}")
        check(equal, f"K9 x{f}: the grays differ from the plain version (max {err})")
        ms, plain_ms, tk, tp = timed_pair(lambda: R.gray_pool(frames, f, f), lambda: R.gray_pool_plain(frames, f, f),
                                          20, 3)
        # the clip read once and the gray written once; per source pixel 5
        # operations for the luma (a product, two fmas), 4 for the
        # quantization, 1 add; per output pixel 1 multiply
        b = bound(4 * (frames.numel() + out.numel()), 10 * frames.numel() // 3 + out.numel())
        log(f"[K9] x{f}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (runs {tk}, {tp}); bound {b['bound_ms']:.4f} ms "
            f"({b['bound_by']}); no single PyTorch call computes it")
        if f == 4:
            result.update(ms=ms, plain_ms=plain_ms, **b, library_ms=None)
        del out, ref
    tri = triple_frames(device)
    for f, quantize in ((1, True), (1, False), (2, True)):
        out = R.gray_pool(tri, f, f, quantize)
        ref = R.gray_pool_plain(tri, f, f, quantize)
        torch.cuda.synchronize()
        equal = bool(torch.equal(out, ref))
        log(f"[K9] every uint8 triple, x{f}, quantize {quantize}: torch.equal {equal}")
        check(equal, f"K9 on the uint8 triples (x{f}, quantize {quantize}): differs from the plain version")
    del tri
    torch.cuda.empty_cache()
    return result


def phase_normalize(device):
    """uint8 and 0..255 float payloads normalized on the card: a uint8 clip
    of random levels and a 0..255 float clip (the shaken 1080p clip's
    levels), both 1080p x 80 from a seed.  Each is torch.equal to the CPU
    normalization and its estimation grays (960x540) to the CPU grays.
    The count of values, full-size gray pixels and working grays that the
    unrepaired normalization (a division by the Python number 255.0,
    which the card makes a multiply by the reciprocal) would change is
    computed here, inline."""
    import torch

    from comfyui_video_stabilizer_tpu_torch.ops import resize as R
    from comfyui_video_stabilizer_tpu_torch.utils.video_io import normalize_video_input

    rng = np.random.default_rng(5)
    clips = {"uint8": torch.from_numpy(rng.integers(0, 256, (CLIP_FRAMES, HEIGHT, WIDTH, 3), dtype=np.uint8))}
    shaken = synth_clip(CLIP_FRAMES, HEIGHT, WIDTH, seed=4, device=device)
    clips["float 0..255"] = torch.round(shaken * 255.0).cpu()
    del shaken
    out = {}
    for name, clip in clips.items():
        cpu = normalize_video_input(clip, device="cpu").frames
        t0 = time.perf_counter()
        gpu = normalize_video_input(clip, device=device).frames
        torch.cuda.synchronize()
        norm_ms = 1e3 * (time.perf_counter() - t0)
        frames_equal = bool(torch.equal(gpu.cpu(), cpu))
        gray_gpu = R.gray_for_estimation(gpu, (960, 540))
        grays_equal = bool(torch.equal(gray_gpu.cpu(), R.gray_for_estimation(cpu, (960, 540))))
        del cpu
        unrepaired = clip.to(device).to(torch.float32) / 255.0
        moved = {"values": int((unrepaired != gpu).sum()), "gray pixels": 0,
                 "working gray pixels": int((R.gray_for_estimation(unrepaired, (960, 540)) != gray_gpu).sum())}
        for s in range(0, CLIP_FRAMES, 16):
            moved["gray pixels"] += int((R.make_gray(unrepaired[s:s + 16]) != R.make_gray(gpu[s:s + 16])).sum())
        del unrepaired, gpu, gray_gpu
        torch.cuda.empty_cache()
        log(f"[normalize] {name} clip ({CLIP_FRAMES}, {HEIGHT}, {WIDTH}, 3) on the card: frames torch.equal to the "
            f"CPU normalization {frames_equal}, 960x540 grays torch.equal {grays_equal}; {norm_ms:.1f} ms with the "
            f"upload; the unrepaired multiply would move {moved['values']} of {clip.numel()} values, "
            f"{moved['gray pixels']} full-size gray pixels ({moved['gray pixels'] / CLIP_FRAMES:.1f} a frame) and "
            f"{moved['working gray pixels']} working gray pixels")
        check(frames_equal and grays_equal, f"normalize, {name}: the card's normalization differs from the CPU's")
        out[name] = moved
    return out


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
    out = GF.gftt_scores_gray(g)
    ref = GF.gftt_gray_plain(g)
    torch.cuda.synchronize()
    keep = torch.isfinite(ref)
    equal = bool(torch.equal(out, ref))
    log(f"[K4] {tuple(g.shape)} from the gray: bitwise equal {equal} ({int(keep.sum())} scores kept by the NMS)")
    check(equal, "K4: the scores differ from the plain version")
    max_err = float((out[keep] - ref[keep]).abs().max()) if bool(keep.any()) else 0.0
    ms, plain_ms, tk, tp = timed_pair(lambda: GF.gftt_scores_gray(g), lambda: GF.gftt_gray_plain(g), 20, 3)

    def sobel_and_products():
        dx, dy = LK._conv2(g, LK._SOBEL_X), LK._conv2(g, LK._SOBEL_Y)
        return dx * dx, dx * dy, dy * dy

    glue_ms = cuda_ms(sobel_and_products, 5)
    # per pixel, counted on the shared tree: 16 for the two separable
    # Sobel gradients, 3 products, 3 products x 2 axes x 6 adds for the
    # box sums, 9 for the eigenvalue, 9 for the NMS; the gray in, the
    # scores out
    px = g.numel()
    b = bound(4 * 2 * px, px * (16 + 3 + 3 * 2 * 6 + 9 + 9))
    log(f"[K4] {tuple(g.shape)}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (runs {tk}, {tp}); "
        f"the Sobel and products it replaces (two _conv2 calls, three products) {glue_ms:.4f} ms; "
        f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}); no single PyTorch call computes it")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, **b, "library_ms": None}


def greedy_tests(top_idx, w: int, max_corners: int, min_distance: float) -> int:
    """The distance tests K7 makes on these candidates: each valid
    candidate it walks is tested against every corner accepted before it;
    the walk ends at max_corners (computed on the host from the plain
    greedy's acceptances, replayed in order)."""
    import torch

    from comfyui_video_stabilizer_tpu_torch.ops import greedy_cuda as GR

    top = top_idx.cpu()
    pts, counts = GR.greedy_plain(top, w, max_corners, min_distance)
    total = 0
    for f in range(top.shape[0]):
        n = int(counts[f])
        acc = set((pts[f, :n, 1].long() * w + pts[f, :n, 0].long()).tolist())
        taken = 0
        for idx in top[f].tolist():
            if taken >= max_corners:
                break
            if idx < 0:
                continue
            total += taken
            taken += idx in acc
    return total


def clustered_candidates(b: int, h: int, w: int, k: int, seed: int):
    """(b, k) int32 candidates on an h x w frame: every pixel within 5 px
    of 40 random centres, shuffled; most lie closer than 7 px to an
    earlier one."""
    rng = np.random.default_rng(seed)
    rows = []
    dy, dx = np.meshgrid(np.arange(-5, 6), np.arange(-5, 6), indexing="ij")
    for _ in range(b):
        cy, cx = rng.integers(5, h - 5, 40), rng.integers(5, w - 5, 40)
        idx = np.unique(((cy[:, None] + dy.ravel()) * w + cx[:, None] + dx.ravel()).ravel())
        rows.append(rng.permutation(idx)[:k])
    return np.stack(rows).astype(np.int32)


def grid_candidates(h: int, w: int, seed: int, repeats: int):
    """(1, K) int32 candidates: every point of a grid 8 px apart on an
    h x w frame (all accepted), shuffled, with the first ``repeats``
    repeated among the next ones (each rejected)."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation((np.arange(4, h, 8)[:, None] * w + np.arange(4, w, 8)[None, :]).ravel())
    return np.insert(idx, 20 + 8 * np.arange(repeats), idx[:repeats])[None, :].astype(np.int32)


def phase_k7(grays):
    """K7 (the corner greedy) torch.equal to its plain version and to the
    native greedy: on the Classic slice's (79, 2048) candidates from
    _topk_packed; on clustered candidates with max_corners 23, so every
    frame's walk ends partway through its candidates; on the slice's
    candidates with every tenth one a repeat of an earlier one; and with
    max_corners MAX_KERNEL_CORNERS on a grid of 8,202 candidates whose
    walk is cut inside a block.  Timed in turns with the plain version."""
    import torch

    from comfyui_video_stabilizer_tpu_torch.ops import greedy_cuda as GR
    from comfyui_video_stabilizer_tpu_torch.ops import lk as LK

    g = grays[:-1]
    B, H, W_ = g.shape
    top = LK._topk_packed(g, LK.TOP_K)
    repeats = top.clone()  # column i repeats column i - 9 where both are valid (the valid ones sort first)
    repeats[:, 10::10] = torch.where(top[:, 10::10] >= 0, top[:, 1:-9:10], top[:, 10::10])
    big_h, big_w = 512, 1024
    cases = [("the slice's candidates", top, H, W_, LK.MAX_CORNERS, None),
             ("clustered, max_corners 23", torch.from_numpy(clustered_candidates(B, H, W_, LK.TOP_K, 7)).to(g.device),
              H, W_, 23, 23),
             ("the slice's candidates, every tenth a repeat", repeats, H, W_, LK.MAX_CORNERS, None),
             (f"a grid on {big_w}x{big_h}, max_corners {GR.MAX_KERNEL_CORNERS}",
              torch.from_numpy(grid_candidates(big_h, big_w, 8, 10)).to(g.device), big_h, big_w,
              GR.MAX_KERNEL_CORNERS, GR.MAX_KERNEL_CORNERS)]
    for name, t, h, w, maxc, fills in cases:
        pts, counts = GR.greedy_min_distance(t, w, maxc, LK.MIN_DISTANCE)
        ref_pts, ref_counts = GR.greedy_plain(t, w, maxc, LK.MIN_DISTANCE)
        host_pts, host_counts = LK.greedy_host(t.cpu().numpy(), h, w, maxc)
        torch.cuda.synchronize()
        eq_plain = bool(torch.equal(pts, ref_pts)) and bool(torch.equal(counts, ref_counts))
        eq_host = bool(np.array_equal(pts.cpu().numpy(), host_pts)) and bool(
            np.array_equal(counts.cpu().numpy(), host_counts))
        log(f"[K7] {name} {tuple(t.shape)}: torch.equal to the plain version {eq_plain}, to the native greedy "
            f"{eq_host}; corners a frame min {int(counts.min())}, median {float(counts.float().median()):.0f}, "
            f"max {int(counts.max())}")
        check(eq_plain and eq_host, f"K7 ({name}): the corners differ from the plain version or the native greedy")
        check(fills is None or bool((counts == fills).all()), f"K7 ({name}): the walk did not fill max_corners")
    ms, plain_ms, tk, tp = timed_pair(lambda: GR.greedy_min_distance(top, W_, LK.MAX_CORNERS, LK.MIN_DISTANCE),
                                      lambda: GR.greedy_plain(top, W_, LK.MAX_CORNERS, LK.MIN_DISTANCE), 50, 1)
    # bytes: the candidates in, the corners and counts out; operations:
    # this run's distance tests, 6 each (two subtractions, two products,
    # an add, a compare)
    nbytes = 4 * top.numel() + 8 * B * LK.MAX_CORNERS + 4 * B
    tests = greedy_tests(top, W_, LK.MAX_CORNERS, LK.MIN_DISTANCE)
    b = bound(nbytes, 6 * tests)
    log(f"[K7] {tuple(top.shape)}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (runs {tk}, {tp}); "
        f"{nbytes} bytes ({1e3 * nbytes / PEAK_BYTES:.6f} ms at the memory rate), {tests} distance tests; "
        f"bound {b['bound_ms']:.6f} ms ({b['bound_by']}); the kernel waits on {LK.TOP_K // GR.KERNEL_BLOCK} dependent "
        f"blocks of {GR.KERNEL_BLOCK} candidates a frame; no single PyTorch call computes it")
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, **b, "library_ms": None}


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
            # a copy: the stack and the corners read once, the windows written once
            result.update(bound(4 * (src.numel() + corners.numel() + out.numel()), 0))
            result["library_ms"] = index_gather_ms(src, corners, wext)
            log(f"[K6] search: one advanced-index gather {result['library_ms']:.4f} ms; "
                f"bound {result['bound_ms']:.4f} ms ({result['bound_by']})")
        del out, ref
    return result


def index_gather_ms(stack, corners, wext: int) -> float:
    """One advanced-index gather of the windows from the zero-padded stack
    (the pad and the index tensor built beforehand, not timed)."""
    import torch
    import torch.nn.functional as F

    B, H, W_ = stack.shape
    flat_src = F.pad(stack, (wext, wext, wext, wext)).reshape(-1)
    hp, wp = H + 2 * wext, W_ + 2 * wext
    cy = torch.clamp(corners[..., 1].to(torch.int64) + wext, 0, H + wext)
    cx = torch.clamp(corners[..., 0].to(torch.int64) + wext, 0, W_ + wext)
    ar = torch.arange(wext, device=stack.device)
    rows = torch.arange(B, device=stack.device)[:, None, None] * hp + cy[..., None] + ar
    index = rows[..., :, None] * wp + (cx[..., None] + ar)[..., None, :]
    return cuda_ms(lambda: flat_src[index], 20)


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
    tracks_eq, status_eq, iters_eq = (bool(torch.equal(a, b)) for a, b in
                                      ((t_out, t_ref), (s_out, s_ref), (iters, iters_ref)))
    live = s_out & s_ref
    err = float((t_out - t_ref).abs()[live].max()) if bool(live.any()) else 0.0
    hist = torch.bincount(iters[runnable.reshape(-1)].long(), minlength=LK.MAX_ITERS + 1).tolist()
    log(f"[K5] level 0, {B} pairs x {F} features ({int(valid.sum())} valid, {int(runnable.sum())} runnable): "
        f"bitwise equal: raw solutions {bool(torch.equal(out, ref))}, tracks {tracks_eq}, status {status_eq}, "
        f"iterations {iters_eq}; live tracks {int(live.sum())}, max|kernel - plain| {err:.3e} px")
    log(f"[K5] iteration histogram of runnable features (index = iterations): {hist}")
    check(bool(torch.equal(out, ref)) and tracks_eq and status_eq and iters_eq,
          "K5: the tracks, status or iteration counts differ from the plain version")
    ms, plain_ms, tk, tp = timed_pair(lambda: LKC.lk_gn_iterate(*args, LK.MAX_ITERS, LK.EPS),
                                      lambda: LKC.lk_gn_plain(*args, LK.MAX_ITERS, LK.EPS), 10, 1)
    # data-dependent: this run's iterations x the operations of one (31 rows
    # x (3 + 31 x 11) for the blend, residual and products, 60 row-sum adds,
    # ~20 for the step and the stop rule); every input read once
    total_iters = int(iters.sum())
    nbytes = sum(4 * a.numel() for a in args) + 12 * n
    b = bound(nbytes, total_iters * (31 * (3 + 31 * 11) + 60 + 20))
    log(f"[K5] level 0 {n} features: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (runs {tk}, {tp}); "
        f"{total_iters} iterations in all; bound {b['bound_ms']:.4f} ms ({b['bound_by']}); "
        "no single PyTorch call computes it")
    return {"max_abs_err": float((out - ref).abs().max()), "ms": ms, "plain_ms": plain_ms, **b,
            "library_ms": None}


def classic_stage_split(frames, device):
    """One Classic estimation run eagerly stage by stage, a synchronize
    after each (ms)."""
    import torch

    from comfyui_video_stabilizer_tpu_torch.models import classic as CL
    from comfyui_video_stabilizer_tpu_torch.ops import gftt_cuda as GF
    from comfyui_video_stabilizer_tpu_torch.ops import greedy_cuda as GR
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
    raw = stage("K4 (gray -> scores)", lambda: GF.gftt_scores_gray(grays[:-1]))
    top = stage("threshold + sort", lambda: LK._top_candidates(raw, LK.TOP_K))
    del raw
    pts, counts = stage("K7 (greedy)", lambda: GR.greedy_min_distance(top, grays.shape[2], LK.MAX_CORNERS,
                                                                      LK.MIN_DISTANCE))
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
    fits = stage("fits", lambda: CL._fused_classic_fits_device(pts, g, valid, 0, False, RS.DEFAULT_HYPOTHESES))
    stage("fetch", lambda: CL._fetch_fits(counts, fits, False))
    mats = np.tile(np.eye(3, dtype=np.float32), (frames.shape[0], 1, 1))
    stage("padding mask", lambda: W.padding_mask_stats(mats, (WIDTH, HEIGHT), (WIDTH, HEIGHT), device)[1].cpu())
    stage("warp (K1)", lambda: W.warp_clip(frames, mats, (WIDTH, HEIGHT), "bilinear", (0.5, 0.5, 0.5)))
    return ms


LAST_PROFILE_NAMES: list = []  # the distinct device event names of profile_call's last call

# each hand kernel's __global__ function, as the profiler names its launches
KERNEL_SYMBOLS = {"warp": "warp_kernel", "warp_blur": "warp_blur_kernel", "cost_volume": "cost_volume_kernel",
                  "gftt": "gftt_gray_kernel", "lk_gn": "lk_gn_kernel", "extract_windows": "extract_kernel",
                  "greedy": "greedy_kernel", "padding_stats": "padding_stats_kernel",
                  "gray_pool": "gray_pool_kernel", "smallest_eigvec": "smallest_eigvec_kernel",
                  "solve8": "solve8_kernel", "homography_4pt": "homography_4pt_kernel"}


PROFILE_LOSSES: list = []  # (pads lost, ms of pad lost) for each device_events session


def device_events(fn):
    """(the device events -- kernels and copies -- torch.profiler records
    over one call of fn, wall ms).  Late in a long run the profiler drops
    the leading device records of each session, more the later the session
    (a fallback call's two leading grays once; all of 256 pads of 1,000
    cycles in another run; 0-8 records a session in a third), so a
    session starts with
    ``PROFILE_PAD`` spin kernels of ``PAD_CYCLES`` cycles each, which absorb
    that loss, whether it is a count of records or a span of time, and are
    left out of the result.  Each session's loss goes into PROFILE_LOSSES
    and is logged; a session that kept none of its pads may have dropped
    more, and fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_PAD):
            torch.cuda._sleep(PAD_CYCLES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    pads = [e for e in device if "spin_kernel" in e.name]
    check(len(pads) > 0, f"torch.profiler dropped all {PROFILE_PAD} leading pad kernels of its session")
    lost = PROFILE_PAD - len(pads)
    pad_ms = sum(e.time_range.elapsed_us() for e in pads) / 1e3 / len(pads)
    PROFILE_LOSSES.append((lost, lost * pad_ms))
    if lost:
        log(f"[profiler] session {len(PROFILE_LOSSES)} lost {lost} of its {PROFILE_PAD} leading pads "
            f"(~{lost * pad_ms:.2f} ms of {PROFILE_PAD * pad_ms:.2f} ms of pad)")
    return [e for e in device if "spin_kernel" not in e.name], wall


def profile_call(fn):
    """torch.profiler over one call: (device events -- kernels and copies
    --, device busy ms, wall ms); the distinct device event names are kept
    in LAST_PROFILE_NAMES.  Fails unless the profile holds one event for
    each hand-kernel launch the call made (a CUDA graph's replay counts
    its captured launches), so a profiler that drops events is caught
    where it drops a hand kernel's."""
    from comfyui_video_stabilizer_tpu_torch.ops import cuda_build

    before = dict(cuda_build.LAUNCHES)
    device, wall = device_events(fn)
    busy = sum(e.time_range.elapsed_us() for e in device) / 1e3
    LAST_PROFILE_NAMES[:] = sorted({e.name[:48] for e in device})
    for key, sym in KERNEL_SYMBOLS.items():
        launched = cuda_build.LAUNCHES[key] - before[key]
        seen = sum(1 for e in device if re.search(rf"(?:^|[\s:]){sym}[<(]", e.name))
        check(seen == launched, f"torch.profiler recorded {seen} {sym} events for {launched} launches")
    return len(device), busy, wall


def phase_classic(device, frames):
    import torch

    from comfyui_video_stabilizer_tpu_torch.models import fastpath as FP
    from comfyui_video_stabilizer_tpu_torch.ops import cuda_build

    ctx = make_context(frames)
    torch.cuda.synchronize()
    captures = FP.GRAPH_STATS["captures"]
    cuda_build.reset_launches()
    with served("classic", 1, "the Classic slice's first call"):
        run_classic(ctx, device)
    torch.cuda.synchronize()
    log(f"[classic] launches in the first stabilize_classic call (the graph's eager warm-up, its capture and one "
        f"replay): {dict(cuda_build.LAUNCHES)}")
    check(FP.GRAPH_STATS["captures"] == captures + 1, "the Classic slice's first call did not capture its CUDA graph")
    replays = FP.GRAPH_STATS["replays"]
    cuda_build.reset_launches()
    with served("classic", 1, "the Classic slice"):
        res = run_classic(ctx, device)
    torch.cuda.synchronize()
    launches = dict(cuda_build.LAUNCHES)
    log(f"[classic] launches in one warm stabilize_classic call (one graph replay): {launches}")
    check(FP.GRAPH_STATS["replays"] == replays + 1, "the Classic estimation did not run from its CUDA graph")
    check(launches["gftt"] >= 1, "K4 was not launched by the Classic slice")
    check(launches["greedy"] >= 1, "K7 was not launched by the Classic slice")
    check(launches["lk_gn"] >= 4, "K5 was launched fewer than 4 times by the Classic slice")
    check(launches["extract_windows"] >= 8, "K6 was launched fewer than 8 times by the Classic slice")
    check(launches["warp"] >= 1, "K1 was not launched by the Classic slice")
    check(launches["padding_stats"] == 1 and launches["gray_pool"] == 1,
          f"the Classic warm call launched K8 {launches['padding_stats']} and K9 {launches['gray_pool']} times, not once")
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
    with served("classic", 5, "the Classic slice's warm calls"):
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
    with served("classic", 1, "the Classic slice's profiled call"):
        n_kernels, busy, wall = profile_call(lambda: run_classic(ctx, device))
    log(f"[classic] torch.profiler over one call: {n_kernels} device events, device busy {busy:.1f} ms "
        f"of {wall:.1f} ms wall (busy share {busy / wall:.2f} under the profiler); "
        f"{len(LAST_PROFILE_NAMES)} kernel and copy names")
    split = [classic_stage_split(frames, device) for _ in range(3)]
    log("[classic] eager stage split, ms (median of 3, synchronize after each stage): " + ", ".join(
        f"{k} {float(np.median([s[k] for s in split])):.2f}" for k in split[0]))

    n, h, w = BASELINE1
    small = synth_clip(n, h, w, seed=1, device=device)
    sctx = make_context(small)
    with served("classic", 2, "BASELINE config 1"):
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


def shake_meta(style: str, seed: int, n: int, h: int, w: int) -> dict:
    """BASELINE configs 2 and 4: a generated shake at 24 fps, amount 1, speed 1."""
    from comfyui_video_stabilizer_tpu_torch.models.shake import STYLES, generate_shake_motion_meta

    return {"motion_meta": generate_shake_motion_meta(
        recipe=STYLES[style], frame_count=n, width=w, height=h, fps=24.0,
        amount=1.0, speed=1.0, seed=seed, style=style)}


def run_apply(ctx, meta, device, framing="crop_and_pad", interp="bicubic", blur=0.5, samples=33):
    from comfyui_video_stabilizer_tpu_torch.models.motion_apply import apply_motion

    return apply_motion(ctx, meta, (127, 127, 127), framing_mode=framing, interpolation=interp,
                        motion_blur=blur, motion_blur_samples=samples, device=device)


def sample_coeffs(meta, samples: int, device, framing: str = "crop_and_pad"):
    """The (N, S, 8) float32 K3 coefficients apply_motion makes for blur 0.5
    under ``framing``, and the output size (width, height)."""
    import torch

    from comfyui_video_stabilizer_tpu_torch.meta.motion_meta import resolve_motion_meta
    from comfyui_video_stabilizer_tpu_torch.models import motion_apply as MA
    from comfyui_video_stabilizer_tpu_torch.ops import warp as W

    motion = resolve_motion_meta(meta)
    mats, out_size = motion.matrices(), motion.output_size
    if framing == "crop":
        common = MA.common_valid_mask(motion.input_size, out_size, mats, device)
        mats = np.einsum("ij,njk->nik", MA.center_crop_matrix_from_common(common, out_size), mats)
    elif framing == "expand":
        mats, out_size = MA.expand_matrices(mats, motion.input_size)
    sm = MA.blurred_sample_matrices(mats, 0.5, samples)
    n = sm.shape[0]
    coeffs = W.prepare_inverse_coeffs(sm.reshape(n * samples, 3, 3)).reshape(n, samples, 8)
    return torch.as_tensor(coeffs.astype(np.float32), device=device), out_size


def k3_global_share(frames, coeffs, border, out_size, interp="bicubic"):
    """(share of K3's tiles that staged nothing, share of its pixel-samples
    whose taps were read from device memory) for one call."""
    import torch

    from comfyui_video_stabilizer_tpu_torch.ops import warp as W

    out_w, out_h = out_size
    stats = torch.zeros(3, dtype=torch.int64, device=frames.device)
    W.warp_blur_frames(frames, coeffs, border, out_h, out_w, interp, True, stats=stats)
    n, s = coeffs.shape[:2]
    tiles, tiles_global, samples_global = (int(v) for v in stats.cpu())
    return tiles_global / tiles, samples_global / (n * out_h * out_w * s)


def phase_k3(device, frames, meta4):
    """K3 with its soft mask against the plain version, frames and mask
    bitwise: 8 frames of 1080p (bicubic S = 33, bilinear S = 5), then the
    Motion Apply slice's own inputs (80 frames, bicubic, S = 33), where
    the JSON line's times are taken."""
    import torch

    from comfyui_video_stabilizer_tpu_torch.ops import warp as W

    border = torch.full((3,), 127 / 255.0, device=device)
    max_err = 0.0

    def held(out, mask, ref, ref_mask, what):
        err = float((out - ref).abs().max())
        check(bool(torch.isfinite(out).all()), f"K3 {what}: non-finite output")
        check(err <= K3_TOL, f"K3 {what}: max|kernel - plain| {err} > {K3_TOL}")
        check(bool(torch.equal(mask, ref_mask)), f"K3 {what}: the mask differs from the plain version")
        return err

    for interp, s in (("bicubic", 33), ("bilinear", 5)):
        small = frames[:8].contiguous()
        coeffs = sample_coeffs(meta4, s, device)[0][:8].contiguous()
        ref, ref_mask = W.warp_blur_mask_plain(small, coeffs, border, HEIGHT, WIDTH, interp)
        out, mask = W.warp_blur_frames(small, coeffs, border, HEIGHT, WIDTH, interp, True)
        torch.cuda.synchronize()
        max_err = max(max_err, held(out, mask, ref, ref_mask, f"{interp} S={s}"))
        del out, mask, ref, ref_mask
        ms, plain_ms, tk, tp = timed_pair(
            lambda: W.warp_blur_frames(small, coeffs, border, HEIGHT, WIDTH, interp, True),
            lambda: W.warp_blur_mask_plain(small, coeffs, border, HEIGHT, WIDTH, interp), 10, 1)
        nchw = small.permute(0, 3, 1, 2).contiguous()
        lib = sum(grid_sample_ms(nchw, coeffs[:, k].contiguous(), HEIGHT, WIDTH, 3, interp) for k in range(s))
        del nchw
        log(f"[K3] (8, {HEIGHT}, {WIDTH}, 3) {interp} S={s}: frames and mask bitwise equal; "
            f"kernel with mask {ms:.3f} ms, plain {plain_ms:.3f} ms (runs {tk}, {tp}); "
            f"{s} {interp} grid_sample calls {lib:.3f} ms")

    coeffs, _ = sample_coeffs(meta4, 33, device)
    out, mask = W.warp_blur_frames(frames, coeffs, border, HEIGHT, WIDTH, "bicubic", True)
    ref, ref_mask = W.warp_blur_mask_plain(frames, coeffs, border, HEIGHT, WIDTH, "bicubic")
    torch.cuda.synchronize()
    max_err = max(max_err, held(out, mask, ref, ref_mask, "at the config 4 inputs"))
    soft = float(((mask > 0) & (mask < 1)).float().mean())
    del out, mask, ref, ref_mask

    def fused(with_mask=True):
        return lambda: W.warp_blur_frames(frames, coeffs, border, HEIGHT, WIDTH, "bicubic", with_mask)

    def plain():
        return W.warp_blur_mask_plain(frames, coeffs, border, HEIGHT, WIDTH, "bicubic")

    # plain, kernel, kernel, plain: the plain version (~11 s a call) unwarmed
    t_plain = [cuda_ms(plain, 1, warm=False)]
    t_kernel = [cuda_ms(fused(), 5) for _ in range(2)]
    t_plain.append(cuda_ms(plain, 1, warm=False))
    t_frames_only = cuda_ms(fused(with_mask=False), 5)
    ms, plain_ms = min(t_kernel), min(t_plain)
    nchw = frames.permute(0, 3, 1, 2).contiguous()
    library_ms = sum(grid_sample_ms(nchw, coeffs[:, k].contiguous(), HEIGHT, WIDTH, 2, "bicubic")
                     for k in range(33))
    del nchw
    b = warp_bound(CLIP_FRAMES, HEIGHT, WIDTH, 3, HEIGHT, WIDTH, "bicubic", samples=33, mask=True)
    no_fma_ms = 1e3 * warp_ops(CLIP_FRAMES, HEIGHT, WIDTH, 3, "bicubic", 33, True) / NO_FMA_FLOPS
    log(f"[K3] ({CLIP_FRAMES}, {HEIGHT}, {WIDTH}, 3) bicubic S=33 (the config 4 inputs): frames and mask "
        f"bitwise equal; soft-mask share {soft:.5f}; kernel with mask {ms:.3f} ms "
        f"(runs {t_kernel}), without the mask {t_frames_only:.3f} ms; plain with mask {plain_ms:.1f} ms (runs {t_plain}); 33 bicubic grid_sample "
        f"calls {library_ms:.3f} ms; bound {b['bound_ms']:.3f} ms ({b['bound_by']}), "
        f"{no_fma_ms:.3f} ms at the no-FMA rate")
    for framing in ("crop_and_pad", "crop", "expand"):
        fc, out_size = sample_coeffs(meta4, 33, device, framing)
        tiles, samples = k3_global_share(frames, fc, border, out_size)
        log(f"[K3] config 4 {framing} ({out_size[0]}x{out_size[1]}): tiles that staged nothing {tiles:.6f}, "
            f"pixel-samples read from device memory {samples:.6f}")
        del fc
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, **b, "library_ms": library_ms}


def apply_stage_split(device, ctx, meta):
    """One config 4 call's device stages, a synchronize after each (ms)."""
    import torch

    from comfyui_video_stabilizer_tpu_torch.models.motion_apply import resolve_motion_for_context
    from comfyui_video_stabilizer_tpu_torch.ops import warp as W

    ms = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms[name] = 1e3 * (time.perf_counter() - t0)
        return out

    stage("resolve meta", lambda: resolve_motion_for_context(meta, ctx))
    coeffs, _ = stage("samples + coeffs (host) + upload", lambda: sample_coeffs(meta, 33, device))
    border = torch.full((3,), 127 / 255.0, device=device)
    stage("K3 with the soft mask", lambda: W.warp_blur_frames(ctx.frames, coeffs, border, HEIGHT, WIDTH,
                                                               "bicubic", True))
    return ms


def phase_motion_apply(device, frames, meta4):
    """BASELINE config 4 on the 1080p x 80 clip, then crop and expand."""
    import torch

    from comfyui_video_stabilizer_tpu_torch.ops import cuda_build
    from comfyui_video_stabilizer_tpu_torch.ops import warp as W

    ctx = make_context(frames)
    # count the plain soft mask's passes: the CUDA path must take none
    coverage_calls = []
    plain_mask = W._coverage_mean
    W._coverage_mean = lambda *a: coverage_calls.append(1) or plain_mask(*a)
    torch.cuda.synchronize()
    cuda_build.reset_launches()
    try:
        res = run_apply(ctx, meta4, device)
        torch.cuda.synchronize()
    finally:
        W._coverage_mean = plain_mask
    launches = dict(cuda_build.LAUNCHES)
    log(f"[apply] launches in one apply_motion call (config 4): {launches}; "
        f"plain soft-mask calls {len(coverage_calls)}")
    check(launches["warp_blur"] == 1, f"K3 launched {launches['warp_blur']} times, not once")
    check(launches["warp"] == 0, f"K1 launched {launches['warp']} times by the blur path")
    check(not coverage_calls, "the CUDA path computed the soft mask outside K3")
    check(tuple(res.frames.shape) == (CLIP_FRAMES, HEIGHT, WIDTH, 3), f"frames {tuple(res.frames.shape)}")
    check(tuple(res.masks.shape) == (CLIP_FRAMES, HEIGHT, WIDTH), f"masks {tuple(res.masks.shape)}")
    check(res.frames.device.type == "cuda" and res.masks.device.type == "cuda", "outputs left the card")
    check(bool(torch.isfinite(res.frames).all()), "non-finite frames")
    check(bool(((res.masks >= 0) & (res.masks <= 1)).all()), "masks outside [0, 1]")
    soft = float(((res.masks > 0) & (res.masks < 1)).float().mean())
    block = res.meta["motion_apply"]
    check(block["motion_blur_samples"] == 33 and block["interpolation"] == "bicubic", f"meta {block}")
    log(f"[apply] soft-mask share {soft:.5f}, padded share {float(res.masks.mean()):.5f}")
    del res

    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_apply(ctx, meta4, device)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        del out
    fps = [CLIP_FRAMES / t for t in times]
    log(f"[apply] warm apply_motion config 4 (1080p x {CLIP_FRAMES}, bicubic, blur 0.5, 33 samples): "
        f"{', '.join(f'{f:.1f}' for f in fps)} f/s; best {max(fps):.1f}, median {float(np.median(fps)):.1f}; "
        f"{', '.join(f'{1e3 * t:.1f}' for t in times)} ms; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    n_events, busy, wall = profile_call(lambda: run_apply(ctx, meta4, device))
    log(f"[apply] torch.profiler over one call: {n_events} device events (12,892 with the plain soft mask), "
        f"device busy {busy:.1f} ms of {wall:.1f} ms wall (busy share {busy / wall:.2f} under the profiler); "
        f"{LAST_PROFILE_NAMES}")
    check(0 < n_events < 1000, f"config 4 made {n_events} device events")
    split = [apply_stage_split(device, ctx, meta4) for _ in range(3)]
    med = {k: float(np.median([s[k] for s in split])) for k in split[0]}
    rest = 1e3 * float(np.median(times)) - sum(med.values())
    log("[apply] stage split, ms (median of 3, synchronize after each stage): " + ", ".join(
        f"{k} {v:.2f}" for k, v in med.items()) + f"; the rest of the median call {rest:.2f}")

    for framing in ("crop", "expand"):
        cuda_build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_apply(ctx, meta4, device, framing=framing)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        block = res.meta["motion_apply"]
        ow, oh = block["output_size"]
        check(tuple(res.frames.shape) == (CLIP_FRAMES, oh, ow, 3), f"{framing}: frames {tuple(res.frames.shape)}")
        check(tuple(res.masks.shape) == (CLIP_FRAMES, oh, ow), f"{framing}: masks {tuple(res.masks.shape)}")
        check(bool(torch.isfinite(res.frames).all()), f"{framing}: non-finite frames")
        check(cuda_build.LAUNCHES["warp_blur"] == 1, f"{framing}: K3 launches {cuda_build.LAUNCHES}")
        if framing == "crop":
            check(block["framing_mode"] == "crop" and "framing_fallback" not in res.meta,
                  f"crop fell back: {block['framing_mode']}")
            check(float(res.masks.max()) == 0.0, "crop: masks not all zero")
        else:
            check(block["framing_mode"] == "expand" and ow >= WIDTH and oh >= HEIGHT,
                  f"expand: canvas {ow}x{oh}")
            check(bool(((res.masks >= 0) & (res.masks <= 1)).all()), "expand: masks outside [0, 1]")
        log(f"[apply] {framing}: status {block['framing_mode']}, output {ow}x{oh}, one call {1e3 * secs:.1f} ms")
        del res
    return launches, fps


def phase_config2(device):
    """BASELINE config 2: handheld shake, seed 7, 1280x720 x 80, bilinear,
    no blur (K1); two calls must give bitwise-equal frames."""
    import torch

    from comfyui_video_stabilizer_tpu_torch.ops import cuda_build

    n, h, w = BASELINE2
    clip = synth_clip(n, h, w, seed=7, device=device)
    meta = shake_meta("handheld", 7, n, h, w)
    ctx = make_context(clip)
    torch.cuda.synchronize()
    cuda_build.reset_launches()
    a = run_apply(ctx, meta, device, interp="bilinear", blur=0.0)
    torch.cuda.synchronize()
    launches = dict(cuda_build.LAUNCHES)
    check(launches["warp"] == 1 and launches["warp_blur"] == 0, f"config 2 launches {launches}")
    b = run_apply(ctx, meta, device, interp="bilinear", blur=0.0)
    torch.cuda.synchronize()
    check(bool(torch.equal(a.frames, b.frames)) and bool(torch.equal(a.masks, b.masks)),
          "config 2: two calls differ")
    check(bool(torch.isfinite(a.frames).all()), "config 2: non-finite frames")
    del a, b
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_apply(ctx, meta, device, interp="bilinear", blur=0.0)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    log(f"[config2] {w}x{h} x {n}, handheld seed 7, bilinear, no blur: launches {launches}; "
        f"deterministic (bitwise); warm calls {', '.join(f'{1e3 * t:.1f}' for t in times)} ms, "
        f"{', '.join(f'{n / t:.1f}' for t in times)} f/s")


def phase_apply_reference(device):
    """Motion Apply, CUDA path against CPU path, on a small clip."""
    import torch

    frames = synth_clip(8, 144, 192, seed=9, device="cpu")
    meta = shake_meta("action", 3, 8, 144, 192)
    for blur in (0.0, 0.5):
        cpu = run_apply(make_context(frames), meta, "cpu", blur=blur)
        gpu = run_apply(make_context(frames.to(device)), meta, device, blur=blur)
        d = (cpu.frames - gpu.frames.cpu()).abs().flatten()
        p99 = float(torch.quantile(d[:: max(1, d.numel() // 1_000_000)], 0.99))
        unequal = float((cpu.masks != gpu.masks.cpu()).float().mean())
        log(f"[apply reference] 8x144x192, bicubic, blur {blur}: frames p99 {p99:.3e}, max {float(d.max()):.3e}; "
            f"masks unequal on {unequal:.2e} of pixels")
        check(p99 <= APPLY_FRAME_P99, f"blur {blur}: frames p99 {p99}")
        check(unequal <= APPLY_MASK_UNEQUAL, f"blur {blur}: masks unequal on {unequal}")


def phase_motion_nodes(frames_cpu):
    """The Motion Apply, Inverse and both Shake Generator nodes on CPU tensors."""
    import torch

    from comfyui_video_stabilizer_tpu_torch import nodes
    from comfyui_video_stabilizer_tpu_torch.meta.motion_meta import build_stabilization_warp_meta

    n = frames_cpu.shape[0]
    t0 = time.perf_counter()
    shake = nodes.VideoStabilizerShakeGenerator.execute(frames_cpu, 24.0, "action", 1.0, 1.0, 3)[0]
    manual = nodes.VideoStabilizerShakeGeneratorManual.execute(
        frames_cpu, 24.0, 0.4, 0.33, 0.5, 0.003, 0.35, 0.35, 5.0, 0.0, 0.0, 0.3, 60.0, 1.0, 1.0, 7)[0]
    secs_shake = time.perf_counter() - t0
    for m in (shake, manual):
        block = m["motion_meta"]
        check(block["frame_count"] == n and block["input_size"] == [WIDTH, HEIGHT], f"shake meta {block['input_size']}")
    t0 = time.perf_counter()
    video, mask, meta = nodes.VideoStabilizerMotionApply.execute(
        frames_cpu, shake, "crop_and_pad", "bicubic", "#7F7F7F", 0.5, "Ultra")
    secs_apply = time.perf_counter() - t0
    check(isinstance(video, torch.Tensor) and video.device.type == "cpu" and video.is_contiguous(),
          "Motion Apply node frames not a contiguous CPU tensor")
    check(tuple(video.shape) == (n, HEIGHT, WIDTH, 3) and tuple(mask.shape) == (n, HEIGHT, WIDTH),
          f"Motion Apply node {tuple(video.shape)} {tuple(mask.shape)}")
    check(bool(torch.isfinite(video).all()) and bool(((mask >= 0) & (mask <= 1)).all()),
          "Motion Apply node outputs out of range")
    check(meta["motion_apply"]["motion_blur_quality"] == "Ultra", "Motion Apply node meta")
    mats = np.array([e["matrix"] for e in manual["motion_meta"]["per_frame"]], np.float32)
    legacy = {"stabilization_warp": build_stabilization_warp_meta(
        source_size=(WIDTH, HEIGHT), output_size=(WIDTH, HEIGHT), framing_mode="crop_and_pad",
        applied_matrices=mats)}
    shaken = nodes.VideoStabilizerMotionApply.execute(
        frames_cpu, manual, "crop_and_pad", "bilinear", "#7F7F7F", 0.0, "Standard")[0]
    t0 = time.perf_counter()
    restored, rmask, rmeta = nodes.VideoStabilizerInverse.execute(shaken, legacy, "#7F7F7F")
    secs_inverse = time.perf_counter() - t0
    check(tuple(restored.shape) == (n, HEIGHT, WIDTH, 3) and restored.device.type == "cpu",
          f"Inverse node {tuple(restored.shape)}")
    check("inverse_stabilization" in rmeta and "motion_apply" not in rmeta, "Inverse node meta")
    valid = rmask < 0.5
    err = (restored - frames_cpu).abs()[valid]
    log(f"[nodes] on CPU tensors ({n}, {HEIGHT}, {WIDTH}, 3): both shake generators {secs_shake:.3f} s; "
        f"Motion Apply (bicubic, Ultra blur) {secs_apply:.3f} s; Inverse {secs_inverse:.3f} s "
        f"(round trip of a bilinear shake: mean |err| {float(err.mean()):.4f} on {float(valid.float().mean()):.3f} "
        "of the pixels)")


def run_stabilizer(kind, ctx, device, framing="crop_and_pad", transform="similarity", lock=False,
                   fps=30.0):
    """stabilize_flow or stabilize_classic at strength 0.8, smooth 0.6,
    keep_fov 0.6, padding (127, 127, 127)."""
    from comfyui_video_stabilizer_tpu_torch.models.classic import stabilize_classic
    from comfyui_video_stabilizer_tpu_torch.models.flow import stabilize_flow

    fn = stabilize_flow if kind == "flow" else stabilize_classic
    res = fn(ctx, framing, transform, lock, 0.8, 0.6, 0.6, (127, 127, 127), fps, device=device)
    if kind == "flow":
        check(res.meta["flow_backend"] == "DIS",
              f"flow_backend {res.meta['flow_backend']!r} ({res.meta['flow_fallback_reason']})")
    return res


def mode_counts(meta) -> dict:
    counts: dict = {}
    for t in meta["estimated_motion"]["per_transition"]:
        counts[t["mode"]] = counts.get(t["mode"], 0) + 1
    return counts


def flow_stage_split(clip, device, transform, mats, out_size):
    """One Flow call's device work stage by stage, a synchronize after each
    (ms): the gray ingest (16-frame chunks, uploads when the clip is on
    the host), DIS, the fits with their host fetch, and the warp with its
    masks for ``mats`` (streamed past the budget).  The host trajectory
    and meta between the fits and the warp are left out."""
    import torch

    from comfyui_video_stabilizer_tpu_torch.models import flow as FL
    from comfyui_video_stabilizer_tpu_torch.models.stabilize import estimation_plan
    from comfyui_video_stabilizer_tpu_torch.ops import flow_dis as FD
    from comfyui_video_stabilizer_tpu_torch.ops import ransac as RS
    from comfyui_video_stabilizer_tpu_torch.ops import resize as R
    from comfyui_video_stabilizer_tpu_torch.ops import warp as W

    ms = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms[name] = round(1e3 * (time.perf_counter() - t0), 2)
        return out

    _, h, w, _ = clip.shape
    working, dec = estimation_plan(w, h, FL.flow_estimator)
    grays = stage("gray ingest", lambda: R.gray_for_estimation(clip, working, decimation=dec, device=device))
    persp = transform == "perspective"
    samples = stage("DIS", lambda: FD.dis_flow_fit(grays, FL.SAMPLE_STEP // dec,
                                                  finest_scale=0 if dec > 1 else FD.FINEST_SCALE,
                                                  model="homography" if persp else "similarity"))
    pts = FL._grid_points(grays.shape[1] * dec, grays.shape[2] * dec, FL.SAMPLE_STEP, device)
    stage("fits + host fetch", lambda: FL._fused_fits_sampled(samples * float(dec), pts, 0, persp,
                                                              RS.DEFAULT_HYPOTHESES))
    del grays, samples
    stage("warp + mask", lambda: W.warp_clip_with_mask(clip, mats, out_size, "bilinear", (0.5, 0.5, 0.5),
                                                       device=device))
    return ms


def phase_crop(device, frames):
    """Crop framing (keep_fov 0.6) of Flow and Classic on the 1080p x 80
    clip through the fast path and through the host engine
    (CVST_FASTPATH=0: models/framing.py's keep_fov search and no-padding
    refine on the card), then the CUDA path against the CPU path on a
    small clip, crop and perspective, Flow and Classic, each engine on
    both devices."""
    import torch

    from comfyui_video_stabilizer_tpu_torch.ops import cuda_build

    engines = (("fast path", "1"), ("host engine", "0"))
    ctx = make_context(frames)
    for kind in ("flow", "classic"):
        for engine, flag in engines:
            torch.cuda.synchronize()
            cuda_build.reset_launches()
            t0 = time.perf_counter()
            with env(CVST_FASTPATH=flag), served(kind, int(flag), f"crop {kind} ({engine})"):
                res = run_stabilizer(kind, ctx, device, framing="crop")
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            fr, meta = res.meta["framing"], res.meta
            check(tuple(res.frames.shape) == (CLIP_FRAMES, HEIGHT, WIDTH, 3),
                  f"crop {kind}: frames {tuple(res.frames.shape)}")
            check(res.frames.device.type == "cuda" and bool(torch.isfinite(res.frames).all()), f"crop {kind}: frames")
            check(cuda_build.LAUNCHES["warp"] >= 1, f"crop {kind} ({engine}): K1 was not launched")
            refined = fr["keep_fov_effective"] == 1.0
            log(f"[crop] {kind} 1080p x {CLIP_FRAMES}, keep_fov 0.6, {engine}: status {fr['keep_fov_status']}, "
                f"scale {fr['stabilization_scale']}, crop origin {fr['crop_origin']} size {fr['crop_size']}, refine "
                f"{'succeeded' if refined else 'bailed'}, note {fr.get('keep_fov_note')!r}; padding max "
                f"{meta['padding_fraction_max']}, strength_effective {meta['strength_effective']}; one call "
                f"{1e3 * secs:.1f} ms; launches {dict(cuda_build.LAUNCHES)}")
            check(fr["keep_fov_status"] in ("met", "clamped", "failed", "disabled"), f"crop {kind}: status")
            if refined:
                check(meta["padding_fraction_max"] == 0.0 and float(res.masks.max()) == 0.0,
                      f"crop {kind} ({engine}): padding remains after a successful refine")
            del res

    small = synth_clip(8, 144, 192, seed=9, device="cpu")
    for kind in ("flow", "classic"):
        for (framing, transform), (engine, flag) in itertools.product(
                (("crop", "similarity"), ("crop_and_pad", "perspective")), engines):
            with env(CVST_FASTPATH=flag), served(kind, 2 * int(flag), f"crop reference {kind} ({engine})"):
                cpu = run_stabilizer(kind, make_context(small), "cpu", framing, transform)
                gpu = run_stabilizer(kind, make_context(small.to(device)), device, framing, transform)
            pc = [t["mode"] for t in cpu.meta["estimated_motion"]["per_transition"]]
            pg = [t["mode"] for t in gpu.meta["estimated_motion"]["per_transition"]]
            mc = np.array([t["matrix"] for t in cpu.meta["estimated_motion"]["per_transition"]])
            mg = np.array([t["matrix"] for t in gpu.meta["estimated_motion"]["per_transition"]])
            fc, fg = cpu.meta["framing"], gpu.meta["framing"]
            d = (cpu.frames - gpu.frames.cpu()).abs().flatten()
            p99 = float(torch.quantile(d[:: max(1, d.numel() // 1_000_000)], 0.99))
            mat_err = float(np.abs(mc - mg).max())
            log(f"[crop reference] {kind} {framing} {transform} 8x144x192, {engine}, CUDA vs CPU path: modes {pg} "
                f"(equal {pc == pg}), matrices max|d| {mat_err:.3e}, frames p99 {p99:.3e}; status "
                f"{fg.get('keep_fov_status')} / {fc.get('keep_fov_status')}, scale {fg.get('stabilization_scale')} "
                f"/ {fc.get('stabilization_scale')}")
            check(pc == pg, f"{kind} {framing} {transform}: per-pair modes differ")
            check(mat_err <= SMALL_MAT_TOL and p99 <= SMALL_FRAME_P99, f"{kind} {framing} {transform}: outputs differ")
            for key in ("keep_fov_status", "keep_fov_note", "stabilization_scale"):
                check(fc.get(key) == fg.get(key), f"{kind} {framing}: {key} differs: {fg.get(key)!r} vs {fc.get(key)!r}")


def phase_config3(device, frames):
    """BASELINE config 3: Flow, 1280x720 x 128, crop_and_pad, perspective,
    camera_lock, 24 fps; then Classic perspective once on the 1080p clip."""
    import torch

    from comfyui_video_stabilizer_tpu_torch.ops import cuda_build

    n, h, w = BASELINE3
    clip = synth_clip(n, h, w, seed=3, device=device)
    ctx = make_context(clip)
    for engine, flag in (("host engine", "0"), ("fast path", "1")):
        torch.cuda.synchronize()
        cuda_build.reset_launches()
        t0 = time.perf_counter()
        with env(CVST_FASTPATH=flag), served("flow", int(flag), f"config 3 ({engine})"):
            res = run_stabilizer("flow", ctx, device, "crop_and_pad", "perspective", lock=True, fps=24.0)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(cuda_build.LAUNCHES)
        modes = mode_counts(res.meta)
        check(tuple(res.frames.shape) == (n, h, w, 3) and bool(torch.isfinite(res.frames).all()),
              f"config 3 ({engine}): frames")
        check(res.meta["camera_lock"] is True and launches["warp"] >= 1 and launches["cost_volume"] >= 4,
              f"config 3 ({engine}): launches {launches}")
        check(modes.get("perspective", 0) > 0, f"config 3 ({engine}): no pair kept the perspective fit: {modes}")
        log(f"[config3] Flow {w}x{h} x {n}, perspective + camera_lock, {engine}: per-pair modes {modes}, applied "
            f"{res.meta['transform_mode_applied']}; launches K1 {launches['warp']}, K2 {launches['cost_volume']}; "
            f"one call {1e3 * secs:.1f} ms")
        res_mats = res.meta["stabilization_warp"]["per_frame"]
        del res
    times = []
    with served("flow", 3, "config 3's warm calls"):
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_stabilizer("flow", ctx, device, "crop_and_pad", "perspective", lock=True, fps=24.0)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    fps = [n / t for t in times]
    log(f"[config3] Flow {w}x{h} x {n}, perspective + camera_lock, 24 fps, fast path: per-pair modes {modes}; "
        f"launches K1 {launches['warp']}, K2 {launches['cost_volume']}; warm {', '.join(f'{f:.1f}' for f in fps)} "
        f"f/s, median {float(np.median(fps)):.1f}")
    sim = []
    with served("flow", 3, "config 3 with similarity"):
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_stabilizer("flow", ctx, device, "crop_and_pad", "similarity", lock=True, fps=24.0)
            torch.cuda.synchronize()
            sim.append(n / (time.perf_counter() - t0))
    mats = np.array([e["applied_matrix"] for e in res_mats])
    split = {t: flow_stage_split(clip, device, t, mats, (w, h)) for t in ("perspective", "similarity")}
    log(f"[config3] the same call with similarity: warm {', '.join(f'{f:.1f}' for f in sim)} f/s, median "
        f"{float(np.median(sim)):.1f}; stage split (ms, synchronize after each) perspective {split['perspective']}, "
        f"similarity {split['similarity']}")
    del ctx, clip

    ctx = make_context(frames)
    for engine, flag in (("fast path", "1"), ("host engine", "0")):
        torch.cuda.synchronize()
        cuda_build.reset_launches()
        t0 = time.perf_counter()
        with env(CVST_FASTPATH=flag), served("classic", int(flag), f"Classic perspective ({engine})"):
            res = run_stabilizer("classic", ctx, device, "crop_and_pad", "perspective")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        check(bool(torch.isfinite(res.frames).all()), f"Classic perspective ({engine}): non-finite frames")
        check(cuda_build.LAUNCHES["warp"] >= 1 and cuda_build.LAUNCHES["lk_gn"] >= 4,
              f"Classic perspective ({engine}): launches {dict(cuda_build.LAUNCHES)}")
        log(f"[config3] Classic perspective 1080p x {CLIP_FRAMES}, {engine}: per-pair modes {mode_counts(res.meta)}, "
            f"applied {res.meta['transform_mode_applied']}; one call {1e3 * secs:.1f} ms "
            f"({'its graph captured in this call' if flag == '1' else 'warm fits'}); launches {dict(cuda_build.LAUNCHES)}")
        del res
    return launches


# K10's operations: a rotation test (three abs, two square roots, two
# products, the compare), a rotation (theta 3, t 6, c 4, s 1; seven rows
# of A x 6; the diagonal 4; nine rows of V x 6) and the pick of the
# smallest of nine diagonal entries
K10_TEST_OPS, K10_ROTATION_OPS, K10_PICK_OPS = 8, 114, 8
# K11's operations a system: the pivot search 64, the reciprocals and
# their test 16, the elimination 364, the back substitution 64; the
# 4-point entry's construction adds 88 (four points' two negations and
# four products, and the ridge added to 64 entries)
K11_SYSTEM_OPS = 508
K11_4PT_BUILD_OPS = 88


def record_linalg_inputs(run):
    """[(kernel name, cloned arguments)] of every K10 and K11 call that one
    eager (CVST_FUSED=0) call of ``run`` makes, in order."""
    from comfyui_video_stabilizer_tpu_torch.ops import linalg_cuda as LA

    seen = []
    real = {"smallest_eigvec": LA.smallest_eigvec, "solve8": LA.solve8,
            "solve_homography_4pt": LA.solve_homography_4pt}

    def spy(name):
        def wrapper(*args):
            seen.append((name, tuple(a.clone() for a in args)))
            return real[name](*args)
        return wrapper

    try:
        for name in real:
            setattr(LA, name, spy(name))
        with env(CVST_FUSED="0"):
            run()
    finally:
        for name, fn in real.items():
            setattr(LA, name, fn)
    return seen


def same_nan(a, b) -> bool:
    """torch.equal, NaN where NaN."""
    import torch

    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(nan_a, nan_b)) and bool(torch.equal(a[~nan_a], b[~nan_b]))


def library_ms(fn, reps: int) -> float:
    """Host ms of one call of a library function with its own
    synchronization: a synchronize after each call, mean of ``reps``
    after one warm call."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def phase_k10_k11(device, frames):
    """K10 (the DLT refit's smallest eigenvector) and K11's two entries
    (the 4-point hypotheses and the general 8x8 solve) against their plain
    versions on the inputs the perspective paths give them, recorded from
    one eager (CVST_FUSED=0) call each of Flow and Classic 1080p x 80
    crop_and_pad perspective and of config 3 (Flow 720p x 128,
    perspective, camera_lock): K10 at (79, 9, 9) and (127, 9, 9), the
    4-point entry on 40,448 and 65,024 sets (repeated draws among them,
    NaN where NaN), the general entry on the IRLS pre-warp's (B, 8, 8)
    systems of every DIS level and on the 4-point sets' systems, all
    torch.equal.  Then each at the main shapes, timed in turns with its
    plain version (the kernel's device time in a CUDA graph of 20 calls,
    and an eager loop's, which the wrapper's host issue sets), beside
    torch.linalg.eigh / solve_ex on the same inputs (host clock, their
    own synchronization included), with bounds from
    this run's inputs (K10's tests and rotations counted by its plain
    version).  Returns the kernels line's rows of K10, the general K11
    entry and the 4-point entry."""
    import torch

    from comfyui_video_stabilizer_tpu_torch.ops import linalg_cuda as LA

    n3, h3, w3 = BASELINE3
    ctx3 = make_context(synth_clip(n3, h3, w3, seed=3, device=device))
    ctx = make_context(frames)
    runs = {
        "flow": ("flow", lambda: run_slice(ctx, device, transform="perspective")),
        "classic": ("classic", lambda: run_classic(ctx, device, transform="perspective")),
        "config 3": ("flow", lambda: run_stabilizer("flow", ctx3, device, "crop_and_pad", "perspective", lock=True,
                                                   fps=24.0)),
    }
    recorded = {}
    for path, (kind, run) in runs.items():
        with served(kind, 1, f"K10/K11 inputs ({path})"):
            recorded[path] = record_linalg_inputs(run)
    del ctx3
    summary = {}

    def compare(key, out, ref):
        torch.cuda.synchronize()
        calls_, nan_rows = summary.get(key, (0, 0))
        summary[key] = (calls_ + 1, nan_rows + int(torch.isnan(ref).flatten(1).any(-1).sum()))
        check(same_nan(out, ref), f"K10/K11 ({key}): the kernel differs from its plain version")

    for path, calls in recorded.items():
        for name, args in calls:
            if name == "smallest_eigvec":
                compare(f"{path} {name} {tuple(args[0].shape)}", LA.smallest_eigvec(args[0]),
                        LA.smallest_eigvec_plain(args[0]))
            elif name == "solve8":
                a, b = args[0].reshape(-1, 8, 8), args[1].reshape(-1, 8)
                compare(f"{path} {name} {tuple(a.shape)}", LA.solve8(a, b), LA.solve8_plain(a, b))
            else:
                p4, q4 = args[0].reshape(-1, 4, 2), args[1].reshape(-1, 4, 2)
                compare(f"{path} {name} {tuple(p4.shape)}", LA.solve_homography_4pt(p4, q4),
                        LA.homography_4pt_plain(p4, q4))
                a, b = LA.four_point_systems(p4, q4)
                compare(f"{path} solve8 on its systems {tuple(a.shape)}", LA.solve8(a, b), LA.solve8_plain(a, b))
    log("[K10/K11] torch.equal (NaN where NaN) to the plain versions on every recorded input (path, kernel, "
        "shape: calls, results with a NaN): " + "; ".join(f"{k}: {v[0]}, {v[1]}" for k, v in summary.items()))
    check(any(v[1] > 0 for k, v in summary.items() if "homography_4pt" in k),
          "K11: no recorded 4-point set came out non-finite")

    def pick(path, name):
        return next(args for n, args in recorded[path] if n == name)

    result = {}
    rows = (("K10", "flow"), ("K10", "config 3"), ("K11", "flow"), ("K11", "config 3"), ("K11 40,448", "flow"),
            ("K11 4-point", "flow"), ("K11 4-point", "config 3"))
    for kernel, path in rows:
        if kernel == "K10":
            m = pick(path, "smallest_eigvec")[0]
            counts = {}
            LA.smallest_eigvec_plain(m, counts)
            kern, plain = (lambda: LA.smallest_eigvec(m)), (lambda: LA.smallest_eigvec_plain(m))
            lib = library_ms(lambda: torch.linalg.eigh(m), 10)
            b = bound(4 * m.shape[0] * (81 + 9), K10_TEST_OPS * counts["tests"]
                      + K10_ROTATION_OPS * counts["rotations"] + K10_PICK_OPS * m.shape[0])
            shape = tuple(m.shape)
            work = f"{counts['tests']} rotation tests, {counts['rotations']} rotations"
        elif kernel == "K11 4-point":
            p4, q4 = (t.reshape(-1, 4, 2) for t in pick(path, "solve_homography_4pt"))
            kern, plain = (lambda: LA.solve_homography_4pt(p4, q4)), (lambda: LA.homography_4pt_plain(p4, q4))
            a, rhs = LA.four_point_systems(p4, q4)
            lib = library_ms(lambda: torch.linalg.solve_ex(a, rhs[..., None], check_errors=False), 10)
            b = bound(4 * p4.shape[0] * (16 + 9), (K11_4PT_BUILD_OPS + K11_SYSTEM_OPS) * p4.shape[0])
            shape = tuple(p4.shape)
            work = f"{p4.shape[0]} 4-point sets (the library call solves the systems built from them)"
        else:
            if kernel == "K11":
                a, rhs = pick(path, "solve8")
            else:
                a, rhs = LA.four_point_systems(*(t.reshape(-1, 4, 2) for t in pick(path, "solve_homography_4pt")))
            a, rhs = a.reshape(-1, 8, 8), rhs.reshape(-1, 8)
            kern, plain = (lambda: LA.solve8(a, rhs)), (lambda: LA.solve8_plain(a, rhs))
            lib = library_ms(lambda: torch.linalg.solve_ex(a, rhs[..., None], check_errors=False), 10)
            b = bound(4 * a.shape[0] * (64 + 8 + 8), K11_SYSTEM_OPS * a.shape[0])
            shape = tuple(a.shape)
            work = f"{a.shape[0]} systems"
        # plain, kernel, kernel, plain; the kernel in a CUDA graph of 20 calls
        tp = [cuda_ms(plain, 2)]
        tk = [graph_ms(kern, 20) for _ in range(2)]
        tp.append(cuda_ms(plain, 2))
        ms, plain_ms, issue_ms = min(tk), min(tp), cuda_ms(kern, 50)
        log(f"[K10/K11] {kernel} {path} {shape}: kernel {ms:.4f} ms (device time in a graph; an eager loop of "
            f"launches {issue_ms:.4f}: the host's issue), plain {plain_ms:.3f} ms (runs {tk}, {tp}); "
            f"{'torch.linalg.eigh' if kernel == 'K10' else 'torch.linalg.solve_ex'} {lib:.4f} ms (host clock, its "
            f"own synchronization included); {work}; bound {b['bound_ms']:.6f} ms ({b['bound_by']})")
        row = {"shape": shape, "max_abs_err": 0.0, "ms": ms, "eager_loop_ms": issue_ms, "plain_ms": plain_ms, **b,
               "library_ms": lib}
        name = kernel.split()[0] if kernel != "K11 4-point" else "K11 4-point"
        if path == "flow" and kernel != "K11 40,448":
            result[name] = row
        else:
            result[name]["config3" if path == "config 3" else "systems_40448"] = row
    return result["K10"], result["K11"], result["K11 4-point"]


def phase_persp_graph(device, frames):
    """Perspective crop_and_pad of Flow and Classic at 1080p x 80 from their
    CUDA graphs.  Per kind, from an empty cache: the first call captures
    one graph (its ms, and the device memory the graph keeps alone); a
    warm call replays it (its launches, the kernels line's for K10 and
    K11: K10 twice, K11's 4-point entry once, its general entry three
    times a DIS level for Flow and never for Classic); calls in turns (graph, eager, eager, graph; CVST_FUSED=0
    for eager) with frames, masks and the whole meta (every matrix in it)
    torch.equal to the first eager call's, timed; the replay alone (CUDA
    events); one eager run of the estimation the graph holds
    (fastpath._flow_estimate / _classic_estimate) under
    torch.cuda.set_sync_debug_mode("error"); a warm call under
    torch.profiler (each hand kernel's events equal to its launches) and
    no device-to-host copy before K1.  Then both graphs cached together:
    the memory they keep, at most the larger alone + 0.5 GiB.  Leaves both
    cached, for the perspective splits."""
    import torch

    from comfyui_video_stabilizer_tpu_torch.models import fastpath as FP
    from comfyui_video_stabilizer_tpu_torch.ops import cuda_build
    from comfyui_video_stabilizer_tpu_torch.ops import resize as R

    ctx = make_context(frames)
    runs = {"flow": lambda: run_slice(ctx, device, transform="perspective"),
            "classic": lambda: run_classic(ctx, device, transform="perspective")}
    gib = 2.0 ** 30
    out = {}
    for kind, run in runs.items():
        tag = f"perspective graph, {kind}"
        FP.clear_graph_cache()
        reserved0 = cache_memory()[0]
        stats = dict(FP.GRAPH_STATS)
        with served(kind, 1, f"{tag}: the first call"):
            first_ms = timed_calls(run, 1)[0]
        check(FP.GRAPH_STATS["captures"] == stats["captures"] + 1, f"{tag}: the first call did not capture")
        kept = (cache_memory()[0] - reserved0) / gib
        cuda_build.reset_launches()
        with served(kind, 1, f"{tag}: a warm call"):
            run()
        torch.cuda.synchronize()
        launches = dict(cuda_build.LAUNCHES)
        check(FP.GRAPH_STATS["captures"] == stats["captures"] + 1
              and FP.GRAPH_STATS["replays"] == stats["replays"] + 2, f"{tag}: the warm call did not replay alone")
        # one 4-point solve a RANSAC fit; Flow: three IRLS solves a DIS level fit
        check(launches["smallest_eigvec"] == 2 and launches["warp"] == 1 and launches["homography_4pt"] == 1
              and (launches["solve8"] > 0 and launches["solve8"] % 3 == 0 if kind == "flow"
                   else launches["solve8"] == 0), f"{tag}: launches {launches}")

        def same(a, b):
            return (bool(torch.equal(a.frames, b.frames)), bool(torch.equal(a.masks, b.masks)), a.meta == b.meta)

        times, equal, ref, pending = {"graph": [], "eager": []}, [], None, []
        for which in ("graph", "eager", "eager", "graph"):
            with env(CVST_FUSED="1" if which == "graph" else "0"), served(kind, 1, f"{tag}: {which} call"):
                replays = FP.GRAPH_STATS["replays"]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = run()
                torch.cuda.synchronize()
                times[which].append(1e3 * (time.perf_counter() - t0))
                check(FP.GRAPH_STATS["replays"] == replays + (which == "graph"), f"{tag}: {which} call's replays")
            if ref is None and which == "graph":
                pending.append(res)
            elif ref is None:
                ref = res
                equal += [same(g, ref) for g in pending]
                pending = []
            else:
                equal.append(same(res, ref))
            del res
        del ref
        check(len(equal) == 3 and all(all(e) for e in equal),
              f"{tag}: the graph calls differ from CVST_FUSED=0 (frames, masks, meta): {equal}")
        entry = next(reversed(FP._GRAPHS.values()))
        replay_ms = cuda_ms(entry.graph.replay, 10)
        working, dec, (strength, keep_fov, kw) = fast_estimate_args(kind, "perspective")
        grays = R.gray_for_estimation(frames, working, decimation=dec)
        s_t, k_t = FP._scalar(strength, device), FP._scalar(keep_fov, device)
        FP._PROGRAMS[kind](grays, s_t, k_t, **kw)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            FP._PROGRAMS[kind](grays, s_t, k_t, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        del grays
        n_events, busy, wall = profile_call(run)
        call_events, _ = device_events(run)
        dtoh_before, dtoh_all = dtoh_copies(call_events)
        check(dtoh_before == 0, f"{tag}: {dtoh_before} device-to-host copies before K1")
        med = {k: float(np.median(v)) for k, v in times.items()}
        log(f"[persp graph] {kind} 1080p x {CLIP_FRAMES} crop_and_pad perspective: first call (eager warm-up + capture "
            f"+ replay) {first_ms:.1f} ms, the graph keeps {kept:.3f} GiB alone; a warm call's launches {launches}; "
            f"graph, eager, eager, graph turns (frames, masks, meta torch.equal to the first eager call: {equal}): "
            f"graph {[round(t, 1) for t in times['graph']]} ms, eager {[round(t, 1) for t in times['eager']]} ms; "
            f"the replay alone {replay_ms:.2f} ms (CUDA events); the estimation eagerly under "
            f"set_sync_debug_mode('error'): no sync; torch.profiler over one call: {n_events} device events, busy "
            f"{busy:.1f} ms of {wall:.1f} ms wall; device-to-host copies before K1 {dtoh_before}, in the call {dtoh_all}")
        out[kind] = {"first_ms": first_ms, "kept_gib": kept, "launches": launches, "graph_ms": med["graph"],
                     "eager_ms": med["eager"], "replay_ms": replay_ms, "events": n_events,
                     "dtoh_before_k1": dtoh_before}
    FP.clear_graph_cache()
    reserved0 = cache_memory()[0]
    segments0 = pool_segments()
    stats = dict(FP.GRAPH_STATS)
    for kind, run in runs.items():
        with served(kind, 1, f"perspective graphs together ({kind})"):
            run()
    both = (cache_memory()[0] - reserved0) / gib
    largest = max(v["kept_gib"] for v in out.values())
    log(f"[persp graph] both perspective graphs cached (one pool): {both:.3f} GiB kept; alone flow "
        f"{out['flow']['kept_gib']:.3f}, classic {out['classic']['kept_gib']:.3f} GiB; GRAPH_STATS since "
        f"{({k: FP.GRAPH_STATS[k] - v for k, v in stats.items()})}; each graph's pool growth at its last capture, "
        f"GiB {({k[0]: round(e.pool_growth / gib, 3) for k, e in FP._GRAPHS.items()})}; segments by pool, GiB, "
        f"before {segments0}, after {pool_segments()}")
    check(both <= largest + 0.5, f"the two perspective graphs keep {both:.3f} GiB, past {largest:.3f} + 0.5")
    out["kept_both_gib"] = both
    return out


def k2_bound(px: int, radius: int) -> dict:
    """K2's least time on ``px`` pixels: I and Jw read, fx, fy and cmin
    written; per pixel, counted on the shift-add tree, (2r+1)^2 candidates
    x (the difference, the square, 3 + 3 tree adds, the 1/64 scale), the
    two input scalings (a Jw pixel's does not depend on the shift), ~20
    for the argmin and the parabolas."""
    return bound(4 * 5 * px, px * ((2 * radius + 1) ** 2 * 8 + 2 + 20))


def phase_dense_dis(device, frames):
    """Dense dis_flow on the 1080p clip's 960x540 grays: K2 at r = 3 at the
    finest level's shape against its plain version (bitwise) and timed,
    K2's launches in one dense call and the call's time, the output
    checks, and the CUDA path against the CPU path on a small clip."""
    import torch

    from comfyui_video_stabilizer_tpu_torch.ops import cuda_build
    from comfyui_video_stabilizer_tpu_torch.ops import cv_cuda as CV
    from comfyui_video_stabilizer_tpu_torch.ops import flow_dis as FD
    from comfyui_video_stabilizer_tpu_torch.ops import resize as R

    grays = R.gray_for_estimation(frames, (WIDTH // 2, HEIGHT // 2), decimation=1)
    n, gh, gw = grays.shape
    coarsest = FD.num_levels(gh, gw)
    finest = min(FD.FINEST_SCALE, coarsest)
    level = FD.build_pyramid(grays, coarsest)[finest]
    I, J = level[:-1].contiguous(), level[1:].contiguous()
    shape = tuple(I.shape)
    out = CV.cost_volume_subpixel(I, J, 3, 8)
    ref = CV.cost_volume_plain(I, J, 3, 8)
    torch.cuda.synchronize()
    equal = [bool(torch.equal(a, b)) for a, b in zip(out, ref)]
    err = max(float((a - b).abs().max()) for a, b in zip(out, ref))
    log(f"[dense] K2 r=3 {shape}: fx, fy, cmin bitwise equal {equal}; max|kernel - plain| {err:.3e}")
    check(all(equal), f"K2 r=3 {shape}: outputs differ from the plain version (equal: {equal})")
    del out, ref
    t_plain = [cuda_ms(lambda: CV.cost_volume_plain(I, J, 3, 8), 5)]
    t_kern = [cuda_ms(lambda: CV.cost_volume_subpixel(I, J, 3, 8), 20) for _ in range(2)]
    t_plain.append(cuda_ms(lambda: CV.cost_volume_plain(I, J, 3, 8), 5))
    r3 = {"max_abs_err": err, "ms": min(t_kern), "plain_ms": min(t_plain), **k2_bound(I.numel(), 3)}
    log(f"[dense] K2 r=3 {shape}: kernel {r3['ms']:.4f} ms, plain {r3['plain_ms']:.4f} ms "
        f"(runs {t_kern}, {t_plain}); bound {r3['bound_ms']:.4f} ms ({r3['bound_by']})")

    torch.cuda.synchronize()
    cuda_build.reset_launches()
    flow, conf = FD.dis_flow(grays)
    torch.cuda.synchronize()
    launches = cuda_build.LAUNCHES["cost_volume"]
    check(launches >= 1, "the dense call launched no K2")
    check(tuple(flow.shape) == (n - 1, gh, gw, 2) and bool(torch.isfinite(flow).all()),
          f"dense flow {tuple(flow.shape)} not finite or of the wrong shape")
    check(bool(torch.isfinite(conf).all()), "dense confidence not finite")
    # the synthetic shake moves the frame centre by up to ~10 px a frame (half
    # that at 960x540); the dense flow at the centre must follow it
    centre = flow[:, gh // 2 - 8: gh // 2 + 8, gw // 2 - 8: gw // 2 + 8].abs().amax().item()
    check(0.0 < centre < 20.0, f"dense flow at the centre {centre} px")
    del flow, conf
    t_call = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        FD.dis_flow(grays)
        torch.cuda.synchronize()
        t_call.append(1e3 * (time.perf_counter() - t0))
    log(f"[dense] dis_flow ({n}, {gh}, {gw}): K2 launches {launches} a call; a warm call "
        f"{', '.join(f'{t:.1f}' for t in t_call)} ms, median {float(np.median(t_call)):.1f}")

    # the CUDA path against the CPU path, as the cuda-marked test
    small = synth_clip(6, 150, 198, seed=13, device="cpu").mean(dim=-1) * 255.0
    cpu_flow, cpu_conf = FD.dis_flow(small)
    gpu_flow, gpu_conf = FD.dis_flow(small.to(device))
    d = (gpu_flow.cpu() - cpu_flow).abs()
    med, p99 = float(d.median()), float(torch.quantile(d.flatten(), 0.99))
    log(f"[dense] (6, 150, 198) CUDA vs CPU path: flow median {med:.3e}, p99 {p99:.3e}, max {float(d.max()):.3e} px; "
        f"conf median {float((gpu_conf.cpu() - cpu_conf).abs().median()):.3e}")
    check(med <= 1e-4 and p99 <= 1e-2, "dense flow: CUDA and CPU paths differ")
    return launches, r3, float(np.median(t_call))


def forced_outage(*_a, **_k):
    raise RuntimeError("synthetic backend outage")


def timed_calls(fn, reps: int):
    """Host ms of ``reps`` warm calls, a synchronize around each."""
    import torch

    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def phase_fallback_tiers(device, frames):
    """The 1080p x 80 Flow call with each fallback tier forced (DIS raising,
    then TV-L1 too): backend, reason, modes, launches, ms a call and the
    device busy share under torch.profiler; the output checks."""
    import torch

    from comfyui_video_stabilizer_tpu_torch.ops import cuda_build
    from comfyui_video_stabilizer_tpu_torch.ops import flow_dis as FD
    from comfyui_video_stabilizer_tpu_torch.ops import tvl1 as TV

    ctx = make_context(frames)
    orig = interior_motion(frames, 100)
    reasons = {
        "TVL1": "DIS unavailable (synthetic backend outage); using TV-L1.",
        "phase_correlate": "DIS unavailable (synthetic backend outage; TV-L1 failed (synthetic backend "
                           "outage)); using phase correlation.",
    }
    from comfyui_video_stabilizer_tpu_torch.models import fastpath as FP

    real_dis, real_tvl1 = FD.dis_flow_fit, TV.tvl1_flow
    result = {}
    # a captured graph replays DIS without calling the patched function: with
    # none, the fast path calls it, fails and leaves the call to the host engine
    FP.clear_graph_cache()
    try:
        FD.dis_flow_fit = forced_outage
        for tier in ("TVL1", "phase_correlate"):
            if tier == "phase_correlate":
                TV.tvl1_flow = forced_outage
            torch.cuda.synchronize()
            cuda_build.reset_launches()
            res = run_slice(ctx, device, backend=tier)
            torch.cuda.synchronize()
            launches = dict(cuda_build.LAUNCHES)
            meta = res.meta
            modes = mode_counts(meta)
            check(meta["flow_backend"] == tier, f"{tier}: flow_backend {meta['flow_backend']!r}")
            check(meta["flow_fallback_reason"] == reasons[tier],
                  f"{tier}: reason {meta['flow_fallback_reason']!r}")
            check(launches["warp"] == 1 and launches["cost_volume"] == 0, f"{tier}: launches {launches}")
            if tier == "phase_correlate":
                check(set(modes) == {"translation"}, f"phase tier modes {modes}")
            check(tuple(res.frames.shape) == (CLIP_FRAMES, HEIGHT, WIDTH, 3)
                  and bool(torch.isfinite(res.frames).all()), f"{tier}: frames")
            stab = interior_motion(res.frames, 100)
            # translation only on the last tier: the shake's rotation stays
            check(stab < (0.8 if tier == "TVL1" else 1.0) * orig,
                  f"{tier}: stabilization did not lower the inter-frame difference")
            del res
            ms = timed_calls(lambda: run_slice(ctx, device, backend=tier), 3)
            n_events, busy, wall = profile_call(lambda: run_slice(ctx, device, backend=tier))
            log(f"[{tier}] 1080p x {CLIP_FRAMES} Flow call, DIS{' and TV-L1' if tier != 'TVL1' else ''} "
                f"forced to raise: modes {modes}; hand-kernel launches {launches}; interior difference "
                f"{orig:.5f} -> {stab:.5f}; warm {', '.join(f'{t:.1f}' for t in ms)} ms, median "
                f"{float(np.median(ms)):.1f} ms ({CLIP_FRAMES / (float(np.median(ms)) / 1e3):.1f} f/s); "
                f"torch.profiler: {n_events} device events, busy {busy:.1f} ms of {wall:.1f} ms wall "
                f"(busy share {busy / wall:.2f} under the profiler)")
            result[tier] = float(np.median(ms))
    finally:
        FD.dis_flow_fit, TV.tvl1_flow = real_dis, real_tvl1
    return result


def phase_kernel_error(device, frames):
    """K2's launch refused (the library entry stubbed to return error 9,
    cudaErrorInvalidConfiguration): stabilize_flow must raise KernelError
    before any fallback tier runs; then K7's: stabilize_classic must
    raise KernelError and no native greedy run in its place."""
    from comfyui_video_stabilizer_tpu_torch.ops import cuda_build
    from comfyui_video_stabilizer_tpu_torch.ops import lk as LK
    from comfyui_video_stabilizer_tpu_torch.ops import tvl1 as TV

    from comfyui_video_stabilizer_tpu_torch.models import fastpath as FP

    lib = cuda_build.library()
    real_k2, real_tvl1 = lib.cvst_cost_volume, TV.tvl1_flow
    for engine, flag in (("fast path", "1"), ("host engine", "0")):
        tiers = []
        FP.clear_graph_cache()  # the graph's capture launches K2 through the stub
        lib.cvst_cost_volume = lambda *_a: 9
        TV.tvl1_flow = lambda *a: tiers.append("TV-L1") or real_tvl1(*a)
        try:
            with env(CVST_FASTPATH=flag):
                run_slice(make_context(frames), device)
        except cuda_build.KernelError as exc:
            raised = exc
        else:
            raised = None
        finally:
            lib.cvst_cost_volume, TV.tvl1_flow = real_k2, real_tvl1
        log(f"[kernel error] {engine}: K2 launch refused: stabilize_flow raised {type(raised).__name__}: "
            f"{raised}; fallback tiers run: {tiers}")
        check(raised is not None, f"{engine}: a refused K2 launch did not make stabilize_flow raise KernelError")
        check(not tiers, f"{engine}: a fallback tier ran after a kernel failure")

    real_k7, real_native = lib.cvst_greedy, LK._native.greedy_min_distance
    for engine, flag in (("fast path", "1"), ("host engine", "0")):
        native = []
        FP.clear_graph_cache()  # the Classic graph's capture launches K7 through the stub
        lib.cvst_greedy = lambda *_a: 9
        LK._native.greedy_min_distance = lambda *a: native.append(1) or real_native(*a)
        try:
            with env(CVST_FASTPATH=flag):
                run_classic(make_context(frames), device)
        except cuda_build.KernelError as exc:
            raised = exc
        else:
            raised = None
        finally:
            lib.cvst_greedy, LK._native.greedy_min_distance = real_k7, real_native
        log(f"[kernel error] {engine}: K7 launch refused: stabilize_classic raised {type(raised).__name__}: "
            f"{raised}; native greedy calls: {len(native)}")
        check(raised is not None and "greedy" in str(raised),
              f"{engine}: a refused K7 launch did not make stabilize_classic raise KernelError")
        check(not native, f"{engine}: the native greedy ran after a K7 failure")


def phase_flow_split(device, frames):
    """The 1080p x 80 Flow call's time split: the device stages one at a
    time with a synchronize after each (median of 3), then a timeline of
    real calls (median of 3 warm calls), stamped on the host as the
    engine enters and leaves its stages: the gray, the estimation (DIS
    enqueued, then the fits and their fetch, which waits for the card),
    the host trajectory + meta between the fits' fetch and K1's launch
    (the card idle), the warp call (the mask pass and K1) and the tail
    (the ratio fetch and the meta); one call's device events and busy
    share under torch.profiler."""
    import torch

    from comfyui_video_stabilizer_tpu_torch.models import flow as FL
    from comfyui_video_stabilizer_tpu_torch.models import stabilize as ST

    mats = np.tile(np.eye(3, dtype=np.float32), (CLIP_FRAMES, 1, 1))
    split = [flow_stage_split(frames, device, "similarity", mats, (WIDTH, HEIGHT)) for _ in range(3)]
    ctx = make_context(frames)
    marks: dict = {}
    os.environ["CVST_FASTPATH"] = "0"  # this phase splits the host engine's call

    def stamped(fn, before, after):
        def wrapper(*a, **k):
            if before:
                marks[before] = time.perf_counter()
            out = fn(*a, **k)
            marks[after] = time.perf_counter()
            return out
        return wrapper

    patched = [(ST.R, "gray_for_estimation", None, "gray"), (FL, "_fused_fits_sampled", None, "fits"),
               (ST.W, "warp_clip_with_mask", "warp in", "warp out")]
    real = [getattr(mod, name) for mod, name, _, _ in patched]
    spans = ("gray", "estimation", "host trajectory + meta", "warp call", "tail")
    edges = ("start", "gray", "fits", "warp in", "warp out", "end")
    timeline = []
    try:
        for (mod, name, before, after), fn in zip(patched, real):
            setattr(mod, name, stamped(fn, before, after))
        for _ in range(4):
            torch.cuda.synchronize()
            marks["start"] = time.perf_counter()
            run_slice(ctx, device)
            torch.cuda.synchronize()
            marks["end"] = time.perf_counter()
            timeline.append([1e3 * (marks[b] - marks[a]) for a, b in zip(edges, edges[1:])])
        n_events, busy, wall = profile_call(lambda: run_slice(ctx, device))
    finally:
        for (mod, name, _, _), fn in zip(patched, real):
            setattr(mod, name, fn)
        os.environ.pop("CVST_FASTPATH")
    timeline = np.array(timeline[1:])
    host = timeline[:, 2]
    log(f"[flow split] host engine (CVST_FASTPATH=0): 1080p x {CLIP_FRAMES} Flow, crop_and_pad, ms (median of 3, "
        "synchronize after each device "
        "stage): " + ", ".join(f"{k} {float(np.median([s[k] for s in split])):.2f}" for k in split[0]))
    log("[flow split] inside warm calls (host stamps, median of 3): "
        + ", ".join(f"{k} {float(np.median(timeline[:, i])):.2f}" for i, k in enumerate(spans))
        + f"; whole call {float(np.median(timeline.sum(axis=1))):.1f}; host trajectory + meta runs "
        f"{[round(float(h), 2) for h in host]}")
    log(f"[flow split] torch.profiler over one host-engine DIS call: {n_events} device events, busy {busy:.1f} ms of "
        f"{wall:.1f} ms wall (busy share {busy / wall:.2f} under the profiler)")
    return float(np.median(host))


def phase_fast_vs_host(device, frames):
    """The 1080p x 80 Flow crop_and_pad call through the host engine
    (CVST_FASTPATH=0) against the fast path, to the docs/parity.md
    contract: per-pair modes equal, path <= 1e-3, applied matrices
    <= 2e-3, frames p99 <= 1e-3 and max <= 1e-2, masks unequal on <= 0.1 %
    of pixels (a round-half-even coverage tie flips on a one-ulp
    coefficient: the fast path inverts on the card in float32, the host
    engine in float64); the warm calls of both, in turns."""
    import torch

    from comfyui_video_stabilizer_tpu_torch.ops import cuda_build

    ctx = make_context(frames)
    with served("flow", 1, "fast vs host: the fast path"):
        fast = run_slice(ctx, device)
    with env(CVST_FASTPATH="0"), served("flow", 0, "fast vs host: the host engine"):
        torch.cuda.synchronize()
        cuda_build.reset_launches()
        host = run_slice(ctx, device)
        torch.cuda.synchronize()
        host_launches = dict(cuda_build.LAUNCHES)
    fm, hm = fast.meta, host.meta
    check(mode_counts(fm) == mode_counts(hm) and [t["mode"] for t in fm["estimated_motion"]["per_transition"]]
          == [t["mode"] for t in hm["estimated_motion"]["per_transition"]], "fast vs host: per-pair modes differ")
    path_err = float(np.abs(np.array(fm["estimated_motion"]["path"]) - np.array(hm["estimated_motion"]["path"])).max())
    applied = [np.array([e["applied_matrix"] for e in m["stabilization_warp"]["per_frame"]]) for m in (fm, hm)]
    app_err = float(np.abs(applied[0] - applied[1]).max())
    d = (fast.frames - host.frames).abs().flatten()
    p99 = float(torch.quantile(d[:: max(1, d.numel() // 1_000_000)], 0.99))
    fmax = float(d.max())
    del d
    unequal = float((fast.masks != host.masks).float().mean())
    pad = abs(fm["padding_fraction_mean"] - hm["padding_fraction_mean"])
    del fast, host
    times = {"fast": [], "host": []}
    for which in ("host", "fast", "fast", "host"):
        with env(CVST_FASTPATH="1" if which == "fast" else "0"), served("flow", 2 * (which == "fast"), which):
            times[which] += timed_calls(lambda: run_slice(ctx, device), 2)
    med = {k: float(np.median(v)) for k, v in times.items()}
    log(f"[fast vs host] 1080p x {CLIP_FRAMES} Flow crop_and_pad similarity: modes equal; path max|d| "
        f"{path_err:.3e}, applied matrices {app_err:.3e}, frames p99 {p99:.3e} max {fmax:.3e}, masks unequal on "
        f"{unequal:.2e} of pixels, padding mean |d| {pad:.2e}; host engine launches {host_launches}; warm calls "
        f"(host, fast, fast, host turns) host {[round(t, 1) for t in times['host']]} ms, fast "
        f"{[round(t, 1) for t in times['fast']]} ms; medians host {med['host']:.1f} ms "
        f"({CLIP_FRAMES / med['host'] * 1e3:.1f} f/s), fast {med['fast']:.1f} ms ({CLIP_FRAMES / med['fast'] * 1e3:.1f} f/s)")
    check(path_err <= 1e-3 and app_err <= 2e-3, f"fast vs host: path {path_err}, applied {app_err}")
    check(p99 <= 1e-3 and fmax <= 1e-2, f"fast vs host: frames p99 {p99}, max {fmax}")
    check(unequal <= 1e-3 and pad <= 1e-3, f"fast vs host: masks unequal on {unequal}, padding {pad}")
    return med


def dtoh_copies(events) -> tuple:
    """(device-to-host copies before K1's first launch, in all) among a
    call's profiled device events."""
    k1 = min((e.time_range.start for e in events if re.search(r"(?:^|[\s:])warp_kernel[<(]", e.name)),
             default=float("inf"))
    dtoh = [e for e in events if "DtoH" in e.name]
    return sum(1 for e in dtoh if e.time_range.start < k1), len(dtoh)


def phase_fused(device, frames, kind="flow"):
    """``kind``'s fused graph at 1080p x 80 ('flow' or 'classic'): the
    first call after the cache is cleared (eager warm-up, capture, replay)
    timed apart from warm calls; the graph's replay alone (CUDA events);
    the call bitwise equal to the eager fast path (CVST_FUSED=0) in
    frames, masks and the whole meta; the launches of a warm call; the
    device events of one call under torch.profiler, those of the replay
    alone, and the device-to-host copies (none before K1); the device
    memory the cached graph keeps after its call (its private pool and its
    static tensors); the host time the estimation holds the calling
    thread, the graph against eager, in turns."""
    import torch

    from comfyui_video_stabilizer_tpu_torch.models import fastpath as FP
    from comfyui_video_stabilizer_tpu_torch.ops import cuda_build

    run = run_slice if kind == "flow" else run_classic
    tag = "fused" if kind == "flow" else "classic graph"
    ctx = make_context(frames)
    FP.clear_graph_cache()
    reserved0, allocated0 = cache_memory()
    captures = FP.GRAPH_STATS["captures"]
    with served(kind, 1, f"{tag}: the first call"):
        first_ms = timed_calls(lambda: run(ctx, device), 1)[0]
    check(FP.GRAPH_STATS["captures"] == captures + 1, f"{tag}: the first call did not capture a graph")
    reserved1, allocated1 = cache_memory()
    kept = {"reserved_gib": (reserved1 - reserved0) / 2**30, "allocated_gib": (allocated1 - allocated0) / 2**30}
    cuda_build.reset_launches()
    with served(kind, 1, f"{tag}: a warm call"):
        fused = run(ctx, device)
    torch.cuda.synchronize()
    launches = dict(cuda_build.LAUNCHES)
    if kind == "flow":
        check(launches["cost_volume"] >= 4 and launches["warp"] == 1, f"{tag}: launches {launches}")
    else:
        check(launches["gftt"] == 1 and launches["greedy"] == 1 and launches["lk_gn"] == 4
              and launches["extract_windows"] == 8 and launches["warp"] == 1, f"{tag}: launches {launches}")
    with env(CVST_FUSED="0"), served(kind, 1, f"{tag}: CVST_FUSED=0"):
        replays = FP.GRAPH_STATS["replays"]
        eager = run(ctx, device)
        check(FP.GRAPH_STATS["replays"] == replays, f"{tag}: CVST_FUSED=0 replayed the graph")
    equal = {"frames": bool(torch.equal(fused.frames, eager.frames)),
             "masks": bool(torch.equal(fused.masks, eager.masks))}
    for key in ("path", "target_path", "target_path_effective", "per_transition"):
        equal[key] = fused.meta["estimated_motion"][key] == eager.meta["estimated_motion"][key]
    equal["applied"] = fused.meta["stabilization_warp"] == eager.meta["stabilization_warp"]
    equal["meta"] = fused.meta == eager.meta
    del fused, eager
    check(all(equal.values()), f"{tag}: the graph call differs from the eager fast path: {equal}")
    times = {"fused": [], "eager": []}
    for which in ("eager", "fused", "fused", "eager"):
        with env(CVST_FUSED="1" if which == "fused" else "0"):
            times[which] += timed_calls(lambda: run(ctx, device), 2)
    issue = host_issue_ms(kind, lambda: run(ctx, device))
    entry = next(reversed(FP._GRAPHS.values()))
    replay_ms = cuda_ms(entry.graph.replay, 10)
    n_events, busy, wall = profile_call(lambda: run(ctx, device))
    graph_events, _ = device_events(entry.graph.replay)
    outside = n_events - len(graph_events)
    call_events, _ = device_events(lambda: run(ctx, device))
    dtoh_before, dtoh_all = dtoh_copies(call_events)
    check(dtoh_before == 0, f"{tag}: {dtoh_before} device-to-host copies before K1")
    med = {k: float(np.median(v)) for k, v in times.items()}
    log(f"[{tag}] 1080p x {CLIP_FRAMES} {kind} crop_and_pad similarity: bitwise equal to CVST_FUSED=0 {equal}; "
        f"first call (eager warm-up + capture + replay) {first_ms:.1f} ms; warm calls (eager, fused, fused, eager "
        f"turns) fused {[round(t, 1) for t in times['fused']]} ms, eager {[round(t, 1) for t in times['eager']]} ms; "
        f"medians fused {med['fused']:.1f} ms ({CLIP_FRAMES / med['fused'] * 1e3:.1f} f/s), eager {med['eager']:.1f} ms "
        f"({CLIP_FRAMES / med['eager'] * 1e3:.1f} f/s); the replay alone {replay_ms:.2f} ms (CUDA events); "
        f"launches of a warm call {launches}")
    log(f"[{tag}] the cached graph keeps {kept['reserved_gib']:.3f} GiB reserved ({kept['allocated_gib']:.3f} GiB "
        f"allocated) after its call; the host time the estimation holds the calling thread, ms (graph, eager, "
        f"eager, graph turns, 2 calls each): graph {[round(t, 2) for t in issue['graph']]}, eager "
        f"{[round(t, 2) for t in issue['eager']]}")
    log(f"[{tag}] torch.profiler over one call: {n_events} device events ({len(graph_events)} in the replay "
        f"alone, {outside} outside it), busy {busy:.1f} ms of {wall:.1f} ms wall (busy share {busy / wall:.2f} "
        f"under the profiler); device-to-host copies before K1 {dtoh_before}, in the call {dtoh_all}")
    return {"first_ms": first_ms, "fused_ms": med["fused"], "eager_ms": med["eager"], "replay_ms": replay_ms,
            "events": n_events, "graph_events": len(graph_events), "launches": launches,
            "dtoh_before_k1": dtoh_before, "dtoh": dtoh_all, "kept": kept,
            "issue_ms": {k: float(np.median(v)) for k, v in issue.items()}}


def cache_memory() -> tuple:
    """(reserved, allocated) device bytes once the caching allocator has
    let go of every block it can: what is left beyond a baseline is held
    by live tensors and by the captured graphs' private pools."""
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved(), torch.cuda.memory_allocated()


def pool_segments() -> dict:
    """GiB of the device's memory segments by pool: "default" for the
    caching allocator's own, "graphs" for the cached graphs' shared pool
    (fastpath._POOLS), "other" for any other private pool."""
    import torch

    from comfyui_video_stabilizer_tpu_torch.models import fastpath as FP

    graph_pools = {tuple(h) for h in FP._POOLS.values()}
    out = {"default": 0.0, "graphs": 0.0, "other": 0.0}
    for seg in torch.cuda.memory_snapshot():
        pool = tuple(seg.get("segment_pool_id", (0, 0)))
        key = "default" if pool == (0, 0) else "graphs" if pool in graph_pools else "other"
        out[key] += seg["total_size"] / 2**30
    return {k: round(v, 3) for k, v in out.items()}


def host_issue_ms(kind: str, call) -> dict:
    """The host ms the estimation of a warm ``call`` holds the calling
    thread, from its CUDA graph and eagerly (CVST_FUSED=0), in turns
    (graph, eager, eager, graph; 2 calls each): the time to return from
    the fast path's estimation function, with no synchronize inside it,
    so it is the time to issue the work (or to wait on a full launch
    queue), not the device's."""
    from comfyui_video_stabilizer_tpu_torch.models import fastpath as FP

    names = {"graph": "_fused_estimate", "eager": f"_{kind}_estimate"}
    saved = {which: getattr(FP, name) for which, name in names.items()}
    times = {"graph": [], "eager": []}

    def timed(which):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            out = saved[which](*args, **kwargs)
            times[which].append(1e3 * (time.perf_counter() - t0))
            return out
        return wrapper

    try:
        for which, name in names.items():
            setattr(FP, name, timed(which))
        for which in ("graph", "eager", "eager", "graph"):
            with env(CVST_FUSED="1" if which == "graph" else "0"), served(kind, 2, f"host issue, {which}"):
                timed_calls(call, 2)
    finally:
        for which, name in names.items():
            setattr(FP, name, saved[which])
    check(len(times["graph"]) == 4 and len(times["eager"]) == 4, f"host issue: calls timed {times}")
    return times


def phase_graph_cache(device, frames):
    """Flow and Classic graphs sharing the cache (GRAPH_CACHE_SIZE = 4
    entries, least recently used out) and one memory pool: four static
    keys (Flow 1080p at smooth 0.6 and 0.3, Classic 1080p at 0.6, Classic
    at BASELINE config 1's 854x480 x 64).  The device memory each key's
    graph keeps alone (the cache cleared between), then the four in three
    rounds: the captures, pool rebuilds (a capture that grows the pool by
    more than fastpath.POOL_REBUILD_BYTES recaptures every cached graph
    into a new pool, the new one first; GRAPH_STATS counts those apart,
    as recaptures) and ms of each call, the bytes each
    key adds as it is captured and those the four keep, at most the
    largest single graph's plus 0.5 GiB; the four replayed in an interleaved order
    (Flow s0.6, Classic, Flow s0.3, Classic 480p, then reversed), each
    call's frames, masks and meta torch.equal to CVST_FUSED=0; the memory
    after clear_graph_cache(), within 0.05 GiB of the baseline.  Then a
    fifth key (Classic 1080p at smooth 0.3) in the cycle for two rounds,
    where each call evicts the graph the next one needs."""
    import torch

    from comfyui_video_stabilizer_tpu_torch.models import fastpath as FP
    from comfyui_video_stabilizer_tpu_torch.models.classic import stabilize_classic
    from comfyui_video_stabilizer_tpu_torch.models.flow import stabilize_flow

    check(FP.GRAPH_CACHE_SIZE == 4, f"GRAPH_CACHE_SIZE {FP.GRAPH_CACHE_SIZE}, the phase assumes 4")
    n, h, w = BASELINE1
    ctx = make_context(frames)
    sctx = make_context(synth_clip(n, h, w, seed=1, device=device))
    gib = 2.0 ** 30

    def call(fn, c, smooth):
        return lambda: fn(c, "crop_and_pad", "similarity", False, 0.8, smooth, 0.6, (127, 127, 127), 30.0,
                          device=device)

    keys = {"flow 1080p s0.6": call(stabilize_flow, ctx, 0.6), "classic 1080p s0.6": call(stabilize_classic, ctx, 0.6),
            "flow 1080p s0.3": call(stabilize_flow, ctx, 0.3), "classic 480p s0.6": call(stabilize_classic, sctx, 0.6)}
    fifth = {"classic 1080p s0.3": call(stabilize_classic, ctx, 0.3)}

    def rounds(calls, n_rounds, added=None):
        """(round, key, captures, pool rebuilds, ms) of each call; fails
        unless a rebuild recaptured every cached graph once."""
        out = []
        for r in range(n_rounds):
            for name, fn in calls.items():
                before = dict(FP.GRAPH_STATS)
                reserved = cache_memory()[0] if added is not None and r == 0 else None
                ms = timed_calls(fn, 1)[0]
                c, rb, rc = (FP.GRAPH_STATS[k] - before[k] for k in ("captures", "rebuilds", "recaptures"))
                check(rb in (0, 1) and rc == rb * len(FP._GRAPHS),
                      f"graph cache, {name}: {rb} rebuilds, {rc} recaptures, {len(FP._GRAPHS)} cached")
                out.append((r, name, c, rb, round(ms, 1)))
                if reserved is not None:
                    added[name] = (cache_memory()[0] - reserved) / gib
        return out

    FP.clear_graph_cache()
    reserved0, allocated0 = cache_memory()
    single = {}
    for name, fn in keys.items():
        fn()
        single[name] = (cache_memory()[0] - reserved0) / gib
        FP.clear_graph_cache()
    check(cache_memory()[0] - reserved0 <= 0.05 * gib, "the single graphs' memory was not returned")
    added = {}
    four = rounds(keys, 3, added)
    reserved1, allocated1 = cache_memory()
    check([c for _, _, c, _, _ in four] == [1] * 4 + [0] * 8,
          f"four keys in a cache of four: captures {[(r, k, c) for r, k, c, _, _ in four]}")
    check(len(FP._POOLS) == 1, f"graph pools {FP._POOLS}")
    kept = (reserved1 - reserved0) / gib
    largest = max(single.values())
    log(f"[graph cache] four keys, three rounds (round, key, captures, pool rebuilds, ms): {four}; GiB reserved "
        f"each key's graph "
        f"keeps alone {({k: round(v, 3) for k, v in single.items()})}; GiB each key adds as it is captured into "
        f"the shared pool {({k: round(v, 3) for k, v in added.items()})}; the four cached graphs keep {kept:.3f} "
        f"GiB reserved ({(allocated1 - allocated0) / gib:.3f} GiB allocated), the largest alone {largest:.3f}")
    check(kept <= largest + 0.5, f"four cached graphs keep {kept:.3f} GiB, past the largest single graph's "
          f"{largest:.3f} + 0.5")

    order = list(keys) + list(reversed(keys))
    with env(CVST_FUSED="0"):
        eager = {name: fn() for name, fn in keys.items()}
    equal, captures = [], FP.GRAPH_STATS["captures"]
    for name in order:
        res = keys[name]()
        ref = eager[name]
        equal.append((name, bool(torch.equal(res.frames, ref.frames)), bool(torch.equal(res.masks, ref.masks)),
                      res.meta == ref.meta))
        del res
    del eager, ref
    check(FP.GRAPH_STATS["captures"] == captures, "the interleaved replays captured a graph")
    log(f"[graph cache] interleaved replays (key, frames, masks, meta torch.equal to CVST_FUSED=0): {equal}")
    check(all(all(e[1:]) for e in equal), f"an interleaved replay differs from CVST_FUSED=0: {equal}")

    FP.clear_graph_cache()
    reserved2, allocated2 = cache_memory()
    cleared = (reserved2 - reserved0) / gib
    log(f"[graph cache] after clear_graph_cache(): {cleared:.3f} GiB reserved past the baseline "
        f"({(allocated2 - allocated0) / gib:.3f} GiB allocated)")
    check(abs(cleared) <= 0.05, f"clear_graph_cache() left {cleared:.3f} GiB")
    five = rounds({**keys, **fifth}, 2)
    check(all(c == 1 for _, _, c, _, _ in five), f"five keys cycled through a cache of four: {five}")
    FP.clear_graph_cache()
    log(f"[graph cache] five keys cycled, two rounds (round, key, captures, pool rebuilds, ms): {five}")
    return {"four": four, "five": five, "kept_gib": kept, "single_gib": single, "added_gib": added,
            "cleared_gib": cleared}


def fit_points(b: int, p: int, seed: int, model: str):
    """(b, p, 2) point pairs of a shaken clip's fits: a similarity (or a
    homography) per pair with 0.3 px noise, 30 % gross outliers and 20 %
    invalid slots, made from ``seed``."""
    rng = np.random.default_rng(seed)
    prev = rng.uniform(8, [952, 532], (b, p, 2)).astype(np.float32)
    curr = np.empty_like(prev)
    for i in range(b):
        th, sc = rng.uniform(-0.01, 0.01), np.exp(rng.uniform(-0.005, 0.005))
        m = np.array([[sc * np.cos(th), -sc * np.sin(th), rng.uniform(-6, 6)],
                      [sc * np.sin(th), sc * np.cos(th), rng.uniform(-6, 6)], [0, 0, 1.0]])
        if model == "perspective":
            m[2, :2] = rng.uniform(-2e-5, 2e-5, 2)
        hom = np.concatenate([prev[i], np.ones((p, 1), np.float32)], axis=1) @ m.T
        curr[i] = hom[:, :2] / hom[:, 2:] + rng.normal(0, 0.3, (p, 2))
        out = rng.random(p) < 0.3
        curr[i, out] += rng.uniform(30, 80, (int(out.sum()), 2)) * rng.choice([-1, 1], (int(out.sum()), 2))
    return prev, curr.astype(np.float32), rng.random((b, p)) >= 0.2


def phase_host_fits(device):
    """The batched RANSAC host calls (ops/ransac.py: fit_model_batch,
    median_translation_batch, reprojection_residuals) on the card at the
    main paths' shapes, Classic 1080p (79 pairs x 400 corners) and Flow
    1080p (79 pairs x the 960x540 fit grid's points), against the same
    calls with device="cpu": inlier and valid counts equal, similarity and
    median matrices within SMALL_MAT_TOL, residuals within 1e-4 px, the
    perspective fits' frame corners within PERSP_FIT_TOL_PX (their
    elementwise max|d| printed beside); the ms of each call
    (host clock, upload and fetch included; the median of 3 on the card
    after one warm call, one on the CPU)."""
    from comfyui_video_stabilizer_tpu_torch.ops import ransac as RS

    step = 8
    grid_pts = ((540 + step - 1) // step) * ((960 + step - 1) // step)
    out = {}
    for path, p in (("classic", 400), ("flow", grid_pts)):
        for model in ("similarity", "perspective"):
            prev, curr, valid = fit_points(CLIP_FRAMES - 1, p, seed=7 if path == "classic" else 8, model=model)
            calls = {"fit": lambda d: RS.fit_model_batch(prev, curr, valid, model, seed=0, device=d),
                     "median": lambda d: RS.median_translation_batch(prev, curr, valid, device=d),
                     "residuals": lambda d: RS.reprojection_residuals(mats, prev, curr, valid, device=d)}
            mats = RS.fit_model_batch(prev, curr, valid, model, device="cpu")[0]
            for name, fn in calls.items():
                if name != "fit" and model == "perspective":
                    continue
                t0 = time.perf_counter()
                ref = fn("cpu")
                cpu_ms = 1e3 * (time.perf_counter() - t0)
                gpu = fn(device)
                gpu_ms = float(np.median(timed_calls(lambda: fn(device), 3)))
                ref = ref if isinstance(ref, tuple) else (ref,)
                gpu = gpu if isinstance(gpu, tuple) else (gpu,)
                err = float(np.abs(gpu[0] - ref[0]).max())
                row = {"shape": (CLIP_FRAMES - 1, p), "max_abs_err": err, "ms": gpu_ms, "cpu_ms": cpu_ms}
                if name == "fit":
                    row["corner_px"] = max(float(np.abs(corner_projection(a) - corner_projection(b)).max())
                                           for a, b in zip(gpu[0], ref[0]))
                out[f"{path} {model} {name}"] = row
                if model == "perspective":
                    check(row["corner_px"] <= PERSP_FIT_TOL_PX,
                          f"host fits, {path} {model} {name}: card vs CPU corners {row['corner_px']} px")
                else:
                    tol = 1e-4 if name == "residuals" else SMALL_MAT_TOL
                    check(err <= tol, f"host fits, {path} {model} {name}: card vs CPU max|d| {err}")
                for a, b in zip(gpu[1:], ref[1:]):
                    check(a.dtype == b.dtype and np.array_equal(a, b), f"host fits, {path} {model} {name}: counts "
                          f"differ on {int((a != b).sum())} pairs")
    log(f"[host fits] card vs device='cpu' (counts equal; similarity matrices within {SMALL_MAT_TOL}, residuals "
        f"1e-4, perspective corners {PERSP_FIT_TOL_PX} px): "
        + "; ".join(f"{k} {v['shape']}: max|d| {v['max_abs_err']:.2e}"
                    + (f", corners {v['corner_px']:.2e} px" if "corner_px" in v else "")
                    + f", {v['ms']:.2f} ms on the card, {v['cpu_ms']:.1f} ms on the CPU" for k, v in out.items()))
    return out


def corner_projection(m) -> np.ndarray:
    """The 960x540 working frame's corners and centre through ``m``, in px."""
    pts = np.array([[0, 0], [960, 0], [0, 540], [960, 540], [480, 270]], np.float64)
    h = np.concatenate([pts, np.ones((len(pts), 1))], axis=1) @ np.asarray(m, np.float64).T
    return h[:, :2] / h[:, 2:3]


def phase_rectangle(device, frames):
    """The largest all-ones rectangle (ops/morphology.py), native and its
    numpy body, on the 1080p Flow call's closed content mask (the padding
    masks inverted, closed 3x3 on the card as crop framing closes them,
    and intersected over the 80 frames): equal tuples, the ms of each."""
    import torch

    from comfyui_video_stabilizer_tpu_torch.ops import morphology as M

    res = run_slice(make_context(frames), device)
    valid = M.erode(M.dilate(1.0 - res.masks, 1), 1) > 0.5
    mask = valid.all(dim=0).cpu().numpy()
    del res, valid
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    native = M.largest_axis_aligned_rectangle(mask)
    native_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    plain = M.largest_axis_aligned_rectangle_plain(mask)
    plain_ms = 1e3 * (time.perf_counter() - t0)
    x0, y0, w, h = native
    log(f"[rectangle] {mask.shape[1]}x{mask.shape[0]} closed content mask ({int(mask.sum())} valid pixels): native "
        f"{native} in {native_ms:.2f} ms, numpy {plain} in {plain_ms:.1f} ms")
    check(native == plain, f"rectangle: native {native} != numpy {plain}")
    check(w * h > 0 and bool(mask[y0:y0 + h, x0:x0 + w].all()), f"rectangle {native} is not all valid")
    return {"native_ms": native_ms, "plain_ms": plain_ms, "rect": native}


def fast_estimate_args(kind: str, mode: str = "similarity"):
    """(working size, decimation, the fast path's estimate argument tuple)
    of the slice's 1080p ``kind`` call (run_slice / run_classic) in
    transform ``mode``."""
    from comfyui_video_stabilizer_tpu_torch.models import fastpath as FP
    from comfyui_video_stabilizer_tpu_torch.models.classic import classic_estimator
    from comfyui_video_stabilizer_tpu_torch.models.flow import flow_estimator
    from comfyui_video_stabilizer_tpu_torch.models.stabilize import estimation_plan

    working, dec = estimation_plan(WIDTH, HEIGHT, flow_estimator if kind == "flow" else classic_estimator)
    strength, _, keep_fov, window, scale_xy = FP._trajectory_args(0.8, 0.6, 30.0, False, 0.6, WIDTH, HEIGHT,
                                                                   working)
    kw = dict(seed=0, mode=mode, camera_lock=False, window=window, width=WIDTH, height=HEIGHT,
              scale_xy=scale_xy)
    if kind == "flow":
        kw["decimation"] = dec
    return working, dec, (strength, keep_fov, kw)


def phase_fast_split(device, frames, kind="flow", mode="similarity"):
    """The fast path's 1080p x 80 ``kind`` call in transform ``mode`` stage
    by stage, a synchronize after each (median of 3): the gray, the graph
    replay (with the copy of the grays in and of the outputs out), the
    padding stats, K1 and the one diagnostics fetch; the whole warm call
    beside them."""
    import torch

    from comfyui_video_stabilizer_tpu_torch.models import fastpath as FP
    from comfyui_video_stabilizer_tpu_torch.ops import resize as R
    from comfyui_video_stabilizer_tpu_torch.ops import warp as W
    from comfyui_video_stabilizer_tpu_torch.utils.device import fetch_packed

    working, dec, est_args = fast_estimate_args(kind, mode)
    border = torch.full((3,), 127 / 255.0, device=device)
    splits = []
    for _ in range(3):
        ms = {}

        def stage(name, fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            ms[name] = round(1e3 * (time.perf_counter() - t0), 2)
            return out

        grays = stage("gray", lambda: R.gray_for_estimation(frames, working, decimation=dec))
        captures = FP.GRAPH_STATS["captures"]
        out = stage("graph replay", lambda: FP._fused_estimate(kind, grays, *est_args))
        check(FP.GRAPH_STATS["captures"] == captures, "the split captured a new graph")
        masks, ratios = stage("padding stats", lambda: W.padding_stats(out["coeffs"], HEIGHT, WIDTH, HEIGHT, WIDTH))
        stage("K1", lambda: W.warp_frames(frames, out["coeffs"], border, HEIGHT, WIDTH, "bilinear"))
        stage("fetch", lambda: fetch_packed({**{k: out[k] for k in FP.DIAG_KEYS}, "ratios": ratios}))
        splits.append(ms)
        del grays, out, masks, ratios
    ctx = make_context(frames)
    whole = timed_calls(lambda: (run_slice if kind == "flow" else run_classic)(ctx, device, transform=mode), 3)
    med = {k: float(np.median([s[k] for s in splits])) for k in splits[0]}
    log(f"[fast split] 1080p x {CLIP_FRAMES} {kind} crop_and_pad {mode}, the fast path, ms (median of 3, synchronize after "
        "each stage): " + ", ".join(f"{k} {v:.2f}" for k, v in med.items())
        + f"; sum {sum(med.values()):.2f}; whole warm call {[round(t, 1) for t in whole]}, median "
        f"{float(np.median(whole)):.1f}")
    return med


def host_available_bytes() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise SmokeFailure("no MemAvailable in /proc/meminfo")


def phase_config5(device):
    """BASELINE config 5: Flow, 3840x2160 x 300, expand, similarity, 24 fps,
    the clip held on the host (it streams past the device budget)."""
    import torch

    from comfyui_video_stabilizer_tpu_torch.ops import cuda_build
    from comfyui_video_stabilizer_tpu_torch.ops import warp as W

    n, h, w = BASELINE5
    # host: the clip, the streamed output on a canvas ~5 % larger per
    # side, its masks, and 12 GiB for everything else
    per_frame = 4 * h * w * 3 + int(1.1 * 4 * h * w * 4)
    avail = host_available_bytes()
    fit = (avail - (12 << 30)) // per_frame
    if fit < n:
        log(f"[config5] host memory available {avail / 2**30:.1f} GiB holds {fit} frames, not {n}: "
            f"the clip is cut to {fit} frames")
        n = int(fit)
    check(n >= 64, f"config 5: host memory holds only {n} frames")
    t0 = time.perf_counter()
    clip = synth_clip(n, h, w, seed=5, device=device, on_host=True)
    log(f"[config5] made the {w}x{h} x {n} clip on the host ({clip.numel() * 4 / 1e9:.1f} GB) in "
        f"{time.perf_counter() - t0:.1f} s; host memory available {avail / 2**30:.1f} GiB before")
    ctx = make_context(clip)
    streams = W.will_stream(n, h, w, h, w)
    walls, peaks = [], []
    for rep in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_build.reset_launches()
        t0 = time.perf_counter()
        res = run_stabilizer("flow", ctx, device, "expand", "similarity", fps=24.0)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        peaks.append(torch.cuda.max_memory_allocated() / 2**30)
        launches = dict(cuda_build.LAUNCHES)
        if rep == 0:
            ow, oh = res.meta["framing"]["expanded_size"]
            chunk = W._chunk_frames(n, h, w, oh, ow)
            check(tuple(res.frames.shape) == (n, oh, ow, 3) and tuple(res.masks.shape) == (n, oh, ow),
                  f"config 5: frames {tuple(res.frames.shape)}")
            check((res.frames.device.type == "cpu") == W.will_stream(n, h, w, oh, ow),
                  "config 5: a streamed result must lie on the host, an unstreamed one on the card")
            check(bool(torch.isfinite(res.frames[::17]).all()), "config 5: non-finite frames")
            mats = np.array([e["applied_matrix"] for e in res.meta["stabilization_warp"]["per_frame"]])
            stream_out = W.will_stream(n, h, w, oh, ow)
            log(f"[config5] expand canvas {ow}x{oh}; streamed {stream_out} (the input alone "
                f"{'streams' if streams else 'fits'}), chunk {chunk} frames; launches {launches}; "
                f"padding mean {res.meta['padding_fraction_mean']:.5f}")
        del res
    log(f"[config5] Flow {w}x{h} x {n} expand: wall {', '.join(f'{t:.2f}' for t in walls)} s, "
        f"{', '.join(f'{n / t:.1f}' for t in walls)} f/s; peak device memory "
        f"{', '.join(f'{g:.2f}' for g in peaks)} GiB")
    split = flow_stage_split(clip, device, "similarity", mats, (ow, oh))
    log(f"[config5] stage split (ms, synchronize after each): {split}")

    # the host<->device copies a streamed call makes, measured apart: the
    # clip up (once for the grays, once for the warp), and the frames and
    # masks down, into new host memory (as the engine's output) and again
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s0 in range(0, n, chunk):
        clip[s0:s0 + chunk].to(device)
    torch.cuda.synchronize()
    up = time.perf_counter() - t0
    host_out = torch.empty((chunk, oh, ow, 4))
    dev_out = torch.empty((chunk, oh, ow, 4), device=device)
    down = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for s0 in range(0, n, chunk):
            e = min(n, s0 + chunk)
            host_out[: e - s0].copy_(dev_out[: e - s0])
        torch.cuda.synchronize()
        down.append(time.perf_counter() - t0)
    del host_out, dev_out
    log(f"[config5] host<->device copies (pageable memory): the clip up {up:.2f} s "
        f"({clip.numel() * 4 / up / 1e9:.1f} GB/s; a streamed call uploads it twice), frames and masks "
        f"down {down[0]:.2f} s into new host memory ({n * oh * ow * 16 / down[0] / 1e9:.1f} GB/s), "
        f"{down[1]:.2f} s again ({n * oh * ow * 16 / down[1] / 1e9:.1f} GB/s)")

    # K1 at the 4K expand canvas, 16 frames, against its plain version
    border = torch.full((3,), 127 / 255.0, device=device)
    src = clip[:16].to(device)
    coeffs = torch.as_tensor(W.prepare_inverse_coeffs(mats[:16]).astype(np.float32), device=device)
    out = W.warp_frames(src, coeffs, border, oh, ow, "bilinear")
    ref = W.warp_plain(src, coeffs, border, oh, ow, "bilinear")
    torch.cuda.synchronize()
    check(bool(torch.equal(out, ref)), "K1 at the 4K expand canvas: differs from the plain version")
    del out, ref
    ms, plain_ms, tk, tp = timed_pair(lambda: W.warp_frames(src, coeffs, border, oh, ow, "bilinear"),
                                      lambda: W.warp_plain(src, coeffs, border, oh, ow, "bilinear"), 10, 2)
    lib = grid_sample_ms(src.permute(0, 3, 1, 2).contiguous(), coeffs, oh, ow, 10)
    b = warp_bound(16, h, w, 3, oh, ow, "bilinear")
    log(f"[config5] K1 (16, {h}, {w}, 3) -> {ow}x{oh} bilinear: bitwise equal; kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms (runs {tk}, {tp}); grid_sample {lib:.3f} ms; bound {b['bound_ms']:.3f} ms "
        f"({b['bound_by']})")
    return launches


def phase_forced_streaming(device, frames, meta4):
    """Flow, Classic and Motion Apply config 4 on the 1080p x 80 clip held
    on the host, with the chunk budget lowered to 20 frames, against the
    same calls unstreamed (Flow and Classic through the host engine, which
    a streamed call takes): frames and masks bitwise."""
    import torch

    from comfyui_video_stabilizer_tpu_torch.ops import cuda_build
    from comfyui_video_stabilizer_tpu_torch.ops import warp as W

    host = frames.cpu()
    runs = {
        "Flow": lambda: run_stabilizer("flow", make_context(host), device),
        "Classic": lambda: run_stabilizer("classic", make_context(host), device),
        "Motion Apply config 4": lambda: run_apply(make_context(host), meta4, device),
    }
    budget = W.CHUNK_BUDGET_BYTES
    for name, run in runs.items():
        # a streamed call goes through the host engine: so does its reference
        with env(CVST_FASTPATH="0"):
            ref = run()
        ref_frames, ref_masks = ref.frames.cpu(), ref.masks.cpu()
        del ref
        W.CHUNK_BUDGET_BYTES = 20 * W.clip_device_bytes(1, HEIGHT, WIDTH, HEIGHT, WIDTH)
        try:
            torch.cuda.synchronize()
            cuda_build.reset_launches()
            t0 = time.perf_counter()
            res = run()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            W.CHUNK_BUDGET_BYTES = budget
        check(res.frames.device.type == "cpu" and res.masks.device.type == "cpu", f"{name}: streamed result on the card")
        equal = (bool(torch.equal(res.frames, ref_frames)), bool(torch.equal(res.masks, ref_masks)))
        log(f"[streaming] {name}, 1080p x {CLIP_FRAMES} in 20-frame chunks: frames and masks bitwise equal to "
            f"the unstreamed call {equal}; {1e3 * secs:.1f} ms; launches {dict(cuda_build.LAUNCHES)}")
        check(all(equal), f"{name}: the streamed result differs from the unstreamed one")
        del res, ref_frames, ref_masks


def phase_65536(device):
    """Motion Apply on 65,536 frames of 64x64 RGB (bilinear, no blur): K1
    splits its launches at 65,535 frames; the result against the CPU path
    (run in 4,096-frame chunks to bound host memory)."""
    import torch

    from comfyui_video_stabilizer_tpu_torch.ops import cuda_build
    from comfyui_video_stabilizer_tpu_torch.ops import warp as W

    n, h, w = 65536, 64, 64
    gen = torch.Generator().manual_seed(11)
    frames = torch.nn.functional.avg_pool2d(torch.rand((n, 3, h + 4, w + 4), generator=gen), 5, 1)
    frames = frames.permute(0, 2, 3, 1).contiguous()
    meta = shake_meta("handheld", 11, n, h, w)
    kw = dict(interp="bilinear", blur=0.0)
    torch.cuda.synchronize()
    cuda_build.reset_launches()
    t0 = time.perf_counter()
    gpu = run_apply(make_context(frames.to(device)), meta, device, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(cuda_build.LAUNCHES)
    check(launches["warp"] == 2, f"65,536 frames: K1 launched {launches['warp']} times, not 2")
    budget = W.CHUNK_BUDGET_BYTES
    W.CHUNK_BUDGET_BYTES = 4096 * W.clip_device_bytes(1, h, w, h, w)
    try:
        t1 = time.perf_counter()
        cpu = run_apply(make_context(frames), meta, "cpu", **kw)
        cpu_secs = time.perf_counter() - t1
    finally:
        W.CHUNK_BUDGET_BYTES = budget
    d = (cpu.frames - gpu.frames.cpu()).abs().flatten()
    p99 = float(torch.quantile(d[:: max(1, d.numel() // 1_000_000)], 0.99))
    unequal = float((cpu.masks != gpu.masks.cpu()).float().mean())
    log(f"[65536] Motion Apply {n} x {w}x{h} RGB ({W.clip_device_bytes(1, h, w, h, w)} B a frame), bilinear: "
        f"launches {launches}; CUDA {1e3 * secs:.1f} ms, CPU path {cpu_secs:.1f} s; frames p99 {p99:.3e}, "
        f"max {float(d.max()):.3e}, bitwise {bool(torch.equal(cpu.frames, gpu.frames.cpu()))}; masks unequal on "
        f"{unequal:.2e} of pixels")
    check(tuple(gpu.frames.shape) == (n, h, w, 3), f"65,536 frames: {tuple(gpu.frames.shape)}")
    check(p99 <= APPLY_FRAME_P99 and unequal <= APPLY_MASK_UNEQUAL, "65,536 frames: CUDA and CPU paths differ")


MESH_SHARDS = 4          # the mesh phase's shards, all on cuda:0
SIDECAR_SHIFT_TOL = 1e-5  # translation sidecar, card vs CPU (tests/test_torch_pipeline.py)


def _same_result(res, ref, what: str) -> dict:
    """torch.equal of frames and masks (gathered from their shards), and
    equality of the per-pair and applied matrices and of the whole meta;
    fails unless frames, masks and matrices are equal."""
    import torch

    from comfyui_video_stabilizer_tpu_torch.parallel.mesh import FrameShards

    def whole(x):
        return x.gather() if isinstance(x, FrameShards) else x

    eq = {"frames": bool(torch.equal(whole(res.frames), ref.frames)),
          "masks": bool(torch.equal(whole(res.masks), ref.masks)),
          "per_transition": res.meta["estimated_motion"]["per_transition"]
          == ref.meta["estimated_motion"]["per_transition"],
          "applied": res.meta["stabilization_warp"] == ref.meta["stabilization_warp"]}
    check(all(eq.values()), f"{what}: the sharded call differs from the unsharded one: {eq}")
    eq["meta"] = res.meta == ref.meta
    return eq


def _k1_row_bands(device, frames) -> dict:
    """K1 with row0 at 1080p: each 540-row band bitwise its plain version
    and the same rows of the whole-frame launch, which (row0 = 0) is
    bitwise the whole-frame plain version."""
    import torch

    from comfyui_video_stabilizer_tpu_torch.ops import warp as W

    src = frames[:8].contiguous()
    mats = np.stack(shake_matrices(8, 11, 0.01, 6.0))
    coeffs = torch.as_tensor(W.prepare_inverse_coeffs(mats).astype(np.float32), device=device)
    border = torch.tensor([0.5, 0.25, 0.75], device=device)
    out = {}
    for interp in ("bilinear", "bicubic"):
        whole = W.warp_frames(src, coeffs, border, HEIGHT, WIDTH, interp, row0=0)
        ok = bool(torch.equal(whole, W.warp_plain(src, coeffs, border, HEIGHT, WIDTH, interp)))
        for r0 in (0, HEIGHT // 2):
            band = W.warp_frames(src, coeffs, border, HEIGHT // 2, WIDTH, interp, row0=r0)
            plain = W.warp_plain(src, coeffs, border, HEIGHT // 2, WIDTH, interp, row0=r0)
            ok = ok and bool(torch.equal(band, plain)) and bool(torch.equal(band, whole[:, r0:r0 + HEIGHT // 2]))
        out[interp] = ok
    torch.cuda.synchronize()
    check(all(out.values()), f"K1 with row0 differs from its plain version or the whole frame: {out}")
    return out


def phase_mesh(device):
    """The multi-device layer (parallel/), on four shards of one card: the
    1080p x 80 Flow slice through stabilize_flow_sharded (the fast path's
    mesh branch) torch.equal to the unsharded call run eagerly
    (CVST_FUSED=0), with K2's and K1's launches by shard and five warm
    calls beside the unsharded graph call in turns; the same clip through
    stabilize_classic_sharded against the unsharded call; a 79-frame clip
    on a (2, 2) mesh (the "rows" outcome: two bands of output rows, K1
    with row0) against the unsharded host engine, and K1 with row0
    against its plain version; both sidecars at 1080p x 80, and on a
    small clip against their CPU runs; with more than one card, the Flow
    check again on distinct cards."""
    import torch

    from comfyui_video_stabilizer_tpu_torch.models import fastpath as FP
    from comfyui_video_stabilizer_tpu_torch.models.flow import stabilize_flow
    from comfyui_video_stabilizer_tpu_torch.ops import cuda_build
    from comfyui_video_stabilizer_tpu_torch.parallel import mesh as PM
    from comfyui_video_stabilizer_tpu_torch.parallel import pipeline as PL
    from comfyui_video_stabilizer_tpu_torch.parallel import production as PR
    from comfyui_video_stabilizer_tpu_torch.utils.meshinfo import set_mesh

    frames = synth_clip(CLIP_FRAMES, HEIGHT, WIDTH, seed=0, device=device)
    host = frames.cpu().numpy()
    mesh = PM.make_mesh(devices=[str(device)] * MESH_SHARDS)
    kw = dict(framing_mode="crop_and_pad", transform_mode="similarity", strength=0.8, smooth=0.6, keep_fov=0.6,
              padding_rgb=(127, 127, 127), frame_rate=30.0)
    out = {}

    # Flow: the fast path's mesh branch against the eager unsharded call
    with env(CVST_FUSED="0"), served("flow", 1, "mesh: the unsharded Flow call"):
        cuda_build.reset_launches()
        ref = run_slice(make_context(frames), device)
        torch.cuda.synchronize()
        ref_launches = dict(cuda_build.LAUNCHES)
    mesh_served = FP.SERVED["mesh"]
    PM.reset_transfers()
    cuda_build.reset_launches()
    with served("flow", 1, "mesh: the sharded Flow call"):
        res = PR.stabilize_flow_sharded(host, mesh, **kw)
    torch.cuda.synchronize()
    flow_launches = dict(cuda_build.LAUNCHES)
    check(FP.SERVED["mesh"] == mesh_served + 1, "the sharded Flow call did not run the fast path's mesh branch")
    check(isinstance(res.frames, PM.FrameShards) and len(res.frames.shards) == MESH_SHARDS,
          f"the sharded Flow frames are {type(res.frames).__name__}, not {MESH_SHARDS} frame shards")
    check(flow_launches["cost_volume"] == MESH_SHARDS * ref_launches["cost_volume"],
          f"K2 launches {flow_launches['cost_volume']} by shard, not {MESH_SHARDS} x {ref_launches['cost_volume']}")
    check(flow_launches["warp"] == MESH_SHARDS, f"K1 launches {flow_launches['warp']}, not one a shard")
    check(PM.TRANSFERS == {"halo": 0, "gather": 0, "scatter": 0}, f"copies on one card: {PM.TRANSFERS}")
    out["flow_equal"] = _same_result(res, ref, "mesh Flow")
    del res, ref
    log(f"[mesh] Flow 1080p x {CLIP_FRAMES} on {MESH_SHARDS} shards of one card: equal to the unsharded eager "
        f"call {out['flow_equal']}; launches by shard {flow_launches} (unsharded: {ref_launches}); copies "
        f"{dict(PM.TRANSFERS)}")

    # warm calls in turns: sharded (contexts already on the card) beside
    # the unsharded call from its CUDA graph
    ctx_sh = PR.sharded_video_context(host, mesh, fps=30.0)
    ctx_one = make_context(frames)
    run_slice(ctx_one, device)  # the graph, captured if it is not cached

    def sharded_call():
        with set_mesh(mesh):
            return stabilize_flow(ctx_sh, "crop_and_pad", "similarity", False, 0.8, 0.6, 0.6, (127, 127, 127),
                                  30.0, device=device)

    times = {"sharded": [], "graph": []}
    with served("flow", 10, "mesh: the warm calls"):
        for _ in range(5):
            times["sharded"] += timed_calls(sharded_call, 1)
            times["graph"] += timed_calls(lambda: run_slice(ctx_one, device), 1)
    out["times"] = times
    log(f"[mesh] warm Flow calls in turns, ms: sharded ({MESH_SHARDS} shards, one card) "
        f"{[round(t, 1) for t in times['sharded']]}, unsharded from its graph {[round(t, 1) for t in times['graph']]}; "
        f"medians {float(np.median(times['sharded'])):.1f} / {float(np.median(times['graph'])):.1f} ms")
    del ctx_sh

    # Classic: against the unsharded call run eagerly (equal to its graph
    # call, phase 10), so its launch counts are one call's
    cuda_build.reset_launches()
    with env(CVST_FUSED="0"), served("classic", 1, "mesh: the unsharded Classic call"):
        ref = run_classic(make_context(frames), device)
    torch.cuda.synchronize()
    ref_launches = dict(cuda_build.LAUNCHES)
    cuda_build.reset_launches()
    with served("classic", 1, "mesh: the sharded Classic call"):
        res = PR.stabilize_classic_sharded(host, mesh, **kw)
    torch.cuda.synchronize()
    classic_launches = dict(cuda_build.LAUNCHES)
    for name in ("gftt", "greedy", "lk_gn", "extract_windows"):
        check(classic_launches[name] == MESH_SHARDS * ref_launches[name],
              f"{name} launches {classic_launches[name]} by shard, not {MESH_SHARDS} x {ref_launches[name]}")
    check(classic_launches["warp"] == MESH_SHARDS, f"Classic K1 launches {classic_launches['warp']}")
    out["classic_equal"] = _same_result(res, ref, "mesh Classic")
    del res, ref
    log(f"[mesh] Classic 1080p x {CLIP_FRAMES} on {MESH_SHARDS} shards: equal to the unsharded call "
        f"{out['classic_equal']}; launches by shard {classic_launches} (unsharded: {ref_launches})")

    # row bands: 79 frames on a (2, 2) mesh, against the host engine
    rows_mesh = PM.make_mesh(devices=[str(device)] * MESH_SHARDS, spatial=2)
    check(PR.input_partition_spec(rows_mesh, CLIP_FRAMES - 1, HEIGHT) == (None, "spatial", None, None),
          "79 frames on a (2, 2) mesh do not take the rows outcome")
    with env(CVST_FASTPATH="0"):
        ref = run_slice(make_context(frames[:-1].contiguous()), device)
    cuda_build.reset_launches()
    with served("flow", 0, "mesh: the rows outcome"):
        res = PR.stabilize_flow_sharded(host[:-1], rows_mesh, **kw)
    torch.cuda.synchronize()
    rows_launches = dict(cuda_build.LAUNCHES)
    check(isinstance(res.frames, PM.FrameShards) and res.frames.axis == 1 and len(res.frames.shards) == 2,
          "the rows outcome did not warp two bands of rows")
    check(rows_launches["warp"] == 2, f"rows outcome: K1 launches {rows_launches['warp']}, not one a band")
    out["rows_equal"] = _same_result(res, ref, "mesh rows")
    del res, ref
    out["k1_row0"] = _k1_row_bands(device, frames)
    log(f"[mesh] rows outcome, 1080p x {CLIP_FRAMES - 1} on a (2, 2) mesh: equal to the unsharded host engine "
        f"{out['rows_equal']}; launches {rows_launches}; K1 with row0 bitwise its plain version {out['k1_row0']}")

    # the sidecars at 1080p x 80, then on a small clip against their CPU runs
    side = {}
    for name, fn, args in (("translation", PL.sharded_stabilize, (0.9, 5)),
                           ("similarity", PL.sharded_stabilize_similarity, (1.0, 15))):
        t0 = time.perf_counter()
        warped, masks, per_frame = fn(host, mesh, *args)
        ms = 1e3 * (time.perf_counter() - t0)
        check(warped.shape == host.shape and masks.shape == host.shape[:3], f"sidecar {name}: shapes")
        check(bool(np.isfinite(warped).all() and np.isfinite(masks).all() and np.isfinite(per_frame).all()),
              f"sidecar {name}: non-finite output")
        side[name] = {"ms": ms, "padded": float(masks.mean())}
        del warped, masks
    small = synth_clip(16, 128, 192, seed=5, device=device).cpu().numpy()
    cpu_mesh = PM.make_mesh(devices=["cpu"] * MESH_SHARDS)
    w_g, m_g, o_g = PL.sharded_stabilize(small, mesh, 0.9, 5)
    w_c, m_c, o_c = PL.sharded_stabilize(small, cpu_mesh, 0.9, 5)
    side["translation"]["vs_cpu"] = [float(np.abs(w_g - w_c).max()), float((m_g != m_c).mean()),
                                     float(np.abs(o_g - o_c).max())]
    check(side["translation"]["vs_cpu"][0] <= SIDECAR_SHIFT_TOL and side["translation"]["vs_cpu"][1] == 0.0
          and side["translation"]["vs_cpu"][2] <= SIDECAR_SHIFT_TOL,
          f"translation sidecar, card vs CPU: {side['translation']['vs_cpu']}")
    w_g, m_g, c_g = PL.sharded_stabilize_similarity(small, mesh, 1.0, 15)
    w_c, m_c, c_c = PL.sharded_stabilize_similarity(small, cpu_mesh, 1.0, 15)
    d = np.abs(w_g - w_c)
    side["similarity"]["vs_cpu"] = [float(np.quantile(d, 0.99)), float(d.max()), float((m_g != m_c).mean()),
                                    float(np.abs(c_g - c_c).max())]
    v = side["similarity"]["vs_cpu"]
    check(v[0] <= SMALL_FRAME_P99 and v[1] <= 1e-2 and v[2] <= APPLY_MASK_UNEQUAL and v[3] <= SMALL_MAT_TOL,
          f"similarity sidecar, card vs CPU: {v}")
    out["sidecars"] = side
    log(f"[mesh] sidecars at 1080p x {CLIP_FRAMES} on {MESH_SHARDS} shards: "
        + "; ".join(f"{k} {s['ms']:.1f} ms (padded share {s['padded']:.4f}), small clip vs CPU {s['vs_cpu']}"
                    for k, s in side.items()))

    # distinct cards
    count = torch.cuda.device_count()
    if count > 1:
        k = max(d for d in range(2, count + 1) if CLIP_FRAMES % d == 0)
        cards = PM.make_mesh(n_devices=k)
        with env(CVST_FUSED="0"):
            ref = run_slice(make_context(frames), device)
        PM.reset_transfers()
        with served("flow", 1, "mesh: distinct cards"):
            res = PR.stabilize_flow_sharded(host, cards, **kw)
        torch.cuda.synchronize()
        check(res.frames.devices == list(cards.devices[:, 0]), "the shards are not on their cards")
        check(PM.TRANSFERS["halo"] == k - 1, f"halo copies {PM.TRANSFERS['halo']}, not {k - 1}")
        out["cards_equal"] = _same_result(res, ref, "mesh, distinct cards")
        copies = dict(PM.TRANSFERS)
        del res, ref
        ctx_cards = PR.sharded_video_context(host, cards, fps=30.0)

        def cards_call():
            with set_mesh(cards):
                return stabilize_flow(ctx_cards, "crop_and_pad", "similarity", False, 0.8, 0.6, 0.6,
                                      (127, 127, 127), 30.0, device=device)

        cards_ms, graph_ms = [], []
        for _ in range(5):
            cards_ms += timed_calls(cards_call, 1)
            graph_ms += timed_calls(lambda: run_slice(ctx_one, device), 1)
        out["cards_times"] = {"cards": cards_ms, "graph": graph_ms}
        log(f"[mesh] Flow on {k} distinct cards: equal to the unsharded call {out['cards_equal']}; copies "
            f"{copies}; warm calls in turns, ms: {k} cards {[round(t, 1) for t in cards_ms]}, one card from "
            f"its graph {[round(t, 1) for t in graph_ms]}")
        del ctx_cards
    else:
        log("[mesh] one card: the Flow check on distinct cards needs more than one and did not run")
    return out


def timed_phase(name, fn, *args):
    """Run one phase and print its wall time on a line of its own."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"[time] {name}: {time.perf_counter() - t0:.1f} s")
    return out


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
    smi = timed_phase("setup", phase_setup)
    timed_phase("build", phase_build)
    k1 = timed_phase("K1", phase_k1, device)
    frames = synth_clip(CLIP_FRAMES, HEIGHT, WIDTH, seed=0, device=device)
    torch.cuda.synchronize()
    k2 = timed_phase("K2", phase_k2, device, frames)
    launches, _fps = timed_phase("Flow slice", phase_slice, device, frames)
    timed_phase("Flow reference", phase_small_reference, device)
    timed_phase("Flow node", phase_node, frames[:16].cpu())
    k8 = timed_phase("K8", phase_k8, device, frames)
    k9 = timed_phase("K9", phase_k9, device, frames)

    grays = classic_grays(frames)
    torch.cuda.synchronize()
    k4 = timed_phase("K4", phase_k4, grays)
    k7 = timed_phase("K7", phase_k7, grays)
    k6 = timed_phase("K6", phase_k6, grays)
    k5 = timed_phase("K5", phase_k5, grays)
    del grays
    classic_launches, _ = timed_phase("Classic slice", phase_classic, device, frames)
    classic_graph = timed_phase("Classic graph", phase_fused, device, frames, "classic")
    classic_split = timed_phase("Classic fast split", phase_fast_split, device, frames, "classic")
    timed_phase("Classic reference", phase_small_reference, device, run_classic, "classic reference")
    timed_phase("Classic node", phase_node, frames[:16].cpu(), "VideoStabilizerClassic")
    timed_phase("crop", phase_crop, device, frames)
    config3_launches = timed_phase("config 3", phase_config3, device, frames)
    k10, k11, k11_4pt = timed_phase("K10/K11", phase_k10_k11, device, frames)

    meta4 = shake_meta("action", 3, CLIP_FRAMES, HEIGHT, WIDTH)
    # every profile ahead of K3's check: once K3's plain version has run at
    # 80 frames, torch.profiler records no device events for the rest of
    # the process; config 4 (3 device events a call) ahead of the Flow
    # chain's profiles, as it ran before they existed
    apply_launches, _ = timed_phase("config 4", phase_motion_apply, device, frames, meta4)
    dense_launches, k2_r3, dense_ms = timed_phase("dense DIS", phase_dense_dis, device, frames)
    tier_ms = timed_phase("fallback tiers", phase_fallback_tiers, device, frames)
    timed_phase("kernel error", phase_kernel_error, device, frames)
    host_ms = timed_phase("Flow split", phase_flow_split, device, frames)
    fast_host = timed_phase("fast vs host", phase_fast_vs_host, device, frames)
    fused = timed_phase("fused graph", phase_fused, device, frames)
    fast_split = timed_phase("fast split", phase_fast_split, device, frames)
    persp = timed_phase("perspective graph", phase_persp_graph, device, frames)
    persp_split = {kind: timed_phase(f"{kind} perspective split", phase_fast_split, device, frames, kind, "perspective")
                   for kind in ("flow", "classic")}
    log(f"[profiler] {len(PROFILE_LOSSES)} sessions; leading pads lost in each (of {PROFILE_PAD}): "
        f"{[n for n, _ in PROFILE_LOSSES]}, at most ~{max(ms for _, ms in PROFILE_LOSSES):.2f} ms of pad")
    # after every profiled phase: see the docstring's phase 27
    normalize = timed_phase("normalize", phase_normalize, device)
    graph_cache = timed_phase("graph cache", phase_graph_cache, device, frames)
    host_fits = timed_phase("host fits", phase_host_fits, device)
    rectangle = timed_phase("rectangle", phase_rectangle, device, frames)
    k3 = timed_phase("K3", phase_k3, device, frames, meta4)
    timed_phase("config 2", phase_config2, device)
    timed_phase("Motion Apply reference", phase_apply_reference, device)
    timed_phase("Motion Apply nodes", phase_motion_nodes, frames[:16].cpu())
    timed_phase("forced streaming", phase_forced_streaming, device, frames, meta4)
    del frames
    torch.cuda.empty_cache()
    timed_phase("65,536 frames", phase_65536, device)
    config5_launches = timed_phase("config 5", phase_config5, device)
    mesh = timed_phase("mesh", phase_mesh, device)
    log(f"[launches] K1 / K2 a call: config 3 {config3_launches['warp']} / {config3_launches['cost_volume']}, "
        f"config 5 {config5_launches['warp']} / {config5_launches['cost_volume']}; K2 in dense dis_flow "
        f"{dense_launches}")
    log(f"[summary] dense dis_flow 960x540 x {CLIP_FRAMES} {dense_ms:.1f} ms; Flow 1080p x {CLIP_FRAMES} with "
        f"TV-L1 {tier_ms['TVL1']:.1f} ms, with phase correlation {tier_ms['phase_correlate']:.1f} ms; host "
        f"trajectory + meta between the fits' fetch and K1's launch {host_ms:.2f} ms")
    log(f"[summary] {smi}: fast path, Flow 1080p x {CLIP_FRAMES} crop_and_pad: from its CUDA graph {fused['fused_ms']:.1f} ms "
        f"({CLIP_FRAMES / fused['fused_ms'] * 1e3:.1f} f/s), eager {fused['eager_ms']:.1f} ms, host engine "
        f"{fast_host['host']:.1f} ms; first call with the capture {fused['first_ms']:.1f} ms; the replay alone "
        f"{fused['replay_ms']:.2f} ms; {fused['events']} device events a call ({fused['graph_events']} in the graph); "
        f"launches {fused['launches']}; split {fast_split}")
    log(f"[summary] {smi}: fast path, Classic 1080p x {CLIP_FRAMES} crop_and_pad: from its CUDA graph "
        f"{classic_graph['fused_ms']:.1f} ms ({CLIP_FRAMES / classic_graph['fused_ms'] * 1e3:.1f} f/s), eager "
        f"{classic_graph['eager_ms']:.1f} ms; first call with the capture {classic_graph['first_ms']:.1f} ms; the "
        f"replay alone {classic_graph['replay_ms']:.2f} ms; {classic_graph['events']} device events a call "
        f"({classic_graph['graph_events']} in the graph); device-to-host copies before K1 "
        f"{classic_graph['dtoh_before_k1']}, in the call {classic_graph['dtoh']}; split {classic_split}")
    log(f"[summary] {smi}: graph cache (one shared pool): the Classic graph keeps "
        f"{classic_graph['kept']['reserved_gib']:.3f} GiB, Flow's {fused['kept']['reserved_gib']:.3f} GiB, four cached "
        f"graphs {graph_cache['kept_gib']:.3f} GiB (the largest alone {max(graph_cache['single_gib'].values()):.3f}), "
        f"{graph_cache['cleared_gib']:.3f} GiB after clear_graph_cache(); "
        f"host issue medians, ms, graph / eager: Classic {classic_graph['issue_ms']['graph']:.2f} / "
        f"{classic_graph['issue_ms']['eager']:.2f}, Flow {fused['issue_ms']['graph']:.2f} / "
        f"{fused['issue_ms']['eager']:.2f}")
    log(f"[summary] {smi}: perspective crop_and_pad 1080p x {CLIP_FRAMES} from the CUDA graphs (K10, K11 inside): "
        + "; ".join(f"{k} {persp[k]['graph_ms']:.1f} ms (eager {persp[k]['eager_ms']:.1f}; the replay alone "
                    f"{persp[k]['replay_ms']:.2f}; first call {persp[k]['first_ms']:.1f}; keeps "
                    f"{persp[k]['kept_gib']:.3f} GiB; K10 / K11 4-point / K11 general launches "
                    f"{persp[k]['launches']['smallest_eigvec']} / {persp[k]['launches']['homography_4pt']} / "
                    f"{persp[k]['launches']['solve8']}; split {persp_split[k]})" for k in ("flow", "classic"))
        + f"; both graphs keep {persp['kept_both_gib']:.3f} GiB")
    log(f"[summary] {smi}: the unrepaired uint8 / 0..255 normalization would move full-size gray pixels: "
        f"{({k: v['gray pixels'] for k, v in normalize.items()})}; host fits on the card, ms: "
        f"{({k: round(v['ms'], 2) for k, v in host_fits.items()})}; the largest rectangle native "
        f"{rectangle['native_ms']:.2f} ms, numpy {rectangle['plain_ms']:.1f} ms")
    log(f"[summary] {smi}: mesh, {MESH_SHARDS} shards of one card, Flow 1080p x {CLIP_FRAMES} crop_and_pad: "
        f"sharded {float(np.median(mesh['times']['sharded'])):.1f} ms, unsharded from its graph "
        f"{float(np.median(mesh['times']['graph'])):.1f} ms (medians of 5 in turns); sharded Flow, Classic and "
        f"rows bitwise equal to unsharded")
    check("jax" not in sys.modules, "jax was imported")
    jax_pkg = [m for m in sys.modules if m.split(".")[0] == "comfyui_video_stabilizer_tpu"]
    check(not jax_pkg, f"modules of the JAX package were imported: {sorted(jax_pkg)}")

    kernels = [
        {"name": "warp", "route": "cuda",
         "source": "comfyui_video_stabilizer_tpu_torch/csrc/warp.cu",
         "replaces": "comfyui_video_stabilizer_tpu/ops/warp_pallas.py:525",
         "launches": launches["warp"], **k1},
        {"name": "warp_blur", "route": "cuda",
         "source": "comfyui_video_stabilizer_tpu_torch/csrc/warp.cu",
         "replaces": "comfyui_video_stabilizer_tpu/ops/warp_pallas.py:525",
         "launches": apply_launches["warp_blur"], **k3},
        {"name": "cost_volume", "route": "cuda",
         "source": "comfyui_video_stabilizer_tpu_torch/csrc/cost_volume.cu",
         "replaces": "comfyui_video_stabilizer_tpu/ops/cv_pallas.py:178",
         "launches": launches["cost_volume"], **k2,
         "r3": {"path": "dense dis_flow", "launches": dense_launches, **k2_r3}},
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
        {"name": "greedy", "route": "cuda",
         "source": "comfyui_video_stabilizer_tpu_torch/csrc/greedy.cu",
         "replaces": "comfyui_video_stabilizer_tpu/ops/lk.py:162",
         "note": "the JAX package runs this stage as an XLA lax.scan (_greedy_device), not a pallas_call",
         "launches": classic_launches["greedy"], **k7},
        {"name": "padding_stats", "route": "cuda",
         "source": "comfyui_video_stabilizer_tpu_torch/csrc/warp.cu",
         "replaces": "comfyui_video_stabilizer_tpu/ops/warp.py:262",
         "note": "the JAX package runs this stage as XLA (_padding_stats_xla; the bucket's _padding_stats_bucket "
                 ":283), not a pallas_call",
         "launches": launches["padding_stats"], **k8},
        {"name": "gray_pool", "route": "cuda",
         "source": "comfyui_video_stabilizer_tpu_torch/csrc/gray.cu",
         "replaces": "comfyui_video_stabilizer_tpu/ops/resize.py:93",
         "note": "the JAX package runs this stage as XLA (_gray_pool_kernel; the gray alone _gray_kernel :54), "
                 "not a pallas_call",
         "launches": launches["gray_pool"], **k9},
        {"name": "smallest_eigvec", "route": "cuda",
         "source": "comfyui_video_stabilizer_tpu_torch/csrc/linalg.cu",
         "replaces": "comfyui_video_stabilizer_tpu/ops/ransac.py:112",
         "note": "the JAX package runs this stage as XLA (jnp.linalg.eigh in _refit_homography), not a pallas_call; "
                 "launches from a warm Flow 1080p x 80 crop_and_pad perspective call (its graph replay)",
         "launches": persp["flow"]["launches"]["smallest_eigvec"],
         "launches_classic": persp["classic"]["launches"]["smallest_eigvec"], **k10},
        {"name": "solve8", "route": "cuda",
         "source": "comfyui_video_stabilizer_tpu_torch/csrc/linalg.cu",
         "replaces": "comfyui_video_stabilizer_tpu/ops/flow_dis.py:341",
         "note": "the general entry; the JAX package runs this stage as XLA (jnp.linalg.solve of the IRLS "
                 "pre-warp's normal equations), not a pallas_call; launches from a warm Flow 1080p x 80 "
                 "crop_and_pad perspective call (its graph replay); systems_40448: the Flow call's 4-point "
                 "sets' systems",
         "launches": persp["flow"]["launches"]["solve8"],
         "launches_classic": persp["classic"]["launches"]["solve8"], **k11},
        {"name": "homography_4pt", "route": "cuda",
         "source": "comfyui_video_stabilizer_tpu_torch/csrc/linalg.cu",
         "replaces": "comfyui_video_stabilizer_tpu/ops/ransac.py:60",
         "note": "K11's 4-point entry, which builds each system itself; the JAX package runs this stage as XLA "
                 "(jnp.linalg.solve in _solve_homography_4pt), not a pallas_call; launches from a warm Flow "
                 "1080p x 80 crop_and_pad perspective call (its graph replay)",
         "launches": persp["flow"]["launches"]["homography_4pt"],
         "launches_classic": persp["classic"]["launches"]["homography_4pt"], **k11_4pt},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
