#!/usr/bin/env python3
"""Digests and warm-call times of the 1080p x 80 Flow and Classic slices.

Runs ``chip_smoke.py``'s Flow and Classic crop_and_pad calls on its
shaken 1080p x 80 clip (seed 0) from the checkout at TREE, on one GPU,
and prints one line ``SLICE {json}``: per kind the SHA-256 digests (16
hex digits) of the frames, masks, per-pair matrices, meta and the
estimation grays, and seven warm calls' milliseconds (host clock around
``torch.cuda.synchronize()``) with their median; then, under "kernels",
the digests and CUDA-event times of K8 (the padding stats) on the Flow
slice's coefficients, on perspective copies of them and on a 4K expand
bucket, and of K7 (the corner greedy) on the Classic slice's candidates,
through the checkout's own wrappers.

Two commits compare on one card by running it for both checkouts in
turns (parent, change, change, parent): equal digests mean bitwise
equal results.

    python3 slice_digest.py TREE LABEL
"""

import hashlib
import json
import os
import sys
import time


def kernel_times(C, frames, device, digest) -> dict:
    """Digest and ms (CUDA events, mean of 20 after one warm call) of each
    K8 and K7 input set; the inputs are made here, so both checkouts get
    the same ones."""
    import numpy as np
    import torch

    from comfyui_video_stabilizer_tpu_torch.models import fastpath as FP
    from comfyui_video_stabilizer_tpu_torch.ops import greedy_cuda as GR
    from comfyui_video_stabilizer_tpu_torch.ops import lk as LK
    from comfyui_video_stabilizer_tpu_torch.ops import resize as R
    from comfyui_video_stabilizer_tpu_torch.ops import warp as W

    h, w = C.HEIGHT, C.WIDTH
    working, dec, est_args = C.fast_estimate_args("flow")
    coeffs = FP._fused_estimate("flow", R.gray_for_estimation(frames, working, decimation=dec), *est_args)["coeffs"]
    persp = coeffs.cpu().numpy().copy()  # chip_smoke.py::perspective_copy(coeffs, 17)
    persp[:, 6:] = np.random.default_rng(17).uniform(-2e-5, 2e-5, (len(persp), 2)).astype(np.float32)
    persp = torch.from_numpy(persp).to(device)
    shift = np.array([[1.0, 0, 25.0], [0, 1.0, 32.0], [0, 0, 1.0]])
    mats = np.stack([shift @ m for m in C.shake_matrices(C.CLIP_FRAMES, 5, 0.003, 3.0)])
    c4k = torch.as_tensor(W.prepare_inverse_coeffs(mats).astype(np.float32), device=device)
    out_wh = torch.tensor([3890, 2224], dtype=torch.int32, device=device)
    grays = C.classic_grays(frames)[:-1]
    top = LK._topk_packed(grays, LK.TOP_K)
    calls = {
        "k8_similarity": lambda: W.padding_counts(coeffs, h, w, h, w),
        "k8_perspective": lambda: W.padding_counts(persp, h, w, h, w),
        "k8_4k_bucket": lambda: W.padding_counts(c4k, 2160 + 128, 3840 + 128, 2160, 3840, out_wh=out_wh),
        "k7": lambda: GR.greedy_min_distance(top, grays.shape[2], LK.MAX_CORNERS, LK.MIN_DISTANCE),
    }
    out = {}
    for name, fn in calls.items():
        res = fn()
        torch.cuda.synchronize()
        out[name] = {"digest": digest(b"".join(t.contiguous().cpu().numpy().tobytes() for t in res)),
                     "ms": C.cuda_ms(fn, 20)}
        del res
    return out


def main() -> int:
    tree, label = sys.argv[1], sys.argv[2]
    sys.path.insert(0, os.path.abspath(tree))
    os.chdir(tree)
    import numpy as np
    import torch

    import chip_smoke as C

    if not torch.cuda.is_available():
        print("slice_digest: torch.cuda.is_available() is False; it needs a GPU", file=sys.stderr)
        return 2
    from comfyui_video_stabilizer_tpu_torch.models.classic import classic_estimator
    from comfyui_video_stabilizer_tpu_torch.models.flow import flow_estimator
    from comfyui_video_stabilizer_tpu_torch.models.stabilize import estimation_plan
    from comfyui_video_stabilizer_tpu_torch.ops import resize as R

    def digest(data) -> str:
        if isinstance(data, torch.Tensor):
            data = data.detach().contiguous().cpu().numpy().tobytes()
        return hashlib.sha256(data).hexdigest()[:16]

    device = torch.device("cuda", 0)
    frames = C.synth_clip(C.CLIP_FRAMES, C.HEIGHT, C.WIDTH, seed=0, device=device)
    ctx = C.make_context(frames)
    out = {"label": label, "device": torch.cuda.get_device_name(0)}
    for kind, run, est in (("flow", C.run_slice, flow_estimator), ("classic", C.run_classic, classic_estimator)):
        run(ctx, device)  # the graph's warm-up and capture
        res = run(ctx, device)
        torch.cuda.synchronize()
        mats = np.array([t["matrix"] for t in res.meta["estimated_motion"]["per_transition"]])
        working, dec = estimation_plan(C.WIDTH, C.HEIGHT, est)
        out[kind] = {"frames": digest(res.frames), "masks": digest(res.masks), "mats": digest(mats.tobytes()),
                     "meta": digest(json.dumps(res.meta, sort_keys=True, default=str).encode()),
                     "grays": digest(R.gray_for_estimation(frames, working, decimation=dec))}
        del res
        times = []
        for _ in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(ctx, device)
            torch.cuda.synchronize()
            times.append(round(1e3 * (time.perf_counter() - t0), 2))
        out[kind].update(ms=times, median_ms=float(np.median(times)))
    out["kernels"] = kernel_times(C, frames, device, digest)
    print("SLICE " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
