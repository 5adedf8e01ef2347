#!/usr/bin/env python3
"""Digests and warm-call times of the 1080p x 80 Flow and Classic slices.

Runs ``chip_smoke.py``'s Flow and Classic crop_and_pad calls on its
shaken 1080p x 80 clip (seed 0) from the checkout at TREE, on one GPU,
and prints one line ``SLICE {json}``: per kind the SHA-256 digests (16
hex digits) of the frames, masks, per-pair matrices, meta and the
estimation grays, and seven warm calls' milliseconds (host clock around
``torch.cuda.synchronize()``) with their median.

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
    print("SLICE " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
