#!/usr/bin/env python3
"""Digests and warm-call times of the 1080p x 80 Flow and Classic slices.

Runs ``chip_smoke.py``'s Flow and Classic crop_and_pad calls on its
shaken 1080p x 80 clip (seed 0) from the checkout at TREE, on one GPU,
in similarity ("flow", "classic") and in perspective
("flow_perspective", "classic_perspective"), and prints one line
``SLICE {json}``: per call the SHA-256 digests (16 hex digits) of the
frames, masks, per-pair matrices, meta and the estimation grays, and
seven warm calls' milliseconds (host clock around
``torch.cuda.synchronize()``) with their median; then, under "kernels",
the digests and CUDA-event times of K8 (the padding stats) on the Flow
slice's coefficients, on perspective copies of them and on a 4K expand
bucket, of K7 (the corner greedy) on the Classic slice's candidates, of
K10 (the DLT refit's smallest eigenvector) on 79 and 127 normalized-DLT
normal matrices, of K11's general 8x8 solve on 40,448 4-point systems
and 79 IRLS-like ones, and of the 4-point hypotheses
(``ops/ransac.py::_solve_homography_4pt``) on 79 x 512 and 127 x 512
draws, through the checkout's own wrappers; the K10 and K11 inputs are
made here from a numpy seed.

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


def linalg_inputs(device) -> dict:
    """The K10 and K11 inputs, from numpy seed 15: normalized-DLT normal
    matrices of 400 noisy correspondences a pair (79 and 127 pairs),
    4-point draws with replacement from 60 correspondences a pair (512 a
    pair; repeated points among them), the 79 x 512 draws' systems
    A + 1e-12 I and b built in float32, and 79 IRLS-like systems (a
    40 x 24 grid, Cauchy-like weights, ridge 1e-6)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(15)

    def homography(persp):
        th, sc = rng.uniform(-0.02, 0.02), np.exp(rng.uniform(-0.01, 0.01))
        return np.array([[sc * np.cos(th), -sc * np.sin(th), rng.uniform(-8, 8)],
                         [sc * np.sin(th), sc * np.cos(th), rng.uniform(-8, 8)],
                         [rng.uniform(-persp, persp), rng.uniform(-persp, persp), 1.0]])

    def project(H, pts):
        h = np.concatenate([pts, np.ones(pts.shape[:-1] + (1,))], -1) @ H.T
        return h[..., :2] / h[..., 2:]

    def pairs(b, n):
        p = rng.uniform(0, [960, 540], (b, n, 2))
        q = np.stack([project(homography(2e-5), p[i]) for i in range(b)]) + rng.normal(0, 0.3, (b, n, 2))
        return p, q

    def normals(b):
        out = []
        for pi, qi in zip(*pairs(b, 400)):
            pn = (pi - pi.mean(0)) / np.sqrt(((pi - pi.mean(0)) ** 2).sum(1).mean())
            qn = (qi - qi.mean(0)) / np.sqrt(((qi - qi.mean(0)) ** 2).sum(1).mean())
            x, y, u, v = pn[:, 0], pn[:, 1], qn[:, 0], qn[:, 1]
            z, o = np.zeros_like(x), np.ones_like(x)
            A = np.concatenate([np.stack([x, y, o, z, z, z, -x * u, -y * u, -u], -1),
                                np.stack([z, z, z, x, y, o, -x * v, -y * v, -v], -1)]).astype(np.float32)
            out.append(A.T @ A)
        return np.stack(out).astype(np.float32)

    def draws(b):
        p, q = (t.astype(np.float32) for t in pairs(b, 60))
        idx = rng.integers(0, 60, (b, 512, 4))
        return (np.take_along_axis(p[:, None], idx[..., None], 2), np.take_along_axis(q[:, None], idx[..., None], 2))

    def systems(p, q):
        x, y, u, v = p[..., 0], p[..., 1], q[..., 0], q[..., 1]
        z, o = np.zeros_like(x), np.ones_like(x)
        A = np.concatenate([np.stack([x, y, o, z, z, z, -x * u, -y * u], -1),
                            np.stack([z, z, z, x, y, o, -x * v, -y * v], -1)], -2)
        A = A + np.float32(1e-12) * np.eye(8, dtype=np.float32)
        return A.reshape(-1, 8, 8), np.concatenate([u, v], -1).reshape(-1, 8)

    def irls(b):
        ys, xs = np.mgrid[-1:1:24j, -1:1:40j]
        pn = np.stack([xs.ravel(), ys.ravel()], 1)
        out_a, out_b = [], []
        for _ in range(b):
            H = homography(2e-3)
            H[:2, 2] /= 200.0
            qn = project(H, pn) + rng.normal(0, 1e-3, pn.shape)
            w = rng.uniform(0.1, 1.0, len(pn))
            x, y, u, v = pn[:, 0], pn[:, 1], qn[:, 0], qn[:, 1]
            z, o = np.zeros_like(x), np.ones_like(x)
            A = np.concatenate([np.stack([x, y, o, z, z, z, -x * u, -y * u], -1),
                                np.stack([z, z, z, x, y, o, -x * v, -y * v], -1)])
            ww = np.concatenate([w, w])
            out_a.append((A * ww[:, None]).T @ A + 1e-6 * np.eye(8))
            out_b.append((A * ww[:, None]).T @ np.concatenate([u, v]))
        return np.stack(out_a).astype(np.float32), np.stack(out_b).astype(np.float32)

    d79, d127 = draws(79), draws(127)
    made = {"normals_79": normals(79), "normals_127": normals(127), "draws_79": d79, "draws_127": d127,
            "systems_40448": systems(*d79), "irls_79": irls(79)}
    dev = lambda t: tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in t)  # noqa: E731
    return {k: dev(v) if isinstance(v, tuple) else torch.from_numpy(v).to(device) for k, v in made.items()}


def graph_ms(fn, reps: int = 20) -> float:
    """Device ms of one fn() call: ``reps`` calls captured in one CUDA
    graph, the best of three replays after a warm one (CUDA events); a
    copy of ``chip_smoke.graph_ms``, which an older checkout lacks."""
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
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return min(times)


def kernel_times(C, frames, device, digest) -> dict:
    """Digest and ms (CUDA events, mean of 20 after one warm call) of each
    K8 and K7 input set, and of each K10 and K11 one also the device ms in
    a CUDA graph ("graph_ms": their wrappers take longer to issue than the
    kernels to run); the inputs are made here, so both checkouts get the
    same ones."""
    import numpy as np
    import torch

    from comfyui_video_stabilizer_tpu_torch.models import fastpath as FP
    from comfyui_video_stabilizer_tpu_torch.ops import greedy_cuda as GR
    from comfyui_video_stabilizer_tpu_torch.ops import linalg_cuda as LA
    from comfyui_video_stabilizer_tpu_torch.ops import ransac as RS
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
    la = linalg_inputs(device)
    calls.update({
        "k10_79": lambda: (LA.smallest_eigvec(la["normals_79"]),),
        "k10_127": lambda: (LA.smallest_eigvec(la["normals_127"]),),
        "k11_40448": lambda: (LA.solve8(*la["systems_40448"]),),
        "k11_irls_79": lambda: (LA.solve8(*la["irls_79"]),),
        "k11_4pt_79x512": lambda: (RS._solve_homography_4pt(*la["draws_79"]),),
        "k11_4pt_127x512": lambda: (RS._solve_homography_4pt(*la["draws_127"]),),
    })
    out = {}
    for name, fn in calls.items():
        res = fn()
        torch.cuda.synchronize()
        out[name] = {"digest": digest(b"".join(t.contiguous().cpu().numpy().tobytes() for t in res)),
                     "ms": C.cuda_ms(fn, 20)}
        if name.startswith(("k10", "k11")):
            out[name]["graph_ms"] = graph_ms(fn)
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
    calls = [(kind + suffix, run, est, transform)
             for suffix, transform in (("", "similarity"), ("_perspective", "perspective"))
             for kind, run, est in (("flow", C.run_slice, flow_estimator), ("classic", C.run_classic, classic_estimator))]
    for kind, run_kind, est, transform in calls:
        def run(ctx, device, run_kind=run_kind, transform=transform):
            return run_kind(ctx, device, transform=transform)

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
