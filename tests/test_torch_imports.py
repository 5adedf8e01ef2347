"""The PyTorch package imports no JAX and no module of the JAX
package, shares the JAX package's constants, and refuses CUDA where
there is none.

The import check runs in a subprocess: this test session imports JAX
for every test (tests/conftest.py).  It imports every module of the
port and runs all six nodes and the host entry points (the batched
fits, the largest rectangle, the package exports) on the CPU before it
looks, both stabilizers also with crop framing and the perspective model and, with
``CVST_FASTPATH=1``, through the fast path in all three framings, the
Flow node also with each fallback tier forced (TV-L1, phase
correlation).
"""

import os
import pathlib
import subprocess
import sys
import textwrap
from dataclasses import asdict

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]

_CPU_SLICE = textwrap.dedent(
    """
    import sys
    import numpy as np
    import torch
    import comfyui_video_stabilizer_tpu_torch
    from comfyui_video_stabilizer_tpu_torch import nodes
    from comfyui_video_stabilizer_tpu_torch.ops import cuda_build, cv_cuda, flow_dis, prng, ransac, resize, warp
    from comfyui_video_stabilizer_tpu_torch.ops import extract_cuda, gftt_cuda, greedy_cuda, lk, lk_cuda, morphology
    from comfyui_video_stabilizer_tpu_torch.ops import pad
    from comfyui_video_stabilizer_tpu_torch.ops import phase_corr, tvl1
    from comfyui_video_stabilizer_tpu_torch.models import classic, fastpath, flow, framing, geometry, inverse
    from comfyui_video_stabilizer_tpu_torch.models import motion_apply
    from comfyui_video_stabilizer_tpu_torch.models import shake, stabilize
    from comfyui_video_stabilizer_tpu_torch.meta import motion_meta
    from comfyui_video_stabilizer_tpu_torch.native import rectangle
    from comfyui_video_stabilizer_tpu_torch.nodes import replacements
    from comfyui_video_stabilizer_tpu_torch.utils import color, device, profiling, video_io

    rng = np.random.default_rng(0)
    base = rng.random((80, 112)).astype(np.float32)
    base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1) + np.roll(base, (1, 1), (0, 1))) / 4
    frames = np.stack([np.roll(base, (i, 2 * i), (0, 1))[8:72, 8:104] for i in range(5)])
    frames = np.repeat(frames[..., None], 3, axis=-1)
    out = nodes.VideoStabilizerFlow.execute(
        torch.from_numpy(frames), 16.0, "crop_and_pad", "similarity", False,
        0.8, 0.6, 0.6, "#7F7F7F", device="cpu")
    assert tuple(out[0].shape) == (5, 64, 96, 3), out[0].shape
    assert out[2]["flow_backend"] == "DIS"
    out = nodes.VideoStabilizerClassic.execute(
        torch.from_numpy(frames), 16.0, "crop_and_pad", "similarity", False,
        0.8, 0.6, 0.6, "#7F7F7F", device="cpu")
    assert tuple(out[0].shape) == (5, 64, 96, 3), out[0].shape
    assert len(out[2]["estimated_motion"]["per_transition"]) == 4
    stab_meta = out[2]
    for node in (nodes.VideoStabilizerFlow, nodes.VideoStabilizerClassic):
        out = node.execute(torch.from_numpy(frames), 16.0, "crop", "perspective", False,
                           0.8, 0.6, 0.6, "#7F7F7F", device="cpu")
        assert out[2]["transform_mode_requested"] == "perspective"
        assert out[2]["framing"]["keep_fov_status"] in ("met", "clamped", "failed", "disabled")
    import os
    os.environ["CVST_FASTPATH"] = "1"
    fast_runs = []
    for name in ("run_flow_fast", "run_classic_fast"):
        real = getattr(fastpath, name)
        setattr(fastpath, name, lambda *a, _r=real, **k: fast_runs.append(_r(*a, **k)) or fast_runs[-1])
    for node in (nodes.VideoStabilizerFlow, nodes.VideoStabilizerClassic):
        for framing in ("crop_and_pad", "expand", "crop"):
            out = node.execute(torch.from_numpy(frames), 16.0, framing, "similarity", False,
                               0.8, 0.6, 0.6, "#7F7F7F", device="cpu")
            assert out[0].shape[0] == 5 and out[2]["framing"]["mode"] == framing
    assert len(fast_runs) == 6 and all(r is not None for r in fast_runs), fast_runs
    del os.environ["CVST_FASTPATH"]
    def outage(*_a, **_k):
        raise RuntimeError("synthetic backend outage")

    real_dis, real_tvl1 = flow_dis.dis_flow_fit, tvl1.tvl1_flow
    flow_dis.dis_flow_fit = outage
    for tier in ("TVL1", "phase_correlate"):
        if tier == "phase_correlate":
            tvl1.tvl1_flow = outage
        out = nodes.VideoStabilizerFlow.execute(
            torch.from_numpy(frames), 16.0, "crop_and_pad", "similarity", False,
            0.8, 0.6, 0.6, "#7F7F7F", device="cpu")
        assert out[2]["flow_backend"] == tier, out[2]["flow_fallback_reason"]
    flow_dis.dis_flow_fit, tvl1.tvl1_flow = real_dis, real_tvl1
    clip = torch.from_numpy(frames)
    shake_meta = nodes.VideoStabilizerShakeGenerator.execute(clip, 16.0, "handheld", 1.0, 1.0, 3)[0]
    manual = nodes.VideoStabilizerShakeGeneratorManual.execute(
        clip, 16.0, 0.4, 0.33, 0.5, 0.003, 0.35, 0.35, 5.0, 0.0, 0.0, 0.3, 60.0, 1.0, 1.0, 3)[0]
    assert manual["motion_meta"]["frame_count"] == 5
    out = nodes.VideoStabilizerMotionApply.execute(
        clip, shake_meta, "crop_and_pad", "bicubic", "#7F7F7F", 0.5, "Draft", device="cpu")
    assert tuple(out[0].shape) == (5, 64, 96, 3) and out[2]["motion_apply"]["motion_blur_samples"] == 5
    out = nodes.VideoStabilizerInverse.execute(out[0], stab_meta, "#7F7F7F", device="cpu")
    assert "inverse_stabilization" in out[2]
    from comfyui_video_stabilizer_tpu_torch import parallel
    from comfyui_video_stabilizer_tpu_torch.parallel import mesh as pmesh, pipeline, production
    from comfyui_video_stabilizer_tpu_torch.utils import meshinfo
    mesh = pmesh.make_mesh(devices=["cpu"] * 4)
    clip4 = np.ascontiguousarray(frames[:4], np.float32)
    for entry in (production.stabilize_flow_sharded, production.stabilize_classic_sharded):
        res = entry(clip4, mesh)
        assert isinstance(res.frames, pmesh.FrameShards) and res.frames.shape == (4, 64, 96, 3)
    for entry in (pipeline.sharded_stabilize, pipeline.sharded_stabilize_similarity):
        warped, masks, _ = entry(clip4, mesh)
        assert warped.shape == (4, 64, 96, 3) and masks.shape == (4, 64, 96)
    assert not meshinfo.mesh_active() and parallel.make_mesh is pmesh.make_mesh
    from comfyui_video_stabilizer_tpu_torch import models as tmodels, ops as tops, utils as tutils
    from comfyui_video_stabilizer_tpu_torch.nodes import stabilizer_nodes
    assert comfyui_video_stabilizer_tpu_torch.MotionMeta is motion_meta.MotionMeta
    assert tutils.normalize_video_input is video_io.normalize_video_input and tops.warp_clip is warp.warp_clip
    assert tmodels.geometry is geometry and stabilizer_nodes.VideoStabilizerFlowExtension
    pts = rng.uniform(0, 90, (2, 40, 2)).astype(np.float32)
    ok = np.ones((2, 40), bool)
    H, n_in, _ = ransac.fit_model_batch(pts, pts + 1.5, ok, "similarity", device="cpu")
    assert n_in.tolist() == [40, 40]
    assert ransac.median_translation_batch(pts, pts + 1.5, ok, device="cpu")[0, 0, 2] == 1.5
    assert ransac.reprojection_residuals(H, pts, pts + 1.5, ok, device="cpu").shape == (2,)
    assert morphology.largest_axis_aligned_rectangle(np.ones((6, 9), bool)) == (0, 0, 9, 6)
    assert all(v == 0 for v in cuda_build.LAUNCHES.values()), cuda_build.LAUNCHES
    assert "warp_blur" in cuda_build.LAUNCHES
    assert "jax" not in sys.modules, sorted(m for m in sys.modules if m.startswith("jax"))
    jax_pkg = sorted(m for m in sys.modules if m == "comfyui_video_stabilizer_tpu"
                     or m.startswith("comfyui_video_stabilizer_tpu."))
    assert not jax_pkg, jax_pkg
    print("NO_JAX_OK")
    """
)


def test_port_imports_and_runs_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", _CPU_SLICE], cwd=str(ROOT), env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "NO_JAX_OK" in proc.stdout


_LK_CONSTANTS = ["MAX_CORNERS", "QUALITY_LEVEL", "MIN_DISTANCE", "BLOCK_SIZE", "WIN", "MAX_LEVEL",
                 "MAX_ITERS", "EPS", "TRAVEL", "WEXT"]
_LK_KERNELS = ["_SOBEL_X", "_SOBEL_Y", "_SCHARR_LK_X", "_SCHARR_LK_Y"]


def _constant_pairs():
    from comfyui_video_stabilizer_tpu.models import classic as JCL
    from comfyui_video_stabilizer_tpu.models import shake as JSH
    from comfyui_video_stabilizer_tpu.nodes import motion_apply_node as JMAN
    from comfyui_video_stabilizer_tpu.models import flow as JFL
    from comfyui_video_stabilizer_tpu.models import stabilize as JST
    from comfyui_video_stabilizer_tpu.ops import flow_dis as JFD
    from comfyui_video_stabilizer_tpu.ops import gftt_pallas as JGP
    from comfyui_video_stabilizer_tpu.ops import lk as JLK
    from comfyui_video_stabilizer_tpu.ops import ransac as JRS
    from comfyui_video_stabilizer_tpu.ops import resize as JR
    from comfyui_video_stabilizer_tpu_torch.models import classic as TCL
    from comfyui_video_stabilizer_tpu_torch.models import shake as TSH
    from comfyui_video_stabilizer_tpu_torch.nodes import motion_apply_node as TMAN
    from comfyui_video_stabilizer_tpu_torch.models import flow as TFL
    from comfyui_video_stabilizer_tpu_torch.models import stabilize as TST
    from comfyui_video_stabilizer_tpu_torch.ops import flow_dis as TFD
    from comfyui_video_stabilizer_tpu_torch.ops import gftt_cuda as TGF
    from comfyui_video_stabilizer_tpu_torch.ops import lk as TLK
    from comfyui_video_stabilizer_tpu_torch.ops import ransac as TRS
    from comfyui_video_stabilizer_tpu_torch.ops import resize as TR

    return {
        "SAMPLE_STEP": (JFL.SAMPLE_STEP, TFL.SAMPLE_STEP),
        "MIN_VALID": (JFL.MIN_VALID, TFL.MIN_VALID),
        "SIM_MIN_RATIO": (JFL.SIM_MIN_RATIO, TFL.SIM_MIN_RATIO),
        "FINEST_SCALE": (JFD.FINEST_SCALE, TFD.FINEST_SCALE),
        "RADIUS": (JFD.RADIUS, TFD.RADIUS),
        "PATCH": (JFD.PATCH, TFD.PATCH),
        "DEFAULT_HYPOTHESES": (JRS.DEFAULT_HYPOTHESES, TRS.DEFAULT_HYPOTHESES),
        "SIM_THRESH": (JRS.SIM_THRESH, TRS.SIM_THRESH),
        "_CHUNK": (JRS._CHUNK, TRS._CHUNK),
        "_LUMA": (JR._LUMA.tolist(), TR._LUMA.tolist()),
        "ESTIMATION_CHUNK_PAIRS": (JST.ESTIMATION_CHUNK_PAIRS, TST.ESTIMATION_CHUNK_PAIRS),
        "MODE_PRIORITY": (JST.MODE_PRIORITY, TST.MODE_PRIORITY),
        "MIN_FEATURES": (JCL.MIN_FEATURES, TCL.MIN_FEATURES),
        "MIN_TRACKS": (JCL.MIN_TRACKS, TCL.MIN_TRACKS),
        "CLASSIC_SIM_MIN_RATIO": (JCL.SIM_MIN_RATIO, TCL.SIM_MIN_RATIO),
        "GFTT_RADIUS": (JGP.RADIUS, TGF.RADIUS),
        "BLUR_QUALITY_SAMPLES": (JMAN.BLUR_QUALITY_SAMPLES, TMAN.BLUR_QUALITY_SAMPLES),
        "STYLES": ({k: asdict(v) for k, v in JSH.STYLES.items()},
                   {k: asdict(v) for k, v in TSH.STYLES.items()}),
        **{name: (getattr(JLK, name), getattr(TLK, name)) for name in _LK_CONSTANTS},
        **{name: (getattr(JLK, name).tolist(), getattr(TLK, name).tolist()) for name in _LK_KERNELS},
    }


@pytest.mark.parametrize("name", [
    "SAMPLE_STEP", "MIN_VALID", "SIM_MIN_RATIO", "FINEST_SCALE",
    "RADIUS", "PATCH", "DEFAULT_HYPOTHESES", "SIM_THRESH", "_CHUNK", "_LUMA",
    "ESTIMATION_CHUNK_PAIRS", "MODE_PRIORITY", "MIN_FEATURES", "MIN_TRACKS",
    "CLASSIC_SIM_MIN_RATIO", "GFTT_RADIUS", "BLUR_QUALITY_SAMPLES", "STYLES",
    *_LK_CONSTANTS, *_LK_KERNELS,
])
def test_constants_equal_jax(name):
    """Tolerance: exact (the constants are copied, not derived)."""
    ref, ours = _constant_pairs()[name]
    assert ours == ref


def test_cuda_request_without_card_raises(monkeypatch):
    from comfyui_video_stabilizer_tpu_torch.models.flow import stabilize_flow
    from comfyui_video_stabilizer_tpu_torch.utils import device as D
    from comfyui_video_stabilizer_tpu_torch.utils.video_io import normalize_video_input

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        D.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        normalize_video_input(torch.zeros((2, 16, 16, 3)))  # default device is cuda
    ctx = normalize_video_input(torch.zeros((2, 16, 16, 3)), device="cpu")
    with pytest.raises(RuntimeError, match="is_available"):
        stabilize_flow(ctx, "crop_and_pad", "similarity", False, 0.8, 0.6, 0.6, (0, 0, 0), 30.0)
    assert D.resolve_device("cpu").type == "cpu"


def test_cpu_tensor_takes_plain_versions_without_launching():
    """A CPU tensor never reaches the kernel library (no build, no launch)."""
    from comfyui_video_stabilizer_tpu_torch.ops import (cuda_build, cv_cuda, extract_cuda, gftt_cuda, greedy_cuda,
                                                        linalg_cuda, lk_cuda, warp)

    cuda_build.reset_launches()
    frames = torch.rand((1, 8, 8, 3))
    coeffs = torch.tensor([[1.0, 0, 0.5, 0, 1.0, 0.25, 0, 0]])
    out = warp.warp_frames(frames, coeffs, torch.zeros(3), 8, 8)
    assert torch.equal(out, warp.warp_plain(frames, coeffs, torch.zeros(3), 8, 8, "bilinear"))
    grays = torch.rand((2, 12, 12)) * 255
    fx, fy, cmin = cv_cuda.cost_volume_subpixel(grays, grays, 2, 8)
    assert torch.equal(cmin, cv_cuda.cost_volume_plain(grays, grays, 2, 8)[2])
    assert torch.equal(gftt_cuda.gftt_scores_gray(grays), gftt_cuda.gftt_gray_plain(grays))
    corners = torch.tensor([[[0, 0], [5, -3]], [[11, 11], [-20, 4]]], dtype=torch.int32)
    assert torch.equal(extract_cuda.extract_windows(grays, corners, 7),
                       extract_cuda.extract_plain(grays, corners, 7))
    n = 2
    jw = torch.rand((n, 49, 49))
    T, gx, gy = (torch.rand((n, 31, 31)) for _ in range(3))
    scal = torch.tensor([[50.0, 1.0, 60.0, 1 / 2999.0, 1.0, 0.0, 0.0, 24.5, 23.5]] * n)
    g, count = lk_cuda.lk_gn_iterate(jw, T, gx, gy, scal, 50, 0.01)
    g_ref, count_ref = lk_cuda.lk_gn_plain(jw, T, gx, gy, scal, 50, 0.01)
    assert torch.equal(g, g_ref) and torch.equal(count, count_ref)
    coeffs_s = torch.stack([coeffs, coeffs + 0.25, coeffs - 0.25], dim=1)
    blur, mask = warp.warp_blur_frames(frames, coeffs_s, torch.zeros(3), 8, 8, "bicubic", True)
    ref, ref_mask = warp.warp_blur_mask_plain(frames, coeffs_s, torch.zeros(3), 8, 8, "bicubic")
    assert torch.equal(blur, ref) and torch.equal(mask, ref_mask)
    with pytest.raises(ValueError, match="bilinear or bicubic"):
        warp.warp_blur_frames(frames, coeffs_s, torch.zeros(3), 8, 8, "nearest")
    top = torch.tensor([[5, 60, 40, -1], [-1, -1, -1, -1]], dtype=torch.int32)
    pts, counts = greedy_cuda.greedy_min_distance(top, 12, 3)
    assert torch.equal(pts, greedy_cuda.greedy_plain(top, 12, 3)[0]) and counts.tolist() == [2, 0]
    spd = torch.eye(9) * 3.0 + 0.5
    assert torch.equal(linalg_cuda.smallest_eigvec(spd[None]), linalg_cuda.smallest_eigvec_plain(spd[None]))
    A, b = torch.eye(8)[None] * 2.0, torch.ones((1, 8))
    assert torch.equal(linalg_cuda.solve8(A, b), linalg_cuda.solve8_plain(A, b))
    quad = torch.tensor([[[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [1.0, 1.0]]])
    assert torch.equal(linalg_cuda.solve_homography_4pt(quad, quad * 2.0),
                       linalg_cuda.homography_4pt_plain(quad, quad * 2.0))
    assert set(cuda_build.LAUNCHES) == {"warp", "warp_blur", "cost_volume", "gftt", "lk_gn",
                                        "extract_windows", "greedy", "padding_stats", "gray_pool",
                                        "smallest_eigvec", "solve8", "homography_4pt"}
    assert all(v == 0 for v in cuda_build.LAUNCHES.values()), cuda_build.LAUNCHES
