"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one.  The file imports no JAX, so on a machine without JAX it runs
without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q

Tolerance: bitwise.  The kernels are built with ``-fmad=false`` and
follow the plain versions' op order, so every multiply and add rounds
the same way.  The end-to-end cases compare the CUDA path with the CPU
path (the plain versions) on a small clip: per-pair modes equal,
matrices <= 1e-3, frames p99 <= 1e-3 (reductions run in another order
on the card); Motion Apply, which has no reductions, frames p99 <= 1e-6
and masks differing on <= 0.1 % of pixels (a round-half-even tie of the
coverage may flip on a one-ulp coordinate).  The stabilizers take the
fast path on both devices there (``CVST_FASTPATH=1`` on the CPU); the
Flow call from its CUDA graph equals the same call run eagerly
bitwise.  A test that patches a function the graph captured clears the
graph cache first.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from comfyui_video_stabilizer_tpu_torch.models import fastpath as FP  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import cuda_build  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import cv_cuda as CV  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import extract_cuda as EX  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import gftt_cuda as GF  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import lk as LK  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import lk_cuda as LKC  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import warp as W  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _mats(n, seed, persp=0.0, shift=(0.0, 0.0)):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        th = rng.uniform(-0.02, 0.02)
        s = np.exp(rng.uniform(-0.01, 0.01))
        tx, ty = rng.uniform(-6, 6, 2) + np.asarray(shift) * (-1) ** i
        out.append(np.array([[s * np.cos(th), -s * np.sin(th), tx],
                             [s * np.sin(th), s * np.cos(th), ty], [persp, -persp / 2, 1.0]]))
    return np.stack(out)


@pytest.mark.parametrize("interp", ["bilinear", "bicubic", "nearest"])
@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("case", ["similarity", "perspective", "past_edge"])
def test_warp_kernel_bitwise(cuda, interp, channels, case):
    n, h, w = 3, 97, 161
    frames = torch.rand((n, h, w, channels), generator=torch.Generator().manual_seed(1)).to(cuda)
    mats = _mats(n, 2, persp=1e-4 if case == "perspective" else 0.0,
                 shift=(150.0, 60.0) if case == "past_edge" else (0.0, 0.0))
    coeffs = torch.as_tensor(W.prepare_inverse_coeffs(mats).astype(np.float32), device=cuda)
    border = torch.linspace(0.1, 0.9, channels, device=cuda)
    out = W.warp_frames(frames, coeffs, border, h + 5, w - 7, interp)
    ref = W.warp_plain(frames, coeffs, border, h + 5, w - 7, interp)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


@pytest.mark.parametrize("samples", [3, 5, 33])
@pytest.mark.parametrize("interp", ["bilinear", "bicubic"])
@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("case", ["similarity", "past_edge", "expand", "zoom_out"])
def test_warp_blur_kernel_bitwise(cuda, interp, channels, samples, case):
    """Frames and soft mask.  past_edge: tiles straddle the frame's edge;
    expand: a canvas larger than the frame; zoom_out: each 32x8 tile's
    source footprint exceeds the staging budget, so its taps are read
    from device memory."""
    n, h, w = 3, 97, 161
    out_h, out_w = (h + 40, w + 56) if case == "expand" else (h + 5, w - 7)
    frames = torch.rand((n, h, w, channels), generator=torch.Generator().manual_seed(2)).to(cuda)
    mats = np.concatenate([_mats(n, 3, persp=1e-4, shift=(150.0, 60.0) if case == "past_edge" else (0.0, 0.0)),
                           _mats(1, 4)])
    if case == "expand":
        mats = np.array([[1.0, 0.0, 28.0], [0.0, 1.0, 20.0], [0.0, 0.0, 1.0]]) @ mats
    elif case == "zoom_out":
        mats = np.diag([0.15, 0.15, 1.0]) @ mats
    ts = np.linspace(0.0, 0.6, samples)  # shutter samples toward the next matrix
    sample_mats = mats[:n, None] + (mats[1:] - mats[:-1])[:, None] * ts[None, :, None, None]
    coeffs = torch.as_tensor(W.prepare_inverse_coeffs(sample_mats.reshape(-1, 3, 3))
                             .astype(np.float32).reshape(n, samples, 8), device=cuda)
    border = torch.linspace(0.1, 0.9, channels, device=cuda)
    stats = torch.zeros(3, dtype=torch.int64, device=cuda)
    out, mask = W.warp_blur_frames(frames, coeffs, border, out_h, out_w, interp, True, stats=stats)
    ref, ref_mask = W.warp_blur_mask_plain(frames, coeffs, border, out_h, out_w, interp)
    frames_only, no_mask = W.warp_blur_frames(frames, coeffs, border, out_h, out_w, interp)
    torch.cuda.synchronize()
    assert torch.equal(out, ref) and torch.equal(mask, ref_mask)
    assert torch.equal(frames_only, ref) and no_mask is None
    assert ((mask > 0) & (mask < 1)).any()
    tiles, unstaged, _ = stats.tolist()
    assert tiles == n * -(-out_h // 8) * -(-out_w // 32)  # 32x8 tiles
    if case == "zoom_out":
        assert unstaged > 0
    elif case != "past_edge":  # past_edge's shutter spans ~180 px, past the budget too
        assert unstaged == 0


@pytest.mark.parametrize("radius", [2, 3])
@pytest.mark.parametrize("shape", [(3, 18, 24), (2, 37, 53), (1, 16, 30), (4, 135, 240)])
def test_cost_volume_kernel_bitwise(cuda, radius, shape):
    gen = torch.Generator().manual_seed(5)
    I = (torch.rand(shape, generator=gen) * 255).floor()
    J = torch.roll(I, (1, -2), (1, 2)) + torch.randn(shape, generator=gen) * 3
    I, J = I.to(cuda), J.to(cuda)
    out = CV.cost_volume_subpixel(I, J, radius, 8)
    ref = CV.cost_volume_plain(I, J, radius, 8)
    torch.cuda.synchronize()
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


def _textured(shape, seed):
    gen = torch.Generator().manual_seed(seed)
    base = torch.rand((shape[0], 1, shape[1] + 4, shape[2] + 4), generator=gen)
    return (torch.nn.functional.avg_pool2d(base, 5, 1)[:, 0] * 255).floor()


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("shape", [(2, 10, 12), (3, 67, 93), (2, 135, 240), (1, 540, 960),
                                   (2, 1, 17), (1, 11, 5), (1, 13, 64)])
def test_gftt_kernel_bitwise(cuda, shape, integer):
    """K4 from the gray.  (2, 1, 17), (1, 11, 5), (1, 13, 64) and
    (2, 10, 12): an axis of one, or smaller than the composed Sobel and
    box pads, so the reflection wraps again."""
    g = _textured(shape, 7)
    if not integer:
        g = g + torch.rand(shape, generator=torch.Generator().manual_seed(8))
    g = g.to(cuda)
    out = GF.gftt_scores_gray(g)
    ref = GF.gftt_gray_plain(g)
    torch.cuda.synchronize()
    assert torch.isfinite(ref).any()
    assert torch.equal(out, ref)


@pytest.mark.parametrize("wext", [13, 36, 49])
def test_extract_kernel_bitwise(cuda, wext):
    gen = torch.Generator().manual_seed(8)
    B, H, W_, F = 3, 61, 83, 37
    stack = torch.rand((B, H, W_), generator=gen).to(cuda)
    corners = torch.stack([torch.randint(-60, W_ + 60, (B, F), generator=gen),
                           torch.randint(-60, H + 60, (B, F), generator=gen)], -1).to(torch.int32)
    corners[0, :3] = torch.tensor([[0, 0], [W_ - 1, H - 1], [-wext, H]], dtype=torch.int32)
    corners = corners.to(cuda)
    out = EX.extract_windows(stack, corners, wext)
    ref = EX.extract_plain(stack, corners, wext)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


@pytest.mark.parametrize("offset", [0.0, 2.5, 7.0])
def test_lk_gn_kernel_bitwise(cuda, offset):
    """One level of a shifted textured pair, through the real _lk_prep."""
    g = _textured((2, 96, 128), 9)
    J = torch.roll(g, (1, -2), (1, 2)).to(cuda)
    I = g.to(cuda)
    pts, counts = LK.gftt_batch(I)
    guess = pts + offset
    prep = LK._lk_prep(I, J, pts, guess, LK.WIN)
    runnable = prep[8]
    args = LK.gn_inputs(prep, guess)
    out, it = LKC.lk_gn_iterate(*args, LK.MAX_ITERS, LK.EPS)
    ref, it_ref = LKC.lk_gn_plain(*args, LK.MAX_ITERS, LK.EPS)
    torch.cuda.synchronize()
    assert int(runnable.sum()) > 100
    assert torch.equal(out, ref) and torch.equal(it, it_ref)


def test_wrappers_validate_arguments(cuda):
    frames = torch.rand((1, 8, 8, 3), device=cuda)
    coeffs = torch.zeros((1, 8), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        W.warp_frames(frames.transpose(1, 2), coeffs, torch.zeros(3, device=cuda), 8, 8)
    with pytest.raises(TypeError, match="float32"):
        CV.cost_volume_subpixel(torch.zeros((1, 8, 8), device=cuda, dtype=torch.float64),
                                torch.zeros((1, 8, 8), device=cuda, dtype=torch.float64), 2, 8)
    with pytest.raises(cuda_build.KernelArgumentError, match="radius"):
        CV.cost_volume_subpixel(torch.zeros((1, 8, 8), device=cuda), torch.zeros((1, 8, 8), device=cuda), 4, 8)
    with pytest.raises(cuda_build.KernelTypeError, match="float32"):
        GF.gftt_scores_gray(torch.zeros((1, 8, 8), device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError, match="3 dims"):
        GF.gftt_scores_gray(torch.zeros((8, 8), device=cuda))
    with pytest.raises(ValueError, match="CUDA tensor"):
        GF.gftt_scores_gray(torch.zeros((1, 8, 8), device="meta"))
    with pytest.raises(ValueError, match="contiguous"):
        GF.gftt_scores_gray(torch.zeros((1, 8, 8), device=cuda).transpose(1, 2))
    with pytest.raises(TypeError, match="int32"):
        EX.extract_windows(torch.zeros((1, 8, 8), device=cuda), torch.zeros((1, 2, 2), device=cuda), 5)
    with pytest.raises(ValueError, match="bilinear or bicubic"):
        W.warp_blur_frames(frames, torch.zeros((1, 5, 8), device=cuda), torch.zeros(3, device=cuda), 8, 8,
                           "nearest")
    with pytest.raises(ValueError, match="K3"):
        W.warp_blur_frames(frames, torch.zeros((1, 2, 8), device=cuda), torch.zeros(3, device=cuda), 8, 8)
    with pytest.raises(ValueError, match="stats"):
        W.warp_blur_frames(frames, torch.zeros((1, 5, 8), device=cuda), torch.zeros(3, device=cuda), 8, 8,
                           stats=torch.zeros(2, dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError, match="K5"):
        LKC.lk_gn_iterate(torch.zeros((1, 48, 48), device=cuda), *(torch.zeros((1, 31, 31), device=cuda),) * 3,
                          torch.zeros((1, 9), device=cuda), 50, 0.01)


def test_slice_on_cuda_launches_kernels_and_matches_cpu(cuda, monkeypatch):
    from comfyui_video_stabilizer_tpu_torch.models.flow import stabilize_flow
    from comfyui_video_stabilizer_tpu_torch.utils.video_io import normalize_video_input

    gen = torch.Generator().manual_seed(3)
    base = torch.nn.functional.avg_pool2d(torch.rand((1, 1, 208, 272), generator=gen), 5, 1, 2)[0, 0]
    base = torch.stack([base, base * 0.7 + 0.1, 1.0 - base], dim=-1)
    shake = [np.eye(3)]
    for d in _mats(7, 4) * np.array([[1, 1, 0.4], [1, 1, 0.4], [1, 1, 1]]):
        shake.append(d @ shake[-1])
    crop = np.eye(3)
    crop[0, 2] = crop[1, 2] = -32
    view = np.stack([crop @ np.linalg.inv(m) for m in shake])
    frames = W.warp_clip(base[None].expand(8, *base.shape).contiguous(), view, (192, 144), "bilinear", (0.5,) * 3)
    args = ("crop_and_pad", "similarity", False, 0.8, 0.6, 0.6, (127, 127, 127), 30.0)
    monkeypatch.setenv("CVST_FASTPATH", "1")    # the CPU takes the fast path too
    cpu = stabilize_flow(normalize_video_input(frames, device="cpu"), *args, device="cpu")
    cuda_build.reset_launches()
    gpu = stabilize_flow(normalize_video_input(frames, device=cuda), *args, device=cuda)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["warp"] == 1 and cuda_build.LAUNCHES["cost_volume"] >= 4
    assert gpu.meta["flow_backend"] == cpu.meta["flow_backend"] == "DIS"
    tc, tg = cpu.meta["estimated_motion"]["per_transition"], gpu.meta["estimated_motion"]["per_transition"]
    assert [t["mode"] for t in tg] == [t["mode"] for t in tc]
    assert np.abs(np.array([t["matrix"] for t in tg]) - np.array([t["matrix"] for t in tc])).max() <= 1e-3
    d = (gpu.frames.cpu() - cpu.frames).abs()
    assert float(torch.quantile(d.flatten()[::7], 0.99)) <= 1e-3


def test_classic_slice_on_cuda_launches_kernels_and_matches_cpu(cuda, monkeypatch):
    from comfyui_video_stabilizer_tpu_torch.models.classic import stabilize_classic
    from comfyui_video_stabilizer_tpu_torch.utils.video_io import normalize_video_input

    gen = torch.Generator().manual_seed(4)
    base = torch.nn.functional.avg_pool2d(torch.rand((1, 1, 208, 272), generator=gen), 3, 1, 1)[0, 0]
    base = torch.stack([base, base * 0.8 + 0.1, 1.0 - base], dim=-1)
    shake = [np.eye(3)]
    for d in _mats(7, 5) * np.array([[1, 1, 0.4], [1, 1, 0.4], [1, 1, 1]]):
        shake.append(d @ shake[-1])
    crop = np.eye(3)
    crop[0, 2] = crop[1, 2] = -32
    view = np.stack([crop @ np.linalg.inv(m) for m in shake])
    frames = W.warp_clip(base[None].expand(8, *base.shape).contiguous(), view, (192, 144), "bilinear", (0.5,) * 3)
    args = ("crop_and_pad", "similarity", False, 0.8, 0.6, 0.6, (127, 127, 127), 30.0)
    monkeypatch.setenv("CVST_FASTPATH", "1")    # the CPU takes the fast path too
    cpu = stabilize_classic(normalize_video_input(frames, device="cpu"), *args, device="cpu")
    # the first call on the card captures the estimation's graph (its eager
    # warm-up launches every kernel once more); the second replays it
    stabilize_classic(normalize_video_input(frames, device=cuda), *args, device=cuda)
    cuda_build.reset_launches()
    gpu = stabilize_classic(normalize_video_input(frames, device=cuda), *args, device=cuda)
    torch.cuda.synchronize()
    launches = dict(cuda_build.LAUNCHES)
    assert launches["gftt"] == 1 and launches["greedy"] == 1 and launches["lk_gn"] == 4
    assert launches["extract_windows"] == 8 and launches["warp"] == 1 and launches["cost_volume"] == 0
    tc, tg = cpu.meta["estimated_motion"]["per_transition"], gpu.meta["estimated_motion"]["per_transition"]
    assert [t["mode"] for t in tg] == [t["mode"] for t in tc]
    assert np.abs(np.array([t["matrix"] for t in tg]) - np.array([t["matrix"] for t in tc])).max() <= 1e-3
    d = (gpu.frames.cpu() - cpu.frames).abs()
    assert float(torch.quantile(d.flatten()[::7], 0.99)) <= 1e-3


@pytest.mark.parametrize("blur", [0.0, 0.5])
def test_motion_apply_on_cuda_launches_kernels_and_matches_cpu(cuda, blur):
    from comfyui_video_stabilizer_tpu_torch.models.motion_apply import apply_motion
    from comfyui_video_stabilizer_tpu_torch.models.shake import STYLES, generate_shake_motion_meta
    from comfyui_video_stabilizer_tpu_torch.utils.video_io import normalize_video_input

    gen = torch.Generator().manual_seed(6)
    frames = torch.nn.functional.avg_pool2d(torch.rand((8, 3, 148, 196), generator=gen), 5, 1)
    frames = frames.permute(0, 2, 3, 1).contiguous()
    meta = {"motion_meta": generate_shake_motion_meta(
        recipe=STYLES["action"], frame_count=8, width=192, height=144, fps=24.0, amount=1.5,
        speed=1.0, seed=3)}
    kw = dict(interpolation="bicubic", motion_blur=blur, motion_blur_samples=9)
    cpu = apply_motion(normalize_video_input(frames, device="cpu"), meta, (127, 127, 127), device="cpu", **kw)
    cuda_build.reset_launches()
    gpu = apply_motion(normalize_video_input(frames, device=cuda), meta, (127, 127, 127), device=cuda, **kw)
    torch.cuda.synchronize()
    launches = dict(cuda_build.LAUNCHES)
    assert (launches["warp_blur"], launches["warp"]) == ((1, 0) if blur else (0, 1))
    d = (gpu.frames.cpu() - cpu.frames).abs()
    assert float(torch.quantile(d.flatten()[::7], 0.99)) <= 1e-6
    assert (gpu.masks.cpu() != cpu.masks).float().mean().item() <= 1e-3


def test_wrappers_split_past_65535_frames(cuda):
    """65,536 tiny frames: every frame-indexed wrapper splits its launch at
    65,535 frames (two launches) and stays bitwise equal to its plain
    version across the split."""
    n = 65536
    gen = torch.Generator().manual_seed(12)
    frames = torch.rand((n, 8, 8, 3), generator=gen).to(cuda)
    mats = np.tile(_mats(1, 13), (n, 1, 1))
    mats[:, 0, 2] += np.linspace(-2.0, 2.0, n)
    coeffs = torch.as_tensor(W.prepare_inverse_coeffs(mats).astype(np.float32), device=cuda)
    coeffs_s = torch.stack([coeffs, coeffs * 1.001, coeffs * 0.999], 1).contiguous()
    border = torch.tensor([0.1, 0.5, 0.9], device=cuda)
    gray = (torch.rand((n, 16, 16), generator=gen) * 255).floor().to(cuda)
    corners = torch.randint(-4, 16, (n, 2, 2), generator=gen).to(torch.int32).to(cuda)
    cuda_build.reset_launches()
    outs = {
        "warp": (W.warp_frames(frames, coeffs, border, 8, 8), W.warp_plain(frames, coeffs, border, 8, 8, "bilinear")),
        "warp_blur": (W.warp_blur_frames(frames, coeffs_s, border, 8, 8, "bilinear", True),
                      W.warp_blur_mask_plain(frames, coeffs_s, border, 8, 8, "bilinear")),
        "cost_volume": (CV.cost_volume_subpixel(gray, gray.roll(1, 2), 2, 8), CV.cost_volume_plain(gray, gray.roll(1, 2), 2, 8)),
        "gftt": (GF.gftt_scores_gray(gray), GF.gftt_gray_plain(gray)),
        "extract_windows": (EX.extract_windows(gray, corners, 5), EX.extract_plain(gray, corners, 5)),
    }
    torch.cuda.synchronize()
    for name, (out, ref) in outs.items():
        assert cuda_build.LAUNCHES[name] == 2, name
        for a, b in zip(out if isinstance(out, tuple) else (out,), ref if isinstance(ref, tuple) else (ref,)):
            assert torch.equal(a, b), name


def _small_clip(seed, n=8, h=144, w=192):
    gen = torch.Generator().manual_seed(seed)
    base = torch.nn.functional.avg_pool2d(torch.rand((1, 1, h + 64, w + 80), generator=gen), 5, 1, 2)[0, 0]
    base = torch.stack([base, base * 0.7 + 0.1, 1.0 - base], dim=-1)
    shake = [np.eye(3)]
    for d in _mats(n - 1, seed + 1) * np.array([[1, 1, 0.4], [1, 1, 0.4], [1, 1, 1]]):
        shake.append(d @ shake[-1])
    crop = np.eye(3)
    crop[0, 2] = crop[1, 2] = -32
    view = np.stack([crop @ np.linalg.inv(m) for m in shake])
    return W.warp_clip(base[None].expand(n, *base.shape).contiguous(), view, (w, h), "bilinear", (0.5,) * 3)


@pytest.mark.parametrize("estimator", ["flow", "classic"])
@pytest.mark.parametrize("framing,transform", [("crop_and_pad", "perspective"), ("crop", "similarity"),
                                               ("crop", "perspective")])
@pytest.mark.parametrize("fastpath", ["1", "0"])
def test_perspective_and_crop_on_cuda_match_cpu(cuda, monkeypatch, estimator, framing, transform, fastpath):
    """Perspective fits (K10 and K11 on the card, their plain twins on the
    CPU) and crop framing, through the fast path (CVST_FASTPATH=1) and
    through the host engine (=0, its keep_fov search and no-padding
    refine on the card), the same engine on both devices: per-pair modes,
    crop status, note and scale equal, matrices <= 1e-3, frames p99
    <= 1e-3."""
    from comfyui_video_stabilizer_tpu_torch.models.classic import stabilize_classic
    from comfyui_video_stabilizer_tpu_torch.models.flow import stabilize_flow
    from comfyui_video_stabilizer_tpu_torch.utils.video_io import normalize_video_input

    run = stabilize_flow if estimator == "flow" else stabilize_classic
    frames = _small_clip(7)
    args = (framing, transform, False, 0.8, 0.6, 0.6, (127, 127, 127), 24.0)
    monkeypatch.setenv("CVST_FASTPATH", fastpath)
    monkeypatch.setenv("CVST_FASTPATH_STRICT", "1")
    served = FP.SERVED[estimator]
    cpu = run(normalize_video_input(frames, device="cpu"), *args, device="cpu")
    cuda_build.reset_launches()
    gpu = run(normalize_video_input(frames, device=cuda), *args, device=cuda)
    torch.cuda.synchronize()
    assert FP.SERVED[estimator] == served + (2 if fastpath == "1" else 0)
    assert cuda_build.LAUNCHES["warp"] == 1
    if estimator == "flow":
        assert gpu.meta["flow_backend"] == cpu.meta["flow_backend"] == "DIS"
    tc, tg = cpu.meta["estimated_motion"]["per_transition"], gpu.meta["estimated_motion"]["per_transition"]
    assert [t["mode"] for t in tg] == [t["mode"] for t in tc]
    assert gpu.meta["transform_mode_applied"] == cpu.meta["transform_mode_applied"] == transform
    assert np.abs(np.array([t["matrix"] for t in tg]) - np.array([t["matrix"] for t in tc])).max() <= 1e-3
    for key in ("keep_fov_status", "keep_fov_note", "stabilization_scale"):
        assert gpu.meta["framing"].get(key) == cpu.meta["framing"].get(key)
    d = (gpu.frames.cpu() - cpu.frames).abs()
    assert float(torch.quantile(d.flatten()[::7], 0.99)) <= 1e-3


@pytest.mark.parametrize("path", ["flow", "classic", "apply_blur", "apply_plain"])
def test_forced_streaming_on_cuda_equals_unstreamed(cuda, monkeypatch, path):
    """The chunk budget lowered to 3 frames: the clip stays on the host,
    streams through the card in chunks, and the result (on the host)
    equals the unstreamed run's, frames and masks bitwise."""
    from comfyui_video_stabilizer_tpu_torch.models.classic import stabilize_classic
    from comfyui_video_stabilizer_tpu_torch.models.flow import stabilize_flow
    from comfyui_video_stabilizer_tpu_torch.models.motion_apply import apply_motion
    from comfyui_video_stabilizer_tpu_torch.models.shake import STYLES, generate_shake_motion_meta
    from comfyui_video_stabilizer_tpu_torch.utils.video_io import normalize_video_input

    frames = _small_clip(9, n=10)
    n, h, w, _ = frames.shape
    if path in ("flow", "classic"):
        fn = stabilize_flow if path == "flow" else stabilize_classic
        args = ("crop_and_pad", "similarity", False, 0.8, 0.6, 0.6, (127, 127, 127), 24.0)

        def run(ctx):
            return fn(ctx, *args, device=cuda)
    else:
        meta = {"motion_meta": generate_shake_motion_meta(
            recipe=STYLES["action"], frame_count=n, width=w, height=h, fps=24.0, amount=1.5, speed=1.0, seed=3)}
        kw = dict(interpolation="bicubic", motion_blur=0.5 if path == "apply_blur" else 0.0, motion_blur_samples=5)

        def run(ctx):
            return apply_motion(ctx, meta, (127, 127, 127), device=cuda, **kw)

    # a streamed clip goes through the host engine, so the unstreamed
    # reference is the host engine's too (the card defaults to the fast path)
    monkeypatch.setenv("CVST_FASTPATH", "0")
    ref = run(normalize_video_input(frames, device=cuda))
    assert ref.frames.device.type == "cuda"
    monkeypatch.setattr(W, "CHUNK_BUDGET_BYTES", 3 * W.clip_device_bytes(1, h, w, h, w) + 1)
    ctx = normalize_video_input(frames, device=cuda)
    assert ctx.frames.device.type == "cpu"       # a clip that streams stays on the host
    cuda_build.reset_launches()
    ours = run(ctx)
    torch.cuda.synchronize()
    assert ours.frames.device.type == "cpu" and ours.masks.device.type == "cpu"
    assert cuda_build.LAUNCHES["warp_blur" if path == "apply_blur" else "warp"] == 4   # ceil(10 / 3) chunks
    if path == "flow":
        assert ours.meta["flow_backend"] == ref.meta["flow_backend"] == "DIS"
    assert torch.equal(ours.frames, ref.frames.cpu()) and torch.equal(ours.masks, ref.masks.cpu())


def test_motion_apply_65536_frames_on_cuda_matches_cpu(cuda):
    """Motion Apply on 65,536 frames of 16x16 RGB: K1 launched twice, the
    result against the CPU path within the Motion Apply tolerances."""
    from comfyui_video_stabilizer_tpu_torch.models.motion_apply import apply_motion
    from comfyui_video_stabilizer_tpu_torch.models.shake import STYLES, generate_shake_motion_meta
    from comfyui_video_stabilizer_tpu_torch.utils.video_io import normalize_video_input

    n = 65536
    gen = torch.Generator().manual_seed(14)
    frames = torch.nn.functional.avg_pool2d(torch.rand((n, 3, 20, 20), generator=gen), 5, 1)
    frames = frames.permute(0, 2, 3, 1).contiguous()
    meta = {"motion_meta": generate_shake_motion_meta(
        recipe=STYLES["handheld"], frame_count=n, width=16, height=16, fps=24.0, amount=1.0, speed=1.0, seed=5)}
    kw = dict(interpolation="bilinear", motion_blur=0.0)
    cpu = apply_motion(normalize_video_input(frames, device="cpu"), meta, (127, 127, 127), device="cpu", **kw)
    cuda_build.reset_launches()
    gpu = apply_motion(normalize_video_input(frames, device=cuda), meta, (127, 127, 127), device=cuda, **kw)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["warp"] == 2
    d = (gpu.frames.cpu() - cpu.frames).abs()
    assert float(torch.quantile(d.flatten()[::61], 0.99)) <= 1e-6
    assert (gpu.masks.cpu() != cpu.masks).float().mean().item() <= 1e-3


@pytest.mark.parametrize("tier", ["TVL1", "phase_correlate"])
def test_flow_fallback_tiers_on_cuda_match_cpu(cuda, monkeypatch, tier):
    """Each fallback tier forced (DIS, then TV-L1 too, raising): the CUDA
    path against the CPU path on a small clip, the same backend and
    reason, per-pair modes equal, matrices <= 1e-3, frames p99 <= 1e-3;
    K1 launched, K2 not (the DIS tier raised before it)."""
    from comfyui_video_stabilizer_tpu_torch.models.flow import stabilize_flow
    from comfyui_video_stabilizer_tpu_torch.ops import flow_dis as FD
    from comfyui_video_stabilizer_tpu_torch.ops import tvl1 as TV
    from comfyui_video_stabilizer_tpu_torch.utils.video_io import normalize_video_input

    def outage(*_a, **_k):
        raise RuntimeError("synthetic backend outage")

    # a captured graph would replay DIS without calling the patched function
    FP.clear_graph_cache()
    monkeypatch.setattr(FD, "dis_flow_fit", outage)
    if tier == "phase_correlate":
        monkeypatch.setattr(TV, "tvl1_flow", outage)
    frames = _small_clip(11)
    args = ("crop_and_pad", "similarity", False, 0.8, 0.6, 0.6, (127, 127, 127), 24.0)
    cpu = stabilize_flow(normalize_video_input(frames, device="cpu"), *args, device="cpu")
    cuda_build.reset_launches()
    gpu = stabilize_flow(normalize_video_input(frames, device=cuda), *args, device=cuda)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["warp"] == 1 and cuda_build.LAUNCHES["cost_volume"] == 0
    for key in ("flow_backend", "flow_fallback_reason", "transform_mode_applied"):
        assert gpu.meta[key] == cpu.meta[key]
    assert gpu.meta["flow_backend"] == tier
    tc, tg = cpu.meta["estimated_motion"]["per_transition"], gpu.meta["estimated_motion"]["per_transition"]
    assert [t["mode"] for t in tg] == [t["mode"] for t in tc]
    assert np.abs(np.array([t["matrix"] for t in tg]) - np.array([t["matrix"] for t in tc])).max() <= 1e-3
    d = (gpu.frames.cpu() - cpu.frames).abs()
    assert float(torch.quantile(d.flatten()[::7], 0.99)) <= 1e-3


def test_kernel_error_at_k2_launch_is_not_degraded(cuda, monkeypatch):
    """K2's launch refused (error 9): stabilize_flow raises KernelError and
    TV-L1 never runs."""
    from comfyui_video_stabilizer_tpu_torch.models.flow import stabilize_flow
    from comfyui_video_stabilizer_tpu_torch.ops import tvl1 as TV
    from comfyui_video_stabilizer_tpu_torch.utils.video_io import normalize_video_input

    calls = []
    monkeypatch.setattr(TV, "tvl1_flow", lambda *a: calls.append(1))
    FP.clear_graph_cache()   # so the fused graph's capture launches K2 through the stub
    lib = cuda_build.library()
    real = lib.cvst_cost_volume
    lib.cvst_cost_volume = lambda *a: 9
    try:
        with pytest.raises(cuda_build.KernelError, match="cost_volume"):
            stabilize_flow(normalize_video_input(_small_clip(11), device=cuda), "crop_and_pad", "similarity",
                           False, 0.8, 0.6, 0.6, (127, 127, 127), 24.0, device=cuda)
    finally:
        lib.cvst_cost_volume = real
    assert calls == []


def _fast_call(frames, device, strength=0.8, framing="crop_and_pad", transform="similarity"):
    from comfyui_video_stabilizer_tpu_torch.models.flow import stabilize_flow
    from comfyui_video_stabilizer_tpu_torch.utils.video_io import normalize_video_input

    return stabilize_flow(normalize_video_input(frames, device=device), framing, transform, False, strength, 0.6,
                          0.6, (127, 127, 127), 24.0, device=device)


def _meta_matrices(meta):
    em = meta["estimated_motion"]
    return [np.array([t["matrix"] for t in em["per_transition"]]), np.array(em["path"]),
            np.array(em["target_path"]), np.array([e["applied_matrix"] for e in meta["stabilization_warp"]["per_frame"]])]


def _graph_equals_eager(run, monkeypatch, frames, cuda, kernel: str):
    """``run`` (a crop_and_pad call) from its CUDA graph against the same
    fast path run eagerly (CVST_FUSED=0): bitwise equal frames, masks and
    meta matrices, one replay a call, the same launch counts, ``kernel``
    among them."""
    monkeypatch.setenv("CVST_FASTPATH_STRICT", "1")
    FP.clear_graph_cache()
    first = run(frames, cuda)                           # warm-up and capture
    replays = FP.GRAPH_STATS["replays"]
    cuda_build.reset_launches()
    fused = run(frames, cuda)
    torch.cuda.synchronize()
    launches = dict(cuda_build.LAUNCHES)
    assert FP.GRAPH_STATS["replays"] == replays + 1
    assert launches[kernel] >= 1 and launches["warp"] == 1
    monkeypatch.setenv("CVST_FUSED", "0")
    cuda_build.reset_launches()
    eager = run(frames, cuda)
    torch.cuda.synchronize()
    assert FP.GRAPH_STATS["replays"] == replays + 1
    assert dict(cuda_build.LAUNCHES) == launches
    for res in (first, fused):
        assert torch.equal(res.frames, eager.frames) and torch.equal(res.masks, eager.masks)
        for a, b in zip(_meta_matrices(res.meta), _meta_matrices(eager.meta)):
            assert np.array_equal(a, b)
        assert res.meta["padding_fraction_mean"] == eager.meta["padding_fraction_mean"]
    return launches


def test_fused_graph_equals_eager_fast_path(cuda, monkeypatch):
    """The Flow crop_and_pad call from its CUDA graph against the same fast
    path run eagerly (CVST_FUSED=0): the same kernels in the same order,
    so frames, masks and every meta matrix are bitwise equal.  The graph
    replays once a call and the launch counts still count the call's K2
    launches."""
    launches = _graph_equals_eager(_fast_call, monkeypatch, _small_clip(15), cuda, "cost_volume")
    assert launches["cost_volume"] >= 4


def _classic_call(frames, device, strength=0.8):
    from comfyui_video_stabilizer_tpu_torch.models.classic import stabilize_classic
    from comfyui_video_stabilizer_tpu_torch.utils.video_io import normalize_video_input

    return stabilize_classic(normalize_video_input(frames, device=device), "crop_and_pad", "similarity", False,
                             strength, 0.6, 0.6, (127, 127, 127), 24.0, device=device)


def test_classic_fused_graph_equals_eager_fast_path(cuda, monkeypatch):
    """The Classic crop_and_pad call from its CUDA graph (K4, K7, K6, K5
    replayed) against the same fast path run eagerly: bitwise equal."""
    launches = _graph_equals_eager(_classic_call, monkeypatch, _small_clip(16), cuda, "greedy")
    assert (launches["gftt"], launches["greedy"], launches["lk_gn"], launches["extract_windows"]) == (1, 1, 4, 8)


def test_kernel_error_at_k7_launch_is_not_degraded(cuda, monkeypatch):
    """K7's launch refused (error 9): a Classic call raises KernelError,
    through the fast path (the graph captured anew) and the host engine,
    and no native greedy runs in its place."""
    called = []
    monkeypatch.setattr(LK._native, "greedy_min_distance", lambda *a: called.append(1))
    lib = cuda_build.library()
    real = lib.cvst_greedy
    for flag in ("1", "0"):
        monkeypatch.setenv("CVST_FASTPATH", flag)
        FP.clear_graph_cache()   # so the graph's capture launches K7 through the stub
        lib.cvst_greedy = lambda *a: 9
        try:
            with pytest.raises(cuda_build.KernelError, match="greedy"):
                _classic_call(_small_clip(11), cuda)
        finally:
            lib.cvst_greedy = real
    assert called == []


def test_fused_graph_results_are_not_aliased(cuda, monkeypatch):
    """Two replays with different strengths give different results, and
    the first call's result is not overwritten by the second."""
    monkeypatch.setenv("CVST_FASTPATH_STRICT", "1")
    frames = _small_clip(15)
    a = _fast_call(frames, cuda, strength=0.8)
    a_frames, a_path = a.frames.clone(), _meta_matrices(a.meta)
    b = _fast_call(frames, cuda, strength=0.3)
    torch.cuda.synchronize()
    assert not torch.equal(a.frames, b.frames)
    assert a.frames.data_ptr() != b.frames.data_ptr()
    assert torch.equal(a.frames, a_frames)
    assert not np.array_equal(_meta_matrices(a.meta)[2], _meta_matrices(b.meta)[2])
    assert all(np.array_equal(x, y) for x, y in zip(_meta_matrices(a.meta), a_path))


@pytest.mark.parametrize("estimator", ["flow", "classic"])
@pytest.mark.parametrize("framing,transform,lock", [("crop_and_pad", "similarity", False),
                                                    ("crop_and_pad", "translation", True),
                                                    ("expand", "similarity", False),
                                                    ("crop", "similarity", False)])
def test_fast_path_on_cuda_matches_cpu_fast_path(cuda, monkeypatch, estimator, framing, transform, lock):
    """The fast path on the card (the fused graph for Flow crop_and_pad)
    against the fast path on the CPU (CVST_FASTPATH=1): per-pair modes
    equal, matrices and applied matrices <= 1e-3, frames p99 <= 1e-3,
    the same canvas, crop status and note."""
    from comfyui_video_stabilizer_tpu_torch.models.classic import stabilize_classic
    from comfyui_video_stabilizer_tpu_torch.models.flow import stabilize_flow
    from comfyui_video_stabilizer_tpu_torch.utils.video_io import normalize_video_input

    monkeypatch.setenv("CVST_FASTPATH", "1")
    monkeypatch.setenv("CVST_FASTPATH_STRICT", "1")
    ran = []
    real = FP.run_fast
    monkeypatch.setattr(FP, "run_fast", lambda kind, *a, **k: ran.append(real(kind, *a, **k)) or ran[-1])
    run = stabilize_flow if estimator == "flow" else stabilize_classic
    frames = _small_clip(17)
    args = (framing, transform, lock, 0.8, 0.6, 0.6, (127, 127, 127), 24.0)
    cpu = run(normalize_video_input(frames, device="cpu"), *args, device="cpu")
    gpu = run(normalize_video_input(frames, device=cuda), *args, device=cuda)
    torch.cuda.synchronize()
    assert len(ran) == 2 and all(r is not None for r in ran)
    mc, mg = _meta_matrices(cpu.meta), _meta_matrices(gpu.meta)
    assert [t["mode"] for t in gpu.meta["estimated_motion"]["per_transition"]] == \
        [t["mode"] for t in cpu.meta["estimated_motion"]["per_transition"]]
    assert np.abs(mg[0] - mc[0]).max() <= 1e-3 and np.abs(mg[3] - mc[3]).max() <= 1e-3
    assert gpu.meta["stabilization_warp"]["output_size"] == cpu.meta["stabilization_warp"]["output_size"]
    for key in ("keep_fov_status", "keep_fov_note"):
        assert gpu.meta["framing"].get(key) == cpu.meta["framing"].get(key)
    d = (gpu.frames.cpu() - cpu.frames).abs()
    assert float(torch.quantile(d.flatten()[::7], 0.99)) <= 1e-3


def test_dense_dis_flow_on_cuda_matches_cpu(cuda):
    """Dense dis_flow (K2 at r = 3 on every level, r = 2 in the last
    round): the CUDA path against the CPU path, flow median <= 1e-4 px
    and p99 <= 1e-2 px (K2 is bitwise, but the IRLS fits' sums run in
    another order on the card, so pre-warps differ by ulps and an argmin
    tie may flip); confidences median <= 1e-4."""
    from comfyui_video_stabilizer_tpu_torch.ops import flow_dis as FD

    gray = _small_clip(13, n=6, h=150, w=198).mean(dim=-1) * 255.0
    cpu_flow, cpu_conf = FD.dis_flow(gray)
    cuda_build.reset_launches()
    flow, conf = FD.dis_flow(gray.to(cuda))
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["cost_volume"] >= 3
    assert flow.shape == cpu_flow.shape == (5, 150, 198, 2)
    d = (flow.cpu() - cpu_flow).abs()
    assert float(d.median()) <= 1e-4 and float(torch.quantile(d.flatten(), 0.99)) <= 1e-2
    assert float((conf.cpu() - cpu_conf).abs().median()) <= 1e-4


@pytest.mark.parametrize("interp", ["bilinear", "bicubic", "nearest"])
@pytest.mark.parametrize("bands", [2, 3, 4])
def test_warp_kernel_row_bands_bitwise(cuda, interp, bands):
    """K1 with ``row0``: each band of output rows is bitwise its plain
    version and the same rows of the whole-canvas launch; row0 = 0 is the
    whole canvas."""
    n, h, w = 3, 97, 161
    frames = torch.rand((n, h, w, 3), generator=torch.Generator().manual_seed(4)).to(cuda)
    coeffs = torch.as_tensor(W.prepare_inverse_coeffs(_mats(n, 5, persp=1e-4)).astype(np.float32), device=cuda)
    border = torch.tensor([0.2, 0.5, 0.8], device=cuda)
    whole = W.warp_frames(frames, coeffs, border, h + 5, w - 7, interp)
    assert torch.equal(W.warp_frames(frames, coeffs, border, h + 5, w - 7, interp, row0=0), whole)
    bounds = [(h + 5) * i // bands for i in range(bands + 1)]
    for r0, r1 in zip(bounds[:-1], bounds[1:]):
        band = W.warp_frames(frames, coeffs, border, r1 - r0, w - 7, interp, row0=r0)
        ref = W.warp_plain(frames, coeffs, border, r1 - r0, w - 7, interp, row0=r0)
        torch.cuda.synchronize()
        assert torch.equal(band, ref) and torch.equal(band, whole[:, r0:r1])


@pytest.mark.parametrize("engine", ["flow", "classic"])
@pytest.mark.parametrize("spatial", [1, 2])
@pytest.mark.parametrize("n", [8, 9])
def test_sharded_on_one_card_equals_unsharded(cuda, monkeypatch, engine, spatial, n):
    """The production engines on four shards of one card
    (``make_mesh(devices=["cuda:0"] * 4)``) against the unsharded call on
    the card: torch.equal in frames, masks and the meta.  An even clip
    runs the fast path by shard (the reference runs it eagerly,
    ``CVST_FUSED=0``); an uneven one defers to the host engine (the
    reference too, ``CVST_FASTPATH=0``), in bands of rows with a spatial
    axis of 2.  K2 (Flow) or K4-K7 (Classic) and K1 launch on every
    shard; no copy is made between the shards of one card."""
    from comfyui_video_stabilizer_tpu_torch.models.classic import stabilize_classic
    from comfyui_video_stabilizer_tpu_torch.models.flow import stabilize_flow
    from comfyui_video_stabilizer_tpu_torch.parallel import mesh as PM
    from comfyui_video_stabilizer_tpu_torch.parallel import production as PR
    from comfyui_video_stabilizer_tpu_torch.utils.video_io import normalize_video_input

    monkeypatch.setenv("CVST_FASTPATH_STRICT", "1")
    monkeypatch.setenv("CVST_FUSED", "0")
    if n % 4:
        monkeypatch.setenv("CVST_FASTPATH", "0")
    frames = _small_clip(21, n=n).cpu().numpy()
    sharded_fn, ref_fn = ((PR.stabilize_flow_sharded, stabilize_flow) if engine == "flow"
                          else (PR.stabilize_classic_sharded, stabilize_classic))
    ref = ref_fn(normalize_video_input(torch.from_numpy(frames), device=cuda), "crop_and_pad", "similarity",
                 False, 0.9, 0.6, 0.6, (127, 127, 127), 16.0, device=cuda)
    PM.reset_transfers()
    cuda_build.reset_launches()
    ours = sharded_fn(frames, PM.make_mesh(devices=["cuda:0"] * 4, spatial=spatial))
    torch.cuda.synchronize()
    if n % 4 == 0:
        assert isinstance(ours.frames, PM.FrameShards) and len(ours.frames.shards) == 4 // spatial
        assert cuda_build.LAUNCHES["warp"] == 4 // spatial
        for kernel in (("cost_volume",) if engine == "flow" else ("gftt", "greedy")):
            assert cuda_build.LAUNCHES[kernel] >= 4 // spatial
    elif spatial == 2:
        assert isinstance(ours.frames, PM.FrameShards) and ours.frames.axis == 1
        assert cuda_build.LAUNCHES["warp"] == 2
    assert PM.TRANSFERS == {"halo": 0, "gather": 0, "scatter": 0}
    gather = (lambda x: x.gather()) if isinstance(ours.frames, PM.FrameShards) else (lambda x: x)
    assert torch.equal(gather(ours.frames), ref.frames) and torch.equal(gather(ours.masks), ref.masks)
    assert ours.meta == ref.meta


def test_graph_cache_keys_one_card_once(cuda, monkeypatch):
    """Frames on "cuda" and on "cuda:0" are one device: the Flow graph is
    captured once and replayed for both."""
    monkeypatch.setenv("CVST_FASTPATH_STRICT", "1")
    frames = _small_clip(15)
    FP.clear_graph_cache()
    captures = FP.GRAPH_STATS["captures"]
    a = _fast_call(frames, torch.device("cuda"))
    b = _fast_call(frames, torch.device("cuda", 0))
    torch.cuda.synchronize()
    assert FP.GRAPH_STATS["captures"] == captures + 1
    assert torch.equal(a.frames, b.frames)


@pytest.mark.parametrize("batch", [1, 4, 19, 20])
def test_similarity_fit_is_batch_invariant_on_cuda(cuda, batch):
    """The dense similarity fit of a pair does not depend on the pairs
    beside it (its sums are fixed-order pairwise trees; a library
    reduction adds in another order for another batch): the first
    ``batch`` pairs fitted alone equal the same rows of a 79-pair fit, at
    a coarse (33 x 60) and the finest (270 x 480) level of the 1080p
    slice."""
    from comfyui_video_stabilizer_tpu_torch.ops import flow_dis as FD

    gen = torch.Generator().manual_seed(batch)
    for h, w in ((33, 60), (270, 480)):
        flow = (torch.randn((79, h, w, 2), generator=gen) * 2).to(cuda)
        conf = torch.rand((79, h, w), generator=gen).to(cuda)
        whole = FD._fit_similarity_dense(flow, conf, 4)
        part = FD._fit_similarity_dense(flow[:batch].contiguous(), conf[:batch].contiguous(), 4)
        torch.cuda.synchronize()
        assert torch.equal(part, whole[:batch])


@pytest.mark.parametrize("payload", ["uint8", "float_0_255"])
def test_normalize_on_cuda_equals_cpu(cuda, payload):
    """A uint8 clip and a 0..255 float clip normalized on the card are
    torch.equal to the CPU normalization (numpy's true division by 255),
    every one of the 256 levels included, and so are their estimation
    grays (1920x1080 -> 960x540, the x2 pool)."""
    from comfyui_video_stabilizer_tpu_torch.ops import resize as R
    from comfyui_video_stabilizer_tpu_torch.utils.video_io import normalize_video_input

    rng = np.random.default_rng(11)
    clip = rng.integers(0, 256, (3, 1080, 1920, 3), dtype=np.uint8)
    clip[0, 0, :256, 0] = np.arange(256)
    src = torch.from_numpy(clip if payload == "uint8" else clip.astype(np.float32))
    ctx = {dev: normalize_video_input(src, device=dev) for dev in ("cpu", cuda)}
    assert torch.equal(ctx[cuda].frames.cpu(), ctx["cpu"].frames)
    grays = {dev: R.gray_for_estimation(c.frames, (960, 540)) for dev, c in ctx.items()}
    torch.cuda.synchronize()
    assert torch.equal(grays[cuda].cpu(), grays["cpu"])


@pytest.mark.parametrize("rebuild", [False, True])
def test_shared_graph_pool_interleaved_replays_equal_eager(cuda, monkeypatch, rebuild):
    """A Flow and a Classic crop_and_pad key captured into the one shared
    graph pool, then replayed A, B, A, B, B, A: every result torch.equal
    to the same call run eagerly (CVST_FUSED=0), though each graph's
    replay reuses the other's freed blocks as scratch.  With ``rebuild``
    the second capture rebuilds the pool (B recaptured first, then A: two
    recaptures); without, it never does.  One pool on the card, none
    once the cache is cleared."""
    monkeypatch.setenv("CVST_FASTPATH_STRICT", "1")
    monkeypatch.setattr(FP, "POOL_REBUILD_BYTES", -1 if rebuild else 2**62)
    frames = _small_clip(21, n=12)
    calls = {"A": _fast_call, "B": _classic_call}
    monkeypatch.setenv("CVST_FUSED", "0")
    eager = {k: run(frames, cuda) for k, run in calls.items()}
    monkeypatch.setenv("CVST_FUSED", "1")
    FP.clear_graph_cache()
    stats = dict(FP.GRAPH_STATS)
    for k in "ABABBA":
        res = calls[k](frames, cuda)
        torch.cuda.synchronize()
        assert torch.equal(res.frames, eager[k].frames) and torch.equal(res.masks, eager[k].masks), k
        assert res.meta == eager[k].meta, k
    assert FP.GRAPH_STATS["captures"] - stats["captures"] == 2
    assert FP.GRAPH_STATS["rebuilds"] - stats["rebuilds"] == int(rebuild)
    assert FP.GRAPH_STATS["recaptures"] - stats["recaptures"] == (2 if rebuild else 0)
    assert [e.program for e in FP._GRAPHS.values()] == [FP._PROGRAMS["classic"], FP._PROGRAMS["flow"]]  # LRU order
    assert list(FP._POOLS) == [str(torch.device("cuda", 0))]
    FP.clear_graph_cache()
    assert FP._POOLS == {}
