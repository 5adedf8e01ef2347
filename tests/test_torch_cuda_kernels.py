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
coverage may flip on a one-ulp coordinate).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

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
    with pytest.raises(ValueError, match="radius"):
        CV.cost_volume_subpixel(torch.zeros((1, 8, 8), device=cuda), torch.zeros((1, 8, 8), device=cuda), 4, 8)
    with pytest.raises(TypeError, match="float32"):
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


def test_slice_on_cuda_launches_kernels_and_matches_cpu(cuda):
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
    cpu = stabilize_flow(normalize_video_input(frames, device="cpu"), *args, device="cpu")
    cuda_build.reset_launches()
    gpu = stabilize_flow(normalize_video_input(frames, device=cuda), *args, device=cuda)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["warp"] == 1 and cuda_build.LAUNCHES["cost_volume"] >= 4
    tc, tg = cpu.meta["estimated_motion"]["per_transition"], gpu.meta["estimated_motion"]["per_transition"]
    assert [t["mode"] for t in tg] == [t["mode"] for t in tc]
    assert np.abs(np.array([t["matrix"] for t in tg]) - np.array([t["matrix"] for t in tc])).max() <= 1e-3
    d = (gpu.frames.cpu() - cpu.frames).abs()
    assert float(torch.quantile(d.flatten()[::7], 0.99)) <= 1e-3


def test_classic_slice_on_cuda_launches_kernels_and_matches_cpu(cuda):
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
    cpu = stabilize_classic(normalize_video_input(frames, device="cpu"), *args, device="cpu")
    cuda_build.reset_launches()
    gpu = stabilize_classic(normalize_video_input(frames, device=cuda), *args, device=cuda)
    torch.cuda.synchronize()
    launches = dict(cuda_build.LAUNCHES)
    assert launches["gftt"] == 1 and launches["lk_gn"] == 4 and launches["extract_windows"] == 8
    assert launches["warp"] == 1 and launches["cost_volume"] == 0
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
