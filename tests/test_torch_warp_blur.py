"""The shutter-blur warp (plain version of K3) and its soft mask against
the JAX package's ``warp_clip_blur`` on the CPU.

Inputs: (2, 64, 96, 3) frames and the shutter samples of
``blurred_sample_matrices`` over a perspective shake, made with numpy
from a seed and handed to both packages.

Tolerances: frames <= 2e-6 abs against the JAX XLA path (XLA's CPU
backend contracts multiply-adds into FMAs, a few ulps of each sample);
<= 5e-6 against the Pallas kernel in interpret mode (it also multiplies
by 1/S where the port divides by S, and samples by shift-FMAs), as
tests/test_warp_pallas.py holds it; the soft mask exactly equal (a sum
of 0/1 coverages times 1/S in float32 on both sides).  The same holds
for ``warp_blur_mask_plain``, the plain version of K3 with its fused
mask, on an expand-like canvas larger than the frame and on a x1.3
crop-like zoom, at S = 3, 5 and 33.  ``motion_blur`` 0 through the
engine is bitwise equal to the plain warp.  The kernel itself is
compared with the plain version on the card
(tests/test_torch_cuda_kernels.py; ``chip_smoke.py`` at 1080p).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

from comfyui_video_stabilizer_tpu.models import motion_apply as JMA  # noqa: E402
from comfyui_video_stabilizer_tpu.ops import warp as JW  # noqa: E402
from comfyui_video_stabilizer_tpu.ops import warp_pallas as JWP  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.models import motion_apply as TMA  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import warp as TW  # noqa: E402

N, H, W = 2, 64, 96
BORDER = (0.2, 0.4, 0.6)


def _frames(seed=0):
    return np.random.default_rng(seed).random((N, H, W, 3), dtype=np.float32)


def _samples(s, seed=1, blur=0.5):
    rng = np.random.default_rng(seed)
    mats = []
    for _ in range(N + 1):
        th = rng.uniform(-0.05, 0.05)
        tx, ty = rng.uniform(-9, 9, 2)
        g, h = rng.uniform(-1e-4, 1e-4, 2)
        mats.append(np.array([[np.cos(th), -np.sin(th), tx], [np.sin(th), np.cos(th), ty], [g, h, 1.0]]))
    return JMA.blurred_sample_matrices(np.stack(mats), blur, s)[:N]


CASES = [(interp, s) for interp in ("bilinear", "bicubic") for s in (5, 33)]


@pytest.mark.parametrize("interp,s", CASES)
def test_blur_matches_jax_xla(interp, s):
    frames, samples = _frames(), _samples(s)
    ref, ref_mask = JW.warp_clip_blur(frames, samples, (W, H), interp, BORDER)
    ours, mask = TW.warp_clip_blur(torch.from_numpy(frames), samples, (W, H), interp, BORDER)
    assert tuple(ours.shape) == (N, H, W, 3) and tuple(mask.shape) == (N, H, W)
    assert np.abs(ours.numpy() - np.asarray(ref)).max() <= 2e-6
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    soft = mask.numpy()
    assert ((soft > 0) & (soft < 1)).any()


@pytest.mark.parametrize("interp,s", CASES)
def test_blur_matches_pallas_interpret(interp, s):
    frames, samples = _frames(2), _samples(s, seed=3)
    coeffs = JW.prepare_inverse_coeffs(samples.reshape(-1, 3, 3)).reshape(N, s, 8)
    ref = JWP.warp_clip_blur_pallas(frames, coeffs, (W, H), interp, BORDER, interpret=True)
    assert ref is not None
    ours, _ = TW.warp_clip_blur(torch.from_numpy(frames), samples, (W, H), interp, BORDER, with_mask=False)
    assert np.abs(ours.numpy() - np.asarray(ref)).max() <= 5e-6


def _framed(samples, canvas):
    """Expand-like: the frame 12 px right, 8 px down on a (W+24, H+16)
    canvas; crop-like: a x1.3 zoom about the centre."""
    if canvas == "expand":
        pre, size = np.array([[1.0, 0.0, 12.0], [0.0, 1.0, 8.0], [0.0, 0.0, 1.0]]), (W + 24, H + 16)
    else:
        cx, cy = (W - 1) / 2, (H - 1) / 2
        pre, size = np.array([[1.3, 0.0, -0.3 * cx], [0.0, 1.3, -0.3 * cy], [0.0, 0.0, 1.0]]), (W, H)
    return np.einsum("ij,nsjk->nsik", pre, samples), size


FUSED_CASES = [(canvas, interp, s) for canvas in ("expand", "zoom") for interp in ("bilinear", "bicubic")
               for s in (3, 5, 33)]


@pytest.mark.parametrize("canvas,interp,s", FUSED_CASES)
def test_blur_mask_plain_matches_jax(canvas, interp, s):
    frames = _frames(8)
    samples, (out_w, out_h) = _framed(_samples(s, seed=9), canvas)
    ref, ref_mask = JW.warp_clip_blur(frames, samples, (out_w, out_h), interp, BORDER)
    coeffs = torch.from_numpy(TW.prepare_inverse_coeffs(samples.reshape(-1, 3, 3))
                              .astype(np.float32).reshape(N, s, 8))
    ours, mask = TW.warp_blur_mask_plain(torch.from_numpy(frames), coeffs, torch.tensor(BORDER),
                                         out_h, out_w, interp)
    assert tuple(ours.shape) == (N, out_h, out_w, 3) and tuple(mask.shape) == (N, out_h, out_w)
    assert np.abs(ours.numpy() - np.asarray(ref)).max() <= 2e-6
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    if canvas == "expand":
        soft = mask.numpy()
        assert ((soft > 0) & (soft < 1)).any() and (soft == 1).any()
    # the wrapper takes the fused plain version for a CPU tensor
    wrapped = TW.warp_blur_frames(torch.from_numpy(frames), coeffs, torch.tensor(BORDER), out_h, out_w,
                                  interp, with_mask=True)
    assert torch.equal(wrapped[0], ours) and torch.equal(wrapped[1], mask)


def test_blur_plain_is_the_sample_mean_of_warp_plain():
    """warp_blur_plain sums warp_plain's samples in order, then divides."""
    frames = torch.from_numpy(_frames(4))
    samples = _samples(5, seed=5)
    coeffs = torch.from_numpy(TW.prepare_inverse_coeffs(samples.reshape(-1, 3, 3))
                              .astype(np.float32).reshape(N, 5, 8))
    border = torch.tensor(BORDER)
    acc = None
    for k in range(5):
        w = TW.warp_plain(frames, coeffs[:, k], border, H, W, "bicubic")
        acc = w if acc is None else acc + w
    out, mask = TW.warp_blur_frames(frames, coeffs, border, H, W, "bicubic")
    assert torch.equal(out, acc / 5.0) and mask is None


def test_blur_without_mask_and_empty_clip():
    frames, samples = _frames(), _samples(5)
    out, mask = TW.warp_clip_blur(torch.from_numpy(frames), samples, (W, H), "bilinear", BORDER,
                                  with_mask=False)
    assert mask is None and tuple(out.shape) == (N, H, W, 3)
    out, mask = TW.warp_clip_blur(torch.zeros((0, H, W, 3)), np.zeros((0, 5, 3, 3)), (W + 2, H))
    assert tuple(out.shape) == (0, H, W + 2, 3) and tuple(mask.shape) == (0, H, W + 2)


def test_nearest_blur_raises():
    with pytest.raises(ValueError, match="bilinear or bicubic"):
        TW.warp_clip_blur(torch.from_numpy(_frames()), _samples(5), (W, H), "nearest", BORDER)


@pytest.mark.parametrize("kind", ["shake", "past_edge"])
def test_coverage_mask_matches_jax(kind):
    samples = _samples(3, seed=7)[:, 1]
    if kind == "past_edge":
        samples[:, 0, 2] += np.array([70.0, -120.0])
    ref = np.asarray(JW.coverage_mask(samples, (W, H), (W + 10, H - 6)))
    ours = TW.coverage_mask(samples, (W, H), (W + 10, H - 6), "cpu").numpy()
    np.testing.assert_array_equal(ours, ref)
    assert 0.0 < ours.mean() < 1.0


def test_motion_blur_zero_is_bitwise_the_plain_warp():
    """apply_motion with blur 0 (any sample count) is warp_clip + the plain mask."""
    from comfyui_video_stabilizer_tpu_torch.meta.motion_meta import build_motion_meta_v2
    from comfyui_video_stabilizer_tpu_torch.utils.video_io import normalize_video_input

    frames = _frames(6)
    mats = _samples(3, seed=8)[:, 0]
    meta = {"motion_meta": build_motion_meta_v2(
        source="estimated_flow", frame_count=N, fps=16.0, input_size=(W, H), output_size=(W, H),
        matrices=list(mats))}
    ctx = normalize_video_input(torch.from_numpy(frames), device="cpu")
    res = TMA.apply_motion(ctx, meta, (51, 102, 153), interpolation="bicubic", motion_blur=0.0,
                           motion_blur_samples=33, device="cpu")
    plain = TW.warp_clip(ctx.frames, mats, (W, H), "bicubic", np.array([51, 102, 153], np.float32) / 255.0)
    assert torch.equal(res.frames, plain)
    cover = TW.coverage_mask(mats, (W, H), (W, H), "cpu")
    assert torch.equal(res.masks, TW.zero_small(1.0 - cover))
