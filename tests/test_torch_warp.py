"""Warp (plain version of K1) and padding masks against the JAX package.

Tolerances: warped values <= 2e-6 abs: interpolation is continuous in
the coordinates and XLA's CPU backend contracts some multiply-adds into
FMAs, so values differ by a few ulps.  Masks exact, or at most 1e-4 of
the pixels where a round-half-even tie flips on a one-ulp coordinate
difference.  The kernel itself is compared with the plain version on
the card (tests/test_torch_cuda_kernels.py; ``chip_smoke.py`` at 1080p).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

from comfyui_video_stabilizer_tpu.ops import warp as JW  # noqa: E402
from comfyui_video_stabilizer_tpu.ops import warp_pallas as JWP  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import warp as TW  # noqa: E402

H, W = 40, 64
BORDER = (0.2, 0.4, 0.6)


def _frames(n=2, h=H, w=W, seed=0):
    return np.random.default_rng(seed).random((n, h, w, 3), dtype=np.float32)


def _mats(kind):
    rng = np.random.default_rng({"identity": 1, "similarity": 2, "perspective": 3, "past_edge": 4}[kind])
    out = []
    for i in range(2):
        if kind == "identity":
            out.append(np.eye(3))
            continue
        th = rng.uniform(-0.02, 0.02)
        s = np.exp(rng.uniform(-0.01, 0.01))
        tx, ty = rng.uniform(-4, 4, 2)
        if kind == "past_edge":
            tx, ty = tx + (50.0 if i == 0 else -70.0), ty + 30.0
        g, h = (2e-4, -1e-4) if kind == "perspective" else (0.0, 0.0)
        out.append(np.array([[s * np.cos(th), -s * np.sin(th), tx],
                             [s * np.sin(th), s * np.cos(th), ty], [g, h, 1.0]]))
    return np.stack(out)


def _ours(frames, mats, interp, out_size=(W, H)):
    coeffs = torch.from_numpy(TW.prepare_inverse_coeffs(mats).astype(np.float32))
    return TW.warp_plain(torch.from_numpy(frames), coeffs, torch.tensor(BORDER),
                         out_size[1], out_size[0], interp).numpy()


def _xla(frames, mats, interp, out_size=(W, H)):
    coeffs = JW.prepare_inverse_coeffs(mats).astype(np.float32)
    return np.asarray(JW._warp_xla(frames, coeffs, np.asarray(BORDER, np.float32),
                                   out_size[1], out_size[0], interp))


@pytest.mark.parametrize("kind", ["identity", "similarity", "perspective", "past_edge"])
@pytest.mark.parametrize("interp", ["bilinear", "bicubic", "nearest"])
def test_plain_warp_matches_xla(kind, interp):
    frames = _frames()
    mats = _mats(kind)
    ours, ref = _ours(frames, mats, interp), _xla(frames, mats, interp)
    assert np.abs(ours - ref).max() <= 2e-6
    if kind == "identity":
        np.testing.assert_array_equal(ours, frames)


@pytest.mark.parametrize("kind,interp", [("similarity", "bilinear"), ("past_edge", "bicubic")])
def test_plain_warp_matches_pallas_interpret(kind, interp):
    frames = _frames()
    mats = _mats(kind)
    ref = JWP.warp_clip_pallas(frames, mats, JW.prepare_inverse_coeffs(mats), (W, H), interp,
                               BORDER, interpret=True)
    assert ref is not None
    assert np.abs(_ours(frames, mats, interp) - np.asarray(ref)).max() <= 2e-6


def test_expand_canvas_matches_xla():
    frames = _frames()
    shift = np.eye(3)
    shift[0, 2], shift[1, 2] = 11.0, 7.0
    mats = np.einsum("ij,njk->nik", shift, _mats("similarity"))
    out_size = (W + 24, H + 14)
    ours = _ours(frames, mats, "bilinear", out_size)
    assert ours.shape == (2, H + 14, W + 24, 3)
    assert np.abs(ours - _xla(frames, mats, "bilinear", out_size)).max() <= 2e-6


def test_prepare_inverse_coeffs_equal():
    mats = np.concatenate([_mats("perspective"), np.zeros((1, 3, 3))])  # singular -> identity
    np.testing.assert_array_equal(TW.prepare_inverse_coeffs(mats), JW.prepare_inverse_coeffs(mats))


@pytest.mark.parametrize("kind", ["similarity", "perspective", "past_edge"])
def test_padding_mask_stats_match(kind):
    mats = _mats(kind)
    ref_mask, ref_ratio = JW.padding_mask_stats(mats, (W, H), (W, H))
    mask, ratio = TW.padding_mask_stats(mats, (W, H), (W, H), "cpu")
    flipped = (mask.numpy() != np.asarray(ref_mask)).mean()
    assert flipped <= 1e-4
    assert np.abs(ratio.numpy() - np.asarray(ref_ratio)).max() <= 1e-4 + 1e-6
    assert set(np.unique(mask.numpy())) <= {0.0, 1.0}


def test_warp_clip_public_api():
    frames = _frames()
    mats = _mats("similarity")
    out = TW.warp_clip(torch.from_numpy(frames), mats, (W, H), "bilinear", BORDER)
    ref = np.asarray(JW.warp_clip(frames, mats, (W, H), "bilinear", BORDER))
    assert np.abs(out.numpy() - ref).max() <= 2e-6
    empty = TW.warp_clip(torch.zeros((0, H, W, 3)), np.zeros((0, 3, 3)), (W, H))
    assert tuple(empty.shape) == (0, H, W, 3)


def test_zero_small_exact():
    m = np.random.default_rng(6).random((2, 9, 11)).astype(np.float32) ** 6
    np.testing.assert_array_equal(TW.zero_small(torch.from_numpy(m)).numpy(), np.asarray(JW.zero_small(m)))


def test_clip_budget_raises_beyond_device_memory(monkeypatch):
    """Past the budget, once a raise, a clip streams through time chunks:
    with both packages' budgets lowered to a few frames, the streamed
    warp and masks against the JAX package's streamed ones (the file's
    tolerances), and the streamed result on the host."""
    frames = _frames(n=7)
    mats = np.concatenate([_mats("similarity"), _mats("perspective"), _mats("past_edge"), _mats("identity")])[:7]
    per_frame = TW.clip_device_bytes(1, H, W, H, W)
    monkeypatch.setattr(TW, "CHUNK_BUDGET_BYTES", 2 * per_frame)
    monkeypatch.setattr(JW, "CHUNK_BUDGET_BYTES", 2 * (3 * H * W + 2 * H * W) * 3 * 4)
    assert TW.will_stream(7, H, W, H, W) and JW.will_stream(7, H, W, H, W)
    out, mask, ratio = TW.warp_clip_with_mask(torch.from_numpy(frames), mats, (W, H), "bilinear", BORDER)
    ref, ref_mask = JW.warp_clip_with_mask(frames, mats, (W, H), "bilinear", BORDER)
    assert isinstance(ref, np.ndarray) and out.device.type == "cpu"
    assert np.abs(out.numpy() - ref).max() <= 2e-6
    assert (mask.numpy() != np.asarray(ref_mask)).mean() <= 1e-4
    np.testing.assert_array_equal(ratio.numpy(), mask.numpy().reshape(7, -1).mean(1))
