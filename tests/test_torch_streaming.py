"""Time-chunk streaming and the launch span plan of the port.

A clip whose warp-stage live set exceeds ``ops/warp.py``'s
``CHUNK_BUDGET_BYTES`` streams through time chunks.  Here the budget is
lowered (``monkeypatch``) so that a 10-frame 144x192 clip, made from a
numpy seed, streams in chunks of 3 frames, and every streamed result is
held to the unstreamed run of the same call.

Tolerances: streamed frames, masks and per-frame ratios ``torch.equal``
to the unstreamed ones (every frame is computed from its own inputs
only); the meta equal; the frame-span plan of the kernel wrappers and
the chunk sizes exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import cv2  # noqa: E402

from comfyui_video_stabilizer_tpu_torch.models import classic as TCL  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.models import flow as TFL  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.models import inverse as TINV  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.models import motion_apply as TMA  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.models.shake import STYLES, generate_shake_motion_meta  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import cuda_build  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import resize as TR  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import warp as TW  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.utils import video_io as TIO  # noqa: E402

N, H, W = 10, 144, 192
CHUNK = 3
GRAY = (127, 127, 127)


@pytest.mark.parametrize("n,spans", [
    (0, []),
    (1, [(0, 1)]),
    (65535, [(0, 65535)]),
    (65536, [(0, 65535), (65535, 65536)]),
    (131071, [(0, 65535), (65535, 131070), (131070, 131071)]),
    (196606, [(0, 65535), (65535, 131070), (131070, 196605), (196605, 196606)]),
])
def test_frame_spans_exact(n, spans):
    assert cuda_build.MAX_GRID_FRAMES == 65535 and cuda_build.frame_spans(n) == spans


def test_chunk_plan_exact(monkeypatch):
    per_frame = TW.clip_device_bytes(1, 1080, 1920, 1080, 1920)
    assert per_frame == 4 * (1080 * 1920 * 3 + 1080 * 1920 * 4) == 58_060_800
    assert TW._chunk_frames(2000, 1080, 1920, 1080, 1920) == (64 << 30) // per_frame == 1183
    assert not TW.will_stream(1183, 1080, 1920, 1080, 1920) and TW.will_stream(1184, 1080, 1920, 1080, 1920)
    assert TW._chunk_frames(300, 2160, 3840, 2160, 3840) == 295
    _lower_budget(monkeypatch)
    assert TW._chunk_frames(N, H, W, H, W) == CHUNK and TW._chunk_frames(2, H, W, H, W) == 2
    assert TW._chunk_frames(N, 4000, 4000, 4000, 4000) == 1


def _lower_budget(monkeypatch, chunk=CHUNK):
    """Lower the budget to ``chunk`` frames of the clip; returns the list
    that counts the streamed calls."""
    monkeypatch.setattr(TW, "CHUNK_BUDGET_BYTES", chunk * TW.clip_device_bytes(1, H, W, H, W) + 1)
    calls = []
    stream = TW._stream_chunks
    monkeypatch.setattr(TW, "_stream_chunks", lambda *a: calls.append(1) or stream(*a))
    return calls


def _clip(seed=8, n=N):
    rng = np.random.default_rng(seed)
    img = cv2.GaussianBlur(rng.random((H + 80, W + 80), np.float32), (0, 0), 2.5)
    img += 0.3 * cv2.GaussianBlur(rng.random((H + 80, W + 80), np.float32), (0, 0), 8.0)
    base = (img - img.min()) / (img.max() - img.min())
    rgb = np.stack([base, 0.7 * base + 0.1, 1.0 - base], -1).astype(np.float32)
    mats = [np.eye(3)]
    for _ in range(n - 1):
        th = rng.uniform(-0.008, 0.008)
        t = rng.uniform(-2.5, 2.5, 2)
        mats.append(np.array([[np.cos(th), -np.sin(th), t[0]], [np.sin(th), np.cos(th), t[1]], [0, 0, 1.0]]) @ mats[-1])
    crop = np.eye(3)
    crop[0, 2] = crop[1, 2] = -40
    view = np.stack([crop @ np.linalg.inv(m) for m in mats])
    src = torch.from_numpy(np.repeat(rgb[None], n, 0))
    return TW.warp_clip(src, view, (W, H), "bilinear", (0.5, 0.5, 0.5))


@pytest.fixture(scope="module")
def clip():
    return _clip()


def _mats(seed, n=N, persp=0.0):
    rng = np.random.default_rng(seed)
    out = np.tile(np.eye(3), (n, 1, 1))
    th = rng.uniform(-0.02, 0.02, n)
    out[:, 0, 0] = out[:, 1, 1] = np.cos(th)
    out[:, 0, 1], out[:, 1, 0] = -np.sin(th), np.sin(th)
    out[:, :2, 2] = rng.uniform(-6, 6, (n, 2))
    out[:, 2, :2] = rng.uniform(-persp, persp, (n, 2))
    return out


def _equal(a, b):
    return a.shape == b.shape and torch.equal(a.cpu(), b.cpu())


@pytest.mark.parametrize("interp", ["bilinear", "bicubic", "nearest"])
def test_warp_clip_streamed_equal(clip, monkeypatch, interp):
    mats = _mats(1, persp=1e-4)
    ref = TW.warp_clip(clip, mats, (W + 16, H + 8), interp, (0.2, 0.4, 0.6))
    _lower_budget(monkeypatch)
    assert TW.will_stream(N, H, W, H + 8, W + 16)
    ours = TW.warp_clip(clip, mats, (W + 16, H + 8), interp, (0.2, 0.4, 0.6), device="cpu")
    assert ours.device.type == "cpu" and _equal(ours, ref)


def test_warp_clip_with_mask_streamed_equal(clip, monkeypatch):
    mats = _mats(2)
    ref = TW.warp_clip_with_mask(clip, mats, (W, H), "bilinear", (0.5, 0.5, 0.5))
    _lower_budget(monkeypatch)
    ours = TW.warp_clip_with_mask(clip, mats, (W, H), "bilinear", (0.5, 0.5, 0.5), device="cpu")
    assert all(_equal(a, b) for a, b in zip(ours, ref))
    assert float(ref[1].max()) == 1.0 and _equal(ref[2], ref[1].reshape(N, -1).mean(1))


@pytest.mark.parametrize("with_mask", [True, False])
def test_warp_clip_blur_streamed_equal(clip, monkeypatch, with_mask):
    samples = TMA.blurred_sample_matrices(_mats(3), 0.5, 5)
    ref = TW.warp_clip_blur(clip, samples, (W, H), "bicubic", (0.5, 0.5, 0.5), with_mask)
    _lower_budget(monkeypatch)
    ours = TW.warp_clip_blur(clip, samples, (W, H), "bicubic", (0.5, 0.5, 0.5), with_mask, device="cpu")
    assert _equal(ours[0], ref[0])
    assert (ours[1] is None) == (ref[1] is None) == (not with_mask)
    assert not with_mask or _equal(ours[1], ref[1])


def test_common_coverage_is_the_and_of_all_frames():
    mats = _mats(4, n=40)
    cover = TW.coverage_mask(mats, (W, H), (W, H), "cpu")
    assert _equal(TW.common_coverage(mats, (W, H), (W, H), "cpu"), cover.amin(0))
    assert _equal(TW.common_coverage(mats[:0], (W, H), (W, H), "cpu"), torch.ones((H, W)))


def test_gray_ingest_chunks_equal(clip):
    """Sixteen frames at a time: the grays of any clip length equal the
    per-frame computation, at the working size and decimated."""
    long = torch.cat([clip, clip.flip(0), clip[:3]])           # 23 frames: one full and one partial chunk
    for working, dec in ((None, 1), ((96, 72), 1), ((96, 72), 2), ((120, 90), 1)):
        whole = TR.gray_for_estimation(long, working, decimation=dec, device="cpu")
        single = torch.cat([TR.gray_for_estimation(long[i:i + 1], working, decimation=dec) for i in range(23)])
        assert _equal(whole, single)


def _context(frames):
    return TIO.normalize_video_input(frames, device="cpu")


def _strip_timing(meta):
    return {k: v for k, v in meta.items() if k != "timing"}


@pytest.mark.parametrize("estimator,framing,transform", [
    ("flow", "crop_and_pad", "similarity"),
    ("flow", "expand", "perspective"),
    ("classic", "crop", "similarity"),
])
def test_stabilizer_streamed_equal(clip, monkeypatch, estimator, framing, transform):
    run = TFL.stabilize_flow if estimator == "flow" else TCL.stabilize_classic
    args = (framing, transform, False, 0.8, 0.6, 0.6, GRAY, 24.0)
    ref = run(_context(clip), *args, device="cpu")
    streamed = _lower_budget(monkeypatch)
    ours = run(_context(clip), *args, device="cpu")
    assert streamed
    assert _equal(ours.frames, ref.frames) and _equal(ours.masks, ref.masks)
    assert _strip_timing(ours.meta) == _strip_timing(ref.meta)


@pytest.mark.parametrize("framing,blur", [("crop_and_pad", 0.5), ("crop_and_pad", 0.0), ("crop", 0.5),
                                          ("expand", 0.0)])
def test_motion_apply_streamed_equal(clip, monkeypatch, framing, blur):
    meta = {"motion_meta": generate_shake_motion_meta(
        recipe=STYLES["action"], frame_count=N, width=W, height=H, fps=24.0, amount=1.5, speed=1.0, seed=3)}
    kw = dict(framing_mode=framing, interpolation="bicubic", motion_blur=blur, motion_blur_samples=5, device="cpu")
    ticks_ref, ticks = [], []
    ref = TMA.apply_motion(_context(clip), meta, GRAY, progress_callback=lambda: ticks_ref.append(1), **kw)
    streamed = _lower_budget(monkeypatch)
    ours = TMA.apply_motion(_context(clip), meta, GRAY, progress_callback=lambda: ticks.append(1), **kw)
    assert _equal(ours.frames, ref.frames) and _equal(ours.masks, ref.masks)
    assert streamed and _strip_timing(ours.meta) == _strip_timing(ref.meta) and ticks == ticks_ref


def test_inverse_streamed_equal(clip, monkeypatch):
    from comfyui_video_stabilizer_tpu_torch.meta.motion_meta import build_stabilization_warp_meta

    meta = {"stabilization_warp": build_stabilization_warp_meta(
        source_size=(W, H), output_size=(W, H), framing_mode="crop_and_pad",
        applied_matrices=_mats(6).astype(np.float32))}
    ref = TINV.apply_inverse_stabilization(_context(clip), meta, GRAY, device="cpu")
    streamed = _lower_budget(monkeypatch)
    ours = TINV.apply_inverse_stabilization(_context(clip), meta, GRAY, device="cpu")
    assert streamed and _equal(ours.frames, ref.frames) and _equal(ours.masks, ref.masks)
