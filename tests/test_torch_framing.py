"""Crop framing of the port against the JAX package.

Inputs are masks and correction deltas made from a numpy seed, and the
8-frame 144x192 shaken clip of tests/test_torch_stabilize_flow.py; the
JAX side runs its host engine on the CPU.

Tolerances: morphology, bounding boxes and the rectangle search exact;
crop statuses, notes and ``keep_fov_applied`` byte-equal (met, clamped,
failed, disabled with and without overlap, and the keep_fov >= 0.9999
early-out); scale, crop origin and size, the effective keep_fov and
the matrices within 1e-6 relative (host float64 numpy on both sides).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import cv2  # noqa: E402

from comfyui_video_stabilizer_tpu import nodes as JN  # noqa: E402
from comfyui_video_stabilizer_tpu.models import framing as JF  # noqa: E402
from comfyui_video_stabilizer_tpu.ops import morphology as JM  # noqa: E402
from comfyui_video_stabilizer_tpu.ops import warp as JW  # noqa: E402
from comfyui_video_stabilizer_tpu_torch import nodes as TN  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.models import framing as TF  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.models import geometry as TG  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import morphology as TM  # noqa: E402

WIDTH, HEIGHT = 192, 144


def _masks(seed, n=3, h=20, w=30):
    rng = np.random.default_rng(seed)
    m = (rng.random((n, h, w)) < 0.6).astype(np.float32)
    m[0] = 0.0                                   # an empty frame
    m[1, 3:15, 4:25] = 1.0
    return m


@pytest.mark.parametrize("radius", [1, 2])
def test_dilate_erode_exact(radius):
    m = _masks(radius)
    np.testing.assert_array_equal(TM.dilate(torch.from_numpy(m), radius).numpy(), np.asarray(JM.dilate(m, radius)))
    np.testing.assert_array_equal(TM.erode(torch.from_numpy(m), radius).numpy(), np.asarray(JM.erode(m, radius)))


def test_content_bboxes_exact():
    m = _masks(3)
    for ours, ref in zip(TM.content_bboxes(torch.from_numpy(m)), JM.content_bboxes(m)):
        np.testing.assert_array_equal(ours, ref)
        assert ours.dtype == ref.dtype


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_aspect_rectangle_exact(seed):
    rng = np.random.default_rng(seed)
    mask = np.zeros((72, 96), bool)
    y0, x0 = rng.integers(0, 20, 2)
    mask[y0:y0 + 40 + seed * 5, x0:x0 + 60] = True
    mask[rng.integers(0, 72, 30), rng.integers(0, 96, 30)] ^= True
    np.testing.assert_array_equal(TM.integral_image(mask), JM.integral_image(mask))
    assert TM.largest_aspect_ratio_rectangle(mask, 16, 9) == JM.largest_aspect_ratio_rectangle(mask, 16, 9)
    assert TM.largest_aspect_ratio_rectangle(np.zeros((8, 8), bool), 4, 3) is None


def _deltas(seed, n=6, rot=0.02, trans=12.0):
    rng = np.random.default_rng(seed)
    th = rng.uniform(-rot, rot, n)
    mats = np.tile(np.eye(3), (n, 1, 1))
    mats[:, 0, 0] = mats[:, 1, 1] = np.cos(th)
    mats[:, 0, 1], mats[:, 1, 0] = -np.sin(th), np.sin(th)
    mats[:, :2, 2] = rng.uniform(-trans, trans, (n, 2))
    return TG.matrices_to_params(mats, "similarity")


def _close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.allclose(a, b, rtol=1e-6, atol=1e-6)


# (deltas, keep_fov, the status it gives)
CROP_CASES = {
    "met_full": (dict(seed=0, rot=0.002, trans=2.0), 0.6, "met"),
    "met_search": (dict(seed=1), 0.9, "met"),
    "clamped": (dict(seed=1), 0.9, "clamped"),
    "failed": (dict(seed=2), 0.99, "failed"),
    "disabled": (dict(seed=3), 0.0, "disabled"),
    "disabled_no_overlap": (dict(seed=4, trans=400.0), 0.0, "disabled"),
}


@pytest.mark.parametrize("case", sorted(CROP_CASES))
def test_keep_fov_search_matches(case, monkeypatch):
    kw, keep_fov, status = CROP_CASES[case]
    deltas = _deltas(**kw)
    if case == "clamped":
        # the closed-mask ratio falls below the target only where the
        # intersection box overstates the content; force it on both sides
        monkeypatch.setattr(JF, "_masked_min_ratio", lambda *a: 0.5)
        monkeypatch.setattr(TF, "_masked_min_ratio", lambda *a: 0.5)
    margin = max(0.5, 0.02 * max(WIDTH, HEIGHT))
    ref = JF.compute_crop_with_keep_fov_parametric("similarity", deltas, WIDTH, HEIGHT, keep_fov, margin,
                                                   return_masks=False)
    ours = TF.compute_crop_with_keep_fov_parametric("similarity", deltas, WIDTH, HEIGHT, keep_fov, margin, "cpu")
    final, pre, _, ratio, st, note, scale, origin, size = ref
    assert ours[3] == st == status and ours[4] == note
    assert _close(ours[0], final) and _close(ours[1], pre)
    assert _close(ours[2], ratio) and _close(ours[5], scale)
    assert _close(ours[6], origin) and _close(ours[7], size)
    if case in ("met_search", "clamped"):
        assert 0.0 < scale < 1.0                 # the binary search ran
    r_final, _, r_origin, r_size, r_eff = JF.refine_no_padding_crop(final, WIDTH, HEIGHT, safety_shrink_px=1)
    o_final, o_origin, o_size, o_eff = TF.refine_no_padding_crop(ours[0], WIDTH, HEIGHT, "cpu", safety_shrink_px=1)
    assert _close(o_final, r_final) and o_origin == r_origin and o_size == r_size and o_eff == r_eff


def test_masked_min_ratio_matches():
    deltas = _deltas(5, n=5, rot=0.05, trans=30.0)
    mats = TG.params_to_matrices(deltas, "similarity")
    ref = JF._masked_min_ratio(np.asarray(JF._closed_content_masks(mats, WIDTH, HEIGHT)), WIDTH, HEIGHT)
    assert TF._masked_min_ratio(mats, WIDTH, HEIGHT, "cpu") == ref < 1.0


def test_refine_bails_without_common_region():
    mats = np.tile(np.eye(3), (2, 1, 1))
    mats[1, 0, 2] = 500.0                       # frame 1 covers nothing in common with frame 0
    ref = JF.refine_no_padding_crop(mats, WIDTH, HEIGHT)
    ours = TF.refine_no_padding_crop(mats, WIDTH, HEIGHT, "cpu")
    np.testing.assert_array_equal(ours[0], ref[0])
    assert (ours[1], ours[2], ours[3]) == (ref[2], ref[3], ref[4]) == ([0.0, 0.0], [192.0, 144.0], 0.0)


@pytest.fixture(scope="module")
def clip():
    """The 8-frame 144x192 shaken clip of tests/test_torch_stabilize_flow.py."""
    h, w, n = HEIGHT, WIDTH, 8
    rng = np.random.default_rng(8)
    img = cv2.GaussianBlur(rng.random((h + 80, w + 80), np.float32), (0, 0), 2.5)
    img += 0.3 * cv2.GaussianBlur(rng.random((h + 80, w + 80), np.float32), (0, 0), 8.0)
    base = (img - img.min()) / (img.max() - img.min())
    rng = np.random.default_rng(9)
    mats = [np.eye(3)]
    for _ in range(n - 1):
        th = rng.uniform(-0.008, 0.008)
        t = rng.uniform(-2.5, 2.5, 2)
        d = np.array([[np.cos(th), -np.sin(th), t[0]], [np.sin(th), np.cos(th), t[1]], [0, 0, 1.0]])
        mats.append(d @ mats[-1])
    crop = np.eye(3)
    crop[0, 2] = crop[1, 2] = -40
    view = np.stack([crop @ np.linalg.inv(m) for m in mats])
    frames = np.asarray(JW.warp_clip(np.repeat(base[None, ..., None], n, 0), view, (w, h), "bilinear", (0.5,)))
    return np.repeat(frames, 3, axis=-1).astype(np.float32)


def _framing_items(meta):
    keys = ("keep_fov_status", "keep_fov_note", "keep_fov_requested", "keep_fov_effective",
            "stabilization_scale", "crop_origin", "crop_size", "mode")
    return {k: meta["framing"].get(k) for k in keys}


@pytest.mark.parametrize("keep_fov", [1.0, 0.95, 0.0])
def test_crop_node_statuses_match(clip, keep_fov):
    """The Flow node in crop mode: the early-out (1.0), failed (0.95) and
    disabled (0.0) on the shaken clip (0.6, met, runs in the Flow and
    Classic node tests)."""
    args = (16.0, "crop", "similarity", False, 0.9, 0.7, keep_fov, "#7F7F7F")
    ref = JN.VideoStabilizerFlow.execute(torch.from_numpy(clip.copy()), *args)
    ours = TN.VideoStabilizerFlow.execute(torch.from_numpy(clip.copy()), *args, device="cpu")
    jm, tm = ref[2], ours[2]
    assert list(tm) == list(jm) and list(tm["framing"]) == list(jm["framing"])
    assert _framing_items(tm) == _framing_items(jm)
    assert tm["keep_fov_applied"] == jm["keep_fov_applied"] and tm.get("note") == jm.get("note")
    assert abs(tm["strength_effective"] - jm["strength_effective"]) <= 1e-6
    d = (ours[0] - ref[0]).abs().numpy()
    assert np.quantile(d, 0.99) <= 1e-3
    if keep_fov == 1.0:
        assert torch.equal(ours[0], ref[0]) and torch.equal(ours[1], ref[1])
