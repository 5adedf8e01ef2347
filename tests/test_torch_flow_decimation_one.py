"""Flow at decimation 1 (the 864x486 clips of the Wan VACE workflows)
against the JAX package, on CPU.

A height of 2 mod 4 cannot take the x4 gray pool, so Flow hands DIS the
full gray and DIS builds its own pyramid down to ``FINEST_SCALE``; the
other Flow parity tests run the pooled route (decimation 4 or
``finest_scale`` 0).  Input: a shaken 9-frame 122x216 clip, made with
numpy and the JAX warp and handed to both packages; the estimators take
the JAX package's grays.  ``dis_flow_fit`` at its default
``finest_scale`` also runs on three full 486x864 grays.

Tolerances, as tests/test_torch_stabilize_flow.py and
tests/test_torch_flow_dis.py state them: per-pair modes, acceptance and
``transform_mode_applied`` identical; matrices and confidences <= 1e-3;
frames p99 <= 1e-3 and max <= 1e-2; masks differ on <= 0.1 % of pixels;
DIS samples median |d| <= 1e-4 px and max <= 2e-2 px (measured:
matrices 5e-5, frames max 8e-6, masks equal, DIS samples max 8e-5 px
on flows of up to 6.5 px).  The node runs the port's plain path and,
with ``CVST_FASTPATH=1``, its fast path (the card's).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import cv2  # noqa: E402

from comfyui_video_stabilizer_tpu import nodes as JN  # noqa: E402
from comfyui_video_stabilizer_tpu.models import flow as JFL  # noqa: E402
from comfyui_video_stabilizer_tpu.ops import flow_dis as JFD  # noqa: E402
from comfyui_video_stabilizer_tpu.ops import resize as JR  # noqa: E402
from comfyui_video_stabilizer_tpu.ops import warp as JW  # noqa: E402
from comfyui_video_stabilizer_tpu_torch import nodes as TN  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.models import flow as TFL  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import flow_dis as TFD  # noqa: E402

NODE_ARGS = (16.0, "crop_and_pad", "similarity", False, 0.7, 0.5, 0.6, "#7F7F7F")


def _scene(h, w, seed):
    rng = np.random.default_rng(seed)
    img = rng.random((h, w), np.float32)
    img = cv2.GaussianBlur(img, (0, 0), 2.5)
    img += 0.3 * cv2.GaussianBlur(rng.random((h, w), np.float32), (0, 0), 8.0)
    return (img - img.min()) / (img.max() - img.min())


def _shaken(n, h, w, seed):
    base = _scene(h + 80, w + 80, seed)
    rng = np.random.default_rng(seed + 1)
    mats = [np.eye(3)]
    for _ in range(n - 1):
        th = rng.uniform(-0.008, 0.008)
        t = rng.uniform(-2.5, 2.5, 2)
        d = np.array([[np.cos(th), -np.sin(th), t[0]], [np.sin(th), np.cos(th), t[1]], [0, 0, 1.0]])
        mats.append(d @ mats[-1])
    crop = np.eye(3)
    crop[0, 2] = crop[1, 2] = -40
    view = np.stack([crop @ np.linalg.inv(m) for m in mats])
    return np.asarray(JW.warp_clip(np.repeat(base[None, ..., None], n, 0), view, (w, h), "bilinear", (0.5,)))


@pytest.fixture(scope="module")
def clip():
    return np.repeat(_shaken(9, 122, 216, 8), 3, axis=-1).astype(np.float32)


def test_the_plan_is_decimation_one():
    assert JFL._gray_decimation(216, 122, None) == TFL._gray_decimation(216, 122, None) == 1
    assert JFL._gray_decimation(864, 486, None) == TFL._gray_decimation(864, 486, None) == 1
    assert TFL.finest_scale(1) == TFD.FINEST_SCALE == JFD.FINEST_SCALE


@pytest.mark.parametrize("mode", ["similarity", "perspective"])
def test_flow_estimator_matches(clip, mode):
    grays = np.array(JR.gray_for_estimation(clip, None, decimation=1))
    assert grays.shape == (9, 122, 216)
    ref = JFL.flow_estimator(grays, mode, decimation=1)
    ours = TFL.flow_estimator(torch.from_numpy(grays), mode, decimation=1)
    assert ours.extra_meta == ref.extra_meta == {"flow_backend": "DIS", "flow_fallback_reason": None}
    assert list(ours.matrices) == list(ref.matrices)
    np.testing.assert_array_equal(ours.degenerate, ref.degenerate)
    for key in ref.matrices:
        np.testing.assert_array_equal(ours.accepted[key], ref.accepted[key])
        assert np.abs(ours.matrices[key] - ref.matrices[key]).max() <= 1e-3, key
        assert np.abs(np.asarray(ours.confidences[key]) - np.asarray(ref.confidences[key])).max() <= 1e-3


def _transitions(meta):
    return meta["estimated_motion"]["per_transition"]


@pytest.mark.parametrize("fast", ["0", "1"], ids=["plain", "fastpath"])
def test_node_matches(clip, monkeypatch, fast):
    monkeypatch.setenv("CVST_FASTPATH", fast)
    jf, jk, jm = JN.VideoStabilizerFlow.execute(torch.from_numpy(clip.copy()), *NODE_ARGS)[:3]
    tf, tk, tm = TN.VideoStabilizerFlow.execute(torch.from_numpy(clip.copy()), *NODE_ARGS, device="cpu")[:3]
    assert tm["flow_backend"] == jm["flow_backend"] == "DIS"
    assert tm["transform_mode_applied"] == jm["transform_mode_applied"]
    assert [t["mode"] for t in _transitions(tm)] == [t["mode"] for t in _transitions(jm)]
    jmat = np.array([t["matrix"] for t in _transitions(jm)])
    tmat = np.array([t["matrix"] for t in _transitions(tm)])
    assert np.abs(tmat - jmat).max() <= 1e-3
    d = np.abs(tf.numpy() - np.asarray(jf))
    assert np.quantile(d, 0.99) <= 1e-3 and d.max() <= 1e-2
    assert (tk.numpy() != np.asarray(jk)).mean() <= 1e-3


def test_dis_flow_fit_on_full_grays_matches():
    """Levels 5..2 of DIS's own pyramid of 486x864 grays (486 -> 243 ->
    121 -> 60 -> 30 -> 15 rows), sampled on the step-8 grid."""
    grays = (_shaken(3, 486, 864, 21)[..., 0] * 255.0).astype(np.float32)
    ref = np.asarray(JFD.dis_flow_fit(grays, 8))
    ours = TFD.dis_flow_fit(torch.from_numpy(grays), 8).numpy()
    assert ours.shape == ref.shape == (2, 61 * 108, 2)
    d = np.abs(ours - ref)
    assert np.median(d) <= 1e-4 and d.max() <= 2e-2
