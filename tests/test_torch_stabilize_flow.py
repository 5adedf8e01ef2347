"""The slice end to end: ``VideoStabilizerFlow.execute`` of both packages.

Input: the 8-frame 144x192 shaken clip of tests/test_flow.py (made with
numpy and the JAX warp, handed to both packages).  The JAX package runs
its host engine on the CPU; the port runs its plain versions on the
CPU.

Tolerances: per-pair modes and ``transform_mode_applied`` identical;
per-pair matrices <= 1e-3 (the fits agree to ~1e-5; the margin covers
float32 refit sums in another order); frames p99 <= 1e-3 and max
<= 1e-2 (warp weights follow from the matrices); masks differ on
<= 0.1 % of pixels (round-half-even ties at the coverage edge); meta
keys and every non-float value equal; progress ticks equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import cv2  # noqa: E402

from comfyui_video_stabilizer_tpu import nodes as JN  # noqa: E402
from comfyui_video_stabilizer_tpu.models import flow as JFL  # noqa: E402
from comfyui_video_stabilizer_tpu.models import motion_apply as JMA  # noqa: E402
from comfyui_video_stabilizer_tpu.models import stabilize as JST  # noqa: E402
from comfyui_video_stabilizer_tpu.ops import warp as JW  # noqa: E402
from comfyui_video_stabilizer_tpu.utils import video_io as JIO  # noqa: E402
from comfyui_video_stabilizer_tpu_torch import nodes as TN  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.models import flow as TFL  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.models import stabilize as TST  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.utils import video_io as TIO  # noqa: E402

GRAY = (127, 127, 127)
COMBOS = [("crop_and_pad", False), ("crop_and_pad", True), ("expand", False), ("expand", True)]


def _scene(h, w, seed):
    rng = np.random.default_rng(seed)
    img = rng.random((h, w), np.float32)
    img = cv2.GaussianBlur(img, (0, 0), 2.5)
    img += 0.3 * cv2.GaussianBlur(rng.random((h, w), np.float32), (0, 0), 8.0)
    return (img - img.min()) / (img.max() - img.min())


@pytest.fixture(scope="module")
def clip():
    h, w, n = 144, 192, 8
    base = _scene(h + 80, w + 80, 8)
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


@pytest.fixture(scope="module")
def runs(clip):
    """Node outputs of both packages for every (framing, camera_lock) combo."""
    out = {}
    for framing, lock in COMBOS:
        args = (16.0, framing, "similarity", lock, 0.9, 0.7, 0.6, "#7F7F7F")
        ref = JN.VideoStabilizerFlow.execute(torch.from_numpy(clip.copy()), *args)
        ours = TN.VideoStabilizerFlow.execute(torch.from_numpy(clip.copy()), *args, device="cpu")
        out[(framing, lock)] = (ref, ours)
    return out


def _non_float_items(obj, path=""):
    """Flatten a meta tree into (path, value) for every non-float leaf."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from _non_float_items(v, f"{path}/{k}")
    elif isinstance(obj, (list, tuple)):
        yield (path, f"len {len(obj)}")
        for i, v in enumerate(obj):
            yield from _non_float_items(v, f"{path}[{i}]")
    elif not isinstance(obj, float):
        yield (path, obj)


def _transitions(meta):
    return meta["estimated_motion"]["per_transition"]


@pytest.mark.parametrize("framing,lock", COMBOS)
def test_modes_and_matrices_match(runs, framing, lock):
    (_, _, jm), (_, _, tm) = runs[(framing, lock)]
    assert [t["mode"] for t in _transitions(tm)] == [t["mode"] for t in _transitions(jm)]
    assert tm["transform_mode_applied"] == jm["transform_mode_applied"] == "similarity"
    jmat = np.array([t["matrix"] for t in _transitions(jm)])
    tmat = np.array([t["matrix"] for t in _transitions(tm)])
    assert np.abs(tmat - jmat).max() <= 1e-3
    japp = np.array([e["applied_matrix"] for e in jm["stabilization_warp"]["per_frame"]])
    tapp = np.array([e["applied_matrix"] for e in tm["stabilization_warp"]["per_frame"]])
    assert np.abs(tapp - japp).max() <= 1e-3


@pytest.mark.parametrize("framing,lock", COMBOS)
def test_frames_and_masks_match(runs, framing, lock):
    (jf, jk, _), (tf, tk, _) = runs[(framing, lock)]
    assert isinstance(tf, torch.Tensor) and tf.device.type == "cpu" and tf.is_contiguous()
    assert tf.dtype == torch.float32 and tuple(tf.shape) == tuple(jf.shape)
    assert tuple(tk.shape) == tuple(jk.shape) and tk.dtype == torch.float32
    d = (tf - jf).abs().numpy()
    assert np.quantile(d, 0.99) <= 1e-3 and d.max() <= 1e-2
    assert (tk.numpy() != jk.numpy()).mean() <= 1e-3


@pytest.mark.parametrize("framing,lock", COMBOS)
def test_meta_keys_and_non_float_values_match(runs, framing, lock):
    (_, _, jm), (_, _, tm) = runs[(framing, lock)]
    assert list(tm) == list(jm)
    assert dict(_non_float_items(tm)) == dict(_non_float_items(jm))
    for key in ("padding_fraction_mean", "padding_fraction_max"):
        assert abs(tm[key] - jm[key]) <= 1e-3


def test_stabilization_reduces_motion(clip, runs):
    (_, _, _), (tf, _, tm) = runs[("crop_and_pad", False)]
    assert tm["flow_backend"] == "DIS" and tm["flow_fallback_reason"] is None
    assert all(t["confidence"] > 0.3 for t in _transitions(tm))
    orig = np.abs(np.diff(clip, axis=0)).mean()
    stab = np.abs(np.diff(tf.numpy()[:, 20:-20, 20:-20], axis=0)).mean()
    assert stab < orig * 0.8


def test_motion_meta_replays_through_jax_motion_apply(clip, runs):
    """Interop: the port's motion_meta drives the JAX Motion Apply and
    reproduces the port's frames (tolerance 1e-5: both warps sample the
    same matrices with the same formula)."""
    (_, _, _), (tf, _, tm) = runs[("crop_and_pad", False)]
    replay = JMA.apply_motion(JIO.normalize_video_input(clip), tm, GRAY)
    assert np.abs(np.asarray(replay.frames) - tf.numpy()).max() <= 1e-5


def test_progress_ticks_match(clip):
    ref_ticks, our_ticks = [], []
    JFL.stabilize_flow(JIO.normalize_video_input(clip), "crop_and_pad", "similarity", False, 0.9, 0.7,
                       0.6, GRAY, 16.0, progress=lambda d, t: ref_ticks.append((d, t)))
    TFL.stabilize_flow(TIO.normalize_video_input(clip, device="cpu"), "crop_and_pad", "similarity", False,
                       0.9, 0.7, 0.6, GRAY, 16.0, progress=lambda d, t: our_ticks.append((d, t)),
                       device="cpu")
    assert our_ticks == ref_ticks and our_ticks


def test_interrupt_propagates(clip):
    class Stop(Exception):
        pass

    def interrupt():
        raise Stop()

    with pytest.raises(Stop):
        TFL.stabilize_flow(TIO.normalize_video_input(clip, device="cpu"), "crop_and_pad", "similarity",
                           False, 0.9, 0.7, 0.6, GRAY, 16.0, interrupt_check=interrupt, device="cpu")


def test_single_frame_early_out_matches(clip):
    ref = JN.VideoStabilizerFlow.execute(torch.from_numpy(clip[:1].copy()), 16.0, "crop_and_pad",
                                         "similarity", False, 0.9, 0.7, 0.6, "#7F7F7F")
    ours = TN.VideoStabilizerFlow.execute(torch.from_numpy(clip[:1].copy()), 16.0, "crop_and_pad",
                                          "similarity", False, 0.9, 0.7, 0.6, "#7F7F7F", device="cpu")
    assert torch.equal(ours[0], ref[0]) and torch.equal(ours[1], ref[1])
    assert list(ours[2]) == list(ref[2])
    assert dict(_non_float_items(ours[2])) == dict(_non_float_items(ref[2]))


@pytest.mark.parametrize("n", [1, 2, 33, 34, 80, 257])
def test_estimation_chunk_spans_equal(n):
    assert TST.estimation_chunk_spans(n) == JST.estimation_chunk_spans(n)


def test_flow_node_schema_equals_jax():
    ref = JN.VideoStabilizerFlow.define_schema()
    ours = TN.VideoStabilizerFlow.define_schema()
    for field in ("node_id", "display_name", "category", "description", "is_deprecated"):
        assert getattr(ours, field) == getattr(ref, field)
    for a, b in ((ours.inputs, ref.inputs), (ours.outputs, ref.outputs)):
        assert [(s.kind, s.io_type, s.id, s.options) for s in a] == \
               [(s.kind, s.io_type, s.id, s.options) for s in b]


@pytest.mark.parametrize("framing,transform", [("crop", "similarity"), ("crop_and_pad", "perspective"),
                                               ("crop", "perspective")])
def test_unported_modes_raise(clip, framing, transform):
    """Crop framing and perspective, once unported, against the JAX node
    (keep_fov 0.6, which the crop search meets): the per-pair modes, the
    crop status and note and every other non-float meta value equal;
    matrices and applied matrices <= 1e-3; crop scale, origin and size
    within 1e-6 relative; frames p99 <= 1e-3."""
    args = (16.0, framing, transform, False, 0.9, 0.7, 0.6, "#7F7F7F")
    ref = JN.VideoStabilizerFlow.execute(torch.from_numpy(clip.copy()), *args)
    ours = TN.VideoStabilizerFlow.execute(torch.from_numpy(clip.copy()), *args, device="cpu")
    _assert_node_parity(ref, ours, transform)


def _assert_node_parity(ref, ours, transform):
    (jf, _, jm), (tf, _, tm) = ref, ours
    assert [t["mode"] for t in _transitions(tm)] == [t["mode"] for t in _transitions(jm)]
    assert tm["transform_mode_applied"] == jm["transform_mode_applied"] == transform
    assert list(tm) == list(jm)
    assert dict(_non_float_items(tm)) == dict(_non_float_items(jm))
    for key in ("matrix",):
        a = np.array([t[key] for t in _transitions(tm)])
        b = np.array([t[key] for t in _transitions(jm)])
        assert np.abs(a - b).max() <= 1e-3
    tapp = np.array([e["applied_matrix"] for e in tm["stabilization_warp"]["per_frame"]])
    japp = np.array([e["applied_matrix"] for e in jm["stabilization_warp"]["per_frame"]])
    assert np.abs(tapp - japp).max() <= 1e-3
    for key in ("stabilization_scale", "crop_origin", "crop_size", "keep_fov_effective"):
        if key in jm["framing"]:
            np.testing.assert_allclose(tm["framing"][key], jm["framing"][key], rtol=1e-6, atol=1e-6)
    d = (tf - jf).abs().numpy()
    assert np.quantile(d, 0.99) <= 1e-3
