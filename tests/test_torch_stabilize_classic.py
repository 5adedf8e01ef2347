"""The Classic slice end to end: ``VideoStabilizerClassic.execute`` of
both packages.

Input: the 8-frame 144x192 shaken textured clip of tests/test_classic.py
(made with numpy and the JAX warp, handed to both packages).  The JAX
package runs its host engine on the CPU (GFTT scored by the XLA form,
the device greedy, the XLA LK loop); the port runs its plain versions
on the CPU (K4's summation order, K7's greedy, K5's loop).

Tolerances: per-pair modes and ``transform_mode_applied`` identical;
per-pair matrices <= 1e-3 (the fits agree to ~1e-5; the margin covers
float32 refit sums in another order); confidences equal, or within
1/400 where one track flips between the two LK loops; frames p99
<= 1e-3 and max <= 1e-2 (warp weights follow from the matrices); masks
differ on <= 0.1 % of pixels (round-half-even ties at the coverage
edge); meta keys and every non-float value equal; progress ticks equal.
The port's chunked estimation equals its single call exactly, and its
motion_meta replays through the JAX Motion Apply to within 1e-5.

The whole-clip estimation program (``_classic_estimate_fused`` of both
packages, on the same grays): corners and detected counts equal; status
>= 99.5 % equal and live tracks within 0.05 px (tests/test_torch_lk.py,
the JAX package's contract for its two LK loops); survivor counts within
one a pair (the 1/400 above); the similarity and translation fits
<= 1e-3, their inlier and valid counts within one; the perspective fit
at the frame's corners within 1e-2 px (tests/test_torch_perspective.py).
Measured: status equal, tracks 7.6e-6 px, every count equal, the
similarity fit 2.3e-5, the homography's entries 1.7e-4.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from comfyui_video_stabilizer_tpu import nodes as JN  # noqa: E402
from comfyui_video_stabilizer_tpu.models import classic as JCL  # noqa: E402
from comfyui_video_stabilizer_tpu.models import motion_apply as JMA  # noqa: E402
from comfyui_video_stabilizer_tpu.ops import resize as JR  # noqa: E402
from comfyui_video_stabilizer_tpu.utils import video_io as JIO  # noqa: E402
from comfyui_video_stabilizer_tpu_torch import nodes as TN  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.models import classic as TCL  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import ransac as TRS  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.utils import video_io as TIO  # noqa: E402
from test_classic import _shaken_clip  # noqa: E402
from test_torch_stabilize_flow import _assert_node_parity, _non_float_items, _transitions  # noqa: E402

GRAY = (127, 127, 127)
COMBOS = [
    ("crop_and_pad", "similarity", False),
    ("crop_and_pad", "translation", True),
    ("expand", "similarity", True),
]


@pytest.fixture(scope="module")
def clip():
    frames, _ = _shaken_clip(n=8, seed=6)
    return np.array(frames, dtype=np.float32)


@pytest.fixture(scope="module")
def runs(clip):
    """Node outputs of both packages for every combo."""
    out = {}
    for framing, mode, lock in COMBOS:
        args = (16.0, framing, mode, lock, 0.9, 0.7, 0.6, "#7F7F7F")
        ref = JN.VideoStabilizerClassic.execute(torch.from_numpy(clip.copy()), *args)
        ours = TN.VideoStabilizerClassic.execute(torch.from_numpy(clip.copy()), *args, device="cpu")
        out[(framing, mode, lock)] = (ref, ours)
    return out


@pytest.mark.parametrize("combo", COMBOS)
def test_modes_matrices_and_confidences_match(runs, combo):
    (_, _, jm), (_, _, tm) = runs[combo]
    assert [t["mode"] for t in _transitions(tm)] == [t["mode"] for t in _transitions(jm)]
    assert tm["transform_mode_applied"] == jm["transform_mode_applied"] == combo[1]
    jmat = np.array([t["matrix"] for t in _transitions(jm)])
    tmat = np.array([t["matrix"] for t in _transitions(tm)])
    assert np.abs(tmat - jmat).max() <= 1e-3
    jconf = np.array([t["confidence"] for t in _transitions(jm)])
    tconf = np.array([t["confidence"] for t in _transitions(tm)])
    assert np.abs(tconf - jconf).max() <= 1.0 / 400
    assert (tconf > 0.5).all()
    japp = np.array([e["applied_matrix"] for e in jm["stabilization_warp"]["per_frame"]])
    tapp = np.array([e["applied_matrix"] for e in tm["stabilization_warp"]["per_frame"]])
    assert np.abs(tapp - japp).max() <= 1e-3


@pytest.mark.parametrize("combo", COMBOS)
def test_frames_and_masks_match(runs, combo):
    (jf, jk, _), (tf, tk, _) = runs[combo]
    assert isinstance(tf, torch.Tensor) and tf.device.type == "cpu" and tf.is_contiguous()
    assert tf.dtype == torch.float32 and tuple(tf.shape) == tuple(jf.shape)
    assert tuple(tk.shape) == tuple(jk.shape) and tk.dtype == torch.float32
    d = (tf - jf).abs().numpy()
    assert np.quantile(d, 0.99) <= 1e-3 and d.max() <= 1e-2
    assert (tk.numpy() != jk.numpy()).mean() <= 1e-3


@pytest.mark.parametrize("combo", COMBOS)
def test_meta_keys_and_non_float_values_match(runs, combo):
    (_, _, jm), (_, _, tm) = runs[combo]
    assert list(tm) == list(jm)
    assert dict(_non_float_items(tm)) == dict(_non_float_items(jm))
    for key in ("padding_fraction_mean", "padding_fraction_max"):
        assert abs(tm[key] - jm[key]) <= 1e-3


def test_stabilization_reduces_motion(clip, runs):
    (_, _, _), (tf, _, _) = runs[("crop_and_pad", "similarity", False)]
    orig = np.abs(np.diff(clip, axis=0)).mean()
    stab = np.abs(np.diff(tf.numpy()[:, 20:-20, 20:-20], axis=0)).mean()
    assert stab < orig


def test_motion_meta_replays_through_jax_motion_apply(clip, runs):
    (_, _, _), (tf, _, tm) = runs[("crop_and_pad", "similarity", False)]
    replay = JMA.apply_motion(JIO.normalize_video_input(clip), tm, GRAY)
    assert np.abs(np.asarray(replay.frames) - tf.numpy()).max() <= 1e-5


def test_progress_ticks_match(clip):
    ref_ticks, our_ticks = [], []
    args = ("crop_and_pad", "similarity", False, 0.9, 0.7, 0.6, GRAY, 16.0)
    JCL.stabilize_classic(JIO.normalize_video_input(clip), *args,
                          progress=lambda d, t: ref_ticks.append((d, t)))
    TCL.stabilize_classic(TIO.normalize_video_input(clip, device="cpu"), *args,
                          progress=lambda d, t: our_ticks.append((d, t)), device="cpu")
    assert our_ticks == ref_ticks and our_ticks


def _frame_corners(H, h, w):
    c = np.array([[0, 0, 1], [w, 0, 1], [0, h, 1], [w, h, 1]], np.float64)
    p = np.einsum("bij,kj->bki", H.astype(np.float64), c)
    return p[..., :2] / p[..., 2:]


@pytest.mark.parametrize("want_persp", [False, True])
def test_classic_estimate_fused_matches_jax(clip, want_persp):
    grays = np.array(JR.gray_for_estimation(jnp.asarray(clip), None), np.float32)
    ref = [np.asarray(x) for x in JCL._classic_estimate_fused(jnp.asarray(grays), 3, want_persp,
                                                              TRS.DEFAULT_HYPOTHESES)]
    ours = [x.numpy() for x in TCL._classic_estimate_fused(torch.from_numpy(grays), 3, want_persp,
                                                           TRS.DEFAULT_HYPOTHESES)]
    assert len(ours) == len(ref) == (12 if want_persp else 9)
    (pts, det, tracked, status, surv), (r_pts, r_det, r_tracked, r_status, r_surv) = ours[:5], ref[:5]
    assert np.array_equal(pts, r_pts) and np.array_equal(det, r_det)
    assert (det >= 12).all()
    assert (status == r_status).mean() >= 0.995
    live = status & r_status
    assert np.abs(tracked - r_tracked)[live].max() <= 0.05
    assert np.abs(surv.astype(np.int64) - r_surv).max() <= 1
    fits, r_fits = ours[5:], ref[5:]
    if want_persp:
        (H, nH, vH), (r_H, r_nH, r_vH) = fits[:3], r_fits[:3]
        h, w = grays.shape[1:]
        assert np.abs(_frame_corners(H, h, w) - _frame_corners(r_H, h, w)).max() <= 1e-2
        assert np.abs(nH.astype(np.int64) - r_nH).max() <= 1 and np.abs(vH.astype(np.int64) - r_vH).max() <= 1
        fits, r_fits = fits[3:], r_fits[3:]
    (S, nS, vS, T), (r_S, r_nS, r_vS, r_T) = fits, r_fits
    assert np.abs(S - r_S).max() <= 1e-3 and np.abs(T - r_T).max() <= 1e-3
    assert np.abs(nS.astype(np.int64) - r_nS).max() <= 1 and np.abs(vS.astype(np.int64) - r_vS).max() <= 1


def test_chunked_estimation_equals_single_call():
    """34 frames: two 32-pair chunks with a tick between them give the
    same fits as one call (GFTT is per frame and LK per pair)."""
    rng = np.random.default_rng(5)
    base = rng.random((64, 80), np.float32)
    frames = np.stack([np.roll(base, (int(2 * np.sin(i)), int(3 * np.cos(i))), (0, 1))
                       for i in range(34)])
    grays = torch.from_numpy(np.floor(frames * 255.0))
    whole = TCL.classic_estimator(grays, "similarity")
    ticks = []
    chunked = TCL.classic_estimator(grays, "similarity", tick_pairs=ticks.append)
    assert ticks == [32, 33]
    np.testing.assert_array_equal(whole.degenerate, chunked.degenerate)
    assert not whole.degenerate.any()
    for key in whole.matrices:
        np.testing.assert_array_equal(whole.matrices[key], chunked.matrices[key])
        np.testing.assert_array_equal(whole.confidences[key], chunked.confidences[key])
        np.testing.assert_array_equal(whole.accepted[key], chunked.accepted[key])


def test_classic_node_schema_equals_jax():
    ref = JN.VideoStabilizerClassic.define_schema()
    ours = TN.VideoStabilizerClassic.define_schema()
    for field in ("node_id", "display_name", "category", "description", "is_deprecated"):
        assert getattr(ours, field) == getattr(ref, field)
    for a, b in ((ours.inputs, ref.inputs), (ours.outputs, ref.outputs)):
        assert [(s.kind, s.io_type, s.id, s.options) for s in a] == \
               [(s.kind, s.io_type, s.id, s.options) for s in b]
    assert [n.__name__ for n in TN.ALL_NODES] == [n.__name__ for n in JN.ALL_NODES]


@pytest.mark.parametrize("framing,transform", [("crop", "similarity"), ("crop_and_pad", "perspective"),
                                               ("crop", "perspective")])
def test_unported_modes_raise(clip, framing, transform):
    """Crop framing and perspective, once unported, against the JAX node
    (keep_fov 0.6): the tolerances of tests/test_torch_stabilize_flow.py's
    case of the same name."""
    args = (16.0, framing, transform, False, 0.9, 0.7, 0.6, "#7F7F7F")
    ref = JN.VideoStabilizerClassic.execute(torch.from_numpy(clip.copy()), *args)
    ours = TN.VideoStabilizerClassic.execute(torch.from_numpy(clip.copy()), *args, device="cpu")
    _assert_node_parity(ref, ours, transform)
