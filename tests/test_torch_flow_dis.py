"""DIS fit path of the port against the JAX package, on CPU.

The main case runs ``dis_flow_fit`` on 6 frames of 36x48 decimated
grays (the 144x192 clip path: working size, then the x4 pool).
Tolerance on the (N-1, P, 2) samples: median |d| <= 1e-4 px, max
<= 2e-2 px.  Both sides follow the same op order, but XLA's CPU backend
contracts multiply-adds into FMAs, so costs differ by ulps; a flipped
argmin tie moves one pixel's cost-volume flow by up to a pixel before
the 8x8 densification averages it down.  The stages are also compared
one by one, each with the tolerance stated beside it.

The dense path (``dis_flow``: three refine rounds at radius 3, the
half-res polish and the upsample chain) runs on a (4, 75, 99) clip,
whose level sizes are odd (75x99 -> 37x49 -> 18x24), so the upsampling
takes 2h + 1 outputs.  Tolerances: flow median <= 1e-5 px and max
<= 1e-3 px, confidence <= 1e-4 (the same FMA ulps; on this clip no
argmin tie flips).  ``_upsample2_flow``: <= 4e-6 px on unit-scale
flows; ``F.interpolate`` and ``jax.image.resize`` weigh the same two
taps (the edge renormalisation equals the clamp), but the sample
positions (i + 0.5) / (out / in) and (i + 0.5) * (in / out) and the
weight sums round apart at odd sizes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import cv2  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from comfyui_video_stabilizer_tpu.ops import flow_dis as JFD  # noqa: E402
from comfyui_video_stabilizer_tpu.ops import resize as JR  # noqa: E402
from comfyui_video_stabilizer_tpu.ops import warp as JW  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import flow_dis as TFD  # noqa: E402


def _scene(h, w, seed):
    rng = np.random.default_rng(seed)
    img = rng.random((h, w), np.float32)
    img = cv2.GaussianBlur(img, (0, 0), 2.5)
    img += 0.3 * cv2.GaussianBlur(rng.random((h, w), np.float32), (0, 0), 8.0)
    return (img - img.min()) / (img.max() - img.min())


@pytest.fixture(scope="module")
def grays():
    """(6, 36, 48) grays of a shaken 144x192 clip, made by the JAX package."""
    h, w, n = 144, 192, 6
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
    frames = np.asarray(JW.warp_clip(np.repeat(base[None, ..., None], n, 0), view, (w, h),
                                     "bilinear", (0.5,)))
    frames = np.repeat(frames, 3, axis=-1).astype(np.float32)
    return np.array(JR.gray_for_estimation(frames, None, decimation=4))


@pytest.fixture(scope="module")
def level_inputs(grays):
    """A level pair (I, J) and a similarity pre-warp matrix per pair."""
    I, J = grays[:-1], grays[1:]
    th = np.linspace(-0.01, 0.01, I.shape[0])
    M = np.stack([np.array([[np.cos(t), -np.sin(t), 0.7 - 3 * t], [np.sin(t), np.cos(t), -0.4],
                            [0, 0, 1.0]]) for t in th]).astype(np.float32)
    return I, J, M


def test_dis_flow_fit_samples_match(grays):
    ref = np.asarray(JFD.dis_flow_fit(grays, 2, finest_scale=0))
    ours = TFD.dis_flow_fit(torch.from_numpy(grays), 2, finest_scale=0).numpy()
    assert ours.shape == ref.shape == (5, 18 * 24, 2)
    d = np.abs(ours - ref)
    assert np.median(d) <= 1e-4
    assert d.max() <= 2e-2


def test_pyramid_matches(grays):
    """Tolerance: exact (means of integer grays are exact in float32)."""
    ref = JFD.build_pyramid(grays, 2)
    ours = TFD.build_pyramid(torch.from_numpy(grays), 2)
    for r, o in zip(ref, ours):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    assert TFD.num_levels(36, 48) == JFD.num_levels(36, 48)
    assert TFD.num_levels(135, 240) == JFD.num_levels(135, 240) == 3


def test_warp_similarity_device_matches(level_inputs):
    """Tolerance: 1e-3 grey levels (0..255 values; FMA contraction in XLA)."""
    _, J, M = level_inputs
    ref = np.asarray(JFD._warp_similarity_device(jnp.asarray(J), jnp.asarray(M), pad_t=32, radius=4))
    ours = TFD._warp_similarity_device(torch.from_numpy(J), torch.from_numpy(M), pad_t=32, radius=4)
    assert np.abs(ours.numpy() - ref).max() <= 1e-3


@pytest.mark.parametrize("lk_only", [False, True])
def test_residual_flow_matches(level_inputs, lk_only):
    """Tolerance: flow median 1e-5 px, 99th percentile 1e-3 px (argmin
    ties may flip, see module docstring); confidence 1e-4."""
    I, J, _ = level_inputs
    rf, rc = JFD._residual_flow(jnp.asarray(I), jnp.asarray(J), 2, 8, lk_only)
    of, oc = TFD._residual_flow(torch.from_numpy(I), torch.from_numpy(J), 2, 8, lk_only)
    d = np.abs(of.numpy() - np.asarray(rf))
    assert np.median(d) <= 1e-5 and np.quantile(d, 0.99) <= 1e-3
    assert np.abs(oc.numpy() - np.asarray(rc)).max() <= 1e-4


def test_fit_compose_and_guard_match(level_inputs):
    """Tolerance: matrices 1e-4 (float32 sums over ~100 samples in
    another order); composed flow 1e-4 px."""
    I, J, M = level_inputs
    flow, conf = JFD._residual_flow(jnp.asarray(I), jnp.asarray(J), 2, 8)
    flow, conf = np.array(flow), np.array(conf)
    ref_fit = np.asarray(JFD._fit_similarity_dense(jnp.asarray(flow), jnp.asarray(conf), 4))
    our_fit = TFD._fit_similarity_dense(torch.from_numpy(flow), torch.from_numpy(conf), 4).numpy()
    assert np.abs(our_fit - ref_fit).max() <= 1e-4
    ref_c = np.asarray(JFD._compose_flow(jnp.asarray(M), jnp.asarray(flow)))
    our_c = TFD._compose_flow(torch.from_numpy(M), torch.from_numpy(flow)).numpy()
    assert np.abs(our_c - ref_c).max() <= 1e-4
    ref_g = np.asarray(JFD._guarded_fit(jnp.asarray(flow), jnp.asarray(conf), jnp.asarray(M), "similarity"))
    our_g = TFD._guarded_fit(torch.from_numpy(flow), torch.from_numpy(conf), torch.from_numpy(M),
                             "similarity").numpy()
    assert np.abs(our_g - ref_g).max() <= 1e-4
    np.testing.assert_array_equal(
        TFD._scale_up_matrix(torch.from_numpy(M)).numpy(), np.asarray(JFD._scale_up_matrix(jnp.asarray(M))))


def test_approx_median_matches():
    """Tolerance: exact (the bisection compares counts, no rounding)."""
    x = np.abs(np.random.default_rng(4).normal(0, 2, (7, 2040))).astype(np.float32)
    np.testing.assert_array_equal(TFD._approx_median(torch.from_numpy(x)).numpy(),
                                  np.asarray(JFD._approx_median(jnp.asarray(x))))


def test_homography_prewarp_not_ported(level_inputs):
    """The homography pre-warp fit, once unported, against JAX on a level's
    residual flow: fit and guarded fit <= 1e-4 (float32 normal equations
    summed in another order)."""
    I, J, M = level_inputs
    flow, conf = JFD._residual_flow(jnp.asarray(I), jnp.asarray(J), 2, 8)
    flow, conf = np.array(flow), np.array(conf)
    ref = np.asarray(JFD._fit_homography_dense(jnp.asarray(flow), jnp.asarray(conf), 4))
    ours = TFD._fit_homography_dense(torch.from_numpy(flow), torch.from_numpy(conf), 4).numpy()
    assert np.abs(ours - ref).max() <= 1e-4
    ref_g = np.asarray(JFD._guarded_fit(jnp.asarray(flow), jnp.asarray(conf), jnp.asarray(M), "homography"))
    our_g = TFD._guarded_fit(torch.from_numpy(flow), torch.from_numpy(conf), torch.from_numpy(M),
                             "homography").numpy()
    assert np.abs(our_g - ref_g).max() <= 1e-4


@pytest.mark.parametrize("h,w,out_h,out_w", [(18, 24, 36, 48), (12, 16, 25, 33), (5, 7, 11, 14), (9, 12, 19, 24)])
def test_upsample2_flow_matches(h, w, out_h, out_w):
    f = np.random.default_rng(h * w).normal(size=(3, h, w, 2)).astype(np.float32)
    ref = np.asarray(JFD._upsample2_flow(jnp.asarray(f), out_h, out_w))
    ours = TFD._upsample2_flow(torch.from_numpy(f), out_h, out_w).numpy()
    assert ours.shape == ref.shape == (3, out_h, out_w, 2)
    assert np.abs(ours - ref).max() <= 4e-6


@pytest.fixture(scope="module")
def dense():
    """Both packages' dense ``dis_flow`` on a (4, 75, 99) shaken clip."""
    base = _scene(115, 139, 3) * 255.0
    rng = np.random.default_rng(4)
    frames = []
    for _ in range(4):
        m = cv2.getRotationMatrix2D((69.5, 57.5), np.degrees(rng.uniform(-0.01, 0.01)), 1.0)
        m[:, 2] += rng.uniform(-3, 3, 2)
        frames.append(cv2.warpAffine(base, m, (139, 115), flags=cv2.INTER_LINEAR)[20:95, 20:119])
    grays = np.stack(frames).astype(np.float32)
    ref = tuple(np.asarray(a) for a in JFD.dis_flow(grays))
    ours = tuple(t.numpy() for t in TFD.dis_flow(torch.from_numpy(grays)))
    return ref, ours


def test_dense_dis_flow_matches(dense):
    (rf, rc), (of, oc) = dense
    assert of.shape == rf.shape == (3, 75, 99, 2)
    assert oc.shape == rc.shape == (3, 37, 49)       # the polish level's confidence
    d = np.abs(of - rf)
    assert np.median(d) <= 1e-5 and d.max() <= 1e-3
    assert np.abs(oc - rc).max() <= 1e-4


def test_dense_dis_flow_short_clip():
    flow, conf = TFD.dis_flow(torch.zeros((1, 20, 30)))
    assert tuple(flow.shape) == (0, 20, 30, 2) and tuple(conf.shape) == (0, 20, 30)
