"""TV-L1 tier of the port (ops/tvl1.py) against the JAX package, on CPU.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances, and why:

- ``_warp_by_field``: exact.  The port gathers the two taps that the
  reference's masked shift-adds weight, and forms the same products and
  sums (the other taps add exact zeros), so XLA has nothing to contract.
- ``_forward_grad`` / ``_divergence``: exact (single subtractions and
  adds).
- one ``_tvl1_level`` warp of 1-5 inner steps: <= 5e-6 px.  XLA's CPU
  backend contracts the data term's multiply-adds into FMAs; the port
  rounds each op, so the fields drift by ulps per step.
- the whole ``tvl1_flow`` solve: a distribution bound, median |dflow|
  <= 1e-4 px and p99 <= 0.25 px.  Over 480 inner steps a level, a
  one-ulp difference flips a thresholding branch or the floor of a
  warp's displacement, and flat or border pixels, where the data term
  barely constrains the flow, then wander apart (a few px at single
  pixels).  Confidence: median <= 1e-4.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import cv2  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from comfyui_video_stabilizer_tpu.ops import tvl1 as JTV  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import tvl1 as TTV  # noqa: E402


def _scene(h, w, seed):
    rng = np.random.default_rng(seed)
    img = rng.random((h, w), np.float32)
    img = cv2.GaussianBlur(img, (0, 0), 2.5)
    img += 0.3 * cv2.GaussianBlur(rng.random((h, w), np.float32), (0, 0), 8.0)
    return (img - img.min()) / (img.max() - img.min())


def _shaken(n, h, w, seed):
    """(n, h, w) grays 0..255: a scene rotated and shifted a little per frame."""
    base = _scene(h + 40, w + 40, seed) * 255.0
    rng = np.random.default_rng(seed + 1)
    out = []
    for _ in range(n):
        m = cv2.getRotationMatrix2D(((w + 40) / 2, (h + 40) / 2), np.degrees(rng.uniform(-0.01, 0.01)), 1.0)
        m[:, 2] += rng.uniform(-3, 3, 2)
        out.append(cv2.warpAffine(base, m, (w + 40, h + 40), flags=cv2.INTER_LINEAR)[20:20 + h, 20:20 + w])
    return np.stack(out).astype(np.float32)


@pytest.fixture(scope="module")
def solves():
    """Both packages' whole solve on (3, 50, 66): three levels, upsampled
    12x16 -> 25x33 -> 50x66 (odd, then even sizes)."""
    grays = _shaken(3, 50, 66, 0)
    ref = tuple(np.asarray(a) for a in JTV.tvl1_flow(grays))
    ours = tuple(t.numpy() for t in TTV.tvl1_flow(torch.from_numpy(grays)))
    return ref, ours


def test_warp_by_field_matches_at_a_discontinuity():
    """Two motions meeting at x = 16: exact against JAX, with per-pixel
    jitter and a flow past the +-7 px clip too.  Without the jitter the
    sampler is a 2-D bilinear sample away from the boundary (<= 1e-3
    grey levels) and not in the band left of it, where x + dx crosses
    into the other motion and dy is read there."""
    rng = np.random.default_rng(0)
    img = (rng.random((2, 24, 32)) * 255).astype(np.float32)
    flow = np.zeros((2, 24, 32, 2), np.float32)
    flow[:, :, :16] = [2.3, -1.7]
    flow[:, :, 16:] = [-3.6, 4.2]
    jitter = flow + rng.normal(0, 0.3, flow.shape).astype(np.float32)
    jitter[0, 0, 0] = [9.5, -12.0]
    outs = {}
    for name, f in (("clean", flow), ("jitter", jitter)):
        ref = np.asarray(JTV._warp_by_field(jnp.asarray(img), jnp.asarray(f)))
        outs[name] = TTV._warp_by_field(torch.from_numpy(img), torch.from_numpy(f)).numpy()
        np.testing.assert_array_equal(outs[name], ref)

    ys, xs = np.meshgrid(np.arange(24), np.arange(32), indexing="ij")
    sx, sy = np.clip(xs + flow[..., 0], 0, 31), np.clip(ys + flow[..., 1], 0, 23)
    x0, y0 = np.floor(sx).astype(int), np.floor(sy).astype(int)
    x1, y1 = np.minimum(x0 + 1, 31), np.minimum(y0 + 1, 23)
    ax, ay = sx - x0, sy - y0
    bil = np.stack([(1 - ay[b]) * ((1 - ax[b]) * img[b][y0[b], x0[b]] + ax[b] * img[b][y0[b], x1[b]])
                    + ay[b] * ((1 - ax[b]) * img[b][y1[b], x0[b]] + ax[b] * img[b][y1[b], x1[b]])
                    for b in range(2)])
    d = np.abs(outs["clean"] - bil)
    assert d[:, 8:16, 2:12].max() <= 1e-3 and d[:, 8:16, 20:28].max() <= 1e-3
    assert d[:, 8:16, 13:16].max() > 1.0


def test_forward_grad_and_divergence_match():
    rng = np.random.default_rng(1)
    u, v = (rng.normal(size=(2, 24, 32)).astype(np.float32) for _ in range(2))
    for r, o in zip(JTV._forward_grad(jnp.asarray(u)), TTV._forward_grad(torch.from_numpy(u))):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    np.testing.assert_array_equal(
        TTV._divergence(torch.from_numpy(u), torch.from_numpy(v)).numpy(),
        np.asarray(JTV._divergence(jnp.asarray(u), jnp.asarray(v))))


@pytest.mark.parametrize("n_inner", [1, 2, 3, 4, 5])
def test_tvl1_level_steps_match(n_inner):
    """One linearization (n_warps=1) from a non-zero field: <= 5e-6 px."""
    rng = np.random.default_rng(2)
    I = (rng.random((1, 24, 32)) * 255).astype(np.float32)
    J = np.roll(I, 1, axis=2) + rng.normal(0, 2, I.shape).astype(np.float32)
    r0 = rng.normal(0, 0.5, (1, 24, 32, 2)).astype(np.float32)
    ref = np.asarray(JTV._tvl1_level(jnp.asarray(I), jnp.asarray(J), jnp.asarray(r0),
                                     n_warps=1, n_inner=n_inner))
    ours = TTV._tvl1_level(torch.from_numpy(I), torch.from_numpy(J), torch.from_numpy(r0),
                           n_warps=1, n_inner=n_inner).numpy()
    assert np.abs(ours - ref).max() <= 5e-6


def test_tvl1_flow_matches_jax(solves):
    (rf, rc), (of, oc) = solves
    assert of.shape == rf.shape == (2, 50, 66, 2) and oc.shape == rc.shape == (2, 50, 66)
    d = np.abs(of - rf)
    assert np.median(d) <= 1e-4, np.median(d)
    assert np.quantile(d, 0.99) <= 0.25, np.quantile(d, 0.99)
    assert np.median(np.abs(oc - rc)) <= 1e-4
    assert np.isfinite(of).all() and np.isfinite(oc).all()


def test_constants_equal_jax():
    """Tolerance: exact (copied)."""
    for name in ("LAMBDA", "THETA", "TAU", "N_WARPS", "N_INNER", "RADIUS"):
        assert getattr(TTV, name) == getattr(JTV, name), name


def test_tvl1_recovers_global_translation():
    """The gate of tests/test_tvl1.py on the port alone: a scene moved by
    (2.3, -1.6) px; interior median error < 0.25 px, p90 < 0.6 px."""
    h, w, pad = 64, 96, 16
    base = _scene(h + 2 * pad, w + 2 * pad, 3) * 255.0
    tx, ty = 2.3, -1.6
    m = np.array([[1.0, 0.0, tx], [0.0, 1.0, ty]])
    J = cv2.warpAffine(base, m, (w + 2 * pad, h + 2 * pad), flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP)
    grays = np.stack([base[pad:pad + h, pad:pad + w], J[pad:pad + h, pad:pad + w]]).astype(np.float32)
    flow, conf = TTV.tvl1_flow(torch.from_numpy(grays))
    inner = flow.numpy()[0, 12:-12, 12:-12]
    err = np.sqrt((inner[..., 0] + tx) ** 2 + (inner[..., 1] + ty) ** 2)
    assert np.median(err) < 0.25, float(np.median(err))
    assert np.quantile(err, 0.9) < 0.6, float(np.quantile(err, 0.9))
    assert conf.shape == (1, h, w)


def test_tvl1_flow_short_clip():
    """Fewer than two frames: empty flow and confidence of the input's size."""
    flow, conf = TTV.tvl1_flow(torch.zeros((1, 20, 30)))
    assert tuple(flow.shape) == (0, 20, 30, 2) and tuple(conf.shape) == (0, 20, 30)
