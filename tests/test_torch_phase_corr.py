"""Phase-correlation tier of the port (ops/phase_corr.py) against the JAX
package and cv2, on CPU.

Tolerances, and why:

- ``_phase_correlate`` on the same DC-free inputs: shifts and responses
  <= 1e-5.  PyTorch's FFT and XLA's round differently (~1e-7 of the
  spectrum); the argmax and the 5x5 centroid are the same arithmetic.
- ``phase_correlate_batch`` (DC removal included): shifts <= 2e-3 px,
  responses <= 50 / (H W).  After the mean is removed, the DC bin holds
  only its rounding residue, which the magnitude normalisation turns
  into a term of modulus 1 whose sign follows how the mean was summed
  (numpy's pairwise float32 sum in JAX, PyTorch's own here).  That moves
  every correlation value by up to 2 / (H W), each of the 25 values
  in the response.
- against cv2.phaseCorrelate on circular shifts: 0.05 px, as
  tests/test_flow.py holds the JAX package.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import cv2  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from comfyui_video_stabilizer_tpu.ops import phase_corr as JPC  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import phase_corr as TPC  # noqa: E402


def _scene(h, w, seed):
    rng = np.random.default_rng(seed)
    img = rng.random((h, w), np.float32)
    img = cv2.GaussianBlur(img, (0, 0), 2.5)
    img += 0.3 * cv2.GaussianBlur(rng.random((h, w), np.float32), (0, 0), 8.0)
    return (img - img.min()) / (img.max() - img.min())


def _pairs(n, h, w, seed):
    """n + 1 grays (0..255) of a scene shifted by sub-pixel amounts and
    rotated a little per frame."""
    base = _scene(h + 40, w + 40, seed) * 255.0
    rng = np.random.default_rng(seed + 1)
    out = []
    for _ in range(n + 1):
        m = cv2.getRotationMatrix2D(((w + 40) / 2, (h + 40) / 2), np.degrees(rng.uniform(-0.004, 0.004)), 1.0)
        m[:, 2] += rng.uniform(-4, 4, 2)
        out.append(cv2.warpAffine(base, m, (w + 40, h + 40), flags=cv2.INTER_LINEAR)[20:20 + h, 20:20 + w])
    return np.stack(out).astype(np.float32)


@pytest.mark.parametrize("shape", [(96, 128), (75, 99)])
def test_phase_correlate_kernel_matches(shape):
    g = _pairs(4, *shape, seed=5)
    p = g[:-1] - g[:-1].mean(axis=(1, 2), keepdims=True)
    c = g[1:] - g[1:].mean(axis=(1, 2), keepdims=True)
    rs, rr = (np.asarray(a) for a in JPC._phase_correlate_kernel(jnp.asarray(p), jnp.asarray(c)))
    os_, or_ = (t.numpy() for t in TPC._phase_correlate(torch.from_numpy(p), torch.from_numpy(c)))
    assert np.abs(os_ - rs).max() <= 1e-5 and np.abs(or_ - rr).max() <= 1e-5


@pytest.mark.parametrize("shape", [(96, 128), (75, 99)])
def test_phase_correlate_batch_matches(shape):
    h, w = shape
    g = _pairs(4, h, w, seed=6)
    rs, rr = JPC.phase_correlate_batch(g[:-1], g[1:])
    os_, or_ = TPC.phase_correlate_batch(torch.from_numpy(g[:-1]), torch.from_numpy(g[1:]))
    assert os_.dtype == or_.dtype == np.float64 and os_.shape == (4, 2) and or_.shape == (4,)
    assert np.abs(os_ - rs).max() <= 2e-3
    assert np.abs(or_ - rr).max() <= 50.0 / (h * w)
    # numpy inputs take the same route
    np.testing.assert_array_equal(TPC.phase_correlate_batch(g[:-1], g[1:])[0], os_)


def test_phase_correlate_sign_matches_cv2():
    """Circular shifts: exact for both, so the sign convention is isolated."""
    img = _scene(128, 160, seed=4).astype(np.float32) * 255
    for sx, sy in [(5, 3), (-7, 2)]:
        curr = np.roll(np.roll(img, sy, axis=0), sx, axis=1)
        ref_shift, _ = cv2.phaseCorrelate(img.astype(np.float64), curr.astype(np.float64))
        shifts, resp = TPC.phase_correlate_batch(torch.from_numpy(img[None]), torch.from_numpy(curr[None]))
        assert abs(shifts[0, 0] - ref_shift[0]) < 0.05, (shifts[0], ref_shift)
        assert abs(shifts[0, 1] - ref_shift[1]) < 0.05, (shifts[0], ref_shift)
        assert resp[0] > 0.5


def test_flat_and_non_finite_inputs_match():
    """Flat frames: a zero spectrum (the 1e-12 guard), all-equal
    correlation values (the first index wins) and a zero response.  A NaN
    frame: shift and response repaired to 0.  Both equal to JAX."""
    z = np.zeros((2, 16, 20), np.float32)
    nan = z.copy()
    nan[0, 3, 3] = np.nan
    for a, b in ((z, z + 7.0), (nan, z)):
        rs, rr = JPC.phase_correlate_batch(a, b)
        os_, or_ = TPC.phase_correlate_batch(torch.from_numpy(a), torch.from_numpy(b))
        np.testing.assert_array_equal(os_, rs)
        np.testing.assert_array_equal(or_, rr)
        assert not os_.any() and not or_.any()
