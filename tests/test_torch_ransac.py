"""Similarity RANSAC, median shift and residuals of the port against JAX.

Inputs are fit-grid samples at the 1080p working size (P = 8160, so
hypotheses are scored on the first 2048 points) with noise, gross
outliers and invalid (NaN) points, made from a seed with numpy.  The
hypothesis draws are bitwise equal (ops/prng.py).

Tolerances: valid counts exact; inlier counts exact or off by one per
pair (a point within an ulp of the 2 px threshold); matrices <= 1e-4
(float32 refit sums in another order); residuals <= 1e-4 px; median
shifts exact (selection, no arithmetic besides one mean of two).
Residuals are NaN on both sides for pairs with invalid samples.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from comfyui_video_stabilizer_tpu.models import flow as JFL  # noqa: E402
from comfyui_video_stabilizer_tpu.ops import ransac as JRS  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.models import flow as TFL  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import prng  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import ransac as TRS  # noqa: E402


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(17)
    pts = np.array(JFL._grid_points(540, 960, 8))
    b, P = 4, pts.shape[0]
    samples = np.empty((b, P, 2), np.float32)
    for i in range(b):
        th, s = rng.uniform(-0.01, 0.01), np.exp(rng.uniform(-0.005, 0.005))
        t = rng.uniform(-6, 6, 2)
        A = s * np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        q = pts @ A.T + t + rng.normal(0, 0.4, (P, 2))
        out = rng.random(P) < 0.2 * i             # up to 60 % gross outliers
        q[out] += rng.uniform(-30, 30, (int(out.sum()), 2))
        samples[i] = (q - pts).astype(np.float32)
        bad = rng.random(P) < 0.1 * i               # invalid samples
        samples[i, bad] = np.nan
    ref = [np.asarray(x) for x in JFL._fused_fits_sampled(jnp.asarray(samples), jnp.asarray(pts), 0, False, 512)]
    ours = TFL._fused_fits_sampled(torch.from_numpy(samples), torch.from_numpy(pts), 0, False, 512)
    return samples, pts, ref, ours


def test_valid_counts_exact(case):
    _, _, ref, ours = case
    np.testing.assert_array_equal(ours["valid_counts"], ref[0])
    np.testing.assert_array_equal(ours["vS"], ref[3])


def test_similarity_fits_match(case):
    _, _, ref, ours = case
    S, n_in, _, rS = ref[1:5]
    assert np.abs(ours["nS"].astype(np.int64) - n_in).max() <= 1
    assert np.abs(ours["S"] - S).max() <= 1e-4
    # an invalid (NaN) sample makes the residual NaN on both sides:
    # err * 0 keeps the NaN in the reference's masked mean
    np.testing.assert_allclose(ours["rS"], rS, rtol=0, atol=1e-4, equal_nan=True)


def test_translation_fits_match(case):
    _, _, ref, ours = case
    T, rT = ref[5:7]
    np.testing.assert_array_equal(ours["T"], T)
    np.testing.assert_allclose(ours["rT"], rT, rtol=0, atol=1e-4, equal_nan=True)


def test_ransac_core_matches_batched_vmap(case):
    """The pair x hypothesis batching against the JAX vmap, same keys."""
    samples, pts, _, _ = case
    prev = np.broadcast_to(pts[None], samples.shape).astype(np.float32)
    curr = prev + samples
    valid = np.isfinite(curr).all(axis=2)
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(5), i))(jnp.arange(samples.shape[0]))
    H, n_in, vc = (np.asarray(x) for x in JRS._ransac_batched(
        keys, jnp.asarray(prev), jnp.asarray(curr), jnp.asarray(valid), "similarity", 128, 2.0))
    oH, on_in, ovc = TRS.ransac_fit(prng.keys_from_jax(np.asarray(keys)), torch.from_numpy(prev),
                                    torch.from_numpy(curr), torch.from_numpy(valid), "similarity", 128, 2.0)
    np.testing.assert_array_equal(ovc.numpy(), vc)
    assert np.abs(on_in.numpy() - n_in).max() <= 1
    assert np.abs(oH.numpy() - H).max() <= 1e-4


def test_masked_median_shift_exact(case):
    samples, pts, _, _ = case
    prev = np.broadcast_to(pts[None], samples.shape).astype(np.float32)
    curr = prev + samples
    valid = np.isfinite(curr).all(axis=2)
    valid[0, :] = False                       # no valid point -> zero shift
    valid[1, 1::2] = False                    # even and odd counts
    ref = np.asarray(JRS._masked_median_shift(jnp.asarray(prev), jnp.asarray(curr), jnp.asarray(valid)))
    ours = TRS.masked_median_shift(torch.from_numpy(prev), torch.from_numpy(curr), torch.from_numpy(valid))
    np.testing.assert_array_equal(ours.numpy(), ref)
