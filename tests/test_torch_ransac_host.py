"""The port's host entry points of the fits (``ops/ransac.py``:
``fit_model_batch``, ``median_translation_batch``,
``reprojection_residuals``) against the JAX package's, on the cases of
tests/test_ransac.py (100 valid of 400 slots, 30 % outliers, similarity
and perspective, sparse and compacted), a batch mixing them with an
all-invalid pair, and the empty batch.  The port runs on the CPU here
(``device="cpu"``); the same calls run on the card in chip_smoke.py.

Tolerances: valid and inlier counts exact, with JAX's dtypes; pair i's
key is ``fold_in(PRNGKey(seed), i)``, bitwise; matrices within
tests/test_ransac.py's 1.0 px at the 960x540 frame's corners and centre
(the refits sum in another order and the 4-point solves are another
float32 solver: ops/linalg_cuda.py's partial pivoting against LAPACK),
and within 1e-3 elementwise; median translations exact
(selection and one mean of two); residuals <= 1e-4 px.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_ransac import _make_pair  # noqa: E402

from comfyui_video_stabilizer_tpu.ops import ransac as JRS  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import prng  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import ransac as TRS  # noqa: E402

CORNERS = np.array([[0, 0], [960, 0], [0, 540], [960, 540], [480, 270]], np.float64)


def _project(M, pts):
    h = np.concatenate([pts, np.ones((len(pts), 1))], axis=1) @ np.asarray(M, np.float64).T
    return h[:, :2] / h[:, 2:3]


def _batch(model, layout):
    """(B, P, 2) points and (B, P) validity for one case of tests/test_ransac.py."""
    if layout == "mixed":
        pairs = [_make_pair(model, 100, 400, 0.3, seed=s)[:3] for s in range(3)]
        p, q, valid = (np.stack(x) for x in zip(*pairs))
        valid[1] = False                                   # an all-invalid pair among valid ones
        return p, q, valid
    p, q, valid, _ = _make_pair(model, 100, 400, 0.3)
    if layout == "compacted":
        sel = np.where(valid)[0]
        p, q, valid = p[sel], q[sel], np.ones(len(sel), bool)
    return p[None], q[None], valid[None]


def _assert_matrices_close(ours, ref):
    assert ours.dtype == ref.dtype == np.float32 and ours.shape == ref.shape
    for a, b in zip(ours, ref):
        assert np.abs(_project(a, CORNERS) - _project(b, CORNERS)).max() < 1.0
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-3)


@pytest.mark.parametrize("layout", ["sparse", "compacted", "mixed"])
@pytest.mark.parametrize("model", ["similarity", "perspective"])
def test_fit_model_batch_matches_jax(model, layout):
    p, q, valid = _batch(model, layout)
    ref = JRS.fit_model_batch(p, q, valid, model, seed=3)
    ours = TRS.fit_model_batch(p, q, valid, model, seed=3, device="cpu")
    _assert_matrices_close(ours[0], np.asarray(ref[0]))
    for a, b in zip(ours[1:], ref[1:]):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)
    if layout == "mixed":
        assert int(ours[2][1]) == 0 and np.isfinite(ours[0]).all()


def test_fit_model_batch_keys_fold_the_pair_index(monkeypatch):
    """Pair i draws with fold_in(PRNGKey(seed), i), bitwise JAX's keys."""
    seen = []
    real = TRS.ransac_fit
    monkeypatch.setattr(TRS, "ransac_fit", lambda keys, *a: seen.append(keys) or real(keys, *a))
    p, q, valid = _batch("similarity", "mixed")
    TRS.fit_model_batch(p, q, valid, "similarity", seed=5, n_hypotheses=64, device="cpu")
    ref = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(5), i))(jnp.arange(3))
    np.testing.assert_array_equal(prng.keys_to_jax(seen[0]), np.asarray(ref))


@pytest.mark.parametrize("layout", ["sparse", "compacted", "mixed"])
def test_median_translation_batch_matches_jax(layout):
    p, q, valid = _batch("similarity", layout)
    ref = JRS.median_translation_batch(p, q, valid)
    ours = TRS.median_translation_batch(p, q, valid, device="cpu")
    assert ours.dtype == ref.dtype and ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("layout", ["sparse", "compacted", "mixed"])
def test_reprojection_residuals_match_jax(layout):
    p, q, valid = _batch("similarity", layout)
    mats = JRS.fit_model_batch(p, q, valid, "similarity")[0]
    ref = JRS.reprojection_residuals(mats, p, q, valid)
    ours = TRS.reprojection_residuals(mats, p, q, valid, device="cpu")
    assert ours.dtype == ref.dtype == np.float64 and ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4)
    if layout == "mixed":
        assert ours[1] == 0.0


def test_empty_batch_shapes_and_dtypes_match_jax():
    p = np.zeros((0, 16, 2), np.float32)
    valid = np.zeros((0, 16), bool)
    mats = np.zeros((0, 3, 3), np.float32)
    pairs = [(JRS.fit_model_batch(p, p, valid, "similarity"), TRS.fit_model_batch(p, p, valid, "similarity")),
             ((JRS.median_translation_batch(p, p, valid),), (TRS.median_translation_batch(p, p, valid),)),
             ((JRS.reprojection_residuals(mats, p, p, valid),), (TRS.reprojection_residuals(mats, p, p, valid),))]
    for ref, ours in pairs:
        for a, b in zip(ours, ref):
            assert a.shape == b.shape and a.dtype == b.dtype


def test_host_calls_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p, q, valid = _batch("similarity", "compacted")
    for call in (lambda: TRS.fit_model_batch(p, q, valid, "similarity"),
                 lambda: TRS.median_translation_batch(p, q, valid),
                 lambda: TRS.reprojection_residuals(np.eye(3, dtype=np.float32)[None], p, q, valid)):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            call()
