"""Perspective fits of the port against the JAX package.

Inputs are correspondences under a known homography with noise, gross
outliers and invalid (NaN) points, and dense flow fields of a known
homography, all made from a numpy seed; the hypothesis draws are
bitwise equal (ops/prng.py).

Tolerances: per hypothesis, ``hyp_ok`` identical on every draw of four
distinct points, and the winning index identical, also where few valid
points make draws repeat.  A repeated point makes the 8x8 system
singular but for a 1e-12 ridge: the port rejects every such draw, JAX
leaves it to its LU's rounding (NaN on most, finite on a few, which
can score as many inliers as the winner, though here none comes
first).  Inlier counts equal on >= 97 % of the hypotheses both keep (an
ill-conditioned hypothesis differs enough to move points across the
2.5 px threshold); the fitted RANSAC counts exact or off by one.
Fitted homographies agree at the four frame corners within 1e-2 px
(float32 solves and eigenvectors in another order: LAPACK through XLA
against the port's partial pivoting and Jacobi, ops/linalg_cuda.py's
plain versions on the CPU), and within 0.05 px for the DLT refit
on 5 points, whose normal matrix is near-singular in float32; the
dense homography fit within 1e-4 of JAX's; acceptance flags identical.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from comfyui_video_stabilizer_tpu.models import classic as JCL  # noqa: E402
from comfyui_video_stabilizer_tpu.models import flow as JFL  # noqa: E402
from comfyui_video_stabilizer_tpu.ops import flow_dis as JFD  # noqa: E402
from comfyui_video_stabilizer_tpu.ops import ransac as JRS  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.models import classic as TCL  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.models import flow as TFL  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import flow_dis as TFD  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import prng  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import ransac as TRS  # noqa: E402

WORK_W, WORK_H = 192, 144
CORNERS = np.array([[0.0, 0.0], [WORK_W - 1, 0.0], [0.0, WORK_H - 1], [WORK_W - 1, WORK_H - 1]])


def _homography(rng, persp=2e-4):
    th = rng.uniform(-0.01, 0.01)
    s = np.exp(rng.uniform(-0.01, 0.01))
    return np.array([[s * np.cos(th), -s * np.sin(th), rng.uniform(-4, 4)],
                     [s * np.sin(th), s * np.cos(th), rng.uniform(-4, 4)],
                     [rng.uniform(-persp, persp), rng.uniform(-persp, persp), 1.0]])


def _project(H, pts):
    h = np.c_[pts, np.ones(len(pts))] @ H.T
    return h[:, :2] / h[:, 2:]


def _corner_err(A, B):
    """Largest distance (px) between the images of the frame corners."""
    return max(np.abs(_project(np.asarray(a, np.float64), CORNERS) - _project(np.asarray(b, np.float64), CORNERS)).max()
               for a, b in zip(A, B))


def _pairs(kind, seed=11):
    """(p, q, valid) for 3 pairs: the 8-px grid of a 192x144 frame, or few points."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:WORK_H:8, 0:WORK_W:8]
    grid = np.stack([xs.ravel(), ys.ravel()], 1).astype(np.float64)
    P = grid.shape[0]
    p = np.repeat(grid[None], 3, 0)
    q = np.empty_like(p)
    valid = np.ones((3, P), bool)
    for i in range(3):
        q[i] = _project(_homography(rng), grid) + rng.normal(0, 0.3, (P, 2))
        out = rng.random(P) < 0.25 * i
        q[i, out] += rng.uniform(-25, 25, (int(out.sum()), 2))
    if kind == "grid":
        q[2, rng.random(P) < 0.1] = np.nan
        valid = np.isfinite(q).all(2)
    else:                                        # 5, 4 and 3 valid points: draws repeat
        valid[:] = False
        for i, k in enumerate((5, 4, 3)):
            valid[i, rng.choice(P, k, replace=False)] = True
    return p.astype(np.float32), q.astype(np.float32), valid


def _jax_draws(key, p, q, valid, n_hyp):
    """hyp_ok, inlier counts and the winner of one pair, step by step as
    the JAX package's ``_ransac_single`` computes them (perspective)."""
    P, m = p.shape[0], 4
    vcount = valid.sum()
    ranks = jnp.cumsum(valid) - valid.astype(jnp.int32)
    lookup = jnp.zeros((P,), jnp.int32).at[jnp.where(valid, ranks, P)].set(
        jnp.arange(P, dtype=jnp.int32), mode="drop")
    u = jax.random.uniform(key, (n_hyp, m))
    denom = jnp.maximum(vcount, 1)
    idx = lookup[jnp.minimum((u * denom).astype(jnp.int32), denom - 1)]
    draw_ok = valid[idx].all(axis=1) & (vcount >= m)
    hyps = jax.vmap(JRS._solve_homography_4pt)(p[idx], q[idx])
    hyp_ok = draw_ok & jnp.isfinite(hyps).all(axis=(1, 2))
    hyps = jnp.where(hyp_ok[:, None, None], hyps, jnp.eye(3, dtype=jnp.float32))
    n_score = min(P, 2048)
    proj = jax.vmap(lambda H: JRS._apply_homography(H, p[:n_score]))(hyps)
    err = ((proj - q[None, :n_score]) ** 2).sum(-1)
    counts = ((err < JRS.PERSP_THRESH ** 2) * valid[None, :n_score]).sum(-1) * hyp_ok
    return np.asarray(hyp_ok), np.asarray(counts), int(jnp.argmax(counts)), np.asarray(idx)


def _keys(seed, b):
    return jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(seed), i))(jnp.arange(b))


@pytest.mark.parametrize("kind", ["grid", "few"])
def test_hypotheses_and_winner_match(kind):
    p, q, valid = _pairs(kind)
    keys = _keys(0, 3)
    hyps, hyp_ok = TRS.draw_hypotheses(prng.keys_from_jax(np.asarray(keys)), torch.from_numpy(p),
                                       torch.from_numpy(q), torch.from_numpy(valid), "perspective", 128)
    counts = TRS.score_hypotheses(hyps, hyp_ok, torch.from_numpy(p), torch.from_numpy(q),
                                  torch.from_numpy(valid), TRS.PERSP_THRESH)
    repeated = 0
    for i in range(3):
        ref_ok, ref_counts, ref_best, idx = _jax_draws(keys[i], jnp.asarray(p[i]), jnp.asarray(q[i]),
                                                       jnp.asarray(valid[i]), 128)
        distinct = np.array([len(set(r)) == 4 for r in idx])
        np.testing.assert_array_equal(hyp_ok[i].numpy()[distinct], ref_ok[distinct])
        assert not hyp_ok[i].numpy()[~distinct].any()
        repeated += int((~distinct & np.asarray(valid[i])[idx].all(1)).sum())
        both = hyp_ok[i].numpy() & ref_ok
        assert not both.any() or (counts[i].numpy() == ref_counts)[both].mean() >= 0.97
        assert int(torch.argmax(counts[i])) == ref_best
    if kind == "few":
        # 5 and 4 valid points: most draws repeat a point; 3 points (< 4):
        # every draw is rejected
        assert repeated > 100
        assert 0 < int(hyp_ok[0].sum()) < 64 and not bool(hyp_ok[2].any())


@pytest.mark.parametrize("kind", ["grid", "few"])
def test_ransac_perspective_matches(kind):
    p, q, valid = _pairs(kind, seed=12)
    keys = _keys(3, 3)
    H, n_in, vc = (np.asarray(x) for x in JRS._ransac_batched(
        keys, jnp.asarray(p), jnp.asarray(q), jnp.asarray(valid), "perspective", 256, JRS.PERSP_THRESH))
    oH, on_in, ovc = TRS.ransac_fit(prng.keys_from_jax(np.asarray(keys)), torch.from_numpy(p),
                                    torch.from_numpy(q), torch.from_numpy(valid), "perspective", 256,
                                    TRS.PERSP_THRESH)
    np.testing.assert_array_equal(ovc.numpy(), vc)
    assert np.abs(on_in.numpy() - n_in).max() <= 1
    assert np.isfinite(oH.numpy()).all() == np.isfinite(H).all()
    assert _corner_err(oH.numpy(), H) <= (1e-2 if kind == "grid" else 0.05)


def test_solve_and_refit_homography_match():
    rng = np.random.default_rng(5)
    p, q, valid = _pairs("grid", seed=5)
    sel = rng.choice(p.shape[1], (3, 4), replace=False)
    ps = np.take_along_axis(p, sel[..., None], 1)
    qs = np.take_along_axis(q, sel[..., None], 1)
    ref = np.stack([np.asarray(JRS._solve_homography_4pt(jnp.asarray(a), jnp.asarray(b))) for a, b in zip(ps, qs)])
    ours = TRS._solve_homography_4pt(torch.from_numpy(ps), torch.from_numpy(qs)).numpy()
    assert _corner_err(ours, ref) <= 1e-2
    w = (valid & (rng.random(valid.shape) < 0.8)).astype(np.float32)
    ref = np.stack([np.asarray(JRS._refit_homography(jnp.asarray(np.nan_to_num(p[i])), jnp.asarray(np.nan_to_num(q[i])),
                                                     jnp.asarray(w[i]))) for i in range(3)])
    ours = TRS._refit_homography(torch.from_numpy(np.nan_to_num(p)), torch.from_numpy(np.nan_to_num(q)),
                                 torch.from_numpy(w)).numpy()
    assert _corner_err(ours, ref) <= 1e-2
    # a NaN sample poisons the normal matrix on both sides: the refit is non-finite
    nan_fit = TRS._refit_homography(torch.from_numpy(p), torch.from_numpy(q), torch.from_numpy(w))
    assert not torch.isfinite(nan_fit[2]).all()


@pytest.fixture(scope="module")
def level():
    """A (3, 34, 60) level flow of known homographies with noise, and a confidence."""
    rng = np.random.default_rng(21)
    h, w = 34, 60
    ys, xs = np.mgrid[0:h, 0:w]
    pts = np.stack([xs.ravel(), ys.ravel()], 1).astype(np.float64)
    flow = np.stack([(_project(_homography(rng, 1e-3), pts) - pts).reshape(h, w, 2) for _ in range(3)])
    flow += rng.normal(0, 0.05, flow.shape)
    conf = rng.uniform(0.2, 1.0, (3, h, w))
    M = np.stack([_homography(rng, 1e-4) for _ in range(3)])
    return flow.astype(np.float32), conf.astype(np.float32), M.astype(np.float32)


def test_dense_homography_fit_matches(level):
    flow, conf, M = level
    ref = np.asarray(JFD._fit_homography_dense(jnp.asarray(flow), jnp.asarray(conf), 4))
    ours = TFD._fit_homography_dense(torch.from_numpy(flow), torch.from_numpy(conf), 4).numpy()
    assert np.abs(ours - ref).max() <= 1e-4
    ref_g = np.asarray(JFD._guarded_fit(jnp.asarray(flow), jnp.asarray(conf), jnp.asarray(M), "homography"))
    our_g = TFD._guarded_fit(torch.from_numpy(flow), torch.from_numpy(conf), torch.from_numpy(M),
                             "homography").numpy()
    assert np.abs(our_g - ref_g).max() <= 1e-4
    # a projective term past 2 / level size keeps the previous estimate
    wild = flow.copy()
    wild[1] *= 40.0
    ref_w = np.asarray(JFD._guarded_fit(jnp.asarray(wild), jnp.asarray(conf), jnp.asarray(M), "homography"))
    our_w = TFD._guarded_fit(torch.from_numpy(wild), torch.from_numpy(conf), torch.from_numpy(M), "homography")
    np.testing.assert_array_equal(our_w.numpy()[1], ref_w[1])


def test_flow_fused_perspective_fits_match():
    p, q, valid = _pairs("grid", seed=31)
    samples = np.where(valid[..., None], q - p, np.nan).astype(np.float32)
    ref = [np.asarray(x) for x in JFL._fused_fits_sampled(jnp.asarray(samples), jnp.asarray(p[0]), 0, True, 512)]
    ours = TFL._fused_fits_sampled(torch.from_numpy(samples), torch.from_numpy(p[0]), 0, True, 512)
    vc, H, nH, vH, rH = ref[:5]
    np.testing.assert_array_equal(ours["valid_counts"], vc)
    np.testing.assert_array_equal(ours["vH"], vH)
    assert np.abs(ours["nH"].astype(np.int64) - nH).max() <= 1
    assert _corner_err(ours["H"], H) <= 1e-2
    np.testing.assert_allclose(ours["rH"], rH, rtol=0, atol=1e-2, equal_nan=True)
    conf, ref_conf = ours["nH"] / np.maximum(ours["vH"], 1), nH / np.maximum(vH, 1)
    np.testing.assert_array_equal((conf >= TFL.PERSP_MIN_RATIO) & (vc >= 4),
                                  (ref_conf >= JFL.PERSP_MIN_RATIO) & (vc >= 4))


def test_classic_fused_perspective_fits_match():
    p, q, valid = _pairs("grid", seed=41)
    status = valid.copy()
    status[0, ::3] = False
    tracked = np.nan_to_num(q).astype(np.float32)
    ref = [np.asarray(x) for x in JCL._fused_classic_fits(jnp.asarray(p), jnp.asarray(tracked), jnp.asarray(status),
                                                          0, True, 512)]
    names = ("surv", "H", "nH", "vH", "S", "nS", "vS", "T")
    ours = {k: v.numpy() for k, v in zip(names, TCL._fused_classic_fits_device(
        torch.from_numpy(p), torch.from_numpy(tracked), torch.from_numpy(status), 0, True, 512))}
    surv, H, nH, vH = ref[:4]
    np.testing.assert_array_equal(ours["surv"], surv)
    np.testing.assert_array_equal(ours["vH"], vH)
    assert np.abs(ours["nH"].astype(np.int64) - nH).max() <= 1
    assert _corner_err(ours["H"], H) <= 1e-2


def test_perspective_constants_match():
    assert TRS.PERSP_THRESH == JRS.PERSP_THRESH
    assert TFL.PERSP_MIN_RATIO == JFL.PERSP_MIN_RATIO and TCL.PERSP_MIN_RATIO == JCL.PERSP_MIN_RATIO
