"""K10 (the DLT refit's smallest eigenvector) and K11 (the 8x8 solves) of
the port (ops/linalg_cuda.py) against the JAX package, and the
perspective estimation they let the fast path's CUDA graphs hold.

On the CPU every wrapper takes its plain twin.  Inputs are made from a
numpy seed.  Tolerances:

- the twins against JAX: the smallest eigenvector of normalized-DLT
  normal matrices (8 to 8,160 noisy correspondences) and of symmetric
  matrices with a set spectrum (smallest eigenvalue 1e-2, the others in
  [1, 100]) equal to ``jnp.linalg.eigh``'s up to sign within 1e-4
  (measured 2.7e-6 at 8 points, 3.5e-6 in the cyclic order: both
  are float32 solvers, Jacobi against LAPACK); K11's solutions against ``jnp.linalg.solve``, each entry
  over its column's largest, within 2e-3 on 4-point systems of
  well-spread quads in pixel coordinates (measured 6.4e-4; JAX's own
  float32 solve is 7.2e-4 from float64's there: the unnormalized
  systems are ill-conditioned) and 1e-4 on ridged IRLS normal equations
  (measured 5.0e-6); both are float32 partial pivoting, in another op
  order;
- the fits through the twins against JAX at the tolerances of
  tests/test_torch_perspective.py: 4-point hypotheses and grid refits
  within 1e-2 px at the frame corners, the 5-point refit within 0.05 px
  (its normal matrix is near-singular in float32), the dense IRLS
  homography within 1e-4;
- the whole captured estimation (``fastpath._flow_estimate`` and
  ``_classic_estimate`` in perspective) runs with ``torch.linalg.eigh``,
  ``solve`` and ``solve_ex`` made to raise, and a perspective
  crop_and_pad call goes through ``_fused_estimate`` with results
  ``torch.equal`` to the eager call.

K10 rotates in the parallel (round-robin) order; its twin in that order
is held to the twin in the old cyclic order within 1e-4 too (both
float32 Jacobi, rounding differently).  K11's 4-point twin is the torch
construction of the systems followed by ``solve8_plain``, ``torch.equal``
(NaN where NaN) to that construction written out here.

The ``cuda`` cases hold K10 and both K11 entries ``torch.equal`` to their
twins on the card at the slice's shapes ((79, 9, 9) and (127, 9, 9);
40,448 and 65,024 4-point sets, repeated draws among them; (79, 8, 8)),
at 1 and at counts that leave a block part full, check that
the perspective estimation makes no host sync, and that both perspective
graphs equal the eager fast path bitwise.  They skip here; on a card:

    python -m pytest --noconftest tests/test_torch_persp_kernels.py -q -m cuda
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from comfyui_video_stabilizer_tpu.ops import flow_dis as JFD  # noqa: E402
from comfyui_video_stabilizer_tpu.ops import ransac as JRS  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.models import fastpath as FP  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import cuda_build  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import flow_dis as TFD  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import linalg_cuda as LA  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import ransac as TRS  # noqa: E402

WORK_W, WORK_H = 960, 540
CORNERS = np.array([[0.0, 0.0, 1.0], [WORK_W, 0.0, 1.0], [0.0, WORK_H, 1.0], [WORK_W, WORK_H, 1.0]])


def _homography(rng, persp=2e-5):
    th, s = rng.uniform(-0.02, 0.02), np.exp(rng.uniform(-0.01, 0.01))
    return np.array([[s * np.cos(th), -s * np.sin(th), rng.uniform(-8, 8)],
                     [s * np.sin(th), s * np.cos(th), rng.uniform(-8, 8)],
                     [rng.uniform(-persp, persp), rng.uniform(-persp, persp), 1.0]])


def _project(H, pts):
    h = np.concatenate([pts, np.ones(pts.shape[:-1] + (1,))], -1) @ np.swapaxes(H, -1, -2)
    return h[..., :2] / h[..., 2:]


def _corner_err(A, B):
    """Largest distance (px) between the images of the working frame's corners."""
    def img(H):
        w = np.einsum("nij,kj->nki", np.asarray(H, np.float64), CORNERS)
        return w[..., :2] / w[..., 2:]
    return float(np.abs(img(A) - img(B)).max())


def _correspondences(rng, b, n, noise=0.3):
    """(p, q) (b, n, 2) float32: points of the working frame and their
    images under a homography a pair, with noise."""
    p = rng.uniform(0, [WORK_W, WORK_H], (b, n, 2))
    q = np.stack([_project(_homography(rng), p[i]) for i in range(b)]) + rng.normal(0, noise, (b, n, 2))
    return p.astype(np.float32), q.astype(np.float32)


def _dlt_normals(rng, b, n, noise=0.3):
    """(b, 9, 9) float32 normalized-DLT normal matrices, as _refit_homography forms them."""
    p, q = _correspondences(rng, b, n, noise)
    out = []
    for pi, qi in zip(p.astype(np.float64), q.astype(np.float64)):
        pn = (pi - pi.mean(0)) / np.sqrt(((pi - pi.mean(0)) ** 2).sum(1).mean())
        qn = (qi - qi.mean(0)) / np.sqrt(((qi - qi.mean(0)) ** 2).sum(1).mean())
        x, y, u, v = pn[:, 0], pn[:, 1], qn[:, 0], qn[:, 1]
        z, o = np.zeros(n), np.ones(n)
        A = np.concatenate([np.stack([x, y, o, z, z, z, -x * u, -y * u, -u], -1),
                            np.stack([z, z, z, x, y, o, -x * v, -y * v, -v], -1)]).astype(np.float32)
        out.append(A.T @ A)
    return np.stack(out).astype(np.float32)


def _spectrum(rng, b):
    """(b, 9, 9) float32 symmetric matrices: smallest eigenvalue 1e-2, the others in [1, 100]."""
    out = []
    for _ in range(b):
        Q, _ = np.linalg.qr(rng.normal(size=(9, 9)))
        lam = np.concatenate([[1e-2], np.sort(rng.uniform(1.0, 100.0, 8))])
        m = (Q * lam) @ Q.T
        out.append((m + m.T) / 2)
    return np.stack(out).astype(np.float32)


def _quad_systems(rng, n):
    """(A + 1e-12 I, b) of n 4-point systems on well-spread quads: one
    point in each quadrant of the working frame."""
    cells = np.array([[0, 0], [1, 0], [0, 1], [1, 1]]) * [WORK_W / 2, WORK_H / 2]
    p = (cells + rng.uniform(40, [WORK_W / 2 - 40, WORK_H / 2 - 40], (n, 4, 2))).astype(np.float32)
    q = np.stack([_project(_homography(rng), p[i]) for i in range(n)]).astype(np.float32)
    return p, q


def _irls_systems(rng, b):
    """(AtA + 1e-6 I, Atb) of the IRLS pre-warp fit on normalized grids."""
    ys, xs = np.mgrid[-1:1:24j, -1:1:40j]
    pn = np.stack([xs.ravel(), ys.ravel()], 1)
    out_a, out_b = [], []
    for _ in range(b):
        H = _homography(rng, 2e-3)
        H[:2, 2] /= 200.0
        qn = _project(H, pn) + rng.normal(0, 1e-3, pn.shape)
        w = rng.uniform(0.1, 1.0, len(pn))
        x, y, u, v = pn[:, 0], pn[:, 1], qn[:, 0], qn[:, 1]
        z, o = np.zeros_like(x), np.ones_like(x)
        A = np.concatenate([np.stack([x, y, o, z, z, z, -x * u, -y * u], -1),
                            np.stack([z, z, z, x, y, o, -x * v, -y * v], -1)])
        ww = np.concatenate([w, w])
        out_a.append((A * ww[:, None]).T @ A + 1e-6 * np.eye(8))
        out_b.append((A * ww[:, None]).T @ np.concatenate([u, v]))
    return np.stack(out_a).astype(np.float32), np.stack(out_b).astype(np.float32)


# ---------------------------------------------------------------------------
# the twins against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["dlt 8", "dlt 400", "dlt 8160", "spectrum"])
def test_eigvec_plain_matches_jax_eigh(case):
    rng = np.random.default_rng(len(case))
    mats = _spectrum(rng, 24) if case == "spectrum" else _dlt_normals(rng, 12, int(case.split()[1]))
    ours = LA.smallest_eigvec(torch.from_numpy(mats)).numpy()
    ref = np.asarray(jnp.linalg.eigh(jnp.asarray(mats))[1][..., 0])
    sign = np.sign((ours * ref).sum(1, keepdims=True))
    assert np.abs(ours * sign - ref).max() <= 1e-4
    np.testing.assert_allclose(np.linalg.norm(ours, axis=1), 1.0, rtol=0, atol=1e-6)


def test_eigvec_plain_reads_the_upper_triangle_and_takes_the_first_tie():
    """The twin reads the upper triangle, as K10 does; the identity (the
    refit's stand-in for a non-finite normal matrix) gives e0."""
    rng = np.random.default_rng(3)
    mats = torch.from_numpy(_dlt_normals(rng, 4, 40))
    lower_junk = mats + torch.tril(torch.full((9, 9), 7.0), -1)
    assert torch.equal(LA.smallest_eigvec_plain(lower_junk), LA.smallest_eigvec_plain(mats))
    e0 = LA.smallest_eigvec_plain(torch.eye(9)[None])
    assert torch.equal(e0, torch.eye(9)[:1])


CYCLIC_PAIRS = tuple((p, q) for p in range(9) for q in range(p + 1, 9))


@pytest.mark.parametrize("case", ["dlt 8", "dlt 400", "dlt 8160", "spectrum"])
def test_eigvec_plain_matches_cyclic_order(case):
    """The parallel order's twin against the cyclic order's (K10's first order),
    up to sign, within 1e-4: the same Jacobi in another order."""
    rng = np.random.default_rng(len(case) + 40)
    mats = torch.from_numpy(_spectrum(rng, 24) if case == "spectrum" else _dlt_normals(rng, 12, int(case.split()[1])))
    ours = LA.smallest_eigvec_plain(mats).numpy()
    cyclic = LA.smallest_eigvec_plain(mats, pairs=CYCLIC_PAIRS).numpy()
    sign = np.sign((ours * cyclic).sum(1, keepdims=True))
    assert np.abs(ours * sign - cyclic).max() <= 1e-4


def test_jacobi_rounds_visit_every_pair_once():
    """Nine rounds of four disjoint pairs, index r left out of round r,
    every pair (p < q) once a sweep; the plain version's order is the
    rounds' in turn."""
    assert len(LA.ROUNDS) == 9 and all(len(r) == 4 for r in LA.ROUNDS)
    for r, rnd in enumerate(LA.ROUNDS):
        idx = [i for pair in rnd for i in pair]
        assert len(set(idx)) == 8 and r not in idx
        assert all(p < q for p, q in rnd)
    assert sorted(LA.PAIRS) == list(CYCLIC_PAIRS)
    assert LA.PAIRS == tuple(pair for rnd in LA.ROUNDS for pair in rnd)


@pytest.mark.parametrize("case", ["identity", "diagonal ties", "block ties"])
def test_eigvec_plain_identity_and_ties(case):
    """Nothing rotates on the identity (the refit's stand-in for a
    non-finite normal matrix) or on a diagonal matrix: e0, or the first
    of the tied smallest entries; a matrix whose two smallest eigenvalues
    tie after rotating gives a unit vector of that eigenspace."""
    if case == "identity":
        mats, first = torch.eye(9)[None], 0
    elif case == "diagonal ties":
        mats, first = torch.diag(torch.tensor([5.0, 2.0, 3.0, 2.0, 9.0, 2.0, 4.0, 6.0, 7.0]))[None], 1
    else:
        Q, _ = np.linalg.qr(np.random.default_rng(11).normal(size=(9, 9)))
        lam = np.array([1.0, 1.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0, 9.0])
        m = (Q * lam) @ Q.T
        mats, first = torch.from_numpy(((m + m.T) / 2).astype(np.float32))[None], None
    counts = {}
    vec = LA.smallest_eigvec_plain(mats, counts)
    if first is None:
        low = Q[:, :2]                                   # the tied eigenspace
        resid = vec[0].numpy() - low @ (low.T @ vec[0].numpy())
        assert np.abs(resid).max() <= 1e-4 and counts["rotations"] > 0
    else:
        assert counts == {"tests": 36, "rotations": 0}
        assert torch.equal(vec, torch.eye(9)[first:first + 1])
    np.testing.assert_allclose(np.linalg.norm(vec.numpy(), axis=1), 1.0, rtol=0, atol=1e-6)


def _four_point_construction(ps, qs):
    """The 4-point systems as ``ransac._solve_homography_4pt`` built them
    in torch before K11 had a 4-point entry, solved by ``solve8_plain``:
    (..., 3, 3)."""
    x, y, u, v = ps[..., 0], ps[..., 1], qs[..., 0], qs[..., 1]
    z, o = torch.zeros_like(x), torch.ones_like(x)
    A = torch.cat([torch.stack([x, y, o, z, z, z, -x * u, -y * u], -1),
                   torch.stack([z, z, z, x, y, o, -x * v, -y * v], -1)], -2)
    A = A + 1e-12 * torch.eye(8, dtype=A.dtype, device=A.device)
    b = torch.cat([u, v], -1)
    h = LA.solve8_plain(A.reshape(-1, 8, 8), b.reshape(-1, 8)).reshape(b.shape)
    return torch.cat([h, torch.ones_like(h[..., :1])], -1).reshape(*h.shape[:-1], 3, 3)


def _draws(rng, pairs, n_hyp, n_pts=60, zeros=True):
    """(ps, qs) (pairs, n_hyp, 4, 2) float32: 4-point draws with replacement
    from n_pts correspondences a pair (repeated points among them); with
    ``zeros``, some coordinates +0 or -0 (so -x * u is a signed zero)."""
    p, q = _correspondences(rng, pairs, n_pts)
    if zeros:
        p[:, :6, 0] = np.array([0.0, -0.0, 0.0, -0.0, 0.0, -0.0], np.float32)
        q[:, 3:9, 1] = np.array([-0.0, 0.0, -0.0, 0.0, -0.0, 0.0], np.float32)
        q[:, 5:8, 0] = -0.0
    idx = rng.integers(0, n_pts, (pairs, n_hyp, 4))
    return (np.take_along_axis(p[:, None], idx[..., None], 2), np.take_along_axis(q[:, None], idx[..., None], 2))


def _same(a, b) -> bool:
    """torch.equal, NaN where NaN."""
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(nan_a, nan_b)) and bool(torch.equal(a[~nan_a], b[~nan_b]))


@pytest.mark.parametrize("pairs,n_hyp", [(3, 512), (1, 1), (2, 77)])
def test_homography_4pt_plain_equals_the_construction(pairs, n_hyp):
    """K11's 4-point twin (and ``ransac._solve_homography_4pt`` on the CPU)
    against the construction written out, torch.equal, NaN where NaN, on
    draws with repeated points and signed zeros."""
    ps, qs = (torch.from_numpy(t) for t in _draws(np.random.default_rng(pairs * 1000 + n_hyp), pairs, n_hyp))
    ref = _four_point_construction(ps, qs)
    out = LA.homography_4pt_plain(ps, qs)
    assert out.shape == (pairs, n_hyp, 3, 3)
    assert _same(out, ref) and _same(TRS._solve_homography_4pt(ps, qs), ref)
    if n_hyp == 512:
        assert not bool(torch.isfinite(ref).all()), "no repeated draw came out non-finite"
    with pytest.raises(cuda_build.KernelArgumentError):
        LA.solve_homography_4pt(ps[..., :3, :], qs[..., :3, :])


@pytest.mark.parametrize("case", ["quads", "irls"])
def test_solve8_plain_matches_jax_solve(case):
    rng = np.random.default_rng(7 if case == "quads" else 8)
    if case == "quads":
        p, q = _quad_systems(rng, 512)
        x, y, u, v = p[..., 0], p[..., 1], q[..., 0], q[..., 1]
        z, o = np.zeros_like(x), np.ones_like(x)
        A = np.concatenate([np.stack([x, y, o, z, z, z, -x * u, -y * u], -1),
                            np.stack([z, z, z, x, y, o, -x * v, -y * v], -1)], 1)
        A = (A + np.float32(1e-12) * np.eye(8, dtype=np.float32)).astype(np.float32)
        b = np.concatenate([u, v], 1)
    else:
        A, b = _irls_systems(rng, 79)
    ours = LA.solve8(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    ref = np.asarray(jnp.linalg.solve(jnp.asarray(A), jnp.asarray(b)[..., None])[..., 0])
    scaled = np.abs(ours - ref) / np.abs(ref).max(axis=0)
    assert scaled.max() <= (2e-3 if case == "quads" else 1e-4)


def test_solve8_singular_and_shapes():
    """An exactly singular system gives non-finite entries (as solve_ex
    without checks did); leading axes pass through; a wrong shape is
    refused on any device."""
    A = torch.eye(8).repeat(3, 2, 1, 1)
    A[1, 0, :, 5] = 0.0                                   # a zero column: a zero pivot
    b = torch.ones((3, 2, 8))
    x = LA.solve8(A, b)
    assert x.shape == (3, 2, 8)
    assert torch.equal(x[0], torch.ones((2, 8))) and not bool(torch.isfinite(x[1, 0]).all())
    with pytest.raises(cuda_build.KernelArgumentError):
        LA.solve8(torch.eye(8)[None], torch.ones((1, 7)))


# ---------------------------------------------------------------------------
# the fits through the twins against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [101, 102, 103])
def test_four_point_hypotheses_match_jax(seed):
    rng = np.random.default_rng(seed)
    p, q = _quad_systems(rng, 64)
    ref = np.stack([np.asarray(JRS._solve_homography_4pt(jnp.asarray(a), jnp.asarray(b))) for a, b in zip(p, q)])
    ours = TRS._solve_homography_4pt(torch.from_numpy(p), torch.from_numpy(q)).numpy()
    assert _corner_err(ours, ref) <= 1e-2


@pytest.mark.parametrize("n,tol", [(5, 0.05), (60, 1e-2), (2000, 1e-2)])
def test_refit_homography_matches_jax(n, tol):
    rng = np.random.default_rng(n)
    p, q = _correspondences(rng, 4, n)
    w = (rng.random((4, n)) < 0.9).astype(np.float32)
    w[:, :5] = 1.0
    ref = np.stack([np.asarray(JRS._refit_homography(jnp.asarray(p[i]), jnp.asarray(q[i]), jnp.asarray(w[i])))
                    for i in range(4)])
    ours = TRS._refit_homography(torch.from_numpy(p), torch.from_numpy(q), torch.from_numpy(w)).numpy()
    assert np.isfinite(ours).all()
    assert _corner_err(ours, ref) <= tol


@pytest.mark.parametrize("seed", [5, 6])
def test_dense_homography_fit_matches_jax(seed):
    rng = np.random.default_rng(seed)
    h, w = 40, 72
    ys, xs = np.mgrid[0:h, 0:w]
    pts = np.stack([xs.ravel(), ys.ravel()], 1).astype(np.float64)
    flow = np.stack([(_project(_homography(rng, 1e-3), pts) - pts).reshape(h, w, 2) for _ in range(3)])
    flow = (flow + rng.normal(0, 0.05, flow.shape)).astype(np.float32)
    conf = rng.uniform(0.2, 1.0, (3, h, w)).astype(np.float32)
    ref = np.asarray(JFD._fit_homography_dense(jnp.asarray(flow), jnp.asarray(conf), 4))
    ours = TFD._fit_homography_dense(torch.from_numpy(flow), torch.from_numpy(conf), 4).numpy()
    assert np.abs(ours - ref).max() <= 1e-4


# ---------------------------------------------------------------------------
# the captured estimation needs no library solver
# ---------------------------------------------------------------------------

def _shaken_grays(n=8, h=144, w=256, seed=4):
    """(n, h, w) float32 grays of a textured plane under a shaken
    homography a frame, 0..255 levels."""
    rng = np.random.default_rng(seed)
    base = torch.nn.functional.avg_pool2d(torch.from_numpy(rng.random((1, 1, h + 64, w + 64))).float(),
                                          5, 1, 2)[0, 0].numpy()
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    out = []
    H = np.eye(3)
    for _ in range(n):
        sx, sy = H[0, 0] * xs + H[0, 1] * ys + H[0, 2] + 32, H[1, 0] * xs + H[1, 1] * ys + H[1, 2] + 32
        d = H[2, 0] * xs + H[2, 1] * ys + 1.0
        out.append(base[np.clip(np.rint(sy / d), 0, h + 63).astype(int), np.clip(np.rint(sx / d), 0, w + 63).astype(int)])
        step = _homography(rng, 3e-5)
        step[:2, 2] = rng.uniform(-3, 3, 2)
        H = step @ H
    return torch.from_numpy(np.floor(np.stack(out) * 255.0).astype(np.float32))


def _estimate_kw(kind, grays):
    n, h, w = grays.shape
    kw = dict(seed=0, mode="perspective", camera_lock=False, window=9, width=w, height=h, scale_xy=(1.0, 1.0))
    if kind == "flow":
        kw["decimation"] = 1
    return kw


@pytest.fixture()
def no_library_solvers(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("a library solver was called")

    for name in ("eigh", "solve", "solve_ex", "eig", "lu_factor", "lu_factor_ex"):
        monkeypatch.setattr(torch.linalg, name, refuse)


@pytest.mark.parametrize("kind", ["flow", "classic"])
def test_perspective_estimation_runs_without_library_solvers(no_library_solvers, kind):
    """The program each graph captures, in perspective, carried by the
    twins: finite coefficients, and perspective chosen for some pairs."""
    grays = _shaken_grays()
    program = FP._PROGRAMS[kind]
    out = program(grays, torch.tensor(0.8), torch.tensor(0.6), **_estimate_kw(kind, grays))
    assert bool(torch.isfinite(out["coeffs"]).all())
    assert int((out["chosen"] == 0).sum()) > 0, out["chosen"]


def test_fused_enabled_admits_perspective(monkeypatch):
    """The route takes the graph for crop_and_pad on one CUDA device
    whatever the transform mode (it has no mode argument), and still
    refuses it under a progress observer (Flow's DIS chunks from their
    graph, Classic eager), for other framings, on the CPU and with
    CVST_FUSED=0."""
    card = types.SimpleNamespace(device=torch.device("cuda", 0))
    plan = ((256, 64), None, 4)  # integer pool factors, as Flow's whole graph needs
    observed = {"flow": "chunks", "classic": "eager"}
    monkeypatch.delenv("CVST_FUSED", raising=False)
    for kind in ("flow", "classic"):
        assert FP._route(kind, card, "crop_and_pad", None, *plan) == "graph"
        assert FP._route(kind, card, "crop_and_pad", lambda i: None, *plan) == observed[kind]
        assert FP._route(kind, card, "expand", None, *plan) == "eager"
        assert FP._route(kind, torch.zeros(1), "crop_and_pad", None, *plan) == "eager"
    assert FP._route("flow", card, "crop_and_pad", None, (1200, 500), (960, 400), 1) == "eager"
    assert FP._route("classic", card, "crop_and_pad", None, (1200, 500), (960, 400), 1) == "graph"
    monkeypatch.setenv("CVST_FUSED", "0")
    for kind in ("flow", "classic"):
        assert FP._route(kind, card, "crop_and_pad", None, *plan) == "eager"
        assert FP._route(kind, card, "crop_and_pad", lambda i: None, *plan) == "eager"


@pytest.mark.parametrize("kind", ["flow", "classic"])
def test_perspective_crop_and_pad_goes_through_the_graph_entry(no_library_solvers, monkeypatch, kind):
    """With the gate opened on the CPU, a perspective crop_and_pad call
    reaches ``_fused_estimate`` (here running the captured program
    eagerly) and returns what the eager fast path returns, bitwise."""
    from comfyui_video_stabilizer_tpu_torch.models.classic import stabilize_classic
    from comfyui_video_stabilizer_tpu_torch.models.flow import stabilize_flow
    from comfyui_video_stabilizer_tpu_torch.utils.video_io import normalize_video_input

    monkeypatch.setenv("CVST_FASTPATH", "1")
    monkeypatch.setenv("CVST_FASTPATH_STRICT", "1")
    g = _shaken_grays(n=6, h=144, w=192, seed=9) / 255.0
    frames = torch.stack([g, g * 0.7 + 0.1, 1.0 - g], dim=-1).contiguous()
    run = stabilize_flow if kind == "flow" else stabilize_classic
    args = ("crop_and_pad", "perspective", False, 0.8, 0.6, 0.6, (127, 127, 127), 24.0)
    eager = run(normalize_video_input(frames, device="cpu"), *args, device="cpu")
    seen = []

    def fused(kind_, grays, strength, keep_fov, kw):
        seen.append((kind_, kw["mode"]))
        return FP._PROGRAMS[kind_](grays, FP._scalar(strength, grays.device), FP._scalar(keep_fov, grays.device),
                                   **kw)

    monkeypatch.setattr(FP, "_fused_estimate", fused)
    route, card = FP._route, types.SimpleNamespace(device=torch.device("cuda", 0))
    monkeypatch.setattr(FP, "_route", lambda kind_, frames, *a: route(kind_, card, *a))
    graph = run(normalize_video_input(frames, device="cpu"), *args, device="cpu")
    assert seen == [(kind, "perspective")]
    assert torch.equal(graph.frames, eager.frames) and torch.equal(graph.masks, eager.masks)
    assert graph.meta == eager.meta
    assert "perspective" in [t["mode"] for t in graph.meta["estimated_motion"]["per_transition"]]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [79, 127])
def test_k10_equals_plain(cuda, b):
    rng = np.random.default_rng(b)
    mats = np.concatenate([_dlt_normals(rng, b - 12, 400), _dlt_normals(rng, 8, 8), _spectrum(rng, 3),
                           np.eye(9, dtype=np.float32)[None]])
    m = torch.from_numpy(mats).to(cuda)
    cuda_build.reset_launches()
    out = LA.smallest_eigvec(m)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["smallest_eigvec"] == 1
    assert torch.equal(out, LA.smallest_eigvec_plain(m))


@pytest.mark.cuda
@pytest.mark.parametrize("pairs", [79, 127])
def test_k11_equals_plain_on_hypotheses(cuda, pairs):
    """The pairs' 512 4-point sets each (40,448 and 65,024), drawn with
    replacement from 60 points, so repeated draws (singular but for the
    ridge) are among them: the 4-point entry (one launch) against its
    twin, and the general entry on the systems built from them."""
    ps, qs = (torch.from_numpy(t).to(cuda) for t in _draws(np.random.default_rng(pairs), pairs,
                                                           TRS.DEFAULT_HYPOTHESES))
    cuda_build.reset_launches()
    hyps = TRS._solve_homography_4pt(ps, qs)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["homography_4pt"] == 1 and cuda_build.LAUNCHES["solve8"] == 0
    assert hyps.shape == (pairs, TRS.DEFAULT_HYPOTHESES, 3, 3)
    assert _same(hyps, LA.homography_4pt_plain(ps, qs))
    assert not bool(torch.isfinite(hyps).all()), "no repeated draw came out non-finite"
    x, y, u, v = ps[..., 0], ps[..., 1], qs[..., 0], qs[..., 1]
    z, o = torch.zeros_like(x), torch.ones_like(x)
    A = torch.cat([torch.stack([x, y, o, z, z, z, -x * u, -y * u], -1),
                   torch.stack([z, z, z, x, y, o, -x * v, -y * v], -1)], -2) + 1e-12 * torch.eye(8, device=cuda)
    b = torch.cat([u, v], -1)
    assert _same(LA.solve8(A, b), LA.solve8_plain(A.reshape(-1, 8, 8), b.reshape(-1, 8)).reshape(b.shape))


@pytest.mark.cuda
def test_k11_equals_plain_on_irls_systems(cuda):
    A, b = (torch.from_numpy(t).to(cuda) for t in _irls_systems(np.random.default_rng(2), 79))
    assert torch.equal(LA.solve8(A, b), LA.solve8_plain(A, b))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 127, 129, 1000])
def test_k11_entries_equal_plain_at_partial_blocks(cuda, n):
    """Both entries where the last block of 128 is part full (n = 1 a
    single system), and on inputs that are not 16-byte aligned (the
    wrappers copy them)."""
    ps, qs = (torch.from_numpy(t.reshape(n, 4, 2)).to(cuda) for t in _draws(np.random.default_rng(n), 1, n))
    assert _same(LA.solve_homography_4pt(ps, qs), LA.homography_4pt_plain(ps, qs))
    A, b = (torch.from_numpy(t).to(cuda) for t in _irls_systems(np.random.default_rng(n), min(n, 8)))
    A, b = A.repeat((n + 7) // 8, 1, 1)[:n].contiguous(), b.repeat((n + 7) // 8, 1)[:n].contiguous()
    assert torch.equal(LA.solve8(A, b), LA.solve8_plain(A, b))
    flat_p = torch.cat([torch.zeros(1, device=cuda), ps.reshape(-1)])[1:].reshape(n, 4, 2)
    assert flat_p.data_ptr() % 16 != 0
    assert _same(LA.solve_homography_4pt(flat_p, qs), LA.homography_4pt_plain(ps, qs))
    flat_a = torch.cat([torch.zeros(1, device=cuda), A.reshape(-1)])[1:].reshape(n, 8, 8)
    assert torch.equal(LA.solve8(flat_a, b), LA.solve8_plain(A, b))


@pytest.mark.cuda
def test_k10_k11_refuse_bad_arguments(cuda):
    with pytest.raises(cuda_build.KernelTypeError):
        LA.smallest_eigvec(torch.eye(9, dtype=torch.float64, device=cuda)[None])
    with pytest.raises(cuda_build.KernelArgumentError):
        LA.smallest_eigvec(torch.eye(8, device=cuda)[None])
    with pytest.raises(cuda_build.KernelTypeError):
        LA.solve8(torch.eye(8, dtype=torch.float64, device=cuda)[None], torch.ones((1, 8), dtype=torch.float64,
                                                                                   device=cuda))
    pts = torch.zeros((5, 4, 2), device=cuda)
    with pytest.raises(cuda_build.KernelTypeError):
        LA.solve_homography_4pt(pts.double(), pts.double())
    with pytest.raises(cuda_build.KernelArgumentError):
        LA.solve_homography_4pt(pts[:, :3], pts[:, :3])
    with pytest.raises(cuda_build.KernelArgumentError):
        LA.solve_homography_4pt(pts, pts[:4])
    with pytest.raises(cuda_build.KernelArgumentError):
        LA.solve_homography_4pt(pts[:0], pts[:0])
    with pytest.raises(cuda_build.KernelArgumentError):
        LA.solve_homography_4pt(pts, pts.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["flow", "classic"])
def test_perspective_estimation_makes_no_host_sync(cuda, kind):
    """The captured program in perspective, run eagerly on the card under
    ``torch.cuda.set_sync_debug_mode("error")`` after one warm run: no
    operation synchronizes with the host."""
    grays = _shaken_grays().to(cuda)
    kw = _estimate_kw(kind, grays)
    strength = torch.full((), 0.8, device=cuda)
    keep_fov = torch.full((), 0.6, device=cuda)
    FP._PROGRAMS[kind](grays, strength, keep_fov, **kw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = FP._PROGRAMS[kind](grays, strength, keep_fov, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(torch.isfinite(out["coeffs"]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["flow", "classic"])
def test_perspective_graph_equals_eager(cuda, monkeypatch, kind):
    """Perspective crop_and_pad from its CUDA graph (captured once, then
    replayed) against CVST_FUSED=0: frames, masks and meta bitwise, the
    same launches, K10 twice, K11's 4-point entry once and its general
    entry three times a DIS level fit (Flow; never for Classic)."""
    from comfyui_video_stabilizer_tpu_torch.models.classic import stabilize_classic
    from comfyui_video_stabilizer_tpu_torch.models.flow import stabilize_flow
    from comfyui_video_stabilizer_tpu_torch.utils.video_io import normalize_video_input

    monkeypatch.setenv("CVST_FASTPATH_STRICT", "1")
    g = _shaken_grays(n=8, h=144, w=192, seed=12).to(cuda) / 255.0
    frames = torch.stack([g, g * 0.7 + 0.1, 1.0 - g], dim=-1).contiguous()
    run = stabilize_flow if kind == "flow" else stabilize_classic
    args = ("crop_and_pad", "perspective", False, 0.8, 0.6, 0.6, (127, 127, 127), 24.0)
    FP.clear_graph_cache()
    stats = dict(FP.GRAPH_STATS)
    run(normalize_video_input(frames, device=cuda), *args, device=cuda)
    assert FP.GRAPH_STATS["captures"] == stats["captures"] + 1
    cuda_build.reset_launches()
    graph = run(normalize_video_input(frames, device=cuda), *args, device=cuda)
    torch.cuda.synchronize()
    launches = dict(cuda_build.LAUNCHES)
    assert FP.GRAPH_STATS["captures"] == stats["captures"] + 1
    assert FP.GRAPH_STATS["replays"] == stats["replays"] + 2
    assert launches["smallest_eigvec"] == 2 and launches["homography_4pt"] == 1, launches
    assert launches["solve8"] % 3 == 0 and (launches["solve8"] > 0) == (kind == "flow"), launches
    monkeypatch.setenv("CVST_FUSED", "0")
    cuda_build.reset_launches()
    eager = run(normalize_video_input(frames, device=cuda), *args, device=cuda)
    torch.cuda.synchronize()
    assert dict(cuda_build.LAUNCHES) == launches
    assert FP.GRAPH_STATS["replays"] == stats["replays"] + 2
    assert torch.equal(graph.frames, eager.frames) and torch.equal(graph.masks, eager.masks)
    assert graph.meta == eager.meta
    FP.clear_graph_cache()
