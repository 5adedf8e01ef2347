"""Window extraction (plain version of K6), ``_lk_prep``, one LK level
(plain version of K5) and ``lk_track`` against JAX.

Fixture: the textured shaken frames of tests/test_lk_pallas.py (one
pair for a level, two for ``lk_track``), GFTT corners from the JAX package, guesses off by up to 3 px.
Tolerances:

* Windows: exact (a copy), for interior, edge and out-of-range corners
  and wext in {13, 36, 49}, against direct numpy slicing.
* ``_lk_prep``: T, gx, gy within 1e-5 of the JAX values' scale (the
  static-slice sample and the Scharr taps follow its op order; measured
  exact); a, b, c within 1e-5 relative (sums over the 31x31 patch in
  another order); runnable and the window corners equal.
* One level against the Pallas loop in interpret mode, ``is_level0``
  both ways, and ``lk_track`` against the JAX
  ``lk_track`` (the XLA loop on the CPU): status >= 99.5 % equal and
  live tracks within 0.05 px, the JAX package's own contract for its
  two loops (tests/test_lk_pallas.py); measured 4e-5 px.

The kernels are bitwise equal to their plain versions on the card
(tests/test_torch_cuda_kernels.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from comfyui_video_stabilizer_tpu.ops import lk as JLK  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import extract_cuda as TEX  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import lk as TLK  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import lk_cuda as TLKC  # noqa: E402
from test_lk_pallas import _tracking_fixture  # noqa: E402


@pytest.mark.parametrize("wext", [13, 36, 49])
def test_extract_plain_matches_slicing(wext):
    rng = np.random.default_rng(3)
    B, H, W, F = 3, 61, 83, 17
    stack = rng.random((B, H, W)).astype(np.float32)
    corners = np.stack([rng.integers(-60, W + 60, (B, F)), rng.integers(-60, H + 60, (B, F))],
                       axis=-1).astype(np.int32)
    corners[0, 0] = (0, 0)
    corners[0, 1] = (W - 1, H - 1)
    corners[0, 2] = (-1, 5)
    corners[0, 3] = (-wext, H)
    got = TEX.extract_windows(torch.from_numpy(stack), torch.from_numpy(corners), wext).numpy()
    assert got.shape == (B, F, wext, wext)
    padded = np.pad(stack, ((0, 0), (wext, wext), (wext, wext)))
    for b in range(B):
        for f in range(F):
            cy = int(np.clip(corners[b, f, 1] + wext, 0, H + wext))
            cx = int(np.clip(corners[b, f, 0] + wext, 0, W + wext))
            np.testing.assert_array_equal(got[b, f], padded[b, cy:cy + wext, cx:cx + wext])


@pytest.fixture(scope="module")
def level_case():
    grays = _tracking_fixture(n=2)
    pts, counts = map(np.array, JLK.gftt_batch(grays[:-1]))
    valid = np.arange(pts.shape[1])[None, :] < counts[:, None]
    guess = pts + np.random.default_rng(1).uniform(-3, 3, pts.shape).astype(np.float32)
    return grays, pts, counts, valid, guess


def _jax_level(fn, case, is_level0, **kw):
    grays, pts, _, valid, guess = case
    g, s = fn(jnp.asarray(grays[:-1]), jnp.asarray(grays[1:]), jnp.asarray(pts), jnp.asarray(guess),
              jnp.asarray(valid), TLK.WIN, TLK.MAX_ITERS, TLK.EPS, is_level0, **kw)
    return np.asarray(g), np.asarray(s)


def _port_level(case, is_level0):
    grays, pts, _, valid, guess = case
    g, s = TLK.lk_level(torch.from_numpy(grays[:-1]), torch.from_numpy(grays[1:]),
                        torch.from_numpy(pts), torch.from_numpy(guess), torch.from_numpy(valid),
                        is_level0=is_level0)
    return g.numpy(), s.numpy()


def _assert_tracks_close(g, s, g_ref, s_ref, valid):
    assert (s == s_ref).mean() >= 0.995, int((s != s_ref).sum())
    live = valid & s & s_ref
    assert live.sum() > 0.5 * valid.sum()
    assert np.abs(g - g_ref)[live].max() <= 0.05


def test_lk_prep_matches_jax(level_case):
    grays, pts, _, _, guess = level_case
    ref = JLK._lk_prep(jnp.asarray(grays[:-1]), jnp.asarray(grays[1:]), jnp.asarray(pts),
                       jnp.asarray(guess), TLK.WIN)
    ours = TLK._lk_prep(torch.from_numpy(grays[:-1]), torch.from_numpy(grays[1:]),
                        torch.from_numpy(pts), torch.from_numpy(guess), TLK.WIN)
    wins_j, T, gx, gy, a, b, c, inv_det, runnable, corner = ours
    lane_major = [np.transpose(np.asarray(x), (0, 3, 1, 2)) for x in ref[:4]]
    np.testing.assert_array_equal(wins_j.numpy(), lane_major[0])
    for got, want in zip((T, gx, gy), lane_major[1:]):
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    for got, want in zip((a, b, c, inv_det), ref[4:8]):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    np.testing.assert_array_equal(runnable.numpy(), np.asarray(ref[8]))
    np.testing.assert_array_equal(corner.numpy(), np.asarray(ref[9]))
    assert runnable.numpy()[level_case[3]].mean() > 0.5


@pytest.mark.parametrize("is_level0", [False, True])
def test_level_matches_pallas_interpret(level_case, is_level0):
    g_ref, s_ref = _jax_level(JLK._lk_level_all_pallas, level_case, is_level0, interpret=True)
    g, s = _port_level(level_case, is_level0)
    _assert_tracks_close(g, s, g_ref, s_ref, level_case[3])


def test_lk_track_matches_jax():
    grays = _tracking_fixture(seed=2, n=3)
    pts, counts = map(np.array, JLK.gftt_batch(grays[:-1]))
    pyr = JLK.gaussian_pyramid(grays)
    t_ref, s_ref = map(np.asarray, JLK.lk_track([lvl[:-1] for lvl in pyr], [lvl[1:] for lvl in pyr],
                                                pts, counts))
    tpyr = TLK.gaussian_pyramid(torch.from_numpy(grays))
    t, s = TLK.lk_track([lvl[:-1] for lvl in tpyr], [lvl[1:] for lvl in tpyr],
                        torch.from_numpy(pts), torch.from_numpy(counts))
    valid = np.arange(pts.shape[1])[None, :] < counts[:, None]
    _assert_tracks_close(t.numpy(), s.numpy(), t_ref, s_ref, valid)


def test_gn_plain_keeps_guess_of_unrunnable_features():
    """A feature that is not runnable returns its guess after 0 iterations."""
    rng = np.random.default_rng(6)
    n = 4
    jw = torch.from_numpy(rng.random((n, TLK.WEXT, TLK.WEXT)).astype(np.float32))
    T, gx, gy = (torch.from_numpy(rng.random((n, TLK.WIN, TLK.WIN)).astype(np.float32)) for _ in range(3))
    scal = torch.zeros((n, TLKC.N_SCAL))
    scal[:, TLKC.COL_A] = scal[:, TLKC.COL_C] = 100.0
    scal[:, TLKC.COL_INVD] = 1e-4
    scal[:, TLKC.COL_RUN] = torch.tensor([1.0, 0.0, 1.0, 0.0])
    scal[:, TLKC.COL_GUESS_X] = scal[:, TLKC.COL_GUESS_Y] = 24.25
    g, count = TLKC.lk_gn_iterate(jw, T, gx, gy, scal, TLK.MAX_ITERS, TLK.EPS)
    assert count.tolist()[1::2] == [0, 0] and min(count.tolist()[0::2]) >= 1
    assert torch.equal(g[1::2], torch.full((2, 2), 24.25))
    assert int(count.max()) <= TLK.MAX_ITERS
