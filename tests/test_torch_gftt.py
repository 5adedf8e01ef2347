"""GFTT scoring (plain version of K4), the convolutions, the pyramid and
``gftt_batch`` against JAX.

References: the Pallas scorer ``gftt_scores`` in interpret mode (its
first test in the repo) and the XLA scorer ``_nms_candidates(
_min_eig_map(.))`` that the JAX package runs on the CPU.  Tolerances:

* NMS masks equal.  Scores within 1e-6 of the frame's maximum score of
  the interpret-mode kernel (measured 6e-8: the box sums follow its
  doubling tree exactly; XLA contracts an FMA in the eigenvalue), also
  for ``gftt_gray_plain`` (K4's plain version, from the gray) against
  the JAX package's whole Pallas route (Sobel, products, kernel), and
  within 1e-5 of the XLA scorer (measured 5.4e-7: it sums the boxes as
  prefix-sum differences).
* ``_conv2`` and ``_pyr_down`` within 1e-5 relative (XLA contracts the
  tap adds into FMAs; the finer levels are exact integers).
* ``gftt_batch`` corners and counts equal.  Near-ties could flip between
  the two scorers' summation orders and reorder the greedy; the fixture
  has none, so equality is asserted.
* Top-k ties: on small-integer images every box sum is exact in both
  packages, and the candidate order (equal scores by ascending index,
  as ``jax.lax.top_k`` returns them) is compared exactly.

The kernel is bitwise equal to the plain version on the card
(tests/test_torch_cuda_kernels.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from comfyui_video_stabilizer_tpu.ops import gftt_pallas as JGP  # noqa: E402
from comfyui_video_stabilizer_tpu.ops import lk as JLK  # noqa: E402
from comfyui_video_stabilizer_tpu.ops import resize as JR  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import gftt_cuda as TGF  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import lk as TLK  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops.pad import reflect_index  # noqa: E402
from test_classic import _shaken_clip  # noqa: E402


def _grays(b, h, w, seed=0):
    return np.floor(np.random.default_rng(seed).random((b, h, w)).astype(np.float32) * 255.0)


def _products(g):
    dx = JLK._conv2(jnp.asarray(g), JLK._SOBEL_X)
    dy = JLK._conv2(jnp.asarray(g), JLK._SOBEL_Y)
    return [np.array(p) for p in (dx * dx, dx * dy, dy * dy)]


def _port_scores(prods):
    return TGF.gftt_plain(*(torch.from_numpy(p) for p in prods)).numpy()


@pytest.mark.parametrize("shape", [(2, 67, 93), (1, 10, 12)])
def test_k4_plain_matches_pallas_interpret(shape):
    prods = _products(_grays(*shape))
    ref = np.asarray(JGP.gftt_scores(*(jnp.asarray(p) for p in prods), interpret=True))
    ours = _port_scores(prods)
    keep = np.isfinite(ref)
    assert np.array_equal(keep, np.isfinite(ours))
    for f in range(shape[0]):
        k = keep[f]
        assert np.abs(ours[f][k] - ref[f][k]).max() <= 1e-6 * ref[f][k].max()


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("shape", [(2, 67, 93), (3, 33, 140), (1, 10, 12)])
def test_k4_gray_plain_matches_pallas_route(shape, integer):
    """K4's plain version from the gray against the JAX package's Pallas
    route: its ``_conv2`` Sobel, the products, then the interpret-mode
    kernel.  The non-integer gray tests the Sobel's op order past exact
    integers; (1, 10, 12) is smaller than the composed pads, so the
    reflection wraps."""
    g = np.random.default_rng(5).random(shape).astype(np.float32) * 255.0
    if integer:
        g = np.floor(g)
    ref = np.asarray(JGP.gftt_scores(*(jnp.asarray(p) for p in _products(g)), interpret=True))
    ours = TGF.gftt_gray_plain(torch.from_numpy(g)).numpy()
    keep = np.isfinite(ref)
    assert np.array_equal(keep, np.isfinite(ours))
    for f in range(shape[0]):
        k = keep[f]
        assert np.abs(ours[f][k] - ref[f][k]).max() <= 1e-6 * ref[f][k].max()


@pytest.mark.parametrize("shape", [(2, 67, 93), (3, 33, 140), (1, 10, 12)])
def test_k4_plain_matches_xla_scorer(shape):
    g = _grays(*shape, seed=3)
    ref = np.asarray(JLK._nms_candidates(JLK._min_eig_map(jnp.asarray(g))))
    raw = _port_scores(_products(g))
    quality = raw.reshape(shape[0], -1).max(1) * np.float32(JLK.QUALITY_LEVEL)
    ours = np.where(raw > quality[:, None, None], raw, -np.inf)
    keep = np.isfinite(ref)
    assert np.array_equal(keep, np.isfinite(ours))
    for f in range(shape[0]):
        k = keep[f]
        assert np.abs(ours[f][k] - ref[f][k]).max() <= 1e-5 * ref[f][k].max()


@pytest.mark.parametrize("n,pad", [(5, 2), (12, 10), (10, 10), (3, 10), (2, 7), (1, 3)])
def test_reflect_index_matches_jnp_pad(n, pad):
    """Pads as wide as the axis reflect again, as jnp.pad does."""
    x = np.arange(n, dtype=np.float32)
    ref = np.asarray(jnp.pad(jnp.asarray(x), (pad, pad), mode="reflect"))
    np.testing.assert_array_equal(reflect_index(n, pad, pad, "cpu").numpy().astype(np.float32), ref)


@pytest.mark.parametrize("kernel", ["_SOBEL_X", "_SOBEL_Y", "_SCHARR_LK_X", "_SCHARR_LK_Y"])
@pytest.mark.parametrize("shape", [(2, 67, 93), (3, 2, 9)])
def test_conv2_matches_jax(kernel, shape):
    g = _grays(*shape, seed=1) / 7.0
    k = getattr(JLK, kernel) / (32.0 if "SCHARR" in kernel else 1.0)
    ref = np.asarray(JLK._conv2(jnp.asarray(g), k))
    ours = TLK._conv2(torch.from_numpy(g), k).numpy()
    assert np.abs(ours - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("shape", [(2, 80, 96), (1, 143, 201)])
def test_pyramid_matches_jax(shape):
    g = _grays(*shape, seed=2)
    ref = JLK.gaussian_pyramid(jnp.asarray(g))
    ours = TLK.gaussian_pyramid(torch.from_numpy(g))
    assert len(ours) == len(ref) == TLK.MAX_LEVEL + 1
    for r, o in zip(ref, ours):
        r = np.asarray(r)
        assert tuple(o.shape) == r.shape
        assert np.abs(o.numpy() - r).max() <= 1e-5 * np.abs(r).max()


def test_topk_ties_in_ascending_index_order():
    """A tiled small-integer pattern: many exactly equal scores, and the
    candidate order must still equal jax.lax.top_k's."""
    tile = np.random.default_rng(4).integers(0, 4, (8, 8)).astype(np.float32)
    g = np.tile(tile, (2, 9, 12))
    g[1] = np.roll(g[1], (3, 5), (0, 1))
    ref = np.asarray(JLK._topk_packed(jnp.asarray(g), 2048))
    ours = TLK._topk_packed(torch.from_numpy(g), 2048).numpy()
    assert (ref >= 0).sum() > 100
    np.testing.assert_array_equal(ours, ref)


@pytest.fixture(scope="module")
def textured_grays():
    frames, _ = _shaken_clip(n=5, seed=9)
    return np.array(JR.make_gray(frames))


def test_gftt_batch_matches_jax(textured_grays):
    ref_pts, ref_counts = map(np.asarray, JLK.gftt_batch(textured_grays))
    pts, counts = TLK.gftt_batch(torch.from_numpy(textured_grays))
    assert pts.dtype == torch.float32 and counts.dtype == torch.int32
    assert tuple(pts.shape) == (5, TLK.MAX_CORNERS, 2)
    assert (ref_counts >= 100).all()
    np.testing.assert_array_equal(counts.numpy(), ref_counts)
    np.testing.assert_array_equal(pts.numpy(), ref_pts)


def test_gftt_batch_respects_min_distance(textured_grays):
    pts, counts = TLK.gftt_batch(torch.from_numpy(textured_grays[:1]))
    p = pts[0, : int(counts[0])].numpy()
    d2 = ((p[:, None] - p[None]) ** 2).sum(-1) + np.eye(len(p)) * 1e9
    assert d2.min() >= TLK.MIN_DISTANCE ** 2
