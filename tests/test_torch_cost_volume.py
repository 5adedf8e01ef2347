"""Cost volume + sub-pixel argmin (plain version of K2) against JAX.

References: ``cost_volume_subpixel_xla`` and the Pallas kernel in
interpret mode (bitwise equal to each other).  Tolerances: cmin <= 1e-6
relative; fx, fy within 2e-6 px of the reference on >= 99.9 % of the
pixels.  Not bitwise: XLA's CPU backend contracts some of the squared
difference adds into FMAs, so costs differ by an ulp, which moves the
parabola offsets by ~1e-7 and can flip an exact argmin tie.  The kernel
is bitwise equal to the plain version on the card
(tests/test_torch_cuda_kernels.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from comfyui_video_stabilizer_tpu.ops import cv_pallas as JCV  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import cv_cuda as TCV  # noqa: E402


def _pair(b, h, w, seed=5):
    rng = np.random.default_rng(seed)
    img = (rng.random((b, h, w)) * 255).astype(np.float32)
    moved = np.roll(img, (1, -2), axis=(1, 2)) + rng.normal(0, 3, (b, h, w)).astype(np.float32)
    return img, moved


def _assert_close(ours, ref):
    fx, fy, cmin = (t.numpy() for t in ours)
    rfx, rfy, rcmin = (np.asarray(t) for t in ref)
    assert np.abs(cmin - rcmin).max() <= 1e-6 * np.abs(rcmin).max()
    for a, r in ((fx, rfx), (fy, rfy)):
        assert (np.abs(a - r) <= 2e-6).mean() >= 0.999


@pytest.mark.parametrize("radius", [2, 3])
@pytest.mark.parametrize("shape", [(3, 18, 24), (2, 37, 53)])
def test_plain_matches_xla_mirror(radius, shape):
    img, moved = _pair(*shape)
    ours = TCV.cost_volume_plain(torch.from_numpy(img), torch.from_numpy(moved), radius, 8)
    ref = JCV.cost_volume_subpixel_xla(jnp.asarray(img), jnp.asarray(moved), radius, 8)
    _assert_close(ours, ref)


@pytest.mark.parametrize("radius,shape", [(2, (3, 18, 24)), (3, (2, 37, 53))])
def test_plain_matches_pallas_interpret(radius, shape):
    img, moved = _pair(*shape, seed=7)
    ours = TCV.cost_volume_subpixel(torch.from_numpy(img), torch.from_numpy(moved), radius, 8)
    ref = JCV.cost_volume_subpixel(jnp.asarray(img), jnp.asarray(moved), radius, 8, interpret=True)
    _assert_close(ours, ref)


def test_tree_and_edge_pad_match():
    """The shift-add box sum and the edge pad are exact ports."""
    x = np.random.default_rng(2).random((2, 21, 30)).astype(np.float32)
    pad = TCV.edge_pad(torch.from_numpy(x), 4, 3, 5, 2).numpy()
    np.testing.assert_array_equal(pad, np.pad(x, ((0, 0), (4, 3), (5, 2)), mode="edge"))
    np.testing.assert_array_equal(TCV.tree(torch.from_numpy(x), 8).numpy(), np.asarray(JCV._tree(jnp.asarray(x), 8)))


def test_identical_inputs_pick_the_zero_shift():
    """cmin is exactly 0 at shift (0, 0); only the parabola's sub-pixel
    offset (|.| <= 0.5, from the asymmetric neighbour costs) remains."""
    img, _ = _pair(2, 20, 28)
    fx, fy, cmin = TCV.cost_volume_plain(torch.from_numpy(img), torch.from_numpy(img), 2, 8)
    assert float(cmin.abs().max()) == 0.0
    assert float(fx.abs().max()) <= 0.5 and float(fy.abs().max()) <= 0.5
