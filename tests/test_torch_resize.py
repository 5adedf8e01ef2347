"""Gray and area resize of the port against the JAX package.

Tolerances: quantized gray exact (integers; the port evaluates the
luma dot as the same fused multiply-add chain XLA's CPU backend emits);
box pool <= 1e-5 abs (a float32 mean may reassociate); dense area
resize <= 1e-4 abs (two float32 matrix products over a few hundred
terms of values up to 255 may reassociate).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from comfyui_video_stabilizer_tpu.ops import resize as JR  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import resize as TR  # noqa: E402


def _frames(n=3, h=128, w=192, seed=5):
    return np.random.default_rng(seed).random((n, h, w, 3)).astype(np.float32)


@pytest.mark.parametrize("quantize", [True, False])
def test_make_gray_exact(quantize):
    f = _frames()
    ref = np.asarray(JR.make_gray(f, quantize=quantize))
    ours = TR.make_gray(torch.from_numpy(f), quantize=quantize).numpy()
    np.testing.assert_array_equal(ours, ref)


def test_box_pool_matches():
    # the estimation path pools quantized grays (integers 0..255)
    x = np.floor(np.random.default_rng(11).random((3, 108, 192)) * 256).astype(np.float32)
    ref = np.asarray(JR.area_resize(x, (96, 54)))
    ours = TR.area_resize(torch.from_numpy(x), (96, 54)).numpy()
    assert np.abs(ours - ref).max() <= 1e-5
    # non-integer input: one float32 ulp at 255 (reassociated mean)
    y = x + 0.37
    ref = np.asarray(JR.area_resize(y, (96, 54)))
    ours = TR.area_resize(torch.from_numpy(y), (96, 54)).numpy()
    assert np.abs(ours - ref).max() <= 2.0 ** -23 * 256


def test_fused_gray_pool_matches():
    f = _frames()
    ref = np.asarray(JR.gray_for_estimation(jnp.asarray(f), (96, 64)))
    ours = TR.gray_for_estimation(torch.from_numpy(f), (96, 64)).numpy()
    assert np.abs(ours - ref).max() <= 1e-5


def test_decimated_gray_matches():
    """The slice's path: working size then a further x4 pool in one pass."""
    f = _frames(n=2, h=144, w=192)
    assert TR.can_decimate(192, 144, None, 4) == JR.can_decimate(192, 144, None, 4)
    ref = np.asarray(JR.gray_for_estimation(f, None, decimation=4))
    ours = TR.gray_for_estimation(torch.from_numpy(f), None, decimation=4).numpy()
    assert ours.shape == (2, 36, 48)
    assert np.abs(ours - ref).max() <= 1e-5


def test_dense_area_resize_matches():
    x = (np.random.default_rng(3).random((2, 108, 192)) * 255).astype(np.float32)
    ref = np.asarray(JR.area_resize(x, (100, 50)))
    ours = TR.area_resize(torch.from_numpy(x), (100, 50)).numpy()
    np.testing.assert_array_equal(TR.area_weights(192, 100), JR.area_weights(192, 100))
    assert np.abs(ours - ref).max() <= 1e-4


@pytest.mark.parametrize("size,working,dec", [
    ((1920, 1080), (960, 540), 4), ((1200, 500), (960, 400), 4), ((192, 144), None, 4),
    ((190, 144), None, 4),
])
def test_can_decimate_matches(size, working, dec):
    assert TR.can_decimate(size[0], size[1], working, dec) == JR.can_decimate(size[0], size[1], working, dec)
