"""The whole-clip sidecar steps (parallel/pipeline.py) of both packages.

Inputs, as in tests/test_parallel.py: a 16 x 32 x 64 random clip for the
translation step, and for the similarity step a 16-frame 128 x 192 clip
warped with the JAX warp from a random scene by known similarity motion
(made with numpy from a seed).  The JAX steps run jitted on the CPU
(sharded over its 8 virtual devices where the JAX test shards them), once
per module; the port's on the CPU, sharded over a mesh that repeats the
CPU device.

Tolerances:
* port sharded against port unsharded: equal arrays (the per-frame and
  per-pair work is the unsharded arithmetic on each shard; the global
  reductions run once, on the lead device);
* the translation step against JAX: the pair deltas are integers and
  equal; frames and offsets within 1e-5 (the JAX test's own bound
  between its sharded and single-device runs; float32 smoothing sums in
  another order), masks equal; the warp alone, at fixed offsets, within
  1e-6 with equal masks;
* the similarity step against JAX: pair matrices within 1e-3 (the dense
  refinement's float32 sums in another order, as the port's DIS
  against JAX's); corrections within 1e-3; frames p99 <= 1e-3 and max
  <= 1e-2 and masks unequal on <= 1e-3 of the pixels (the production
  engines' tolerances: the warp follows from the matrices).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from comfyui_video_stabilizer_tpu.ops import warp as JW  # noqa: E402
from comfyui_video_stabilizer_tpu.parallel import mesh as JM  # noqa: E402
from comfyui_video_stabilizer_tpu.parallel import pipeline as JPL  # noqa: E402
from comfyui_video_stabilizer_tpu_torch import parallel as TPAR  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.parallel import mesh as TM  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.parallel import pipeline as TPL  # noqa: E402

BORDER = (0.5, 0.5, 0.5)


def _jborder():
    return jnp.asarray(BORDER, jnp.float32)


@pytest.fixture(scope="module")
def noise_clip():
    return np.random.default_rng(0).random((16, 32, 64, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def motion_clip():
    """(frames (16, 128, 192, 3), the camera matrices) of the JAX test."""
    rng = np.random.default_rng(3)
    base = rng.random((180, 260, 3)).astype(np.float32)
    mats = []
    for i in range(16):
        ang = 0.004 * np.sin(1.1 * i)
        dx, dy = 3.0 * np.sin(0.9 * i), 2.5 * np.cos(0.7 * i)
        mats.append(np.array([[np.cos(ang), -np.sin(ang), dx], [np.sin(ang), np.cos(ang), dy], [0, 0, 1.0]]))
    view = np.stack(mats)
    frames = np.asarray(JW.warp_clip(np.repeat(base[None], 16, 0), view, (260, 180), "bilinear", BORDER))
    return np.ascontiguousarray(frames[:, 20:148, 50:242]), mats


@pytest.fixture(scope="module")
def jax_translation(noise_clip):
    warped, masks, offsets = JPL.jit_stabilize_step(jnp.asarray(noise_clip), jnp.float32(0.9), 5, _jborder())
    return np.asarray(warped), np.asarray(masks), np.asarray(offsets)


@pytest.fixture(scope="module")
def jax_similarity(motion_clip):
    frames, _ = motion_clip
    out = JPL.sharded_stabilize_similarity(frames, JM.make_mesh(8), strength=1.0, window=15)
    grays = np.einsum("nhwc,c->nhw", frames, JPL._LUMA) * 255.0
    return out, np.asarray(JPL._estimate_similarity_pairs(jnp.asarray(grays)))


@pytest.fixture(scope="module")
def port_similarity(motion_clip):
    frames, _ = motion_clip
    ref = TPL.jit_stabilize_step_similarity(torch.from_numpy(frames), 1.0, 15, BORDER)
    return tuple(t.numpy() for t in ref)


@pytest.mark.parametrize("devices", [8, 4, 3])
def test_translation_sharded_equals_unsharded(noise_clip, devices):
    warped, masks, offsets = TPAR.sharded_stabilize(noise_clip, TM.make_mesh(devices=["cpu"] * devices),
                                                    strength=0.9, window=5)
    ref = TPAR.jit_stabilize_step(torch.from_numpy(noise_clip), 0.9, 5, BORDER)
    np.testing.assert_array_equal(warped, ref[0].numpy())
    np.testing.assert_array_equal(masks, ref[1].numpy())
    np.testing.assert_array_equal(offsets, ref[2].numpy())


def test_translation_matches_jax(noise_clip, jax_translation):
    warped, masks, offsets = TPAR.sharded_stabilize(noise_clip, TM.make_mesh(devices=["cpu"] * 8),
                                                    strength=0.9, window=5)
    jw, jm, jo = jax_translation
    np.testing.assert_allclose(warped, jw, atol=1e-5)
    np.testing.assert_array_equal(masks, jm)
    np.testing.assert_allclose(offsets, jo, atol=1e-5)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_phase_correlation_deltas_match_jax(seed):
    rng = np.random.default_rng(seed)
    base = rng.random((72, 104)).astype(np.float32)
    shifts = rng.integers(-6, 7, size=(6, 2))
    grays = np.stack([np.roll(base, (int(dy), int(dx)), (0, 1))[4:68, 4:100] for dx, dy in shifts])
    ours = TPL._phase_correlate_pairs(torch.from_numpy(grays)).numpy()
    np.testing.assert_array_equal(ours, np.asarray(JPL._phase_correlate_pairs(jnp.asarray(grays))))
    np.testing.assert_array_equal(ours, (shifts[1:] - shifts[:-1]).astype(np.float32))


@pytest.mark.parametrize("shift", [(0.25, -0.5), (3.7, 2.2), (-15.5, 15.9), (17.3, -2.0), (-20.0, 18.5)])
def test_translation_warp_matches_jax(noise_clip, shift):
    """The warp's 4-tap blend, its +-16 px clamp of the integer shift and
    its mask, against the JAX step's warp at fixed offsets."""
    frames = noise_clip[:4]
    offsets = np.array([shift, (0.0, 0.0), (-shift[0], shift[1]), (shift[1], shift[0])], np.float32)
    ow, om = TPL._translation_warp(torch.from_numpy(frames), torch.from_numpy(offsets), torch.tensor(BORDER))
    jw, jm = JPL._translation_warp(jnp.asarray(frames), jnp.asarray(offsets), _jborder())
    np.testing.assert_allclose(ow.numpy(), np.asarray(jw), atol=1e-6)
    np.testing.assert_array_equal(om.numpy(), np.asarray(jm))


@pytest.mark.parametrize("window", [3, 5, 15])
def test_smoothing_matches_jax(window):
    path = np.cumsum(np.random.default_rng(window).normal(size=(12, 4)), axis=0).astype(np.float32)
    np.testing.assert_allclose(TPL._smooth(torch.from_numpy(path), window).numpy(),
                               np.asarray(JPL._smooth(jnp.asarray(path), window)), atol=1e-5)


def test_similarity_pairs_match_jax_and_recover_motion(motion_clip, jax_similarity):
    frames, mats = motion_clip
    grays = np.einsum("nhwc,c->nhw", frames, JPL._LUMA) * 255.0
    pair_m = TPL._estimate_similarity_pairs(torch.from_numpy(grays.astype(np.float32))).numpy()
    assert np.abs(pair_m - jax_similarity[1]).max() <= 1e-3
    crop = np.array([[1, 0, -50.0], [0, 1, -20.0], [0, 0, 1]])
    for k in range(15):
        true_rel = crop @ mats[k + 1] @ np.linalg.inv(mats[k]) @ np.linalg.inv(crop)
        assert abs(pair_m[k, 0, 2] - true_rel[0, 2]) < 0.6, k
        assert abs(pair_m[k, 1, 2] - true_rel[1, 2]) < 0.6, k
        assert abs(pair_m[k, 0, 0] - true_rel[0, 0]) < 0.01, k


@pytest.mark.parametrize("devices", [8, 5, 2])
def test_similarity_sharded_equals_unsharded(motion_clip, port_similarity, devices):
    frames, _ = motion_clip
    out = TPL.sharded_stabilize_similarity(frames, TM.make_mesh(devices=["cpu"] * devices), strength=1.0,
                                           window=15)
    for ours, ref in zip(out, port_similarity):
        np.testing.assert_array_equal(ours, ref)


def test_similarity_matches_jax_and_stabilizes(motion_clip, port_similarity, jax_similarity):
    frames, _ = motion_clip
    warped, masks, corr = port_similarity
    jw, jm, jc = jax_similarity[0]
    d = np.abs(warped - jw)
    assert np.quantile(d, 0.99) <= 1e-3 and d.max() <= 1e-2
    assert (masks != jm).mean() <= 1e-3
    assert np.abs(corr - jc).max() <= 1e-3
    assert np.isfinite(corr).all()
    interior = (slice(None), slice(32, 96), slice(48, 144))
    assert np.var(warped[interior], axis=0).mean() < 0.5 * np.var(frames[interior], axis=0).mean()
