"""The port's ingest normalization and integer pool against the JAX
package's, on the CPU (the same calls on the card are the ``cuda`` test
``test_normalize_on_cuda_equals_cpu`` and chip_smoke.py's normalize
phase).

Tolerance: torch.equal.  The 0..255 -> 0..1 scaling is a float32 true
division by 255 in both packages (numpy there; a division by a 0-dim
device tensor here, since the card multiplies by the reciprocal when
the divisor is a Python number), over all 256 uint8 levels and a
0..255 float clip; float 0..1 input passes through unchanged.  The
integer pool is XLA's mean, the sum times the float32 reciprocal of
the factor, which differs from a true division for factors that are
not powers of two (x3 here).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from comfyui_video_stabilizer_tpu.ops import resize as JR  # noqa: E402
from comfyui_video_stabilizer_tpu.utils import video_io as JV  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import resize as TR  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.utils import video_io as TV  # noqa: E402


def _levels_clip():
    """Three 16x16 frames holding every uint8 level in each channel."""
    rng = np.random.default_rng(4)
    levels = np.arange(256, dtype=np.uint8).reshape(16, 16)
    return np.stack([np.stack([rng.permutation(levels.ravel()).reshape(16, 16) for _ in range(3)], -1)
                     for _ in range(3)])


@pytest.mark.parametrize("origin", ["numpy", "torch"])
def test_uint8_levels_equal_jax(origin):
    clip = _levels_clip()
    ref, value_range = JV._scale_to_unit(clip, np.uint8)
    ctx = TV.normalize_video_input(clip if origin == "numpy" else torch.from_numpy(clip), device="cpu")
    assert torch.equal(ctx.frames, torch.from_numpy(ref))
    assert ctx.adapter.value_range == value_range == "0_255"
    # the multiply by the reciprocal that the card makes of a division by 255.0
    moved = (torch.from_numpy(clip).to(torch.float32) * np.float32(1 / 255) != ctx.frames)
    assert int(moved[0, ..., 0].sum()) == 126


def test_float_0_255_clip_equals_jax():
    """Frames scaled per frame: a 0..255 frame first, then a 0..1 one."""
    clip = _levels_clip().astype(np.float32)
    clip[1] /= 300.0
    ref, value_range = JV._scale_to_unit(clip, np.float32)
    ctx = TV.normalize_video_input(torch.from_numpy(clip), device="cpu")
    assert torch.equal(ctx.frames, torch.from_numpy(ref))
    assert ctx.adapter.value_range == value_range == "0_255"


def test_float_0_1_clip_unchanged():
    clip = np.random.default_rng(2).random((4, 24, 40, 3)).astype(np.float32)
    ctx = TV.normalize_video_input(torch.from_numpy(clip), device="cpu")
    assert torch.equal(ctx.frames, torch.from_numpy(clip))
    assert ctx.adapter.value_range == "0_1"
    np.testing.assert_array_equal(JV.normalize_video_input(clip).frames, clip)


@pytest.mark.parametrize("factor", [2, 3, 4])
def test_integer_pool_equals_xla_mean(factor):
    x = np.floor(np.random.default_rng(factor).random((3, 20 * factor, 30 * factor)) * 256).astype(np.float32)
    ref = np.asarray(JR._box_pool_kernel(jnp.asarray(x), factor, factor))
    ours = TR.box_pool(torch.from_numpy(x), factor, factor)
    assert torch.equal(ours, torch.from_numpy(np.array(ref)))


def test_uint8_grays_equal_jax_at_factor_3():
    """A uint8 clip through normalization, the luma chain and the x3 pool."""
    clip = np.random.default_rng(9).integers(0, 256, (3, 60, 96, 3), dtype=np.uint8)
    jctx = JV.normalize_video_input(clip)
    ref = np.asarray(JR.gray_for_estimation(jnp.asarray(jctx.frames), (32, 20)))
    ctx = TV.normalize_video_input(torch.from_numpy(clip), device="cpu")
    ours = TR.gray_for_estimation(ctx.frames, (32, 20))
    assert torch.equal(ours, torch.from_numpy(np.array(ref)))
