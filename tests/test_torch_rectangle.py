"""The largest all-ones rectangle of the port (``ops/morphology.py``:
``largest_axis_aligned_rectangle``, native, and its numpy body
``largest_axis_aligned_rectangle_plain``) against both versions of the
JAX package's: its native ``native/rectangle.py`` and the numpy body
its ``ops/morphology.py`` falls back to.

Tolerance: exact tuples.  Every version walks the same histogram stack
in the same order, so ties between rectangles of equal area resolve the
same way.  Masks: the seeds of tests/test_native.py, masks from a seed
at several densities and shapes, and all-zero, all-one, one-row and
one-column masks.
"""

import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

from comfyui_video_stabilizer_tpu.native import rectangle as JNR  # noqa: E402
from comfyui_video_stabilizer_tpu.ops import morphology as JM  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import morphology as TM  # noqa: E402


def _masks():
    out = {f"native_seed{s}": np.random.default_rng(s).random((48, 64)) > 0.25 for s in range(4)}
    out["morphology_seed7"] = np.random.default_rng(7).random((40, 56)) > 0.2
    for s, (shape, dens) in enumerate((((33, 17), 0.1), ((17, 33), 0.5), ((64, 64), 0.05), ((9, 120), 0.3))):
        out[f"random{s}"] = np.random.default_rng(100 + s).random(shape) > dens
    out["all_zero"] = np.zeros((12, 20), bool)
    out["all_one"] = np.ones((12, 20), bool)
    out["one_row"] = np.random.default_rng(8).random((1, 40)) > 0.3
    out["one_column"] = np.random.default_rng(9).random((40, 1)) > 0.3
    out["uint8_levels"] = (np.random.default_rng(10).random((30, 30)) * 3).astype(np.uint8)
    return out


MASKS = _masks()


def _jax_numpy_body(mask, monkeypatch):
    """The JAX function with its native half refusing: its numpy body."""
    def refuse(_mask):
        raise OSError("native half refused")

    with monkeypatch.context() as m:
        m.setattr(JNR, "largest_axis_aligned_rectangle", refuse)
        return JM.largest_axis_aligned_rectangle(mask)


@pytest.mark.parametrize("name", sorted(MASKS))
def test_rectangle_equals_both_jax_versions(name, monkeypatch):
    mask = MASKS[name]
    ref_native = JNR.largest_axis_aligned_rectangle(mask)
    ref_numpy = _jax_numpy_body(mask, monkeypatch)
    assert ref_native == ref_numpy
    ours = TM.largest_axis_aligned_rectangle(mask)
    assert ours == ref_native and all(type(v) is int for v in ours)
    assert TM.largest_axis_aligned_rectangle_plain(mask) == ref_numpy
    x0, y0, w, h = ours
    if mask.any():
        assert (mask[y0:y0 + h, x0:x0 + w] > 0).all()
    else:
        assert ours == (0, 0, mask.shape[1], mask.shape[0])


def test_rectangle_build_failure_raises(monkeypatch, tmp_path):
    """No quiet fallback: a native build that fails raises."""
    from comfyui_video_stabilizer_tpu_torch.native import rectangle as TNR

    TNR._load.cache_clear()
    monkeypatch.setattr(TNR, "library_path", lambda: tmp_path / "librectangle_missing.so")
    monkeypatch.setattr(TNR, "GXX_FLAGS", ("--no-such-flag",))
    try:
        with pytest.raises((subprocess.CalledProcessError, FileNotFoundError)):
            TM.largest_axis_aligned_rectangle(MASKS["all_one"])
    finally:
        TNR._load.cache_clear()
