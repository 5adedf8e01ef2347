"""Motion Apply and the legacy inverse engine of both packages, end to end
on the CPU.

Inputs: the smooth textured clip of tests/test_motion_apply.py (made
with numpy from a seed) and shake motion_meta from the JAX generator,
handed to both packages.  The JAX package runs its XLA path on the CPU;
the port runs its plain versions (K1's and K3's) on the CPU.

Tolerances: frames <= 2e-6 abs (a few ulps: XLA's CPU backend contracts
multiply-adds into FMAs); masks exactly equal; meta keys and every
non-float value equal, floats within 1e-12; progress tick counts equal;
error strings equal.  The inverse round trip is held to the JAX test's
bounds: p99 <= 0.3 and mean <= 0.035 on 0..1 pixels.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

from comfyui_video_stabilizer_tpu.meta import motion_meta as JMM  # noqa: E402
from comfyui_video_stabilizer_tpu.models import inverse as JINV  # noqa: E402
from comfyui_video_stabilizer_tpu.models import motion_apply as JMA  # noqa: E402
from comfyui_video_stabilizer_tpu.utils import video_io as JIO  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.models import inverse as TINV  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.models import motion_apply as TMA  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.utils import video_io as TIO  # noqa: E402
from test_motion_apply import _frames, _shake_meta  # noqa: E402
from test_torch_stabilize_flow import _non_float_items  # noqa: E402

GRAY = (127, 127, 127)


def _float_items(obj, path=""):
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from _float_items(v, f"{path}/{k}")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            yield from _float_items(v, f"{path}[{i}]")
    elif isinstance(obj, float):
        yield (path, obj)


def _assert_meta_equal(ours, ref):
    assert list(ours) == list(ref)
    assert dict(_non_float_items(ours)) == dict(_non_float_items(ref))
    a, b = dict(_float_items(ours)), dict(_float_items(ref))
    assert a.keys() == b.keys()
    assert all(abs(a[k] - b[k]) <= 1e-12 * max(1.0, abs(b[k])) for k in a)


def _both(frames, meta, padding=GRAY, **kw):
    """(JAX result, port result, JAX ticks, port ticks) of apply_motion."""
    jt, tt = [], []
    ref = JMA.apply_motion(JIO.normalize_video_input(frames), meta, padding,
                           progress_callback=lambda: jt.append(1), **kw)
    ours = TMA.apply_motion(TIO.normalize_video_input(torch.from_numpy(frames), device="cpu"), meta,
                            padding, progress_callback=lambda: tt.append(1), device="cpu", **kw)
    return ref, ours, len(jt), len(tt)


def _assert_same_result(ref, ours):
    jf, jm = np.asarray(ref.frames), np.asarray(ref.masks)
    assert ours.frames.device.type == "cpu" and ours.frames.dtype == torch.float32
    assert tuple(ours.frames.shape) == jf.shape and tuple(ours.masks.shape) == jm.shape
    assert np.abs(ours.frames.numpy() - jf).max() <= 2e-6
    np.testing.assert_array_equal(ours.masks.numpy(), jm)
    _assert_meta_equal(ours.meta, ref.meta)


@pytest.mark.parametrize("blur", [0.0, 0.5])
@pytest.mark.parametrize("interp", ["bilinear", "bicubic"])
@pytest.mark.parametrize("framing", ["crop_and_pad", "crop", "expand", "pad"])
def test_apply_motion_matches_jax(framing, interp, blur):
    frames = _frames(n=4, h=48, w=64, seed=1)
    meta = _shake_meta(4, 64, 48, style="action", seed=5, amount=3.0)
    ref, ours, jt, tt = _both(frames, meta, (200, 40, 90), framing_mode=framing, interpolation=interp,
                              motion_blur=blur, motion_blur_samples=9)
    _assert_same_result(ref, ours)
    assert tt == jt and tt == 4 * (9 if blur else 1) + (4 if framing == "crop" else 0)
    if framing == "crop":
        assert float(ours.masks.max()) == 0.0 and "framing_fallback" not in ours.meta
    if blur and framing != "crop":
        soft = ours.masks.numpy()
        assert ((soft > 0) & (soft < 1)).any()


@pytest.mark.parametrize("blur", [0.0, 0.5])
def test_crop_fallback_matches_jax(blur):
    frames = _frames(n=3, h=48, w=64, seed=2)
    mats = [np.eye(3), np.array([[1.0, 0, 64 * 3.0], [0, 1, 0], [0, 0, 1]]),
            np.array([[1.0, 0, -64 * 3.0], [0, 1, 0], [0, 0, 1]])]
    meta = {"motion_meta": JMM.build_motion_meta_v2(
        source="estimated_classic", frame_count=3, fps=16.0, input_size=(64, 48),
        output_size=(64, 48), matrices=mats)}
    ref, ours, jt, tt = _both(frames, meta, framing_mode="crop", motion_blur=blur, motion_blur_samples=9)
    assert ours.meta["framing_fallback"] == "crop_and_pad"
    assert ours.meta["motion_apply"]["framing_mode"] == "crop_and_pad"
    _assert_same_result(ref, ours)
    assert tt == jt


def test_legacy_block_selection_matches_jax():
    frames = _frames(n=3, h=60, w=80)
    mats = [np.array([[1.0, 0, -10.0], [0, 1, -5.0], [0, 0, 1]])] * 3
    warp_block = JMM.build_stabilization_warp_meta(
        source_size=(100, 70), output_size=(80, 60), framing_mode="crop_and_pad", applied_matrices=mats)
    motion_block = JMM.applied_motion_meta_from_stabilization_warp(warp_block, 24.0, "estimated_flow")
    meta = {"motion_meta": motion_block, "stabilization_warp": warp_block}
    ours = TMA.resolve_motion_for_context(meta, TIO.normalize_video_input(torch.from_numpy(frames),
                                                                         device="cpu"))
    ref = JMA.resolve_motion_for_context(meta, JIO.normalize_video_input(frames))
    assert ours.source == ref.source == "legacy_stabilization"
    assert (ours.input_size, ours.output_size, ours.fps) == (ref.input_size, ref.output_size, ref.fps)
    np.testing.assert_array_equal(ours.matrices(), ref.matrices())
    ref_res, our_res, _, _ = _both(frames, meta)
    _assert_same_result(ref_res, our_res)
    assert our_res.frames.shape[1:3] == (70, 100)


def _error(fn, *args, **kw):
    with pytest.raises(ValueError) as info:
        fn(*args, **kw)
    return str(info.value)


ERROR_CASES = {
    "size": (lambda: _shake_meta(4, 66, 48), {}),
    "frame_count": (lambda: _shake_meta(5, 64, 48), {}),
    "interpolation": (lambda: _shake_meta(4, 64, 48), {"interpolation": "nearest"}),
    "framing": (lambda: _shake_meta(4, 64, 48), {"framing_mode": "letterbox"}),
    "meta": (lambda: {"other": 1}, {}),
}


@pytest.mark.parametrize("case", sorted(ERROR_CASES))
def test_error_strings_match_jax(case):
    frames = _frames(n=4, h=48, w=64)
    make, kw = ERROR_CASES[case]
    ref = _error(JMA.apply_motion, JIO.normalize_video_input(frames), make(), GRAY, **kw)
    ours = _error(TMA.apply_motion, TIO.normalize_video_input(torch.from_numpy(frames), device="cpu"),
                  make(), GRAY, device="cpu", **kw)
    assert ours == ref


def _legacy_meta(n=5, h=96, w=128, seed=4):
    meta = _shake_meta(n, w, h, seed=seed)
    mats = JMA.expand_matrices(np.asarray([e["matrix"] for e in meta["motion_meta"]["per_frame"]], float),
                               (w, h))
    warp_block = JMM.build_stabilization_warp_meta(
        source_size=(w, h), output_size=mats[1], framing_mode="expand", applied_matrices=mats[0])
    return {"stabilization_warp": warp_block}, mats[1]


def test_inverse_engine_matches_jax():
    legacy, (ow, oh) = _legacy_meta()
    stabilized = _frames(n=5, h=oh, w=ow, seed=9)
    ref = JINV.apply_inverse_stabilization(JIO.normalize_video_input(stabilized), legacy, (30, 60, 90))
    ours = TINV.apply_inverse_stabilization(
        TIO.normalize_video_input(torch.from_numpy(stabilized), device="cpu"), legacy, (30, 60, 90),
        device="cpu")
    _assert_same_result(ref, ours)
    assert tuple(ours.frames.shape) == (5, 96, 128, 3)


INVERSE_ERRORS = {
    "not_dict": lambda m: [1],
    "missing": lambda m: {},
    "convention": lambda m: {"stabilization_warp": {**m["stabilization_warp"], "matrix_convention": "x"}},
    "size": lambda m: {"stabilization_warp": {**m["stabilization_warp"], "output_size": [10, 10]}},
    "count": lambda m: {"stabilization_warp": {**m["stabilization_warp"],
                                               "per_frame": m["stabilization_warp"]["per_frame"][:-1]}},
    "singular": lambda m: {"stabilization_warp": {**m["stabilization_warp"], "per_frame": [
        {"index": i, "applied_matrix": np.zeros((3, 3)).tolist()} for i in range(5)]}},
}


@pytest.mark.parametrize("case", sorted(INVERSE_ERRORS))
def test_inverse_error_strings_match_jax(case):
    legacy, (ow, oh) = _legacy_meta()
    meta = INVERSE_ERRORS[case](legacy)
    frames = _frames(n=5, h=oh, w=ow)
    ref = _error(JINV.apply_inverse_stabilization, JIO.normalize_video_input(frames), meta, GRAY)
    ours = _error(TINV.apply_inverse_stabilization,
                  TIO.normalize_video_input(torch.from_numpy(frames), device="cpu"), meta, GRAY, device="cpu")
    assert ours == ref


def test_inverse_roundtrip_accuracy():
    """Shake -> apply (expand) -> legacy inverse restores the originals,
    all on the port (the JAX test's thresholds)."""
    import cv2

    frames = _frames(n=6, h=120, w=160, seed=3)
    blurred = np.stack([cv2.GaussianBlur(f, (5, 5), 1.5) for f in frames])
    n, h, w = blurred.shape[:3]
    meta = _shake_meta(n, w, h, seed=12)
    ctx = TIO.normalize_video_input(torch.from_numpy(blurred), device="cpu")
    applied = TMA.apply_motion(ctx, meta, GRAY, framing_mode="expand", device="cpu")
    ow, oh = applied.meta["motion_apply"]["output_size"]
    mats = TMA.expand_matrices(np.asarray([e["matrix"] for e in meta["motion_meta"]["per_frame"]], float),
                               (w, h))[0]
    warp_block = JMM.build_stabilization_warp_meta(
        source_size=(w, h), output_size=(ow, oh), framing_mode="expand", applied_matrices=mats)
    restored = TINV.apply_inverse_stabilization(
        TIO.normalize_video_input(applied.frames, device="cpu"), {"stabilization_warp": warp_block}, GRAY,
        device="cpu")
    err = np.abs(restored.frames.numpy() - blurred)
    err_valid = err[restored.masks.numpy() < 0.5]
    assert np.percentile(err_valid, 99) <= 0.3
    assert err_valid.mean() <= 0.035
    assert "inverse_stabilization" in restored.meta


def test_cuda_request_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    frames = _frames(n=4, h=48, w=64)
    ctx = TIO.normalize_video_input(torch.from_numpy(frames), device="cpu")
    with pytest.raises(RuntimeError, match="is_available"):
        TMA.apply_motion(ctx, _shake_meta(4, 64, 48), GRAY)
    legacy, _ = _legacy_meta()
    with pytest.raises(RuntimeError, match="is_available"):
        TINV.apply_inverse_stabilization(ctx, legacy, GRAY)
