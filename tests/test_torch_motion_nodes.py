"""The Motion Apply, Inverse and two Shake Generator nodes of both
packages, and the Inverse -> Motion Apply replacement.

Schemas and ``REPLACEMENT_SPEC`` are compared field for field (exact).
``execute`` runs on CPU tensors in both packages, on the same seeded
numpy clip: shake motion_meta JSON byte-identical; Motion Apply and
Inverse frames <= 2e-6 abs (XLA's CPU backend contracts multiply-adds
into FMAs), masks exactly equal, meta keys and non-float values equal.
"""

import asyncio
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

from comfyui_video_stabilizer_tpu import nodes as JN  # noqa: E402
from comfyui_video_stabilizer_tpu.nodes import motion_apply_node as JMAN  # noqa: E402
from comfyui_video_stabilizer_tpu.nodes import replacements as JR  # noqa: E402
from comfyui_video_stabilizer_tpu_torch import nodes as TN  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.nodes import motion_apply_node as TMAN  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.nodes import replacements as TR  # noqa: E402
from test_motion_apply import _frames  # noqa: E402
from test_torch_stabilize_flow import _non_float_items  # noqa: E402

NEW_NODES = ["VideoStabilizerMotionApply", "VideoStabilizerShakeGenerator",
             "VideoStabilizerShakeGeneratorManual", "VideoStabilizerInverse"]


@pytest.mark.parametrize("name", NEW_NODES)
def test_node_schema_equals_jax(name):
    ref = getattr(JN, name).define_schema()
    ours = getattr(TN, name).define_schema()
    for field in ("node_id", "display_name", "category", "description", "is_deprecated"):
        assert getattr(ours, field) == getattr(ref, field)
    for a, b in ((ours.inputs, ref.inputs), (ours.outputs, ref.outputs)):
        assert [(s.kind, s.io_type, s.id, s.options) for s in a] == \
               [(s.kind, s.io_type, s.id, s.options) for s in b]


def test_replacement_spec_and_registration_equal():
    assert TR.REPLACEMENT_SPEC == JR.REPLACEMENT_SPEC
    ext = asyncio.run(TN.comfy_entrypoint())
    assert [n.__name__ for n in asyncio.run(ext.get_node_list())] == [n.__name__ for n in JN.ALL_NODES]
    assert asyncio.run(ext.on_load()) is None


@pytest.mark.parametrize("quality", ["Draft", "Standard", "High", "Ultra", "bogus"])
@pytest.mark.parametrize("blur", [0.0, 0.3])
def test_blur_profile_equal(quality, blur):
    assert TMAN._blur_profile(quality, blur) == JMAN._blur_profile(quality, blur)


def _clip(n=4, h=48, w=64, seed=2):
    return torch.from_numpy(_frames(n=n, h=h, w=w, seed=seed))


@pytest.mark.parametrize("style", ["handheld", "action"])
def test_shake_generator_execute_equal(style):
    clip = {"frames": _clip(), "fps": 29.97}
    args = (16.0, style, 1.4, 0.8, 12345)
    ref = JN.VideoStabilizerShakeGenerator.execute(clip, *args)
    ours = TN.VideoStabilizerShakeGenerator.execute(clip, *args)
    assert len(ours) == len(ref) == 1
    assert json.dumps(ours[0]) == json.dumps(ref[0])
    assert ours[0]["motion_meta"]["fps"] == 29.97


def test_shake_generator_manual_execute_equal():
    args = (0.0, 1.2, 0.7, 0.9, 0.004, 0.4, 1.1, 7.0, 1.5, 0.8, 0.5, 45.0, 2.0, 1.3, 77)
    ref = JN.VideoStabilizerShakeGeneratorManual.execute(_clip(), *args)
    ours = TN.VideoStabilizerShakeGeneratorManual.execute(_clip(), *args)
    assert json.dumps(ours[0]) == json.dumps(ref[0])


def _assert_node_outputs_equal(ours, ref):
    assert len(ours) == len(ref) == 3
    tf, tm, tmeta = ours
    jf, jm, jmeta = ref
    assert isinstance(tf, torch.Tensor) and tf.device.type == "cpu" and tf.dtype == torch.float32
    assert tf.is_contiguous() and tuple(tf.shape) == tuple(jf.shape)
    assert (tf - jf).abs().max().item() <= 2e-6
    assert tm.device.type == "cpu" and torch.equal(tm, jm)
    assert list(tmeta) == list(jmeta)
    assert dict(_non_float_items(tmeta)) == dict(_non_float_items(jmeta))


@pytest.mark.parametrize("framing,interp,blur,quality", [
    ("crop_and_pad", "bicubic", 0.5, "Draft"),
    ("crop", "bilinear", 0.0, "Ultra"),
    ("expand", "bilinear", 0.25, "Standard"),
])
def test_motion_apply_execute_equal(framing, interp, blur, quality):
    clip = _clip()
    shake = JN.VideoStabilizerShakeGenerator.execute(clip, 16.0, "action", 2.0, 1.0, 9)[0]
    args = (shake, framing, interp, "#336699", blur, quality)
    ref = JN.VideoStabilizerMotionApply.execute(clip, *args)
    ours = TN.VideoStabilizerMotionApply.execute(clip, *args, device="cpu")
    _assert_node_outputs_equal(ours, ref)
    assert ours[2]["motion_apply"]["motion_blur_quality"] == quality


def test_inverse_execute_equal():
    clip = _clip(n=5, h=60, w=80, seed=3)
    mats = [np.array([[1.0, 0.01 * i, -3.0 * i], [0.0, 1.0, 2.0], [0, 0, 1]]) for i in range(5)]
    from comfyui_video_stabilizer_tpu.meta.motion_meta import (
        applied_motion_meta_from_stabilization_warp,
        build_stabilization_warp_meta,
    )

    warp = build_stabilization_warp_meta(source_size=(88, 64), output_size=(80, 60),
                                         framing_mode="crop_and_pad", applied_matrices=mats)
    meta = {"stabilization_warp": warp,
            "motion_meta": applied_motion_meta_from_stabilization_warp(warp, 16.0, "estimated_flow")}
    ref = JN.VideoStabilizerInverse.execute(clip, meta, "#202020")
    ours = TN.VideoStabilizerInverse.execute(clip, meta, "#202020", device="cpu")
    _assert_node_outputs_equal(ours, ref)
    assert tuple(ours[0].shape) == (5, 64, 88, 3)
    assert ours[2]["motion_meta"] == meta["motion_meta"] and "motion_apply" not in ours[2]
