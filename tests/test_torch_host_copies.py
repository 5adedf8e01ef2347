"""The port's copies of the JAX package's host modules give exactly what
the originals give: motion_meta, geometry, color, shake and the native
largest rectangle and corner greedy.

Tolerance: exact everywhere.  The copies are the same numpy code (and
the same C++ for the rectangle and the greedy), so error strings, float64 results, the
shake JSON bytes and the accepted corners must all be identical.
"""

import json

import pathlib

import numpy as np
import pytest

from comfyui_video_stabilizer_tpu.meta import motion_meta as JMM
from comfyui_video_stabilizer_tpu.models import geometry as JG
from comfyui_video_stabilizer_tpu.models import shake as JSH
from comfyui_video_stabilizer_tpu.native import rectangle as JNR
from comfyui_video_stabilizer_tpu.utils import color as JC
from comfyui_video_stabilizer_tpu_torch.meta import motion_meta as TMM
from comfyui_video_stabilizer_tpu_torch.models import geometry as TG
from comfyui_video_stabilizer_tpu_torch.models import shake as TSH
from comfyui_video_stabilizer_tpu_torch.native import rectangle as TNR
from comfyui_video_stabilizer_tpu_torch.utils import color as TC


def _good_block():
    return JMM.build_motion_meta_v2(
        source="estimated_flow", frame_count=2, fps=24.0, input_size=(64, 48),
        output_size=(64, 48), matrices=[np.eye(3), np.diag([1.01, 0.99, 1.0])],
    )


def _malformed():
    def with_(**kw):
        block = _good_block()
        block.update(kw)
        return block

    def frame(i, **kw):
        block = _good_block()
        block["per_frame"][i].update(kw)
        return block

    def frame_without(i, key):
        block = _good_block()
        del block["per_frame"][i][key]
        return block

    return {
        "not_a_dict": [1, 2],
        "version": with_(version=1),
        "convention": with_(matrix_convention="output_to_input"),
        "source": with_(source=""),
        "frame_count_type": with_(frame_count="two"),
        "frame_count_negative": with_(frame_count=-1),
        "fps": with_(fps=0.0),
        "fps_nan": with_(fps=float("nan")),
        "input_size": with_(input_size=[64]),
        "output_size_int": with_(output_size=["a", 48]),
        "output_size_zero": with_(output_size=[0, 48]),
        "per_frame_type": with_(per_frame={}),
        "per_frame_length": with_(frame_count=3),
        "entry_type": with_(per_frame=[1, 2]),
        "index": frame(1, index=5),
        "matrix_missing": frame_without(0, "matrix"),
        "matrix_shape": frame(0, matrix=[[1, 0], [0, 1]]),
        "matrix_nan": frame(0, matrix=[[1, 0, float("nan")], [0, 1, 0], [0, 0, 1]]),
        "singular": frame(1, matrix=[[0, 0, 0], [0, 0, 0], [0, 0, 0]]),
        "generator": with_(source="generated_shake"),
    }


MALFORMED = sorted(_malformed())


def _message(fn, *args, **kw):
    with pytest.raises(ValueError) as info:
        fn(*args, **kw)
    return str(info.value)


@pytest.mark.parametrize("case", MALFORMED)
def test_malformed_motion_meta_raises_same_message(case):
    block = _malformed()[case]
    ref = _message(JMM.validate_motion_meta, block)
    assert _message(TMM.validate_motion_meta, block) == ref
    ref = _message(JMM.resolve_motion_meta, {"motion_meta": block})
    assert _message(TMM.resolve_motion_meta, {"motion_meta": block}) == ref


@pytest.mark.parametrize("meta", [None, {}, {"stabilization_warp": {"matrix_convention": "x"}},
                                  {"stabilization_warp": {"matrix_convention": "source_to_stabilized",
                                                          "source_size": [4, 4], "output_size": [4, 4],
                                                          "per_frame": "no"}}])
def test_resolve_errors_match(meta):
    assert _message(TMM.resolve_motion_meta, meta) == _message(JMM.resolve_motion_meta, meta)


def _warp_block(n=5, seed=0):
    rng = np.random.default_rng(seed)
    mats = [np.eye(3) + rng.normal(0, 1e-2, (3, 3)) * [[1, 1, 100], [1, 1, 100], [1e-3, 1e-3, 0]]
            for _ in range(n)]
    return mats, JMM.build_stabilization_warp_meta(
        source_size=(160, 120), output_size=(176, 128), framing_mode="expand", applied_matrices=mats)


def test_meta_builders_equal():
    mats, warp_ref = _warp_block()
    _, warp_ours = _warp_block()
    assert TMM.build_stabilization_warp_meta(
        source_size=(160, 120), output_size=(176, 128), framing_mode="expand",
        applied_matrices=mats) == warp_ref
    kw = dict(source="generated_shake", frame_count=5, fps=30.0, input_size=(160, 120),
              output_size=(160, 120), matrices=mats, generator={"node": "x", "seed": 3})
    assert json.dumps(TMM.build_motion_meta_v2(**kw)) == json.dumps(JMM.build_motion_meta_v2(**kw))
    for fn in ("motion_meta_from_stabilization_warp", "applied_motion_meta_from_stabilization_warp"):
        ref = getattr(JMM, fn)(warp_ref, fps=24.0, source="legacy_stabilization")
        assert json.dumps(getattr(TMM, fn)(warp_ours, fps=24.0, source="legacy_stabilization")) == \
            json.dumps(ref)


@pytest.mark.parametrize("key", ["motion_meta", "stabilization_warp"])
def test_resolve_motion_meta_equal(key):
    mats, warp = _warp_block(seed=1)
    meta = {"stabilization_warp": warp}
    if key == "motion_meta":
        meta["motion_meta"] = JMM.applied_motion_meta_from_stabilization_warp(warp, 30.0, "estimated_flow")
    ref, ours = JMM.resolve_motion_meta(meta), TMM.resolve_motion_meta(meta)
    for field in ("source", "frame_count", "fps", "input_size", "output_size", "generator"):
        assert getattr(ours, field) == getattr(ref, field)
    np.testing.assert_array_equal(ours.matrices(), ref.matrices())
    assert [t.index for t in ours.per_frame] == [t.index for t in ref.per_frame]


def _random_mats(n=7, seed=3):
    rng = np.random.default_rng(seed)
    mats = np.tile(np.eye(3), (n, 1, 1))
    mats[:, :2, :2] += rng.normal(0, 0.02, (n, 2, 2))
    mats[:, :2, 2] = rng.normal(0, 10, (n, 2))
    mats[:, 2, :2] = rng.normal(0, 1e-4, (n, 2))
    return mats


GEOMETRY_CASES = {
    "matrices_to_params": lambda G, m: [G.matrices_to_params(m, mode)
                                        for mode in ("translation", "similarity", "perspective")],
    "params_to_matrices": lambda G, m: [G.params_to_matrices(G.matrices_to_params(m, mode), mode)
                                        for mode in ("translation", "similarity", "perspective")],
    "matrix_params_single": lambda G, m: [G.params_to_matrix(G.matrix_to_params(m[0], "similarity"),
                                                             "similarity")],
    "working_estimation_size": lambda G, m: [np.array(G.working_estimation_size(w, h) or (0, 0))
                                             for w, h in ((1920, 1080), (1200, 500), (640, 480), (961, 3))],
    "rescale_transforms_to_full": lambda G, m: [G.rescale_transforms_to_full(m, (1920, 1080), (960, 540))],
    "integrate_and_smooth": lambda G, m: [G.smooth_path(G.integrate_path(G.matrices_to_params(m, "similarity")),
                                                        s, fps) for s, fps in ((0.0, 16), (0.5, 24), (1.0, 60))],
    "smoothing_window": lambda G, m: [np.array([G.smoothing_window(s, f) for s in (0, 0.3, 1) for f in (1, 16, 59.94)])],
    "bounding_boxes": lambda G, m: list(G.compute_bounding_boxes(m, 160, 120)),
    "framing": lambda G, m: [np.array(G.min_content_ratio(*G.compute_bounding_boxes(m, 160, 120), 160, 120)),
                             np.array(G.intersection_box(*G.compute_bounding_boxes(m, 160, 120))),
                             G.prepare_expand_transform(*G.compute_bounding_boxes(m, 160, 120))[0],
                             np.array(G.prepare_expand_transform(*G.compute_bounding_boxes(m, 160, 120))[1])],
    "translation_and_inverse": lambda G, m: [G.translation_matrix(3.5, -2.25), G.invert_matrices(m)],
}


@pytest.mark.parametrize("case", sorted(GEOMETRY_CASES))
def test_geometry_equal(case):
    m = _random_mats()
    ref, ours = GEOMETRY_CASES[case](JG, m), GEOMETRY_CASES[case](TG, m)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert TG.PARAM_DIM == JG.PARAM_DIM


@pytest.mark.parametrize("value", ["#7F7F7F", "#abc", "7f7f7f", " #102030 ", "#12345", "#GGGGGG",
                                   "10,20,30", "10/20/30", "300, -5, 7", "42", "1,2", "a,b,c", "",
                                   0x112233, -4, 2 ** 30, None, 3.7])
def test_parse_padding_color_equal(value):
    assert TC.parse_padding_color(value) == JC.parse_padding_color(value)
    assert TC.DEFAULT_PADDING_RGB == JC.DEFAULT_PADDING_RGB


def _shake_json(SH, style, seed, n, fps=24.0, amount=1.0, speed=1.0):
    return json.dumps(SH.generate_shake_motion_meta(
        recipe=SH.STYLES[style], frame_count=n, width=320, height=180, fps=fps,
        amount=amount, speed=speed, seed=seed, style=style,
    ))


@pytest.mark.parametrize("n", [1, 2, 64])
@pytest.mark.parametrize("seed", [0, 7, 2 ** 40 + 3])
@pytest.mark.parametrize("style", ["tripod", "handheld", "walking", "action", "vibration"])
def test_shake_json_byte_identical(style, seed, n):
    assert _shake_json(TSH, style, seed, n) == _shake_json(JSH, style, seed, n)


def test_shake_manual_recipe_and_clamps_identical():
    values = {f: v for f, v in zip(TSH.ShakeRecipe.__dataclass_fields__,
                                   (9.0, 0.5, 0.2, 0.1, 3.0, 0.8, 20.0, 2.5, 1.5, 0.7, 5.0))}
    for SH in (JSH, TSH):
        assert SH.recipe_to_dict(SH.recipe_from_mapping(values)) == \
            JSH.recipe_to_dict(JSH.recipe_from_mapping(values))
    kw = dict(frame_count=48, width=200, height=100, fps=12.5, amount=2.5, speed=0.05, seed=11,
              node="shake_generator_manual", style="manual")
    ref = json.dumps(JSH.generate_shake_motion_meta(recipe=JSH.recipe_from_mapping(values), **kw))
    assert json.dumps(TSH.generate_shake_motion_meta(recipe=TSH.recipe_from_mapping(values), **kw)) == ref


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_greedy_equal(seed):
    rng = np.random.default_rng(seed)
    h, w = 90, 130
    idx = rng.permutation(h * w)[:2048]
    for min_distance, max_corners in ((7.0, 400), (1.0, 50), (12.5, 2048)):
        ref = JNR.greedy_min_distance(idx // w, idx % w, h, w, min_distance, max_corners)
        ours = TNR.greedy_min_distance(idx // w, idx % w, h, w, min_distance, max_corners)
        np.testing.assert_array_equal(ours, ref)
        assert ours.shape[0] > 0


def _cpp_function(path, name):
    """The text of the C function ``name`` in a native source file."""
    text = pathlib.Path(path).read_text()
    start = text.index(f" {name}(")
    return text[text.rindex("\n", 0, start):text.index("\n}\n", start)]


def test_native_rectangle_source_is_a_copy():
    assert _cpp_function(TNR._SRC, "largest_rectangle") == \
        _cpp_function(pathlib.Path(JNR.__file__).with_name("rectangle.cpp"), "largest_rectangle")


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_native_rectangle_equal(seed):
    rng = np.random.default_rng(seed)
    for shape, density in (((48, 64), 0.25), ((40, 56), 0.2), ((1, 31), 0.3), ((31, 1), 0.3), ((20, 20), 1.0)):
        mask = rng.random(shape) > density
        assert TNR.largest_axis_aligned_rectangle(mask) == JNR.largest_axis_aligned_rectangle(mask)


def test_native_greedy_builds_into_build_dir():
    TNR.greedy_min_distance(np.zeros(1, np.int64), np.zeros(1, np.int64), 4, 4, 7.0, 1)
    path = TNR.library_path()
    assert path.exists() and path.parent.name == "build"
    assert path.parent == TNR.build_dir() == pathlib.Path(TNR.__file__).resolve().parents[2] / "build"
    assert "comfyui_video_stabilizer_tpu" not in path.parent.parts


@pytest.mark.parametrize("layout", ["checkout", "installed"])
def test_build_dir_stays_out_of_install_trees(tmp_path, monkeypatch, layout):
    """A checkout builds into its own build/; an installed package (no
    pyproject.toml beside it) into the user cache, never next to site-packages."""
    from comfyui_video_stabilizer_tpu_torch.ops import cuda_build

    pkg = tmp_path / "site-packages" / "comfyui_video_stabilizer_tpu_torch"
    pkg.mkdir(parents=True)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    if layout == "checkout":
        (pkg.parent / "pyproject.toml").write_text("")
        assert cuda_build.build_dir(pkg) == pkg.parent / "build"
    else:
        assert cuda_build.build_dir(pkg) == tmp_path / "cache" / "comfyui_video_stabilizer_tpu_torch" / "build"
