"""A configuration names its own plain reference, and the check takes the
path width, the converter and the framing mode from that reference.

(a) a copy of the benchmark whose added configuration names a copied
reference directory runs with no edit, and the copy's ``stabilize`` is
the one the check calls; (b) for each configuration, the check through
the configuration's reference reads the same numbers, bit for bit, as
through the default reference imported directly; (c) a stub reference
with 8-parameter paths and ``crop`` framing: the paths and the meta read
0 where the program's outputs match it, more where one perspective
parameter moves, and infinity where the widths differ."""

import json
import pathlib
import shutil
import time

import numpy as np
import pytest
import torch

from benchmark import calibrate, check, core
from benchmark.inputs import clips
from benchmark.reference import engine as default_engine

ROOT = pathlib.Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
TINY = (9, 144, 256)
SEED = 2**31 + 6151

SENTINEL = '''

CALLS = []
_unmarked = stabilize


def stabilize(frames, estimator, settings, **kwargs):
    CALLS.append(tuple(frames.shape))
    return _unmarked(frames, estimator, settings, **kwargs)
'''


@pytest.fixture(autouse=True)
def fast_path(monkeypatch):
    """The card's timed path is the fast path; the CPU runs it when asked."""
    monkeypatch.setenv("CVST_FASTPATH", "1")


def test_an_added_config_with_its_own_reference_is_run_and_checked_by_it(tmp_path):
    base = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark", base, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copytree(base / "reference", base / "reference_sentinel")
    with (base / "reference_sentinel" / "engine.py").open("a") as f:
        f.write(SENTINEL)
    conf = json.loads((base / "configs" / "flow_1080p.json").read_text())
    conf.update(name="flow_sentinel", reference="reference_sentinel")
    (base / "configs" / "flow_sentinel.json").write_text(json.dumps(conf))
    shutil.copy(base / "limits" / "flow_1080p.json", base / "limits" / "flow_sentinel.json")
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append(dict(spec["configs"][0], name="flow_sentinel", file="benchmark/configs/flow_sentinel.json"))
    spec["workloads"].append({"name": "flow_sentinel.resident", "config": "flow_sentinel", "traffic": "resident",
                              "chips": 1, "why": "a configuration with its own reference"})
    cell = core.find_cell("flow_sentinel.resident", spec=spec, root=tmp_path, base=base)
    engine = cell.reference()
    assert engine is not default_engine and engine.CALLS == []
    assert pathlib.Path(engine.ransac.__file__).parent == (base / "reference_sentinel").resolve()
    result, compared = core.run_cell(cell, SEED, 0.3, False, torch.device("cpu"), time.perf_counter(), clip_size=TINY)
    assert result["correct"], compared
    assert all(value == 0.0 for value, _ in compared.values()), compared
    assert engine.CALLS and set(engine.CALLS) == {TINY + (3,)}   # one reference a clip the check compared


@pytest.mark.parametrize("name, size", [("flow_1080p.resident", TINY), ("classic_1080p.resident", TINY),
                                        ("flow_wan_vace.node", (9, 122, 216))])
def test_the_check_through_a_configurations_reference_reads_as_the_default_one(name, size):
    cell = core.find_cell(name)
    conf, est = cell.config, cell.config["estimator"]
    engine = cell.reference()
    assert engine is not default_engine          # loaded by path, the same files
    clip = clips.make_clip(*size, clips.sub_seed(SEED, 0), cell.traffic["clip"], torch.device("cpu"))
    program = cell.entry()(conf, torch.device("cpu"))(clip)
    settings = engine.settings_of(conf)
    control = default_engine.as_node_outputs(default_engine.stabilize(clip, est, settings, store=torch.bfloat16),
                                             est, settings)
    ref, direct = engine.stabilize(clip, est, settings), default_engine.stabilize(clip, est, settings)
    for outputs in (program, control):
        numbers = check.compare(*outputs, ref, est, settings, "cpu")
        assert numbers == check.compare(*outputs, direct, est, settings, "cpu")
    assert all(v == 0.0 for v in check.compare(*program, ref, est, settings, "cpu").values())
    assert check.compare(*control, ref, est, settings, "cpu")["path_px"] > 0.0
    assert calibrate.control_readings(cell, SEED, torch.device("cpu"), clip_size=size) == check.compare(
        *control, direct, est, settings, "cpu")


STUB = '''"""A stub reference: perspective paths and crop framing."""

import math
from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

WIDTHS = []


@dataclass
class Result:
    modes: List[str]
    motion: np.ndarray
    path: np.ndarray
    target_path: np.ndarray
    final: np.ndarray
    frames: torch.Tensor
    masks: torch.Tensor
    ratios: np.ndarray
    framing: Dict[str, object]


def to_matrices(p):
    p = np.asarray(p, np.float64)
    WIDTHS.append(p.shape[-1])
    out = np.zeros(p.shape[:-1] + (3, 3))
    out[..., :2, :] = p[..., :6].reshape(p.shape[:-1] + (2, 3))
    out[..., 0, 0] += 1.0
    out[..., 1, 1] += 1.0
    out[..., 2, 0], out[..., 2, 1], out[..., 2, 2] = p[..., 6], p[..., 7], 1.0
    return out


def corner_gap_px(a, b, width, height):
    corners = np.array([[0.0, 0.0, 1.0], [width, 0.0, 1.0], [0.0, height, 1.0], [width, height, 1.0]])
    wa, wb = np.einsum("nij,kj->nki", a, corners), np.einsum("nij,kj->nki", b, corners)
    gap = np.sqrt(((wa[..., :2] / wa[..., 2:] - wb[..., :2] / wb[..., 2:]) ** 2).sum(-1))
    return float(gap.max()) if np.isfinite(gap).all() else math.inf
'''


@pytest.fixture
def stub(tmp_path):
    (tmp_path / "stub").mkdir()
    (tmp_path / "stub" / "__init__.py").write_text("")
    (tmp_path / "stub" / "engine.py").write_text(STUB)
    engine = core.load_reference(tmp_path, "stub")
    n, h, w = 5, 16, 24
    rng = np.random.default_rng(3)
    path = np.cumsum(rng.normal(0.0, [0.01, 0.01, 1.0, 0.01, 0.01, 1.0, 1e-4, 1e-4], (n, 8)), axis=0)
    path[0] = 0.0
    target = 0.5 * path
    framing = {"mode": "crop", "input_size": [w, h], "padding_color_rgb": [127, 127, 127], "min_content_ratio": 0.9,
               "safe_region_origin": [1.0, 1.0], "safe_region_size": [22.0, 14.0], "actual_content_ratio": 0.875,
               "center_offset": [0.5, -0.5], "padding_detected": False}
    res = engine.Result(["perspective"] * (n - 1), engine.to_matrices(np.diff(path, axis=0)), path, target,
                        engine.to_matrices(target - path).astype(np.float32), torch.zeros((n, h, w, 3)),
                        torch.zeros((n, h, w)), np.zeros(n), framing)
    settings = {"transform_mode": "perspective", "frame_rate": 24.0}
    engine.WIDTHS.clear()
    return engine, res, settings


def test_a_stub_references_paths_and_meta_read_0_when_the_program_matches_it(stub):
    engine, res, settings = stub
    frames, masks, meta = default_engine.as_node_outputs(res, "flow", settings)
    numbers = check.compare(frames, masks, meta, res, "flow", settings, "cpu")
    assert numbers == {k: 0.0 for k in check.NUMBERS}
    assert engine.WIDTHS == [8] * 4                  # the stub's converter read both paths of both sides
    assert meta["framing"]["mode"] == meta["stabilization_warp"]["framing_mode"] == "crop"
    meta["framing"]["mode"] = "crop_and_pad"         # the mode is the reference's, not a fixed one
    assert check.compare(frames, masks, meta, res, "flow", settings, "cpu")["meta_off"] == 1.0


@pytest.mark.parametrize("key", ["path", "target_path"])
@pytest.mark.parametrize("param", range(8))
def test_a_stub_references_path_reads_a_moved_perspective_parameter(stub, key, param):
    engine, res, settings = stub
    frames, masks, meta = default_engine.as_node_outputs(res, "flow", settings)
    meta["estimated_motion"][key][2][param] += 1e-3
    assert check.compare(frames, masks, meta, res, "flow", settings, "cpu")["path_px"] > 0.0


@pytest.mark.parametrize("width", [2, 4, 9])
def test_a_path_of_another_width_than_the_references_reads_infinity(stub, width):
    engine, res, settings = stub
    frames, masks, meta = default_engine.as_node_outputs(res, "flow", settings)
    for key in ("path", "target_path"):
        meta["estimated_motion"][key] = np.resize(np.asarray(meta["estimated_motion"][key]), (5, width)).tolist()
    numbers = check.compare(frames, masks, meta, res, "flow", settings, "cpu")
    assert numbers["path_px"] == np.inf
    assert numbers["meta_off"] == 0.0 and numbers["warp_px"] == 0.0


@pytest.mark.parametrize("params, matrix", [
    ([2.0, -3.0], [[1, 0, 2], [0, 1, -3], [0, 0, 1]]),
    ([2.0, -3.0, 0.0, np.log(2.0)], [[2, 0, 2], [0, 2, -3], [0, 0, 1]]),
    ([2.0, -3.0, np.pi / 2, 0.0], [[0, -1, 2], [1, 0, -3], [0, 0, 1]]),
    ([0.5, 0.1, 2.0, 0.2, -0.5, -3.0, 1e-3, -2e-3], [[1.5, 0.1, 2], [0.2, 0.5, -3], [1e-3, -2e-3, 1]]),
], ids=["translation", "similarity-scale", "similarity-turn", "perspective"])
def test_the_default_converter_reads_each_width(params, matrix):
    got = default_engine.to_matrices(np.asarray([params, params]))
    assert got.shape == (2, 3, 3)
    np.testing.assert_allclose(got, [matrix, matrix], rtol=0, atol=1e-15)


def test_a_path_width_no_transform_has_is_refused():
    with pytest.raises(ValueError, match="no transform"):
        default_engine.to_matrices(np.zeros((3, 5)))


@pytest.mark.parametrize("name", ["..", "../elsewhere", "configs", "no_such_dir"])
def test_a_reference_outside_the_benchmark_or_without_an_engine_is_refused(name):
    with pytest.raises(FileNotFoundError, match="engine.py"):
        core.load_reference(ROOT / "benchmark", name)


def test_the_same_directory_loads_once_and_another_copy_apart(tmp_path):
    shutil.copytree(ROOT / "benchmark" / "reference", tmp_path / "reference", ignore=shutil.ignore_patterns("__pycache__"))
    first = core.load_reference(ROOT / "benchmark", "reference")
    assert core.load_reference(ROOT / "benchmark", "reference") is first
    other = core.load_reference(tmp_path, "reference")
    assert other is not first and other.dis is not first.dis
    assert pathlib.Path(other.dis.__file__).parent == (tmp_path / "reference").resolve()
