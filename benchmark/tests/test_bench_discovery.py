"""Configurations, traffic mixes, entries and metrics are files found by name."""

import json
import pathlib
import shutil

import pytest

from benchmark import core

ROOT = pathlib.Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_resolves_to_its_files(name):
    cell = core.find_cell(name)
    assert cell.config["name"] == cell.config_name
    assert callable(cell.entry())
    assert [m["name"] for m in cell.end_to_end] == [
        m["name"] for m in SPEC["end_to_end"] if name in m.get("workloads", [name])]
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "peak_mem_gib"}
    quantities = {core.quantity(m["name"]) for m in cell.end_to_end}
    assert quantities <= set(core.QUANTITIES) and {"frames_per_s", "setup_s"} <= quantities
    if "call_ms_p95" not in quantities:  # a tail too wide for its bound is read per layer
        assert any(m["name"].endswith("call_ms_p95") for m in cell.per_layer)
    for m in cell.per_layer:
        assert callable(cell.reader(m["name"]))
    assert set(core.check.limits_of(cell.config_name)) == set(core.check.NUMBERS)


def test_every_file_named_in_the_spec_exists_under_paths():
    for c in SPEC["configs"]:
        assert c["file"].startswith(tuple(p + "/" for p in SPEC["paths"]))
        assert (ROOT / c["file"]).is_file()
    for m in SPEC["per_layer"]:
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()


def test_an_added_config_traffic_entry_and_metric_are_taken_with_no_edit(tmp_path):
    base = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark", base, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copytree(base / "reference", base / "reference_720p")
    conf = json.loads((base / "configs" / "flow_1080p.json").read_text())
    conf.update(name="flow_720p", reference="reference_720p")
    conf["clip"].update(height=720, width=1280)
    (base / "configs" / "flow_720p.json").write_text(json.dumps(conf))
    traffic = json.loads((base / "traffic" / "resident.json").read_text())
    traffic["entry"] = "echo"
    (base / "traffic" / "echo.json").write_text(json.dumps(traffic))
    (base / "entries" / "echo.py").write_text("class Entry:\n    def __init__(self, config, device):\n"
                                              "        self.config = config\n")
    (base / "metrics" / "echo.calls.py").write_text("def read(obs):\n    return obs.counters['calls']\n")
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append(dict(spec["configs"][0], name="flow_720p", file="benchmark/configs/flow_720p.json"))
    spec["workloads"].append({"name": "flow_720p.echo", "config": "flow_720p", "traffic": "echo", "chips": 1,
                              "why": "a cell made of added files"})
    spec["per_layer"].append({"name": "echo.calls", "unit": "calls", "better": "higher",
                              "source": "program_counter", "layer": "echo", "moves": "setup_s"})
    cell = core.find_cell("flow_720p.echo", spec=spec, root=tmp_path, base=base)
    assert cell.config["clip"]["height"] == 720
    engine = cell.reference()   # the configuration's own copy of the reference, and its modules
    assert pathlib.Path(engine.__file__).parent == (base / "reference_720p").resolve()
    assert pathlib.Path(engine.dis.__file__).parent == (base / "reference_720p").resolve()
    assert core.find_cell("flow_1080p.resident").reference() is not engine
    assert cell.entry()(cell.config, "cpu").config is cell.config
    assert "echo.calls" in [m["name"] for m in cell.per_layer]   # no workloads key: every setup_s cell
    obs = core.Observation((1, 1, 1, 3), None, {"calls": 7}, None)
    assert cell.reader("echo.calls")(obs) == 7


def test_a_metric_with_workloads_applies_to_those_cells_only():
    node = core.find_cell("flow_1080p.node")
    resident = core.find_cell("flow_1080p.resident")
    assert "io.egress_ms" in [m["name"] for m in node.per_layer]
    assert "io.egress_ms" not in [m["name"] for m in resident.per_layer]
    assert "engine.call_ms.api" in [m["name"] for m in resident.per_layer]
    assert "engine.call_ms.api" not in [m["name"] for m in node.per_layer]


@pytest.mark.parametrize("metric, want", [("api_frames_per_s", "frames_per_s"), ("node_call_ms_p95", "call_ms_p95"),
                                          ("setup_s", "setup_s"), ("peak_mem_gib", "peak_mem_gib")])
def test_an_end_to_end_metric_is_the_quantity_its_name_ends_with(metric, want):
    assert core.quantity(metric) == want
    with pytest.raises(KeyError):
        core.quantity("frames_per_s_total")
    with pytest.raises(KeyError):
        core.find_cell("no_such.cell")


@pytest.mark.parametrize("extra", [{"callers": 4}, {"loop": "open"}, {"clip_on": "disk"}])
def test_a_traffic_key_the_harness_does_not_read_is_refused(tmp_path, extra):
    traffic = json.loads((ROOT / "benchmark" / "traffic" / "resident.json").read_text())
    traffic.update(extra)
    (tmp_path / "mix.json").write_text(json.dumps(traffic))
    with pytest.raises(ValueError, match="closed"):
        core.read_traffic(tmp_path / "mix.json")
