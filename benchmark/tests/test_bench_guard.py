"""What the benchmark may load and read."""

import json
import pathlib
import re

import pytest

from benchmark import core

BENCH = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("modules, found", [
    (["comfyui_video_stabilizer_tpu_torch", "comfyui_video_stabilizer_tpu_torch.ops.warp"], []),
    (["comfyui_video_stabilizer_tpu.models.flow"], ["comfyui_video_stabilizer_tpu"]),
    (["jax.numpy", "numpy"], ["jax"]),
    (["jaxlib"], ["jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["jaxtyping", "jax_foo", "comfyui_video_stabilizer_tpu_extra"], []),
])
def test_forbidden_modules_compare_whole_top_level_names(modules, found):
    assert core.forbidden_modules(modules) == found


def _sources():
    return [p for p in BENCH.rglob("*.py") if "tests" not in p.parts]


def test_no_benchmark_source_imports_jax_or_the_jax_package():
    pat = re.compile(r"^\s*(?:from|import)\s+(jax|jaxlib|flax|comfyui_video_stabilizer_tpu)\b(?!_)", re.M)
    assert [p.name for p in _sources() if pat.search(p.read_text())] == []


def test_the_reference_and_the_inputs_import_nothing_of_the_program():
    references = {json.loads(p.read_text()).get("reference", core.DEFAULT_REFERENCE)
                  for p in (BENCH / "configs").glob("*.json")} | {core.DEFAULT_REFERENCE}
    for sub in sorted(references) + ["inputs", "rooflines"]:
        for p in (BENCH / sub).rglob("*.py"):
            assert "comfyui_video_stabilizer" not in p.read_text(), p


def test_nothing_reads_the_jax_benchmark_or_the_smoke_and_digest_scripts():
    for p in _sources():
        text = p.read_text()
        for name in ("bench.py", "chip_smoke", "slice_digest", "BENCH_r", "MULTICHIP_r"):
            assert name not in text, (p, name)
