"""The cell of the upstream Wan VACE workflows' clip size, ``flow_wan_vace.node``
(864x486 x 81, Flow through the node): a whole run on the CPU at a small
size of the same plan (2 mod 4 rows: decimation 1, a 1 x 1 gray), and
K9's roofline reader, which reads only a 1 x 1 plan of the reference's."""

import time

import pytest
import torch

from benchmark import core, tracing
from benchmark.rooflines import k9

CELL = "flow_wan_vace.node"
SMALL = (9, 122, 216)
SEED = 2**31 + 4111
K9_EVENT = "void (anonymous namespace)::gray_pool_kernel<3, true>(float const*, float*, int, int, int, int, int, float)"


@pytest.fixture(autouse=True)
def fast_path(monkeypatch):
    monkeypatch.setenv("CVST_FASTPATH", "1")


def _reader():
    return core.find_cell(CELL).reader("kernels.k9_roofline.node")


def test_a_small_run_of_the_cell_is_correct_with_every_number_0():
    cell = core.find_cell(CELL)
    result, compared = core.run_cell(cell, SEED, 0.3, False, torch.device("cpu"), time.perf_counter(),
                                     clip_size=SMALL)
    assert result["correct"] and result["failed"] == 0, compared
    assert set(result["metrics"]) == {"node_frames_per_s", "peak_mem_gib", "setup_s"}  # its tail is per layer
    assert all(value == 0.0 for value, _ in compared.values()), compared


def _obs(shape, profile):
    return core.Observation(shape, None, {"calls": 3}, profile)


def test_the_k9_reader_reads_a_one_by_one_plan_only():
    read = _reader()
    shape = (81, 486, 864, 3)
    assert read(_obs(shape, None)) is None                        # no profile
    prof = tracing.Profile(device=[(K9_EVENT, 0.0, 0.5e-3), ("Memcpy HtoD", 1.0, 2.0), (K9_EVENT, 3.0, 3.5e-3 + 3.0)],
                           calls=2)
    assert read(_obs((81, 1080, 1920, 3), prof)) is None          # 1080p: the reference pools 8 x 8
    assert read(_obs((81, 500, 1200, 3), prof)) is None           # an area resize, no integer pool
    assert read(_obs(shape, tracing.Profile(device=[("Memcpy HtoD", 1.0, 2.0)], calls=1))) is None
    # two calls' 544.2 MB at 3.35 TB/s over 4 ms of K9
    assert k9.bytes_moved(*shape, 1, 1) == 544_195_584
    assert read(_obs(shape, prof)) == pytest.approx(100.0 * 2 * 544_195_584 / 3.35e12 / 4e-3)
