"""The clip size of the upstream Wan VACE workflows (``ImageScaleToTotalPixels``
0.4 MP of a 1080p video: 864x486, the benchmark's ``flow_wan_vace``).

At 864x486 the longest side is at most 960, so Flow estimates at full size,
and 486 % 4 = 2, so its gray is not decimated: K9 runs at a 1 x 1 pool and
DIS builds its own pyramid from the full gray.  On the CPU, with the fast
path forced on: the plan against 1080p's, the node against the benchmark's
plain reference (``benchmark/reference``; every compared number 0), the
bfloat16 control refused by the configuration's limits, and the port's
pyramid against the reference's.  The ``cuda`` case holds K9 at 1 x 1 on a
whole 81-frame clip to its plain version, bitwise (``--noconftest``: this
file imports no JAX):

    python -m pytest --noconftest tests/test_torch_wan_vace.py -q -m cuda
"""

import pathlib
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import calibrate, check, core  # noqa: E402
from benchmark.inputs import clips  # noqa: E402
from benchmark.reference import dis as ref_dis  # noqa: E402
from benchmark.reference import engine as ref_engine  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.models import classic as CL  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.models import fastpath  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.models import flow as FL  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.models.stabilize import estimation_plan  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.nodes import stabilizer_nodes as SN  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import cuda_build  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import flow_dis as FD  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import resize as R  # noqa: E402

CELL = "flow_wan_vace.node"
SEED = 2**31 + 4099


@pytest.fixture(autouse=True)
def fast_path(monkeypatch):
    """The card's path is the fast path; the CPU runs it when asked."""
    monkeypatch.setenv("CVST_FASTPATH", "1")


@pytest.mark.parametrize("estimator, size, plan, pool", [
    (FL.flow_estimator, (1920, 1080), ((960, 540), 4), (8, 8)),
    (FL.flow_estimator, (864, 486), (None, 1), (1, 1)),
    (CL.classic_estimator, (1920, 1080), ((960, 540), 1), (2, 2)),
    (CL.classic_estimator, (864, 486), (None, 1), (1, 1)),
], ids=["flow-1080p", "flow-wan-vace", "classic-1080p", "classic-wan-vace"])
def test_the_estimation_plan_of_each_size(estimator, size, plan, pool):
    width, height = size
    assert estimation_plan(width, height, estimator) == plan
    assert fastpath._gray_pool_factors(width, height, *plan) == pool


@pytest.mark.parametrize("size", [(9, 122, 216), (9, 486, 864)], ids=["small", "published"])
def test_the_node_equals_the_plain_reference(size):
    """Heights of 2 mod 4 keep Flow's decimation at 1, as at 486 rows."""
    cell = core.find_cell(CELL)
    conf = cell.config
    n, h, w = size
    clip = clips.make_clip(n, h, w, clips.sub_seed(SEED, 0), cell.traffic["clip"], torch.device("cpu"))
    widgets = tuple(conf["node"][k] for k in ("frame_rate", "framing_mode", "transform_mode", "camera_lock",
                                               "strength", "smooth", "keep_fov", "padding_color"))
    frames, masks, meta = SN.VideoStabilizerFlow.execute(clip, *widgets, device="cpu")
    settings = ref_engine.settings_of(conf)
    ref = ref_engine.stabilize(clip, conf["estimator"], settings)
    numbers = check.compare(frames, masks, meta, ref, conf["estimator"], settings, "cpu")
    assert numbers == {k: 0.0 for k in check.NUMBERS}


def test_the_bfloat16_control_is_not_correct():
    cell = core.find_cell(CELL)
    numbers = calibrate.control_readings(cell, SEED, torch.device("cpu"), clip_size=(9, 122, 216))
    assert not check.verdict(numbers, check.limits_of(cell.config_name)), numbers


def test_the_pyramid_of_a_full_gray_equals_the_references():
    gen = torch.Generator().manual_seed(7)
    gray = torch.floor(torch.rand((3, 486, 864), generator=gen) * 256.0)
    coarsest = FD.num_levels(486, 864)
    assert coarsest == ref_dis.num_levels(486, 864) == 5
    ours, ref = FD.build_pyramid(gray, coarsest), ref_dis.build_pyramid(gray, coarsest)
    assert [tuple(lvl.shape[1:]) for lvl in ours] == [(486, 864), (243, 432), (121, 216), (60, 108), (30, 54),
                                                     (15, 27)]
    assert len(ours) == len(ref) and all(torch.equal(a, b) for a, b in zip(ours, ref))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_k9_at_one_by_one_on_a_whole_clip_equals_plain(cuda):
    frames = torch.rand((81, 486, 864, 3), generator=torch.Generator().manual_seed(11)).to(cuda)
    cuda_build.reset_launches()
    out = R.gray_pool(frames, 1, 1)
    ref = R.gray_pool_plain(frames, 1, 1)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["gray_pool"] == 1
    assert torch.equal(out, ref)
