"""BASELINE config 3 (the benchmark's ``flow_720p_persp_lock``): Flow at
1280x720 x 128, perspective with camera lock, crop_and_pad, 24 fps.

At 1280x720 the working size is 960x540, which no integer pool of the
clip gives, so the gray goes through the INTER_AREA weights and Flow's
decimation is 1; DIS fits its pre-warp as a homography, RANSAC fits
perspective first, and the lock's target path is zero.  On the CPU, with
the fast path forced on: the package API against the configuration's own
plain reference (``benchmark/reference_flow_720p_persp_lock``, loaded as
the harness loads it) within the configuration's limits, with equal
modes; the working gray, and DIS with the homography pre-warp, against
the reference's; the bfloat16 control refused by the limits; the
reference refusing the framings it does not run.  The ``cuda`` case
makes the first comparison on a short 720p clip on the card
(``--noconftest``: this file imports no JAX):

    python -m pytest --noconftest tests/test_torch_flow_720p_persp_lock.py -q -m cuda
"""

import pathlib
import sys
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import calibrate, check, core  # noqa: E402
from benchmark.inputs import clips  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.models import fastpath  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.models import flow as FL  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.models.flow import stabilize_flow  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.models.stabilize import estimation_plan  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import flow_dis as FD  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import resize as R  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.utils.color import parse_padding_color  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.utils.video_io import normalize_video_input  # noqa: E402

CELL = "flow_720p_persp_lock.resident"
SEED = 2**31 + 8191


@pytest.fixture(autouse=True)
def fast_path(monkeypatch):
    """The card's path is the fast path; the CPU runs it when asked."""
    monkeypatch.setenv("CVST_FASTPATH", "1")


@pytest.fixture(scope="module")
def cell():
    return core.find_cell(CELL)


def _clip(cell, size, device="cpu", k=0):
    return clips.make_clip(*size, clips.sub_seed(SEED, k), cell.traffic["clip"], torch.device(device))


def _api_against_reference(cell, clip, device):
    """The package API call of the cell's entry on ``clip`` and the
    reference's numbers for it."""
    conf = cell.config
    s = conf["node"]
    context = normalize_video_input(clip, device=device)
    result = stabilize_flow(context, s["framing_mode"], s["transform_mode"], s["camera_lock"], s["strength"],
                            s["smooth"], s["keep_fov"], parse_padding_color(s["padding_color"]), s["frame_rate"],
                            device=device)
    engine = cell.reference()
    settings = engine.settings_of(conf)
    ref = engine.stabilize(clip, conf["estimator"], settings)
    numbers = check.compare(result.frames, result.masks, result.meta, ref, conf["estimator"], settings,
                            torch.device(device).type)
    return result.meta, ref, numbers


def test_the_plan_at_720p_is_an_area_resize_at_decimation_one_on_the_eager_route():
    """No integer pool gives 960x540 from 1280x720, so a clip on the card
    takes the eager route, where 1080p's pooled gray takes the graph."""
    assert estimation_plan(1280, 720, FL.flow_estimator) == ((960, 540), 1)
    assert fastpath._gray_pool_factors(1280, 720, (960, 540), 1) is None
    on_card = SimpleNamespace(device=torch.device("cuda", 0))
    assert fastpath._route("flow", on_card, "crop_and_pad", None, (1280, 720), (960, 540), 1) == "eager"
    assert fastpath._route("flow", on_card, "crop_and_pad", None, (1920, 1080), (960, 540), 4) == "graph"


def test_the_api_equals_the_configurations_reference(cell):
    meta, ref, numbers = _api_against_reference(cell, _clip(cell, (12, 144, 256)), "cpu")
    limits = check.limits_of(cell.config_name)
    assert check.verdict(numbers, limits), (numbers, limits)
    modes = [t["mode"] for t in meta["estimated_motion"]["per_transition"]]
    assert modes == ref.modes and modes.count("perspective") == len(modes)
    assert meta["camera_lock"] is True and meta["transform_mode_requested"] == "perspective"
    assert len(meta["estimated_motion"]["path"][0]) == 8
    assert not any(meta["estimated_motion"]["target_path"][i] != [0.0] * 8 for i in range(12))


def test_the_working_gray_of_a_720p_clip_equals_the_references(cell):
    """Both pool nothing and apply the same float32 area weights, rows then
    columns.  The tolerance, 1e-3 grey levels, bounds any order of the two
    products' sums: each output sums at most 9 products of an integer
    level under 256 and weights summing to 1, so rounding moves it by
    under 9 x 256 x 2**-24 ~ 1.4e-4; on the CPU it reads 0."""
    clip = _clip(cell, (2, 720, 1280))
    ours = R.gray_for_estimation(clip, (960, 540))
    ref = cell.reference().grays(clip, 960, 540)
    assert ours.shape == ref.shape == (2, 540, 960)
    assert float((ours - ref).abs().max()) <= 1e-3


@pytest.mark.parametrize("finest_scale", [0, 2])
def test_dis_with_the_homography_prewarp_equals_the_references(cell, finest_scale):
    """The port solves the IRLS normal equations by its own elimination
    (K11's plain twin here), the reference by the library's LU, so the
    pre-warps differ by rounding, which the cost volume and the
    densification carry on: 1.1e-3 px on this pair at the finest scale 0,
    as far as the reference's own sound variants move it (float64 solves
    1.6e-3, reversed sums 1.0e-3).  The tolerance is 0.01 px, 0.1 % of
    the pair's largest flow."""
    engine = cell.reference()
    clip = _clip(cell, (3, 135, 240))
    grays = engine.grays(clip, 240, 135)
    ours = FD.dis_flow_fit(grays, 8, finest_scale=finest_scale, model="homography")
    ref = engine.dis.dis_flow_fit(grays, 8, finest_scale)
    assert ours.shape == ref.shape == (2, 510, 2)
    assert float((ours - ref).abs().max()) <= 0.01
    assert float(ref.abs().max()) > 5.0  # the pair moves


def test_the_bfloat16_control_is_not_correct(cell):
    numbers = calibrate.control_readings(cell, SEED, torch.device("cpu"), clip_size=(12, 144, 256))
    assert not check.verdict(numbers, check.limits_of(cell.config_name)), numbers


@pytest.mark.parametrize("framing", ["expand", "crop"])
def test_the_reference_refuses_a_framing_it_does_not_run(cell, framing):
    engine = cell.reference()
    settings = dict(engine.settings_of(cell.config), framing_mode=framing)
    with pytest.raises(NotImplementedError):
        engine.stabilize(_clip(cell, (3, 64, 96)), "flow", settings)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_the_api_equals_the_reference_on_a_short_720p_clip_on_the_card(cell, cuda):
    replays = fastpath.GRAPH_STATS["replays"]
    meta, ref, numbers = _api_against_reference(cell, _clip(cell, (17, 720, 1280), device=cuda), cuda)
    assert fastpath.GRAPH_STATS["replays"] == replays  # the eager route
    assert check.verdict(numbers, check.limits_of(cell.config_name)), numbers
    modes = [t["mode"] for t in meta["estimated_motion"]["per_transition"]]
    assert modes == ref.modes and modes.count("perspective") >= len(modes) // 2
    assert meta["camera_lock"] is True
