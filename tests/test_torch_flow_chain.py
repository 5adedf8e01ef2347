"""The Flow backend chain of the port (models/flow.py) against the JAX
package, on CPU: DIS -> TV-L1 -> phase correlation, the
``EstimationInterrupted`` shield and the rule that kernel failures are
not degraded.

The tiers are forced as tests/test_flow.py forces them: ``dis_flow_fit``
(and for the last tier ``tvl1_flow``) monkeypatched to raise, in both
packages.  Input: the 8-frame 144x192 shaken clip of
tests/test_torch_stabilize_flow.py; its grays are (8, 36, 48)
(working size, then the x4 pool), which the estimator cases hand to
both packages, so JAX compiles TV-L1 for one shape only.

Tolerances: ``flow_backend`` and ``flow_fallback_reason`` equal strings;
per-pair modes, acceptance and ``transform_mode_applied`` identical;
per-pair matrices <= 1e-3 (measured: 4e-5 on the TV-L1 tier, whose
dense flows differ by ulp-driven branch flips at single pixels, see
tests/test_torch_tvl1.py, and 2e-6 on the phase tier); frames p99
<= 1e-3, as the DIS slice test.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import cv2  # noqa: E402

from comfyui_video_stabilizer_tpu import nodes as JN  # noqa: E402
from comfyui_video_stabilizer_tpu.models import flow as JFL  # noqa: E402
from comfyui_video_stabilizer_tpu.ops import flow_dis as JFD  # noqa: E402
from comfyui_video_stabilizer_tpu.ops import resize as JR  # noqa: E402
from comfyui_video_stabilizer_tpu.ops import tvl1 as JTV  # noqa: E402
from comfyui_video_stabilizer_tpu.ops import warp as JW  # noqa: E402
from comfyui_video_stabilizer_tpu.utils import video_io as JIO  # noqa: E402
from comfyui_video_stabilizer_tpu_torch import nodes as TN  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.models import flow as TFL  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import cv_cuda as TCV  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import flow_dis as TFD  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import phase_corr as TPC  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import tvl1 as TTV  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import cuda_build  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops.cuda_build import KernelError  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.utils import video_io as TIO  # noqa: E402

GRAY = (127, 127, 127)
TIERS = ["TVL1", "phase_correlate"]
REASONS = {
    "TVL1": "DIS unavailable (synthetic backend outage); using TV-L1.",
    "phase_correlate": "DIS unavailable (synthetic backend outage; TV-L1 failed (synthetic backend outage)); "
                       "using phase correlation.",
}


def _scene(h, w, seed):
    rng = np.random.default_rng(seed)
    img = rng.random((h, w), np.float32)
    img = cv2.GaussianBlur(img, (0, 0), 2.5)
    img += 0.3 * cv2.GaussianBlur(rng.random((h, w), np.float32), (0, 0), 8.0)
    return (img - img.min()) / (img.max() - img.min())


def _outage(*_a, **_k):
    raise RuntimeError("synthetic backend outage")


def _force(mp, tier):
    """Make both packages' chains start at ``tier``."""
    for fd in (JFD, TFD):
        mp.setattr(fd, "dis_flow_fit", _outage)
    if tier == "phase_correlate":
        for tv in (JTV, TTV):
            mp.setattr(tv, "tvl1_flow", _outage)


@pytest.fixture(scope="module")
def clip():
    h, w, n = 144, 192, 8
    base = _scene(h + 80, w + 80, 8)
    rng = np.random.default_rng(9)
    mats = [np.eye(3)]
    for _ in range(n - 1):
        th = rng.uniform(-0.008, 0.008)
        t = rng.uniform(-2.5, 2.5, 2)
        d = np.array([[np.cos(th), -np.sin(th), t[0]], [np.sin(th), np.cos(th), t[1]], [0, 0, 1.0]])
        mats.append(d @ mats[-1])
    crop = np.eye(3)
    crop[0, 2] = crop[1, 2] = -40
    view = np.stack([crop @ np.linalg.inv(m) for m in mats])
    frames = np.asarray(JW.warp_clip(np.repeat(base[None, ..., None], n, 0), view, (w, h), "bilinear", (0.5,)))
    return np.repeat(frames, 3, axis=-1).astype(np.float32)


@pytest.fixture(scope="module")
def runs(clip):
    """Each forced tier through both packages' flow_estimator (similarity
    and perspective), stabilize_flow and Flow node."""
    grays = np.array(JR.gray_for_estimation(clip, None, decimation=4))
    args = ("crop_and_pad", "similarity", False, 0.9, 0.7, 0.6, GRAY, 16.0)
    node_args = (16.0, "crop_and_pad", "similarity", False, 0.9, 0.7, 0.6, "#7F7F7F")
    out = {}
    for tier in TIERS:
        with pytest.MonkeyPatch.context() as mp:
            _force(mp, tier)
            for mode in ("similarity", "perspective"):
                out[(tier, "estimator", mode)] = (
                    JFL.flow_estimator(grays, mode, decimation=4),
                    TFL.flow_estimator(torch.from_numpy(grays), mode, decimation=4))
            out[(tier, "stabilize_flow")] = (
                JFL.stabilize_flow(JIO.normalize_video_input(clip), *args),
                TFL.stabilize_flow(TIO.normalize_video_input(clip, device="cpu"), *args, device="cpu"))
            out[(tier, "node")] = (
                JN.VideoStabilizerFlow.execute(torch.from_numpy(clip.copy()), *node_args),
                TN.VideoStabilizerFlow.execute(torch.from_numpy(clip.copy()), *node_args, device="cpu"))
    return out


@pytest.mark.parametrize("mode", ["similarity", "perspective"])
@pytest.mark.parametrize("tier", TIERS)
def test_flow_estimator_tiers_match(runs, tier, mode):
    ref, ours = runs[(tier, "estimator", mode)]
    assert ours.extra_meta == ref.extra_meta == {"flow_backend": tier, "flow_fallback_reason": REASONS[tier]}
    assert list(ours.matrices) == list(ref.matrices)
    if tier == "phase_correlate":
        assert list(ours.matrices) == ["translation"]
    np.testing.assert_array_equal(ours.degenerate, ref.degenerate)
    for key in ref.matrices:
        np.testing.assert_array_equal(ours.accepted[key], ref.accepted[key])
        assert np.abs(ours.matrices[key] - ref.matrices[key]).max() <= 1e-3, key
        assert np.abs(np.asarray(ours.confidences[key]) - np.asarray(ref.confidences[key])).max() <= 1e-3
    assert ours.matrices["translation"].dtype == np.float32


def _transitions(meta):
    return meta["estimated_motion"]["per_transition"]


@pytest.mark.parametrize("entry", ["stabilize_flow", "node"])
@pytest.mark.parametrize("tier", TIERS)
def test_stabilizer_tiers_match(runs, tier, entry):
    ref, ours = runs[(tier, entry)]
    if entry == "node":
        (jf, jk, jm), (tf, tk, tm) = ref[:3], ours[:3]
        jf, tf = np.asarray(jf), tf.numpy()
    else:
        jf, jm, tm = np.asarray(ref.frames), ref.meta, ours.meta
        tf = ours.frames.numpy()
    assert tm["flow_backend"] == jm["flow_backend"] == tier
    assert tm["flow_fallback_reason"] == jm["flow_fallback_reason"] == REASONS[tier]
    assert tm["transform_mode_applied"] == jm["transform_mode_applied"]
    assert [t["mode"] for t in _transitions(tm)] == [t["mode"] for t in _transitions(jm)]
    jmat = np.array([t["matrix"] for t in _transitions(jm)])
    tmat = np.array([t["matrix"] for t in _transitions(tm)])
    assert np.abs(tmat - jmat).max() <= 1e-3
    d = np.abs(tf - jf)
    assert np.quantile(d, 0.99) <= 1e-3


def test_phase_tier_recovers_circular_shift(monkeypatch):
    """The last tier alone on a circular shift (exact for phase
    correlation): the translation, in working pixels after the x4
    decimation, within 0.1 px; degenerate all False, residuals 0,
    confidences = responses."""
    _force(monkeypatch, "phase_correlate")
    img = _scene(45, 60, 22).astype(np.float32) * 255.0
    grays = torch.from_numpy(np.stack([img, np.roll(np.roll(img, -1, axis=0), 2, axis=1)]))
    fits = TFL.flow_estimator(grays, "similarity", decimation=4)
    np.testing.assert_allclose(fits.matrices["translation"][0, :2, 2], [8.0, -4.0], atol=0.1)
    assert not fits.degenerate.any() and fits.accepted["translation"].all()
    assert (fits.residuals["translation"] == 0).all()
    _, resp = TPC.phase_correlate_batch(grays[:-1], grays[1:])
    np.testing.assert_array_equal(fits.confidences["translation"], resp)


def _kernel_error(*_a, **_k):
    raise KernelError("CUDA kernel 'cost_volume' failed to launch: error 9 (invalid configuration argument)")


def _accelerator_error(*_a, **_k):
    raise torch.AcceleratorError("CUDA error: an illegal memory access was encountered")


def _refused(I, *_a, **_k):
    # K2's wrapper given a tensor that is not on the card: its argument
    # check refuses it, as it refuses any argument K2 cannot take
    cuda_build.require_cuda_tensor("I", I, torch.float32, 3)


@pytest.mark.parametrize("where", ["dis_flow_fit", "cost_volume", "refused", "accelerator", "tvl1"])
def test_kernel_failures_are_not_degraded(monkeypatch, clip, where):
    """A KernelError from a kernel's build or launch, a wrapper's refusal
    of its arguments (a KernelError that is also a ValueError), or a CUDA
    runtime error, propagates out of flow_estimator and stabilize_flow;
    no later tier runs."""
    calls = []
    real_tvl1, real_phase = TTV.tvl1_flow, TPC.phase_correlate_batch
    monkeypatch.setattr(TTV, "tvl1_flow", lambda *a: calls.append("tvl1") or real_tvl1(*a))
    monkeypatch.setattr(TPC, "phase_correlate_batch", lambda *a: calls.append("phase") or real_phase(*a))
    if where == "dis_flow_fit":
        monkeypatch.setattr(TFD, "dis_flow_fit", _kernel_error)
    elif where == "cost_volume":
        monkeypatch.setattr(TCV, "cost_volume_subpixel", _kernel_error)
    elif where == "refused":
        monkeypatch.setattr(TCV, "cost_volume_subpixel", _refused)
    elif where == "accelerator":
        monkeypatch.setattr(TCV, "cost_volume_subpixel", _accelerator_error)
    else:
        monkeypatch.setattr(TFD, "dis_flow_fit", _outage)
        monkeypatch.setattr(TTV, "tvl1_flow", lambda *a: calls.append("tvl1") or _kernel_error())
    expected = torch.AcceleratorError if where == "accelerator" else KernelError
    grays = torch.from_numpy(np.array(JR.gray_for_estimation(clip, None, decimation=4)))
    with pytest.raises(expected) as info:
        TFL.flow_estimator(grays, "similarity", decimation=4)
    if where == "refused":
        assert isinstance(info.value, ValueError) and "must be a CUDA tensor" in str(info.value)
    with pytest.raises(expected):
        TFL.stabilize_flow(TIO.normalize_video_input(clip, device="cpu"), "crop_and_pad", "similarity",
                           False, 0.9, 0.7, 0.6, GRAY, 16.0, device="cpu")
    assert calls == (["tvl1", "tvl1"] if where == "tvl1" else []), calls


def test_out_of_memory_degrades(monkeypatch, clip):
    """Out-of-memory is not a kernel failure: it degrades as in the
    reference, and the reason names it."""
    def oom(*_a, **_k):
        raise torch.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(TFD, "dis_flow_fit", oom)
    grays = torch.from_numpy(np.array(JR.gray_for_estimation(clip, None, decimation=4)))
    fits = TFL.flow_estimator(grays, "similarity", decimation=4)
    assert fits.extra_meta == {"flow_backend": "TVL1",
                               "flow_fallback_reason": "DIS unavailable (CUDA out of memory); using TV-L1."}


@pytest.mark.parametrize("dis_fails_at", [None, 3])
def test_interrupt_aborts_within_one_estimation_chunk(monkeypatch, dis_fails_at):
    """A copy of tests/test_aux_subsystems.py's interrupt test on the port:
    256 frames, the interrupt raised at the third tick reaches the caller
    as its own type after exactly 3 ticks.  With DIS working, the third
    tick comes from inside the DIS tier (between 32-pair chunks), and the
    shield keeps the chain from taking it for a DIS failure: TV-L1 never
    runs.  With DIS failing at its third chunk, TV-L1 carries the
    estimation and the third tick is the engine's after it."""
    class Cancelled(Exception):
        pass

    state = {"ticks": 0, "dis": 0, "tvl1": 0}

    def interrupt():
        state["ticks"] += 1
        if state["ticks"] >= 3:
            raise Cancelled()

    real_dis, real_tvl1 = TFD.dis_flow_fit, TTV.tvl1_flow

    def dis(*a, **k):
        state["dis"] += 1
        if state["dis"] == dis_fails_at:
            raise RuntimeError("synthetic DIS outage")
        return real_dis(*a, **k)

    def tvl1(*a):
        state["tvl1"] += 1
        return real_tvl1(*a)

    monkeypatch.setattr(TFD, "dis_flow_fit", dis)
    monkeypatch.setattr(TTV, "tvl1_flow", tvl1)
    rng = np.random.default_rng(3)
    frames = rng.random((256, 48, 64, 3)).astype(np.float32)
    with pytest.raises(Cancelled):
        TFL.stabilize_flow(
            TIO.normalize_video_input(frames, device="cpu"), "crop_and_pad", "translation", False,
            0.7, 0.5, 0.6, (127, 127, 127), 16.0, interrupt_check=interrupt, device="cpu",
        )
    assert state["ticks"] == 3, state
    assert state["tvl1"] == (0 if dis_fails_at is None else 1), state
    assert state["dis"] == 3, state
