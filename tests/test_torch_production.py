"""The production engines sharded over a device mesh: the port against
itself unsharded and against the JAX package's sharded engines.

Inputs: the JAX tests' shaken clips (tests/test_parallel.py's
``_shake_frames``, 64 x 96, made with numpy from a seed), 16 frames on
the 8-entry mesh (two a shard), 9 and 2 frames (uneven: the "rows"
outcome, which on a spatial axis of 1 is one band, so the lead device).
The JAX package runs on the 8 virtual CPU devices of tests/conftest.py;
the port on a mesh that repeats the CPU device, its plain versions on
each shard.  The JAX runs are made once per module.

Tolerances:
* port sharded against port unsharded: ``torch.equal`` on frames and
  masks, and the meta equal (modes, per-pair and applied matrices,
  padding fractions): each pair and each frame is computed from the
  inputs an unsharded call uses, and the RANSAC keys fold in the global
  pair index;
* port sharded against JAX sharded, the tolerances of
  tests/test_torch_stabilize_flow.py: modes identical; per-pair and
  applied matrices <= 1e-3; frames p99 <= 1e-3 and max <= 1e-2; masks
  unequal on <= 1e-3 of the pixels.
"""

import contextlib
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

from comfyui_video_stabilizer_tpu.parallel import mesh as JM  # noqa: E402
from comfyui_video_stabilizer_tpu.parallel import production as JPR  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.models import fastpath as TFP  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.models import flow as TFL  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.models import classic as TCL  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.models import stabilize as TST  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import cuda_build  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import flow_dis as TFD  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import lk as TLK  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import ransac as TRS  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import resize as TR  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import warp as TW  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.parallel import mesh as TM  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.parallel import production as TPR  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.utils import meshinfo as TMI  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.utils import video_io as TIO  # noqa: E402
from test_parallel import _shake_frames  # noqa: E402

CPU8 = ["cpu"] * 8
ARGS = ("crop_and_pad", "similarity", False, 0.9, 0.6, 0.6, (127, 127, 127), 16.0)
ENGINES = {"flow": (TPR.stabilize_flow_sharded, TFL.stabilize_flow),
           "classic": (TPR.stabilize_classic_sharded, TCL.stabilize_classic)}


@contextlib.contextmanager
def fastpath(flag):
    """CVST_FASTPATH set to ``flag`` ("0": the host engine, "1": the fast
    path on the CPU) inside the block."""
    before = os.environ.get("CVST_FASTPATH")
    os.environ["CVST_FASTPATH"] = flag
    try:
        yield
    finally:
        if before is None:
            del os.environ["CVST_FASTPATH"]
        else:
            os.environ["CVST_FASTPATH"] = before


def _unsharded(kind, frames, framing="crop_and_pad"):
    args = (framing,) + ARGS[1:]
    return ENGINES[kind][1](TIO.normalize_video_input(torch.from_numpy(frames), device="cpu"), *args,
                            device="cpu")


def _whole(x):
    return x.gather() if isinstance(x, TM.FrameShards) else x


def _transitions(meta):
    return meta["estimated_motion"]["per_transition"]


def _applied(meta):
    return np.array([e["applied_matrix"] for e in meta["stabilization_warp"]["per_frame"]])


@pytest.fixture(scope="module")
def clips():
    return {n: _shake_frames(n, 64, 96, seed=n) for n in (16, 9, 2)}


@pytest.fixture(scope="module")
def jax_runs(clips):
    """The JAX package's sharded engines on its 8-device mesh."""
    mesh = JM.make_mesh(8)
    out = {("flow", n): JPR.stabilize_flow_sharded(clips[n], mesh) for n in (16, 9, 2)}
    out[("classic", 16)] = JPR.stabilize_classic_sharded(clips[16], mesh)
    return out


@pytest.fixture(scope="module")
def port_runs(clips):
    """(sharded, unsharded) port results by (kind, n, CVST_FASTPATH).  An
    uneven clip defers the fast path to the host engine, so its
    reference is the unsharded host engine."""
    mesh = TM.make_mesh(devices=CPU8)
    out = {}
    for kind, n in (("flow", 16), ("flow", 9), ("flow", 2), ("classic", 16), ("classic", 9), ("classic", 2)):
        for flag in ("0", "1"):
            with fastpath(flag):
                sharded = ENGINES[kind][0](clips[n], mesh)
            with fastpath(flag if n % 8 == 0 else "0"):
                ref = _unsharded(kind, clips[n])
            out[(kind, n, flag)] = (sharded, ref)
    return out


@pytest.mark.parametrize("n", [16, 9, 2, 12])
@pytest.mark.parametrize("h", [64, 63])
@pytest.mark.parametrize("spatial", [1, 2, 4, 8])
def test_input_partition_spec_matches_jax(n, h, spatial):
    ref = JPR.input_partition_spec(JM.make_mesh(8, spatial=spatial), n, h)
    ours = TPR.input_partition_spec(TM.make_mesh(devices=CPU8, spatial=spatial), n, h)
    assert ours == tuple(ref)


@pytest.mark.parametrize("flag", ["0", "1"])
@pytest.mark.parametrize("kind,n", [("flow", 16), ("flow", 9), ("flow", 2), ("classic", 16), ("classic", 9),
                                    ("classic", 2)])
def test_sharded_equals_unsharded(port_runs, kind, n, flag):
    sharded, ref = port_runs[(kind, n, flag)]
    assert torch.equal(_whole(sharded.frames), ref.frames)
    assert torch.equal(_whole(sharded.masks), ref.masks)
    assert sharded.meta == ref.meta
    assert isinstance(sharded.frames, TM.FrameShards) == (n == 16)


@pytest.mark.parametrize("kind,n", [("flow", 16), ("flow", 9), ("flow", 2), ("classic", 16)])
def test_sharded_matches_jax_sharded(jax_runs, port_runs, kind, n):
    ref = jax_runs[(kind, n)]
    ours, _ = port_runs[(kind, n, "0")]
    jt, tt = _transitions(ref.meta), _transitions(ours.meta)
    assert [t["mode"] for t in tt] == [t["mode"] for t in jt]
    if jt:
        assert np.abs(np.array([t["matrix"] for t in tt]) - np.array([t["matrix"] for t in jt])).max() <= 1e-3
    assert np.abs(_applied(ours.meta) - _applied(ref.meta)).max() <= 1e-3
    d = np.abs(np.asarray(ours.frames) - np.asarray(ref.frames))
    assert np.quantile(d, 0.99) <= 1e-3 and d.max() <= 1e-2
    assert (np.asarray(ours.masks) != np.asarray(ref.masks)).mean() <= 1e-3
    assert ours.meta.get("flow_backend") == ref.meta.get("flow_backend")


@pytest.mark.parametrize("flag", ["0", "1"])
@pytest.mark.parametrize("kind", ["flow", "classic"])
def test_outputs_stay_partitioned(port_runs, kind, flag):
    """Each FrameShards entry holds n/data frames (and their masks) on its
    own mesh entry: nothing gathers the clip onto one device."""
    mesh = TM.make_mesh(devices=CPU8)
    sharded, _ = port_runs[(kind, 16, flag)]
    for out, tail in ((sharded.frames, (64, 96, 3)), (sharded.masks, (64, 96))):
        assert isinstance(out, TM.FrameShards) and out.axis == 0
        assert [tuple(s.shape) for s in out.shards] == [(2,) + tail] * 8
        assert out.devices == list(mesh.devices[:, 0])


def test_fast_path_took_the_mesh_branch(clips):
    served = dict(TFP.SERVED)
    with fastpath("1"):
        res = TPR.stabilize_flow_sharded(clips[16], TM.make_mesh(devices=CPU8))
        TPR.stabilize_flow_sharded(clips[9], TM.make_mesh(devices=CPU8))
    assert isinstance(res.frames, TM.FrameShards)
    assert TFP.SERVED["flow"] == served["flow"] + 1 and TFP.SERVED["mesh"] == served["mesh"] + 1


@pytest.mark.parametrize("kind", ["flow", "classic"])
@pytest.mark.parametrize("n", [9, 16])
def test_spatial_mesh(clips, kind, n):
    """On a (2, 4) mesh, 16 frames split over the data axis (2 shards) and
    9 frames take the rows outcome: 4 bands of output rows, K1 and the
    masks by band; both torch.equal to the unsharded host engine."""
    mesh = TM.make_mesh(devices=CPU8, spatial=4)
    with fastpath("0"):
        ours = ENGINES[kind][0](clips[n], mesh)
        ref = _unsharded(kind, clips[n])
    axis, parts = (1, 4) if n == 9 else (0, 2)
    for out in (ours.frames, ours.masks):
        assert isinstance(out, TM.FrameShards) and out.axis == axis and len(out.shards) == parts
    assert [tuple(s.shape[:2]) for s in ours.frames.shards] == (
        [(9, 16)] * 4 if n == 9 else [(8, 64)] * 2)
    assert torch.equal(ours.frames.gather(), ref.frames) and torch.equal(ours.masks.gather(), ref.masks)
    assert ours.meta == ref.meta


def test_ransac_keys_use_the_global_pair_index(clips):
    """The fits of shard-local pair indices differ from the global ones on
    this clip, so the equality of sharded and unsharded runs (above) holds
    only because every pair is fitted with its global key."""
    grays = TR.gray_for_estimation(torch.from_numpy(clips[16]), None)
    samples = TFD.dis_flow_fit(grays, TFL.SAMPLE_STEP)
    pts = TFL._grid_points(64, 96, TFL.SAMPLE_STEP, "cpu")
    full = TFL._fused_fits_device(samples, pts, 0, False, TRS.DEFAULT_HYPOTHESES)
    local = [TFL._fused_fits_device(samples[s:s + 2], pts, 0, False, TRS.DEFAULT_HYPOTHESES)
             for s in range(0, 15, 2)]
    assert not torch.equal(torch.cat([part[1] for part in local]), full[1])
    shards = TM.split_frames(grays, CPU8)
    gathered = TST.chunked_pairs(shards, lambda g: TFD.dis_flow_fit(g, TFL.SAMPLE_STEP), None)
    assert torch.equal(gathered, samples)
    assert torch.equal(TFL._fused_fits_device(gathered, pts, 0, False, TRS.DEFAULT_HYPOTHESES)[1], full[1])


def _raise_on_call(real, at):
    calls = []

    def wrapped(*a, **k):
        calls.append(1)
        if len(calls) == at:
            raise cuda_build.KernelError("synthetic refused launch in a shard")
        return real(*a, **k)

    return wrapped


@pytest.mark.parametrize("flag", ["0", "1"])
def test_kernel_error_in_a_flow_shard_reaches_the_caller(clips, monkeypatch, flag):
    monkeypatch.setattr(TFD, "dis_flow_fit", _raise_on_call(TFD.dis_flow_fit, 3))
    with fastpath(flag), pytest.raises(cuda_build.KernelError, match="synthetic"):
        TPR.stabilize_flow_sharded(clips[16], TM.make_mesh(devices=CPU8))


@pytest.mark.parametrize("flag", ["0", "1"])
def test_kernel_error_in_a_classic_shard_reaches_the_caller(clips, monkeypatch, flag):
    monkeypatch.setattr(TLK, "gftt_batch", _raise_on_call(TLK.gftt_batch, 5))
    with fastpath(flag), pytest.raises(cuda_build.KernelError, match="synthetic"):
        TPR.stabilize_classic_sharded(clips[16], TM.make_mesh(devices=CPU8))


@pytest.mark.parametrize("kind", ["flow", "classic"])
def test_progress_and_interrupt_under_a_mesh(clips, kind):
    """Ticks by shard count global pairs and end at the total; a tick's
    exception reaches the caller as itself."""
    mesh = TM.make_mesh(devices=CPU8)
    ticks = []
    ctx = TPR.sharded_video_context(clips[16], mesh)
    with TMI.set_mesh(mesh):
        res = ENGINES[kind][1](ctx, *ARGS, progress=lambda d, t: ticks.append((d, t)), device="cpu")
    assert ticks[-1] == (31, 31) and all(t == 31 for _, t in ticks)
    assert [d for d, _ in ticks] == sorted(d for d, _ in ticks) and (15, 31) in ticks
    assert torch.equal(res.frames.gather(), _unsharded(kind, clips[16]).frames)

    class Stop(Exception):
        pass

    def interrupt():
        raise Stop()

    with TMI.set_mesh(mesh), pytest.raises(Stop):
        ENGINES[kind][1](ctx, *ARGS, interrupt_check=interrupt, device="cpu")


@pytest.mark.parametrize("framing", ["crop", "expand"])
def test_crop_defers_and_expand_shards(clips, framing):
    """Under a mesh the fast path serves expand by shard and leaves crop to
    the host engine (as the JAX package); both equal their unsharded
    references."""
    served = dict(TFP.SERVED)
    with fastpath("1"):
        ours = TPR.stabilize_flow_sharded(clips[16], TM.make_mesh(devices=CPU8), framing_mode=framing)
    with fastpath("1" if framing == "expand" else "0"):
        ref = _unsharded("flow", clips[16], framing)
    assert TFP.SERVED["mesh"] == served["mesh"] + (framing == "expand")
    assert torch.equal(ours.frames.gather(), ref.frames) and torch.equal(ours.masks.gather(), ref.masks)
    assert ours.meta == ref.meta


def test_no_copies_on_a_repeated_device(clips):
    TM.reset_transfers()
    TPR.stabilize_flow_sharded(clips[16], TM.make_mesh(devices=CPU8))
    assert TM.TRANSFERS == {"halo": 0, "gather": 0, "scatter": 0}


def test_sharded_context_layouts(clips):
    mesh = TM.make_mesh(devices=CPU8)
    ctx = TPR.sharded_video_context(clips[16], mesh, fps=24.0)
    assert isinstance(ctx.frames, TM.FrameShards) and ctx.frame_count == 16 and ctx.fps == 24.0
    assert (ctx.width, ctx.height, ctx.channels) == (96, 64, 3)
    ctx9 = TPR.sharded_video_context(clips[9], mesh)
    assert isinstance(ctx9.frames, torch.Tensor) and ctx9.frames.device == mesh.lead


def test_streamed_clip_on_a_mesh(clips, monkeypatch):
    """A clip whose warp streams stays on the host; its time chunks split
    over the data axis; the host result equals the unsharded streamed
    and unstreamed runs."""
    with fastpath("0"):
        ref = _unsharded("flow", clips[16])
    monkeypatch.setattr(TW, "CHUNK_BUDGET_BYTES", TW.clip_device_bytes(5, 64, 96, 64, 96))
    with fastpath("0"):
        ours = TPR.stabilize_flow_sharded(clips[16], TM.make_mesh(devices=CPU8))
    assert isinstance(ours.frames, torch.Tensor) and ours.frames.device.type == "cpu"
    assert torch.equal(ours.frames, ref.frames) and torch.equal(ours.masks, ref.masks)
    assert ours.meta == ref.meta


def test_sharded_flow_check_passes():
    TPR.sharded_stabilize_flow_check(TM.make_mesh(devices=CPU8))
