"""The port's span and counter recorder (``utils/profiling.py``) and the
spans at its layer boundaries.

On the CPU, at tiny sizes: off, a call records nothing and makes no
CUDA call; on, a node call gives the span tree with one call id, no
device time and ``meta["timing"]``; nothing is recorded while a CUDA
graph is captured; events turn into milliseconds only once they have
completed, and the recorder never waits for one; outputs and meta (but
``timing``) are bitwise equal with the recorder on and off.

The ``cuda`` case runs a Flow API call and a node call on the card
(``--noconftest``: this file imports no JAX):

    python -m pytest --noconftest tests/test_torch_profiling.py -q -m cuda
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

from comfyui_video_stabilizer_tpu_torch.models import fastpath  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.models import motion_apply as MA  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.models.flow import stabilize_flow  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.nodes import stabilizer_nodes as SN  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import cuda_build  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.utils import profiling as P  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.utils.video_io import normalize_video_input  # noqa: E402

NODES = {"flow": SN.VideoStabilizerFlow, "classic": SN.VideoStabilizerClassic}
WIDGETS = (16.0, "crop_and_pad", "similarity", False, 0.7, 0.5, 0.6, "#7F7F7F")

FAST_TREE = {
    "node.call": None, "io.ingest": "node.call", "io.ingest.copy": "io.ingest",
    "io.ingest.normalize": "io.ingest", "engine.call": "node.call", "fastpath.gray": "engine.call",
    "fastpath.estimate": "engine.call", "fastpath.warp": "engine.call", "fastpath.fetch": "engine.call",
    "engine.meta": "engine.call", "io.egress": "node.call", "io.egress.copy": "io.egress",
}
HOST_TREE = {**{k: v for k, v in FAST_TREE.items() if not k.startswith("fastpath.")},
             "engine.gray": "engine.call", "engine.estimate": "engine.call", "engine.warp": "engine.call"}
# Flow's DIS, under the estimation span of its engine; the fast path's
# eager Flow fits after it
DIS_TREE = {"flow.dis.chunk": None, "flow.dis.pyramid": "flow.dis.chunk"}
FITS_TREE = {"fastpath.fits": "fastpath.estimate"}


def _tree(kind, fast):
    tree = FAST_TREE if fast else HOST_TREE
    if kind != "flow":
        return tree
    return {**tree, **DIS_TREE, "flow.dis.chunk": "fastpath.estimate" if fast else "engine.estimate",
            **(FITS_TREE if fast else {})}


def _clip(n=5, h=64, w=80, seed=3):
    """A smooth textured scene shifted a few pixels a frame, plus noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h + 16, 0:w + 16].astype(np.float32)
    scene = np.stack([0.5 + 0.4 * np.sin(xx / 5.0 + c) * np.cos(yy / 7.0 - c) for c in range(3)], -1)
    shifts = rng.integers(0, 8, size=(n, 2))
    frames = np.stack([scene[dy:dy + h, dx:dx + w] for dy, dx in shifts])
    frames += rng.random(frames.shape, dtype=np.float32) * 0.02
    return torch.from_numpy(np.clip(frames, 0.0, 1.0).astype(np.float32))


@pytest.fixture
def recorder():
    """The recorder switched by the test, restored and emptied after it."""
    before = P.timing_enabled()
    P.drain()
    yield P
    P.enable_timing(before)
    P.drain()


def _node(kind, clip, device="cpu"):
    return NODES[kind].execute(clip, *WIDGETS, device=device)


def _refuse_cuda(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the recorder made a CUDA call")

    for name in ("Event", "current_stream", "is_current_stream_capturing", "synchronize"):
        monkeypatch.setattr(torch.cuda, name, refuse)


def test_off_a_call_records_nothing_and_makes_no_cuda_call(recorder, monkeypatch):
    monkeypatch.setenv("CVST_FASTPATH", "1")
    recorder.enable_timing(False)
    assert P.span("a") is P.span("b")  # the shared null context
    _refuse_cuda(monkeypatch)
    frames, masks, meta = _node("flow", _clip())
    assert "timing" not in meta
    assert P.drain() == []


@pytest.mark.parametrize("kind, fast", [("flow", True), ("flow", False), ("classic", True)])
def test_node_call_span_tree_on_the_cpu(recorder, monkeypatch, kind, fast):
    monkeypatch.setenv("CVST_FASTPATH", "1" if fast else "0")
    recorder.enable_timing(True)
    clip = _clip()
    frames, masks, meta = _node(kind, clip)
    recs = P.drain()
    tree = _tree(kind, fast)
    assert {r.name: r.parent for r in recs} == tree
    assert len({r.call for r in recs}) == 1
    assert all(r.device_ms is None and r.end_ns >= r.start_ns for r in recs)
    root = [r for r in recs if r.parent is None]
    assert [r.name for r in root] == ["node.call"]
    assert root[0].counters["fastpath.served"] == int(fast)
    assert root[0].counters["fastpath.replays"] == 0  # no graph on the CPU
    # on the CPU no byte crosses a device; the counters are there, at 0
    assert [r.counters for r in recs if r.name == "io.ingest.copy"] == [{"io.h2d_bytes": 0}]
    assert [r.counters for r in recs if r.name == "io.egress.copy"] == \
        [{"io.d2h_bytes": 0, "io.d2h_staged_bytes": 0, "io.d2h_reserved_bytes": 0}] * 2
    timing = meta["timing"]
    assert list(timing) == sorted(tree, key=lambda name: min(r.start_ns for r in recs if r.name == name))
    assert timing["io.egress.copy"]["n"] == 2 and timing["io.egress"]["parent"] == "node.call"
    assert all(v["device_ms"] is None and v["host_ms"] >= 0.0 for v in timing.values())
    json.dumps(timing)


def test_api_call_attaches_its_own_spans(recorder, monkeypatch):
    monkeypatch.setenv("CVST_FASTPATH", "1")
    recorder.enable_timing(True)
    context = normalize_video_input(_clip(), device="cpu")
    result = stabilize_flow(context, *WIDGETS[1:7], (127, 127, 127), 16.0, device="cpu")
    assert result.meta["timing"]["engine.call"]["parent"] is None
    assert set(result.meta["timing"]) == {k for k, v in FAST_TREE.items() if v and v.startswith("engine")} \
        | {"engine.call"} | set(DIS_TREE) | set(FITS_TREE)
    calls = {r.call for r in P.drain()}
    assert len(calls) == 2  # the ingest, then the engine: two roots


def test_motion_apply_attaches_its_spans(recorder):
    recorder.enable_timing(False)
    clip = _clip()
    _, _, meta = _node("flow", clip)
    context = normalize_video_input(clip, device="cpu")
    off = MA.apply_motion(context, meta, (127, 127, 127), device="cpu")
    assert "timing" not in off.meta
    recorder.enable_timing(True)
    on = MA.apply_motion(context, meta, (127, 127, 127), device="cpu")
    assert {k: v["parent"] for k, v in on.meta["timing"].items()} == {
        "motion_apply.call": None, "motion_apply.resolve_meta": "motion_apply.call",
        "motion_apply.warp": "motion_apply.call"}
    assert torch.equal(on.frames, off.frames) and torch.equal(on.masks, off.masks)


def test_nothing_is_recorded_while_a_graph_is_captured(recorder, monkeypatch):
    recorder.enable_timing(True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with P.span("outer") as s:
        s.count("k", 1)
        P.count("k", 1)
        with P.span("inner"):
            pass
    assert P.drain() == []
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    with P.span("outer"):
        P.count("k", 2)
    recs = P.drain()
    assert [(r.name, r.counters["k"]) for r in recs] == [("outer", 2)]


class _Event:
    """A stand-in for ``torch.cuda.Event``: completes when the test says."""

    done = False
    recorded = []

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.t = None

    def record(self, stream):
        _Event.recorded.append(self)
        self.t = len(_Event.recorded)

    def query(self):
        return _Event.done

    def elapsed_time(self, end):
        assert _Event.done, "elapsed_time on an event that has not completed"
        return float(end.t - self.t)

    def synchronize(self):
        raise AssertionError("the recorder waited on an event")


def test_device_time_resolves_lazily_and_never_waits(recorder, monkeypatch):
    recorder.enable_timing(True)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: "stream")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: pytest.fail("the recorder synchronised"))
    monkeypatch.setattr(_Event, "done", False)
    monkeypatch.setattr(_Event, "recorded", [])
    cuda = torch.device("cuda")
    with P.span("call", cuda) as root:
        with P.span("stage", cuda):
            pass
    meta = P.attach({}, root)
    assert meta["timing"]["call"]["device_ms"] is None  # pending: not waited for
    _Event.done = True
    recs = P.drain()
    assert [(r.name, r.device_ms) for r in recs] == [("stage", 1.0), ("call", 3.0)]
    assert all(r.events is None for r in recs)  # the events are dropped once read
    # events that never complete are dropped PENDING_CALLS calls later
    _Event.done = False
    with P.span("stuck", cuda):
        pass
    for _ in range(P.PENDING_CALLS):
        with P.span("next"):
            pass
    assert P._PENDING == []
    assert [r.device_ms for r in P.drain()] == [None] * (P.PENDING_CALLS + 1)


def test_the_ring_keeps_the_newest_records(recorder, monkeypatch):
    from collections import deque

    recorder.enable_timing(True)
    monkeypatch.setattr(P, "_RING", deque(maxlen=4))
    for i in range(6):
        with P.span(f"s{i}"):
            pass
    assert [r.name for r in P.drain()] == ["s2", "s3", "s4", "s5"]


@pytest.mark.parametrize("kind", ["flow", "classic"])
def test_outputs_and_meta_equal_with_the_recorder_on_and_off(recorder, monkeypatch, kind):
    monkeypatch.setenv("CVST_FASTPATH", "1")
    clip = _clip()
    recorder.enable_timing(False)
    off = _node(kind, clip)
    recorder.enable_timing(True)
    on = _node(kind, clip)
    assert torch.equal(on[0], off[0]) and torch.equal(on[1], off[1])
    timing = on[2].pop("timing")
    assert timing and json.dumps(on[2], sort_keys=True) == json.dumps(off[2], sort_keys=True)


def _counters(recs, name):
    return [r.counters for r in recs if r.name == name]


def test_gray_and_dis_counters_at_decimation_one(recorder, monkeypatch):
    """A Flow node call on 9 frames of 122 x 216 (2 mod 4 rows: no
    decimation, as at 864 x 486): one chunk of the whole clip, so one
    gray span, one DIS chunk with its own pyramid, under the estimation;
    the spans carry no counter (their bytes and pairs follow from the
    shapes)."""
    from comfyui_video_stabilizer_tpu_torch.models import stabilize as ST
    from comfyui_video_stabilizer_tpu_torch.models.flow import flow_estimator

    monkeypatch.setenv("CVST_FASTPATH", "1")
    recorder.enable_timing(True)
    n, h, w = 9, 122, 216
    assert ST.estimation_plan(w, h, flow_estimator) == (None, 1)
    assert ST.estimation_chunk_spans(n) == [(0, n, 0)]
    _node("flow", _clip(n=n, h=h, w=w))
    recs = P.drain()
    for span in ("fastpath.gray", "flow.dis.chunk", "flow.dis.pyramid", "fastpath.estimate"):
        assert _counters(recs, span) == [{}], span
    assert [r.parent for r in recs if r.name == "flow.dis.chunk"] == ["fastpath.estimate"]


def test_gray_counters_of_a_pooled_plan_and_the_host_engine(recorder, monkeypatch):
    """64 x 80 decimates Flow's gray by 4 and not Classic's; the fast path
    records its gray on ``fastpath.gray``, the host engine on
    ``engine.gray``, once a call and with no counter."""
    from comfyui_video_stabilizer_tpu_torch.models import stabilize as ST
    from comfyui_video_stabilizer_tpu_torch.models.classic import classic_estimator
    from comfyui_video_stabilizer_tpu_torch.models.flow import flow_estimator

    recorder.enable_timing(True)
    n, h, w = 5, 64, 80
    assert ST.estimation_plan(w, h, flow_estimator) == (None, 4)
    assert ST.estimation_plan(w, h, classic_estimator) == (None, 1)
    for fast, span in (("1", "fastpath.gray"), ("0", "engine.gray")):
        monkeypatch.setenv("CVST_FASTPATH", fast)
        _node("classic" if fast == "0" else "flow", _clip(n=n, h=h, w=w))
        recs = P.drain()
        assert _counters(recs, span) == [{}]
        assert not any(r.name.endswith(".gray") and r.name != span for r in recs)


@pytest.mark.parametrize("shards", [1, 2])
def test_dis_chunks_count_the_pairs_the_plan_gives(recorder, shards):
    """In 32-pair chunks with a tick (the node's eager path), each DIS
    dispatch receives the frames ``estimation_chunk_spans`` gives its
    shard, one ``flow.dis.chunk`` span (and pyramid) each: 40 frames in
    two chunks of 33, the last recomputing 25 pairs it drops; on shards
    of 22 and 18 frames, 23 (the first with its halo) and 18, a chunk
    each.  The ticks count the pairs done."""
    from comfyui_video_stabilizer_tpu_torch.models import flow as FL
    from comfyui_video_stabilizer_tpu_torch.models import stabilize as ST
    from comfyui_video_stabilizer_tpu_torch.ops import flow_dis as FD
    from comfyui_video_stabilizer_tpu_torch.parallel.mesh import FrameShards

    recorder.enable_timing(True)
    grays = torch.floor(torch.rand((40, 30, 40), generator=torch.Generator().manual_seed(5)) * 255.0)
    sizes = [40] if shards == 1 else [23, 18]
    if shards == 2:
        grays = FrameShards([grays[:22], grays[22:]])
    frames, ticks = [], []

    def dis(g, *a, **k):
        frames.append(int(g.shape[0]))
        return FD.dis_flow_fit(g, *a, **k)

    samples = FL._dis_samples_chunked(grays, 8, 2, "similarity", ticks.append, dis)
    recs = P.drain()
    assert frames == [e - s for n in sizes for s, e, _ in ST.estimation_chunk_spans(n)]
    assert frames == ([33, 33] if shards == 1 else [23, 18])
    assert len(_counters(recs, "flow.dis.chunk")) == len(_counters(recs, "flow.dis.pyramid")) == len(frames)
    assert ticks == ([32, 39] if shards == 1 else [22, 39]) and samples.shape[0] == 39


def test_off_the_new_spans_are_the_shared_null_context(recorder, monkeypatch):
    monkeypatch.setenv("CVST_FASTPATH", "1")
    recorder.enable_timing(False)
    assert P.span("flow.dis.chunk") is P.span("flow.dis.pyramid") is P._NULL
    _refuse_cuda(monkeypatch)
    _, _, meta = _node("flow", _clip(n=5, h=122, w=216))
    assert "timing" not in meta and P.drain() == []


PERSP_WIDGETS = (24.0, "crop_and_pad", "perspective", True, 0.7, 0.5, 0.6, "#7F7F7F")


@pytest.mark.parametrize("fast, on", [(True, True), (False, True), (True, False)],
                         ids=["fast-path", "host-engine", "off"])
def test_a_perspective_call_on_an_area_resized_gray(recorder, monkeypatch, fast, on):
    """A locked perspective Flow call on 5 frames of 40 x 1000: the longest
    side over 960 gives a working size of 960 x 38, which no integer pool
    of the clip gives, so the gray goes through the area weights in
    ``gray.area_resize``, under the engine's gray span; the fast path's
    eager fits record ``fastpath.fits``, and its fetch counts the
    transitions kept in perspective.  Off, nothing is recorded and no
    CUDA call made."""
    monkeypatch.setenv("CVST_FASTPATH", "1" if fast else "0")
    recorder.enable_timing(on)
    if not on:
        _refuse_cuda(monkeypatch)
    _, _, meta = SN.VideoStabilizerFlow.execute(_clip(n=5, h=40, w=1000), *PERSP_WIDGETS, device="cpu")
    recs = P.drain()
    if not on:
        assert "timing" not in meta and recs == []
        return
    timing = meta["timing"]
    assert timing["gray.area_resize"]["parent"] == ("fastpath.gray" if fast else "engine.gray")
    assert len(_counters(recs, "gray.area_resize")) == 1
    modes = [t["mode"] for t in meta["estimated_motion"]["per_transition"]]
    assert meta["camera_lock"] is True and modes.count("perspective") > 0
    if fast:
        assert timing["fastpath.fits"]["parent"] == "fastpath.estimate"
        assert timing["fastpath.fetch"]["fastpath.persp_transitions"] == modes.count("perspective")
    else:
        assert not any(name.startswith("fastpath.") for name in timing)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_spans_on_the_card_take_device_time_and_never_wait(recorder, monkeypatch, cuda):
    """A Flow API call from its graph: ``fastpath.estimate`` has device time,
    a replay launches what it launched with the recorder off, and the
    recorder neither synchronises nor waits on an event; a node call
    counts the bytes its copies move."""
    clip = _clip(n=9, h=270, w=480)
    args = (*WIDGETS[1:7], (127, 127, 127), 16.0)
    context = normalize_video_input(clip.to(cuda), device=cuda)
    fastpath.clear_graph_cache()
    recorder.enable_timing(False)
    stabilize_flow(context, *args, device=cuda)  # capture
    before = dict(cuda_build.LAUNCHES)
    stabilize_flow(context, *args, device=cuda)
    launched_off = {k: cuda_build.LAUNCHES[k] - before[k] for k in before}
    torch.cuda.synchronize()

    recorder.enable_timing(True)
    waits = []
    sync, event_sync = torch.cuda.synchronize, torch.cuda.Event.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: waits.append("synchronize") or sync(*a, **k))
    monkeypatch.setattr(torch.cuda.Event, "synchronize",
                        lambda self: waits.append("Event.synchronize") or event_sync(self))
    replays = fastpath.GRAPH_STATS["replays"]
    before = dict(cuda_build.LAUNCHES)
    result = stabilize_flow(context, *args, device=cuda)
    launched_on = {k: cuda_build.LAUNCHES[k] - before[k] for k in before}
    assert waits == []
    monkeypatch.undo()
    assert fastpath.GRAPH_STATS["replays"] == replays + 1 and launched_on == launched_off
    assert "fastpath.estimate" in result.meta["timing"]
    torch.cuda.synchronize()
    recs = P.drain()
    est = [r for r in recs if r.name == "fastpath.estimate"]
    assert len(est) == 1 and est[0].device_ms > 0.0
    root = [r for r in recs if r.parent is None]
    assert [r.name for r in root] == ["engine.call"] and root[0].counters["fastpath.replays"] == 1

    frames, masks, meta = _node("flow", clip, device="cuda")
    torch.cuda.synchronize()
    recs = P.drain()
    assert sum(r.counters.get("io.h2d_bytes", 0) for r in recs) == clip.nbytes
    assert sum(r.counters.get("io.d2h_bytes", 0) for r in recs) == frames.nbytes + masks.nbytes
    assert sum(r.counters.get("io.d2h_staged_bytes", 0) for r in recs) == frames.nbytes + masks.nbytes
    assert sum(r.counters.get("io.d2h_reserved_bytes", 0) for r in recs) == frames.nbytes + masks.nbytes
    assert meta["timing"]["node.call"]["fastpath.served"] == 1
    assert all(r.device_ms is not None for r in recs if r.name.startswith(("io.ingest", "io.egress.", "fastpath.")))


@pytest.mark.cuda
def test_a_replay_counts_its_dis_level_pairs_and_records_no_span_inside(recorder, cuda):
    """A Flow API call at 864 x 486 from its graph: ``fastpath.estimate``
    counts the capture on the capture call and nothing else on either
    call (its pairs and levels follow from the shapes); the capture
    call's only DIS spans are its eager warm-up's, and the replay records
    none."""
    clip = _clip(n=81, h=486, w=864)
    args = (*WIDGETS[1:7], (127, 127, 127), 16.0)
    context = normalize_video_input(clip.to(cuda), device=cuda)
    fastpath.clear_graph_cache()
    recorder.enable_timing(True)
    replays = fastpath.GRAPH_STATS["replays"]
    stabilize_flow(context, *args, device=cuda)  # warm-up, capture, replay
    stabilize_flow(context, *args, device=cuda)  # replay
    torch.cuda.synchronize()
    assert fastpath.GRAPH_STATS["replays"] == replays + 2
    recs = P.drain()
    calls = sorted({r.call for r in recs if r.name == "engine.call"})
    assert len(calls) == 2
    for call, captured in zip(calls, (1, 0)):
        mine = [r for r in recs if r.call == call]
        est = _counters(mine, "fastpath.estimate")
        assert len(est) == 1 and est[0] == ({"fastpath.capture": 1} if captured else {})
        dis_spans = captured  # the warm-up's, eager on its side stream
        assert len(_counters(mine, "flow.dis.chunk")) == len(_counters(mine, "flow.dis.pyramid")) == dis_spans
        assert _counters(mine, "fastpath.gray") == [{}]
