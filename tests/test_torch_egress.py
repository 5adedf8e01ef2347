"""The node's egress (``utils/video_io.py``): frames and masks to the host.

A contiguous float32 CUDA tensor goes through its device's ring of
pinned slots (``plan_chunks`` cuts it, ``_staged_to_cpu`` pipelines it
into new memory from ``_new_host_f32``);
everything else takes the one ``.to("cpu", torch.float32)`` it took
before the ring.  On the CPU: the chunk planner, the new output memory,
the ring's loop on stand-in slots and events, and every input the ring does not serve,
bitwise what the plain copy returns, with ``io.d2h_staged_bytes`` at 0.  The node's
reserved outputs (``reserve_host_outputs``): their shapes against ``_normalize_batch``'s,
the calls that reserve nothing, the ring placing into one, and one dropped, abandoned or
whose mapping raised.

The ``cuda`` cases hold the ring to ``.cpu()`` bitwise on the card, at
sizes below a slot and past the whole ring, after work still queued on
the stream, with no device memory allocated, and count the bytes of a
node call, placed into reserved outputs, bitwise those of a call that
reserves nothing (``--noconftest``: this file imports no JAX):

    python -m pytest --noconftest tests/test_torch_egress.py -q -m cuda
"""

import errno
import gc
import json
import mmap
import sys
import threading
import types
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from comfyui_video_stabilizer_tpu_torch.nodes import stabilizer_nodes as SN  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import warp as W  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.parallel.mesh import FrameShards, make_mesh  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.utils import meshinfo  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.utils import profiling as P  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.utils import video_io as V  # noqa: E402

SLOT = V.RING_SLOT_BYTES // 4  # float32 elements a slot
LENGTHS = {
    "one_element": 1,
    "one_slot": SLOT,
    "one_slot_plus_one": SLOT + 1,
    "one_4k_frame": 2160 * 3840 * 3,
    "81_1080p_frames": 81 * 1080 * 1920 * 3,
    "81_1080p_masks": 81 * 1080 * 1920,
}


@pytest.mark.parametrize("slots", [2, 4])
@pytest.mark.parametrize("length", list(LENGTHS))
def test_chunk_plan_covers_the_range_in_order(length, slots):
    n = LENGTHS[length]
    plan = V.plan_chunks(n, SLOT, slots)
    assert plan[0][1] == 0 and plan[-1][2] == n
    assert all(prev[2] == cur[1] for prev, cur in zip(plan, plan[1:]))  # no gap, no overlap
    assert all(0 < b - a <= SLOT for _, a, b in plan)
    assert [slot for slot, _, _ in plan] == [i % slots for i in range(len(plan))]
    assert len(plan) == -(-n // SLOT)


def test_chunk_plan_of_nothing_is_empty():
    assert V.plan_chunks(0, SLOT, 3) == []


@pytest.mark.parametrize("populate", [True, False])
@pytest.mark.parametrize("shape", [(), (1,), (3, 5, 7), (2, 1081, 1923), (0, 4)])
def test_new_host_output_is_float32_contiguous_and_lives_with_its_tensor(monkeypatch, shape, populate):
    """The ring's output: a contiguous float32 CPU tensor of the shape, its
    memory freed with its storage (a view keeps it); without
    ``MAP_POPULATE`` (or with no bytes) it is ``torch.empty``'s."""
    if not populate:
        monkeypatch.setattr(V, "_MAP_POPULATE", None)
    t = V._new_host_f32(shape)
    assert t.shape == shape and t.dtype == torch.float32 and t.device.type == "cpu" and t.is_contiguous()
    t.fill_(1.5)
    tail = t.view(-1)[-3:]
    del t
    gc.collect()
    assert torch.equal(tail, torch.full_like(tail, 1.5))


@pytest.fixture
def recorder():
    """The recorder on for the test, restored and emptied after it."""
    before = P.timing_enabled()
    P.drain()
    P.enable_timing(True)
    yield P
    P.enable_timing(before)
    P.drain()


def _plain_to_cpu_f32(x, reserved=None):
    """The egress's copy before the ring: one ``.to("cpu", torch.float32)``
    (these inputs come with no reservation)."""
    assert reserved is None
    if isinstance(x, FrameShards):
        x = x.gather("cpu")
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    return t.detach().to("cpu", torch.float32).contiguous()


def _bits(t):
    return t.contiguous().view(torch.int32)


def _frames(n=4, h=6, w=10, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((n, h, w, 3), generator=g)


FRAME_INPUTS = {
    "cpu_tensor": lambda: _frames(),
    "frame_list": lambda: list(_frames()),
    "frame_shards": lambda: FrameShards([_frames()[:1], _frames()[1:]]),
    "float64": lambda: _frames().double() / 3.0,
    "float16": lambda: _frames().half(),
    "non_contiguous": lambda: _frames(w=20)[:, :, ::2],
    "numpy": lambda: _frames().numpy(),
}
MASK_INPUTS = {
    "cpu_tensor": lambda: _frames()[..., 0].contiguous(),
    "one_channel": lambda: _frames()[..., :1].contiguous(),
    "frame_list": lambda: list(_frames()[..., 0]),
    "frame_list_one_channel": lambda: list(_frames()[..., :1]),
    "frame_shards": lambda: FrameShards([_frames()[:3, ..., 0], _frames()[3:, ..., 0]]),
    "float64": lambda: _frames()[..., 0].double() / 3.0,
    "uint8": lambda: (_frames()[..., 0] > 0.5).to(torch.uint8),
    "non_contiguous": lambda: _frames()[..., 1],
}


def _egress_records():
    return [r.counters for r in P.drain() if r.name == "io.egress.copy"]


@pytest.mark.parametrize("template", ["sequence", "dict"])
@pytest.mark.parametrize("kind", list(FRAME_INPUTS))
def test_frames_the_ring_does_not_serve_come_back_as_before(recorder, monkeypatch, kind, template):
    clip = _frames()
    context = V.normalize_video_input({"frames": clip, "fps": 12.0} if template == "dict" else clip, device="cpu")
    out = V.reconstruct_video(FRAME_INPUTS[kind](), context)
    records = _egress_records()
    with monkeypatch.context() as m:
        m.setattr(V, "_to_cpu_f32", _plain_to_cpu_f32)
        before = V.reconstruct_video(FRAME_INPUTS[kind](), context)
    if template == "dict":
        assert out.keys() == before.keys() and out["fps"] == 12.0
        out, before = out["frames"], before["frames"]
    assert out.dtype == torch.float32 and out.is_contiguous() and out.shape == before.shape
    assert torch.equal(_bits(out), _bits(before))
    assert records and all(r == {"io.d2h_bytes": 0, "io.d2h_staged_bytes": 0, "io.d2h_reserved_bytes": 0}
                           for r in records)


@pytest.mark.parametrize("kind", list(MASK_INPUTS))
def test_masks_the_ring_does_not_serve_come_back_as_before(recorder, monkeypatch, kind):
    out = V.convert_masks_for_output(MASK_INPUTS[kind]())
    records = _egress_records()
    with monkeypatch.context() as m:
        m.setattr(V, "_to_cpu_f32", _plain_to_cpu_f32)
        before = V.convert_masks_for_output(MASK_INPUTS[kind]())
    assert out.dtype == torch.float32 and out.is_contiguous() and out.shape == before.shape
    assert out.ndim == 3 and torch.equal(_bits(out), _bits(before))
    assert records and all(r == {"io.d2h_bytes": 0, "io.d2h_staged_bytes": 0, "io.d2h_reserved_bytes": 0}
                           for r in records)


class _Event:
    """A stand-in for a slot's ``torch.cuda.Event``: logs what the ring does."""

    def __init__(self, log, slot):
        self.log, self.slot = log, slot

    def record(self, stream):
        self.log.append(("queued", self.slot))

    def synchronize(self):
        self.log.append(("waited", self.slot))


class _Stream:
    synchronized = 0

    def synchronize(self):
        self.synchronized += 1


class _Ring:
    """The ring's shape with unpinned CPU slots of ``slot_elems``."""

    def __init__(self, slots, slot_elems):
        self.lock = threading.Lock()
        self.log = []
        self.slots = [torch.full((slot_elems,), float("nan")) for _ in range(slots)]
        self.copied = [_Event(self.log, i) for i in range(slots)]


def _stand_in_ring(monkeypatch, slots, slot_elems):
    ring, stream = _Ring(slots, slot_elems), _Stream()
    monkeypatch.setattr(V, "_ring", lambda device: ring)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: stream)
    return ring, stream


@pytest.mark.parametrize("slots", [2, 3, 4])
@pytest.mark.parametrize("n", [1, 6, 7, 8, 29, 64])
def test_ring_loop_places_every_chunk_and_refills_a_slot_only_after_its_host_copy(monkeypatch, slots, n):
    """The ring's loop on CPU slots of 7 elements: the output is the source
    bitwise; the first ``slots`` copies are queued before the host's first
    wait, so that many stay in flight; a slot is queued again only after
    the host waited for it (and placed it), and every queued copy is
    waited for before the egress returns."""
    ring, stream = _stand_in_ring(monkeypatch, slots, 7)
    src = torch.randn(n, 3) if n % 2 else torch.randn(n)
    out = V._staged_to_cpu(src)
    assert out.shape == src.shape and out.dtype == torch.float32 and out.is_contiguous()
    assert torch.equal(_bits(out), _bits(src))
    chunks = -(-src.numel() // 7)
    first_wait = ring.log.index(("waited", 0))
    assert ring.log[:first_wait] == [("queued", i) for i in range(min(slots, chunks))]
    for slot in range(slots):
        seen = [what for what, s in ring.log if s == slot]
        assert seen == ["queued", "waited"] * len(seen[::2])
    assert sum(1 for what, _ in ring.log if what == "queued") == chunks
    assert stream.synchronized == 0 and not ring.lock.locked()


def test_ring_interrupted_waits_for_its_copies_and_frees_the_slots(monkeypatch):
    ring, stream = _stand_in_ring(monkeypatch, 3, 7)

    def interrupted():
        raise KeyboardInterrupt

    ring.copied[1].synchronize = interrupted
    with pytest.raises(KeyboardInterrupt):
        V._staged_to_cpu(torch.randn(40))
    assert stream.synchronized == 1 and not ring.lock.locked()


def test_ring_serves_one_egress_at_a_time_under_threads(monkeypatch):
    """More callers than cores on one ring, with a short switch interval:
    each gets its own source back bitwise, so no two shared a slot."""
    ring, _ = _stand_in_ring(monkeypatch, 3, 5)
    results, sources = {}, {i: torch.randn(37) + 100 * i for i in range(16)}

    def caller(i):
        results[i] = [V._staged_to_cpu(sources[i]) for _ in range(20)]

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=caller, args=(i,)) for i in sources]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert all(torch.equal(_bits(out), _bits(sources[i])) for i, outs in results.items() for out in outs)
    assert len(results) == len(sources)


def test_one_ring_a_device_under_threads(monkeypatch):
    made = []

    class Ring:
        def __init__(self):
            made.append(self)

    monkeypatch.setattr(V, "_PinnedRing", Ring)
    monkeypatch.setattr(V, "_RINGS", {})
    devices = [torch.device("cuda", i % 2) for i in range(32)]
    got = [None] * len(devices)
    barrier = threading.Barrier(len(devices))

    def take(i):
        barrier.wait(timeout=30)
        got[i] = V._ring(devices[i])

    threads = [threading.Thread(target=take, args=(i,)) for i in range(len(devices))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert len(made) == 2 and all(got[i] is V._RINGS[d] for i, d in enumerate(devices))


# ---- the node's reserved outputs ----

CUDA = torch.device("cuda", 0)  # a device name only: nothing below touches a card


@pytest.fixture
def worker():
    """The populate worker's mappings: ``mapped`` holds a weak reference
    to each mmap ``video_io`` makes on it and ``made`` the calling thread's
    too, each with whether the worker made it; the worker waits at
    ``gate`` (open by default), with ``waiting`` set, and raises ENOMEM
    when ``fail`` is set.  The worker is left idle."""
    log = types.SimpleNamespace(mapped=[], gate=threading.Event(), waiting=threading.Event(), fail=False)
    log.gate.set()

    def logged_mmap(*args, **kwargs):
        on_worker = threading.current_thread().name.startswith("cvst-populate")
        if on_worker:
            log.waiting.set()
            assert log.gate.wait(timeout=60)
            if log.fail:
                raise OSError(errno.ENOMEM, "Cannot allocate memory")
        buf = mmap.mmap(*args, **kwargs)
        log.mapped.append((on_worker, weakref.ref(buf)))
        return buf

    fake = types.SimpleNamespace(**{k: getattr(mmap, k) for k in dir(mmap) if k.isupper()}, mmap=logged_mmap)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(V, "mmap", fake)
        yield log
        log.gate.set()
        _worker_idle()


def _worker_idle():
    """Wait until the populate worker has run everything queued before."""
    assert V._populator().submit(int).result(timeout=60) == 0


def _live(log):
    gc.collect()
    return [on_worker for on_worker, ref in log.mapped if ref() is not None]


LAYOUTS = {  # the input's shape -> the outputs' (N, H, W), as _normalize_batch lays the frames out
    "hwc_3": (2, 6, 10, 3), "hwc_1": (2, 6, 10, 1), "hwc_4": (2, 6, 10, 4), "hwc_2": (2, 6, 10, 2),
    "chw_3": (2, 3, 6, 10), "chw_1": (2, 1, 6, 10), "chw_4": (2, 4, 6, 10),
    "hwc_tall_3": (2, 3, 5, 3),  # 3 rows, not channels: 3 < 3 fails the CHW test
    "hwc_narrow": (2, 4, 3, 3),  # 4 rows of 3 pixels
    "one_frame": (1, 7, 9, 3),
}


@pytest.mark.parametrize("container", ["tensor", "numpy", "dict"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_reserved_shapes_are_the_normalized_clips(layout, container):
    shape = LAYOUTS[layout]
    clip = torch.rand(shape)
    value = {"tensor": clip, "numpy": clip.numpy(), "dict": {"frames": clip, "fps": 8.0}}[container]
    normalized = V.normalize_video_input(value, device="cpu").frames
    for framing in ("crop", "crop_and_pad"):
        assert V._reservable_shape(value, CUDA, framing) == tuple(normalized.shape[:3])
    assert normalized.shape[3] == 3


def _clip_streams(monkeypatch):
    monkeypatch.setattr(W, "CHUNK_BUDGET_BYTES", 1 << 10)
    return torch.rand(4, 6, 10, 3)


NOT_RESERVED = {
    "expand": lambda m: (torch.rand(4, 6, 10, 3), CUDA, "expand"),
    "cpu": lambda m: (torch.rand(4, 6, 10, 3), torch.device("cpu"), "crop_and_pad"),
    "frame_list": lambda m: (list(torch.rand(4, 6, 10, 3)), CUDA, "crop_and_pad"),
    "dict_of_frame_list": lambda m: ({"frames": list(torch.rand(4, 6, 10, 3))}, CUDA, "crop"),
    "three_dims": lambda m: (torch.rand(4, 6, 10), CUDA, "crop_and_pad"),
    "empty": lambda m: (torch.rand(0, 6, 10, 3), CUDA, "crop_and_pad"),
    "streamed": lambda m: (_clip_streams(m), CUDA, "crop_and_pad"),
    "no_map_populate": lambda m: (m.setattr(V, "_MAP_POPULATE", None), torch.rand(4, 6, 10, 3))[1:] + (CUDA, "crop"),
}


@pytest.mark.parametrize("case", list(NOT_RESERVED))
def test_calls_that_reserve_nothing(monkeypatch, case):
    value, dev, framing = NOT_RESERVED[case](monkeypatch)

    def refuse(*a, **k):
        raise AssertionError("a population was submitted")

    monkeypatch.setattr(V, "_populator", refuse)
    assert V._reservable_shape(value, dev, framing) is None
    with V.reserve_host_outputs(value, dev, framing) as reserved:
        assert reserved.frames is None and reserved.masks is None


def test_a_mesh_of_more_than_one_device_reserves_nothing():
    clip = torch.rand(4, 6, 10, 3)
    with meshinfo.set_mesh(make_mesh(devices=["cpu"] * 2)):
        assert V._reservable_shape(clip, CUDA, "crop_and_pad") is None
    with meshinfo.set_mesh(make_mesh(devices=["cpu"])):
        assert V._reservable_shape(clip, CUDA, "crop_and_pad") == (4, 6, 10)


def test_reservation_maps_frames_then_masks_on_the_worker(worker):
    with V.reserve_host_outputs(torch.rand(3, 6, 10, 3), CUDA, "crop_and_pad") as reserved:
        assert (reserved.frames.numel, reserved.masks.numel) == (3 * 6 * 10 * 3, 3 * 6 * 10)
        _worker_idle()
        assert [on_worker for on_worker, _ in worker.mapped] == [True, True]
    assert _live(worker) == []  # neither taken: both dropped on exit


@pytest.mark.parametrize("slots", [2, 3])
@pytest.mark.parametrize("shape, reserved_shape", [((4, 6, 10, 3), (4, 6, 10, 3)), ((4, 6, 10), (4, 6, 10)),
                                                   ((4, 6, 10, 1), (4, 6, 10)), ((29,), (29,))])
def test_ring_places_into_a_reserved_output_as_into_a_new_one(recorder, worker, monkeypatch, shape, reserved_shape,
                                                              slots):
    """The ring's loop on CPU slots of 7 elements: the reserved buffer, viewed
    as the source's shape (masks may come as (N, H, W, 1)), is the output,
    bitwise the output of a new mapping; the wait is its own span with the
    worker's population time."""
    ring, _ = _stand_in_ring(monkeypatch, slots, 7)
    src = torch.randn(shape)
    src.view(-1)[::5] = -0.0
    reserved = V.ReservedOutput(reserved_shape)
    into = reserved.take(src)
    assert into.shape == src.shape and into.dtype == torch.float32 and into.is_contiguous()
    out = V._staged_to_cpu(src, into)
    assert out is into
    fresh = V._staged_to_cpu(src)
    assert torch.equal(_bits(out), _bits(fresh)) and torch.equal(_bits(out), _bits(src))
    (wait,) = [r for r in P.drain() if r.name == "io.egress.reserve_wait"]
    assert wait.counters["io.host_populate_us"] >= 0  # a root here: it also takes the watched counters
    assert reserved.take(src) is None  # spent
    assert [on_worker for on_worker, _ in worker.mapped] == [True, False]


def test_a_reservation_of_another_element_count_is_dropped(recorder, worker):
    reserved = V.ReservedOutput((4, 6, 10))
    _worker_idle()
    assert reserved.take(torch.zeros(4, 6, 11)) is None
    assert [r.name for r in P.drain()] == []  # nothing waited for
    assert _live(worker) == []


def test_an_abandoned_reservation_is_unmapped_once_the_worker_is_done(worker):
    """The worker held at its first mapping: dropping the reservation does
    not wait for it, the masks' population (still queued) never runs, and
    the frames' buffer is unmapped once the worker lets it go."""
    worker.gate.clear()
    with V.reserve_host_outputs(torch.rand(3, 6, 10, 3), CUDA, "crop") as reserved:
        frames = reserved.frames
        assert worker.waiting.wait(timeout=60)
    assert not worker.gate.is_set() and frames.take(torch.zeros(3, 6, 10, 3)) is None
    worker.gate.set()
    _worker_idle()
    assert [on_worker for on_worker, _ in worker.mapped] == [True]
    assert _live(worker) == []


def test_a_worker_whose_mapping_raises_leaves_the_egress_its_own(recorder, worker, monkeypatch):
    _stand_in_ring(monkeypatch, 3, 7)
    worker.fail = True
    src = torch.randn(4, 6, 10)
    reserved = V.ReservedOutput(tuple(src.shape))
    assert reserved.take(src) is None
    out = V._staged_to_cpu(src, None)
    assert torch.equal(_bits(out), _bits(src))
    assert [on_worker for on_worker, _ in worker.mapped] == [False]  # mapped by the egress's thread
    (wait,) = [r for r in P.drain() if r.name == "io.egress.reserve_wait"]
    assert "io.host_populate_us" not in wait.counters


class _Interrupted(Exception):
    pass


@pytest.mark.parametrize("kind", ["flow", "classic"])
def test_node_call_with_a_reservation_the_cpu_egress_drops(worker, monkeypatch, kind):
    """On the CPU the egress never takes a reservation (its outputs are no
    CUDA tensors): forced, it is dropped and the outputs are those of a call
    that reserves nothing; a call interrupted while the worker still maps
    returns without waiting for it, and leaves nothing mapped."""
    clip = _frames(n=5, h=48, w=64)
    node = {"flow": SN.VideoStabilizerFlow, "classic": SN.VideoStabilizerClassic}[kind]
    args = (16.0, "crop_and_pad", "similarity", False, 0.7, 0.5, 0.6, "#7F7F7F")
    plain = node.execute(clip, *args, device="cpu")
    monkeypatch.setattr(V, "_reservable_shape", lambda value, dev, framing: tuple(value.shape[:3]))
    reserved = node.execute(clip, *args, device="cpu")
    _worker_idle()
    assert [on_worker for on_worker, _ in worker.mapped] == [True, True]
    for a, b in zip(plain[:2], reserved[:2]):
        assert torch.equal(_bits(a), _bits(b))
    assert json.dumps(plain[2], sort_keys=True, default=str) == json.dumps(reserved[2], sort_keys=True, default=str)
    assert _live(worker) == []

    def interrupt():
        raise _Interrupted

    worker.mapped.clear()
    worker.gate.clear()
    monkeypatch.setattr(SN, "check_interrupt", interrupt)
    with pytest.raises(_Interrupted):
        node.execute(clip, *args, device="cpu")
    assert not worker.gate.is_set()
    worker.gate.set()
    _worker_idle()
    assert _live(worker) == []


# ---- on the card ----

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the pinned ring stages copies from a card")
    return torch.device("cuda", 0)


def _card_sizes():
    ring_elems = V.RING_SLOTS * SLOT
    frames_past_ring = -(-ring_elems // (1081 * 1923 * 3)) + 1
    return {
        "one_element": (1,),
        "below_a_slot": (3, 17, 29),
        "one_slot": (SLOT,),
        "one_slot_plus_one": (SLOT + 1,),
        "frames_past_the_ring": (frames_past_ring, 1081, 1923, 3),
        "masks_past_the_ring": (frames_past_ring * 3 + 1, 1081, 1923),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("size", ["one_element", "below_a_slot", "one_slot", "one_slot_plus_one",
                                  "frames_past_the_ring", "masks_past_the_ring"])
def test_ring_is_bitwise_cpu_and_allocates_nothing_on_the_card(recorder, cuda, size):
    shape = _card_sizes()[size]
    g = torch.Generator(device=cuda).manual_seed(7)
    t = torch.randn(shape, device=cuda, generator=g)
    flat = t.view(-1)
    flat[::997] = float("nan")
    flat[1::1009] = float("-inf")
    flat[2::1013] = -0.0
    expected = t.cpu()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda)
    allocated = torch.cuda.memory_allocated(cuda)
    out = V._to_cpu_f32(t)
    assert torch.cuda.max_memory_allocated(cuda) == allocated
    assert out.device.type == "cpu" and out.dtype == torch.float32 and out.shape == t.shape
    assert out.is_contiguous() and not out.is_pinned()
    assert torch.equal(_bits(out), _bits(expected))
    (record,) = _egress_records()
    assert (record["io.d2h_bytes"], record["io.d2h_staged_bytes"]) == (t.nbytes, t.nbytes)


@pytest.mark.cuda
def test_ring_waits_for_work_queued_on_the_stream(cuda):
    """The source is written by a fill queued behind ~0.2 s of spinning on
    the current stream when the egress starts: the copies follow it."""
    shape = _card_sizes()["frames_past_the_ring"]
    t = torch.zeros(shape, device=cuda)
    pattern = torch.arange(t.numel(), device=cuda, dtype=torch.int32).view(shape) % 8191
    torch.cuda.synchronize()
    torch.cuda._sleep(400_000_000)
    t.copy_(pattern)
    out = V._to_cpu_f32(t)
    assert torch.equal(out, pattern.cpu().to(torch.float32))


NODES = {"flow": SN.VideoStabilizerFlow, "classic": SN.VideoStabilizerClassic}
WIDGETS = (16.0, "crop_and_pad", "similarity", False, 0.7, 0.5, 0.6, "#7F7F7F")


def _shaken_clip():
    """Nine 120 x 240 CPU frames of a smooth scene shifted a few pixels each."""
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:136, 0:256].astype(np.float32)
    scene = np.stack([0.5 + 0.4 * np.sin(xx / 5.0 + c) * np.cos(yy / 7.0 - c) for c in range(3)], -1)
    shifts = rng.integers(0, 16, size=(9, 2))
    return torch.from_numpy(np.stack([scene[dy:dy + 120, dx:dx + 240] for dy, dx in shifts]).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["flow", "classic"])
def test_node_call_stages_every_byte_of_its_egress(recorder, cuda, kind):
    clip = _shaken_clip()
    node = NODES[kind]
    frames, masks, meta = node.execute(clip, *WIDGETS, device="cuda")
    timing = meta["timing"]["io.egress.copy"]
    assert timing["io.d2h_bytes"] == frames.nbytes + masks.nbytes
    assert timing["io.d2h_staged_bytes"] == timing["io.d2h_bytes"]
    assert not frames.is_pinned() and not masks.is_pinned()


def _meta_json(meta):
    return json.dumps({k: v for k, v in meta.items() if k != "timing"}, sort_keys=True, default=str)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["flow", "classic"])
def test_node_call_places_its_egress_into_reserved_outputs(recorder, cuda, monkeypatch, kind):
    """Frames and masks placed into the outputs reserved before the upload
    (``io.d2h_reserved_bytes == io.d2h_bytes``, one wait each): bitwise the
    outputs and meta of the same call with nothing reserved, with the same
    device memory, peak and after."""
    clip, node = _shaken_clip(), NODES[kind]

    def call():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(cuda)
        out = node.execute(clip, *WIDGETS, device="cuda")
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated(cuda), torch.cuda.memory_allocated(cuda)

    call()  # the ring, the kernels and any graph made
    (frames, masks, meta), peak, after = call()
    copy = meta["timing"]["io.egress.copy"]
    assert copy["io.d2h_reserved_bytes"] == copy["io.d2h_bytes"] == frames.nbytes + masks.nbytes
    assert meta["timing"]["io.egress.reserve_wait"]["n"] == 2
    assert not frames.is_pinned() and not masks.is_pinned() and frames.is_contiguous() and masks.is_contiguous()
    monkeypatch.setattr(V, "_reservable_shape", lambda value, dev, framing: None)
    (frames0, masks0, meta0), peak0, after0 = call()
    assert meta0["timing"]["io.egress.copy"]["io.d2h_reserved_bytes"] == 0
    assert "io.egress.reserve_wait" not in meta0["timing"]
    assert frames.shape == frames0.shape and masks.shape == masks0.shape
    assert torch.equal(_bits(frames), _bits(frames0)) and torch.equal(_bits(masks), _bits(masks0))
    assert _meta_json(meta) == _meta_json(meta0)
    assert (peak, after) == (peak0, after0)


@pytest.mark.cuda
@pytest.mark.parametrize("held", [True, False])
def test_an_interrupted_node_call_leaves_no_live_reservation(cuda, worker, monkeypatch, held):
    """Interrupted at the engine's first poll, with the worker still mapping
    (held) or done: the call raises without waiting for it, and nothing it
    reserved stays mapped once the worker is idle."""

    def interrupt():
        raise _Interrupted

    clip = _shaken_clip()
    SN.VideoStabilizerFlow.execute(clip, *WIDGETS, device="cuda")  # warm
    worker.mapped.clear()
    if held:
        worker.gate.clear()
    monkeypatch.setattr(SN, "check_interrupt", interrupt)
    with pytest.raises(_Interrupted):
        SN.VideoStabilizerFlow.execute(clip, *WIDGETS, device="cuda")
    worker.gate.set()
    _worker_idle()
    assert _live(worker) == []
