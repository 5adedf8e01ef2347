"""The node's egress (``utils/video_io.py``): frames and masks to the host.

A contiguous float32 CUDA tensor goes through its device's ring of
pinned slots (``plan_chunks`` cuts it, ``_staged_to_cpu`` pipelines it
into new memory from ``_new_host_f32``);
everything else takes the one ``.to("cpu", torch.float32)`` it took
before the ring.  On the CPU: the chunk planner, the new output memory,
the ring's loop on stand-in slots and events, and every input the ring does not serve,
bitwise what the plain copy returns, with ``io.d2h_staged_bytes`` at 0.

The ``cuda`` cases hold the ring to ``.cpu()`` bitwise on the card, at
sizes below a slot and past the whole ring, after work still queued on
the stream, with no device memory allocated, and count the bytes of a
node call (``--noconftest``: this file imports no JAX):

    python -m pytest --noconftest tests/test_torch_egress.py -q -m cuda
"""

import gc
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from comfyui_video_stabilizer_tpu_torch.nodes import stabilizer_nodes as SN  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.parallel.mesh import FrameShards  # noqa: E402
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


def _plain_to_cpu_f32(x):
    """The egress's copy before the ring: one ``.to("cpu", torch.float32)``."""
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
    assert records and all(r == {"io.d2h_bytes": 0, "io.d2h_staged_bytes": 0} for r in records)


@pytest.mark.parametrize("kind", list(MASK_INPUTS))
def test_masks_the_ring_does_not_serve_come_back_as_before(recorder, monkeypatch, kind):
    out = V.convert_masks_for_output(MASK_INPUTS[kind]())
    records = _egress_records()
    with monkeypatch.context() as m:
        m.setattr(V, "_to_cpu_f32", _plain_to_cpu_f32)
        before = V.convert_masks_for_output(MASK_INPUTS[kind]())
    assert out.dtype == torch.float32 and out.is_contiguous() and out.shape == before.shape
    assert out.ndim == 3 and torch.equal(_bits(out), _bits(before))
    assert records and all(r == {"io.d2h_bytes": 0, "io.d2h_staged_bytes": 0} for r in records)


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


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["flow", "classic"])
def test_node_call_stages_every_byte_of_its_egress(recorder, cuda, kind):
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:136, 0:256].astype(np.float32)
    scene = np.stack([0.5 + 0.4 * np.sin(xx / 5.0 + c) * np.cos(yy / 7.0 - c) for c in range(3)], -1)
    shifts = rng.integers(0, 16, size=(9, 2))
    clip = torch.from_numpy(np.stack([scene[dy:dy + 120, dx:dx + 240] for dy, dx in shifts]).astype(np.float32))
    node = {"flow": SN.VideoStabilizerFlow, "classic": SN.VideoStabilizerClassic}[kind]
    frames, masks, meta = node.execute(clip, 16.0, "crop_and_pad", "similarity", False, 0.7, 0.5, 0.6, "#7F7F7F",
                                       device="cuda")
    timing = meta["timing"]["io.egress.copy"]
    assert timing["io.d2h_bytes"] == frames.nbytes + masks.nbytes
    assert timing["io.d2h_staged_bytes"] == timing["io.d2h_bytes"]
    assert not frames.is_pinned() and not masks.is_pinned()
