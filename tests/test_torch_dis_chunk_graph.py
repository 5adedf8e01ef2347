"""Flow's DIS chunks from a CUDA graph, under a progress observer.

A call with an observer (the ComfyUI node always passes one) estimates
Flow in chunks with a tick between them; on one CUDA device each chunk's
DIS replays one graph of ``flow_dis.dis_flow_fit_level`` on the chunk's
finest refined level (models/fastpath.py::_dis_from_graph).

On the CPU: the split entry from a fresh copy of that level gives
samples bitwise equal to ``dis_flow_fit`` (decimation 1 with finest 2,
as at 864x486; decimation 4 with finest 0, as 1080p's grays pooled
8 x 8; both pre-warp models); the bytes the graph
keeps, from the shapes (:func:`dis_graph_bytes`); with the route
opened on the CPU and the graph's program run eagerly, an observed call
goes through the entry, one key for every chunk, bitwise equal to the
eager chunks with the same ticks.

The ``cuda`` cases run on the card (this file imports no JAX):

    python -m pytest --noconftest tests/test_torch_dis_chunk_graph.py -q -m cuda

Tolerance: bitwise.  The graph holds the same kernels in the same order
as the eager chunks.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

from comfyui_video_stabilizer_tpu_torch.models import fastpath as FP  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.models import flow as FL  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.models import stabilize as ST  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import flow_dis as FD  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import warp as W  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.utils.video_io import normalize_video_input  # noqa: E402

ARGS = ("crop_and_pad", "similarity", False, 0.8, 0.6, 0.6, (127, 127, 127), 24.0)

# what a CUDA graph's capture keeps besides the program's tensors, while
# any graph lives: the CUDA generator's seed and offset for graphs, one
# 512-byte block each (PyTorch's CUDAGeneratorState::register_graph)
CAPTURE_BYTES = 1024


def _grays(n, h, w, seed):
    """(n, h, w) integer grays 0..255 of a smooth noise scene drifting a
    pixel or two a frame."""
    gen = torch.Generator().manual_seed(seed)
    scene = torch.nn.functional.avg_pool2d(torch.rand((1, 1, h + 3 * n, w + 3 * n), generator=gen), 5, 1, 2)[0, 0]
    steps = torch.randint(0, 3, (n, 2), generator=gen).cumsum(0)
    return torch.stack([torch.floor(scene[y:y + h, x:x + w] * 255.0) for y, x in steps.tolist()])


def _clip(n=8, h=128, w=256, seed=5):
    """A shaken RGB clip in 0..1: a smooth scene under small similarities."""
    gen = torch.Generator().manual_seed(seed)
    base = torch.nn.functional.avg_pool2d(torch.rand((1, 1, h + 64, w + 64), generator=gen), 5, 1, 2)[0, 0]
    base = torch.stack([base, base * 0.7 + 0.1, 1.0 - base], dim=-1)
    rng = np.random.default_rng(seed)
    view = []
    for _ in range(n):
        th, (tx, ty) = rng.uniform(-0.01, 0.01), rng.uniform(-4.0, 4.0, 2)
        view.append([[np.cos(th), -np.sin(th), tx - 32.0], [np.sin(th), np.cos(th), ty - 32.0], [0.0, 0.0, 1.0]])
    return W.warp_clip(base[None].expand(n, *base.shape).contiguous(), np.asarray(view), (w, h), "bilinear",
                       (0.5,) * 3)


def dis_graph_bytes(n: int, h: int, w: int, decimation: int) -> int:
    """The bytes the DIS graph of an (n, h, w) gray clip's chunks keeps
    between calls, from the shapes: its static input, a chunk's frames at
    the finest level refined, and its output, the chunk's pairs' samples
    (pairs, grid points, 2), all float32."""
    start, end, _ = ST.estimation_chunk_spans(n)[0]
    frames = end - start
    _, finest = FD.level_range(h, w, FL.finest_scale(decimation))
    step = FL.SAMPLE_STEP // decimation
    points = -(-h // step) * -(-w // step)
    return 4 * frames * (h >> finest) * (w >> finest) + 4 * (frames - 1) * points * 2


def _two_pair_chunks(monkeypatch):
    """The chunk plan cut to 2 pairs a chunk, as the shared loop reads it."""
    spans = ST.estimation_chunk_spans
    monkeypatch.setattr(ST, "estimation_chunk_spans", lambda n: spans(n, chunk=2))


@pytest.mark.parametrize("model", ["similarity", "homography"])
@pytest.mark.parametrize("shape,step,finest", [((9, 122, 216), 8, 2), ((9, 68, 120), 2, 0)],
                         ids=["decimation1", "decimation4"])
def test_split_entry_from_the_finest_level_equals_dis_flow_fit(shape, step, finest, model):
    """The graph's program on a fresh copy of level ``finest`` (as its
    static input holds it) against ``dis_flow_fit`` on the grays."""
    grays = _grays(*shape, seed=shape[1])
    level = FD.build_pyramid(grays, finest)[finest].clone()
    assert level.shape == (shape[0], shape[1] >> finest, shape[2] >> finest)
    ours = FD.dis_flow_fit_level(level, shape[1:], step, finest, model=model)
    ref = FD.dis_flow_fit(grays, step, finest_scale=finest, model=model)
    assert ours.shape == ref.shape and torch.equal(ours, ref)


@pytest.mark.parametrize("n,h,w,decimation,kept", [
    (81, 486, 864, 1, 4 * 33 * 121 * 216 + 4 * 32 * 61 * 108 * 2),  # 864x486: level 2, 8-px grid
    (81, 135, 240, 4, 4 * 33 * 135 * 240 + 4 * 32 * 68 * 120 * 2),  # 1080p pooled 8 x 8: level 0, 2-px grid
    (9, 122, 216, 1, 4 * 9 * 30 * 54 + 4 * 8 * 16 * 27 * 2),         # one span: the whole clip
])
def test_graph_keeps_its_level_and_samples(n, h, w, decimation, kept):
    """The DIS graph's static input (a chunk of chunk + 1 frames at the
    finest level refined) and its samples, float32, from the shapes:
    5,136,480 bytes at 864x486 and 6,365,760 at 1080p."""
    assert dis_graph_bytes(n, h, w, decimation) == kept
    assert dis_graph_bytes(81, 486, 864, 1) == 5_136_480 and dis_graph_bytes(81, 135, 240, 4) == 6_365_760


def _observed(frames, device):
    ticks = []
    res = FL.stabilize_flow(normalize_video_input(frames, device=device), *ARGS,
                            progress=lambda d, t: ticks.append((d, t)), device=device)
    return res, ticks


def test_observed_call_goes_through_the_chunk_graph_entry(monkeypatch):
    """2-pair chunks and an observer, the route opened on the CPU (the
    frames taken for a card's) and the graph's program run eagerly on a
    copy of its input: every chunk reaches the cache with one key, and
    the call equals the eager chunks bitwise, ticks included."""
    monkeypatch.setenv("CVST_FASTPATH", "1")
    monkeypatch.setenv("CVST_FASTPATH_STRICT", "1")
    _two_pair_chunks(monkeypatch)
    frames = _clip()
    eager, eager_ticks = _observed(frames, "cpu")

    class Eager:
        def __init__(self, program, kw):
            self.program, self.kw = program, kw

        def replay(self, level):
            return self.program(level.clone(), **self.kw)

    keys = []
    route, card = FP._route, types.SimpleNamespace(device=torch.device("cuda", 0))
    monkeypatch.setattr(FP, "_route", lambda kind, frames, *a: route(kind, card, *a))
    monkeypatch.setattr(FP, "_cached_graph", lambda key, program, example, kw: keys.append(key) or Eager(program, kw))
    graph, ticks = _observed(frames, "cpu")
    assert len(keys) == len(ST.estimation_chunk_spans(8)) == 4 and len(set(keys)) == 1
    assert torch.equal(graph.frames, eager.frames) and torch.equal(graph.masks, eager.masks)
    assert graph.meta == eager.meta
    assert ticks == eager_ticks and ticks


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_observed_call_replays_one_graph_a_chunk_bitwise(cuda, monkeypatch):
    """2-pair chunks and a progress observer on the card: the call from the
    chunk graph (captured on the first chunk, then replayed) equals the
    same call with CVST_FUSED=0 bitwise (frames, masks, meta) with the
    same ticks; one capture and a replay a chunk; and the memory it
    leaves allocated exceeds the eager call's by at most what
    :func:`dis_graph_bytes` says the graph keeps (the clip's tensors are
    whole 512-byte blocks) and what any capture keeps."""
    monkeypatch.setenv("CVST_FASTPATH_STRICT", "1")
    _two_pair_chunks(monkeypatch)
    frames = _clip().to(cuda)
    chunks = len(ST.estimation_chunk_spans(8))

    def grown(run):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(cuda)
        out = run()
        torch.cuda.synchronize()
        return out, torch.cuda.memory_allocated(cuda) - before

    FP.clear_graph_cache()
    monkeypatch.setenv("CVST_FUSED", "0")
    stats = dict(FP.GRAPH_STATS)
    (eager, eager_ticks), eager_bytes = grown(lambda: _observed(frames, cuda))
    assert FP.GRAPH_STATS == stats
    monkeypatch.setenv("CVST_FUSED", "1")
    (first, first_ticks), graph_bytes = grown(lambda: _observed(frames, cuda))
    assert FP.GRAPH_STATS["captures"] == stats["captures"] + 1
    assert FP.GRAPH_STATS["replays"] == stats["replays"] + chunks
    again, again_ticks = _observed(frames, cuda)
    torch.cuda.synchronize()
    assert FP.GRAPH_STATS["captures"] == stats["captures"] + 1
    assert FP.GRAPH_STATS["replays"] == stats["replays"] + 2 * chunks
    assert [k[0] for k in FP._GRAPHS] == ["flow_dis"]
    for res in (first, again):
        assert torch.equal(res.frames, eager.frames) and torch.equal(res.masks, eager.masks)
        assert res.meta == eager.meta
    assert first_ticks == again_ticks == eager_ticks and eager_ticks
    assert graph_bytes - eager_bytes <= dis_graph_bytes(8, 32, 64, 4) + CAPTURE_BYTES
    FP.clear_graph_cache()


@pytest.mark.cuda
def test_interrupt_at_the_first_replayed_chunk(cuda, monkeypatch):
    """The interrupt raised at the first tick, after the first chunk's
    replay, reaches the caller as itself; neither the host engine (its
    Flow fits, TV-L1) nor the trajectory program runs."""
    monkeypatch.setenv("CVST_FASTPATH_STRICT", "1")
    _two_pair_chunks(monkeypatch)
    calls = []
    for mod, name in ((FL, "_fused_fits_sampled"), (FL.TV, "tvl1_flow"), (FP, "_traj_program")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name, **k: calls.append(_n) or _r(*a, **k))

    class Stop(Exception):
        pass

    def interrupt():
        raise Stop()

    frames = _clip().to(cuda)
    FP.clear_graph_cache()
    replays = FP.GRAPH_STATS["replays"]
    with pytest.raises(Stop):
        FL.stabilize_flow(normalize_video_input(frames, device=cuda), *ARGS, interrupt_check=interrupt, device=cuda)
    torch.cuda.synchronize()
    assert calls == []
    assert FP.GRAPH_STATS["replays"] == replays + 1
    FP.clear_graph_cache()
