"""The estimation chunk loop both estimators share
(models/stabilize.py::chunked_pairs), on the CPU.

At 81 frames under an observer the loop dispatches the chunks of
``estimation_chunk_spans`` (three of 33 frames, the last recomputing 16
pairs it drops) and ticks at 32, 64 and 80 pairs; Flow's DIS and
Classic's tracks are per pair, so the result equals one whole-clip
dispatch (the call with no observer).

Tolerance: bitwise.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

from comfyui_video_stabilizer_tpu_torch.models import classic as CL  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.models import stabilize as ST  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import flow_dis as FD  # noqa: E402

PER_CHUNK = {"flow": lambda g: FD.dis_flow_fit(g, 8), "classic": CL._tracks}


def _grays(n=81, h=48, w=64, seed=7):
    """(n, h, w) grays 0..255 of a smooth textured scene drifting a pixel
    or two a frame."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h + 2 * n, 0:w + 2 * n].astype(np.float32)
    scene = 127.5 + 60.0 * np.sin(xx / 4.0) * np.cos(yy / 5.0) + 40.0 * rng.random(xx.shape, dtype=np.float32)
    steps = np.cumsum(rng.integers(0, 3, size=(n, 2)), axis=0)
    return torch.from_numpy(np.floor(np.stack([scene[y:y + h, x:x + w] for y, x in steps])))


@pytest.mark.parametrize("kind", ["flow", "classic"])
def test_chunks_equal_one_whole_clip_dispatch(kind):
    grays = _grays()
    dispatched, ticks = [], []

    def per_chunk(g):
        dispatched.append(int(g.shape[0]))
        return PER_CHUNK[kind](g)

    chunked = ST.chunked_pairs(grays, per_chunk, ticks.append)
    assert dispatched == [e - s for s, e, _ in ST.estimation_chunk_spans(81)] == [33, 33, 33]
    assert ticks == [32, 64, 80]
    whole = ST.chunked_pairs(grays, per_chunk, None)
    assert dispatched[3:] == [81]
    if kind == "flow":
        chunked, whole = (chunked,), (whole,)
    assert len(chunked) == len(whole)
    for a, b in zip(chunked, whole):
        assert a.shape[0] == 80 and torch.equal(a, b)
