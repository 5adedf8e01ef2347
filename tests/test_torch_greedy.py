"""The corner greedy (``ops/greedy_cuda.py``: K7 and its plain version)
against the JAX package's device scan and the native oracle.

References: ``comfyui_video_stabilizer_tpu/ops/lk.py::_greedy_device``
(a ``lax.scan`` of 16-candidate blocks, run on the CPU) and the port's
native greedy (``ops/lk.py::greedy_host``, ``native/rectangle.cpp``).
Inputs are made with numpy from a seed on a 72x96 frame.

Tolerance: exact, in corners and counts.  The coordinates are integers,
so every squared distance the three compare with 49 is exact in
float32 and in double.

The ``cuda`` cases hold K7 ``torch.equal`` to its plain version and to
the native greedy on the card, across a launch split at 65,535 frames;
they import no JAX, so the file runs there without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_greedy.py -q -m cuda
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

from comfyui_video_stabilizer_tpu_torch.ops import cuda_build  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import greedy_cuda as TGR  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import lk as TLK  # noqa: E402

H, W = 72, 96
CASES = ["random", "clusters", "cap_mid_block", "all_invalid", "k_not_multiple_of_16", "one_frame"]


def _case(name: str):
    """(top_idx (B, K) int32, max_corners) of one case, valid candidates first."""
    rng = np.random.default_rng(CASES.index(name))
    if name in ("random", "one_frame"):
        b = 4 if name == "random" else 1
        return np.stack([rng.permutation(H * W)[:2048] for _ in range(b)]).astype(np.int32), 400
    if name == "clusters":
        # every pixel within 5 px of one of six centres, shuffled: most
        # candidates sit closer than 7 px to one accepted before them
        rows = []
        for _ in range(3):
            cy, cx = rng.integers(5, H - 5, 6), rng.integers(5, W - 5, 6)
            dy, dx = np.meshgrid(np.arange(-5, 6), np.arange(-5, 6), indexing="ij")
            idx = np.unique(((cy[:, None] + dy.ravel()) * W + cx[:, None] + dx.ravel()).ravel())
            rows.append(rng.permutation(idx)[:512])
        return np.stack(rows).astype(np.int32), 400
    if name == "cap_mid_block":
        # a grid 8 px apart: every candidate passes the distance test, so
        # the 23rd acceptance (inside the second 16-block) ends the walk
        grid = (np.arange(4, H, 8)[:, None] * W + np.arange(4, W, 8)[None, :]).ravel()
        return np.stack([rng.permutation(grid)[:64] for _ in range(2)]).astype(np.int32), 23
    if name == "all_invalid":
        return np.full((3, 48), -1, np.int32), 400
    # K = 1003; frame 0 ends in 100 invalid candidates
    top = np.stack([rng.permutation(H * W)[:1003] for _ in range(2)]).astype(np.int32)
    top[0, -100:] = -1
    return top, 400


def _jax_greedy(top_idx: np.ndarray, max_corners: int):
    import jax.numpy as jnp

    from comfyui_video_stabilizer_tpu.ops import lk as JLK

    pts, counts = JLK._greedy_device(jnp.asarray(top_idx), W, max_corners, JLK.MIN_DISTANCE)
    return np.asarray(pts), np.asarray(counts)


@pytest.mark.parametrize("case", CASES)
def test_greedy_plain_matches_jax_scan_and_native(case):
    top_idx, max_corners = _case(case)
    pts, counts = TGR.greedy_plain(torch.from_numpy(top_idx), W, max_corners, TLK.MIN_DISTANCE)
    assert pts.dtype == torch.float32 and counts.dtype == torch.int32
    assert tuple(pts.shape) == (top_idx.shape[0], max_corners, 2)
    jax_pts, jax_counts = _jax_greedy(top_idx, max_corners)
    host_pts, host_counts = TLK.greedy_host(top_idx, H, W, max_corners)
    assert np.array_equal(pts.numpy(), jax_pts) and np.array_equal(counts.numpy(), jax_counts)
    assert np.array_equal(pts.numpy(), host_pts) and np.array_equal(counts.numpy(), host_counts)
    if case == "cap_mid_block":
        assert counts.tolist() == [23, 23]
    if case == "all_invalid":
        assert counts.tolist() == [0, 0, 0] and not pts.any()
    if case == "clusters":
        assert (counts < 60).all() and (counts > 0).all()


def test_gftt_batch_runs_no_native_greedy(monkeypatch):
    """gftt_batch takes the greedy on the grays' device (its plain version
    here) and never the native helper; its corners equal the host route's."""
    from test_classic import _shaken_clip

    frames, _ = _shaken_clip(n=3, h=H, w=W, seed=5)
    grays = torch.from_numpy(np.asarray(frames, np.float32).mean(-1) * 255.0)
    ref_pts, ref_counts = TLK.gftt_batch_host(grays)

    def refused(*_a, **_k):
        raise AssertionError("the native greedy was called")

    monkeypatch.setattr(TLK._native, "greedy_min_distance", refused)
    pts, counts = TLK.gftt_batch(grays)
    assert (counts > 12).all()
    assert torch.equal(pts, ref_pts) and torch.equal(counts, ref_counts)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_k7_equals_plain_and_native(cuda, case):
    top_idx, max_corners = _case(case)
    t = torch.from_numpy(top_idx).to(cuda)
    launches = cuda_build.LAUNCHES["greedy"]
    pts, counts = TGR.greedy_min_distance(t, W, max_corners, TLK.MIN_DISTANCE)
    ref_pts, ref_counts = TGR.greedy_plain(t, W, max_corners, TLK.MIN_DISTANCE)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["greedy"] == launches + 1
    assert torch.equal(pts, ref_pts) and torch.equal(counts, ref_counts)
    host_pts, host_counts = TLK.greedy_host(top_idx, H, W, max_corners)
    assert np.array_equal(pts.cpu().numpy(), host_pts) and np.array_equal(counts.cpu().numpy(), host_counts)


@pytest.mark.cuda
def test_k7_splits_past_65535_frames(cuda):
    """65,536 frames of 12 candidates on a 16x16 frame: two launches, and
    the frames on both sides of the split equal the plain version."""
    rng = np.random.default_rng(9)
    top_idx = np.argsort(rng.random((65536, 256)), axis=1)[:, :12].astype(np.int32)
    top_idx[::7, 9:] = -1
    t = torch.from_numpy(top_idx).to(cuda)
    cuda_build.reset_launches()
    pts, counts = TGR.greedy_min_distance(t, 16, 5, TLK.MIN_DISTANCE)
    ref_pts, ref_counts = TGR.greedy_plain(t, 16, 5, TLK.MIN_DISTANCE)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["greedy"] == 2
    assert torch.equal(pts, ref_pts) and torch.equal(counts, ref_counts)


@pytest.mark.cuda
def test_k7_refuses_arguments(cuda):
    top = torch.zeros((2, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(cuda_build.KernelArgumentError, match="max_corners"):
        TGR.greedy_min_distance(top, 16, 0)
    with pytest.raises(cuda_build.KernelArgumentError, match="max_corners"):
        TGR.greedy_min_distance(top, 16, TGR.MAX_KERNEL_CORNERS + 1)
    with pytest.raises(cuda_build.KernelArgumentError, match="w "):
        TGR.greedy_min_distance(top, 0)
    with pytest.raises(cuda_build.KernelTypeError, match="int32"):
        TGR.greedy_min_distance(top.to(torch.int64), 16)
    with pytest.raises(cuda_build.KernelArgumentError, match="2 dims"):
        TGR.greedy_min_distance(top[0], 16)
