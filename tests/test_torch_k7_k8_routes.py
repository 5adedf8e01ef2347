"""The designs of K8 (padding stats) and K7 (corner greedy), held in plain
PyTorch on the CPU, where the kernels cannot run.

K8 takes, per frame, an affine route when g == h == 0 (either sign):
no denominator, no reciprocal, no g/h terms
(``csrc/warp.cu::padding_stats_kernel``).
``ops/warp.py::padding_counts_affine_plain`` repeats that route op for
op; here it is held to ``padding_counts_plain`` (the general formula)
and to the JAX package's ``_padding_stats_xla`` / ``_padding_stats_bucket``
run on the CPU, on similarities with signed zeros, scales near 0 and
negative, half-pixel ties and displacements past the +-1e6 clip, over
the whole canvas, a bucket's true canvas and 2-3 row bands.

K7 walks the candidates in blocks (``csrc/greedy.cu``): each block is
tested against the corners of earlier blocks, then resolved inside in
rounds of bit operations.  ``ops/greedy_cuda.py::greedy_blocked_plain``
runs those steps in plain torch; here it is held to ``greedy_plain``
(one step a candidate) and to the native greedy for blocks of 1, 16,
32 and 64 candidates.

Inputs are made with numpy from a seed, at small sizes.  Tolerance:
exact (``torch.equal`` / ``np.array_equal``): masks are 0 or 1, counts
are integers, corners are integer coordinates whose squared distances
are exact in float32.

The ``cuda`` cases hold both kernels ``torch.equal`` to their plain
versions on the card (a mixed affine + perspective batch; K7 at
max_corners 6144 and with duplicates); they import no JAX:

    python -m pytest --noconftest tests/test_torch_k7_k8_routes.py -q -m cuda
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

from comfyui_video_stabilizer_tpu_torch.ops import cuda_build  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import greedy_cuda as TGR  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import lk as TLK  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import warp as TW  # noqa: E402

# ---------------------------------------------------------------------------
# K8
# ---------------------------------------------------------------------------

H, W = 45, 67
AFFINE_CASES = ["shaken", "signed_zeros", "scales", "clip"]


def _affine_coeffs(case: str) -> np.ndarray:
    """(n, 8) float32 inverse coefficients with g == h == 0; each case
    holds the identity, so its mask has both values."""
    rng = np.random.default_rng(AFFINE_CASES.index(case))
    ident = [1, 0, 0, 0, 1, 0, 0, 0]
    if case == "shaken":
        mats = []
        for _ in range(6):
            th = rng.uniform(-0.05, 0.05)
            s = np.exp(rng.uniform(-0.05, 0.05))
            tx, ty = rng.uniform(-12, 12, 2)
            mats.append([[s * np.cos(th), -s * np.sin(th), tx], [s * np.sin(th), s * np.cos(th), ty], [0, 0, 1.0]])
        coeffs = TW.prepare_inverse_coeffs(np.asarray(mats)).astype(np.float32)
        coeffs[:, 6:] = np.where(rng.random((6, 2)) < 0.5, np.float32(-0.0), np.float32(0.0))
        return np.concatenate([coeffs, np.float32([ident])])
    z = -0.0
    rows = {
        # c, f and g, h as -0.0; half-pixel translations (round-half-even
        # ties on every pixel); a zoom whose c lands on 1/4 and 1/2
        "signed_zeros": [[1, z, z, z, 1, z, z, z], [1.02, 0, z, 0, 0.98, z, z, 0], [1, 0, 0.5, 0, 1, -1.5, z, z],
                         [0.5, z, 20.25, z, 0.5, 11.5, 0, z], [1, 0, -0.5, 0, 1, 2.5, 0, 0]],
        # scales near 0 and negative: collapse onto one source pixel, a
        # mirror, a negative zoom with a shear, an exact zero matrix
        "scales": [[1e-8, 0, 3.3, 0, 1e-8, 20.7, z, z], [1e-30, 1e-30, 0, z, 1e-30, 0, 0, 0],
                   [-1, 0, W - 1, 0, -1, H - 1, 0, z], [-0.5, 0.1, 40, 0.05, -0.75, 30, z, 0],
                   [0, 0, 0, 0, 0, 0, 0, 0], ident],
        # displacements reaching the +-1e6 clip and past it
        "clip": [[1e5, 0, 0, 0, -1e5, 0, 0, 0], [1, 0, 5e6, 0, 1, -5e6, z, z], [1, 0, 1e6, 0, 1, -1e6, 0, 0],
                 [1, 0, -999999.5, 0, 1, 999999.5, 0, 0], [3e4, 2e4, -1e6, -2e4, 3e4, 1e6, 0, 0], ident],
    }[case]
    return np.asarray(rows, np.float32)


def _jax_padding(coeffs: np.ndarray, out_h: int, out_w: int, out_wh=None) -> np.ndarray:
    import jax.numpy as jnp

    from comfyui_video_stabilizer_tpu.ops import warp as JW

    if out_wh is None:
        mask, _ = JW._padding_stats_xla(jnp.asarray(coeffs), out_h, out_w, H, W)
    else:
        mask, _ = JW._padding_stats_bucket(jnp.asarray(coeffs), jnp.asarray(out_wh), out_h, out_w, H, W)
    return np.asarray(mask)


def test_affine_route_takes_signed_zeros_only():
    z = -0.0
    rows = [[1, 0, 0, 0, 1, 0, 0, 0], [1, 0, 0, 0, 1, 0, z, z], [1, 0, 0, 0, 1, 0, z, 0],
            [1, 0, 0, 0, 1, 0, 1e-12, 0], [1, 0, 0, 0, 1, 0, 0, -1e-30], [1, 0, 0, 0, 1, 0, float("nan"), 0],
            [1, 0, 0, 0, 1, 0, 0, float("inf")]]
    assert TW.affine_route(torch.tensor(rows, dtype=torch.float32)).tolist() == [True] * 3 + [False] * 4


def test_affine_plain_refuses_a_perspective_frame():
    coeffs = torch.tensor([[1, 0, 0, 0, 1, 0, 0, 0], [1, 0, 0, 0, 1, 0, 1e-12, 0]], dtype=torch.float32)
    with pytest.raises(ValueError, match="g == h == 0"):
        TW.padding_counts_affine_plain(coeffs, H, W, H, W)


@pytest.mark.parametrize("size", [(H, W), (48, 72)])
@pytest.mark.parametrize("case", AFFINE_CASES)
def test_affine_route_matches_plain_and_jax(case, size):
    out_h, out_w = size
    coeffs = _affine_coeffs(case)
    mask, counts = TW.padding_counts_affine_plain(torch.from_numpy(coeffs), out_h, out_w, H, W)
    ref_mask, ref_counts = TW.padding_counts_plain(torch.from_numpy(coeffs), out_h, out_w, H, W)
    assert torch.equal(mask, ref_mask) and torch.equal(counts, ref_counts)
    jax_mask = _jax_padding(coeffs, out_h, out_w)
    np.testing.assert_array_equal(mask.numpy(), jax_mask)
    np.testing.assert_array_equal(counts.numpy(), jax_mask.reshape(len(coeffs), -1).sum(1).astype(np.int64))
    assert 0 < int(counts.sum()) < len(coeffs) * out_h * out_w


@pytest.mark.parametrize("case", AFFINE_CASES)
def test_affine_route_bucket_matches_plain_and_jax(case):
    """A true canvas smaller than the static bucket: the mask everywhere,
    the count inside the true canvas only."""
    coeffs = _affine_coeffs(case)
    out_wh = np.array([W - 7, H - 3], np.int32)
    mask, counts = TW.padding_counts_affine_plain(torch.from_numpy(coeffs), H, W, H, W,
                                                  out_wh=torch.from_numpy(out_wh))
    ref_mask, ref_counts = TW.padding_counts_plain(torch.from_numpy(coeffs), H, W, H, W,
                                                   out_wh=torch.from_numpy(out_wh))
    assert torch.equal(mask, ref_mask) and torch.equal(counts, ref_counts)
    jax_mask = _jax_padding(coeffs, H, W, out_wh)
    np.testing.assert_array_equal(mask.numpy(), jax_mask)
    np.testing.assert_array_equal(counts.numpy(), jax_mask[:, :H - 3, :W - 7].reshape(len(coeffs), -1).sum(1))


@pytest.mark.parametrize("bands", [2, 3])
@pytest.mark.parametrize("case", AFFINE_CASES)
def test_affine_route_row_bands(case, bands):
    """Each band (its first row row0, a bucket's true canvas too) equals
    the general formula's, and the bands make up the whole canvas."""
    coeffs = torch.from_numpy(_affine_coeffs(case))
    out_wh = torch.tensor([W - 5, H - 8], dtype=torch.int32)
    whole = TW.padding_counts_affine_plain(coeffs, H, W, H, W, out_wh=out_wh)
    cuts = np.linspace(0, H, bands + 1).astype(int)
    parts = []
    for a, b in zip(cuts, cuts[1:]):
        part = TW.padding_counts_affine_plain(coeffs, int(b - a), W, H, W, row0=int(a), out_wh=out_wh)
        ref = TW.padding_counts_plain(coeffs, int(b - a), W, H, W, row0=int(a), out_wh=out_wh)
        assert torch.equal(part[0], ref[0]) and torch.equal(part[1], ref[1])
        parts.append(part)
    assert torch.equal(torch.cat([m for m, _ in parts], dim=1), whole[0])
    assert torch.equal(sum(c for _, c in parts), whole[1])


# ---------------------------------------------------------------------------
# K7
# ---------------------------------------------------------------------------

GH, GW = 72, 96  # tests/test_torch_greedy.py's frame
BLOCKS = [1, 16, 32, 64]
GREEDY_CASES = ["random", "clusters", "cap_mid_block", "all_invalid", "k_not_multiple_of_16", "one_frame",
                "duplicates", "min_distance_0", "max_kernel_corners"]


@functools.lru_cache(maxsize=None)
def _greedy_case(name: str):
    """(top_idx (B, K) int32, h, w, max_corners, min_distance): the cases
    of tests/test_torch_greedy.py, then duplicates, min_distance 0 and
    max_corners MAX_KERNEL_CORNERS with the walk cut inside a block."""
    from test_torch_greedy import CASES, _case

    if name in CASES:
        top_idx, max_corners = _case(name)
        return top_idx, GH, GW, max_corners, TLK.MIN_DISTANCE
    rng = np.random.default_rng(GREEDY_CASES.index(name))
    if name in ("duplicates", "min_distance_0"):
        # every tenth candidate repeats one before it (some in the same
        # block of 16, some far back); the last 40 are invalid
        rows = []
        for _ in range(3):
            idx = rng.permutation(GH * GW)[:600]
            for i in range(10, 600, 10):
                idx[i] = idx[i - rng.integers(1, 12 if i % 20 else i)]
            idx[-40:] = -1
            rows.append(idx)
        top_idx = np.stack(rows).astype(np.int32)
        return top_idx, GH, GW, 400, (TLK.MIN_DISTANCE if name == "duplicates" else 0.0)
    # a grid 8 px apart on 1024 x 512 (8192 points, all accepted), shuffled,
    # with 10 repeats among the first 100: the 6144th corner is candidate
    # 6153, inside a block of every size
    h, w = 512, 1024
    grid = (np.arange(4, h, 8)[:, None] * w + np.arange(4, w, 8)[None, :]).ravel()
    idx = rng.permutation(grid)
    idx = np.insert(idx, np.arange(20, 100, 8), idx[:10])
    return idx[None, :].astype(np.int32), h, w, TGR.MAX_KERNEL_CORNERS, TLK.MIN_DISTANCE


def _native_greedy(top_idx: np.ndarray, h: int, w: int, max_corners: int, min_distance: float):
    """The native greedy of each row's valid candidates, as float32 (x, y)."""
    pts = np.zeros((top_idx.shape[0], max_corners, 2), np.float32)
    counts = np.zeros(top_idx.shape[0], np.int32)
    for b, row in enumerate(top_idx):
        row = row[row >= 0]
        got = TLK._native.greedy_min_distance(row // w, row % w, h, w, min_distance, max_corners)
        pts[b, :len(got)] = got
        counts[b] = len(got)
    return pts, counts


@functools.lru_cache(maxsize=None)
def _greedy_refs(name: str):
    top_idx, h, w, max_corners, min_distance = _greedy_case(name)
    plain = TGR.greedy_plain(torch.from_numpy(top_idx), w, max_corners, min_distance)
    return plain, _native_greedy(top_idx, h, w, max_corners, min_distance)


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("case", GREEDY_CASES)
def test_blocked_greedy_matches_plain_and_native(case, block):
    top_idx, h, w, max_corners, min_distance = _greedy_case(case)
    (ref_pts, ref_counts), (host_pts, host_counts) = _greedy_refs(case)
    pts, counts = TGR.greedy_blocked_plain(torch.from_numpy(top_idx), w, max_corners, min_distance, block)
    assert pts.dtype == torch.float32 and counts.dtype == torch.int32
    assert torch.equal(pts, ref_pts) and torch.equal(counts, ref_counts)
    assert np.array_equal(pts.numpy(), host_pts) and np.array_equal(counts.numpy(), host_counts)
    if case == "duplicates":
        assert (counts.numpy() < (top_idx >= 0).sum(1)).all()
    if case == "min_distance_0":  # every valid candidate, repeats too, up to max_corners
        assert counts.tolist() == [400] * 3
    if case == "max_kernel_corners":
        assert counts.tolist() == [TGR.MAX_KERNEL_CORNERS]


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _mixed_batch() -> np.ndarray:
    """The affine frames of every case and perspective copies of half of
    them, shuffled into one batch."""
    rng = np.random.default_rng(11)
    affine = np.concatenate([_affine_coeffs(c) for c in AFFINE_CASES])
    persp = affine[::2].copy()
    persp[:, 6:] = rng.uniform(-4e-3, 4e-3, (len(persp), 2)).astype(np.float32)
    both = np.concatenate([affine, persp])
    return both[rng.permutation(len(both))]


@pytest.mark.cuda
@pytest.mark.parametrize("size", [(45, 67), (64, 128), (40, 72), (33, 132)])
def test_k8_mixed_routes_equal_plain(cuda, size):
    """One launch holds affine frames (signed zeros, ties, the clip) and
    perspective ones; whole canvas, a bucket and a row band; the widths
    take 1, 16, 8 and 4 pixels a thread."""
    out_h, out_w = size
    coeffs = torch.from_numpy(_mixed_batch()).to(cuda)
    routes = TW.affine_route(coeffs)
    assert 0 < int(routes.sum()) < len(coeffs)
    out_wh = torch.tensor([out_w - 9, out_h - 4], dtype=torch.int32, device=cuda)
    cuda_build.reset_launches()
    for kw in ({}, {"out_wh": out_wh}, {"row0": 11}):
        rows = out_h - 11 if kw.get("row0") else out_h
        mask, counts = TW.padding_counts(coeffs, rows, out_w, H, W, **kw)
        ref_mask, ref_counts = TW.padding_counts_plain(coeffs, rows, out_w, H, W, **kw)
        torch.cuda.synchronize()
        assert torch.equal(mask, ref_mask) and torch.equal(counts, ref_counts), kw
        aff = TW.padding_counts_affine_plain(coeffs[routes], rows, out_w, H, W, **kw)
        assert torch.equal(mask[routes], aff[0]) and torch.equal(counts[routes], aff[1]), kw
    assert cuda_build.LAUNCHES["padding_stats"] == 3


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["duplicates", "min_distance_0", "max_kernel_corners", "clusters", "cap_mid_block"])
def test_k7_blocks_equal_plain_and_native(cuda, case):
    top_idx, h, w, max_corners, min_distance = _greedy_case(case)
    t = torch.from_numpy(top_idx).to(cuda)
    cuda_build.reset_launches()
    pts, counts = TGR.greedy_min_distance(t, w, max_corners, min_distance)
    ref_pts, ref_counts = TGR.greedy_plain(t, w, max_corners, min_distance)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["greedy"] == 1
    assert torch.equal(pts, ref_pts) and torch.equal(counts, ref_counts)
    host_pts, host_counts = _native_greedy(top_idx, h, w, max_corners, min_distance)
    assert np.array_equal(pts.cpu().numpy(), host_pts) and np.array_equal(counts.cpu().numpy(), host_counts)
