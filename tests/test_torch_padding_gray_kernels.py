"""The padding stats (``ops/warp.py``: K8 and ``padding_counts_plain``) and
the gray + integer pool (``ops/resize.py``: K9 and ``gray_pool_plain``)
against the JAX package's XLA stages they stand for, and each kernel
against its plain version on the card.

References, run on the CPU: ``comfyui_video_stabilizer_tpu/ops/warp.py::
_padding_stats_xla`` and ``_padding_stats_bucket``, and
``comfyui_video_stabilizer_tpu/ops/resize.py::_gray_pool_kernel``,
``_gray_kernel``, ``make_gray`` and ``_box_pool_kernel``.  Inputs are made
with numpy from a seed.

Tolerance: bitwise (``np.array_equal``) everywhere, since every quantity
here is exact: masks are 0 or 1, counts are integers, grays are the same
float32 operations in the same order (the luma's fused multiply-adds,
the quantization, the row-major patch sum that XLA's CPU reduce takes,
the reciprocal).  One recorded deviation: ``_padding_stats_xla``'s ratio
is the count times the float32 reciprocal of the area, the port's the
count over the area (``ops/warp.py::_ratios``, a true division), so
there the counts are held equal and the ratios within one ulp.

The ``cuda`` cases hold K8 and K9 ``torch.equal`` to their plain versions
on the card (odd sizes, ``out_w % 4 != 0``, launches split at 65,535
frames); they import no JAX, so the file runs there without the suite's
conftest:

    python -m pytest --noconftest tests/test_torch_padding_gray_kernels.py -q -m cuda
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

from comfyui_video_stabilizer_tpu_torch.ops import cuda_build  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import resize as TR  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import warp as TW  # noqa: E402

H, W = 45, 67
COEFF_CASES = ["shaken", "perspective", "degenerate"]


def _coeffs(case: str, n: int = 6, seed: int = 0) -> np.ndarray:
    """(n, 8) float32 inverse coefficients: a shaken similarity clip, a
    perspective one, or rows whose denominator 1 + g*x + h*y is exactly 0
    on a line of output pixels (and a zero matrix, denominator 1)."""
    rng = np.random.default_rng(seed + COEFF_CASES.index(case))
    if case == "degenerate":
        rows = [[1, 0, 0, 0, 1, 0, -0.125, 0], [1, 0, 0, 0, 1, 0, 0, -1 / 32],
                [1, 0.01, 2, 0, 1, -3, -1 / 16, -1 / 32], [0, 0, 0, 0, 0, 0, 0, 0]]
        return np.asarray(rows, np.float32)
    mats = []
    for _ in range(n):
        th = rng.uniform(-0.05, 0.05)
        s = np.exp(rng.uniform(-0.05, 0.05))
        tx, ty = rng.uniform(-12, 12, 2)
        g, h = (rng.uniform(-4e-3, 4e-3, 2) if case == "perspective" else (0.0, 0.0))
        mats.append([[s * np.cos(th), -s * np.sin(th), tx], [s * np.sin(th), s * np.cos(th), ty], [g, h, 1.0]])
    return TW.prepare_inverse_coeffs(np.asarray(mats)).astype(np.float32)


def _jax_padding(coeffs: np.ndarray, out_wh=None):
    import jax.numpy as jnp

    from comfyui_video_stabilizer_tpu.ops import warp as JW

    if out_wh is None:
        mask, ratios = JW._padding_stats_xla(jnp.asarray(coeffs), H, W, H, W)
    else:
        mask, ratios = JW._padding_stats_bucket(jnp.asarray(coeffs), jnp.asarray(out_wh), H, W, H, W)
    return np.asarray(mask), np.asarray(ratios)


@pytest.mark.parametrize("case", COEFF_CASES)
def test_padding_plain_matches_jax_xla(case):
    coeffs = _coeffs(case)
    ref_mask, ref_ratios = _jax_padding(coeffs)
    mask, counts = TW.padding_counts_plain(torch.from_numpy(coeffs), H, W, H, W)
    assert counts.dtype == torch.int64
    np.testing.assert_array_equal(mask.numpy(), ref_mask)
    np.testing.assert_array_equal(counts.numpy(), ref_mask.reshape(len(coeffs), -1).sum(1).astype(np.int64))
    assert 0 < counts.sum() < counts.numel() * H * W
    _, ratios = TW.padding_stats(torch.from_numpy(coeffs), H, W, H, W)
    np.testing.assert_array_equal(ratios.numpy(), counts.numpy().astype(np.float32) / np.float32(H * W))
    assert np.all(np.abs(ratios.numpy() - ref_ratios) <= np.spacing(ref_ratios))


@pytest.mark.parametrize("case", COEFF_CASES)
def test_padding_bucket_plain_matches_jax(case):
    """A true canvas smaller than the static bucket: the mask everywhere,
    the ratio over the true canvas only."""
    coeffs = _coeffs(case, seed=3)
    out_wh = np.array([W - 7, H - 3], np.int32)
    ref_mask, ref_ratios = _jax_padding(coeffs, out_wh)
    mask, ratios = TW.padding_stats_bucket(torch.from_numpy(coeffs), torch.from_numpy(out_wh), H, W, H, W)
    np.testing.assert_array_equal(mask.numpy(), ref_mask)
    np.testing.assert_array_equal(ratios.numpy(), ref_ratios)
    _, counts = TW.padding_counts_plain(torch.from_numpy(coeffs), H, W, H, W, out_wh=torch.from_numpy(out_wh))
    np.testing.assert_array_equal(counts.numpy(), ref_mask[:, :H - 3, :W - 7].reshape(len(coeffs), -1).sum(1))


@pytest.mark.parametrize("bands", [2, 3])
def test_padding_row_bands_concatenate_to_whole(bands):
    coeffs = torch.from_numpy(_coeffs("perspective", seed=5))
    whole_mask, whole_counts = TW.padding_counts_plain(coeffs, H, W, H, W)
    cuts = np.linspace(0, H, bands + 1).astype(int)
    parts = [TW.padding_counts_plain(coeffs, int(b - a), W, H, W, row0=int(a)) for a, b in zip(cuts, cuts[1:])]
    assert torch.equal(torch.cat([m for m, _ in parts], dim=1), whole_mask)
    assert torch.equal(sum(c for _, c in parts), whole_counts)


def _frames(shape, seed: int) -> np.ndarray:
    """Values in [-0.1, 1.1): the quantization's clamp is exercised at both ends."""
    return (np.random.default_rng(seed).random(shape) * 1.2 - 0.1).astype(np.float32)


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("quantize", [True, False])
@pytest.mark.parametrize("fy,fx", [(1, 1), (2, 2), (3, 3), (4, 4), (2, 3)])
def test_gray_pool_plain_matches_jax(fy, fx, quantize, channels):
    import jax.numpy as jnp

    from comfyui_video_stabilizer_tpu.ops import resize as JR

    frames = _frames((3, 9 * fy, 13 * fx, channels), seed=10 * fy + fx)
    if channels == 3:
        ref = (JR._gray_kernel(jnp.asarray(frames), quantize) if fy == fx == 1
               else JR._gray_pool_kernel(jnp.asarray(frames), fy, fx, quantize))
    else:
        ref = JR.make_gray(frames, quantize=quantize)
        if fy * fx > 1:
            ref = JR._box_pool_kernel(ref, fy, fx)
    ours = TR.gray_pool_plain(torch.from_numpy(frames), fy, fx, quantize)
    assert ours.shape == (3, 9, 13)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("quarter", range(4))
def test_luma_of_every_uint8_triple_matches_jax(quarter):
    """All 16,777,216 (r, g, b) levels / 255, a quarter of them a case (r
    in [64q, 64q + 64)), as four 1024 x 1024 frames: the plain luma, alone
    and quantized, against JAX's ``_gray_kernel``."""
    import jax.numpy as jnp

    from comfyui_video_stabilizer_tpu.ops import resize as JR

    levels = np.arange(256, dtype=np.float32) / np.float32(255.0)
    idx = np.arange(quarter << 22, (quarter + 1) << 22, dtype=np.uint32)
    frames = np.stack([levels[idx >> 16], levels[(idx >> 8) & 255], levels[idx & 255]], -1).reshape(4, 1024, 1024, 3)
    for quantize in (True, False):
        ref = np.asarray(JR._gray_kernel(jnp.asarray(frames), quantize))
        ours = TR.gray_pool_plain(torch.from_numpy(frames), 1, 1, quantize).numpy()
        np.testing.assert_array_equal(ours, ref)


def test_gray_does_not_depend_on_chunking():
    """37 frames: whole, per frame and in chunks of 5, through the plain
    version and through gray_for_estimation (x2 and the matrix path)."""
    frames = torch.from_numpy(_frames((37, 36, 52, 3), seed=7))
    whole = TR.gray_pool_plain(frames, 2, 2)
    assert torch.equal(torch.cat([TR.gray_pool_plain(frames[s:s + 5], 2, 2) for s in range(0, 37, 5)]), whole)
    for working in ((26, 18), (20, 15)):
        est = TR.gray_for_estimation(frames, working)
        assert torch.equal(torch.cat([TR.gray_for_estimation(frames[i:i + 1], working) for i in range(37)]), est)
    assert torch.equal(TR.gray_for_estimation(frames, (26, 18)), whole)


def test_cpu_tensors_take_the_plain_versions_without_launching():
    cuda_build.reset_launches()
    coeffs = torch.from_numpy(_coeffs("shaken"))
    out_wh = torch.tensor([W - 5, H - 2], dtype=torch.int32)
    for kw in ({}, {"row0": 7}, {"out_wh": out_wh}):
        got = TW.padding_counts(coeffs, H - 7, W, H, W, **kw)
        ref = TW.padding_counts_plain(coeffs, H - 7, W, H, W, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
    frames = torch.from_numpy(_frames((2, 24, 36, 3), seed=1))
    assert torch.equal(TR.gray_pool(frames, 4, 4), TR.gray_pool_plain(frames, 4, 4))
    assert torch.equal(TR.make_gray(frames, False), TR.gray_pool_plain(frames, 1, 1, False))
    assert all(v == 0 for v in cuda_build.LAUNCHES.values()), cuda_build.LAUNCHES


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("size", [(45, 67), (64, 128), (33, 130)])
@pytest.mark.parametrize("case", COEFF_CASES)
def test_k8_equals_plain(cuda, case, size):
    """Mask and counts, whole canvas, a bucket and two row bands; the
    sizes are odd, a multiple of 4 wide and 2 mod 4 wide."""
    out_h, out_w = size
    coeffs = torch.from_numpy(_coeffs(case)).to(cuda)
    out_wh = torch.tensor([out_w - 9, out_h - 4], dtype=torch.int32, device=cuda)
    cuda_build.reset_launches()
    for kw in ({}, {"out_wh": out_wh}, {"row0": 0}, {"row0": 11}):
        rows = out_h - 11 if kw.get("row0") else out_h
        mask, counts = TW.padding_counts(coeffs, rows, out_w, H, W, **kw)
        ref_mask, ref_counts = TW.padding_counts_plain(coeffs, rows, out_w, H, W, **kw)
        torch.cuda.synchronize()
        assert torch.equal(mask, ref_mask) and torch.equal(counts, ref_counts), kw
    assert cuda_build.LAUNCHES["padding_stats"] == 4
    mask, ratios = TW.padding_stats_bucket(coeffs, out_wh, out_h, out_w, H, W)
    cpu_mask, cpu_ratios = TW.padding_stats_bucket(coeffs.cpu(), out_wh.cpu(), out_h, out_w, H, W)
    assert torch.equal(mask.cpu(), cpu_mask) and torch.equal(ratios.cpu(), cpu_ratios)


@pytest.mark.cuda
def test_k8_splits_past_65535_frames(cuda):
    coeffs = torch.from_numpy(np.tile(_coeffs("shaken", n=8), (8192, 1))).to(cuda)
    cuda_build.reset_launches()
    mask, counts = TW.padding_counts(coeffs, 8, 12, 8, 12)
    ref_mask, ref_counts = TW.padding_counts_plain(coeffs, 8, 12, 8, 12)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["padding_stats"] == 2
    assert torch.equal(mask, ref_mask) and torch.equal(counts, ref_counts)


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("quantize", [True, False])
@pytest.mark.parametrize("fy,fx", [(1, 1), (2, 2), (3, 3), (4, 4), (2, 3)])
def test_k9_equals_plain(cuda, fy, fx, quantize, channels):
    frames = torch.from_numpy(_frames((5, 27 * fy, 41 * fx, channels), seed=fy * fx)).to(cuda)
    cuda_build.reset_launches()
    out = TR.gray_pool(frames, fy, fx, quantize)
    ref = TR.gray_pool_plain(frames, fy, fx, quantize)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["gray_pool"] == 1
    assert torch.equal(out, ref)


@pytest.mark.cuda
def test_k9_splits_past_65535_frames(cuda):
    frames = torch.from_numpy(_frames((65536, 4, 8, 3), seed=3)).to(cuda)
    cuda_build.reset_launches()
    out = TR.gray_pool(frames, 2, 2)
    ref = TR.gray_pool_plain(frames, 2, 2)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["gray_pool"] == 2
    assert torch.equal(out, ref)


@pytest.mark.cuda
def test_k9_streamed_chunks_equal_resident_clip(cuda):
    """A clip on the host is uploaded 16 frames at a time (3 launches for
    37 frames); the same clip on the card is one launch; equal grays."""
    host = torch.from_numpy(_frames((37, 72, 96, 3), seed=4))
    cuda_build.reset_launches()
    streamed = TR.gray_for_estimation(host, (24, 18), device=cuda)
    assert cuda_build.LAUNCHES["gray_pool"] == 3
    resident = TR.gray_for_estimation(host.to(cuda), (24, 18))
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["gray_pool"] == 4
    assert torch.equal(streamed, resident)
    assert torch.equal(resident.cpu(), TR.gray_for_estimation(host, (24, 18)))


@pytest.mark.cuda
def test_k8_k9_refuse_arguments(cuda):
    frames = torch.zeros((2, 8, 8, 3), device=cuda)
    with pytest.raises(cuda_build.KernelArgumentError, match="1 or 3 channels"):
        TR.gray_pool(torch.zeros((2, 8, 8, 4), device=cuda), 2, 2)
    with pytest.raises(cuda_build.KernelArgumentError, match="does not divide"):
        TR.gray_pool(frames, 3, 3)
    with pytest.raises(cuda_build.KernelTypeError, match="float32"):
        TR.gray_pool(frames.double(), 2, 2)
    coeffs = torch.zeros((2, 8), device=cuda)
    with pytest.raises(cuda_build.KernelArgumentError, match=r"\(N, 8\)"):
        TW.padding_counts(torch.zeros((2, 9), device=cuda), 8, 8, 8, 8)
    with pytest.raises(cuda_build.KernelTypeError, match="int32"):
        TW.padding_counts(coeffs, 8, 8, 8, 8, out_wh=torch.zeros(2, dtype=torch.int64, device=cuda))
    with pytest.raises(cuda_build.KernelArgumentError, match="positive"):
        TW.padding_counts(coeffs, 0, 8, 8, 8)
