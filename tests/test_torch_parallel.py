"""The port's device mesh and the warp by shard, against the JAX package's
mesh on the 8 virtual CPU devices of tests/conftest.py.

The port's CPU mesh repeats one device (``devices=["cpu"] * 8``), the
counterpart of the virtual devices: every shard runs its stage on its
own entry of the mesh, and no copy is made between entries that are the
same device.  Inputs are made with numpy from a seed.

Tolerances: the mesh shapes, ``data_shards`` and the errors equal JAX's
exactly; every sharded or banded warp, mask and ratio is ``torch.equal``
to the unsharded one (each frame and each row is computed from the same
inputs with the same arithmetic); the padding ratios equal the mask
mean bitwise.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402

from comfyui_video_stabilizer_tpu.parallel import mesh as JM  # noqa: E402
from comfyui_video_stabilizer_tpu.utils import meshinfo as JMI  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.models import motion_apply as TMA  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import warp as TW  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.parallel import mesh as TM  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.utils import meshinfo as TMI  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.utils import profiling as TP  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.utils import video_io as TIO  # noqa: E402
from test_motion_apply import _frames, _shake_meta  # noqa: E402

CPU8 = ["cpu"] * 8


def _matrices(n, seed, rot=0.02, trans=6.0, persp=0.0):
    rng = np.random.default_rng(seed)
    mats = np.tile(np.eye(3), (n, 1, 1))
    for i in range(n):
        th = rng.uniform(-rot, rot)
        mats[i, :2, :2] = [[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]]
        mats[i, :2, 2] = rng.uniform(-trans, trans, 2)
        mats[i, 2, :2] = rng.uniform(-persp, persp, 2)
    return mats


def test_mesh_shapes():
    mesh = TM.make_mesh(8, devices=CPU8)
    assert mesh.size == 8 and mesh.devices.shape == (8, 1)
    assert mesh.axis_names == ("data", "spatial")
    # data-major default, as in the JAX package
    assert mesh.shape == {"data": 8, "spatial": 1}
    assert mesh.lead == torch.device("cpu")


@pytest.mark.parametrize("n_devices,spatial", [(8, None), (8, 1), (8, 2), (8, 4), (8, 8), (4, 2), (2, None)])
def test_mesh_shape_matches_jax(n_devices, spatial):
    ours = TM.make_mesh(n_devices, spatial=spatial, devices=CPU8)
    ref = JM.make_mesh(n_devices, spatial=spatial)
    assert ours.shape == dict(ref.shape)
    assert ours.axis_names == tuple(ref.axis_names)
    assert ours.devices.shape == ref.devices.shape


@pytest.mark.parametrize("spatial", [3, 5, 0])
def test_mesh_spatial_must_divide(spatial):
    with pytest.raises(ValueError):
        JM.make_mesh(8, spatial=spatial)
    with pytest.raises(ValueError):
        TM.make_mesh(8, spatial=spatial, devices=CPU8)


def test_make_mesh_needs_a_card_or_devices():
    """With no devices given, the mesh is every card; with no card it
    raises: there is no CPU fallback."""
    if torch.cuda.is_available():
        mesh = TM.make_mesh()
        assert all(d.type == "cuda" for d in mesh.devices.reshape(-1))
        assert mesh.size == torch.cuda.device_count()
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TM.make_mesh()
        with pytest.raises(RuntimeError):
            TM.make_mesh(devices=["cuda:0"] * 2)


@pytest.mark.parametrize("n", [16, 8, 9, 2, 24, 7])
@pytest.mark.parametrize("spatial", [1, 4])
def test_data_shards_matches_jax(n, spatial):
    with jax.sharding.set_mesh(JM.make_mesh(8, spatial=spatial)):
        ref = JMI.data_shards(n)
    assert TMI.data_shards(n) is None
    with TMI.set_mesh(TM.make_mesh(8, spatial=spatial, devices=CPU8)):
        assert TMI.data_shards(n) == ref
        assert TMI.mesh_active()
    assert not TMI.mesh_active() and TMI.active_mesh() is None


def test_set_mesh_nests_and_restores():
    outer = TM.make_mesh(devices=CPU8)
    inner = TM.make_mesh(devices=CPU8[:4], spatial=2)
    with TMI.set_mesh(outer):
        with TMI.set_mesh(inner):
            assert TMI.active_mesh() is inner
        assert TMI.active_mesh() is outer
        with pytest.raises(KeyError):
            with TMI.set_mesh(inner):
                raise KeyError("inside")
        assert TMI.active_mesh() is outer
    assert TMI.active_mesh() is None


def test_move_on_a_repeated_device_is_no_copy():
    TM.reset_transfers()
    t = torch.arange(6.0)
    assert TM.move(t, "cpu", "halo") is t
    assert TM.TRANSFERS == {"halo": 0, "gather": 0, "scatter": 0}


def test_frame_shards_shape_gather_and_array():
    x = torch.arange(5 * 4 * 3 * 3, dtype=torch.float32).reshape(5, 4, 3, 3)
    shards = TM.split_frames(x, ["cpu"] * 3)
    assert [tuple(s.shape) for s in shards.shards] == [(1, 4, 3, 3), (2, 4, 3, 3), (2, 4, 3, 3)]
    assert shards.shape == (5, 4, 3, 3) and shards.ndim == 4
    assert shards.spans == [(0, 1), (1, 3), (3, 5)]
    assert torch.equal(shards.gather(), x)
    np.testing.assert_array_equal(np.asarray(shards), x.numpy())
    bands = TM.FrameShards([x[:, :1], x[:, 1:]], axis=1)
    assert bands.shape == (5, 4, 3, 3) and bands.spans == [(0, 1), (1, 4)]
    assert torch.equal(bands.gather(), x)
    assert torch.equal(shards.map(lambda t: t * 2).gather(), x * 2)


@pytest.mark.parametrize("n,h,spatial,expect", [
    (16, 64, 1, ("data", None, None, None)),
    (9, 64, 1, (None, "spatial", None, None)),
    (9, 64, 4, (None, "spatial", None, None)),
    (9, 62, 4, (None, None, None, None)),
])
def test_partition_spec_outcomes(n, h, spatial, expect):
    assert TM.partition_spec(TM.make_mesh(devices=CPU8, spatial=spatial), n, h) == expect


@pytest.mark.parametrize("interp", ["bilinear", "bicubic", "nearest"])
@pytest.mark.parametrize("bands", [1, 3, 4])
def test_k1_plain_row_band_equals_whole_frame(interp, bands):
    """K1's plain version with ``row0``: each band of rows is the same rows
    of the whole-canvas warp, bitwise; row0 = 0 is the whole canvas."""
    rng = np.random.default_rng(3)
    frames = torch.from_numpy(rng.random((3, 37, 45, 3), dtype=np.float32))
    coeffs = torch.from_numpy(TW.prepare_inverse_coeffs(_matrices(3, 4, persp=2e-4)).astype(np.float32))
    border = torch.tensor([0.2, 0.4, 0.6])
    whole = TW.warp_frames(frames, coeffs, border, 41, 50, interp)
    assert torch.equal(TW.warp_frames(frames, coeffs, border, 41, 50, interp, row0=0), whole)
    for r0, r1 in TM.even_spans(41, bands):
        band = TW.warp_frames(frames, coeffs, border, r1 - r0, 50, interp, row0=r0)
        assert torch.equal(band, whole[:, r0:r1])


def test_padding_ratios_equal_mask_mean():
    coeffs = torch.from_numpy(TW.prepare_inverse_coeffs(_matrices(6, 5, trans=9.0)).astype(np.float32))
    mask, ratios = TW.padding_stats(coeffs, 48, 64, 48, 64)
    assert torch.equal(ratios, mask.reshape(6, -1).mean(dim=1))
    assert float(ratios.max()) > 0.0


@pytest.mark.parametrize("layout", ["frames", "rows", "frames_tensor"])
@pytest.mark.parametrize("size", [(64, 48), (80, 60)])
def test_warp_clip_by_shard_equals_unsharded(layout, size):
    """warp_clip and warp_clip_with_mask under a mesh: frame shards (given
    as FrameShards or as one tensor the data axis splits), or row bands
    (an uneven clip on a spatial axis of 4), each torch.equal to the
    unsharded warp, with the frames and masks left in their shards."""
    n = 8 if layout != "rows" else 9
    rng = np.random.default_rng(6)
    frames = torch.from_numpy(rng.random((n, 48, 64, 3), dtype=np.float32))
    mats = _matrices(n, 7, trans=8.0)
    ref_f, ref_m, ref_r = TW.warp_clip_with_mask(frames, mats, size, "bilinear", (0.1, 0.2, 0.3))
    ref_plain = TW.warp_clip(frames, mats, size, "bicubic", (0.1, 0.2, 0.3))
    mesh = TM.make_mesh(devices=CPU8, spatial=4 if layout == "rows" else 1)
    src = TM.split_frames(frames, TM.data_devices(mesh)) if layout == "frames" else frames
    with TMI.set_mesh(mesh):
        out_f, out_m, out_r = TW.warp_clip_with_mask(src, mats, size, "bilinear", (0.1, 0.2, 0.3))
        out_plain = TW.warp_clip(src, mats, size, "bicubic", (0.1, 0.2, 0.3))
    axis = 1 if layout == "rows" else 0
    for out in (out_f, out_m, out_plain):
        assert isinstance(out, TM.FrameShards) and out.axis == axis
        assert len(out.shards) == (4 if layout == "rows" else 8)
    assert torch.equal(out_f.gather(), ref_f) and torch.equal(out_m.gather(), ref_m)
    assert torch.equal(out_r, ref_r) and torch.equal(out_plain.gather(), ref_plain)


def test_streamed_warp_splits_each_chunk(monkeypatch):
    """A streamed clip keeps its rule (will_stream on the whole clip) and
    splits each time chunk over the data axis; the host result equals the
    unstreamed one."""
    rng = np.random.default_rng(8)
    frames = torch.from_numpy(rng.random((16, 32, 40, 3), dtype=np.float32))
    mats = _matrices(16, 9)
    ref = TW.warp_clip_with_mask(frames, mats, (40, 32), "bilinear", 0.5)
    monkeypatch.setattr(TW, "CHUNK_BUDGET_BYTES", TW.clip_device_bytes(5, 32, 40, 32, 40))
    assert TW.will_stream(16, 32, 40, 32, 40)
    with TMI.set_mesh(TM.make_mesh(devices=CPU8[:4])):
        out = TW.warp_clip_with_mask(frames, mats, (40, 32), "bilinear", 0.5)
    for a, b in zip(out, ref):
        assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
        assert torch.equal(a, b)


@pytest.mark.parametrize("framing", ["crop_and_pad", "crop", "expand"])
def test_motion_apply_unblurred_by_shard(framing):
    """Motion Apply's unblurred path (config 2) under a mesh: K1 by shard,
    torch.equal to the unsharded call, frames and masks in FrameShards."""
    frames = _frames(n=8, h=48, w=64, seed=1)
    meta = _shake_meta(8, 64, 48, style="action", seed=5, amount=3.0)

    def run():
        ctx = TIO.normalize_video_input(torch.from_numpy(frames), device="cpu")
        return TMA.apply_motion(ctx, meta, (10, 20, 30), framing_mode=framing, device="cpu")

    ref = run()
    with TMI.set_mesh(TM.make_mesh(devices=CPU8[:4])):
        ours = run()
    assert isinstance(ours.frames, TM.FrameShards) and isinstance(ours.masks, TM.FrameShards)
    assert torch.equal(ours.frames.gather(), ref.frames) and torch.equal(ours.masks.gather(), ref.masks)
    assert ours.meta == ref.meta
    assert torch.equal(TIO.convert_masks_for_output(ours.masks), TIO.convert_masks_for_output(ref.masks))


def test_reconstruct_gathers_frame_shards():
    frames = torch.rand(6, 8, 10, 3)
    ctx = TIO.normalize_video_input(frames, device="cpu")
    out = TIO.reconstruct_video(TM.split_frames(frames, ["cpu"] * 3), ctx)
    assert isinstance(out, torch.Tensor) and torch.equal(out, frames)


def test_timing_enabled_follows_enable_timing():
    before = TP.timing_enabled()
    try:
        TP.enable_timing(True)
        assert TP.timing_enabled()
        TP.enable_timing(False)
        assert not TP.timing_enabled()
    finally:
        TP.enable_timing(before)


def test_device_trace_writes_a_chrome_trace(tmp_path, monkeypatch):
    monkeypatch.delenv("CVST_TRACE_DIR", raising=False)
    with TP.device_trace():
        torch.ones(4).sum()
    assert not list(tmp_path.iterdir())
    monkeypatch.setenv("CVST_TRACE_DIR", str(tmp_path / "env"))
    with TP.device_trace():
        torch.ones(4).sum()
    with TP.device_trace(str(tmp_path / "arg")):
        torch.ones(4).sum()
    for sub in ("env", "arg"):
        traces = list((tmp_path / sub).glob("cvst_trace_*.json"))
        assert len(traces) == 1 and traces[0].stat().st_size > 0


def test_lazy_apply_inverse_export():
    """The package exports apply_inverse_stabilization lazily: importing the
    package loads no engine; the export runs models/inverse.py's."""
    code = textwrap.dedent("""
        import sys
        import comfyui_video_stabilizer_tpu_torch as pkg
        assert "comfyui_video_stabilizer_tpu_torch.models.inverse" not in sys.modules
        assert callable(pkg.apply_inverse_stabilization)
        print("LAZY_OK")
    """)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0 and "LAZY_OK" in proc.stdout, proc.stderr[-2000:]

    import comfyui_video_stabilizer_tpu_torch as pkg
    from comfyui_video_stabilizer_tpu_torch.models import inverse as TINV
    from comfyui_video_stabilizer_tpu_torch.meta import motion_meta as TMM

    frames = torch.rand(3, 24, 32, 3)
    mats = [np.eye(3), np.array([[1.0, 0, 2.0], [0, 1, -1.0], [0, 0, 1]]), np.eye(3)]
    meta = {"stabilization_warp": TMM.build_stabilization_warp_meta(
        source_size=(32, 24), output_size=(32, 24), framing_mode="crop_and_pad", applied_matrices=mats)}
    ctx = TIO.normalize_video_input(frames, device="cpu")
    ours = pkg.apply_inverse_stabilization(ctx, meta, (127, 127, 127), device="cpu")
    ref = TINV.apply_inverse_stabilization(ctx, meta, (127, 127, 127), device="cpu")
    assert torch.equal(ours.frames, ref.frames) and torch.equal(ours.masks, ref.masks)


@pytest.mark.parametrize("n", [1, 2, 5, 135, 256])
def test_pairwise_sum_is_a_fixed_order_row_sum(n):
    """ops/flow_dis.py::_pairwise_sum: the row sum (to float32 rounding),
    each row the same alone as in a batch, and the pairwise order itself
    (checked against a float64-free recursive reference)."""
    from comfyui_video_stabilizer_tpu_torch.ops import flow_dis as TFD

    x = torch.from_numpy(np.random.default_rng(n).normal(size=(7, 3, n)).astype(np.float32))
    out = TFD._pairwise_sum(x)
    assert out.shape == (7, 3)
    assert torch.allclose(out, x.sum(-1), rtol=1e-5, atol=1e-5)
    assert torch.equal(TFD._pairwise_sum(x[2:3]), out[2:3])

    def tree(v):
        width = 1 << max(0, (len(v) - 1).bit_length())
        v = list(v) + [np.float32(0.0)] * (width - len(v))
        while len(v) > 1:
            half = len(v) // 2
            v = [np.float32(a + b) for a, b in zip(v[:half], v[half:])]
        return v[0]

    assert out[4, 1].item() == float(tree(x[4, 1].numpy()))
