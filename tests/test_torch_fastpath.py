"""The port's zero-sync fast path (models/fastpath.py) against the JAX
package's, and against the port's own host engine, on the CPU.

Both fast paths are forced on with ``CVST_FASTPATH=1`` (the CPU default
keeps the host engine) and ``CVST_FASTPATH_STRICT=1`` (a failure raises
instead of falling back), and a spy on each package's ``run_*_fast``
counts the calls that returned a result, so no case compares the host
engine with itself.  Inputs are made from a seed with numpy; the clips
are 8 frames of 144x256 (tests/test_fastpath.py::_shaken_clip for Flow,
tests/test_classic.py::_shaken_clip for Classic), one shape per
estimator so the JAX compiles are shared.

Tolerances:
- device math (``_inverse_coeffs_device``, ``_params_from_mats``,
  ``_mats_from_params``): relative difference <= 1e-6 (measured 8.8e-8
  for the inverse, 1.9e-9 for the parameters: XLA and PyTorch round
  atan2, sin, cos, exp and log within an ulp or two);
- ``_traj_program`` on the same fits: ``chosen`` and ``degenerate``
  identical, path / target / final matrices <= 1e-3 px (measured
  1.8e-4 px on 1280x720 corners), ``out_wh`` and ``fit`` equal; the crop
  search (keep_fov 0.925, so the bisection runs): ``found`` equal,
  ``ratio_full`` within 1e-6 relative (measured 3.9e-7: its corners go
  through sin and cos) and ``s_star`` equal but for the last bisection
  steps, <= 2**-16, where a ratio test lands within float32 rounding of
  the target (measured once in 8 cases: 2**-17);
- ``_crop_finalize`` on the same matrices: ``rect``, ``refine_ok`` and
  ``ratio_final`` equal;
- end to end, port fast path against JAX fast path: per-pair modes
  identical, matrices and applied matrices <= 1e-3, frames p99 <= 1e-3
  and max <= 1e-2, crop statuses and notes byte-equal (the tolerances
  of tests/test_torch_stabilize_flow.py);
- port fast path against the port's host engine, the docs/parity.md
  contract (as tests/test_fastpath.py holds the JAX package's): path
  <= 1e-3, applied matrices <= 2e-3, frames p99 <= 1e-3 and max
  <= 1e-2, masks <= 1e-3.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from comfyui_video_stabilizer_tpu.models import classic as JCL  # noqa: E402
from comfyui_video_stabilizer_tpu.models import fastpath as JFP  # noqa: E402
from comfyui_video_stabilizer_tpu.models import flow as JFL  # noqa: E402
from comfyui_video_stabilizer_tpu.utils import video_io as JIO  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.models import classic as TCL  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.models import fastpath as TFP  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.models import flow as TFL  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.models import stabilize as TST  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import cuda_build  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import flow_dis as TFD  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import lk as TLK  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.ops import warp as TW  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.utils.device import fetch_packed  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.utils import video_io as TIO  # noqa: E402
from test_classic import _shaken_clip as _classic_clip  # noqa: E402
from test_fastpath import _shaken_clip as _flow_clip  # noqa: E402

GRAY = (127, 127, 127)
H, W = 144, 256


@pytest.fixture(scope="module")
def flow_clip():
    return np.asarray(_flow_clip(n=8, h=H, w=W, seed=3), np.float32)


@pytest.fixture(scope="module")
def classic_clip():
    frames, _ = _classic_clip(n=8, h=H, w=W, seed=11)
    return np.asarray(frames, np.float32)


@pytest.fixture()
def taken(monkeypatch):
    """Fast paths forced on and strict; counts of the calls of each
    package's run_flow_fast / run_classic_fast that returned a result."""
    monkeypatch.setenv("CVST_FASTPATH", "1")
    monkeypatch.setenv("CVST_FASTPATH_STRICT", "1")
    counts = {}
    for pkg, mod in (("jax", JFP), ("torch", TFP)):
        for name in ("run_flow_fast", "run_classic_fast"):
            real = getattr(mod, name)

            def spy(*a, _real=real, _key=(pkg, name), **k):
                out = _real(*a, **k)
                counts[_key] = counts.get(_key, 0) + (out is not None)
                return out

            monkeypatch.setattr(mod, name, spy)
    return counts


def _stabilize(pkg, kind, frames, framing="crop_and_pad", mode="similarity", lock=False, keep_fov=0.6,
               **kw):
    args = (framing, mode, lock, 0.8, 0.6, keep_fov, GRAY, 24.0)
    if pkg == "jax":
        fn = JFL.stabilize_flow if kind == "flow" else JCL.stabilize_classic
        return fn(JIO.normalize_video_input(jnp.asarray(frames)), *args, **kw)
    fn = TFL.stabilize_flow if kind == "flow" else TCL.stabilize_classic
    return fn(TIO.normalize_video_input(torch.from_numpy(frames.copy()), device="cpu"), *args, device="cpu", **kw)


def _modes(meta):
    return [t["mode"] for t in meta["estimated_motion"]["per_transition"]]


def _pair_matrices(meta):
    return np.array([t["matrix"] for t in meta["estimated_motion"]["per_transition"]])


def _applied(meta):
    return np.array([e["applied_matrix"] for e in meta["stabilization_warp"]["per_frame"]])


def _frame_diff(a, b):
    d = np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))
    return float(np.quantile(d, 0.99)), float(d.max())


# ---------------------------------------------------------------------------
# (a) device math
# ---------------------------------------------------------------------------

def _test_matrices(n=12, seed=0):
    rng = np.random.default_rng(seed)
    mats = []
    for _ in range(n):
        th, s = rng.uniform(-0.05, 0.05), np.exp(rng.uniform(-0.05, 0.05))
        tx, ty = rng.uniform(-40, 40, 2)
        g, h = rng.uniform(-2e-4, 2e-4, 2)
        mats.append([[s * np.cos(th), -s * np.sin(th), tx], [s * np.sin(th), s * np.cos(th), ty], [g, h, 1.0]])
    mats.append(np.zeros((3, 3)))                       # singular: the identity fallback
    mats.append([[1.0, 0.0, 5.0], [0.0, 1.0, -3.0], [0.0, 0.0, 1.0]])
    return np.asarray(mats, np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1.0)))


def test_inverse_coeffs_device_matches_jax():
    m = _test_matrices()
    ours = TFP._inverse_coeffs_device(torch.from_numpy(m)).numpy()
    ref = np.asarray(JFP._inverse_coeffs_device(jnp.asarray(m)))
    assert ours.dtype == np.float32
    assert _rel(ours, ref) <= 1e-6
    np.testing.assert_array_equal(ours[-2], [1, 0, 0, 0, 1, 0, 0, 0])


@pytest.mark.parametrize("mode", ["translation", "similarity", "perspective"])
def test_params_and_mats_match_jax(mode):
    m = _test_matrices()[:-2]
    if mode != "perspective":
        m[:, 2] = [0.0, 0.0, 1.0]
    p_ours = TFP._params_from_mats(torch.from_numpy(m), mode)
    p_ref = JFP._params_from_mats(jnp.asarray(m), mode)
    assert _rel(p_ours.numpy(), p_ref) <= 1e-6
    assert _rel(TFP._mats_from_params(p_ours, mode).numpy(), JFP._mats_from_params(p_ref, mode)) <= 1e-6


# ---------------------------------------------------------------------------
# (b) the trajectory program on the same fits
# ---------------------------------------------------------------------------

def _synthetic_fits(kind, want_persp, b=11, seed=5):
    """Fit arrays of both kinds with degenerate pairs and rejected fits,
    so the sticky scan degrades and recovers."""
    rng = np.random.default_rng(seed)

    def mats(persp):
        out = np.tile(np.eye(3, dtype=np.float32), (b, 1, 1))
        th = rng.uniform(-0.01, 0.01, b)
        out[:, 0, 0] = out[:, 1, 1] = np.cos(th)
        out[:, 0, 1], out[:, 1, 0] = -np.sin(th), np.sin(th)
        out[:, :2, 2] = rng.uniform(-3, 3, (b, 2))
        if persp:
            out[:, 2, :2] = rng.uniform(-1e-5, 1e-5, (b, 2))
        return out

    valid = rng.integers(200, 400, b).astype(np.int32)
    valid[3] = 5                                          # degenerate
    n_in_s = (valid * rng.uniform(0.3, 1.0, b)).astype(np.int32)
    n_in_s[6] = 2                                         # similarity rejected
    if kind == "flow":
        fits = [valid]
        if want_persp:
            n_in_p = (valid * rng.uniform(0.3, 1.0, b)).astype(np.int32)
            n_in_p[1] = 1                                 # perspective rejected
            fits += [mats(True), n_in_p, valid, rng.uniform(0, 1, b).astype(np.float32)]
        fits += [mats(False), n_in_s, valid, rng.uniform(0, 1, b).astype(np.float32),
                 mats(False), rng.uniform(0, 1, b).astype(np.float32)]
        return fits
    det = rng.integers(300, 400, b).astype(np.int32)
    det[8] = 10                                           # too few corners
    surv = (det * 0.8).astype(np.int32)
    fits = [det, surv]
    if want_persp:
        fits += [mats(True), (surv * 0.7).astype(np.int32), surv]
    fits += [mats(False), np.minimum(n_in_s, surv), surv, mats(False)]
    return fits


TRAJ_MODES = [("similarity", False), ("translation", False), ("perspective", False), ("similarity", True)]


@pytest.mark.parametrize("framing", ["crop_and_pad", "expand", "crop"])
@pytest.mark.parametrize("mode,lock", TRAJ_MODES)
@pytest.mark.parametrize("kind", ["flow", "classic"])
def test_traj_program_matches_jax(kind, mode, lock, framing):
    want_persp = mode == "perspective"
    fits = _synthetic_fits(kind, want_persp)
    width, height = 1280, 720
    out_h_b, out_w_b = JFP._out_dims(framing, height, width)
    plan = None
    if framing != "crop":
        p = JFP._speculative_plan(out_h_b, out_w_b, height, width, affine=not want_persp)
        plan = (p["k"], p["th"], p["tw"], p["n_th"], p["n_tw"], p["sub"], p["margin"], p["extra"])
    static = dict(kind=kind, mode=mode, want_persp=want_persp, camera_lock=lock, window=9, width=width,
                  height=height, scale_xy=(0.75, 0.75), total_pts=3600 if kind == "flow" else 1,
                  framing=framing, bucket=(out_h_b, out_w_b))
    keep_fov = 0.925 if framing == "crop" else 0.6
    ref = JFP._traj_program(jnp.float32(0.8), jnp.float32(keep_fov), *[jnp.asarray(f) for f in fits],
                            plan=plan, **static)
    ours = TFP._traj_program(torch.tensor(0.8), torch.tensor(keep_fov), *[torch.from_numpy(f) for f in fits],
                             **static)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    ours = {k: v.numpy() for k, v in ours.items()}
    np.testing.assert_array_equal(ours["chosen"], ref["chosen"])
    np.testing.assert_array_equal(ours["degenerate"], ref["degenerate"])
    assert set(ours["chosen"].tolist()) != {int(JFP._MODE_IDX[mode])} or mode == "translation"
    for key in ("path", "target", "final", "apply", "matrices"):
        assert np.abs(ours[key] - ref[key]).max() <= 1e-3, key
    np.testing.assert_array_equal(ours["out_wh"], ref["out_wh"])
    assert bool(ours["fit"]) == bool(ref["fit"])
    if framing == "crop":
        assert bool(ours["crop_found"]) == bool(ref["crop_found"])
        assert abs(float(ours["crop_s_star"]) - float(ref["crop_s_star"])) <= 2.0 ** -16
        assert abs(float(ours["crop_ratio_full"]) - float(ref["crop_ratio_full"])) <= 1e-6 * float(ref["crop_ratio_full"])


def test_sticky_scan_matches_host_select():
    """The doubling composition against the engine's host loop
    (models/stabilize.py::sticky_select), on random acceptance flags."""
    rng = np.random.default_rng(2)
    b = 37
    for requested in ("perspective", "similarity", "translation"):
        acc = rng.random((b, 3)) < 0.6
        acc[:, 2] = True
        deg = rng.random(b) < 0.15
        fits = TST.PairFits(
            degenerate=deg,
            matrices={m: np.tile(np.eye(3, dtype=np.float32), (b, 1, 1)) for m in TFP._MODE_NAMES},
            confidences={m: np.ones(b) for m in TFP._MODE_NAMES},
            accepted={m: acc[:, i] for i, m in enumerate(TFP._MODE_NAMES)},
        )
        _, host_modes, _, _ = TST.sticky_select(requested, fits)
        chosen = TFP._sticky_modes(torch.from_numpy(acc), torch.from_numpy(deg), TFP._MODE_IDX[requested])
        assert [TFP._MODE_NAMES[i] for i in chosen.tolist()] == host_modes


# ---------------------------------------------------------------------------
# (c) the crop finalize on the same matrices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["shaken", "identity", "no_common"])
def test_crop_finalize_matches_jax(case):
    rng = np.random.default_rng(8)
    n = 6
    mats = np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))
    if case == "shaken":
        th = rng.uniform(-0.02, 0.02, n)
        mats[:, 0, 0] = mats[:, 1, 1] = 1.05 * np.cos(th)
        mats[:, 0, 1], mats[:, 1, 0] = -1.05 * np.sin(th), 1.05 * np.sin(th)
        mats[:, :2, 2] = rng.uniform(-9, 9, (n, 2))
    elif case == "no_common":
        mats[:, 0, 2] = np.where(np.arange(n) % 2, W, -W)
    _, iters = TFP._crop_search_iters(W, H)
    table = TFP._crop_w_table(W, H, "cpu")
    np.testing.assert_array_equal(table.numpy(), JFP._crop_w_table(W, H))
    ours = TFP._crop_finalize(torch.from_numpy(mats), table, width=W, height=H, iters=iters)
    ref = JFP._crop_finalize(jnp.asarray(mats), jnp.asarray(JFP._crop_w_table(W, H)), width=W, height=H,
                             iters=iters)
    np.testing.assert_array_equal(ours["rect"].numpy(), np.asarray(ref["rect"]))
    assert bool(ours["refine_ok"]) == bool(ref["refine_ok"]) == (case != "no_common")
    assert float(ours["ratio_final"]) == float(ref["ratio_final"])
    assert np.abs(ours["final"].numpy() - np.asarray(ref["final"])).max() <= 1e-3


# ---------------------------------------------------------------------------
# (d) end to end: port fast path against JAX fast path
# ---------------------------------------------------------------------------

E2E = [
    ("flow", "crop_and_pad", "similarity", False),
    ("flow", "crop_and_pad", "translation", False),
    ("flow", "crop_and_pad", "perspective", False),
    ("flow", "crop_and_pad", "similarity", True),
    ("flow", "expand", "similarity", False),
    ("flow", "crop", "similarity", False),
    ("classic", "crop_and_pad", "similarity", False),
    ("classic", "crop_and_pad", "perspective", False),
    ("classic", "expand", "similarity", True),
    ("classic", "crop", "similarity", False),
]


@pytest.mark.parametrize("kind,framing,mode,lock", E2E)
def test_fast_path_matches_jax_fast_path(taken, flow_clip, classic_clip, kind, framing, mode, lock):
    frames = flow_clip if kind == "flow" else classic_clip
    ref = _stabilize("jax", kind, frames, framing, mode, lock)
    ours = _stabilize("torch", kind, frames, framing, mode, lock)
    name = f"run_{kind}_fast"
    assert taken.get(("jax", name)) == 1 and taken.get(("torch", name)) == 1, taken
    jm, tm = ref.meta, ours.meta
    assert _modes(tm) == _modes(jm)
    assert tm["transform_mode_applied"] == jm["transform_mode_applied"]
    assert np.abs(_pair_matrices(tm) - _pair_matrices(jm)).max() <= 1e-3
    assert np.abs(_applied(tm) - _applied(jm)).max() <= 1e-3
    assert tm["stabilization_warp"]["output_size"] == jm["stabilization_warp"]["output_size"]
    assert set(tm["framing"]) == set(jm["framing"])
    for key in ("keep_fov_status", "keep_fov_note", "keep_fov_effective", "expanded_size"):
        assert tm["framing"].get(key) == jm["framing"].get(key), key
    if framing == "crop":
        assert tm["framing"]["stabilization_scale"] == jm["framing"]["stabilization_scale"]
        assert tm["framing"]["crop_origin"] == jm["framing"]["crop_origin"]
    assert tuple(ours.frames.shape) == tuple(np.asarray(ref.frames).shape)
    p99, mx = _frame_diff(ours.frames, ref.frames)
    assert p99 <= 1e-3 and mx <= 1e-2, (p99, mx)


def test_classic_fused_program_matches_jax_fast_path(taken, classic_clip):
    """The program the Classic graph captures (``_classic_estimate``, run
    eagerly on the CPU) against the JAX fast path's Classic estimation
    (``_tracks_and_fits``, then ``_traj_program``) on the same working
    grays at 1080p scale: ``chosen`` and ``degenerate`` identical, the
    matrices, path, target, final and applied matrices <= 1e-3 (the
    ``_traj_program`` tolerances above); then the whole crop_and_pad call
    of both fast paths."""
    from comfyui_video_stabilizer_tpu.ops import resize as JR

    width, height = 1920, 1080
    grays = np.array(JR.gray_for_estimation(jnp.asarray(classic_clip), None), np.float32)
    strength, smooth, keep_fov, window, scale_xy = TFP._trajectory_args(0.8, 0.6, 24.0, False, 0.6, width, height,
                                                                         (W, H))
    static = dict(mode="similarity", camera_lock=False, window=window, width=width, height=height,
                  scale_xy=scale_xy)
    (_, det, _, _), fits = JCL._tracks_and_fits(jnp.asarray(grays), None, 0, False)
    p = JFP._speculative_plan(height, width, height, width, affine=True)
    plan = (p["k"], p["th"], p["tw"], p["n_th"], p["n_tw"], p["sub"], p["margin"], p["extra"])
    ref = JFP._traj_program(jnp.float32(strength), jnp.float32(keep_fov), det, *fits, kind="classic",
                            want_persp=False, total_pts=1, plan=plan, framing="crop_and_pad",
                            bucket=(height, width), **static)
    ours = TFP._classic_estimate(torch.from_numpy(grays), torch.tensor(strength), torch.tensor(keep_fov),
                                 seed=0, **static)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    ours = {k: v.numpy() for k, v in ours.items()}
    np.testing.assert_array_equal(ours["chosen"], ref["chosen"])
    np.testing.assert_array_equal(ours["degenerate"], ref["degenerate"])
    assert not ours["degenerate"].any()
    for key in ("matrices", "path", "target", "final", "apply"):
        assert np.abs(ours[key] - ref[key]).max() <= 1e-3, key
    jm, tm = _stabilize("jax", "classic", classic_clip).meta, _stabilize("torch", "classic", classic_clip).meta
    assert taken[("jax", "run_classic_fast")] == 1 and taken[("torch", "run_classic_fast")] == 1
    assert _modes(tm) == _modes(jm) and np.abs(_applied(tm) - _applied(jm)).max() <= 1e-3


# ---------------------------------------------------------------------------
# (e) port fast path against the port's host engine (docs/parity.md)
# ---------------------------------------------------------------------------

HOST = [
    ("flow", "crop_and_pad", "similarity", False),
    ("flow", "crop_and_pad", "translation", False),
    ("flow", "crop_and_pad", "perspective", False),
    ("flow", "crop_and_pad", "similarity", True),
    ("flow", "expand", "similarity", False),
    ("flow", "crop", "similarity", False),
    ("flow", "crop", "perspective", False),
    ("classic", "crop_and_pad", "similarity", False),
    ("classic", "crop_and_pad", "translation", True),
    ("classic", "crop_and_pad", "perspective", False),
    ("classic", "expand", "similarity", False),
    ("classic", "crop", "similarity", False),
]


@pytest.mark.parametrize("kind,framing,mode,lock", HOST)
def test_fast_path_matches_host_engine(taken, monkeypatch, flow_clip, classic_clip, kind, framing, mode, lock):
    frames = flow_clip if kind == "flow" else classic_clip
    fast = _stabilize("torch", kind, frames, framing, mode, lock)
    assert taken.get(("torch", f"run_{kind}_fast")) == 1, taken
    monkeypatch.setenv("CVST_FASTPATH", "0")
    host = _stabilize("torch", kind, frames, framing, mode, lock)
    fm, hm = fast.meta, host.meta
    assert _modes(fm) == _modes(hm)
    assert fm["transform_mode_applied"] == hm["transform_mode_applied"]
    assert list(fm) == list(hm) and list(fm["framing"]) == list(hm["framing"])
    np.testing.assert_allclose(fm["estimated_motion"]["path"], hm["estimated_motion"]["path"], atol=1e-3)
    assert np.abs(_applied(fm) - _applied(hm)).max() <= 2e-3
    assert fm["stabilization_warp"]["output_size"] == hm["stabilization_warp"]["output_size"]
    for key in ("keep_fov_status", "keep_fov_note", "keep_fov_effective"):
        assert fm["framing"].get(key) == hm["framing"].get(key), key
    if framing == "crop":
        np.testing.assert_allclose(fm["framing"]["stabilization_scale"], hm["framing"]["stabilization_scale"],
                                   atol=1e-3)
    p99, mx = _frame_diff(fast.frames, host.frames)
    assert p99 <= 1e-3 and mx <= 1e-2, (p99, mx)
    np.testing.assert_allclose(fast.masks.numpy(), host.masks.numpy(), atol=1e-3)
    assert abs(fm["padding_fraction_mean"] - hm["padding_fraction_mean"]) <= 1e-3


def test_cpu_default_keeps_host_engine(monkeypatch, flow_clip):
    """Without CVST_FASTPATH the CPU frames take the host engine."""
    monkeypatch.delenv("CVST_FASTPATH", raising=False)
    calls = []
    real = TFP.run_flow_fast
    monkeypatch.setattr(TFP, "run_flow_fast", lambda *a, **k: calls.append(real(*a, **k)) or calls[-1])
    _stabilize("torch", "flow", flow_clip[:4])
    assert calls == [None] and not TFP.enabled(torch.zeros(1))


# ---------------------------------------------------------------------------
# (f)-(i) the expand bucket miss, failures and interrupts
# ---------------------------------------------------------------------------

def test_expand_bucket_miss_rewarps_exact(taken, monkeypatch, flow_clip):
    rewarps = []
    real = TW.warp_clip_with_mask
    monkeypatch.setattr(TW, "warp_clip_with_mask", lambda *a, **k: rewarps.append(a[2]) or real(*a, **k))
    held = _stabilize("torch", "flow", flow_clip, "expand")
    assert taken[("torch", "run_flow_fast")] == 1 and rewarps == []      # the bucket held: sliced
    monkeypatch.setattr(TFP, "EXPAND_MARGIN_PX", 0)
    missed = _stabilize("torch", "flow", flow_clip, "expand")
    assert taken[("torch", "run_flow_fast")] == 2
    size = tuple(missed.meta["framing"]["expanded_size"])
    assert rewarps == [size] and size[0] > W and size[1] > H             # re-warped at the exact canvas
    # the same canvas and matrices; the re-warp inverts them on the host in float64
    assert missed.meta["framing"]["expanded_size"] == held.meta["framing"]["expanded_size"]
    assert np.array_equal(_applied(missed.meta), _applied(held.meta))
    p99, mx = _frame_diff(missed.frames, held.frames)
    assert p99 <= 1e-3 and mx <= 1e-2 and (missed.masks != held.masks).float().mean() <= 1e-3
    monkeypatch.setenv("CVST_FASTPATH", "0")
    host = _stabilize("torch", "flow", flow_clip, "expand")
    p99, _ = _frame_diff(missed.frames, host.frames)
    assert tuple(missed.frames.shape) == tuple(host.frames.shape) and p99 <= 1e-3


def _host_spies(monkeypatch):
    """Calls of the host engine's Flow fits, its Classic fits fetch and the
    TV-L1 tier."""
    calls = []
    for mod, name in ((TFL, "_fused_fits_sampled"), (TCL, "_fetch_fits"), (TFL.TV, "tvl1_flow")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name, **k: calls.append(_n) or _r(*a, **k))
    return calls


@pytest.mark.parametrize("kind", ["flow", "classic"])
def test_kernel_error_propagates_from_fast_path(monkeypatch, flow_clip, kind):
    monkeypatch.setenv("CVST_FASTPATH", "1")
    monkeypatch.delenv("CVST_FASTPATH_STRICT", raising=False)
    host = _host_spies(monkeypatch)

    def refused(*_a, **_k):
        raise cuda_build.KernelError("CUDA kernel 'x' failed to launch: error 9")

    monkeypatch.setattr(TFD if kind == "flow" else TLK, "dis_flow_fit" if kind == "flow" else "gftt_batch", refused)
    with pytest.raises(cuda_build.KernelError, match="error 9"):
        _stabilize("torch", kind, flow_clip[:4])
    assert host == []


@pytest.mark.parametrize("kind", ["flow", "classic"])
def test_other_failures_fall_back_to_host_engine(monkeypatch, flow_clip, kind):
    monkeypatch.setenv("CVST_FASTPATH", "0")
    ref = _stabilize("torch", kind, flow_clip[:4])
    monkeypatch.setenv("CVST_FASTPATH", "1")
    monkeypatch.delenv("CVST_FASTPATH_STRICT", raising=False)
    entered = []

    def broken(*_a, **_k):
        entered.append(1)
        raise RuntimeError("synthetic fast-path failure")

    monkeypatch.setattr(TFP, "_traj_program", broken)
    host = _host_spies(monkeypatch)
    out = _stabilize("torch", kind, flow_clip[:4])
    assert entered == [1] and host[:1] == ["_fused_fits_sampled" if kind == "flow" else "_fetch_fits"]
    assert torch.equal(out.frames, ref.frames) and out.meta["estimated_motion"] == ref.meta["estimated_motion"]
    monkeypatch.setenv("CVST_FASTPATH_STRICT", "1")
    with pytest.raises(RuntimeError, match="synthetic fast-path failure"):
        _stabilize("torch", kind, flow_clip[:4])


def test_capture_failure_raises_and_served_counts_results(monkeypatch):
    """A failure while a graph is captured raises (the capture condition is
    static, so it is a fault, not a fallback); a later ordinary failure
    still falls back; SERVED counts only the calls that returned a result."""
    monkeypatch.delenv("CVST_FASTPATH_STRICT", raising=False)

    def capturing():
        TFP._CAPTURE.open = True
        raise RuntimeError("synthetic capture failure")

    def broken():
        raise RuntimeError("synthetic fast-path failure")

    served = TFP.SERVED["flow"]
    with pytest.raises(RuntimeError, match="capture failure"):
        TFP.offer("flow", capturing)
    assert TFP.offer("flow", broken) is None
    assert TFP.offer("flow", lambda: None) is None
    assert TFP.offer("flow", lambda: {"ok": 1}) == {"ok": 1}
    assert TFP.SERVED["flow"] == served + 1


@pytest.mark.parametrize("kind", ["flow", "classic"])
def test_interrupt_passes_through_fast_path(taken, monkeypatch, flow_clip, kind):
    """2-pair estimation chunks, so the fast path's chunked estimation
    ticks; the interrupt raised at the first tick reaches the caller as
    itself and neither the rest of the fast path nor the host engine runs."""
    mod = TFL if kind == "flow" else TCL
    monkeypatch.setattr(mod, "estimation_chunk_spans", lambda n: TST.estimation_chunk_spans(n, chunk=2))
    host = _host_spies(monkeypatch)
    traj = []
    real = TFP._traj_program
    monkeypatch.setattr(TFP, "_traj_program", lambda *a, **k: traj.append(1) or real(*a, **k))

    class Stop(Exception):
        pass

    def interrupt():
        raise Stop()

    with pytest.raises(Stop):
        _stabilize("torch", kind, flow_clip, interrupt_check=interrupt)
    assert host == [] and traj == []
    assert taken.get(("torch", f"run_{kind}_fast"), 0) == 0


def test_progress_ticks_match_host_engine(taken, monkeypatch, flow_clip):
    ticks = {}
    for flag in ("1", "0"):
        monkeypatch.setenv("CVST_FASTPATH", flag)
        ticks[flag] = []
        _stabilize("torch", "flow", flow_clip, progress=lambda d, t, _l=ticks[flag]: _l.append((d, t)))
    assert taken[("torch", "run_flow_fast")] == 1
    assert ticks["1"] == ticks["0"] and ticks["1"]


def test_fetch_is_one_exact_copy():
    t = {"a": torch.tensor([1.5, -2.25], dtype=torch.float32), "b": torch.tensor([[3, 2**40]]),
         "c": torch.tensor(True), "d": torch.tensor([7, 9], dtype=torch.int32)}
    out = fetch_packed(t)
    for k, v in t.items():
        assert out[k].shape == tuple(v.shape) and (out[k] == v.numpy()).all(), k
    assert out["a"].dtype == np.float32 and out["c"].dtype == np.bool_
