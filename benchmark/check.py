"""How ``correct`` is decided: the program's outputs against the plain
reference's, number by number, each against its limit.

The reference is whichever the configuration names (the default's
``engine.py`` states the contract): the path converter and the corner
distance come from the module that defines the ``Result`` handed in, the
path width from ``Result.path``, the framing mode from
``Result.framing["mode"]``.

The numbers (``NUMBERS``), each the worst over the clip:

- ``modes_off``: transitions whose estimated mode differs (exact).
- ``motion_px``: the widest distance between where the program's and the
  reference's per-transition matrices put a frame corner, in px.
- ``path_px``: the same for the integrated and the target camera paths,
  read at the reference path's width (infinite where the program's differs).
- ``warp_px``: the same for the applied warp (``stabilization_warp`` and
  ``motion_meta``'s matrices).
- ``frames_mae``: the worst frame's mean absolute difference of the
  stabilized frames.
- ``masks_off``: the worst frame's share of padding-mask pixels that differ.
- ``framing_px``: the widest gap of the framing's safe region and centre
  offset, in px.
- ``ratio_gap``: the widest gap of the content ratios and padding fractions.
- ``meta_off``: meta fields that must be equal and are not (exact).
- ``outputs_off``: outputs of the wrong device, dtype or shape (exact).
"""

from __future__ import annotations

import json
import math
import pathlib
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

NUMBERS = ("modes_off", "motion_px", "path_px", "warp_px", "frames_mae", "masks_off", "framing_px",
           "ratio_gap", "meta_off", "outputs_off")
LIMITS_DIR = pathlib.Path(__file__).resolve().parent / "limits"
_FRAME_BLOCK = 8


def limits_of(config_name: str, limits_dir: pathlib.Path = LIMITS_DIR) -> Dict[str, Optional[float]]:
    """Each number's limit; None for a number that is read but not held,
    because its control did not separate from sound arithmetic."""
    limits = json.loads((limits_dir / f"{config_name}.json").read_text())["limits"]
    missing = set(NUMBERS) - set(limits)
    if missing:
        raise KeyError(f"limits/{config_name}.json lacks {sorted(missing)}")
    return {k: None if limits[k] is None else float(limits[k]) for k in NUMBERS}


def engine_of(ref):
    """The reference module that made ``ref``: the one defining its ``Result``."""
    return sys.modules[type(ref).__module__]


def _corner_px(engine, a, b, width: int, height: int) -> float:
    try:
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
    except (TypeError, ValueError):
        return math.inf
    if a.shape != b.shape or a.ndim != 3 or a.shape[1:] != (3, 3):
        return math.inf
    return engine.corner_gap_px(a, b, width, height)


def _path_px(engine, motion: dict, ref, width: int, height: int) -> float:
    """The widest corner gap of the integrated and the target paths, the
    program's read at the width of the reference's path."""
    d = ref.path.shape[-1]
    gaps = []
    for key, want in (("path", ref.path), ("target_path", ref.target_path)):
        try:
            got = np.asarray(motion.get(key, []), np.float64)
        except (TypeError, ValueError):
            return math.inf
        if got.size % d:
            return math.inf
        gaps.append(_corner_px(engine, engine.to_matrices(got.reshape(-1, d)), engine.to_matrices(want),
                               width, height))
    return max(gaps)


def _worst_frame(prog: torch.Tensor, ref: torch.Tensor, fn) -> float:
    """The largest of ``fn(program block, reference block)`` per frame,
    over blocks of frames on the reference's device."""
    worst = 0.0
    for s in range(0, ref.shape[0], _FRAME_BLOCK):
        p = prog[s:s + _FRAME_BLOCK].to(ref.device, torch.float32)
        worst = max(worst, float(fn(p, ref[s:s + _FRAME_BLOCK]).max()))
    return worst


def _output_faults(frames, masks, n: int, h: int, w: int, device_type: str) -> int:
    faults = 0
    for t, shape in ((frames, (n, h, w, 3)), (masks, (n, h, w))):
        ok = (isinstance(t, torch.Tensor) and t.device.type == device_type and t.dtype == torch.float32
              and tuple(t.shape) == shape and t.is_contiguous())
        faults += 0 if ok else 1
    return faults


def _meta_faults(meta, ref, estimator: str, settings, n: int, w: int, h: int) -> int:
    mm = meta.get("motion_meta", {})
    sw = meta.get("stabilization_warp", {})
    fr = meta.get("framing", {})
    expected = [
        (meta.get("frames"), n),
        (meta.get("transform_mode_requested"), settings["transform_mode"]),
        (meta.get("transform_mode_applied"), ref.modes[-1] if ref.modes else settings["transform_mode"]),
        (fr.get("mode"), ref.framing["mode"]),
        (fr.get("input_size"), [w, h]),
        (fr.get("padding_color_rgb"), ref.framing["padding_color_rgb"]),
        (fr.get("padding_detected"), ref.framing["padding_detected"]),
        (sw.get("source_size"), [w, h]),
        (sw.get("output_size"), [w, h]),
        (sw.get("matrix_convention"), "source_to_stabilized"),
        (len(sw.get("per_frame", [])), n),
        (mm.get("version"), 2),
        (mm.get("source"), "estimated_flow" if estimator == "flow" else "estimated_classic"),
        (mm.get("frame_count"), n),
        (mm.get("fps"), float(settings["frame_rate"])),
        (mm.get("input_size"), [w, h]),
        (mm.get("output_size"), [w, h]),
        (mm.get("matrix_convention"), "input_to_output"),
        (len(mm.get("per_frame", [])), n),
        (len(meta.get("estimated_motion", {}).get("per_transition", [])), n - 1),
    ]
    if estimator == "flow":
        expected.append((meta.get("flow_backend"), "DIS"))
    return sum(1 for got, want in expected if got != want)


def compare(frames, masks, meta, ref, estimator: str, settings, output_device: str) -> Dict[str, float]:
    """Every number of ``NUMBERS`` for one call's outputs against ``ref``, the
    ``Result`` of its clip from the configuration's reference."""
    engine = engine_of(ref)
    n, h, w = ref.masks.shape
    em = meta.get("estimated_motion", {})
    trans = em.get("per_transition", [])
    fr = meta.get("framing", {})
    rf = ref.framing
    out = {
        "modes_off": float(sum(1 for t, m in zip(trans, ref.modes) if t.get("mode") != m)
                           + abs(len(trans) - len(ref.modes))),
        "motion_px": _corner_px(engine, [t.get("matrix") for t in trans], ref.motion, w, h),
        "path_px": _path_px(engine, em, ref, w, h),
        "warp_px": max(
            _corner_px(engine, [f.get("applied_matrix")
                                for f in meta.get("stabilization_warp", {}).get("per_frame", [])], ref.final, w, h),
            _corner_px(engine, [f.get("matrix") for f in meta.get("motion_meta", {}).get("per_frame", [])],
                       ref.final, w, h)),
        "meta_off": float(_meta_faults(meta, ref, estimator, settings, n, w, h)),
        "outputs_off": float(_output_faults(frames, masks, n, h, w, output_device)),
    }
    shapes_ok = (isinstance(frames, torch.Tensor) and tuple(frames.shape) == tuple(ref.frames.shape)
                 and isinstance(masks, torch.Tensor) and tuple(masks.shape) == tuple(ref.masks.shape))
    out["frames_mae"] = _worst_frame(frames, ref.frames, lambda p, r: (p - r).abs().mean(dim=(1, 2, 3))) \
        if shapes_ok else math.inf
    out["masks_off"] = _worst_frame(masks, ref.masks, lambda p, r: (p != r).to(torch.float32).mean(dim=(1, 2))) \
        if shapes_ok else math.inf
    try:
        out["framing_px"] = max(abs(float(a) - float(b)) for k in ("safe_region_origin", "safe_region_size",
                                                                    "center_offset")
                                for a, b in zip(fr[k], rf[k]))
        ratios = [(fr["min_content_ratio"], rf["min_content_ratio"]),
                  (fr["actual_content_ratio"], rf["actual_content_ratio"]),
                  (meta["padding_fraction_mean"], float(ref.ratios.mean())),
                  (meta["padding_fraction_max"], float(ref.ratios.max()))]
        out["ratio_gap"] = max(abs(float(a) - float(b)) for a, b in ratios)
    except (KeyError, TypeError, ValueError):
        out["framing_px"] = out["ratio_gap"] = math.inf
    return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}


def worst(readings: List[Dict[str, float]]) -> Dict[str, float]:
    """Each number's largest reading over several calls."""
    return {k: max(r[k] for r in readings) for k in NUMBERS}


def verdict(numbers: Dict[str, float], limits: Dict[str, Optional[float]]) -> bool:
    return all(numbers[k] <= limits[k] for k in NUMBERS if limits[k] is not None)
