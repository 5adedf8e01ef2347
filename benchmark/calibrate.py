"""The readings the limits of ``limits/<config>.json`` are set from.

    python3 benchmark/calibrate.py --cells <cell,...> --seeds 12 --variant-seeds 6 --control-seeds 3 [--out f.json]

On the card, at each cell's own size.  The lower reading of each number
is the largest that sound arithmetic gives: short runs of the program
(the cell's set-up, a window of ``--seconds`` at its own load, the
check) on ``--seeds`` seeds, all in this one process, and the sound
variants of the configuration's reference (its ``VARIANTS``: the default
reference's sums in another order, its trajectory in float64) against it on
``--variant-seeds`` seeds.  The upper reading is the smallest that the
control gives: the reference put in the program's place with every
hand-off between its stages held in bfloat16, on ``--control-seeds``
seeds.  The same with TF32 switched on is printed beside it (the
similarity path has no float32 product or convolution for TF32 to
round, so it reads as the reference).  ``limit`` sets a number's limit
from its two readings.  The benchmark's own runs never run this.
"""

import argparse
import json
import math
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)

import torch  # noqa: E402

from benchmark import check, core  # noqa: E402
from benchmark.inputs import clips  # noqa: E402

SEED_BASE = 3_000_000_000


EXACT = ("modes_off", "meta_off", "outputs_off")


def reference_readings(cell, seed: int, device, kinds, clip_size=None):
    """{kind: numbers} of the cell's reference computed as each of ``kinds``
    asks (keyword arguments of its ``stabilize``: ``store``, ``tf32``,
    ``variant``) and put in the program's place, against the reference,
    on clip 0 of ``seed``'s pool."""
    conf = cell.config
    engine = cell.reference()
    n, h, w = clip_size or (conf["clip"]["frames"], conf["clip"]["height"], conf["clip"]["width"])
    clip = clips.make_clip(n, h, w, clips.sub_seed(seed, 0), cell.traffic["clip"], device)
    settings = engine.settings_of(conf)
    ref = engine.stabilize(clip, conf["estimator"], settings)
    out = {}
    for name, kw in kinds.items():
        other = engine.stabilize(clip, conf["estimator"], settings, **kw)
        out[name] = check.compare(*engine.as_node_outputs(other, conf["estimator"], settings), ref,
                                  conf["estimator"], settings, device.type)
    return out


def control_readings(cell, seed: int, device, clip_size=None):
    """The bfloat16 control's numbers."""
    return reference_readings(cell, seed, device, {"bf16": {"store": torch.bfloat16}}, clip_size)["bf16"]


def limit(name: str, lower: float, upper: float):
    """A number's limit from its lower and upper readings, two significant
    digits, rounded down: 0 for an exact number; where the upper reading
    is three times the lower or more, lower^(1/3) x upper^(2/3), which
    leaves more room above the lower than below the upper (0.6 x the
    upper where the lower is 0); None (not held) where they do not
    separate."""
    if name in EXACT:
        return 0.0 if lower == 0.0 else None
    if upper <= 0.0 or upper < 3.0 * lower:
        return None
    value = 0.6 * upper if lower == 0.0 else lower ** (1.0 / 3.0) * upper ** (2.0 / 3.0)
    digits = 1 - math.floor(math.log10(value))
    return math.floor(value * 10 ** digits) / 10 ** digits


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--cells", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--variant-seeds", type=int, default=6)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default=None)
    args = p.parse_args()
    if not torch.cuda.is_available():
        core.log("calibration reads the card; there is none")
        return 2
    device = torch.device("cuda:0")
    core.log(f"[device] {torch.cuda.get_device_name(device)}; nvidia-smi: {core.power_limit()}")
    report = {}
    for name in args.cells.split(","):
        cell = core.find_cell(name)
        runs, variants, controls = [], [], []
        for i in range(args.seeds):
            seed = SEED_BASE + 7919 * i
            t = time.perf_counter()
            result, compared = core.run_cell(cell, seed, args.seconds, False, device, t)
            runs.append({"seed": seed, "attempted": result["attempted"], "failed": result["failed"],
                         "numbers": {k: v for k, (v, _) in compared.items()}})
            core.log(f"[program] {name} seed {seed}: " + json.dumps(runs[-1]["numbers"]))
        for i in range(args.variant_seeds):
            seed = SEED_BASE + 15485863 + 7919 * i
            got = reference_readings(cell, seed, device, {v: {"variant": v} for v in cell.reference().VARIANTS})
            for v, numbers in got.items():
                variants.append({"seed": seed, "variant": v, "numbers": numbers})
                core.log(f"[variant {v}] {name} seed {seed}: " + json.dumps(numbers))
        for i in range(args.control_seeds):
            seed = SEED_BASE + 104729 * (i + 1)
            kinds = {"bf16": {"store": torch.bfloat16}}
            if i == 0:
                kinds["tf32"] = {"tf32": True}
            got = reference_readings(cell, seed, device, kinds)
            controls.append({"seed": seed, "numbers": got["bf16"]})
            core.log(f"[control bf16] {name} seed {seed}: " + json.dumps(got["bf16"]))
            if "tf32" in got:
                core.log(f"[control tf32] {name} seed {seed}: " + json.dumps(got["tf32"]))
        sound = [r["numbers"] for r in runs + variants]
        lower = {k: max(r[k] for r in sound) for k in check.NUMBERS}
        upper = {k: min(r["numbers"][k] for r in controls) for k in check.NUMBERS}
        limits = {k: limit(k, lower[k], upper[k]) for k in check.NUMBERS}
        report[name] = {"runs": runs, "variants": variants, "controls": controls, "lower": lower, "upper": upper,
                        "limits": limits}
        core.log(f"[readings] {name}\n" + "\n".join(
            f"  {k:12s} lower {lower[k]:.6g}  upper {upper[k]:.6g}  limit {limits[k]}" for k in check.NUMBERS))
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
