"""One run of one cell: set-up, the measured window, the check of the
outputs against the plain reference, and the result line.

Everything that belongs to one configuration, traffic mix, entry or
per-layer metric is a file of its own, found by the names in
``BENCHMARK.json``: ``configs/<config>.json`` (the ``file`` of the
configuration), ``traffic/<traffic>.json``, ``entries/<entry>.py`` (the
traffic's ``entry``), ``metrics/<metric>.py`` (a ``read(obs)`` that
returns a number or None), ``limits/<config>.json`` and the plain
reference, the package the configuration's ``reference`` names
(``reference/`` when it names none; the default's ``engine.py`` states
what the harness calls).

The loop is closed with one caller: a call starts when the previous one
has returned and its outputs are synchronised, and calls alternate over
the pool of clips.  The window opens at the first timed call and closes
when the first call that ends ``seconds`` or more after the opening has
returned; every call in it counts.  A call runs while the outputs of
one earlier call are held, as a caller holds its last result while it
makes the next: the previous call's until the call drawn from the seed,
then that call's.  The check compares the drawn call and the last call
once the window has closed.

In a traced run every call of the window opens spans around the entry's
layers, and after the window a few more calls are profiled.
"""

from __future__ import annotations

import bisect
import contextlib
import hashlib
import importlib
import importlib.util
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time
import traceback
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import check, stats, tracing
from .inputs import clips

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "comfyui_video_stabilizer_tpu")
DEFAULT_REFERENCE = "reference"
_NAME_CHARS = 100


QUANTITIES = ("frames_per_s", "call_ms_p95", "peak_mem_gib", "setup_s")


def quantity(metric: str) -> str:
    """What an end-to-end metric measures: the quantity its name is or ends
    with after an underscore (``api_frames_per_s`` is ``frames_per_s``)."""
    for q in QUANTITIES:
        if metric == q or metric.endswith("_" + q):
            return q
    raise KeyError(f"the benchmark measures no {metric!r}")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole: the port's own name only begins with one."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def load_file(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_reference(base: pathlib.Path, name: str):
    """The ``engine`` module of the reference package ``base/name``.  The
    package is loaded by path under a name of its own, made from its
    directory, so that its relative imports resolve inside that directory
    and two copies never share a module; a second call returns the first's."""
    package_dir = (base / name).resolve()
    if not package_dir.is_relative_to(base.resolve()) or not all(
            (package_dir / f).is_file() for f in ("__init__.py", "engine.py")):
        raise FileNotFoundError(f"reference {name!r}: no package with an engine.py under {base}")
    digest = hashlib.sha1(str(package_dir).encode()).hexdigest()[:12]
    package = f"benchmark_reference_{''.join(c if c.isalnum() else '_' for c in name)}_{digest}"
    if package not in sys.modules:
        spec = importlib.util.spec_from_file_location(package, package_dir / "__init__.py",
                                                      submodule_search_locations=[str(package_dir)])
        sys.modules[package] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sys.modules[package])
    return importlib.import_module(package + ".engine")


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    base: pathlib.Path = HERE

    def reader(self, metric: str) -> Callable:
        return load_file(self.base / "metrics" / f"{metric}.py", f"benchmark_metric_{metric}").read

    def entry(self):
        return load_file(self.base / "entries" / f"{self.traffic['entry']}.py",
                         f"benchmark_entry_{self.traffic['entry']}").Entry

    def reference(self):
        """The configuration's plain reference (its ``engine`` module)."""
        return load_reference(self.base, self.config.get("reference", DEFAULT_REFERENCE))


def _applies(metric: dict, cell: str, reported) -> bool:
    """A metric with ``workloads`` applies to those cells; an end-to-end one
    without (``reported`` None) to every cell; a per-layer one without to
    every cell that reports the end-to-end metric it ``moves``."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric["moves"] in reported


TRAFFIC_KEYS = {"entry", "clip_on", "pool", "clip", "warmup_calls", "sample_below", "traced_calls", "why"}
CLIP_ON = ("host", "device")


def read_traffic(path: pathlib.Path) -> dict:
    """A traffic mix; a key the harness does not read, or a clip placement
    it does not make, is refused rather than run as something else."""
    traffic = json.loads(path.read_text())
    unknown = set(traffic) - TRAFFIC_KEYS
    if unknown or traffic.get("clip_on") not in CLIP_ON:
        raise ValueError(f"{path.name}: keys {sorted(unknown)} are read by nothing, or clip_on "
                         f"{traffic.get('clip_on')!r} is not one of {CLIP_ON}; the loop is closed, with one caller")
    return traffic


def find_cell(name: str, spec: Optional[dict] = None, root: pathlib.Path = ROOT,
              base: pathlib.Path = HERE) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (or of ``spec``), its
    configuration, traffic and metrics read from their files."""
    spec = spec if spec is not None else json.loads((root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise KeyError(f"no cell {name!r}; cells: {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    e2e = [m for m in spec["end_to_end"] if _applies(m, name, None)]
    reported = {m["name"] for m in e2e}
    return Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"],
        config=json.loads((root / conf["file"]).read_text()),
        traffic_name=w["traffic"], traffic=read_traffic(base / "traffic" / f"{w['traffic']}.json"),
        end_to_end=e2e, per_layer=[m for m in spec["per_layer"] if _applies(m, name, reported)], base=base,
    )


@dataclass
class Observation:
    """What the per-layer readers read."""

    shape: Tuple[int, int, int, int]
    spans: tracing.Spans
    counters: Dict[str, int]
    profile: Optional[tracing.Profile]
    hand_kernels: List[str] = field(default_factory=list)
    latencies: List[float] = field(default_factory=list)  # each window call's seconds


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20, check=False)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable ({exc})"


def _to_pageable_host(clip: torch.Tensor, chunk: int = 16) -> torch.Tensor:
    """The clip in ordinary (pageable) host memory, as a ComfyUI IMAGE
    lies, copied through a pinned stage so that set-up spends little of
    its time, and little of its spread, on a pageable copy."""
    if clip.device.type == "cpu":
        return clip
    out = torch.empty(clip.shape, dtype=clip.dtype)
    stage = torch.empty((min(chunk, clip.shape[0]),) + tuple(clip.shape[1:]), dtype=clip.dtype, pin_memory=True)
    for s in range(0, clip.shape[0], chunk):
        e = min(clip.shape[0], s + chunk)
        stage[:e - s].copy_(clip[s:e])
        out[s:e].copy_(stage[:e - s])
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _breakdown(prof: tracing.Profile) -> dict:
    """The device operations that took most time, and the device's idle
    time by the CUDA runtime call the host was in at each gap's middle
    ("(host)": in none, so in Python or the host's own work), summed over
    the longest 4,096 gaps inside the profiled calls' spans; 10 of each."""
    by_op: Dict[str, float] = defaultdict(float)
    for name, s, e in prof.device:
        by_op[name[:_NAME_CHARS]] += e - s
    host = sorted(prof.host, key=lambda x: x[1])
    starts = [h[1] for h in host]
    by_host: Dict[str, float] = defaultdict(float)
    intervals = [(s, e) for _, s, e in prof.device]
    idle = sorted((g for t0, t1 in prof.spans for g in stats.gaps(intervals, t0, t1)),
                  key=lambda g: g[0] - g[1])[:4096]
    for s, e in idle:
        mid = 0.5 * (s + e)
        label = "(host)"
        for j in range(bisect.bisect_right(starts, mid) - 1, max(-1, bisect.bisect_right(starts, mid) - 4097), -1):
            if host[j][2] >= mid:
                label = host[j][0][:_NAME_CHARS]
                break
        by_host[label] += e - s
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return {"device_ops": top(by_op), "idle_gaps": top(by_host)}


PROFILE_SESSIONS = 3


def _profile(make_calls: Callable[[], list], k1_launches: Callable[[], int],
             sessions: int = PROFILE_SESSIONS) -> tracing.Profile:
    """A profile of the calls ``make_calls()`` gives, whose records read
    soundly: every pad lost or none, every marker kept, no device event
    outside the calls, and as many K1 events as K1 launches.  A session
    that falls short is logged with its reason and the calls are
    profiled again in a new one, up to ``sessions`` in all."""
    faults = []
    for attempt in range(1, sessions + 1):
        k1_before = k1_launches()
        try:
            prof = tracing.profile(make_calls())
            k1_seen = sum(1 for name, _, _ in prof.device if tracing.kernel_pattern("warp_kernel").search(name))
            k1_launched = k1_launches() - k1_before
            if k1_seen != k1_launched:
                raise tracing.ProfileError(f"the profiler recorded {k1_seen} K1 events for {k1_launched} launches")
        except tracing.ProfileError as exc:
            faults.append(str(exc))
            log(f"[profile] session {attempt} of {sessions} unreadable: {exc}")
            continue
        log(f"[profile] session {attempt}: {prof.calls} calls, {1e3 * prof.span_seconds() / prof.calls:.3f} ms a "
            f"call between their markers, {len(prof.device)} device events, {prof.pads_lost} of "
            f"{tracing.PAD_KERNELS} pad kernels lost, K1 {k1_seen} events / {k1_launched} launches")
        return prof
    raise tracing.ProfileError(f"no readable profile in {sessions} sessions: {faults}")


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device: torch.device, t_start: float,
             clip_size: Optional[Tuple[int, int, int]] = None) -> Tuple[dict, Dict[str, Tuple[float, float]]]:
    """One run of ``cell``: (the result line's object, {number: (value, limit)}).
    ``clip_size`` (frames, height, width) replaces the configuration's for
    the CPU tests; a measured run never passes it."""
    from comfyui_video_stabilizer_tpu_torch.models import fastpath
    from comfyui_video_stabilizer_tpu_torch.ops import cuda_build

    conf, traf = cell.config, cell.traffic
    n, h, w = clip_size or (conf["clip"]["frames"], conf["clip"]["height"], conf["clip"]["width"])
    c = conf["clip"]["channels"]
    limits = check.limits_of(cell.config_name, cell.base / "limits")
    ref_engine = cell.reference()
    on_host = traf["clip_on"] == "host"

    t_made = time.perf_counter()
    pool = [clips.make_clip(n, h, w, clips.sub_seed(seed, k), traf["clip"], device) for k in range(traf["pool"])]
    if on_host:
        pool = [_to_pageable_host(clip) for clip in pool]
    _sync(device)
    t_pool = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    entry = cell.entry()(conf, device)

    def call(k):
        out = entry(pool[k])
        _sync(device)
        return out

    for k in range(int(traf["warmup_calls"])):  # every shape and kernel; the first call captures the graph
        call(k % len(pool))
    _sync(device)
    setup_s = time.perf_counter() - t_start
    log(f"[setup] {setup_s:.3f} s: start to the clips {t_made - t_start:.3f}, the pool {t_pool - t_made:.3f}, "
        f"warm-up {t_start + setup_s - t_pool:.3f}")

    rng = np.random.default_rng(int(seed) % (1 << 64))
    sample = int(rng.integers(0, traf["sample_below"]))
    spans = tracing.Spans(device)
    latencies: List[float] = []
    kept: Dict[int, Tuple[int, object]] = {}
    failed = 0
    replays0 = fastpath.GRAPH_STATS["replays"]
    prof = None

    def step():
        nonlocal failed
        i = len(latencies)
        k = i % len(pool)
        for j in [j for j in kept if j != (sample if sample < i else i - 1)]:
            del kept[j]
        if traced:
            spans.new_call()
        t = time.perf_counter()
        try:
            out = call(k)
        except Exception:  # a call that raises is an answer that never came; the run goes on
            failed += 1
            if failed == 1:
                log(traceback.format_exc())
            out = None
        latencies.append(time.perf_counter() - t)
        kept[i] = (k, out)

    t0 = time.perf_counter()
    with entry.traced(spans) if traced else contextlib.nullcontext():
        while not latencies or time.perf_counter() - t0 < seconds:
            step()
    t1 = time.perf_counter()
    calls = len(latencies)
    replays = fastpath.GRAPH_STATS["replays"] - replays0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    if traced:
        prof = _profile(lambda: [lambda k=k: call(k % len(pool)) for k in range(int(traf["traced_calls"]))],
                        lambda: cuda_build.LAUNCHES["warp"])

    values = {
        "frames_per_s": stats.rate(n * (calls - failed), t1 - t0),
        "call_ms_p95": 1e3 * stats.percentile(latencies, 95),
        "peak_mem_gib": peak / float(1 << 30),
        "setup_s": setup_s,
    }
    log(f"[window] {calls} calls in {t1 - t0:.3f} s, {failed} failed; call ms median "
        f"{1e3 * statistics.median(latencies):.2f}, p95 {values['call_ms_p95']:.2f}, max {1e3 * max(latencies):.2f}; "
        f"setup {setup_s:.3f} s; peak {values['peak_mem_gib']:.3f} GiB")
    result = {"correct": False, "attempted": calls, "failed": failed}
    if traced:
        obs = Observation((n, h, w, c), spans, {"calls": calls, "graph_replays": replays}, prof,
                          tracing.hand_kernels(pathlib.Path(cuda_build.CSRC_DIR)), latencies)
        metrics = {}
        for m in cell.per_layer:
            value = cell.reader(m["name"])(obs)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": float(values[quantity(m["name"])]), "unit": m["unit"]}
                   for m in cell.end_to_end}
    result["metrics"] = metrics
    result["device"] = {"platform": "gpu" if device.type == "cuda" else device.type,
                        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                        "count": cell.chips, "memory_peak_bytes": int(peak)}
    if prof is not None:  # the profiled calls' spans between their marker kernels, and any device work in them
        intervals = [(s, e) for _, s, e in prof.device]
        result["device"]["busy_s"] = sum(stats.busy(intervals, s, e) for s, e in prof.spans)
        result["device"]["window_s"] = prof.span_seconds()
        result["breakdown"] = _breakdown(prof)

    # the check: the program's state freed, the reference on each sampled clip
    output_device = entry.output_device
    del entry
    fastpath.clear_graph_cache()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    settings = ref_engine.settings_of(conf)
    readings = []
    t_check = time.perf_counter()
    for k in sorted({k for k, _ in kept.values()}):
        ref = ref_engine.stabilize(pool[k].to(device), conf["estimator"], settings)
        for i, (kk, out) in sorted(kept.items()):
            if kk != k:
                continue
            if out is None:
                readings.append({name: math.inf for name in check.NUMBERS})
                continue
            try:
                readings.append(check.compare(*out, ref, conf["estimator"], settings, output_device))
            except Exception:  # a malformed output reads as infinitely far off
                log(traceback.format_exc())
                readings.append({name: math.inf for name in check.NUMBERS})
            log(f"[check] call {i} (clip {k}): " + ", ".join(f"{a} {b:.6g}" for a, b in readings[-1].items()))
        del ref
    numbers = check.worst(readings)
    log(f"[check] {len(readings)} calls of {len({k for k, _ in kept.values()})} clips against the reference "
        f"in {time.perf_counter() - t_check:.2f} s")
    result["correct"] = failed == 0 and check.verdict(numbers, limits)
    compared = {k: (numbers[k], limits[k]) for k in check.NUMBERS}
    result["checks"] = {k: {"value": v if math.isfinite(v) else str(v), "limit": lim} for k, (v, lim) in compared.items()}
    return result, compared


def main(argv, t_start: float) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    cell = find_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"cell {cell.name} needs {cell.chips} CUDA device(s); torch.cuda.is_available() is "
            f"{torch.cuda.is_available()}, device_count() {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    device = torch.device("cuda:0")
    log(f"[device] {torch.cuda.get_device_name(device)}; nvidia-smi: {power_limit()}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    result, compared = run_cell(cell, args.seed, args.seconds, bool(args.trace), device, t_start)
    found = forbidden_modules()
    if found:
        log(f"the run loaded {found}: the benchmark runs the port alone")
        return 3
    log("[checks] " + ", ".join(f"{k} {v:.6g} (limit {'not held' if lim is None else f'{lim:g}'})"
                                for k, (v, lim) in compared.items()))
    for k, (v, lim) in compared.items():
        log(f"{k} {v!r} limit {lim!r}")
    print(json.dumps(result), flush=True)
    return 0
