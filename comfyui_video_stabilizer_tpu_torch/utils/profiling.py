"""Stage timing and device traces.

Counterpart of ``comfyui_video_stabilizer_tpu/utils/profiling.py``:

* ``StageTimer`` -- enabled by ``CVST_TIMING=1`` or :func:`enable_timing`
  (:func:`timing_enabled` says whether it is), it attaches per-stage
  seconds to the result meta as ``timing``.  CUDA work is asynchronous,
  so a stage's time is its host time (enqueue plus whatever it waits
  for), not its device time.
* ``device_trace`` -- a ``torch.profiler`` trace of a run (host ops and,
  where there is a card, its kernels, the hand kernels included),
  written as a Chrome trace into ``CVST_TRACE_DIR`` or the given
  directory; with neither it does nothing.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator

import torch

_ENABLED = os.environ.get("CVST_TIMING", "") not in ("", "0")


def enable_timing(on: bool = True) -> None:
    global _ENABLED
    _ENABLED = on


def timing_enabled() -> bool:
    return _ENABLED


class StageTimer:
    """Accumulates per-stage wall-clock seconds; cheap when disabled."""

    def __init__(self) -> None:
        self.stages: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        if not _ENABLED:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stages[name] = self.stages.get(name, 0.0) + (time.perf_counter() - t0)

    def attach(self, meta: dict) -> dict:
        if _ENABLED and self.stages:
            meta["timing"] = {k: round(v, 6) for k, v in self.stages.items()}
        return meta


@contextlib.contextmanager
def device_trace(trace_dir: str | None = None) -> Iterator[None]:
    """Trace the ``with`` block with ``torch.profiler`` (the CPU, and CUDA
    where a card is present) into ``trace_dir`` (default: ``CVST_TRACE_DIR``)
    as ``cvst_trace_<pid>_<ns>.json``; a no-op when neither names one."""
    trace_dir = trace_dir or os.environ.get("CVST_TRACE_DIR")
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, f"cvst_trace_{os.getpid()}_{time.time_ns()}.json"))
