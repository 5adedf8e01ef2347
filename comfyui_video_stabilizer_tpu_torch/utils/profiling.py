"""Per-stage wall-clock accounting (``StageTimer``).

Counterpart of the ``StageTimer`` part of
``comfyui_video_stabilizer_tpu/utils/profiling.py``: enabled by
``CVST_TIMING=1`` or :func:`enable_timing`, it attaches per-stage
seconds to the result meta as ``timing``.  CUDA work is asynchronous,
so a stage's time is its host time (enqueue plus whatever it waits
for), not its device time.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator

_ENABLED = os.environ.get("CVST_TIMING", "") not in ("", "0")


def enable_timing(on: bool = True) -> None:
    global _ENABLED
    _ENABLED = on


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
