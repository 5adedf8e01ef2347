"""The port's spans and counters.

The counterpart of ``comfyui_video_stabilizer_tpu/utils/profiling.py``'s
stage timer, rebuilt for asynchronous CUDA work.  Recording is on under ``CVST_TIMING=1`` or :func:`enable_timing`
(:func:`timing_enabled` says whether it is).  Off, :func:`span` is one
test of a module flag that returns a shared null context: no clock is
read and no CUDA call is made.

A span is a ``with`` block around existing code at a layer boundary
(``node.call``, ``io.ingest.copy``, ``fastpath.estimate``, ...).  Its
record holds the name, the enclosing span's name, the call's id (shared
by every span of one node or API call: a span opened with no span open
is the call's root and takes a new id), the host start and end
(``time.perf_counter_ns``), the device milliseconds and the counters
the code gave it (:meth:`Span.count`; ``io.h2d_bytes``,
``io.d2h_bytes``).  A root span also holds the call's growth of every
counter registered with :func:`watch` (the fast path registers its graph
captures, recaptures, replays and the calls it served).

On a CUDA device a span records a timing event on the device's current
stream at each end.  The recorder never synchronises or waits on an
event: a span's events become milliseconds once the end event has
completed (``Event.query``), checked when the next call opens, when
:func:`attach` builds a call's summary and when :func:`drain` takes the
records; events still pending ``PENDING_CALLS`` calls later are dropped
and that span's device time stays None.  Nothing is recorded while the
current stream captures a CUDA graph.  Finished records wait in a ring
of ``RING_SIZE`` until :func:`drain` takes them.

:func:`attach` puts a call's spans into a result's meta as ``timing``
(the operator's view): per span name, the host and device milliseconds
and the counters, summed over the call's spans of that name.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

import torch

_ENABLED = os.environ.get("CVST_TIMING", "") not in ("", "0")

# finished records kept for drain(): a few thousand calls' spans
RING_SIZE = 1 << 15
# calls after which a span's events that have not completed are dropped
PENDING_CALLS = 8

_RING: deque = deque(maxlen=RING_SIZE)
_PENDING: List["Record"] = []
_CALL_IDS = itertools.count(1)
_LOCAL = threading.local()
_LOCK = threading.Lock()  # _PENDING and _RING, for callers on several threads
_WATCHED: Dict[str, Callable[[], int]] = {}
_last_call = 0


def enable_timing(on: bool = True) -> None:
    global _ENABLED
    _ENABLED = on


def timing_enabled() -> bool:
    return _ENABLED


def watch(name: str, read: Callable[[], int]) -> None:
    """Record the growth of ``read()`` over each call on its root span, as ``name``."""
    _WATCHED[name] = read


class Record:
    """One finished span.  ``device_ms`` is None on the CPU, and until the
    span's end event has completed on the device."""

    __slots__ = ("name", "parent", "call", "start_ns", "end_ns", "device_ms", "counters", "events")

    def __init__(self, name: str, parent: Optional[str], call: int):
        self.name, self.parent, self.call = name, parent, call
        self.start_ns = self.end_ns = 0
        self.device_ms: Optional[float] = None
        self.counters: Dict[str, int] = {}
        self.events = None

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


class _NullSpan:
    """What :func:`span` returns when nothing is recorded."""

    root = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def count(self, key: str, n: int) -> None:
        pass


_NULL = _NullSpan()


def _stack() -> list:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


class Span:
    """An open span; made by :func:`span`."""

    __slots__ = ("record", "stream", "root", "watched")

    def __init__(self, name: str, device: Optional[torch.device]):
        stack = _stack()
        self.root = not stack
        parent = stack[-1].record if stack else None
        if self.root:
            global _last_call
            _last_call = next(_CALL_IDS)
            _resolve()
        self.record = Record(name, parent.name if parent else None, _last_call if self.root else parent.call)
        self.stream = torch.cuda.current_stream(device) if device is not None and device.type == "cuda" else None
        self.watched = {k: read() for k, read in _WATCHED.items()} if self.root else None

    def __enter__(self):
        _stack().append(self)
        if self.stream is not None:
            start = torch.cuda.Event(enable_timing=True)
            self.record.events = (start, torch.cuda.Event(enable_timing=True))
            start.record(self.stream)
        self.record.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        rec = self.record
        if rec.events is not None:
            rec.events[1].record(self.stream)
        rec.end_ns = time.perf_counter_ns()
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        if self.watched is not None:  # a counter registered during the call counted from 0
            for k, read in _WATCHED.items():
                rec.counters[k] = read() - self.watched.get(k, 0)
        with _LOCK:
            if rec.events is not None:
                _PENDING.append(rec)
            _RING.append(rec)
        return False

    def count(self, key: str, n: int) -> None:
        self.record.counters[key] = self.record.counters.get(key, 0) + int(n)


def _capturing() -> bool:
    return torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing()


def span(name: str, device=None):
    """A span named ``name`` around a ``with`` block; ``device`` (a
    ``torch.device`` or None) is where the block's work runs: on a CUDA
    device the span also takes its device time."""
    if not _ENABLED or _capturing():
        return _NULL
    return Span(name, device)


def count(key: str, n: int) -> None:
    """Add ``n`` to ``key`` on the innermost open span, if any."""
    if not _ENABLED:
        return
    stack = _stack()
    if stack:
        stack[-1].count(key, n)


def _resolve() -> None:
    """Turn completed events into device milliseconds; drop those of spans
    more than ``PENDING_CALLS`` calls old."""
    with _LOCK:
        keep = []
        for rec in _PENDING:
            start, end = rec.events
            if end.query():
                rec.device_ms = start.elapsed_time(end)
                rec.events = None
            elif rec.call <= _last_call - PENDING_CALLS:
                rec.events = None
            else:
                keep.append(rec)
        _PENDING[:] = keep


def drain() -> List[Record]:
    """Every finished record since the last drain, oldest first (the ring
    keeps the newest ``RING_SIZE``), with the device times that have
    completed."""
    _resolve()
    with _LOCK:
        out = list(_RING)
        _RING.clear()
    return out


def _summary(call: int) -> Dict[str, dict]:
    """The call's spans by name, in the order they opened: the parent's
    name, host and device ms (None where any span of the name has none),
    the counters, and ``n`` where the name opened more than once."""
    recs = []
    with _LOCK:
        for r in reversed(_RING):  # a call's records are the newest: stop at an older call's
            if r.call < call:
                break
            if r.call == call:
                recs.append(r)
    recs.sort(key=lambda r: r.start_ns)
    out: Dict[str, dict] = {}
    for r in recs:
        entry = out.get(r.name)
        if entry is None:
            out[r.name] = {"parent": r.parent, "host_ms": r.host_ms, "device_ms": r.device_ms, **r.counters}
            continue
        entry["n"] = entry.get("n", 1) + 1
        entry["host_ms"] += r.host_ms
        entry["device_ms"] = None if entry["device_ms"] is None or r.device_ms is None \
            else entry["device_ms"] + r.device_ms
        for k, v in r.counters.items():
            entry[k] = entry.get(k, 0) + v
    return out


def attach(meta: dict, root) -> dict:
    """``meta`` with ``timing``: the summary of ``root``'s call, if ``root``
    is a recorded root span; anything else leaves ``meta`` as it was."""
    if root.root:
        _resolve()
        meta["timing"] = _summary(root.record.call)
    return meta
