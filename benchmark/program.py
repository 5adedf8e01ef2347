"""The program's own spans in a traced run.

The port records spans and counters itself when its switch is on
(``comfyui_video_stabilizer_tpu_torch.utils.profiling``: ``CVST_TIMING``
or ``enable_timing()``; ``drain()`` hands over the records).  A record
has ``name``, ``parent`` (the enclosing span's name), ``call`` (one id
for every span of one node or API call), ``start_ns`` and ``end_ns``
(``time.perf_counter_ns``), ``device_ms`` (CUDA events; None on the CPU
or while they have not completed) and ``counters``.

Here are, on those records:

- the readers of per-layer metrics: a copy's GB/s from its byte counter
  and its span's host time, a span's device or host ms, each the median
  over the calls that opened the span, and None where no call did (a
  program that records no such span);
- the map of the host clock onto a profile's clock: the marker kernels
  that frame each profiled call are launched just after the host notes
  ``perf_counter_ns()``, and the session keeps each launch's runtime call,
  so the median of (note - launch start) is the offset between the two
  clocks;
- the placement of each profiled call's root spans between the launches
  of its two markers, as a check of that map;
- the profile's idle gaps (the same gaps ``core._breakdown`` reads) by
  the innermost program span open at each gap's middle, joined with the
  runtime call the host was in there.

Nothing here synchronises the device or imports the program.
"""

from __future__ import annotations

import bisect
import statistics
from collections import defaultdict
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from . import stats

NO_SPAN = "(no span)"
HOST = "(host)"
_NAME_CHARS = 100
_GAPS = 4096


def _by_call(records: Iterable) -> Dict[int, List]:
    """The records grouped by call id, in the order the calls opened."""
    out: Dict[int, List] = defaultdict(list)
    for r in sorted(records, key=lambda r: r.call):
        out[r.call].append(r)
    return dict(out)


def _median_over_calls(records: Iterable, name: str, value: Callable[[List], Optional[float]]) -> Optional[float]:
    """The median over the calls that opened span ``name`` of ``value(its
    records in the call)``, leaving out a call for which it is None."""
    values = []
    for recs in _by_call(records).values():
        mine = [r for r in recs if r.name == name]
        v = value(mine) if mine else None
        if v is not None:
            values.append(v)
    return statistics.median(values) if values else None


def gb_per_s(records: Iterable, name: str, counter: str) -> Optional[float]:
    """Median over calls of the bytes ``counter`` counts on span ``name`` over
    the span's host seconds, in GB/s (10**9 bytes); a call that moved no
    byte is left out."""
    def rate(recs):
        moved = sum(r.counters.get(counter, 0) for r in recs)
        ns = sum(r.end_ns - r.start_ns for r in recs)
        return moved / ns if moved > 0 and ns > 0 else None

    return _median_over_calls(records, name, rate)


def device_ms(records: Iterable, name: str) -> Optional[float]:
    """Median over calls of span ``name``'s device ms, summed in a call; a
    call with a span whose events have not completed is left out."""
    def total(recs):
        ms = [r.device_ms for r in recs]
        return None if any(m is None for m in ms) else sum(ms)

    return _median_over_calls(records, name, total)


def host_ms(records: Iterable, name: str) -> Optional[float]:
    """Median over calls of span ``name``'s host ms, summed in a call."""
    return _median_over_calls(records, name, lambda recs: sum(r.end_ns - r.start_ns for r in recs) / 1e6)


def marker_launch_starts(events: Iterable, spin_name: str, calls: int) -> Optional[List[float]]:
    """The start, in the profile's seconds, of the runtime call that
    launched each of the last ``2 * calls`` spin kernels (the markers, in
    order), matched by correlation id; None where one has no match.
    ``events`` are a session's events (``name``, ``id``, ``device_type``,
    ``time_range`` in microseconds, as ``torch.profiler`` gives them)."""
    spins, launches = [], {}
    for e in events:
        if getattr(e.device_type, "name", str(e.device_type)) == "CUDA":
            if spin_name in e.name:
                spins.append(e)
        elif e.name.startswith("cudaLaunchKernel"):
            launches[e.id] = e.time_range.start / 1e6
    spins.sort(key=lambda e: e.time_range.start)
    marks = spins[len(spins) - 2 * calls:] if len(spins) >= 2 * calls else []
    starts = [launches.get(e.id) for e in marks]
    return starts if marks and all(s is not None for s in starts) else None


def clock_offset_ns(notes_ns: Sequence[int], launch_starts_s: Sequence[float]) -> int:
    """The offset from the profile's clock to ``perf_counter_ns``: the
    median of each note less its launch's start (profile seconds = (ns -
    offset) / 1e9)."""
    if not notes_ns or len(notes_ns) != len(launch_starts_s):
        raise ValueError(f"{len(notes_ns)} notes for {len(launch_starts_s)} launches")
    return int(statistics.median(n - round(s * 1e9) for n, s in zip(notes_ns, launch_starts_s)))


def to_profile_s(ns: int, offset_ns: int) -> float:
    return (ns - offset_ns) / 1e9


def root_misplacement_s(records: Iterable, offset_ns: int, launch_starts_s: Sequence[float]) -> List[float]:
    """For each root span that maps into the session (between the first
    marker's launch and the last's), how far it lies outside the launches
    of the two markers of the call whose window holds its middle, in
    seconds (0 where it lies between them)."""
    windows = [(launch_starts_s[2 * i], launch_starts_s[2 * i + 1]) for i in range(len(launch_starts_s) // 2)]
    if not windows:
        return []
    out = []
    for r in records:
        if r.parent is not None:
            continue
        s, e = to_profile_s(r.start_ns, offset_ns), to_profile_s(r.end_ns, offset_ns)
        if e < windows[0][0] or s > windows[-1][1]:
            continue
        mid = 0.5 * (s + e)
        w0, w1 = min(windows, key=lambda w: 0.0 if w[0] <= mid <= w[1] else min(abs(mid - w[0]), abs(mid - w[1])))
        out.append(max(0.0, w0 - s, e - w1))
    return out


def idle_gaps(prof) -> List[Tuple[float, float, str]]:
    """The longest ``_GAPS`` idle stretches of the device inside the
    profiled calls' spans, each with the runtime call the host was in at
    its middle (``(host)``: none), as ``core._breakdown`` reads them."""
    host = sorted(prof.host, key=lambda x: x[1])
    starts = [h[1] for h in host]
    intervals = [(s, e) for _, s, e in prof.device]
    idle = sorted((g for t0, t1 in prof.spans for g in stats.gaps(intervals, t0, t1)),
                  key=lambda g: g[0] - g[1])[:_GAPS]
    out = []
    for s, e in idle:
        mid = 0.5 * (s + e)
        label = HOST
        at = bisect.bisect_right(starts, mid)
        for j in range(at - 1, max(-1, at - 1 - _GAPS), -1):
            if host[j][2] >= mid:
                label = host[j][0][:_NAME_CHARS]
                break
        out.append((s, e, label))
    return out


def idle_by_span(prof, records: Iterable, offset_ns: int, top: Optional[int] = 10) -> List[List]:
    """The profile's idle gaps summed by ``"<span> / <runtime call>"``: the
    innermost program span (the latest to open of those open) at each
    gap's middle, mapped onto the profile's clock; the ``top`` largest
    (None: all), in seconds."""
    t0, t1 = prof.spans[0][0], prof.spans[-1][1]
    spans = sorted((to_profile_s(r.start_ns, offset_ns), to_profile_s(r.end_ns, offset_ns), r.name)
                   for r in records)
    spans = [sp for sp in spans if sp[1] >= t0 and sp[0] <= t1]
    total: Dict[str, float] = defaultdict(float)
    for s, e, runtime in idle_gaps(prof):
        mid = 0.5 * (s + e)
        inner = NO_SPAN
        for a, b, name in spans:
            if a > mid:
                break
            if b >= mid:
                inner = name
        total[f"{inner} / {runtime}"] += e - s
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:top]]

