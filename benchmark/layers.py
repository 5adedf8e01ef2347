"""The readers the per-layer metric files share; each ``metrics/<name>.py``
names one of them ``read``.  A reader returns None where the run holds
nothing for it to read."""

from __future__ import annotations

import statistics

from . import stats
from .rooflines import k1
from .tracing import is_kernel, kernel_pattern


def _median_span(obs, name):
    ms = obs.spans.per_call(name)
    return statistics.median(ms) if ms else None


def ingest_ms(obs):
    """Median ms a call in the node's ingest span."""
    return _median_span(obs, "io.ingest")


def egress_ms(obs):
    """Median ms a call in the node's egress span."""
    return _median_span(obs, "io.egress")


def engine_call_ms(obs):
    """Median ms a call in the engine span."""
    return _median_span(obs, "engine.call")


def call_ms_p95(obs):
    """The 95th percentile of every call of the traced window, in ms (host
    clock, each call ended by a synchronise, the benchmark's spans open
    inside it)."""
    return 1e3 * stats.percentile(obs.latencies, 95) if obs.latencies else None


def graph_replays_per_call(obs):
    """The growth of the fast path's ``GRAPH_STATS["replays"]`` over the window's calls, a call."""
    calls = obs.counters.get("calls", 0)
    return obs.counters["graph_replays"] / calls if calls else None


def k1_roofline(obs):
    """K1's least time by its bytes at the published bandwidth over the
    device time of its launches in the profile, in %."""
    if obs.profile is None:
        return None
    pattern = kernel_pattern("warp_kernel")
    times = [e - s for name, s, e in obs.profile.device if pattern.search(name)]
    if not times:
        return None
    n, h, w, c = obs.shape
    return stats.roofline_share(k1.least_seconds(n, h, w, h, w, c) * len(times), sum(times))


def plain_ms(obs):
    """Device ms a call in kernels not named in the program's CUDA sources
    (library kernels), over the profiled calls; copies and fills are no kernels."""
    if obs.profile is None:
        return None
    hand = [kernel_pattern(name) for name in obs.hand_kernels]
    plain = [e - s for name, s, e in obs.profile.device if is_kernel(name) and not any(p.search(name) for p in hand)]
    return 1e3 * sum(plain) / obs.profile.calls


def idle_share(obs):
    """The share of the profiled calls' device time in which no kernel
    runs, in %: both terms from the profile, the calls' spans between
    their marker kernels and the kernels' busy time inside them (copies
    and fills are no kernels)."""
    if obs.profile is None:
        return None
    kernels = [(s, e) for name, s, e in obs.profile.device if is_kernel(name)]
    busy = sum(stats.busy(kernels, s, e) for s, e in obs.profile.spans)
    return 100.0 * (1.0 - busy / obs.profile.span_seconds())
