"""The readers of the program's own spans, the map of their clock onto a
profile's, and the profile's idle time by program span, on hand-worked
records and a synthetic profile."""

from dataclasses import dataclass, field
from types import SimpleNamespace

import pytest

from benchmark import program, tracing


@dataclass
class Rec:
    name: str
    parent: object
    call: int
    start_ns: int
    end_ns: int
    device_ms: object = None
    counters: dict = field(default_factory=dict)


def _node_calls():
    # two node calls: 2.0 GB up in 250 ms and 400 ms, 2.7 GB down in two copies each
    out = []
    for call, (up_ms, est_dev, est_host) in enumerate([(250, 200.0, 230.0), (400, 160.0, 190.0)], start=1):
        t = call * 10**10
        out += [
            Rec("node.call", None, call, t, t + 3 * 10**9),
            Rec("io.ingest.copy", "io.ingest", call, t, t + up_ms * 10**6, 5.0, {"io.h2d_bytes": 2 * 10**9}),
            Rec("fastpath.estimate", "engine.call", call, t, t + int(est_host * 1e6), est_dev),
            Rec("io.egress.copy", "io.egress", call, t, t + 10**9, 1.0, {"io.d2h_bytes": 2 * 10**9}),
            Rec("io.egress.copy", "io.egress", call, t, t + 2 * 10**8, 1.0, {"io.d2h_bytes": 7 * 10**8}),
        ]
    return out


def test_readers_take_the_median_over_calls():
    recs = _node_calls()
    # 2 GB over 0.25 s and 0.4 s: 8 and 5 GB/s
    assert program.gb_per_s(recs, "io.ingest.copy", "io.h2d_bytes") == pytest.approx(6.5)
    # 2.7 GB over 1.2 s in both calls
    assert program.gb_per_s(recs, "io.egress.copy", "io.d2h_bytes") == pytest.approx(2.25)
    assert program.device_ms(recs, "fastpath.estimate") == pytest.approx(180.0)
    assert program.host_ms(recs, "fastpath.estimate") == pytest.approx(210.0)


def test_readers_find_nothing_where_the_program_records_nothing():
    recs = _node_calls()
    assert program.host_ms([], "fastpath.estimate") is None
    assert program.device_ms(recs, "engine.gray") is None
    # a copy that moved no byte (a clip already on the card) reads nothing
    assert program.gb_per_s([Rec("io.ingest.copy", "io.ingest", 1, 0, 10, None, {"io.h2d_bytes": 0})],
                            "io.ingest.copy", "io.h2d_bytes") is None
    # a call whose events have not completed is left out
    pending = [Rec("fastpath.estimate", "engine.call", 3, 0, 10, None)]
    assert program.device_ms(recs + pending, "fastpath.estimate") == pytest.approx(180.0)


def _event(name, cid, start_us, end_us, device):
    return SimpleNamespace(name=name, id=cid, device_type=SimpleNamespace(name=device),
                           time_range=SimpleNamespace(start=start_us, end=end_us))


def test_marker_launches_are_matched_by_correlation_id():
    # two pads, then two calls' markers (ids 10-13), their launches 5 us before each, and other kernels
    events = [_event("void spin_kernel(long)", i, 100.0 * i, 100.0 * i + 50, "CUDA") for i in (1, 2)]
    events += [_event("cudaLaunchKernel", i, 100.0 * i - 20, 100.0 * i - 10, "CPU") for i in (1, 2)]
    for k, cid in enumerate((10, 11, 12, 13)):
        t = 1000.0 + 500.0 * k
        events += [_event("void spin_kernel(long)", cid, t, t + 1, "CUDA"),
                   _event("cudaLaunchKernel", cid, t - 5, t - 3, "CPU"),
                   _event("warp_kernel<", 100 + cid, t + 2, t + 400, "CUDA"),
                   _event("cudaLaunchKernel", 100 + cid, t - 2, t - 1, "CPU")]
    starts = program.marker_launch_starts(events, "spin_kernel", 2)
    assert starts == pytest.approx([0.000995, 0.001495, 0.001995, 0.002495])
    # a marker whose launch the session lost gives no map
    lost = [e for e in events if not (e.id == 12 and e.name.startswith("cuda"))]
    assert program.marker_launch_starts(lost, "spin_kernel", 2) is None


def test_clock_offset_is_the_median_of_note_minus_launch():
    launches = [1.0, 1.5, 2.0, 2.5]
    # notes 2 us before each launch on a clock 7 s ahead, one note taken late by a descheduled thread
    notes = [round((s + 7.0) * 1e9) - 2000 for s in launches]
    notes[2] += 3_000_000
    offset = program.clock_offset_ns(notes, launches)
    assert offset == 7 * 10**9 - 2000  # the median of 7 s less 2 us (three notes) and 7 s plus 2.998 ms
    assert program.to_profile_s(notes[0], offset) == pytest.approx(1.0)
    with pytest.raises(ValueError):
        program.clock_offset_ns(notes[:3], launches)


def test_roots_map_between_their_markers_and_a_misplaced_one_is_measured():
    offset = 7 * 10**9
    launches = [1.0, 1.5, 2.0, 2.5]
    ns = lambda s: round(s * 1e9) + offset  # noqa: E731
    recs = [Rec("node.call", None, 1, ns(1.01), ns(1.49)), Rec("io.ingest", "node.call", 1, ns(1.02), ns(1.2)),
            Rec("node.call", None, 2, ns(2.01), ns(2.504)),   # ends 4 ms after its second marker's launch
            Rec("node.call", None, 0, ns(0.1), ns(0.2))]     # before the session: not read
    assert program.root_misplacement_s(recs, offset, launches) == pytest.approx([0.0, 0.004])


def test_idle_by_span_puts_each_gap_in_the_innermost_open_span():
    # one profiled call from 0 to 100 ms: kernels at 0-10, 30-40 and 90-100 ms; the host is in
    # cudaStreamSynchronize from 50 to 80 ms; spans (already on the profile's clock, offset 0):
    # node.call 0-100 > io.ingest 0-35 > io.ingest.copy 5-25, and io.egress 45-95
    prof = tracing.Profile(device=[("k", 0.000, 0.010), ("k", 0.030, 0.040), ("k", 0.090, 0.100)],
                           host=[("cudaStreamSynchronize", 0.050, 0.080)], calls=1, spans=[(0.0, 0.1)])
    ms = 10**6
    recs = [Rec("node.call", None, 1, 0, 100 * ms), Rec("io.ingest", "node.call", 1, 0, 35 * ms),
            Rec("io.ingest.copy", "io.ingest", 1, 5 * ms, 25 * ms), Rec("io.egress", "node.call", 1, 45 * ms, 95 * ms)]
    # gaps: 10-30 (middle 20: io.ingest.copy, host), 40-90 (middle 65: io.egress, the sync)
    assert [(s, e) for s, e, _ in program.idle_gaps(prof)] == pytest.approx([(0.040, 0.090), (0.010, 0.030)])
    rows = program.idle_by_span(prof, recs, 0)
    assert [r[0] for r in rows] == ["io.egress / cudaStreamSynchronize", "io.ingest.copy / (host)"]
    assert [r[1] for r in rows] == pytest.approx([0.050, 0.020])
    # gaps outside every span are put down to none
    rows = program.idle_by_span(prof, recs[1:3], 0, top=None)
    assert rows[0][0] == "(no span) / cudaStreamSynchronize" and rows[0][1] == pytest.approx(0.050)
