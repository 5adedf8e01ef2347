"""The benchmark's arithmetic on hand-worked cases."""

import math

import pytest

from benchmark import calibrate, core, layers, stats, tracing
from benchmark.rooflines import k1, peaks


def test_rate_counts_the_whole_window():
    # 3 calls of 81 frames whose window closed at 2.5 s: the last call's tail counts
    assert stats.rate(3 * 81, 2.5) == pytest.approx(97.2)
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


@pytest.mark.parametrize("values, q, want", [
    ([5.0], 95, 5.0),
    ([1.0, 2.0], 50, 1.5),
    (list(range(1, 21)), 95, 19.05),          # numpy's linear rule: 1 + 0.95 * 19
    (list(range(101)), 95, 95.0),
    ([3.0, 1.0, 2.0, 10.0], 100, 10.0),
])
def test_percentile_over_all_calls(values, q, want):
    assert stats.percentile(values, q) == pytest.approx(want)


def test_busy_gaps_and_idle_share_from_intervals():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (9.0, 12.0)]
    assert stats.merge(iv) == [(0.0, 2.0), (3.0, 4.0), (9.0, 12.0)]
    assert stats.busy(iv, 0.0, 10.0) == pytest.approx(4.0)
    assert stats.gaps(iv, 0.0, 10.0) == [(2.0, 3.0), (4.0, 9.0)]
    assert stats.busy([], 1.0, 2.0) == 0.0


def test_idle_share_is_the_unbusy_share_of_the_calls_spans():
    # 2 profiled calls of 40 ms between their markers, kernels busy 30 ms in the first and 10 ms in the
    # second (overlaps counted once); a copy is no kernel, and the time between calls does not count
    prof = tracing.Profile(device=[("k", 0.000, 0.020), ("k", 0.010, 0.030), ("Memcpy HtoD", 0.030, 0.040),
                                   ("k", 0.100, 0.110)], calls=2, spans=[(0.0, 0.040), (0.090, 0.130)])
    obs = core.Observation((1, 1, 1, 3), None, {}, prof, [])
    assert layers.idle_share(obs) == pytest.approx(100.0 * (1.0 - 0.040 / 0.080))
    assert 0.0 <= layers.idle_share(obs) <= 100.0
    assert layers.idle_share(core.Observation((1, 1, 1, 3), None, {}, None)) is None


def test_the_per_layer_tail_is_the_95th_percentile_of_every_window_call():
    # 20 calls of 100..119 ms (seconds on the host clock): between the 19th and 20th order statistics
    obs = core.Observation((1, 1, 1, 3), None, {}, None, [], [0.100 + 0.001 * i for i in range(20)])
    assert layers.call_ms_p95(obs) == pytest.approx(118.05)
    assert layers.call_ms_p95(core.Observation((1, 1, 1, 3), None, {}, None)) is None


def test_a_session_is_read_between_its_marker_kernels():
    pads = [("spin_kernel", 0.001 * i, 0.001 * i + 0.0009) for i in range(3)]
    marks = [("spin_kernel", 0.010, 0.011), ("spin_kernel", 0.050, 0.051),
             ("spin_kernel", 0.060, 0.061), ("spin_kernel", 0.090, 0.091)]
    device = [("k", 0.012, 0.030), ("Memcpy DtoH", 0.030, 0.049), ("k", 0.070, 0.080)]
    prof = tracing.read_session(pads + marks, device, [("cudaLaunchKernel", 0.012, 0.013)], 2)
    assert prof.spans == [(0.011, 0.050), (0.061, 0.090)]
    assert prof.span_seconds() == pytest.approx(0.068)
    assert prof.pads_lost == tracing.PAD_KERNELS - 3
    with pytest.raises(RuntimeError, match="outside"):      # a marker lost inside the session shifts the pairs
        tracing.read_session(pads + marks[:2] + marks[3:], device, [], 2)
    with pytest.raises(tracing.ProfileError, match="pad"):
        tracing.read_session(marks, device, [], 2)
    with pytest.raises(tracing.ProfileError, match="pads"):  # fewer spins than markers: no index past the end
        tracing.read_session(marks[1:], device, [], 2)


def test_an_unreadable_session_is_profiled_again(monkeypatch):
    good = tracing.Profile(device=[("warp_kernel<float>(", 0.1, 0.2)], calls=1, spans=[(0.0, 1.0)])
    sessions, launches = [], [0]

    def profile(calls):
        sessions.append(len(calls))
        for fn in calls:
            fn()
        if len(sessions) == 1:
            raise tracing.ProfileError("markers lost")
        return good

    def call():
        launches[0] += 1

    monkeypatch.setattr(tracing, "profile", profile)
    assert core._profile(lambda: [call], lambda: launches[0]) is good
    assert sessions == [1, 1]
    sessions.clear()
    monkeypatch.setattr(tracing, "profile", lambda calls: (sessions.append(1), good)[1])
    with pytest.raises(tracing.ProfileError, match="1 K1 events for 0 launches"):  # K1 events the calls never launched
        core._profile(lambda: [], lambda: launches[0], sessions=2)
    assert len(sessions) == 2


def test_plain_ms_and_k1_roofline_from_profiled_kernels():
    n, h, w = 81, 1080, 1920
    least = k1.least_seconds(n, h, w, h, w)
    prof = tracing.Profile(device=[("void (anonymous namespace)::warp_kernel<3, 0>(float const*)", 0.0, 2 * least),
                                   ("void at::native::reduce_kernel<512, 1>(x)", 1.0, 1.004),
                                   ("Memcpy DtoH (Device -> Pageable)", 2.0, 3.0)], calls=2, spans=[(0.0, 3.0)])
    obs = core.Observation((n, h, w, 3), None, {}, prof, ["warp_kernel", "gray_pool_kernel"])
    assert layers.k1_roofline(obs) == pytest.approx(50.0)
    assert layers.plain_ms(obs) == pytest.approx(2.0)   # 4 ms of library kernels over 2 calls; copies are no kernels


def test_roofline_share_and_k1_bytes():
    n, h, w = 81, 1080, 1920
    b = k1.bytes_moved(n, h, w, h, w)
    assert b == 4 * n * (2 * h * w * 3 + 8)
    least = k1.least_seconds(n, h, w, h, w)
    assert least == pytest.approx(b / 3.35e12)
    assert 1e3 * least == pytest.approx(1.2034, rel=1e-3)
    assert stats.roofline_share(least, 1.5e-3) == pytest.approx(100 * least / 1.5e-3)
    assert peaks.least_seconds(flops=67e12) == pytest.approx(1.0)
    with pytest.raises(ValueError):
        stats.roofline_share(least, 0.0)
    assert not math.isnan(stats.roofline_share(least, least))


@pytest.mark.parametrize("name, lower, upper, want", [
    ("modes_off", 0.0, 0.0, 0.0),          # exact
    ("modes_off", 1.0, 5.0, None),         # an exact number that sound arithmetic moves is not held
    ("motion_px", 0.0, 0.0029, 0.0017),    # 0.6 x the upper where the lower is 0
    ("path_px", 0.002, 1.0, 0.12),         # lower^(1/3) upper^(2/3): 0.126, rounded down to two digits
    ("path_px", 0.006, 0.0057, None),      # no separation, not held
    ("frames_mae", 1e-6, 2.9e-6, None),    # under three times the lower
])
def test_a_limit_lies_between_its_readings(name, lower, upper, want):
    got = calibrate.limit(name, lower, upper)
    assert got == (None if want is None else pytest.approx(want))
    if got and lower:
        assert lower < got < upper and got / lower > upper / got
