"""API cells with perspective fits: device ms a call in K10 and K11
(``smallest_eigvec_kernel``, ``homography_4pt_kernel``, ``solve8_kernel``)
over the profiled calls; None where the profile holds none of them.
They are latency-bound (a few thousand tiny systems a call), so a share
of a roofline would read near 0; their time is the number."""

from benchmark.tracing import kernel_pattern

KERNELS = ("smallest_eigvec_kernel", "homography_4pt_kernel", "solve8_kernel")


def read(obs):
    if obs.profile is None:
        return None
    patterns = [kernel_pattern(name) for name in KERNELS]
    times = [e - s for name, s, e in obs.profile.device if any(p.search(name) for p in patterns)]
    if not times:
        return None
    return 1e3 * sum(times) / obs.profile.calls
