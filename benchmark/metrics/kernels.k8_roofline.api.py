"""API cells whose padding stats run K8's perspective route: K8's least
time by its bytes (the float32 mask) at the published bandwidth over the
device time of its launches in the profile, in %; None where the profile
holds no K8 event."""

from benchmark import stats
from benchmark.rooflines import k8
from benchmark.tracing import kernel_pattern


def read(obs):
    if obs.profile is None:
        return None
    pattern = kernel_pattern("padding_stats_kernel")
    times = [e - s for name, s, e in obs.profile.device if pattern.search(name)]
    if not times:
        return None
    n, h, w, _ = obs.shape
    return stats.roofline_share(k8.least_seconds(n, h, w) * obs.profile.calls, sum(times))
