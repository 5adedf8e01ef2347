"""Node cells whose Flow plan grays the clip at 1 x 1: K9's least time by
its bytes at the published bandwidth over the device time of its
launches in the profile, in %.

The pool factors come from the reference's plan (its working size and
Flow decimation), never from the program's; a pooled plan, or a run with
no profile or no K9 event in it, reads nothing.

A guard of the 1 x 1 route, not a lever: K9 is about 0.2 ms of a call of
about 500 ms on ``flow_wan_vace.node``, so no change to it can move
``node_frames_per_s``."""

from benchmark import stats
from benchmark.reference import engine
from benchmark.rooflines import k9
from benchmark.tracing import kernel_pattern


def pool_factors(h: int, w: int):
    """(fy, fx) of the reference's Flow gray for an h x w clip, or None
    where its working size is no integer pool of the clip."""
    work = engine.working_size(w, h)
    dec = engine.flow_decimation(w, h, work)
    tw, th = work if work is not None else (w, h)
    gh, gw = th // dec, tw // dec
    return None if h % gh or w % gw else (h // gh, w // gw)


def read(obs):
    if obs.profile is None:
        return None
    n, h, w, c = obs.shape
    if pool_factors(h, w) != (1, 1):
        return None
    pattern = kernel_pattern("gray_pool_kernel")
    times = [e - s for name, s, e in obs.profile.device if pattern.search(name)]
    if not times:
        return None
    return stats.roofline_share(k9.least_seconds(n, h, w, c, 1, 1) * obs.profile.calls, sum(times))
