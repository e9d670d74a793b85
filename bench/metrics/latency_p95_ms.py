"""The 95th percentile of the latency of every request done in the window,
from when it was due to when its answer was ready on the host, in ms
(nearest rank)."""

import math


def read(run):
    lat = sorted(r.latency for r in run.done)
    if not lat:
        return None
    return lat[math.ceil(0.95 * len(lat)) - 1] * 1e3
