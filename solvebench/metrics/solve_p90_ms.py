"""The 90th percentile of the solves' wall times in the window, by nearest
rank."""

import math


def read(run):
    times = sorted(s.seconds for s in run.solves)
    return 1e3 * times[math.ceil(0.9 * len(times)) - 1] if times else None
