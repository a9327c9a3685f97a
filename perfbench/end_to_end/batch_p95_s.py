"""The 95th percentile, by nearest rank, of the wall time of every call in
the window, each up to a synchronize after it."""

import math


def read(window, verdict, ctx):
    times = sorted(c.seconds for c in window.calls)
    return times[max(0, math.ceil(0.95 * len(times)) - 1)]
