"""Kernel launches on the device (copies and fills left out) per Newton
step."""

from perfbench.metrics_common import steps


def read(trace, ctx):
    n = steps(trace)
    return len(trace.launches) / n if n else None
