"""Newton steps per call: mcp.newton_solve spans over the traced calls."""

from perfbench.metrics_common import steps


def read(trace, ctx):
    n = steps(trace)
    return n / trace.calls if n and trace.calls else None
