"""Newton steps of the terminal polish per call: mcp.polish_steps over the
traced calls; nothing where the polish did not run."""

from perfbench import metrics_telemetry as table


def read(trace, ctx):
    snap = table.snapshot()
    if not snap or table.POLISH not in snap["spans"] or not trace.calls:
        return None
    return snap["counters"].get(table.POLISH_STEPS, 0) / trace.calls
