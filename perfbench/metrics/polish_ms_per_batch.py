"""Host milliseconds inside the mcp.polish span per call. Its loop tests
synchronize, so this is close to the call's wall time spent polishing."""

from perfbench import metrics_telemetry as table


def read(trace, ctx):
    return table.span_ms_per_call(trace, table.POLISH)
