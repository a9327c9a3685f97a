"""Host milliseconds inside the mcp.setup spans per call: each solver body's
work before its first loop test (the linearizer, for an affine MCP its
Jacobians; the bands' cast; the starting iterate)."""

from perfbench import metrics_telemetry as table


def read(trace, ctx):
    return table.span_ms_per_call(trace, table.SETUP)
