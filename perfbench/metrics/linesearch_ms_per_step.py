"""Host milliseconds inside the mcp.linesearch spans, per Newton step; nothing
where the span does not fire."""

from perfbench.metrics_common import per_step_ms


def read(trace, ctx):
    return per_step_ms(trace, "mcp.linesearch")
