"""What several per-layer readers share."""

from __future__ import annotations

from typing import Optional

SPAN_NEWTON = "mcp.newton_solve"


def steps(trace) -> int:
    """Newton steps in the traced calls: the mcp.newton_solve spans."""
    return trace.span_count(SPAN_NEWTON)


def per_step_ms(trace, span: str) -> Optional[float]:
    n = steps(trace)
    if not n or not trace.span_count(span):
        return None
    return 1e3 * trace.span_seconds(span) / n
