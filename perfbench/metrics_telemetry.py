"""What the readers of the program's own table share: the snapshot of
``mcp_tpu_torch.telemetry``, the spans' counts and host nanoseconds and the
solver's counters. The program fills it only while a profiler records, so in
a run it holds the traced window alone (the warm call and the check run with
no profiler). A program without that module gives nothing to read."""

from __future__ import annotations

from typing import Optional

SETUP = "mcp.setup"
POLISH = "mcp.polish"
LIVE_LANE_STEPS = "mcp.live_lane_steps"
LANE_STEPS = "mcp.lane_steps"
POLISH_STEPS = "mcp.polish_steps"


def snapshot() -> Optional[dict]:
    """The program's table, or None where the program keeps none."""
    try:
        from mcp_tpu_torch import telemetry
    except ImportError:
        return None
    return telemetry.snapshot()


def span_ms_per_call(trace, name: str) -> Optional[float]:
    """Host milliseconds inside the span ``name`` per traced call; nothing
    where the span did not fire."""
    table = snapshot()
    entry = table and table["spans"].get(name)
    if not entry or not trace.calls:
        return None
    return entry["ns"] / 1e6 / trace.calls
