"""Percent of the lanes that the Newton steps work on which are still live:
mcp.live_lane_steps / mcp.lane_steps, over every Newton step of the traced
calls (main loop and polish). Every step runs the whole batch and masks the
finished lanes, so the rest is work thrown away."""

from perfbench import metrics_telemetry as table


def read(trace, ctx):
    snap = table.snapshot()
    lanes = snap and snap["counters"].get(table.LANE_STEPS)
    if not lanes:
        return None
    return 100.0 * snap["counters"].get(table.LIVE_LANE_STEPS, 0) / lanes
