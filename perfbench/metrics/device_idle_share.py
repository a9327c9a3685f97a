"""Percent of the traced window in which no operation ran on the device:
1 − (union of the device intervals) / the window."""


def read(trace, ctx):
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s) if trace.window_s > 0 else None
