"""The port's tracing: named spans and counters of the solve, recorded only
while a ``torch.profiler`` profile (or any other autograd profiler) records.

``span(name)`` marks a stretch of host work, as a context manager or as a
decorator. With no profiler recording it reads one flag and does nothing
else. While one records, it enters ``torch.profiler.record_function(name)``,
so the span lands in the Kineto trace on the clock of CUPTI's device
activity, and it adds one count and its host nanoseconds to an in-memory
table. ``count(name, n)`` adds to a counter of the same table; callers count
only while ``recording()`` holds. ``snapshot()`` reads the table, ``reset()``
clears it; nothing is written anywhere unless ``trace(log_dir)`` is asked
for.

Cost of a span on a CPU host with torch 2.13: entering and leaving a bare
``record_function`` takes about 10 µs with no profiler running; a span then
costs about 0.6 µs, of which the gate, ``_profiler_enabled()``, takes 0.07.
While a profiler records, a span costs about 14.5 µs against
``record_function``'s 12 µs: two clock reads and the table's update.

Every span and counter of the program is named here (``SPANS``,
``COUNTERS``); ``solver.py`` and ``diff.py`` keep their ``SPAN_*`` names as
aliases of these.
"""

from __future__ import annotations

import contextlib
import functools
import time

import torch

#: The solver's residual (and the bands or Jacobians) at an iterate.
RESIDUAL = "mcp.residual_bands"
#: One Newton direction: the factorization and its solves.
NEWTON = "mcp.newton_solve"
#: The fraction-to-the-boundary linesearch and the update.
LINESEARCH = "mcp.linesearch"
#: A loop test: the one host sync of each loop iteration.
LOOP_TEST = "mcp.loop_test"
#: A solver body's set-up before its first loop test: the step's
#: linearizer (an affine MCP's Jacobians), the bands' cast, the start.
SETUP = "mcp.setup"
#: The whole terminal polish, its own Newton step's set-up included.
POLISH = "mcp.polish"
#: The IFT's bands or Jacobians at the solution, and its solve.
IFT_BANDS = "mcp.ift_bands"
IFT_SOLVE = "mcp.ift_solve"

SPANS = (RESIDUAL, NEWTON, LINESEARCH, LOOP_TEST, SETUP, POLISH, IFT_BANDS, IFT_SOLVE)

#: Lanes live at each Newton step, summed over the steps.
LIVE_LANE_STEPS = "mcp.live_lane_steps"
#: The batch at each Newton step, summed over the steps: every lane works
#: at every step, live or not.
LANE_STEPS = "mcp.lane_steps"
#: Newton steps of the terminal polish.
POLISH_STEPS = "mcp.polish_steps"

COUNTERS = (LIVE_LANE_STEPS, LANE_STEPS, POLISH_STEPS)

#: True while a profiler records (a C call, ~0.07 µs).
recording = torch._C._autograd._profiler_enabled

# span name -> [count, host ns]; counter name -> total. Filled only while a
# profiler records.
_spans: dict = {}
_counters: dict = {}


class span:
    """``with span(name): ...`` or ``@span(name)``: see the module docstring.
    An instance is entered by one ``with`` at a time; the decorator makes a
    new one per call."""

    __slots__ = ("name", "_rf", "_t0")

    def __init__(self, name: str):
        self.name = name
        self._rf = None

    def __enter__(self):
        if recording():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
            self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        rf = self._rf
        if rf is not None:
            entry = _spans.setdefault(self.name, [0, 0])
            entry[0] += 1
            entry[1] += time.perf_counter_ns() - self._t0
            self._rf = None
            rf.__exit__(*exc)
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            if not recording():
                return fn(*args, **kwargs)
            with span(name):
                return fn(*args, **kwargs)

        return wrapped


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    _counters[name] = _counters.get(name, 0) + int(n)


def snapshot() -> dict:
    """``{"spans": {name: {"count", "ns"}}, "counters": {name: total}}``: what
    was recorded since the last ``reset()``, a copy."""
    return {"spans": {k: {"count": c, "ns": ns} for k, (c, ns) in _spans.items()},
            "counters": dict(_counters)}


def reset() -> None:
    """Clear the table."""
    _spans.clear()
    _counters.clear()


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (the host's operations and spans, and the card's
    kernels where CUDA is available) and write the trace to ``log_dir``, for
    TensorBoard or Perfetto. The spans' table fills as under any profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    ):
        yield
