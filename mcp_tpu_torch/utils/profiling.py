"""Profiling and phase-timing utilities.

``trace`` captures a ``torch.profiler`` trace (CPU ops and, on a card, its
kernels) around arbitrary code; ``PhaseTimer`` accumulates wall-clock per
named phase and separates the first call (kernel builds, caches) from the
steady state; ``time_compiled`` times a callable the same way.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable

import torch


def _sync_if_cuda(out) -> None:
    """``torch.cuda.synchronize()`` when ``out`` holds a CUDA tensor: the
    card runs asynchronously, so a host clock without it times the enqueue."""
    leaves = out if isinstance(out, (tuple, list)) else (out,)
    if any(isinstance(t, torch.Tensor) and t.is_cuda for t in leaves):
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the block (CPU ops, and the
    card's kernels when CUDA is available), written to ``log_dir`` for
    TensorBoard or Perfetto."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    ):
        yield


class PhaseTimer:
    """Accumulate wall-clock per named phase; report first call vs steady
    state."""

    def __init__(self):
        self.phases: dict[str, list[float]] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phases.setdefault(name, []).append(time.perf_counter() - t0)

    def summary(self) -> dict:
        out = {}
        for name, times in self.phases.items():
            out[name] = {
                "calls": len(times),
                "first_s": times[0],  # includes kernel builds on a first call
                "steady_s": min(times[1:]) if len(times) > 1 else None,
                "total_s": sum(times),
            }
        return out


def time_compiled(fn: Callable, *args, repeats: int = 3) -> dict:
    """Time ``fn(*args)``: the first call (kernel builds included) against
    the best of ``repeats`` timed calls. A result holding a CUDA tensor ends
    each call in ``torch.cuda.synchronize()``."""
    t0 = time.perf_counter()
    _sync_if_cuda(fn(*args))
    first = time.perf_counter() - t0
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        _sync_if_cuda(fn(*args))
        times.append(time.perf_counter() - t0)
    return {"first_s": first, "best_s": min(times), "mean_s": sum(times) / len(times)}
