"""The measured window: the host clock and, on a card, CUDA events at its
ends, held together by ``timing_consistency``. Frozen copies of the port's
``bench/harness.TimedWindow`` and ``timing_consistency``."""

from __future__ import annotations

import time
from typing import NamedTuple

import torch


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timing_consistency(host_t: float, event_t: float, *, ratio: float = 2.0,
                       dispatch_slack_s: float = 0.03) -> bool:
    """One-sided agreement of a host time and the card's event time: the
    host may exceed the events by launch overhead (the ratio or the slack),
    but a host time below the event time beyond the ratio means the clock
    stopped before the work was done. NaN on either side passes."""
    if not (host_t == host_t and event_t == event_t):
        return True
    if host_t >= event_t:
        return host_t / max(event_t, 1e-12) <= ratio or (host_t - event_t) <= dispatch_slack_s
    return event_t / max(host_t, 1e-12) <= ratio


class TimedWindow:
    """Open it after the inputs are ready; it ends in a synchronize.
    ``host_s``, and ``event_s`` (None on the CPU), once it has closed."""

    def __init__(self, device: torch.device):
        self.device = device
        self.host_s = self.event_s = None

    def __enter__(self):
        sync(self.device)
        if self.device.type == "cuda":
            self._ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            self._ev[0].record()
        self._t0 = time.perf_counter()
        return self

    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            self._ev[1].record()
        sync(self.device)
        self.host_s = time.perf_counter() - self._t0
        if self.device.type == "cuda":
            self.event_s = self._ev[0].elapsed_time(self._ev[1]) / 1e3
        return False


class Call(NamedTuple):
    index: int
    seconds: float  # the call on the host clock, up to a synchronize after it
    checksum: float  # Σθ in float64, to hold the check's redraw to the call's θ
    answer: object  # session.Answer


class Window(NamedTuple):
    calls: list
    host_s: float
    event_s: object  # float, or None on the CPU
    consistent: bool
