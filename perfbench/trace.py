"""The traced run: torch.profiler over whole calls, its raw Kineto events
reduced to what the per-layer readers take. A copy of the reduction of
``chip_smoke.profile_call``: the spans' host time, the device's kernels,
the union of their intervals (busy time), the host's synchronizations."""

from __future__ import annotations

import contextlib
from typing import NamedTuple

from perfbench.session import SPAN_CALL, SPAN_DRAW, SPAN_FETCH, SPAN_WINDOW

#: The program's solver spans (``mcp_tpu_torch/solver.py``).
SOLVER_SPANS = ("mcp.residual_bands", "mcp.newton_solve", "mcp.linesearch", "mcp.loop_test")
HARNESS_SPANS = (SPAN_WINDOW, SPAN_CALL, SPAN_DRAW, SPAN_FETCH)
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize")
#: Device activities that are copies or fills, not kernel launches.
NOT_LAUNCHES = ("Memcpy", "Memset")
TOP = 10


class Interval(NamedTuple):
    name: str
    start_s: float
    end_s: float


class Trace(NamedTuple):
    calls: int  # whole calls traced
    window_s: float  # the traced window, first draw to the last synchronize
    kernels: list  # Interval of every device activity inside the window
    spans: dict  # span name -> [Interval] on the host
    syncs_in_calls: int  # host synchronizations inside the calls

    def span_seconds(self, name: str) -> float:
        return sum(i.end_s - i.start_s for i in self.spans.get(name, ()))

    def span_count(self, name: str) -> int:
        return len(self.spans.get(name, ()))

    @property
    def launches(self) -> list:
        return [k for k in self.kernels if not k.name.startswith(NOT_LAUNCHES)]

    def busy(self) -> list:
        """The union of the device's intervals, in order."""
        merged = []
        for k in sorted(self.kernels, key=lambda k: k.start_s):
            if merged and k.start_s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], k.end_s)
            else:
                merged.append([k.start_s, k.end_s])
        return merged

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy())


@contextlib.contextmanager
def profiled(on_card: bool):
    """``with profiled(True) as events: ...``; ``events`` holds the raw
    Kineto events once the block has ended."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    events: list = []
    with profile(activities=activities) as prof:
        yield events
    # The raw events: building prof.events()' Python tree of a run with
    # millions of host operations takes minutes.
    events.extend(prof.profiler.kineto_results.events())


def reduce(events) -> Trace:
    from torch.autograd import DeviceType

    spans = {name: [] for name in SOLVER_SPANS + HARNESS_SPANS}
    device, syncs = [], []
    for e in events:
        name = e.name()
        start = e.start_ns() / 1e9
        end = start + e.duration_ns() / 1e9
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append(Interval(name, start, end))
        elif name in spans:
            spans[name].append(Interval(name, start, end))
        elif name in SYNC_CALLS:
            syncs.append(start)
    windows = spans[SPAN_WINDOW]
    if len(windows) != 1:
        raise RuntimeError(f"the trace holds {len(windows)} windows, not 1")
    w = windows[0]
    calls = spans[SPAN_CALL]
    inside = lambda t: any(c.start_s <= t <= c.end_s for c in calls)
    return Trace(
        calls=len(calls),
        window_s=w.end_s - w.start_s,
        kernels=[k for k in device if k.start_s >= w.start_s and k.end_s <= w.end_s],
        spans={n: [i for i in v if w.start_s <= i.start_s <= w.end_s] for n, v in spans.items()},
        syncs_in_calls=sum(1 for t in syncs if inside(t)),
    )


def host_labels(spans: dict, times: list) -> list:
    """The innermost span open on the host at each of ``times`` (ascending):
    the open span that started last, or "outside spans"."""
    import heapq

    order = sorted((i for name in SOLVER_SPANS + HARNESS_SPANS for i in spans.get(name, ())),
                   key=lambda i: i.start_s)
    heap, out, j = [], [], 0
    for t in times:
        while j < len(order) and order[j].start_s <= t:
            heapq.heappush(heap, (-order[j].start_s, j))
            j += 1
        while heap and order[heap[0][1]].end_s < t:
            heapq.heappop(heap)
        out.append(order[heap[0][1]].name if heap else "outside spans")
    return out


def breakdown(trace: Trace) -> dict:
    """The device operations that took most time, and the device's idle time
    inside the window summed by the innermost span open on the host at the
    middle of each gap; at most ``TOP`` of each, in seconds."""
    by_op: dict = {}
    for k in trace.kernels:
        by_op[k.name] = by_op.get(k.name, 0.0) + (k.end_s - k.start_s)
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
    w = trace.spans[SPAN_WINDOW][0]
    edges = [w.start_s] + [t for ab in trace.busy() for t in ab] + [w.end_s]
    holes = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    gaps: dict = {}
    for (a, b), label in zip(holes, host_labels(trace.spans, [0.5 * (a + b) for a, b in holes])):
        gaps[label] = gaps.get(label, 0.0) + (b - a)
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[n[:160], s] for n, s in ops], "idle_gaps": [[n, s] for n, s in idle]}
