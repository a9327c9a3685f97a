"""The closed loop: one caller hands the program a batch of ``batch`` lanes,
waits for the answer, and sends the next at once. Call k's θ is drawn on the
device just before it. The window opens before the first draw and closes at
the synchronize after the first call that ends ``seconds`` or more after it
opened; that call counts. Traffic parameters: ``batch``, ``trace_seconds``
(the traced run's window) and, optionally, ``pool_calls``.

Without a pool, call k's lanes are fresh, drawn from (seed, k). With one,
every seed solves the same work in another order: the pool holds
``pool_calls`` batches drawn from ``seeds.POOL_SEED``; call k takes the batch
order[k mod pool_calls], the order drawn from the run's seed, with its lanes
permuted by (seed, k). The warm call then takes a batch of its own from
``seeds.POOL_SEED``, so set-up does the same work on every seed too."""

from __future__ import annotations

import time

import torch
from torch.profiler import record_function

from perfbench import seeds
from perfbench.session import SPAN_WINDOW
from perfbench.window import Call, TimedWindow, Window, sync, timing_consistency


def warm(session) -> dict:
    """One call at the window's batch, from the warm stream; the seconds of
    its draw and of its call."""
    t0 = time.perf_counter()
    pooled = bool(session.cell.traffic.get("pool_calls"))
    theta = session.draw(seeds.WARM, 0, seed=seeds.POOL_SEED if pooled else None)
    sync(session.device)
    t1 = time.perf_counter()
    session.fetch(session.solve(theta))
    sync(session.device)
    return {"warm_draw_s": t1 - t0, "warm_call_s": time.perf_counter() - t1}


def drive(session, seconds: float) -> Window:
    device, calls = session.device, []
    with record_function(SPAN_WINDOW), TimedWindow(device) as w:
        while True:
            k = len(calls)
            theta = draw(session, k)
            checksum = theta.double().sum()
            sync(device)
            t0 = time.perf_counter()
            result = session.solve(theta)
            sync(device)
            seconds_k = time.perf_counter() - t0
            calls.append(Call(k, seconds_k, float(checksum), session.fetch(result)))
            del theta, result
            if w.elapsed() >= seconds:
                break
    event_s = w.event_s
    consistent = event_s is None or timing_consistency(w.host_s, event_s)
    return Window(calls, w.host_s, event_s, consistent)


def draw(session, k: int) -> torch.Tensor:
    """θ of the window's call ``k``."""
    n = session.cell.traffic.get("pool_calls")
    if not n:
        return session.draw(seeds.CALLS, k)
    cpu = torch.device("cpu")
    order = torch.randperm(n, generator=seeds.generator(cpu, session.seed, seeds.ORDER, 0))
    theta = session.draw(seeds.CALLS, int(order[k % n]), seed=seeds.POOL_SEED)
    lanes = torch.randperm(session.batch, device=session.device,
                           generator=seeds.generator(session.device, session.seed, seeds.LANES, k))
    return theta[lanes]


def redraw(session, call: Call):
    """Call ``call``'s θ again, for the check."""
    return draw(session, call.index)
