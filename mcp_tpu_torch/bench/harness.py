"""Benchmark harness: certification, success rate, μ±σ runtimes, and
batched, sequential and warm-started throughput.

The reference's harness generates one problem and many random θ, warms the
solve up, times each solve and reports the success rate and the mean and
standard deviation of the successful runtimes. The comparison axes here are
sequential single solves (the reference's execution model) and the batched
path, reported as solves/s with iteration counts and the recomputed true
KKT residuals.

Timing on the card: every timed call ends in ``torch.cuda.synchronize()``,
and CUDA events recorded around the same calls give the card's own time,
held against the host clock by ``timing_consistency``
(``apply_ingraph_crosscheck``). On the CPU there are no events and the
event times are ``None``.
"""

from __future__ import annotations

import time
import warnings
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .._device import matmul_precision
from ..diff import solve
from ..mcp import PrimalDualMCP
from ..parallel.batch import _options, batch_statistics, solve_batch, solve_batches_streamed
from ..solver import SolverOptions
from ..types import SOLVED, SolveResult


def timing_consistency(host_t: float, event_t: float, *, ratio: float = 2.0,
                       dispatch_slack_s: float = 0.03) -> bool:
    """One-sided agreement of a host time and the card's event time.

    The host time may exceed the event time by launch overhead (excused by
    ``dispatch_slack_s`` or the ratio). A host time below the event time
    beyond the ratio means the host stopped its clock before the work was
    done, and no absolute slack excuses it. NaN on either side is unknown
    and passes."""
    if not (host_t == host_t and event_t == event_t):
        return True
    if host_t >= event_t:
        return (
            host_t / max(event_t, 1e-12) <= ratio
            or (host_t - event_t) <= dispatch_slack_s
        )
    return event_t / max(host_t, 1e-12) <= ratio


def summary_statistics(elapsed: np.ndarray, success: np.ndarray) -> dict:
    """Success rate and mean/std of the successful runtimes."""
    ok = success.astype(bool)
    succeeded = elapsed[ok]
    return {
        "num_samples": int(len(elapsed)),
        "success_rate": float(ok.mean()) if len(elapsed) else 0.0,
        "mean_time_s": float(succeeded.mean()) if len(succeeded) else float("nan"),
        "std_time_s": float(succeeded.std()) if len(succeeded) else float("nan"),
    }


def relative_runtime(stats_a: dict, stats_b: dict) -> str:
    """"A runtime is X% that of B", for two stats dicts with mean_time_s or
    solves_per_sec."""
    a = stats_a.get("mean_time_s") or 1.0 / stats_a["solves_per_sec"]
    b = stats_b.get("mean_time_s") or 1.0 / stats_b["solves_per_sec"]
    return f"first runtime is {100.0 * a / b:.1f}% that of second"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class TimedWindow:
    """A timed window: the host clock, and on a card CUDA events recorded at
    its ends. Open it after the inputs are ready; it ends in a synchronize.
    ``host_s``, and ``event_s`` (``None`` on the CPU), after it closes."""

    def __init__(self, device: torch.device):
        self.device = device
        self.host_s = self.event_s = None

    def __enter__(self):
        _sync(self.device)
        if self.device.type == "cuda":
            self._ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            self._ev[0].record()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            self._ev[1].record()
        _sync(self.device)
        self.host_s = time.perf_counter() - self._t0
        if self.device.type == "cuda":
            self.event_s = self._ev[0].elapsed_time(self._ev[1]) / 1e3
        return False


def benchmark_sequential(
    mcp: PrimalDualMCP,
    thetas: torch.Tensor,
    *,
    options: Optional[SolverOptions] = None,
    **option_overrides,
) -> dict:
    """One instance at a time, each solve timed (the reference's execution
    model), after one warm solve of the first θ. thetas (N, p)."""
    options = _options(options, option_overrides)
    thetas = torch.as_tensor(thetas)
    solve(mcp, thetas[0], options=options)
    _sync(thetas.device)
    elapsed, success = [], []
    for theta in thetas:
        with TimedWindow(thetas.device) as w:
            sol = solve(mcp, theta, options=options)
        elapsed.append(w.host_s)
        success.append(int(sol.status) == SOLVED)
    stats = summary_statistics(np.asarray(elapsed), np.asarray(success))
    stats["solves_per_sec"] = (
        stats["num_samples"] / float(np.sum(elapsed)) if elapsed else float("nan")
    )
    return stats


def true_kkt_errors(mcp: PrimalDualMCP, result, thetas: torch.Tensor) -> torch.Tensor:
    """‖F‖∞ recomputed at the FINAL iterates, per instance: max(‖g‖∞,
    ‖h − s‖∞, ‖s∘y‖∞).

    The solver's own kkt_error is the stale pre-step metric and its exit
    can be triggered by ϵ ≤ tol rather than kkt ≤ tol, so an honest report
    re-evaluates the residual at the returned point. Leading axes of
    ``result``/``thetas`` (a batch, or K batches) are kept. An accuracy
    metric: float32 matmuls run at full precision, whatever the caller's."""
    x, y, s = result.x, result.y, result.s
    lead = x.shape[:-1]
    x, y, s = x.reshape(-1, x.shape[-1]), y.reshape(-1, y.shape[-1]), s.reshape(-1, s.shape[-1])
    thetas = torch.as_tensor(thetas).reshape(-1, thetas.shape[-1])
    with torch.no_grad(), matmul_precision("highest"):
        g, h = mcp.gh_batched(x, y, thetas)
        kkt = torch.maximum(
            g.abs().amax(dim=1),
            torch.maximum((h - s).abs().amax(dim=1), (s * y).abs().amax(dim=1)),
        )
    return kkt.reshape(lead)


def certification(true_kkt: np.ndarray, status: np.ndarray, tol: float) -> dict:
    """True-KKT statistics over the SOLVED instances (a failed lane's last
    iterate says nothing about convergence; with none solved the extremes
    are NaN) and the fraction of ALL instances at tol, the honest
    end-to-end success rate."""
    true_kkt, solved = np.ravel(true_kkt), np.ravel(status) == SOLVED
    solved_kkt = true_kkt[solved] if solved.any() else np.asarray([np.nan])
    return {
        "true_kkt_max": float(np.max(solved_kkt)),
        "true_kkt_median": float(np.median(solved_kkt)),
        "frac_true_kkt_at_tol": float(np.mean(true_kkt <= tol)),
    }


def stack_results(results: Sequence[SolveResult]) -> SolveResult:
    """SolveResults of equal shape stacked along a new leading axis."""
    return SolveResult(*(torch.stack(f) for f in zip(*results)))


def benchmark_batched(
    mcp: PrimalDualMCP,
    thetas: torch.Tensor,
    *,
    repeats: int = 5,
    options: Optional[SolverOptions] = None,
    theta_sampler: Optional[Callable[[int], torch.Tensor]] = None,
    ingraph_check: bool = True,
    **option_overrides,
) -> dict:
    """Whole-batch solves, timed over ``repeats`` runs after a warm solve of
    ``thetas`` (B, p). Reports solves/s from the MEDIAN repeat and the
    convergence statistics of every timed repeat, with the recomputed true
    KKT errors (``true_kkt_errors``) of every timed instance.

    Every repeat solves a fresh θ batch: ``theta_sampler(i)`` when given,
    else ``thetas`` plus 1e-3 of a standard normal drawn from
    ``torch.Generator().manual_seed(1000 + i)``. θ is ready on its device
    before the clock starts. When ``ingraph_check``, the CUDA-event times of
    the same repeats cross-check the host clock
    (``apply_ingraph_crosscheck``). The last repeat's SolveResult is
    returned under ``last_result``."""
    options = _options(options, option_overrides)
    thetas = torch.as_tensor(thetas)
    device, B = thetas.device, thetas.shape[0]

    def batch_for(i: int) -> torch.Tensor:
        if theta_sampler is not None:
            return torch.as_tensor(theta_sampler(i)).to(device=device, dtype=thetas.dtype)
        # Small enough to keep the problem distribution, non-zero so no two
        # repeats solve the same bytes.
        g = torch.Generator().manual_seed(1000 + i)
        noise = torch.randn(thetas.shape, generator=g, dtype=thetas.dtype)
        return thetas + 1e-3 * noise.to(device)

    solve_batch(mcp, thetas, options=options)  # warm: builds and caches
    _sync(device)
    times, event_times, results, tks = [], [], [], []
    for r in range(repeats):
        th = batch_for(r)
        with TimedWindow(device) as w:
            result = solve_batch(mcp, th, options=options)
        times.append(w.host_s)
        if w.event_s is not None:
            event_times.append(w.event_s)
        results.append(result)
        tks.append(true_kkt_errors(mcp, result, th))
    median_t = float(np.median(times))
    everything = stack_results(results)
    stats = batch_statistics(everything)
    stats.update(
        {
            "batch_size": B,
            "repeats": repeats,
            "best_batch_time_s": float(min(times)),
            "median_batch_time_s": median_t,
            "mean_batch_time_s": float(np.mean(times)),
            "solves_per_sec": B / median_t,
            **certification(torch.stack(tks).cpu().numpy(),
                            everything.status.cpu().numpy(), options.tol),
        }
    )
    stats["last_result"] = results[-1]
    if ingraph_check:
        apply_ingraph_crosscheck(stats, event_times)
    return stats


def apply_ingraph_crosscheck(stats: dict, event_times: Sequence[float]) -> dict:
    """Fold the card's own time of the timed repeats into ``stats`` (as made
    by ``benchmark_batched``): ``event_batch_time_s`` is the median of the
    CUDA-event times recorded around the same repeats as the host clock,
    and ``timing_consistent`` holds the two together (``timing_consistency``).
    Nothing runs a second time. When the host time is the smaller, or the
    two disagree, the larger time sets ``solves_per_sec``. With no event
    times (the CPU) the event time is ``None`` and the check passes."""
    B = stats["batch_size"]
    median_t = stats["median_batch_time_s"]
    if not event_times:
        stats.update(event_batch_time_s=None, timing_consistent=True)
        return stats
    event_t = float(np.median(event_times))
    consistent = timing_consistency(median_t, event_t)
    if not consistent:
        ratio = max(median_t, event_t) / max(min(median_t, event_t), 1e-12)
        warnings.warn(
            f"benchmark timing cross-check FAILED: host median {median_t:.4f} "
            f"s/batch vs CUDA events {event_t:.4f} s/batch ({ratio:.1f}x apart); "
            "the larger is reported.",
            stacklevel=2,
        )
    stats.update(
        event_batch_time_s=event_t,
        event_solves_per_sec=B / event_t,
        timing_consistent=bool(consistent),
    )
    if not consistent or median_t < event_t:
        # A host time below the card's own time has no legitimate cause:
        # the larger time ships.
        stats["solves_per_sec"] = B / max(median_t, event_t)
    return stats


def benchmark_warm_sweep(
    mcp: PrimalDualMCP,
    theta_sweep: torch.Tensor,
    *,
    options: Optional[SolverOptions] = None,
    warm_slacks: bool = False,
    cold_options: Optional[SolverOptions] = None,
    **option_overrides,
) -> dict:
    """Warm-started re-solves across a θ sweep (K, B, p), the receding-
    horizon pattern: step k's batch warm-starts from step k−1's (x, y), and
    from its s too when ``warm_slacks`` (Mehrotra stalls from an off-central
    s₀ = 1). ``cold_options`` sets the cold first solve (e.g. the annealed
    loop before Mehrotra re-solves).

    The cold first step and a warm probe of step 1 run outside the clock.
    Each timed step warm-starts from the last solved lanes: a lane whose
    solve failed keeps its previous warm start. The same chain then runs
    through ``solve_batches_streamed(warm_chain=True)`` between CUDA events,
    the card's own time per step, against the host median per step (on a
    card only: on the CPU ``event_step_time_s`` is ``None``). The final step
    is certified (``true_kkt_errors``); its SolveResult is returned under
    ``final_result``."""
    options = _options(options, option_overrides)
    theta_sweep = torch.as_tensor(theta_sweep)
    device = theta_sweep.device
    K, B, _ = theta_sweep.shape
    cold = solve_batch(mcp, theta_sweep[0], options=cold_options or options)
    _sync(device)
    result = cold
    if K > 1:
        warm0 = {"s0": cold.s} if warm_slacks else {}
        solve_batch(mcp, theta_sweep[1], x0=cold.x, y0=cold.y, options=options, **warm0)
        _sync(device)
    iters = [batch_statistics(cold)["median_outer_iters"]]
    warm_x, warm_y, warm_s = cold.x, cold.y, cold.s
    times = []
    for k in range(1, K):
        warm = {"s0": warm_s} if warm_slacks else {}
        with TimedWindow(device) as w:
            result = solve_batch(
                mcp, theta_sweep[k], x0=warm_x, y0=warm_y, options=options, **warm
            )
        times.append(w.host_s)
        ok = (result.status == SOLVED)[:, None]
        warm_x = torch.where(ok, result.x, warm_x)
        warm_y = torch.where(ok, result.y, warm_y)
        if warm_slacks:
            warm_s = torch.where(ok, result.s, warm_s)
        iters.append(batch_statistics(result)["median_outer_iters"])

    event_step_t = None
    if K > 1 and device.type == "cuda":  # the CPU has no events to read
        with TimedWindow(device) as w:
            solve_batches_streamed(
                mcp, theta_sweep[1:], x0=cold.x, y0=cold.y,
                s0=cold.s if warm_slacks else None, options=options,
                warm_chain=True, warm_slacks=warm_slacks,
            )
        event_step_t = w.event_s / (K - 1)
    true_kkt = true_kkt_errors(mcp, result, theta_sweep[-1]).cpu().numpy()
    host_step_t = float(np.median(times)) if times else float("nan")
    ev = float("nan") if event_step_t is None else event_step_t
    consistent = timing_consistency(host_step_t, ev, ratio=2.5)
    if host_step_t == host_step_t and ev == ev:
        # The host median ships when it agrees and is the larger; otherwise
        # the larger of the two.
        step_t = (
            host_step_t if consistent and host_step_t >= ev else max(host_step_t, ev)
        )
    else:
        step_t = host_step_t if host_step_t == host_step_t else ev
    return {
        "sweep_steps": K,
        "batch_size": B,
        "warm_solves_per_sec": B / step_t if step_t == step_t else float("nan"),
        "median_step_time_s": host_step_t,
        "event_step_time_s": event_step_t,
        "timing_consistent": bool(consistent),
        "step_times_s": [float(t) for t in times],
        "median_outer_iters_per_step": iters,
        "final_success_rate": batch_statistics(result)["success_rate"],
        **certification(true_kkt, result.status.cpu().numpy(), options.tol),
        "final_result": result,
    }
