"""The port's tracing (``mcp_tpu_torch/telemetry.py``) on small solves on the
CPU: a QP (n = m = 5, B = 8, float64, Mehrotra with the polish, one lane
made infeasible) and the lane-change game at horizon 3 (B = 4, the annealed
loop with the polish), each on its benchmark cell's tier.

With no profiler recording, a solve enters no ``record_function`` and leaves
the table empty; while one records, the spans land in the Kineto trace, the
polish's Newton steps nest in ``mcp.polish``, the counters count the Newton
steps that the trace shows, and the solve's results and loop tests are
those of an untraced solve."""

from __future__ import annotations

import functools
from types import SimpleNamespace
from unittest import mock

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from mcp_tpu_torch import diff, solver, telemetry
from mcp_tpu_torch.bench import lane_change, qp
from mcp_tpu_torch.parallel.batch import solve_batch
from mcp_tpu_torch.solver import SolverOptions
from mcp_tpu_torch.types import FAILED, SOLVED

N = M = 5
QP_B = 8
INFEASIBLE = 2
POLISH_STEPS = 20  # SolverOptions.max_inner_iters


@functools.lru_cache(maxsize=None)
def _qp():
    mcp = qp.generate_test_problem(num_primals=N, num_inequalities=M, device="cpu").mcp
    theta = qp.generate_parameter_batch(
        torch.Generator().manual_seed(3), QP_B, num_primals=N, num_inequalities=M,
        sparsity_rate=0.0, dtype=torch.float64, device="cpu")
    # Row 0 of A zero and b₀ = 1: A₀x − b₀ = −1 for every x, no feasible point.
    theta[INFEASIBLE, N * N:N * N + N] = 0.0
    theta[INFEASIBLE, N * N + M * N] = 1.0
    options = SolverOptions(tol=1e-6, linear_solver="schur_pallas_gj", algorithm="mehrotra",
                            refinement_steps=0, max_outer_iters=25, polish=True)
    return mcp, theta, options


@functools.lru_cache(maxsize=None)
def _game():
    bench = lane_change.generate_test_problem(horizon=3, device="cpu")
    mcp = bench.parametric_game.mcp
    theta = lane_change.generate_parameter_batch(
        torch.Generator().manual_seed(1), 4, bench, dtype=torch.float64, device="cpu")
    options = SolverOptions(tol=1e-6, linear_solver="tridiag_pallas", algorithm="ip",
                            tightening_rate=solver.auto_tightening_rate(mcp),
                            refinement_steps=1, polish=True)
    return mcp, theta, options


CASES = {"qp": _qp, "game": _game}


def _traced(fn):
    """``fn()`` under a CPU profile: (its result, the table, the host spans as
    name → [(start, end)] in ns)."""
    telemetry.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    table = telemetry.snapshot()
    telemetry.reset()
    spans = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU and e.name() in telemetry.SPANS:
            spans.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    return out, table, spans


def _refuse(*args, **kwargs):
    raise AssertionError("record_function entered with no profiler recording")


@functools.lru_cache(maxsize=None)
def _runs(name):
    """The case's solve untraced, with ``record_function`` refusing to be
    entered, and traced, each with its loop tests counted."""
    mcp, theta, options = CASES[name]()
    tests = []
    real = solver._any

    def solve():
        return solve_batch(mcp, theta, options=options)

    with mock.patch.object(solver, "_any", lambda *a, **k: tests.append(1) or real(*a, **k)):
        telemetry.reset()
        with mock.patch.object(torch.profiler, "record_function", _refuse), \
                mock.patch.object(torch.autograd.profiler, "record_function", _refuse):
            off = solve()
        off_table, off_tests = telemetry.snapshot(), len(tests)
        tests.clear()
        on, table, spans = _traced(solve)
    return SimpleNamespace(off=off, off_table=off_table, off_tests=off_tests, on=on,
                           table=table, spans=spans, on_tests=len(tests), batch=theta.shape[0])


@pytest.fixture(params=sorted(CASES))
def run(request):
    return _runs(request.param)


def test_no_profiler_no_record_function(run):
    assert run.off_table == {"spans": {}, "counters": {}}


def test_setup_and_polish_spans_in_the_trace(run):
    spans, table = run.spans, run.table
    assert len(spans[telemetry.SETUP]) == len(spans[telemetry.POLISH]) == 1
    (p0, p1), = spans[telemetry.POLISH]
    (s0, s1), = spans[telemetry.SETUP]
    newton = spans[telemetry.NEWTON]
    in_polish = [(a, b) for a, b in newton if a >= p0]
    # The set-up ends before the first step; the polish's steps nest in it
    # and are the polish's count; the main loop's all end before it.
    assert s1 <= min(a for a, _ in newton)
    assert all(p0 <= a and b <= p1 for a, b in in_polish)
    assert all(b <= p0 for a, b in newton if a < p0)
    assert len(in_polish) == table["counters"].get(telemetry.POLISH_STEPS, 0)
    for name in (telemetry.SETUP, telemetry.POLISH, telemetry.NEWTON, telemetry.RESIDUAL,
                 telemetry.LINESEARCH, telemetry.LOOP_TEST):
        assert table["spans"][name]["count"] == len(spans[name])
        assert table["spans"][name]["ns"] > 0


def test_lane_steps_count_the_newton_spans(run):
    lanes = run.table["counters"][telemetry.LANE_STEPS]
    assert lanes % run.batch == 0
    assert lanes // run.batch == len(run.spans[telemetry.NEWTON]) > 0
    assert 0 < run.table["counters"][telemetry.LIVE_LANE_STEPS] <= lanes


def test_live_lane_steps_by_hand():
    """Each lane is live at the Mehrotra steps that take its iteration count
    from 1 to its final count; in the polish only the infeasible lane stays
    above the exit test, and it keeps the whole batch polishing for every
    one of the polish's steps."""
    run = _runs("qp")
    r = run.on
    want_status = torch.full((QP_B,), SOLVED, dtype=torch.int32)
    want_status[INFEASIBLE] = FAILED
    assert torch.equal(r.status, want_status)
    main = int((r.outer_iters - 1).sum())
    c = run.table["counters"]
    assert c[telemetry.POLISH_STEPS] == POLISH_STEPS
    assert c[telemetry.LIVE_LANE_STEPS] == main + POLISH_STEPS * 1
    assert c[telemetry.LANE_STEPS] == QP_B * (int(r.outer_iters.max()) - 1 + POLISH_STEPS)


def test_tracing_changes_no_result(run):
    for name, a, b in zip(run.off._fields, run.off, run.on):
        assert a.dtype == b.dtype and torch.equal(a, b), name


def test_tracing_keeps_the_loop_tests(run):
    """The same number of loop tests (each one host sync) traced and not."""
    assert run.on_tests == run.off_tests == run.table["spans"][telemetry.LOOP_TEST]["count"]


def test_ift_spans_through_the_table():
    mcp, theta, options = _qp()
    theta = theta[:2].clone().requires_grad_()

    def solve_and_grad():
        r = diff.solve(mcp, theta, options=options)
        r.x.sum().backward()
        return r

    _, table, spans = _traced(solve_and_grad)
    for name in (diff.SPAN_IFT_BANDS, diff.SPAN_IFT_SOLVE):
        assert table["spans"][name]["count"] == len(spans[name]) >= 1


def test_span_forms_and_table():
    @telemetry.span(telemetry.LINESEARCH)
    def doubled(v):
        return 2 * v

    telemetry.reset()
    assert not telemetry.recording()
    with telemetry.span(telemetry.SETUP):
        assert doubled(3) == 6
    assert telemetry.snapshot() == {"spans": {}, "counters": {}}
    with profile(activities=[ProfilerActivity.CPU]):
        assert telemetry.recording()
        for _ in range(2):
            with telemetry.span(telemetry.SETUP):
                assert doubled(4) == 8
        with pytest.raises(ValueError), telemetry.span(telemetry.POLISH):
            raise ValueError
        telemetry.count(telemetry.LANE_STEPS, 8)
        telemetry.count(telemetry.LANE_STEPS, 8)
    snap = telemetry.snapshot()
    assert {k: v["count"] for k, v in snap["spans"].items()} == {
        telemetry.SETUP: 2, telemetry.LINESEARCH: 2, telemetry.POLISH: 1}
    assert snap["spans"][telemetry.SETUP]["ns"] >= snap["spans"][telemetry.LINESEARCH]["ns"] > 0
    assert snap["counters"] == {telemetry.LANE_STEPS: 16}
    telemetry.reset()
    assert telemetry.snapshot() == {"spans": {}, "counters": {}}


def test_one_registry_of_names():
    names = (solver.SPAN_RESIDUAL, solver.SPAN_NEWTON, solver.SPAN_LINESEARCH,
             solver.SPAN_LOOP_TEST, solver.SPAN_SETUP, solver.SPAN_POLISH,
             diff.SPAN_IFT_BANDS, diff.SPAN_IFT_SOLVE)
    assert sorted(names) == sorted(telemetry.SPANS) and len(set(names)) == len(names)
    assert solver.SPAN_NEWTON == "mcp.newton_solve"  # the benchmark's readers count it
    assert len(set(telemetry.COUNTERS)) == 3 and not set(telemetry.COUNTERS) & set(names)
