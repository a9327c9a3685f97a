"""The port's benchmark harness (``mcp_tpu_torch/bench/harness.py``) against
the JAX package's: the timing and summary statistics exactly, the batched
benchmark on a small QP and the warm-started θ sweep on the lane change,
both in float64 on the CPU, on the same θ (drawn by the JAX samplers,
passed through numpy)."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcp_tpu.bench import harness as jh
from mcp_tpu.bench import lane_change as jlc
from mcp_tpu.bench import qp as jqp
from mcp_tpu.parallel.batch import solve_batch as jax_solve_batch
from mcp_tpu.parallel.batch import solve_batches_streamed as jax_streamed
from mcp_tpu.solver import SolverOptions as JaxOptions
from mcp_tpu_torch.bench import harness as th
from mcp_tpu_torch.bench import lane_change as tlc
from mcp_tpu_torch.bench import qp as tqp

torch.set_num_threads(1)

NAN = float("nan")

# (host, other, keywords): agreement, each side of the one-sided window,
# the absolute slack, and NaN on either side.
TIMING_CASES = [
    (1.0, 1.0, {}),
    (1.9, 1.0, {}),
    (2.1, 1.0, {}),
    (0.02, 0.001, {}),  # 20x apart but within the 30 ms dispatch slack
    (0.05, 0.001, {}),
    (0.6, 1.0, {}),
    (0.4, 1.0, {}),
    (0.001, 0.02, {}),  # host below: the slack never excuses it
    (2.4, 1.0, {"ratio": 2.5}),
    (1.0, 2.6, {"ratio": 2.5}),
    (3.0, 1.0, {"ratio": 2.0, "dispatch_slack_s": 5.0}),
    (NAN, 1.0, {}),
    (1.0, NAN, {}),
    (NAN, NAN, {}),
    (0.0, 0.0, {}),
]


@pytest.mark.parametrize("host,other,kw", TIMING_CASES)
def test_timing_consistency_equals_jax(host, other, kw):
    assert th.timing_consistency(host, other, **kw) == jh.timing_consistency(host, other, **kw)


SUMMARY_CASES = [
    ([0.1, 0.2, 0.3, 0.4], [1, 1, 0, 1]),
    ([0.5, 0.25], [0, 0]),
    ([0.5], [1]),
    ([], []),
    ([0.3, 0.1, 0.7, 0.2, 0.9], [True, False, True, True, False]),
]


@pytest.mark.parametrize("elapsed,success", SUMMARY_CASES)
def test_summary_statistics_equals_jax(elapsed, success):
    e, s = np.asarray(elapsed, dtype=np.float64), np.asarray(success)
    np.testing.assert_equal(th.summary_statistics(e, s), jh.summary_statistics(e, s))


@pytest.mark.parametrize("a,b", [
    ({"solves_per_sec": 100.0}, {"solves_per_sec": 10.0}),
    ({"mean_time_s": 0.25}, {"solves_per_sec": 2.0}),
    ({"mean_time_s": 0.5, "solves_per_sec": 7.0}, {"mean_time_s": 0.125}),
])
def test_relative_runtime_equals_jax(a, b):
    assert th.relative_runtime(a, b) == jh.relative_runtime(a, b)


# -- benchmark_batched: a small dense QP -----------------------------------

QP_N, QP_M, QP_B = 8, 6, 4


@functools.lru_cache(maxsize=None)
def _qp_thetas() -> np.ndarray:
    """The QP of tests/test_bench.py (sparsity 0: small dense convex QPs
    that must all solve), float64."""
    return np.asarray(jqp.generate_parameter_batch(
        jax.random.PRNGKey(1), QP_B, num_primals=QP_N, num_inequalities=QP_M,
        sparsity_rate=0.0, dtype=jnp.float64))


@functools.lru_cache(maxsize=None)
def _qp_setup(polish: bool):
    """JAX's batched benchmark at tol 1e-6 and the port's, every repeat on
    the same θ in both packages."""
    thetas = _qp_thetas()
    jm = jqp.generate_test_problem(num_primals=QP_N, num_inequalities=QP_M).mcp
    opts = dict(linear_solver="schur", tol=1e-6, polish=polish)
    stats = jh.benchmark_batched(jm, jnp.asarray(thetas), repeats=1, ingraph_check=False,
                                 theta_sampler=lambda i: jnp.asarray(thetas), **opts)
    want = jax.tree.map(np.asarray, jax_solve_batch(jm, jnp.asarray(thetas),
                                                    options=JaxOptions(**opts)))
    tm = tqp.generate_test_problem(num_primals=QP_N, num_inequalities=QP_M, device="cpu").mcp
    got = th.benchmark_batched(tm, torch.tensor(thetas), repeats=1,
                               theta_sampler=lambda i: torch.tensor(thetas), **opts)
    return stats, want, got


@pytest.mark.parametrize("polish", [False, True])
def test_benchmark_batched_matches_jax(polish):
    want_stats, want, got = _qp_setup(polish)
    assert got["success_rate"] == want_stats["success_rate"] == 1.0
    assert got["median_outer_iters"] == want_stats["median_outer_iters"]
    np.testing.assert_array_equal(got["last_result"].status.numpy(), want.status)
    np.testing.assert_array_equal(got["last_result"].outer_iters.numpy(), want.outer_iters)
    # float64 iterates of the same algorithm: rounding only.
    np.testing.assert_allclose(got["last_result"].x.numpy(), want.x, rtol=0, atol=1e-8)
    for key in ("true_kkt_max", "true_kkt_median", "frac_true_kkt_at_tol"):
        np.testing.assert_allclose(got[key], want_stats[key], rtol=0, atol=1e-9)
    if polish:  # the bare ϵ-exit may stop above tol; the polish certifies
        assert got["true_kkt_max"] <= 1e-6 and got["frac_true_kkt_at_tol"] == 1.0


@pytest.mark.parametrize("key", ["best_batch_time_s", "median_batch_time_s",
                                 "mean_batch_time_s", "solves_per_sec"])
def test_benchmark_batched_timing_fields(key):
    got = _qp_setup(False)[2]
    assert math.isfinite(got[key]) and got[key] > 0
    # On the CPU there are no CUDA events: no event time, nothing to flag.
    assert got["event_batch_time_s"] is None and got["timing_consistent"] is True


def test_benchmark_batched_default_perturbation_is_fresh_per_repeat():
    """Without a sampler each repeat solves θ plus 1e-3 of seeded noise:
    two repeats, two different batches, every lane certified."""
    tm = tqp.generate_test_problem(num_primals=QP_N, num_inequalities=QP_M, device="cpu").mcp
    thetas = torch.from_numpy(_qp_thetas())
    got = th.benchmark_batched(tm, thetas, repeats=2, linear_solver="schur", tol=1e-6,
                               polish=True)
    assert got["num_instances"] == 2 * QP_B and got["repeats"] == 2
    assert got["success_rate"] == 1.0 and got["frac_true_kkt_at_tol"] == 1.0


def test_apply_ingraph_crosscheck_ships_the_larger_time():
    stats = {"batch_size": 8, "median_batch_time_s": 0.5, "solves_per_sec": 16.0}
    th.apply_ingraph_crosscheck(stats, [0.8, 0.9, 1.0])
    assert stats["event_batch_time_s"] == 0.9 and stats["timing_consistent"] is True
    assert stats["solves_per_sec"] == 8 / 0.9  # host below the card's own time
    stats = {"batch_size": 8, "median_batch_time_s": 0.5, "solves_per_sec": 16.0}
    th.apply_ingraph_crosscheck(stats, [0.1])
    assert stats["timing_consistent"] is False  # 5x apart, beyond the slack
    assert stats["solves_per_sec"] == 16.0 and stats["event_solves_per_sec"] == 80.0


# -- benchmark_warm_sweep: the lane change ---------------------------------

SWEEP_B, SWEEP_K, DRIFT = 4, 4, 0.02


@functools.lru_cache(maxsize=None)
def _sweep_setup():
    """JAX's warm sweep as in tests/test_bench.py (B=4, K=4, drift 0.02,
    tier "schur", tol 1e-4) in float64; the final step's iterates from the
    same chain (solve_batches_streamed with warm_chain from the cold step)."""
    jb = jlc.generate_test_problem(horizon=10)
    base = np.asarray(jlc.generate_parameter_batch(jax.random.PRNGKey(3), SWEEP_B, jb,
                                                   dtype=jnp.float64))
    sweep = np.stack([base + DRIFT * k for k in range(SWEEP_K)])
    jm = jb.parametric_game.mcp
    opts = dict(linear_solver="schur", tol=1e-4)
    want = jh.benchmark_warm_sweep(jm, jnp.asarray(sweep), **opts)
    cold = jax_solve_batch(jm, jnp.asarray(sweep[0]), options=JaxOptions(**opts))
    chain = jax_streamed(jm, jnp.asarray(sweep[1:]), x0=cold.x, y0=cold.y,
                         options=JaxOptions(**opts), warm_chain=True)
    final = jax.tree.map(lambda a: np.asarray(a)[-1], chain)
    tm = tlc.generate_test_problem(horizon=10, device="cpu").parametric_game.mcp
    got = th.benchmark_warm_sweep(tm, torch.from_numpy(sweep), **opts)
    return want, final, got


def test_warm_sweep_matches_jax():
    want, final, got = _sweep_setup()
    assert got["sweep_steps"] == SWEEP_K and got["batch_size"] == SWEEP_B
    assert got["median_outer_iters_per_step"] == want["median_outer_iters_per_step"]
    assert got["final_success_rate"] == want["final_success_rate"] == 1.0
    res = got["final_result"]
    np.testing.assert_array_equal(res.status.numpy(), final.status)
    np.testing.assert_array_equal(res.outer_iters.numpy(), final.outer_iters)
    np.testing.assert_allclose(res.x.numpy(), final.x, rtol=0, atol=1e-8)
    for key in ("true_kkt_max", "true_kkt_median", "frac_true_kkt_at_tol"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-9)


def test_warm_sweep_timing_fields():
    got = _sweep_setup()[2]
    assert len(got["step_times_s"]) == SWEEP_K - 1
    assert all(t > 0 for t in got["step_times_s"])
    assert got["warm_solves_per_sec"] > 0 and got["median_step_time_s"] > 0
    assert got["event_step_time_s"] is None and got["timing_consistent"] is True



def test_benchmark_sequential_matches_jax():
    """One instance at a time on the small QP: the same sample count and
    success rate as the JAX package's, positive times."""
    thetas = _qp_thetas()
    opts = dict(linear_solver="schur", tol=1e-6)
    jm = jqp.generate_test_problem(num_primals=QP_N, num_inequalities=QP_M).mcp
    want = jh.benchmark_sequential(jm, jnp.asarray(thetas), **opts)
    tm = tqp.generate_test_problem(num_primals=QP_N, num_inequalities=QP_M, device="cpu").mcp
    got = th.benchmark_sequential(tm, torch.tensor(thetas), **opts)
    assert set(got) == set(want)
    assert (got["num_samples"], got["success_rate"]) == (want["num_samples"],
                                                        want["success_rate"]) == (QP_B, 1.0)
    assert got["mean_time_s"] > 0 and got["solves_per_sec"] > 0


def test_profiling_helpers(tmp_path):
    from mcp_tpu_torch.utils import PhaseTimer, time_compiled, trace

    timer = PhaseTimer()
    for _ in range(3):
        with timer.phase("solve"):
            torch.ones(4).sum()
    summary = timer.summary()["solve"]
    assert summary["calls"] == 3 and summary["steady_s"] <= summary["total_s"]
    times = time_compiled(lambda a: a @ a, torch.eye(8), repeats=2)
    assert set(times) == {"first_s", "best_s", "mean_s"} and times["best_s"] >= 0
    with trace(str(tmp_path)):
        torch.eye(8) @ torch.eye(8)
    assert any(tmp_path.iterdir())
