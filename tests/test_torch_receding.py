"""The warm-started receding-horizon path of the port
(``trajectories/strategies.py``, ``examples/lane_change.py``) against the
JAX package's: the lane-change demo rolled out in float64 on the CPU in
both packages, and the warm-start rules (warm only after a SOLVED solve; a
failed solve never overwrites the warm start)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcp_tpu.bench import lane_change as jlc
from mcp_tpu.examples import lane_change as jex
from mcp_tpu.solver import SolverOptions as JaxOptions
from mcp_tpu.trajectories.strategies import solve_trajectory_game as jax_solve_trajectory_game
from mcp_tpu_torch import FAILED, SOLVED, SolverOptions
from mcp_tpu_torch.bench import lane_change as tlc
from mcp_tpu_torch.examples import lane_change as tex
from mcp_tpu_torch.trajectories import (
    JointStrategy,
    OpenLoopStrategy,
    WarmStartRecedingHorizonStrategy,
    pack_parameters,
    solve_trajectory_game,
)

torch.set_num_threads(1)

DEMO = dict(num_sim_steps=4, turn_length=2)


@functools.lru_cache(maxsize=None)
def _demo():
    want_sim, want_strat = jex.run_lane_change_example(**DEMO)
    got_sim, got_strat = tex.run_lane_change_example(**DEMO, device="cpu", dtype=torch.float64)
    return want_sim, want_strat, got_sim, got_strat


def test_demo_statuses_and_replan_times_match_jax():
    want_sim, want_strat, got_sim, got_strat = _demo()
    assert got_sim.infos == [int(s) for s in want_sim.infos] == [SOLVED] * DEMO["num_sim_steps"]
    assert got_strat.time_last_updated == want_strat.time_last_updated == 2
    assert got_strat.solution_status == want_strat.solution_status == SOLVED
    assert int(got_strat.last_solution.outer_iters) == int(want_strat.last_solution.outer_iters)


@pytest.mark.parametrize("field", ["xs", "us"])
def test_demo_rollout_matches_jax(field):
    want_sim, _, got_sim, _ = _demo()
    got, want = getattr(got_sim, field), np.asarray(getattr(want_sim, field))
    assert got.dtype == torch.float64 and tuple(got.shape) == want.shape
    # float64 solves of the same algorithm: rounding only.
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-8)


def test_demo_last_plan_matches_jax():
    _, want_strat, _, got_strat = _demo()
    np.testing.assert_allclose(got_strat.last_solution.x.numpy(),
                               np.asarray(want_strat.last_solution.x), rtol=0, atol=1e-8)


@functools.lru_cache(maxsize=None)
def _game():
    return tlc.generate_test_problem(horizon=10, device="cpu")


def _theta_blocks(state, dtype=torch.float64):
    bench = _game()
    blocks = bench.game.dynamics.state_blocking.split(torch.as_tensor(state, dtype=dtype))
    lane = torch.tensor([bench.lane_centers[0]], dtype=dtype)
    return pack_parameters(blocks, [lane, lane])


def test_failed_solve_keeps_the_warm_start():
    """A re-plan whose solve fails (one outer iteration) reports FAILED but
    keeps the last SOLVED solution as the warm start; the next re-plan
    warm-starts from it."""
    bench = _game()
    lane = torch.tensor([bench.lane_centers[0]], dtype=torch.float64)
    strat = WarmStartRecedingHorizonStrategy(
        game=bench.game, parametric_game=bench.parametric_game, turn_length=1,
        horizon=10, parameters=[lane, lane],
    )
    state = torch.tensor(tex.DEMO_INITIAL_STATE, dtype=torch.float64)
    strat(state, 0)
    first = strat.last_solution
    assert strat.solution_status == SOLVED and first is not None
    strat.options = SolverOptions(max_outer_iters=1)
    strat(state, 1)
    assert strat.solution_status == FAILED
    assert strat.last_solution is first
    assert strat.time_last_updated == 1
    # The failed plan still drives the strategy until the next re-plan.
    assert isinstance(strat.receding_horizon_strategy, JointStrategy)
    strat.options = None
    strat(state, 2)
    assert strat.solution_status == SOLVED and strat.last_solution is not first


def test_warm_start_matches_a_solve_from_the_last_solution():
    """A warm re-plan is the solve from the last solution's (x, y), and a
    failed last solution leads to the cold start."""
    from mcp_tpu_torch import solve_game

    bench = _game()
    theta = _theta_blocks(tex.DEMO_INITIAL_STATE)
    _, cold = solve_trajectory_game(bench.game, 10, theta, parametric_game=bench.parametric_game)
    _, warm = solve_trajectory_game(bench.game, 10, theta, parametric_game=bench.parametric_game,
                                    last_solution=cold)
    direct = solve_game(bench.parametric_game, theta, x0=cold.x, y0=cold.y)
    torch.testing.assert_close(warm.x, direct.x, rtol=0, atol=0)
    _, again = solve_trajectory_game(bench.game, 10, theta, parametric_game=bench.parametric_game,
                                     last_solution=cold._replace(status=torch.tensor(FAILED)))
    torch.testing.assert_close(again.x, cold.x, rtol=0, atol=0)


def test_warm_start_slacks_match_jax():
    """solve_trajectory_game with warm_start_slacks (an annealed cold solve,
    then a Mehrotra re-solve from (x, y, s)), against the JAX package's
    (tests/test_mehrotra.py), in float64."""
    jb = jlc.generate_test_problem(horizon=10)
    theta = np.asarray(jlc.generate_random_parameter(jax.random.PRNGKey(5), jb,
                                                     dtype=jnp.float64))
    ip = dict(linear_solver="schur", tol=1e-4)
    me = dict(ip, algorithm="mehrotra")
    outs = []
    for solve, opts, blocks, game, pg in (
        (jax_solve_trajectory_game, JaxOptions, [jnp.asarray(theta[:5]), jnp.asarray(theta[5:])],
         jb.game, jb.parametric_game),
        (solve_trajectory_game, SolverOptions, [torch.tensor(theta[:5]), torch.tensor(theta[5:])],
         _game().game, _game().parametric_game),
    ):
        _, sol0 = solve(game, 10, blocks, parametric_game=pg, options=opts(**ip))
        _, sol1 = solve(game, 10, blocks, parametric_game=pg, last_solution=sol0,
                        options=opts(**me), warm_start_slacks=True)
        outs.append((sol0, sol1))
    (j0, j1), (t0, t1) = outs
    for j, t in ((j0, t0), (j1, t1)):
        assert int(t.status) == int(j.status) == SOLVED
        assert int(t.outer_iters) == int(j.outer_iters)
        np.testing.assert_allclose(t.x.numpy(), np.asarray(j.x), rtol=0, atol=1e-8)
    assert int(t1.outer_iters) <= int(t0.outer_iters)


def test_open_loop_and_joint_strategies():
    xs, us = torch.zeros(3, 4), torch.arange(6.0).reshape(3, 2)
    a, b = OpenLoopStrategy(xs, us), OpenLoopStrategy(xs, -us)
    torch.testing.assert_close(a(None, 1), us[1])
    torch.testing.assert_close(JointStrategy([a, b])(None, 2), torch.cat([us[2], -us[2]]))


def test_origin_demo_runs_on_the_cpu():
    """The original demo's game (tighter velocity box, re-plan every 3):
    a short rollout on the CPU in float64, every re-plan SOLVED."""
    sim, strat = tex.run_lane_change_origin_example(num_sim_steps=4, device="cpu",
                                                    dtype=torch.float64)
    assert sim.infos == [SOLVED] * 4 and strat.time_last_updated == 3
    assert tuple(sim.xs.shape) == (4, 8) and bool(torch.isfinite(sim.xs).all())
    # forward speed stays inside the 0–5 m/s box (interior-point slack)
    assert float(sim.xs[:, [3, 7]].max()) <= 5.0 + 1e-3


@pytest.mark.parametrize("fn", [tex.run_lane_change_example, tex.run_lane_change_origin_example])
def test_demos_default_to_cuda_and_raise_without_gpu(fn):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="cuda"):
        fn(num_sim_steps=1)


def test_dataclass_fields_match_jax():
    names = lambda cls: [f.name for f in dataclasses.fields(cls)]
    from mcp_tpu.trajectories import strategies as js

    assert names(WarmStartRecedingHorizonStrategy) == names(js.WarmStartRecedingHorizonStrategy)


@pytest.mark.parametrize("batched", [False, True])
def test_solve_whose_loop_never_runs_matches_jax(batched):
    """max_outer_iters=1 runs no outer iteration: the solve returns its
    starting point, FAILED, as the JAX package's does. The port's IFT solve
    used to raise here (autograd refuses an input saved as an output)."""
    from mcp_tpu.diff import solve as jax_one
    from mcp_tpu.parallel.batch import solve_batch as jax_batch
    from mcp_tpu_torch import solve, solve_batch

    jax_solve, port_solve = (jax_batch, solve_batch) if batched else (jax_one, solve)
    jb = jlc.generate_test_problem(horizon=10)
    theta = np.asarray(jlc.generate_parameter_batch(jax.random.PRNGKey(6), 2, jb,
                                                    dtype=jnp.float64))
    theta = theta if batched else theta[0]
    x0 = np.linspace(0.0, 1.0, 200) * np.ones(theta.shape[:-1] + (1,))
    want = jax_solve(jb.parametric_game.mcp, jnp.asarray(theta), x0=jnp.asarray(x0),
                     max_outer_iters=1, linear_solver="schur")
    got = port_solve(_game().parametric_game.mcp, torch.tensor(theta), x0=torch.tensor(x0),
                max_outer_iters=1, linear_solver="schur")
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(want.status))
    np.testing.assert_array_equal(got.outer_iters.numpy(), np.asarray(want.outer_iters))
    assert bool((got.status == FAILED).all())
    np.testing.assert_array_equal(got.x.numpy(), np.asarray(want.x))
    np.testing.assert_array_equal(got.x.numpy(), x0)
