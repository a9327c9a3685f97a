"""The masked N-player game (the flagship game at N=4, horizon 6: blocks of
b=40, T=6) in the PyTorch port against the JAX package, in float64 on the
CPU: the game build, the colored-seed bands, the cold start and θ packing,
and the annealed solve with polish on every ported banded tier that the
flagship path reaches.

The JAX reference solves run the JAX package's tiers as its own tests run
them on the CPU (Pallas kernels in interpret mode). To keep this file well
under two minutes, the port's "tridiag" and "tridiag_pallas_crgjpr" tiers
are held against the JAX "tridiag_cr" solve (every tier solves the same
regularized Newton system exactly; they differ by rounding only), while
"tridiag_auto" and "tridiag_cr" are held against their own JAX tiers. The
hybrid algorithm is tested in test_torch_masked_hybrid.py."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcp_tpu.bench.flagships import masked_game_setup as jax_setup
from mcp_tpu.kernels.block_tridiag import gh_banded as jax_gh_banded
from mcp_tpu.parallel.batch import solve_batch as jax_solve_batch
from mcp_tpu.selection.games import pack_masked_theta as jax_pack_masked_theta
from mcp_tpu.solver import SolverOptions as JaxOptions
from mcp_tpu_torch import SOLVED, SolverOptions, auto_tightening_rate, solve_batch
from mcp_tpu_torch.bench.flagships import masked_game_setup
from mcp_tpu_torch.kernels import cyclic_reduction as C
from mcp_tpu_torch.kernels.block_tridiag import gh_banded
from mcp_tpu_torch.selection import pack_masked_theta
from mcp_tpu_torch.trajectories.strategies import cold_start_primal, zero_input_trajectory

torch.set_num_threads(1)

OPTS = dict(tol=1e-4, polish=True, tightening_rate=0.02)


@functools.lru_cache(maxsize=None)
def _setup():
    js = jax_setup(2, 4, 6)
    ts = masked_game_setup(2, 4, 6, device="cpu", dtype=torch.float64)
    thetas = np.asarray(js.thetas, dtype=np.float64)
    x0 = np.asarray(js.x0, dtype=np.float64)
    return js, ts, thetas, x0


@functools.lru_cache(maxsize=None)
def _jax_solve(tier):
    js, _, thetas, x0 = _setup()
    res = jax_solve_batch(js.mcp, jnp.asarray(thetas), x0=jnp.asarray(x0),
                          options=JaxOptions(linear_solver=tier, **OPTS))
    return jax.tree.map(np.asarray, res)


def _port_solve(tier, **extra):
    _, ts, thetas, x0 = _setup()
    return solve_batch(ts.mcp, torch.from_numpy(thetas), x0=torch.from_numpy(x0),
                       options=SolverOptions(linear_solver=tier, **OPTS, **extra))


def _probe(mcp, seed):
    rng = np.random.default_rng(seed)
    n, m = mcp.unconstrained_dimension, mcp.constrained_dimension
    return 0.3 * rng.standard_normal(n), 1.0 + 0.1 * rng.random(m)


def test_game_build_matches_jax():
    js, ts, _, _ = _setup()
    jm, tm = js.mcp, ts.mcp
    assert (tm.unconstrained_dimension, tm.constrained_dimension, tm.parameter_dimension) == (
        jm.unconstrained_dimension, jm.constrained_dimension, jm.parameter_dimension) == (
        240, 294, 40)
    jst, tst = jm.time_structure, tm.time_structure
    assert tuple(tst.permutation) == tuple(jst.permutation)
    assert tuple(tst.row_permutation) == tuple(jst.row_permutation)
    assert (tst.num_blocks, tst.block_size, tst.rows_per_block) == (
        jst.num_blocks, jst.block_size, jst.rows_per_block) == (6, 40, 49)
    # The soft-masked repulsion is not quadratic: no affine bands in either.
    assert jm.affine_bands is None and tm.affine_bands is None
    assert auto_tightening_rate(tm) == OPTS["tightening_rate"]


@pytest.mark.parametrize("lane", [0, 1])
def test_residual_matches_jax(lane):
    js, ts, thetas, _ = _setup()
    x, y = _probe(ts.mcp, lane)
    g_j, h_j = js.mcp.gh(jnp.asarray(x), jnp.asarray(y), jnp.asarray(thetas[lane]))
    g_t, h_t = ts.mcp.gh(*(torch.from_numpy(a) for a in (x, y, thetas[lane])))
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=0, atol=1e-12)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), rtol=0, atol=1e-12)


def test_colored_seed_bands_match_jax():
    js, ts, thetas, _ = _setup()
    x, y = _probe(ts.mcp, 7)
    want = jax_gh_banded(js.mcp, js.mcp.time_structure, jnp.asarray(x), jnp.asarray(y),
                         jnp.asarray(thetas[0]))
    got = gh_banded(ts.mcp, ts.mcp.time_structure,
                    *(torch.from_numpy(a) for a in (x, y, thetas[0])))
    for name, g, w in zip(("g", "h", "diag", "lower", "upper", "Gy", "Hx"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-10, err_msg=name)


def test_cold_start_matches_jax():
    js, ts, _, _ = _setup()
    init = np.asarray(js.init, dtype=np.float64)
    want = np.asarray(js.runner.cold_starts(jnp.asarray(init)))
    got = ts.runner.cold_starts(torch.from_numpy(init))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    one = cold_start_primal(ts.runner.game, ts.runner.parametric_game, 6,
                            torch.from_numpy(init[1].reshape(-1)))
    torch.testing.assert_close(one, got[1], rtol=0, atol=0)
    trajs = zero_input_trajectory(game=ts.runner.game, horizon=6,
                                  initial_state=torch.from_numpy(init[0].reshape(-1)))
    assert len(trajs) == 4 and tuple(trajs[0].xs.shape) == (6, 4)
    # Zero controls: the velocity is constant along the rollout.
    torch.testing.assert_close(trajs[2].xs[:, 2:], trajs[2].xs[:1, 2:].expand(6, 2))


def test_theta_packing_matches_jax():
    js, ts, thetas, _ = _setup()
    init, goals = np.asarray(js.init, np.float64), np.asarray(js.goals, np.float64)
    rng = np.random.default_rng(3)
    masks = rng.random((2, 4))
    masks[:, 0] = 1.0
    rows_j = js.runner.ego_masked_mask_rows(jnp.asarray(masks), ego_index=0)
    rows_t = ts.runner.ego_masked_mask_rows(torch.from_numpy(masks), ego_index=0)
    np.testing.assert_array_equal(rows_t.numpy(), np.asarray(rows_j))
    want = js.runner.pack_thetas(jnp.asarray(init), jnp.asarray(goals), rows_j)
    got = ts.runner.pack_thetas(*(torch.from_numpy(a) for a in (init, goals)), rows_t)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        pack_masked_theta(*(torch.from_numpy(a[0]) for a in (init, goals, masks))).numpy(),
        np.asarray(jax_pack_masked_theta(*(jnp.asarray(a[0]) for a in (init, goals, masks)))))
    # The flagship θ: all-ones masks, the same layout.
    ones = torch.ones((2, 4, 4), dtype=torch.float64)
    np.testing.assert_allclose(
        ts.runner.pack_thetas(torch.from_numpy(init), torch.from_numpy(goals), ones).numpy(),
        thetas, rtol=0, atol=0)


@pytest.mark.parametrize("tier, jax_tier", [
    ("tridiag_auto", "tridiag_auto"),
    ("tridiag_cr", "tridiag_cr"),
    ("tridiag", "tridiag_cr"),
    ("tridiag_pallas_crgjpr", "tridiag_cr"),
])
def test_annealed_solve_matches_jax(tier, jax_tier):
    want = _jax_solve(jax_tier)
    got = _port_solve(tier)
    assert (want.status == SOLVED).all()
    np.testing.assert_array_equal(got.status.numpy(), want.status)
    np.testing.assert_array_equal(got.outer_iters.numpy(), want.outer_iters)
    # 1e-7: float64 iterates of the same algorithm; the tiers and the two
    # packages differ by rounding only (measured ~2e-15).
    np.testing.assert_allclose(got.x.numpy(), want.x, rtol=0, atol=1e-7)
    assert (got.kkt_error.numpy() <= OPTS["tol"]).all()


def test_auto_tier_runs_cr_gjp_on_the_flagship_shape(monkeypatch):
    """B=2, b=40: the auto tier routes to K3 with pivoted Gauss–Jordan (the
    plain version on the CPU, so no launch is counted)."""
    from mcp_tpu_torch.kernels import thomas_dispatch as TD

    assert TD.auto_pick(2, 6, 40) == ("cr", "gjp")
    calls = []
    real = C.cr_solve_plain

    def spy(diag, lower, upper, rhs, fact="qr"):
        calls.append(fact)
        return real(diag, lower, upper, rhs, fact)

    monkeypatch.setattr(C, "cr_solve_plain", spy)
    res = _port_solve("tridiag_auto", max_outer_iters=2)
    assert set(calls) == {"gjp"} and len(calls) > 0
    assert tuple(res.x.shape) == (2, 240)


def test_runner_solve_is_solve_batch_with_its_options():
    js, ts, thetas, x0 = _setup()
    runner = dataclasses.replace(
        ts.runner, options=SolverOptions(linear_solver="tridiag_auto", **OPTS))
    init, goals = (torch.from_numpy(np.asarray(a, np.float64)) for a in (js.init, js.goals))
    masks = torch.ones((2, 4), dtype=torch.float64)
    nxt, ctrl, bs = runner.step_closed_loop(init, goals, masks, x0=torch.from_numpy(x0))
    ref = _port_solve("tridiag_auto")
    np.testing.assert_array_equal(bs.result.status.numpy(), ref.status.numpy())
    torch.testing.assert_close(bs.result.x, ref.x, rtol=0, atol=0)
    trajs, ctrls = runner.unpack_plans(bs.result.x)
    assert tuple(trajs.shape) == (2, 4, 6, 4) and tuple(ctrls.shape) == (2, 4, 6, 2)
    torch.testing.assert_close(nxt, trajs[:, :, 1])
    torch.testing.assert_close(ctrl, ctrls[:, :, 0])
    # Player 0's plan is the first T·6 primal entries: states, then controls.
    torch.testing.assert_close(trajs[0, 0].reshape(-1), bs.result.x[0, :24])
