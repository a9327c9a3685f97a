"""The horizon-sharded (SPIKE) and batch-sharded solves of the PyTorch port
against the JAX package's on its virtual CPU mesh, float64 on the CPU.

The three SPIKE stages run in one process for D ∈ {2, 4} against
``horizon_sharded_tridiag_solve`` on 2 or 4 of the 8 virtual devices. Then
spawned ranks over gloo (``bench/horizon.py``, a file rendezvous under the
test's temporary directory, one thread each; the ranks import the port
only): 2 ranks run the sharded block-tridiagonal solve, the lane-change
T=16 ``solve_horizon_sharded`` and its gradient; 4 ranks run a dp=2 ×
horizon=2 ``solve_batch_horizon_sharded``, ``solve_batch_sharded`` and the
T=64 lane change on a horizon of 4 ranks. Each world size is spawned once,
in a module-scoped fixture."""

import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcp_tpu import solve as jax_solve
from mcp_tpu.bench import lane_change as jlc
from mcp_tpu.bench.harness import true_kkt_errors as jax_true_kkt
from mcp_tpu.parallel.horizon import (
    horizon_sharded_solve_fn as jax_solve_fn,
    horizon_sharded_tridiag_solve as jax_tridiag,
    make_dp_horizon_mesh as jax_dp_mesh,
    make_horizon_mesh as jax_horizon_mesh,
    solve_batch_horizon_sharded as jax_batch_horizon,
    solve_horizon_sharded as jax_solve_horizon,
)
from mcp_tpu.parallel.mesh import make_batch_mesh as jax_batch_mesh
from mcp_tpu.parallel.mesh import solve_batch_sharded as jax_batch_sharded
from mcp_tpu.solver import SolverOptions as JaxOptions
from mcp_tpu.solver import default_initialization as jax_init
from mcp_tpu.trajectories.strategies import cold_start_primal
from mcp_tpu_torch import SOLVED, SolverOptions
from mcp_tpu_torch.bench import horizon as worker
from mcp_tpu_torch.bench import lane_change as tlc
from mcp_tpu_torch.parallel import horizon as H
from mcp_tpu_torch.parallel.mesh import Mesh

torch.set_num_threads(1)

SOLVE = dict(linear_solver="tridiag", tol=1e-4)
GRAD = dict(linear_solver="tridiag", sensitivity_solver="tridiag", tol=1e-6)
#: The T=64 solve against the JAX package's, relative to max|x| (~161). At
#: T=64 and tol 1e-4 the returned x is fixed by rounding only to ~3e-4 of
#: max|x|: a 1-ulp perturbation of θ moves the port's 4-slab SPIKE solution
#: by 0.017–0.048 (one draw in three then fails to converge), and the JAX
#: package's own SPIKE on 4 devices and its "tridiag_cr" differ by 0.018.
T64_X_REL = 5e-4


def _system(T, b, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((T, b, b)) + 6 * np.eye(b),
            0.5 * rng.standard_normal((T - 1, b, b)),
            0.5 * rng.standard_normal((T - 1, b, b)),
            rng.standard_normal((T, b)))


def _jax_tridiag(arrs, D):
    return np.asarray(jax_tridiag(*(jnp.asarray(a) for a in arrs),
                                  mesh=jax_horizon_mesh(jax.devices()[:D])))


@pytest.mark.parametrize("T,b", [(16, 4), (32, 12)])
@pytest.mark.parametrize("D", [2, 4])
def test_spike_stages_match_jax(D, T, b):
    """The three stages for every slab in one process, against the JAX
    package's SPIKE on D virtual devices (and so the plain block-Thomas)."""
    arrs = _system(T, b, seed=T + b)
    diag, lower, upper, rhs = (torch.from_numpy(a)[None] for a in arrs)
    Xs = [H.spike_local_solve(*H._slab(diag, lower, upper, rhs, d, D)) for d in range(D)]
    w = H.spike_reduced_solve(torch.stack([X[:, [0, -1]] for X in Xs]))
    x = torch.cat([H.spike_back_substitute(X, w, d) for d, X in enumerate(Xs)], dim=1)
    np.testing.assert_allclose(x[0].numpy(), _jax_tridiag(arrs, D), rtol=0, atol=1e-10)
    torch.testing.assert_close(H.spike_solve(diag, lower, upper, rhs, num_slabs=D), x,
                               rtol=0, atol=0)


def _cpu_mesh(D):
    """A one-axis mesh object for the validation paths, which raise before
    any collective."""
    return Mesh(("horizon",), (D,), (None,), (0,), torch.device("cpu"))


def test_rejects_bad_horizon_and_tier():
    arrs = [torch.from_numpy(a) for a in _system(12, 4, 0)]
    with pytest.raises(ValueError, match="multiple of the mesh size"):
        H.horizon_sharded_tridiag_solve(*arrs, mesh=_cpu_mesh(8))
    mcp = tlc.generate_test_problem(horizon=16, device="cpu").parametric_game.mcp
    theta = torch.zeros(mcp.parameter_dimension, dtype=torch.float64)
    with pytest.raises(ValueError, match="tridiag-family"):
        H.solve_horizon_sharded(mcp, theta, mesh=_cpu_mesh(2),
                                options=SolverOptions(linear_solver="schur"))
    with pytest.raises(ValueError, match="multiple of the mesh size"):
        H.solve_horizon_sharded(mcp, theta, mesh=_cpu_mesh(3), options=SolverOptions(**SOLVE))


@functools.lru_cache(maxsize=None)
def _lane_change_thetas():
    jb = jlc.generate_test_problem(horizon=16)
    draw = lambda k: np.array(jlc.generate_random_parameter(
        jax.random.PRNGKey(k), jb, dtype=jnp.float64))
    return jb.parametric_game.mcp, {"solve": draw(0), "grad": draw(2),
                                    "batch": np.stack([draw(7 + i) for i in range(4)])}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    _, th = _lane_change_thetas()
    tasks = [
        dict(kind="tridiag", name="tridiag",
             **dict(zip(("diag", "lower", "upper", "rhs"), _system(16, 4, 3)))),
        dict(kind="solve", name="solve", theta=th["solve"], options=SOLVE, horizon=16),
        dict(kind="grad", name="grad", thetas=th["grad"][None], options=GRAD, horizon=16),
    ]
    return worker.spawn(2, tasks, tmp_path_factory.mktemp("ranks2"), device="cpu",
                        timeout_s=300)


@functools.lru_cache(maxsize=None)
def _t64():
    """The T=64 lane change on a 300 m road, warm-started from the
    zero-input rollout (as the JAX package's T=64 test)."""
    jb = jlc.generate_test_problem(horizon=64, height=300.0)
    theta = jlc.generate_random_parameter(jax.random.PRNGKey(2), jb, height=300.0,
                                          dtype=jnp.float64)
    x0 = cold_start_primal(jb.game, jb.parametric_game, 64,
                           jnp.concatenate([theta[0:4], theta[5:9]]))
    return jb.parametric_game.mcp, np.array(theta), np.array(x0)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    _, th = _lane_change_thetas()
    _, th64, x64 = _t64()
    tasks = [
        dict(kind="batch", name="batch", thetas=th["batch"], options=SOLVE, horizon=16,
             dp=2, hz=2),
        dict(kind="batch_sharded", name="batch_sharded", thetas=th["batch"], options=SOLVE,
             horizon=16),
        dict(kind="solve", name="t64", theta=th64, x0=x64, options=SOLVE, horizon=64,
             height=300.0),
    ]
    return worker.spawn(4, tasks, tmp_path_factory.mktemp("ranks4"), device="cpu",
                        timeout_s=600)


def _same_on_every_rank(ranks, name):
    for r in ranks[1:]:
        for k, v in ranks[0][name].items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(r[name][k], v)
    return ranks[0][name]


def test_sharded_tridiag_solve_on_two_ranks(two_ranks):
    got = _same_on_every_rank(two_ranks, "tridiag")["x"]
    np.testing.assert_allclose(got, _jax_tridiag(_system(16, 4, 3), 2), rtol=0, atol=1e-10)


def test_lane_change_on_two_ranks_matches_jax(two_ranks):
    jm, th = _lane_change_thetas()
    got = _same_on_every_rank(two_ranks, "solve")
    want = jax.tree.map(np.asarray, jax_solve_horizon(
        jm, jnp.asarray(th["solve"]), mesh=jax_horizon_mesh(jax.devices()[:2]),
        options=JaxOptions(**SOLVE)))
    assert int(got["status"]) == int(want.status) == SOLVED
    assert int(got["outer_iters"]) == int(want.outer_iters)
    # 1e-8: float64 iterates of the same algorithm, differing by rounding.
    np.testing.assert_allclose(got["x"], want.x, rtol=0, atol=1e-8)
    assert got["launches"]["multi"] == 0  # the CPU runs the plain LU slab


def test_gradient_on_two_ranks_matches_jax(two_ranks):
    jm, th = _lane_change_thetas()
    got = _same_on_every_rank(two_ranks, "grad")
    theta = jnp.asarray(th["grad"])
    fn = jax_solve_fn(jm, mesh=jax_horizon_mesh(jax.devices()[:2]), options=JaxOptions(**GRAD))
    x0, y0, s0 = jax_init(jm, theta)
    want = np.asarray(jax.grad(lambda t: jnp.sum(fn(t, x0, y0, s0).x ** 2))(theta))
    assert int(got["status"][0]) == SOLVED
    # rtol 1e-6: two float64 IFT solves at solutions equal to ~1e-9.
    np.testing.assert_allclose(got["grad"][0], want, rtol=1e-6, atol=1e-8)


def test_dp_horizon_batch_on_four_ranks_matches_jax(four_ranks):
    jm, th = _lane_change_thetas()
    got = _same_on_every_rank(four_ranks, "batch")
    want = jax.tree.map(np.asarray, jax_batch_horizon(
        jm, jnp.asarray(th["batch"]), mesh=jax_dp_mesh(2, 2, jax.devices()[:4]),
        options=JaxOptions(**SOLVE)))
    np.testing.assert_array_equal(got["status"], want.status)
    assert (want.status == SOLVED).all()
    np.testing.assert_array_equal(got["outer_iters"], want.outer_iters)
    np.testing.assert_allclose(got["x"], want.x, rtol=0, atol=1e-8)


def test_batch_sharded_on_four_ranks_matches_jax(four_ranks):
    jm, th = _lane_change_thetas()
    got = _same_on_every_rank(four_ranks, "batch_sharded")
    want, n_ok = jax_batch_sharded(jm, jnp.asarray(th["batch"]),
                                   mesh=jax_batch_mesh(jax.devices()[:4]),
                                   options=JaxOptions(**SOLVE))
    np.testing.assert_array_equal(got["status"], np.asarray(want.status))
    np.testing.assert_array_equal(got["outer_iters"], np.asarray(want.outer_iters))
    np.testing.assert_allclose(got["x"], np.asarray(want.x), rtol=0, atol=1e-8)
    assert got["num_solved"] == int(n_ok) == int((np.asarray(want.status) == SOLVED).sum())


def test_lane_change_t64_on_four_ranks_matches_jax(four_ranks):
    """The T=64 lane change on a horizon of 4 ranks (LU slabs) against the
    JAX package's SPIKE on 4 virtual devices and, independently, its
    single-device LU cyclic reduction ("tridiag_cr"): SOLVED in the same
    outer iterations, x to T64_X_REL of max|x|, and a true residual (the
    JAX package's, at the port's iterate) no larger than at theirs. (At
    this θ SOLVED does not bound the true residual by tol: the solver exits
    on its stale pre-step residual, and the JAX package's two solutions
    read 2.9e-4 and 3.7e-4.)"""
    jm, theta, x0 = _t64()
    got = _same_on_every_rank(four_ranks, "t64")
    th, x0 = jnp.asarray(theta), jnp.asarray(x0)
    spike = jax_solve_horizon(jm, th, x0=x0, mesh=jax_horizon_mesh(jax.devices()[:4]),
                              options=JaxOptions(**SOLVE))
    cr = jax_solve(jm, th, x0=x0, options=JaxOptions(**dict(SOLVE, linear_solver="tridiag_cr")))
    assert int(got["status"]) == SOLVED
    for want in (spike, cr):
        assert int(want.status) == SOLVED
        assert int(got["outer_iters"]) == int(want.outer_iters)
        want_x = np.asarray(want.x)
        np.testing.assert_allclose(got["x"], want_x, rtol=0,
                                   atol=T64_X_REL * np.abs(want_x).max())
    def true_kkt(it):
        it = SimpleNamespace(**{k: jnp.asarray(it[k])[None] for k in ("x", "y", "s")})
        return float(jax_true_kkt(jm, it, th[None])[0])

    assert true_kkt(got) <= max(true_kkt(w._asdict()) for w in (spike, cr))
