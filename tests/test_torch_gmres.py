"""The gmres tier and the ``verbose`` option of the PyTorch port against the
JAX package, in float64 on the CPU, on the same numpy-seeded inputs.

GMRES: ``linalg.newton_step_gmres`` against ``mcp_tpu.linalg``'s under
vmap on random QP Schur systems (both preconditioners, restart below n and
at or above it), a right-hand side that is an eigenvector (the Arnoldi
breakdown), the knobs of the reference's QP oracle (tests/test_solver.py),
Mehrotra on it (tests/test_mehrotra.py), the annealed loop and a retry
round that runs on the gmres tier, and ``bench_cuda.py --tier gmres``.
Verbose: the lines each package prints on inner-step failures (a failed
linesearch, a non-finite direction) under "ip", "mehrotra" and "hybrid",
one per failed lane and step; the iterates equal to a quiet solve's."""

import collections
import contextlib
import functools
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcp_tpu import PrimalDualMCP as JaxMCP
from mcp_tpu import linalg as jlinalg
from mcp_tpu import solve as jax_solve
from mcp_tpu.bench import qp as jqp
from mcp_tpu.parallel.batch import solve_batch as jax_solve_batch
from mcp_tpu.solver import SolverOptions as JaxOptions
from mcp_tpu_torch import SOLVED, PrimalDualMCP, SolverOptions, solve, solve_batch
from mcp_tpu_torch import linalg
from mcp_tpu_torch.bench import qp
from mcp_tpu_torch.bench.main import main as bench_main

torch.set_num_threads(1)

B, N, M = 4, 12, 9
REG = 1e-4


def _schur_inputs(seed):
    """B convex-QP Newton systems (Gy = −Hxᵀ, Hy = 0) at an interior point."""
    rng = np.random.default_rng(seed)
    P = rng.standard_normal((B, N, N))
    Hx = rng.standard_normal((B, M, N))
    return (P @ P.transpose(0, 2, 1) + N * np.eye(N), -Hx.transpose(0, 2, 1), Hx,
            np.zeros((B, M, M)), rng.uniform(0.1, 2.0, (B, M)), rng.uniform(0.01, 2.0, (B, M)),
            rng.standard_normal((B, N)), rng.standard_normal((B, M)),
            rng.standard_normal((B, M)))


#: restart 50 ≥ n = 12 runs the full Krylov space; restart 5 restarts.
GMRES_CASES = {
    "none-restart-above-n": dict(),
    "jacobi-restart-above-n": dict(preconditioner="jacobi"),
    "none-restart-below-n": dict(restart=5, maxiter=3),
    "jacobi-restart-below-n": dict(restart=5, maxiter=2, preconditioner="jacobi"),
}


@pytest.mark.parametrize("case", GMRES_CASES)
def test_newton_step_gmres_matches_jax(case):
    kw = GMRES_CASES[case]
    arrs = _schur_inputs(seed=len(case))
    want = jax.vmap(lambda *a: jlinalg.newton_step_gmres(*a, REG, **kw))(*map(jnp.asarray, arrs))
    got = linalg.newton_step_gmres(*map(torch.from_numpy, arrs), REG, **kw)
    # 1e-10: the same iteration in float64, summed in another order
    # (measured ≤ 2e-13).
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-10)


@pytest.mark.parametrize("preconditioner", ["none", "jacobi"])
def test_gmres_stops_at_a_breakdown(preconditioner):
    """b is an eigenvector of lane 0's A: the first Arnoldi step finds the
    invariant subspace, that lane stops, and x = b/λ exactly; the other
    lanes (perturbed A) run on."""
    rng = np.random.default_rng(5)
    A = np.repeat(np.diag(np.arange(1.0, N + 1))[None], B, axis=0)
    A[1:] += 0.01 * rng.standard_normal((B - 1, N, N))
    b = np.zeros((B, N))
    b[:, 3] = 1.0
    kw = dict(tol=1e-8, restart=50, maxiter=5, preconditioner=preconditioner)
    want = jax.vmap(lambda a, v: jlinalg._gmres_inner(a, v, **kw))(jnp.asarray(A), jnp.asarray(b))
    got = linalg._gmres_inner(torch.from_numpy(A), torch.from_numpy(b), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)
    np.testing.assert_allclose(got[0].numpy(), b[0] / 4.0, rtol=0, atol=1e-15)


def test_factored_gmres_solves_as_the_direct_step():
    """Mehrotra's factored solver on "gmres" solves what the direct step
    solves (one GMRES per right-hand side)."""
    Gx, Gy, Hx, Hy, y, s, rG, rH, rC = map(torch.from_numpy, _schur_inputs(seed=11))
    kw = dict(tol=1e-9, restart=7, maxiter=3, preconditioner="jacobi")
    solve_f = linalg.factored_newton_solver("gmres")(Gx, Gy, Hx, Hy, y, s, REG, gmres_options=kw)
    got = solve_f(rG, rH, rC)
    want = linalg.newton_step_gmres(Gx, Gy, Hx, Hy, y, s, rG, rH, rC, REG, **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


# -- whole solves -------------------------------------------------------------

_QP_M = np.array([[2.0, 1.0], [1.0, 2.0]])
_QP_B = np.array([1.0, 1.0])
THETA = np.array([-0.5, 0.5])


@functools.lru_cache(maxsize=None)
def _oracle():
    """The reference's QP oracle (tests/test_solver.py) in both packages:
    min ½xᵀMx − θᵀx s.t. x ≥ b."""
    jm = JaxMCP.from_gh(lambda x, y, t: jnp.asarray(_QP_M) @ x - t - y,
                        lambda x, y, t: x - jnp.asarray(_QP_B),
                        unconstrained_dimension=2, constrained_dimension=2,
                        parameter_dimension=2)
    Mt, bt = torch.from_numpy(_QP_M), torch.from_numpy(_QP_B)
    tm = PrimalDualMCP.from_gh(lambda x, y, t: Mt @ x - t - y, lambda x, y, t: x - bt,
                               unconstrained_dimension=2, constrained_dimension=2,
                               parameter_dimension=2)
    return jm, tm


def _assert_same(got, want):
    assert int(got.status) == int(want.status)
    assert int(got.outer_iters) == int(want.outer_iters)
    # 1e-8: float64 iterates of the same algorithm, differing by rounding.
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0, atol=1e-8)


#: tests/test_solver.py::test_gmres_tier_with_knobs and
#: tests/test_mehrotra.py's gmres tier.
ORACLE_CASES = {
    "none": dict(linear_solver="gmres"),
    "jacobi": dict(linear_solver="gmres", gmres_preconditioner="jacobi"),
    "starved": dict(linear_solver="gmres", gmres_maxiter=1, gmres_restart=1, gmres_tol=1e-1,
                    max_outer_iters=60),
    "mehrotra": dict(linear_solver="gmres", algorithm="mehrotra", tol=1e-6),
}


@pytest.mark.parametrize("case", ORACLE_CASES)
def test_gmres_on_the_qp_oracle_matches_jax(case):
    jm, tm = _oracle()
    opts = ORACLE_CASES[case]
    want = jax_solve(jm, jnp.asarray(THETA), options=JaxOptions(**opts))
    got = solve(tm, torch.from_numpy(THETA), options=SolverOptions(**opts))
    _assert_same(got, want)
    assert int(got.status) == SOLVED
    np.testing.assert_allclose(got.x.numpy(), [1.0, 1.0], atol=1e-3)
    if case == "starved":
        exact = solve(tm, torch.from_numpy(THETA), linear_solver="condensed")
        assert int(got.outer_iters) >= int(exact.outer_iters)


@functools.lru_cache(maxsize=None)
def _qp():
    """The QP suite's MCP at n=8, m=6, dense, 4 draws (tests/test_torch_qp.py)."""
    jp = jqp.generate_test_problem(num_primals=8, num_inequalities=6)
    tp = qp.generate_test_problem(num_primals=8, num_inequalities=6, device="cpu")
    thetas = np.array(jqp.generate_parameter_batch(
        jax.random.PRNGKey(5), 4, num_primals=8, num_inequalities=6, sparsity_rate=0.0,
        dtype=jnp.float64))
    return jp.mcp, tp.mcp, thetas


#: "ip" on the gmres tier; and a retry round that runs: Mehrotra stopped at
#: 3 iterations fails every lane, and the annealed retry on "gmres"
#: rescues them.
QP_CASES = {
    "ip": dict(linear_solver="gmres", algorithm="ip", tol=1e-6),
    "retry": dict(linear_solver="schur", algorithm="mehrotra", max_outer_iters=3, retry=1,
                  retry_linear_solver="gmres", retry_max_outer_iters=30,
                  gmres_preconditioner="jacobi"),
}


@pytest.mark.parametrize("case", QP_CASES)
def test_gmres_on_the_qp_matches_jax(case):
    jm, tm, thetas = _qp()
    opts = QP_CASES[case]
    want = jax.tree.map(np.asarray, jax_solve_batch(jm, jnp.asarray(thetas),
                                                    options=JaxOptions(**opts)))
    got = solve_batch(tm, torch.from_numpy(thetas), options=SolverOptions(**opts))
    np.testing.assert_array_equal(got.status.numpy(), want.status)
    assert (want.status == SOLVED).all()
    np.testing.assert_array_equal(got.outer_iters.numpy(), want.outer_iters)
    np.testing.assert_allclose(got.x.numpy(), want.x, rtol=0, atol=1e-8)
    if case == "retry":
        assert (want.outer_iters > 3).all()  # every lane ran the retry round


def test_bench_cuda_runs_the_gmres_tier():
    """``bench_cuda.py --suite qp --tier gmres`` (float64, 2 lanes, one
    streamed batch): the JSON line of a certified run."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench_main(["--cpu", "--suite", "qp", "--tier", "gmres", "--x64", "--batch", "2",
                         "--stream", "1", "--spans", "1"])
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rc == 0 and line["device"] == "cpu" and line["batch_size"] == 2
    assert line["certified"] is True and line["success_rate"] == 1.0


# -- verbose ---------------------------------------------------------------------

#: Options whose solves fail inner steps: a backtracking grid that stops at
#: 0.81 fails linesearches; a NaN in θ gives non-finite directions.
VERBOSE_CASES = {
    "ip-linesearch": (dict(linear_solver="condensed", decay=0.9, min_stepsize=0.85,
                           max_outer_iters=6), False),
    "ip-nan": (dict(linear_solver="condensed", max_outer_iters=6), True),
    "mehrotra-nan": (dict(linear_solver="condensed", algorithm="mehrotra",
                          max_outer_iters=6), True),
    "hybrid-nan": (dict(linear_solver="condensed", algorithm="hybrid", max_outer_iters=4), True),
}


def _theta(lane, nan):
    th = _qp()[2][lane].copy()
    if nan:
        th[-1] = np.nan
    return th


@pytest.mark.parametrize("case", VERBOSE_CASES)
def test_verbose_prints_the_jax_lines(case, capfd):
    """One solve prints what the JAX package prints for it (its unbatched
    solve, where the debug print fires on failed steps only); a batch of two
    lanes prints each lane's lines (JAX's vmapped print fires on every lane
    of every step, failed or not, so the batch is held to the single
    solves)."""
    jm, tm, _ = _qp()
    opts, nan = VERBOSE_CASES[case]
    lanes = [_theta(0, nan), _theta(1, False)]
    want = []
    for th in lanes:
        jax.block_until_ready(jax_solve(jm, jnp.asarray(th),
                                        options=JaxOptions(**opts, verbose=True)).x)
        jax.effects_barrier()
        want.append(capfd.readouterr().out.splitlines())
    assert want[0], "the case must fail a step"
    solve(tm, torch.from_numpy(lanes[0]), options=SolverOptions(**opts, verbose=True))
    assert capfd.readouterr().out.splitlines() == want[0]
    solve_batch(tm, torch.from_numpy(np.stack(lanes)), options=SolverOptions(**opts, verbose=True))
    got = capfd.readouterr().out.splitlines()
    assert collections.Counter(got) == collections.Counter(want[0] + want[1])


def test_verbose_leaves_the_iterates_unchanged(capfd):
    _, tm, _ = _qp()
    opts, _ = VERBOSE_CASES["ip-linesearch"]
    th = torch.from_numpy(np.stack([_theta(0, False), _theta(1, False)]))
    quiet = solve_batch(tm, th, options=SolverOptions(**opts, fused_linesearch=False))
    loud = solve_batch(tm, th, options=SolverOptions(**opts, fused_linesearch=False,
                                                     verbose=True))
    assert capfd.readouterr().out
    for a, b in zip(loud, quiet):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_verbose_with_the_fused_linesearch_falls_back_with_a_warning(capfd):
    _, tm, _ = _qp()
    opts, _ = VERBOSE_CASES["ip-linesearch"]
    th = torch.from_numpy(_theta(0, False)[None])
    with pytest.warns(UserWarning, match="fused_linesearch=True is incompatible with "
                                         "verbose=True"):
        loud = solve_batch(tm, th, options=SolverOptions(**opts, fused_linesearch=True,
                                                         verbose=True))
    unfused = solve_batch(tm, th, options=SolverOptions(**opts, fused_linesearch=False))
    assert capfd.readouterr().out
    for a, b in zip(loud, unfused):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
