"""The one-instance entry points of the PyTorch port against the JAX
package, and K8a, the single-system Householder-QR solve with a separate
right-hand side: the plain version against ``pallas_gauss_solve`` in
interpret mode, the one-instance ``solve`` of a small QP on tier
"schur_pallas" (the JAX package's unbatched ``gauss_solve``, i.e. K8a), and
``solve_game`` on the README's clamp game; float64 on the CPU."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcp_tpu
from mcp_tpu.bench import qp as jqp
from mcp_tpu.kernels import linear_solve as JL
from mcp_tpu.solver import SolverOptions as JaxOptions
import mcp_tpu_torch
from mcp_tpu_torch import SOLVED, SolverOptions, solve
from mcp_tpu_torch.bench import qp
from mcp_tpu_torch.kernels import linear_solve as L

torch.set_num_threads(1)


def _system(n, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((2, n, n)) + 0.3 * n * np.eye(n), rng.standard_normal((2, n))


@pytest.mark.parametrize("n", [5, 16, 37])
def test_plain_matches_the_jax_kernel(n):
    A, b = _system(n, n)
    want = np.asarray(JL.pallas_gauss_solve(jnp.asarray(A), jnp.asarray(b), interpret=True))
    got = L.pallas_gauss_solve(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


def test_zero_pivot_gives_non_finite_in_both_packages():
    A, b = _system(6, 1)
    A[1, 0, :] = 0.0
    A[1, :, 0] = 0.0
    want = np.asarray(JL.pallas_gauss_solve(jnp.asarray(A), jnp.asarray(b), interpret=True))
    got = L.pallas_gauss_solve(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    assert not np.isfinite(want[1]).all() and not np.isfinite(got[1]).all()
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-12 * np.abs(want[0]).max())


def test_gauss_solve_routes_one_system_to_k8a(monkeypatch):
    """``gauss_solve`` sends a batch of one system to K8a and larger batches
    to K4b/K4c (here their plain versions, by monkeypatched wrappers)."""
    calls = []
    monkeypatch.setattr(L, "qr_solve_sep_plain", lambda A, b: calls.append("K8a") or b)
    monkeypatch.setattr(L, "qr_solve_plain", lambda A, b: calls.append("K4b") or b)
    A, b = (torch.from_numpy(a) for a in _system(4, 2))
    L.gauss_solve(A[:1], b[:1])
    L.gauss_solve(A, b)
    assert calls == ["K8a", "K4b"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [100, 200])
def test_cluster_plan_covers_every_column_and_fits(n, dtype):
    """K8a's launch plan at the one-instance routes' orders (the QP's n=100,
    the lane change's n=200): a cluster of 1, 2, 4 or 8 CTAs of 256 threads
    per system, slabs of whole panels that cover every column exactly once,
    the last one the widest at most, and shared memory per CTA within
    232,448 bytes as ``csrc/qr_sep.cu`` lays it out."""
    plan = L.qr_sep_plan(n, dtype)
    assert plan.cluster in (1, 2, 4, 8) and plan.threads == 256
    assert plan.cluster == (8 if n == 200 else 4)
    assert len(plan.bounds) == plan.cluster + 1
    cover = [c for lo, hi in zip(plan.bounds, plan.bounds[1:]) for c in range(lo, hi)]
    assert cover == list(range(n))
    assert all(lo % L.QR_SEP_PANEL == 0 for lo in plan.bounds[:-1])
    wsmax = max(hi - lo for lo, hi in zip(plan.bounds, plan.bounds[1:]))
    itemsize = torch.empty((), dtype=dtype).element_size()
    assert plan.smem_per_cta == L._qr_sep_smem_bytes(n, wsmax, itemsize) <= 232448


def test_shared_memory_plan_accepts_n200_and_refuses_beyond_a_cluster():
    """n=200 in float64 (the one-instance lane change) fits in a cluster of
    8; n=400 in float64 does not, and the plan refuses it."""
    assert L.qr_sep_plan(200, torch.float64).smem_per_cta <= 232448
    with pytest.raises(ValueError, match="shared memory"):
        L.qr_sep_plan(400, torch.float64)


@functools.lru_cache(maxsize=None)
def _qp():
    N, M = 8, 6
    jp = jqp.generate_test_problem(num_primals=N, num_inequalities=M)
    tp = qp.generate_test_problem(num_primals=N, num_inequalities=M, device="cpu")
    theta = np.array(jqp.generate_parameter_batch(
        jax.random.PRNGKey(5), 1, num_primals=N, num_inequalities=M, sparsity_rate=0.0,
        dtype=jnp.float64))[0]
    return jp.mcp, tp.mcp, theta


@pytest.mark.parametrize("algorithm", ["ip", "mehrotra"])
def test_one_instance_solve_on_schur_pallas_matches_jax(algorithm):
    jm, tm, theta = _qp()
    opts = dict(tol=1e-6, linear_solver="schur_pallas", algorithm=algorithm)
    want = jax.tree.map(np.asarray, mcp_tpu.solve(jm, jnp.asarray(theta),
                                                  options=JaxOptions(**opts)))
    before = L.gauss_solve.launches
    got = solve(tm, torch.from_numpy(theta), options=SolverOptions(**opts))
    assert got.x.shape == want.x.shape and L.gauss_solve.launches == before
    assert int(got.status) == int(want.status) == SOLVED
    assert int(got.outer_iters) == int(want.outer_iters)
    # 1e-8: float64 iterates of the same algorithm, differing by rounding.
    np.testing.assert_allclose(got.x.numpy(), want.x, rtol=0, atol=1e-8)


def _clamp_games():
    def problems(cls, cat):
        return [
            cls(objective=lambda xs, ti, i=i: ((xs[i] - ti) ** 2).sum(),
                private_inequality=lambda xs, ti, i=i: cat([-xs[i] + 0.5, xs[i] + 0.5]))
            for i in range(2)
        ]

    jgame = mcp_tpu.ParametricGame.create(
        test_point=[jnp.ones(2), jnp.ones(2)], test_parameter=[jnp.ones(2), jnp.ones(2)],
        problems=problems(mcp_tpu.OptimizationProblem, jnp.concatenate))
    one = torch.ones(2, dtype=torch.float64)
    tgame = mcp_tpu_torch.ParametricGame.create(
        test_point=[one, one], test_parameter=[one, one],
        problems=problems(mcp_tpu_torch.OptimizationProblem, torch.cat))
    return jgame, tgame


@pytest.mark.parametrize("tier", [None, "schur", "schur_pallas"])
def test_solve_game_matches_jax(tier):
    jgame, tgame = _clamp_games()
    kw = {} if tier is None else {"linear_solver": tier}
    theta = [np.array([-1.0, 0.0]), np.array([1.0, 1.0])]
    want = mcp_tpu.solve_game(jgame, [jnp.asarray(t) for t in theta], **kw)
    got = mcp_tpu_torch.solve_game(tgame, [torch.from_numpy(t) for t in theta], **kw)
    assert isinstance(got, mcp_tpu_torch.GameSolveResult)
    assert mcp_tpu_torch.num_players(tgame) == 2
    assert int(got.status) == int(want.status) == SOLVED
    assert int(got.outer_iters) == int(want.outer_iters)
    for g, w in zip(got.primals, want.primals):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.primals[0].numpy(), [-0.5, 0.0], atol=1e-3)
    np.testing.assert_allclose(got.primals[1].numpy(), [0.5, 0.5], atol=1e-3)
    np.testing.assert_allclose(got.variables.y.numpy(), np.asarray(want.y), atol=1e-8)
