"""The differentiable solve of the PyTorch port (``mcp_tpu_torch/diff.py``,
the implicit function theorem) against the JAX package's ``mcp_tpu.diff``,
in float64 on the CPU, on the same numpy inputs: reverse-mode gradients
(``torch.autograd.grad`` vs the transpose of ``jax.linearize``) and
forward-mode tangents (``torch.func.jvp`` vs ``jax.linearize``) on each of
the three branches of the sensitivity solve:

* dense LU: the README QP (default ``sensitivity_solver="lu"``);
* banded: the lane-change game at T=10, B=2 on Newton tier "tridiag" with
  ``sensitivity_solver="tridiag"``;
* condensed: the same game with ``sensitivity_solver="condensed"``, and
  with ``"tridiag"`` on a copy of its time structure without row order
  (``tridiag_solve_permuted``), solved on the "schur" tier;

plus ``solve_jacobian_theta`` and the ``compute_sensitivities=False`` error.
The masked-game banded IFT on tier "tridiag_pallas" is in
test_torch_diff_masked.py. Both packages solve at tol 1e-4 along the same
iterates, so their tangents differ by rounding only: 1e-9 of the largest
entry."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcp_tpu
from mcp_tpu import PrimalDualMCP as JaxMCP
from mcp_tpu.bench import lane_change as jlc
from mcp_tpu.diff import solve_jacobian_theta as jax_solve_jacobian_theta
from mcp_tpu.parallel.batch import solve_batch as jax_solve_batch
from mcp_tpu.solver import SolverOptions as JaxOptions
from mcp_tpu_torch import (
    PrimalDualMCP,
    SolverOptions,
    default_initialization,
    solve,
    solve_batch,
    solve_jacobian_theta,
)
from mcp_tpu_torch.bench import lane_change as tlc

torch.set_num_threads(1)

REL = 1e-9

M = np.array([[2.0, 1.0], [1.0, 2.0]])
A = np.eye(2)
b = np.array([1.0, 1.0])
THETAS = [np.array([-0.5, 0.5]), np.array([3.0, 0.2])]  # both rows active; one inactive


def _jax_qp(compute_sensitivities=True):
    Mj, Aj, bj = (jnp.asarray(a) for a in (M, A, b))
    return JaxMCP.from_gh(
        lambda x, y, t: Mj @ x - t - Aj.T @ y, lambda x, y, t: Aj @ x - bj,
        unconstrained_dimension=2, constrained_dimension=2, parameter_dimension=2,
        compute_sensitivities=compute_sensitivities,
    )


def _port_qp(compute_sensitivities=True):
    Mt, At, bt = (torch.from_numpy(a) for a in (M, A, b))
    return PrimalDualMCP.from_gh(
        lambda x, y, t: Mt @ x - t - At.T @ y, lambda x, y, t: At @ x - bt,
        unconstrained_dimension=2, constrained_dimension=2, parameter_dimension=2,
        compute_sensitivities=compute_sensitivities,
    )


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=REL * max(np.abs(want).max(), 1.0))


@pytest.mark.parametrize("k", range(len(THETAS)))
def test_qp_reverse_and_forward_match_jax(k):
    """Dense LU branch: the gradient of Σx² + Σy² and the tangent of the
    whole (x, y, s) along a fixed direction, single-instance ``solve``."""
    theta = THETAS[k]
    jm, tm = _jax_qp(), _port_qp()
    loss_j = lambda t: (lambda s: jnp.sum(s.x**2) + jnp.sum(s.y**2))(mcp_tpu.solve(jm, t))
    want_g = jax.grad(loss_j)(jnp.asarray(theta))
    th = torch.tensor(theta, requires_grad=True)
    sol = solve(tm, th)
    (got_g,) = torch.autograd.grad((sol.x**2).sum() + (sol.y**2).sum(), th)
    _close(got_g.numpy(), want_g)
    # Forward mode.
    tdot = np.array([0.3, -1.1])
    vec_j = lambda t: (lambda s: jnp.concatenate([s.x, s.y, s.s]))(mcp_tpu.solve(jm, t))
    _, want_t = jax.jvp(vec_j, (jnp.asarray(theta),), (jnp.asarray(tdot),))
    vec_t = lambda t: (lambda s: torch.cat([s.x, s.y, s.s]))(solve(tm, t))
    _, got_t = torch.func.jvp(vec_t, (torch.tensor(theta),), (torch.tensor(tdot),))
    _close(got_t.numpy(), want_t)
    # A batch of one through solve_batch gives the same gradient.
    th2 = torch.tensor(theta[None], requires_grad=True)
    res = solve_batch(tm, th2)
    (g2,) = torch.autograd.grad((res.x**2).sum() + (res.y**2).sum(), th2)
    _close(g2[0].numpy(), want_g)


@pytest.mark.parametrize("method", ["lu", "lstsq"])
def test_solve_jacobian_theta_matches_jax(method):
    jm, tm = _jax_qp(), _port_qp()
    for theta in THETAS:
        jsol = mcp_tpu.solve(jm, jnp.asarray(theta))
        want = jax_solve_jacobian_theta(jm, jsol, jnp.asarray(theta), method=method)
        tsol = solve(tm, torch.tensor(theta))
        got = solve_jacobian_theta(tm, tsol, torch.tensor(theta), method=method)
        assert got.shape == (6, 2)
        _close(got.numpy(), want)
        # Batched: (B, n+2m, p).
        bsol = solve_batch(tm, torch.tensor(theta[None]))
        _close(solve_jacobian_theta(tm, bsol, torch.tensor(theta[None]), method=method)[0]
               .numpy(), want)


def test_missing_sensitivities_raise():
    """compute_sensitivities=False: a solve runs, differentiating it raises
    the JAX package's ValueError, in both modes."""
    tm = _port_qp(compute_sensitivities=False)
    theta = torch.tensor(THETAS[0], requires_grad=True)
    assert int(solve(tm, theta.detach()).status) == 0
    with pytest.raises(ValueError, match="compute_sensitivities=True"):
        torch.autograd.grad(solve(tm, theta).x.sum(), theta)
    with pytest.raises(ValueError, match="compute_sensitivities=True"):
        torch.func.jvp(lambda t: solve(tm, t).x, (theta.detach(),), (torch.ones(2, dtype=torch.float64),))
    with pytest.raises(ValueError, match="compute_sensitivities=True"):
        solve_jacobian_theta(tm, solve(tm, theta.detach()), theta.detach())
    with pytest.raises(ValueError, match="compute_sensitivities"):
        jax.grad(lambda t: jnp.sum(mcp_tpu.solve(_jax_qp(False), t).x))(jnp.asarray(THETAS[0]))


def test_default_initialization_follows_theta():
    tm = _port_qp()
    x0, y0, s0 = default_initialization(tm, torch.zeros(2, dtype=torch.float32))
    assert x0.shape == (2,) and x0.dtype == torch.float32 and bool((y0 == 1).all())
    x0, y0, s0 = default_initialization(tm, torch.zeros(3, 2), x0=torch.ones(3, 2),
                                        dtype=torch.float64)
    assert x0.shape == (3, 2) and x0.dtype == torch.float64 and bool((x0 == 1).all())
    assert s0.shape == (3, 2)


# -- the lane-change game: banded and condensed branches --------------------


@functools.lru_cache(maxsize=None)
def _lane_change():
    jb = jlc.generate_test_problem(horizon=10)
    tb = tlc.generate_test_problem(horizon=10, device="cpu")
    thetas = np.array(jlc.generate_parameter_batch(jax.random.PRNGKey(1), 2, jb,
                                                   dtype=jnp.float64))
    jm, tm = jb.parametric_game.mcp, tb.parametric_game.mcp
    rng = np.random.default_rng(0)
    n, m = tm.unconstrained_dimension, tm.constrained_dimension
    probe = (rng.standard_normal(thetas.shape), rng.standard_normal((2, n)),
             rng.standard_normal((2, m)))
    return jm, tm, thetas, probe


#: case → (Newton tier, sensitivity solver, drop the row time structure)
CASES = {
    "banded": ("tridiag", "tridiag", False),
    "condensed": ("tridiag", "condensed", False),
    "tridiag_permuted": ("schur", "tridiag", True),
}


@functools.lru_cache(maxsize=None)
def _lane_change_case(case):
    """(JAX forward tangent (x, y), JAX gradient, port tangent, port
    gradient) of the lane-change solution map at θ along the probe: the
    gradient of Σ cx·x + Σ cy·y."""
    jm, tm, thetas, (tdot, cx, cy) = _lane_change()
    tier, sens, drop_rows = CASES[case]
    if drop_rows:
        jm = dataclasses.replace(jm, time_structure=jm.time_structure._replace(
            row_permutation=None))
        tm = dataclasses.replace(tm, time_structure=tm.time_structure._replace(
            row_permutation=None))
    opts = dict(tol=1e-4, linear_solver=tier, sensitivity_solver=sens, polish=True,
                tightening_rate=0.02)
    f = lambda t: (lambda r: (r.x, r.y))(jax_solve_batch(jm, t, options=JaxOptions(**opts)))
    _, lin = jax.linearize(f, jnp.asarray(thetas))
    jax_tangent = [np.asarray(a) for a in lin(jnp.asarray(tdot))]
    (jax_grad,) = jax.linear_transpose(lin, jnp.asarray(thetas))(
        (jnp.asarray(cx), jnp.asarray(cy)))

    g = lambda t: (lambda r: (r.x, r.y))(solve_batch(tm, t, options=SolverOptions(**opts)))
    th = torch.from_numpy(thetas).requires_grad_()
    x, y = g(th)
    (port_grad,) = torch.autograd.grad((x * torch.from_numpy(cx)).sum()
                                       + (y * torch.from_numpy(cy)).sum(), th)
    _, port_tangent = torch.func.jvp(g, (torch.from_numpy(thetas),), (torch.from_numpy(tdot),))
    return jax_tangent, np.asarray(jax_grad), [t.numpy() for t in port_tangent], port_grad.numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_lane_change_reverse_matches_jax(case):
    _, jax_grad, _, port_grad = _lane_change_case(case)
    assert np.abs(jax_grad).max() > 1.0
    _close(port_grad, jax_grad)


@pytest.mark.parametrize("case", sorted(CASES))
def test_lane_change_forward_matches_jax(case):
    jax_tangent, _, port_tangent, _ = _lane_change_case(case)
    for got, want in zip(port_tangent, jax_tangent):
        _close(got, want)
