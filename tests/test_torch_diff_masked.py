"""The banded IFT of the PyTorch port on the masked N-player game (N=2,
horizon 20, batch 2; blocks of b=20, T=20) against the JAX package's, in
float64 on the CPU, on the same θ and cold start.

The port solves and differentiates on tier "tridiag_pallas", whose route at
this shape (B < 128, T ≥ 20, packed blocks) is the two-way sweep K7a: its
plain version ``babe_solve_plain`` runs in every Newton step and in the
IFT's A/Aᵀ solve. The JAX side runs tier "tridiag" (the plain LU
block-Thomas; its Pallas two-way sweep in interpret mode would compile for
minutes): every tier solves the same systems, so the two differ by rounding
only (1e-9 of the largest entry)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcp_tpu.bench.flagships import masked_game_setup as jax_setup
from mcp_tpu.parallel.batch import solve_batch as jax_solve_batch
from mcp_tpu.solver import SolverOptions as JaxOptions
from mcp_tpu_torch import SOLVED, SolverOptions, solve_batch
from mcp_tpu_torch.bench.flagships import masked_game_setup
from mcp_tpu_torch.kernels import thomas_babe

torch.set_num_threads(1)

B, N, H = 2, 2, 20
OPTS = dict(tol=1e-4, sensitivity_solver="tridiag", polish=True, tightening_rate=0.05)
REL = 1e-9


@functools.lru_cache(maxsize=None)
def _case():
    js = jax_setup(B, N, H)
    ts = masked_game_setup(B, N, H, device="cpu", dtype=torch.float64)
    thetas = np.asarray(js.thetas, dtype=np.float64)
    x0 = np.asarray(js.x0, dtype=np.float64)
    n, m = ts.mcp.unconstrained_dimension, ts.mcp.constrained_dimension
    rng = np.random.default_rng(0)
    tdot, cx, cy = (rng.standard_normal(thetas.shape), rng.standard_normal((B, n)),
                    rng.standard_normal((B, m)))

    f = lambda t: (lambda r: (r.x, r.y))(jax_solve_batch(
        js.mcp, t, x0=jnp.asarray(x0), options=JaxOptions(linear_solver="tridiag", **OPTS)))
    _, lin = jax.linearize(f, jnp.asarray(thetas))
    jax_tangent = [np.asarray(a) for a in lin(jnp.asarray(tdot))]
    (jax_grad,) = jax.linear_transpose(lin, jnp.asarray(thetas))(
        (jnp.asarray(cx), jnp.asarray(cy)))

    calls = []
    plain = thomas_babe.babe_solve_plain

    def counted(*args):
        calls.append(args[0].shape)
        return plain(*args)

    thomas_babe.babe_solve_plain = counted
    try:
        options = SolverOptions(linear_solver="tridiag_pallas", **OPTS)
        g = lambda t: solve_batch(ts.mcp, t, x0=torch.from_numpy(x0), options=options)
        th = torch.from_numpy(thetas).requires_grad_()
        res = g(th)
        in_solve = len(calls)
        (port_grad,) = torch.autograd.grad((res.x * torch.from_numpy(cx)).sum()
                                           + (res.y * torch.from_numpy(cy)).sum(), th)
        in_backward = len(calls) - in_solve
        _, port_tangent = torch.func.jvp(lambda t: (lambda r: (r.x, r.y))(g(t)),
                                         (torch.from_numpy(thetas),), (torch.from_numpy(tdot),))
    finally:
        thomas_babe.babe_solve_plain = plain
    return dict(jax_tangent=jax_tangent, jax_grad=np.asarray(jax_grad), res=res,
                port_grad=port_grad.numpy(), port_tangent=[t.numpy() for t in port_tangent],
                calls=calls, in_solve=in_solve, in_backward=in_backward)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=REL * max(np.abs(want).max(), 1.0))


def test_masked_game_reaches_the_two_way_sweep():
    """Every Newton step and the backward's Aᵀ solve ran K7a's plain
    version at (B, T, b) = (2, 20, 20); every lane solved."""
    c = _case()
    assert bool((c["res"].status == SOLVED).all())
    assert c["in_solve"] > 0 and c["in_backward"] == 1
    assert set(c["calls"]) == {(B, H, 20, 20)}


def test_masked_game_reverse_matches_jax():
    c = _case()
    assert np.abs(c["jax_grad"]).max() > 1.0
    _close(c["port_grad"], c["jax_grad"])


def test_masked_game_forward_matches_jax():
    c = _case()
    for got, want in zip(c["port_tangent"], c["jax_tangent"]):
        _close(got, want)
