"""Mehrotra on the banded tiers: the hybrid algorithm (annealed warm-up, then
Mehrotra predictor-corrector with ``banded_jac_mv`` refinement) on the
masked N=4 game at horizon 6, tier "tridiag_auto" (K3 with pivoted
Gauss–Jordan on the CPU's plain version), held against the JAX package in
float64 on the same θ and cold start: refinement 0 (the N=4 flagship's
recipe) and refinement 1. A separate file from test_torch_masked.py so
that the two JAX builds and compiles run on separate test workers."""

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
from mcp_tpu_torch.bench.harness import true_kkt_errors

torch.set_num_threads(1)

OPTS = dict(tol=1e-4, polish=True, tightening_rate=0.02, linear_solver="tridiag_auto",
            algorithm="hybrid")


@functools.lru_cache(maxsize=None)
def _setup():
    js = jax_setup(2, 4, 6)
    ts = masked_game_setup(2, 4, 6, device="cpu", dtype=torch.float64)
    return js, ts, np.asarray(js.thetas, np.float64), np.asarray(js.x0, np.float64)


@pytest.mark.parametrize("refinement_steps", [0, 1])
def test_hybrid_matches_jax(refinement_steps):
    js, ts, thetas, x0 = _setup()
    opts = dict(OPTS, refinement_steps=refinement_steps)
    want = jax.tree.map(np.asarray, jax_solve_batch(
        js.mcp, jnp.asarray(thetas), x0=jnp.asarray(x0), options=JaxOptions(**opts)))
    got = solve_batch(ts.mcp, torch.from_numpy(thetas), x0=torch.from_numpy(x0),
                      options=SolverOptions(**opts))
    assert (want.status == SOLVED).all()
    np.testing.assert_array_equal(got.status.numpy(), want.status)
    np.testing.assert_array_equal(got.outer_iters.numpy(), want.outer_iters)
    np.testing.assert_allclose(got.x.numpy(), want.x, rtol=0, atol=1e-7)
    np.testing.assert_allclose(got.epsilon.numpy(), want.epsilon, rtol=1e-6, atol=1e-14)


def test_flagship_recipe_in_float32_certifies():
    """The card's working precision with the N=4 flagship's recipe (hybrid,
    refinement 0, polish): every lane SOLVED with a float32 true KKT within
    tol, and the same status as the float64 solve."""
    js, ts, thetas, x0 = _setup()
    opts = SolverOptions(**OPTS, refinement_steps=0)
    th = torch.from_numpy(thetas).float()
    res = solve_batch(ts.mcp, th, x0=torch.from_numpy(x0).float(), options=opts)
    assert res.x.dtype == torch.float32
    assert bool((res.status == SOLVED).all())
    assert bool((true_kkt_errors(ts.mcp, res, th) <= opts.tol).all())
