"""Full solves on the cyclic-reduction tiers with the Gauss–Jordan
factorizations that only this kernel takes, in the PyTorch port against the
JAX package, in float64 on the CPU (the JAX Pallas kernels in interpret
mode, the port's plain versions of K3): the lane change (B=2, T=10, b=20) on
"tridiag_pallas_crgj" (pivot-free), "tridiag_pallas_crgjbr" (blocked,
pivot-free, one refinement step) and "tridiag_pallas_crgjbpr" (blocked with
gjp's pivots, one refinement step)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcp_tpu.bench import lane_change as jlc
from mcp_tpu.parallel.batch import solve_batch as jax_solve_batch
from mcp_tpu.solver import SolverOptions as JaxOptions
from mcp_tpu_torch import SOLVED, SolverOptions, solve_batch
from mcp_tpu_torch.bench import lane_change as tlc
from mcp_tpu_torch.kernels import cyclic_reduction as C
from mcp_tpu_torch.kernels import thomas_dispatch as TD

torch.set_num_threads(1)

#: The headline options (bench.py) with the tier under test; these tiers run
#: the unfused linesearch in both packages (the fused one is the default of
#: "tridiag_pallas" and "tridiag_auto" only).
OPTIONS = dict(tol=1e-4, algorithm="ip", polish=True, retry=0, refinement_steps=1,
               tightening_rate=0.02)


@functools.lru_cache(maxsize=None)
def _lane_change():
    jb = jlc.generate_test_problem(horizon=10)
    tb = tlc.generate_test_problem(horizon=10, device="cpu")
    thetas = np.array(
        jlc.generate_parameter_batch(jax.random.PRNGKey(1), 2, jb, dtype=jnp.float64))
    return jb.parametric_game.mcp, tb.parametric_game.mcp, thetas


def _solve_both(tier):
    """The lane change (B=2, T=10, b=20) on ``tier`` in both packages:
    (port, JAX)."""
    jm, tm, thetas = _lane_change()
    want = jax_solve_batch(jm, jnp.asarray(thetas),
                           options=JaxOptions(linear_solver=tier, **OPTIONS))
    got = solve_batch(tm, torch.from_numpy(thetas),
                      options=SolverOptions(linear_solver=tier, **OPTIONS))
    return got, jax.tree.map(np.asarray, want)


def _counted(real, facts):
    """``real`` (a kernel wrapper, whose plain version runs on the CPU) that
    records the factorization of each call in ``facts``."""
    def solve(*args, fact="qr"):
        facts.append(fact)
        return real(*args, fact=fact)
    return solve


def _assert_same(got, want):
    """Status, outer iterations and x within 1e-7: float64 iterates of the
    same algorithm, differing by rounding only."""
    np.testing.assert_array_equal(got.status.numpy(), want.status)
    np.testing.assert_array_equal(got.outer_iters.numpy(), want.outer_iters)
    np.testing.assert_allclose(got.x.numpy(), want.x, rtol=0, atol=1e-7)


@pytest.mark.parametrize("tier", ["tridiag_pallas_crgj", "tridiag_pallas_crgjbr",
                                  "tridiag_pallas_crgjbpr"])
def test_lane_change_on_cr_tier_matches_jax(tier, monkeypatch):
    fact, facts = TD.PALLAS_TIERS[tier][1], []
    monkeypatch.setitem(TD.CR_SOLVERS, fact,
                        functools.partial(_counted(C.cr_thomas_solve, facts), fact=fact))
    got, want = _solve_both(tier)
    assert facts and set(facts) == {fact}
    assert (want.status == SOLVED).all()
    _assert_same(got, want)
