"""K2 (fused linesearch + update) of the PyTorch port held against the JAX
package's ``make_linesearch_update`` under ``jax.vmap`` (its Pallas kernel
in interpret mode on the CPU), on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcp_tpu.kernels.linesearch_pallas import make_linesearch_update
from mcp_tpu.solver import fraction_to_the_boundary_linesearch as jax_ftb
from mcp_tpu.solver import linesearch_candidates as jax_candidates
from mcp_tpu_torch.kernels.linesearch import linesearch_update, linesearch_update_plain
from mcp_tpu_torch.solver import (
    fraction_to_the_boundary_linesearch,
    linesearch_candidates,
)

torch.set_num_threads(1)

TAU, DECAY, MINSTEP = 0.995, 0.5, 1e-4
CASES = ["feasible", "partly_feasible", "infeasible", "nan_direction"]


def _case(kind, dtype, B=16, n=37, m=23, seed=0):
    """Per-lane inputs (x, dx, s, ds, y, dy, rg, rh, rc) as numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, n))
    dx = rng.standard_normal((B, n))
    s = rng.uniform(0.01, 2.0, (B, m))
    y = rng.uniform(0.01, 2.0, (B, m))
    ds = 0.1 * rng.standard_normal((B, m))
    dy = 0.1 * rng.standard_normal((B, m))
    rg = rng.standard_normal((B, n))
    rh = rng.standard_normal((B, m))
    rc = rng.standard_normal((B, m))
    if kind == "partly_feasible":
        # Mid-grid steps: α ≈ τ/c needs several halvings; half the lanes.
        ds[::2] = -7.3 * s[::2]
        dy[::2] = -2.9 * y[::2]
    elif kind == "infeasible":
        # So steep that every candidate (incl. the sub-min_stepsize one)
        # violates the bound, on every other lane.
        ds[1::2] = -s[1::2] / (MINSTEP * DECAY * 0.5)
    elif kind == "nan_direction":
        dx[0, 0] = np.nan
        ds[5, 1] = np.inf
        dy[10, 2] = np.nan
    return tuple(a.astype(dtype) for a in (x, dx, s, ds, y, dy, rg, rh, rc))


def test_candidates_match():
    assert linesearch_candidates(DECAY, MINSTEP) == jax_candidates(DECAY, MINSTEP)
    assert len(linesearch_candidates(DECAY, MINSTEP)) == 15


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", CASES)
def test_plain_matches_jax_kernel(kind, dtype):
    arrs = _case(kind, dtype)
    op = make_linesearch_update(tau=TAU, decay=DECAY, min_stepsize=MINSTEP)
    want = [np.asarray(a) for a in jax.vmap(op)(*(jnp.asarray(a) for a in arrs))]
    cands = linesearch_candidates(DECAY, MINSTEP)
    got = [a.numpy() for a in linesearch_update_plain(
        *(torch.from_numpy(a) for a in arrs), tau=TAU, candidates=cands)]
    # Flags and kkt exactly: the same compares and max-reductions of the
    # same values.
    np.testing.assert_array_equal(got[4], want[4])
    np.testing.assert_array_equal(got[3], want[3])
    # Iterates: one multiply and one add per entry. 1e-12 in float64;
    # float32 allows a single rounding of a possibly fused multiply-add.
    tol = dict(rtol=0, atol=1e-12) if dtype == np.float64 else dict(rtol=1e-6, atol=1e-6)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g, w, **tol)
    if kind == "feasible":
        assert not got[4].any()
    elif kind in ("infeasible", "nan_direction"):
        assert got[4].any() and not got[4].all()
    if kind == "nan_direction":
        # A failed lane keeps its iterate; its kkt is still reported.
        failed = got[4]
        np.testing.assert_array_equal(got[0][failed], arrs[0][failed])
        assert np.isfinite(got[3]).all()


@pytest.mark.parametrize("kind", CASES)
def test_wrapper_on_cpu_is_the_plain_version(kind):
    arrs = [torch.from_numpy(a) for a in _case(kind, np.float64, seed=5)]
    cands = linesearch_candidates(DECAY, MINSTEP)
    before = linesearch_update.launches
    got = linesearch_update(*arrs, tau=TAU, candidates=cands)
    want = linesearch_update_plain(*arrs, tau=TAU, candidates=cands)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
    assert linesearch_update.launches == before


@pytest.mark.parametrize("kind", CASES)
def test_unfused_linesearch_matches_jax(kind):
    _, _, s, ds, y, dy, *_ = _case(kind, np.float64, seed=9)
    ds = np.where(np.isfinite(ds), ds, 0.0)
    got = fraction_to_the_boundary_linesearch(
        torch.from_numpy(s), torch.from_numpy(ds), tau=TAU, decay=DECAY,
        min_stepsize=MINSTEP,
    ).numpy()
    want = np.asarray(jax.vmap(
        lambda v, dv: jax_ftb(v, dv, tau=TAU, decay=DECAY, min_stepsize=MINSTEP)
    )(jnp.asarray(s), jnp.asarray(ds)))
    np.testing.assert_array_equal(got, want)
