"""K7a (the two-way block-Thomas sweep) of the PyTorch port against the JAX
package's ``pallas_block_thomas(..., mode="babe")`` in interpret mode, on
the same numpy inputs in float64 on the CPU, and the route of tier
"tridiag_pallas" at the shapes where it used to run another algorithm
(T ≥ 64: cyclic reduction; B < 128 and T ≥ 20: the two-way sweep)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcp_tpu.kernels import thomas_pallas as jtp
from mcp_tpu_torch.kernels import thomas_babe as K
from mcp_tpu_torch.kernels import thomas_dispatch as TD
from mcp_tpu_torch.kernels.cyclic_reduction import cr_solve_plain
from mcp_tpu_torch.kernels.thomas import thomas_solve_plain
from mcp_tpu_torch.solver import BANDED_SOLVERS

torch.set_num_threads(1)


def _bands(B, T, b, seed):
    """Random bands (K1's layout) with a +6I diagonal, as numpy."""
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((B, T, b, b)) + 6 * np.eye(b),
        0.3 * rng.standard_normal((B, T - 1, b, b)),
        0.3 * rng.standard_normal((B, T - 1, b, b)),
        rng.standard_normal((B, T, b)),
    )


def _t(arrs):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrs)


def _jax_babe(arrs):
    return np.asarray(jtp.pallas_block_thomas(*(jnp.asarray(a) for a in arrs), mode="babe",
                                              interpret=True))


@pytest.mark.parametrize("T", [2, 3, 20, 21])
@pytest.mark.parametrize("b", [3, 8])
def test_babe_plain_matches_jax(T, b):
    """Even and odd T (the JAX package's identity pad block), T = 2 and 3
    (no back substitution on one side), the flagship route's T ≥ 20. 1e-10
    of max|x|: the same eliminations in float64, summed in another order."""
    arrs = _bands(3, T, b, seed=10 * T + b)
    want = _jax_babe(arrs)
    got = K.babe_solve_plain(*_t(arrs)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * np.abs(want).max())
    # And it is the solve the one-way sweep computes.
    np.testing.assert_allclose(got, thomas_solve_plain(*_t(arrs)).numpy(), rtol=0,
                               atol=1e-10 * np.abs(want).max())


@pytest.mark.parametrize("T", [2, 5])
def test_babe_plain_shared_bands(T):
    """A band expanded over the batch (stride 0, the affine games) solves as
    the same band stored per system."""
    diag, lower, upper, rhs = _t(_bands(4, T, 6, seed=T))
    shared = K.babe_thomas_solve(diag, lower[:1].expand(4, -1, -1, -1),
                                 upper[:1].expand(4, -1, -1, -1), rhs)
    ref = K.babe_solve_plain(diag, lower[:1].repeat(4, 1, 1, 1), upper[:1].repeat(4, 1, 1, 1),
                             rhs)
    torch.testing.assert_close(shared, ref, rtol=0, atol=1e-14)


def test_babe_wrapper_on_cpu_is_the_plain_version_and_counts_no_launch():
    arrs = _t(_bands(2, 7, 5, seed=1))
    before = dict(K.babe_thomas_solve.launches)
    torch.testing.assert_close(K.babe_thomas_solve(*arrs), K.babe_solve_plain(*arrs),
                               rtol=0, atol=0)
    assert K.babe_thomas_solve.launches == before
    diag, lower, upper, rhs = _t(_bands(2, 1, 5, seed=2))
    with pytest.raises(ValueError, match="T >= 2"):
        K.babe_thomas_solve(diag, lower, upper, rhs)
    with pytest.raises(ValueError, match="contiguous"):
        d, lo, up, r = arrs
        K.babe_thomas_solve(d, lo.mT, up, r)


def test_shared_memory_plan():
    """Both directions' working sets in one block: the flagship's b=40 fits
    in float32 and float64, b=64 in float32; b=64 in float64 is refused."""
    for b, dtype in ((40, torch.float32), (40, torch.float64), (64, torch.float32)):
        K.check_fits(b, dtype)
    with pytest.raises(ValueError, match="shared memory"):
        K.check_fits(64, torch.float64)


def test_singular_block_fails_only_its_system():
    """A zero pivot gives inf/NaN in its system in both packages; the other
    systems are untouched and agree."""
    diag, lower, upper, rhs = _bands(3, 6, 4, seed=7)
    diag = diag.copy()
    diag[1, 0, :, 2] = 0.0  # the left chain starts on a singular block
    want = _jax_babe((diag, lower, upper, rhs))
    got = K.babe_solve_plain(*_t((diag, lower, upper, rhs))).numpy()
    bad = lambda x: [not np.isfinite(x[i]).all() for i in range(3)]
    assert bad(got) == bad(want) == [False, True, False]
    np.testing.assert_allclose(got[[0, 2]], want[[0, 2]], rtol=0, atol=1e-12)


def test_pallas_tier_runs_cr_at_t64():
    """T = 64: the JAX package's tier "tridiag_pallas" runs cyclic reduction
    with QR blocks (the sweep stalls the IP loop on long chains); the port's
    tier now gives K3-qr's plain version, not K1's one-way sweep."""
    arrs = _t(_bands(2, 64, 4, seed=64))
    got = BANDED_SOLVERS["tridiag_pallas"](*arrs)
    torch.testing.assert_close(got, cr_solve_plain(*arrs, "qr"), rtol=0, atol=0)
    assert not torch.equal(got, thomas_solve_plain(*arrs))


def test_pallas_tier_runs_the_two_way_sweep():
    """B < 128, T ≥ 20, packed blocks: the two-way sweep, as in the JAX
    package."""
    arrs = _t(_bands(8, 20, 20, seed=20))
    assert TD.kernel_mode(8, 20, 20, 8) == "babe"
    torch.testing.assert_close(BANDED_SOLVERS["tridiag_pallas"](*arrs),
                               K.babe_solve_plain(*arrs), rtol=0, atol=0)
