"""K8b, the compact-WY blocked Householder-QR solve, in the PyTorch port
against the JAX package: the plain version against ``pallas_wy_solve`` in
interpret mode (n = 13 pads to a multiple of the panel), on saddle-point
systems, and the wrapper's checks; float64 on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcp_tpu.kernels import linear_solve as JL
from mcp_tpu_torch.kernels import linear_solve as L

torch.set_num_threads(1)


def _system(B, n, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, n, n)) + 0.3 * n * np.eye(n), rng.standard_normal((B, n))


@pytest.mark.parametrize("n", [8, 13, 24])
def test_plain_matches_the_jax_kernel(n):
    A, b = _system(3, n, n)
    want = np.asarray(JL.pallas_wy_solve(jnp.asarray(A), jnp.asarray(b), interpret=True))
    got = L.wy_solve(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("panel", [4, 16])
def test_other_panels_match_the_jax_kernel(panel):
    A, b = _system(2, 20, 3)
    want = np.asarray(JL.pallas_wy_solve(jnp.asarray(A), jnp.asarray(b), panel=panel,
                                         interpret=True))
    got = L.wy_solve(torch.from_numpy(A), torch.from_numpy(b), panel=panel).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


def test_saddle_systems_solve_as_the_unblocked_qr():
    """A zero diagonal block (the saddle-point shape of Newton systems): the
    blocked and unblocked reflections give the same x to rounding."""
    rng = np.random.default_rng(4)
    n, m = 10, 6
    H = rng.standard_normal((2, n, n))
    H = H @ H.transpose(0, 2, 1) + np.eye(n)
    C = rng.standard_normal((2, m, n))
    A = np.block([[H, C.transpose(0, 2, 1)], [C, np.zeros((2, m, m))]])
    b = rng.standard_normal((2, n + m))
    x = L.wy_solve(*(torch.from_numpy(a) for a in (A, b))).numpy()
    x_sep = L.qr_solve_sep_plain(*(torch.from_numpy(a) for a in (A, b))).numpy()
    np.testing.assert_allclose(x, x_sep, rtol=0, atol=1e-10 * np.abs(x_sep).max())
    np.testing.assert_allclose(x, np.linalg.solve(A, b[..., None])[..., 0], rtol=0,
                               atol=1e-10 * np.abs(x).max())


def test_wrapper_checks_and_counts_no_cpu_launch():
    A, b = (torch.from_numpy(a) for a in _system(2, 9, 5))
    before = L.wy_solve.launches
    L.wy_solve(A, b)
    assert L.wy_solve.launches == before
    with pytest.raises(ValueError, match="panel"):
        L.wy_solve(A, b, panel=17)
    with pytest.raises(ValueError, match="b must be"):
        L.wy_solve(A, b[:, :3])
    # A card block holds at most 232,448 bytes of shared memory: n = 104 in
    # float64 fits, n = 160 does not. K8a splits A over a cluster of up to 8
    # CTAs: n = 200 fits in both dtypes, n = 400 in float64 does not.
    assert L._wy_smem_bytes(104, 8, 8) < 232448 < L._wy_smem_bytes(160, 8, 8)
    assert L.qr_sep_plan(200, torch.float64).smem_per_cta < 232448
    with pytest.raises(ValueError, match="shared memory"):
        L.qr_sep_plan(400, torch.float64)
