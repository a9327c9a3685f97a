"""K1 (block-Thomas sweep) of the PyTorch port held against the JAX package
on the same numpy inputs. The JAX Pallas kernel runs in interpret mode on
the CPU, as the JAX package's own tests run it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcp_tpu.kernels.block_tridiag import block_thomas_solve as jax_block_thomas
from mcp_tpu.kernels.thomas_pallas import pallas_block_thomas
from mcp_tpu_torch.kernels.block_tridiag import block_thomas_solve
from mcp_tpu_torch.kernels.thomas import thomas_solve, thomas_solve_plain

torch.set_num_threads(1)

SHAPES = [(4, 10, 20), (3, 1, 8), (5, 7, 5)]


def _bands(shape, dtype, seed):
    """Diagonally dominant random bands, as numpy."""
    B, T, b = shape
    rng = np.random.default_rng(seed)
    diag = rng.standard_normal((B, T, b, b)) + 6 * np.eye(b)
    lower = 0.3 * rng.standard_normal((B, max(T - 1, 0), b, b))
    upper = 0.3 * rng.standard_normal((B, max(T - 1, 0), b, b))
    rhs = rng.standard_normal((B, T, b))
    return tuple(a.astype(dtype) for a in (diag, lower, upper, rhs))


def _torch(arrs):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrs)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_lanes_kernel_f32(shape):
    # atol 1e-4: the JAX lane-major kernel test's own bound against the XLA
    # Thomas in float32 (tests/test_tridiag.py), for the same sweep.
    arrs = _bands(shape, np.float32, 40 + shape[2])
    want = np.asarray(pallas_block_thomas(*(jnp.asarray(a) for a in arrs), mode="lanes"))
    got = thomas_solve_plain(*_torch(arrs)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_thomas_f64(shape):
    # 1e-10: both are backward-stable solves of a well-conditioned
    # (diagonally dominant) system in float64; they differ by rounding only.
    arrs = _bands(shape, np.float64, 7 + shape[0])
    import jax

    want = np.asarray(jax.vmap(jax_block_thomas)(*(jnp.asarray(a) for a in arrs)))
    plain = thomas_solve_plain(*_torch(arrs)).numpy()
    lu = block_thomas_solve(*_torch(arrs)).numpy()
    np.testing.assert_allclose(plain, want, rtol=0, atol=1e-10)
    np.testing.assert_allclose(lu, want, rtol=0, atol=1e-10)


@pytest.mark.parametrize("shape", SHAPES)
def test_wrapper_on_cpu_is_the_plain_version(shape):
    arrs = _torch(_bands(shape, np.float64, 3))
    before = dict(thomas_solve.launches)
    torch.testing.assert_close(thomas_solve(*arrs), thomas_solve_plain(*arrs), rtol=0, atol=0)
    # Expanded (batch-stride 0) bands are accepted as the solver passes them.
    diag, lower, upper, rhs = arrs
    B = diag.shape[0]
    shared = thomas_solve(diag, lower[:1].expand(B, -1, -1, -1),
                          upper[:1].expand(B, -1, -1, -1), rhs)
    ref = thomas_solve_plain(diag, lower[:1].repeat(B, 1, 1, 1),
                             upper[:1].repeat(B, 1, 1, 1), rhs)
    torch.testing.assert_close(shared, ref, rtol=0, atol=0)
    assert thomas_solve.launches == before


def test_zero_pivot_gives_non_finite_in_both_packages():
    diag, lower, upper, rhs = _bands((2, 4, 6), np.float32, 11)
    diag = diag.copy()
    diag[1, 0] = 0.0  # system 1: a zero first block, hence a zero pivot
    want = np.asarray(pallas_block_thomas(*(jnp.asarray(a) for a in (diag, lower, upper, rhs)),
                                          mode="lanes"))
    got = thomas_solve(*_torch((diag, lower, upper, rhs))).numpy()
    assert not np.isfinite(want[1]).all()
    assert not np.isfinite(got[1]).all()
    # The other system is untouched by the failure.
    assert np.isfinite(got[0]).all() and np.isfinite(want[0]).all()
    np.testing.assert_allclose(got[0], want[0], atol=1e-4)


def test_rejects_wide_blocks_and_bad_shapes():
    diag, lower, upper, rhs = _torch(_bands((1, 2, 65), np.float32, 0))
    with pytest.raises(ValueError, match="b=64"):
        thomas_solve(diag, lower, upper, rhs)
    diag, lower, upper, rhs = _torch(_bands((2, 3, 4), np.float32, 0))
    with pytest.raises(ValueError, match="lower"):
        thomas_solve(diag, lower[:, :1], upper, rhs)
