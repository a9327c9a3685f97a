"""The port's double-word arithmetic (``mcp_tpu_torch/utils/twofloat.py``)
and the compensated-float32 tol-1e-6 QP protocol (``bench/qp_dw.py``):
the error-free transformations exact against float64, the compensated sums
and matvecs within n·u²·Σ|·| of the exact value and of the JAX package's,
and the double-word polish certifying every lane of the JAX test's setup."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcp_tpu.bench import qp as jqp
from mcp_tpu.bench import qp_dw as jqp_dw
from mcp_tpu.parallel.batch import solve_batch as jax_solve_batch
from mcp_tpu.solver import SolverOptions as JaxOptions
from mcp_tpu.utils import twofloat as jtf
from mcp_tpu_torch.bench import qp as tqp
from mcp_tpu_torch.bench import qp_dw
from mcp_tpu_torch.utils import twofloat as tf

torch.set_num_threads(1)

U = 2.0**-24  # unit roundoff of float32


def _f32(rng, shape, spread=3):
    """Standard normals scaled by 10^[−spread, spread], as float32."""
    scale = 10.0 ** rng.uniform(-spread, spread, size=shape)
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _np64(*ts):
    return [np.asarray(t, dtype=np.float64) for t in ts]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_two_sum_is_exact(seed):
    rng = np.random.default_rng(seed)
    a, b = _f32(rng, 512, spread=6), _f32(rng, 512, spread=6)
    s, e = tf.two_sum(torch.from_numpy(a), torch.from_numpy(b))
    s64, e64 = _np64(s, e)
    # s + e = a + b as reals: both float64 sums are the same correctly
    # rounded value.
    np.testing.assert_array_equal(s64 + e64, a.astype(np.float64) + b.astype(np.float64))
    assert s.dtype == torch.float32


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_two_prod_is_exact(seed):
    rng = np.random.default_rng(seed)
    a, b = _f32(rng, 512), _f32(rng, 512)
    p, e = tf.two_prod(torch.from_numpy(a), torch.from_numpy(b))
    p64, e64 = _np64(p, e)
    # A product of two float32 values is exact in float64.
    np.testing.assert_array_equal(p64 + e64, a.astype(np.float64) * b.astype(np.float64))


def test_fast_two_sum_and_split_are_exact():
    rng = np.random.default_rng(3)
    a = _f32(rng, 256)
    b = (a * rng.uniform(-1, 1, 256).astype(np.float32)).astype(np.float32)  # |b| ≤ |a|
    s, e = tf.fast_two_sum(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(sum(_np64(s, e)), a.astype(np.float64) + b.astype(np.float64))
    hi, lo = tf.split(torch.from_numpy(a))
    np.testing.assert_array_equal(sum(_np64(hi, lo)), a.astype(np.float64))


def _exact_rows(x: np.ndarray) -> np.ndarray:
    """Σ along the last axis of float32 values, correctly rounded to float64."""
    flat = x.reshape(-1, x.shape[-1]).astype(np.float64)
    return np.array([math.fsum(r) for r in flat]).reshape(x.shape[:-1])


# (shape, chunk): a padded last chunk, an exact multiple, a short row.
SUM_CASES = [((3, 8, 200), 16), ((2, 5, 64), 16), ((4, 7), 16), ((2, 3, 100), 8)]


@functools.lru_cache(maxsize=None)
def _sum_case(i):
    shape, chunk = SUM_CASES[i]
    x = _f32(np.random.default_rng(10 + i), shape)
    s, e = tf.sum2(torch.from_numpy(x), chunk=chunk)
    js, je = jax.jit(functools.partial(jtf.sum2, chunk=chunk))(jnp.asarray(x))
    bound = shape[-1] * U * U * np.abs(x.astype(np.float64)).sum(-1)
    return x, sum(_np64(s, e)), sum(_np64(js, je)), bound


@pytest.mark.parametrize("i", range(len(SUM_CASES)))
def test_sum2_within_doubled_precision(i):
    x, got, _, bound = _sum_case(i)
    assert np.all(np.abs(got - _exact_rows(x)) <= bound)


@pytest.mark.parametrize("i", range(len(SUM_CASES)))
def test_sum2_agrees_with_jax(i):
    _, got, want, bound = _sum_case(i)
    assert np.all(np.abs(got - want) <= bound)


@pytest.mark.parametrize("axis", [0, 1, -2])
def test_sum2_along_other_axes(axis):
    x = _f32(np.random.default_rng(20), (40, 33, 3))
    s, e = tf.sum2(torch.from_numpy(x), axis=axis)
    moved = np.moveaxis(x, axis, -1)
    bound = moved.shape[-1] * U * U * np.abs(moved.astype(np.float64)).sum(-1)
    assert np.all(np.abs(sum(_np64(s, e)) - _exact_rows(moved)) <= bound)


MV_SHAPES = [(4, 200, 200), (3, 100, 37), (50, 20)]


@functools.lru_cache(maxsize=None)
def _mv_case(i):
    shape = MV_SHAPES[i]
    rng = np.random.default_rng(30 + i)
    A, v = _f32(rng, shape), _f32(rng, shape[:-2] + shape[-1:])
    hi, lo = tf.mv2(torch.from_numpy(A), torch.from_numpy(v))
    jhi, jlo = jax.jit(jtf.mv2)(jnp.asarray(A), jnp.asarray(v))
    prods = A.astype(np.float64) * v.astype(np.float64)[..., None, :]  # exact
    exact = np.array([math.fsum(r) for r in prods.reshape(-1, shape[-1])]).reshape(
        prods.shape[:-1])
    bound = shape[-1] * U * U * np.abs(prods).sum(-1)
    return sum(_np64(hi, lo)), sum(_np64(jhi, jlo)), exact, bound


@pytest.mark.parametrize("i", range(len(MV_SHAPES)))
def test_mv2_within_doubled_precision(i):
    got, _, exact, bound = _mv_case(i)
    assert np.all(np.abs(got - exact) <= bound)


@pytest.mark.parametrize("i", range(len(MV_SHAPES)))
def test_mv2_agrees_with_jax(i):
    got, want, _, bound = _mv_case(i)
    assert np.all(np.abs(got - want) <= bound)


def test_dw_residual_beats_the_float32_floor():
    """The residual of a near-exact solution (catastrophic cancellation):
    the double-word evaluation recovers the true tiny residual that a
    float32 evaluation buries under u·‖A‖‖x‖ (tests/test_twofloat.py)."""
    rng = np.random.default_rng(3)
    n = 200
    A = rng.normal(size=(n, n)).astype(np.float32) + 3 * np.eye(n, dtype=np.float32)
    b32 = (A.astype(np.float64) @ rng.normal(size=n)).astype(np.float32)
    x = np.linalg.solve(A.astype(np.float64), b32.astype(np.float64))
    xhi = x.astype(np.float32)
    xlo = (x - xhi).astype(np.float32)
    hi, lo = tf.dw_sub(tf.dw(torch.from_numpy(b32)),
                       tf.dw_mv(torch.from_numpy(A), (torch.from_numpy(xhi),
                                                      torch.from_numpy(xlo))))
    r_true = b32.astype(np.float64) - A.astype(np.float64) @ x
    assert np.max(np.abs(sum(_np64(hi, lo)) - r_true)) < 1e-10
    r_f32 = (b32 - A @ (xhi + xlo)).astype(np.float64)
    assert np.max(np.abs(r_f32 - r_true)) > 1e-7  # the floor is real


def test_dw_mul_and_add_within_doubled_precision():
    rng = np.random.default_rng(4)
    parts = [torch.from_numpy(_f32(rng, 256)) for _ in range(2)]
    a = tf.dw(parts[0], parts[0] * 2.0**-30)
    b = tf.dw(parts[1], parts[1] * 2.0**-30)
    av, bv = sum(_np64(*a)), sum(_np64(*b))
    mag = np.abs(av) + np.abs(bv)
    for got, exact, scale in ((tf.dw_add(a, b), av + bv, mag), (tf.dw_sub(a, b), av - bv, mag),
                              (tf.dw_mul(a, b), av * bv, np.abs(av * bv))):
        assert np.all(np.abs(sum(_np64(*got)) - exact) <= 8 * U * U * scale)


# -- the tol-1e-6 protocol on the JAX test's setup -------------------------

DW_B, DW_N = 4, 100


@functools.lru_cache(maxsize=None)
def _dw_setup():
    """tests/test_twofloat.py's setup: B=4, n=m=100, Mehrotra on
    "schur_pallas" at tol 1e-5 with polish (the JAX package's float32 solve,
    its Pallas kernels in interpret mode); the port refines those iterates
    (8 iterations at tol 1e-6) on the CPU."""
    thetas = jqp.generate_parameter_batch(jax.random.PRNGKey(0), DW_B)
    opts = JaxOptions(linear_solver="schur_pallas", algorithm="mehrotra", polish=True,
                      tol=1e-5, refinement_steps=0)
    res = jax_solve_batch(jqp.generate_test_problem().mcp, thetas, options=opts)
    assert bool(np.all(np.asarray(res.status) == 0))
    th, x, y, s = (torch.from_numpy(np.array(v)) for v in (thetas, res.x, res.y, res.s))
    st, tk = qp_dw.polish_batch_dw(th, x, y, s, n=DW_N, m=DW_N, tol=1e-6, iters=8)
    return thetas, th, st, tk


def _f64_kkt(theta, st, i):
    M, A, b, phi = (np.asarray(v, np.float64) for v in tqp.unpack_parameters(
        theta[i], num_primals=DW_N, num_inequalities=DW_N))
    x, y, s = (np.asarray(hi[i], np.float64) + np.asarray(lo[i], np.float64)
               for hi, lo in ((st.x_hi, st.x_lo), (st.y_hi, st.y_lo), (st.s_hi, st.s_lo)))
    return max(np.max(np.abs(M @ x - phi - A.T @ y)), np.max(np.abs(A @ x - b - s)),
               np.max(np.abs(s * y)))


@pytest.mark.parametrize("lane", range(DW_B))
def test_polish_batch_dw_certifies_1e6(lane):
    """Every lane's doubled-precision ‖F‖∞ ≤ 1e-6 and within 1e-9 of an
    independent float64 evaluation (the JAX test's tolerances)."""
    _, th, st, tk = _dw_setup()
    assert tk.dtype == torch.float32 and tk.shape == (DW_B,)
    f64kkt = _f64_kkt(th, st, lane)
    assert float(tk[lane]) <= 1e-6
    assert abs(f64kkt - float(tk[lane])) < 1e-9
    assert f64kkt <= 1.1e-6


def test_true_kkt_dw_agrees_with_jax():
    """The certification metric of the same double-word state in both
    packages (each within ~1e-12 of the exact residual)."""
    thetas, th, st, tk = _dw_setup()
    jst = jqp_dw.DWState(*(jnp.asarray(v.numpy()) for v in st))
    want = np.asarray(jax.vmap(functools.partial(jqp_dw.true_kkt_dw, n=DW_N, m=DW_N))(
        thetas, jst))
    np.testing.assert_allclose(tk.numpy(), want, rtol=0, atol=1e-9)
