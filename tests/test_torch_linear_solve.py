"""K4a, K4b/K4c and K5 (the dense solves of the Schur-condensed Newton step)
and the dense Newton tiers of the PyTorch port, held against the JAX package
on the same numpy inputs. The JAX Pallas kernels run in interpret mode on
the CPU, as the JAX package's own tests run them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcp_tpu import linalg as jlinalg
from mcp_tpu.kernels.linear_solve import (
    pallas_gj_lanes_solve,
    pallas_gji_lanes_solve,
    pallas_qr_lanes_solve,
    pallas_qr_solve_fused,
)
from mcp_tpu_torch import linalg
from mcp_tpu_torch.kernels import linear_solve as L

torch.set_num_threads(1)


def _spd(B, n, dtype, seed):
    """P·Pᵀ + n·I and a standard normal right side, as numpy."""
    rng = np.random.default_rng(seed)
    P = rng.standard_normal((B, n, n))
    A = P @ P.transpose(0, 2, 1) + n * np.eye(n)
    return A.astype(dtype), rng.standard_normal((B, n)).astype(dtype)


def _random(B, n, dtype, seed):
    """Standard normal plus n·I (the JAX kernel tests' construction)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, n, n)) + n * np.eye(n)
    return A.astype(dtype), rng.standard_normal((B, n)).astype(dtype)


def _saddle(B, n, dtype, seed):
    """[[M, C], [Cᵀ, 1e-4·I]] with M SPD: the interior-point saddle system
    that breaks pivot-free elimination (tests/test_kernels.py:155-174)."""
    rng = np.random.default_rng(seed)
    h = n // 2
    P = rng.standard_normal((B, h, h))
    M = P @ P.transpose(0, 2, 1) + np.eye(h)
    C = rng.standard_normal((B, h, h))
    low = np.broadcast_to(1e-4 * np.eye(h), (B, h, h))
    A = np.concatenate([np.concatenate([M, C], 2), np.concatenate([C.transpose(0, 2, 1), low], 2)], 1)
    return A.astype(dtype), rng.standard_normal((B, n)).astype(dtype)


def _t(*arrs):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrs)


def _j(*arrs):
    return tuple(jnp.asarray(a) for a in arrs)


# Tolerances: float64, 1e-12 (the same algebra; XLA and PyTorch differ only
# in rounding order, on systems of condition ~10); float32, 1e-5 (the same
# rounding-order gap, at float32's epsilon).
TOL = {np.float64: 1e-12, np.float32: 1e-5}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", [(5, 10), (3, 8), (2, 1)])
def test_gj_plain_matches_jax_lanes_kernel(dtype, shape):
    A, b = _spd(*shape, dtype, 10 + shape[1])
    want = np.asarray(pallas_gj_lanes_solve(*_j(A, b)))
    got = L.gj_solve_plain(*_t(A, b)).numpy()
    assert got.dtype == dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", [(5, 10), (3, 8)])
def test_gji_plain_matches_jax_lanes_kernel(dtype, shape):
    A, b = _spd(*shape, dtype, 20 + shape[1])
    want_x, want_inv = (np.asarray(a) for a in pallas_gji_lanes_solve(*_j(A, b)))
    got_x, got_inv = (a.numpy() for a in L.gji_solve_plain(*_t(A, b)))
    np.testing.assert_allclose(got_x, want_x, rtol=0, atol=TOL[dtype])
    np.testing.assert_allclose(got_inv, want_inv, rtol=0, atol=TOL[dtype])
    np.testing.assert_allclose(
        got_inv, np.linalg.inv(A.astype(np.float64)), rtol=0, atol=100 * TOL[dtype]
    )


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", ["random", "spd", "saddle"])
def test_qr_plain_matches_jax_lanes_kernel_at_128(dtype, kind):
    """K4b: the JAX package's lane-major QR (its B ≥ 128 route)."""
    make = {"random": _random, "spd": _spd, "saddle": _saddle}[kind]
    A, b = make(128, 10, dtype, 30)
    want = np.asarray(pallas_qr_lanes_solve(*_j(A, b)))
    got = L.qr_solve_plain(*_t(A, b)).numpy()
    # The saddle systems have condition ~1e4: the rounding gap scales with it.
    scale = 1e3 if kind == "saddle" else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=scale * TOL[dtype] * np.abs(want).max())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", ["random", "saddle"])
def test_qr_plain_matches_jax_fused_kernel_at_5(dtype, kind):
    """K4c: the JAX package's fused augmented QR (B < 128 or float64)."""
    make = {"random": _random, "saddle": _saddle}[kind]
    A, b = make(5, 12, dtype, 40)
    want = np.asarray(pallas_qr_solve_fused(*_j(A, b)))
    got = L.qr_solve_plain(*_t(A, b)).numpy()
    scale = 1e3 if kind == "saddle" else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=scale * TOL[dtype] * np.abs(want).max())


def test_qr_is_stable_on_saddle_systems():
    """Householder QR needs no pivoting on the saddle systems (float64
    against LAPACK's pivoted LU)."""
    A, b = _saddle(4, 12, np.float64, 41)
    got = L.qr_solve_plain(*_t(A, b)).numpy()
    np.testing.assert_allclose(got, np.linalg.solve(A, b[..., None])[..., 0], rtol=0, atol=1e-8)


def _zero_pivot(dtype):
    A, b = _spd(3, 8, dtype, 50)
    A = A.copy()
    A[1, 0, :] = 0.0
    A[1, :, 0] = 0.0
    return A, b


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_gj_zero_pivot_gives_huge_finite_values_in_both_packages(dtype):
    A, b = _zero_pivot(dtype)
    want = np.asarray(pallas_gj_lanes_solve(*_j(A, b)))
    got = L.gj_solve(*_t(A, b)).numpy()
    got_x, _ = (a.numpy() for a in L.gji_solve(*_t(A, b)))
    for x in (want, got, got_x):
        assert np.isfinite(x).all()
        assert np.abs(x[1]).max() > 1e20  # 1/1e-30 times b
    np.testing.assert_allclose(got[[0, 2]], want[[0, 2]], rtol=0, atol=TOL[dtype])
    np.testing.assert_array_equal(got_x, got)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_qr_zero_pivot_gives_non_finite_in_both_packages(dtype):
    A, b = _zero_pivot(dtype)
    want = np.asarray(pallas_qr_solve_fused(*_j(A, b)))
    got = L.gauss_solve(*_t(A, b)).numpy()
    assert not np.isfinite(want[1]).all() and not np.isfinite(got[1]).all()
    assert np.isfinite(got[[0, 2]]).all()
    np.testing.assert_allclose(got[[0, 2]], want[[0, 2]], rtol=0, atol=TOL[dtype] * 10)


@pytest.mark.parametrize(
    "wrapper, plain",
    [(L.gj_solve, L.gj_solve_plain), (L.gji_solve, L.gji_solve_plain),
     (L.gauss_solve, L.qr_solve_plain)],
    ids=["gj", "gji", "qr"],
)
def test_wrapper_on_cpu_is_the_plain_version(wrapper, plain):
    A, b = _t(*_spd(4, 9, np.float64, 60))
    before = wrapper.launches
    got, want = wrapper(A, b), plain(A, b)
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert wrapper.launches == before


def test_wrappers_reject_bad_operands():
    A, b = _t(*_spd(2, 4, np.float64, 0))
    with pytest.raises(ValueError, match="b must be"):
        L.gj_solve(A, b[:, :3])
    with pytest.raises(ValueError, match="share dtype"):
        L.gauss_solve(A, b.float())
    with pytest.raises(ValueError, match="contiguous"):
        L.gji_solve(A.transpose(1, 2), b)
    with pytest.raises(ValueError, match="float32/float64"):
        L.gj_solve(A.half(), b.half())
    # A card block holds at most 232,448 bytes of shared memory.
    L._check_fits("gji_solve", 100, 201, torch.float64)
    with pytest.raises(ValueError, match="shared memory"):
        L._check_fits("gji_solve", 120, 241, torch.float64)


# -- the dense Newton tiers -------------------------------------------------


def _newton_inputs(B=4, n=7, m=5, seed=70):
    """A random convex-QP-like Newton system: Gx SPD, Gy = −Hxᵀ, Hy = 0,
    y, s > 0, as numpy float64."""
    rng = np.random.default_rng(seed)
    P = rng.standard_normal((B, n, n))
    Gx = P @ P.transpose(0, 2, 1) + np.eye(n)
    Hx = rng.standard_normal((B, m, n))
    Gy = -Hx.transpose(0, 2, 1)
    Hy = np.zeros((B, m, m))
    y, s = rng.uniform(0.1, 2.0, (B, m)), rng.uniform(0.1, 2.0, (B, m))
    rG, rH, rC = rng.standard_normal((B, n)), rng.standard_normal((B, m)), rng.standard_normal((B, m))
    return Gx, Gy, Hx, Hy, y, s, rG, rH, rC


TIERS = ["dense", "condensed", "schur", "schur_pallas", "schur_pallas_gj", "schur_pallas_gjr"]


@pytest.mark.parametrize("tier", TIERS)
def test_newton_step_matches_jax(tier):
    arrs = _newton_inputs()
    reg = 1e-4
    want = jax.vmap(lambda *a: jlinalg.NEWTON_STEPS[tier](*a, reg))(*_j(*arrs))
    got = linalg.NEWTON_STEPS[tier](*_t(*arrs), reg)
    # 1e-10: float64 solves of systems of condition ~1e2 that differ only by
    # rounding order.
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-10)


@pytest.mark.parametrize("tier", TIERS)
def test_factored_solver_matches_jax(tier):
    Gx, Gy, Hx, Hy, y, s, rG, rH, rC = _newton_inputs(seed=71)
    reg = 1e-4

    def jax_solve(Gx, Gy, Hx, Hy, y, s, rG, rH, rC):
        solve_f = jlinalg.factored_newton_solver(tier)(Gx, Gy, Hx, Hy, y, s, reg)
        return solve_f(rG, rH, rC)

    want = jax.vmap(jax_solve)(*_j(Gx, Gy, Hx, Hy, y, s, rG, rH, rC))
    solve_f = linalg.factored_newton_solver(tier)(*_t(Gx, Gy, Hx, Hy, y, s), reg)
    got = solve_f(*_t(rG, rH, rC))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-10)


def test_tiers_agree_with_the_dense_system():
    """Every tier solves the same regularized system (the eliminations are
    exact), so each direction matches the dense tier's."""
    arrs = _t(*_newton_inputs(seed=72))
    ref = linalg.newton_step_dense(*arrs, 1e-4)
    for tier in TIERS[1:]:
        got = linalg.NEWTON_STEPS[tier](*arrs, 1e-4)
        for g, r in zip(got, ref):
            torch.testing.assert_close(g, r, rtol=0, atol=1e-9)


def test_schur_matrix_is_spd_on_qp_systems():
    """The no-pivot GJ tiers rely on it: Gx + tI − Gy·diag(1/w)·Hx with
    Gy = −Hxᵀ is M + tI + Hxᵀ·diag(1/w)·Hx."""
    Gx, Gy, Hx, Hy, y, s, rG, rH, rC = _t(*_newton_inputs(seed=73))
    A, *_ = linalg._schur_system(Gx, Gy, Hx, y, s, rG, rH, rC, 1e-4)
    torch.testing.assert_close(A, A.mT, rtol=0, atol=1e-12)
    assert bool((torch.linalg.eigvalsh(A) > 0).all())


def test_gmres_is_not_ported():
    """The gmres tier, which raised before its port: its direct step and its
    factored solver (Mehrotra's) against the JAX package's."""
    arrs = _newton_inputs(seed=74)
    reg = 1e-4
    want = jax.vmap(lambda *a: jlinalg.NEWTON_STEPS["gmres"](*a, reg))(*_j(*arrs))
    got = linalg.NEWTON_STEPS["gmres"](*_t(*arrs), reg)
    kw = dict(tol=1e-9, restart=3, maxiter=2, preconditioner="jacobi")
    want_f = jax.vmap(lambda *a: jlinalg.factored_newton_solver("gmres")(
        *a[:6], reg, gmres_options=kw)(*a[6:]))(*_j(*arrs))
    got_f = linalg.factored_newton_solver("gmres")(*_t(*arrs)[:6], reg, gmres_options=kw)(
        *_t(*arrs)[6:])
    # 1e-10: float64 GMRES of systems of condition ~1e2, summed in another
    # order.
    for g, w in zip(got + got_f, tuple(want) + tuple(want_f)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-10)
