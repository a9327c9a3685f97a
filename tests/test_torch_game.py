"""The port's lane-change game front end (T=10, float64) held against the
JAX package's: residuals, time structure, affine bands and the banded Newton
step on the same numpy inputs."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcp_tpu.bench import lane_change as jlc
from mcp_tpu.kernels.block_tridiag import (
    banded_newton_step_compressed as jax_newton_step,
    gh_banded_fast as jax_gh_banded_fast,
)
from mcp_tpu_torch.bench import lane_change as tlc
from mcp_tpu_torch.convert import affine_bands_from_numpy, time_structure_from_numpy
from mcp_tpu_torch.kernels.block_tridiag import (
    banded_newton_step_compressed,
    gh_banded,
    gh_banded_fast,
)
from mcp_tpu_torch.kernels.thomas import thomas_solve

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _games():
    jb = jlc.generate_test_problem(horizon=10)
    tb = tlc.generate_test_problem(horizon=10, device="cpu")
    return jb.parametric_game.mcp, tb.parametric_game.mcp


def _point(seed, n=200, m=250, p=10):
    rng = np.random.default_rng(seed)
    x = 0.5 * rng.standard_normal(n)
    y = rng.uniform(0.5, 1.5, m)
    s = rng.uniform(0.5, 1.5, m)
    theta = rng.standard_normal(p)
    return x, y, s, theta


def _jax_structure_dict(st):
    return dict(
        permutation=np.asarray(st.permutation),
        num_blocks=st.num_blocks,
        block_size=st.block_size,
        row_permutation=np.asarray(st.row_permutation),
        rows_per_block=st.rows_per_block,
    )


def test_dimensions_and_structure_match():
    jm, tm = _games()
    assert (tm.unconstrained_dimension, tm.constrained_dimension,
            tm.parameter_dimension) == (jm.unconstrained_dimension,
                                        jm.constrained_dimension,
                                        jm.parameter_dimension) == (200, 250, 10)
    assert tm.time_structure.permutation == tuple(jm.time_structure.permutation)
    assert tm.time_structure.row_permutation == tuple(jm.time_structure.row_permutation)
    assert (tm.time_structure.num_blocks, tm.time_structure.block_size,
            tm.time_structure.rows_per_block) == (10, 20, 25)
    assert time_structure_from_numpy(_jax_structure_dict(jm.time_structure)) == tm.time_structure


@pytest.mark.parametrize("seed", [0, 1])
def test_residuals_match(seed):
    # 1e-12: the same float64 arithmetic up to summation order.
    jm, tm = _games()
    x, y, _, theta = _point(seed)
    gj, hj = jm.gh(jnp.asarray(x), jnp.asarray(y), jnp.asarray(theta))
    gt, ht = tm.gh(*(torch.from_numpy(a) for a in (x, y, theta)))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=0, atol=1e-12)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=0, atol=1e-12)
    # The batched (vmapped) evaluation equals the per-instance one.
    gb, hb = tm.gh_batched(*(torch.from_numpy(a)[None] for a in (x, y, theta)))
    torch.testing.assert_close(gb[0], gt, rtol=0, atol=1e-14)
    torch.testing.assert_close(hb[0], ht, rtol=0, atol=1e-14)


def test_affine_bands_match_jax():
    # 1e-10: the port's game builder reproduces JAX's bands; both are exact
    # derivatives of the same quadratic game in float64.
    jm, tm = _games()
    ab_j = affine_bands_from_numpy(
        {k: None if v is None else np.asarray(v) for k, v in jm.affine_bands._asdict().items()},
        device="cpu",
    )
    for name, a, b in zip(ab_j._fields, tm.affine_bands, ab_j):
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.shape == b.shape, name
            torch.testing.assert_close(a, b, rtol=0, atol=1e-10, msg=name)
    for name in ("diag_x", "Gy_y", "Hx_y"):
        assert getattr(tm.affine_bands, name) is None
    assert tuple(tm.affine_bands.diag_y.shape) == (10, 25, 20, 20)
    assert tuple(tm.affine_bands.Gy_x.shape) == (10, 20, 20, 25)
    assert tuple(tm.affine_bands.Hx_x.shape) == (10, 20, 25, 20)


def test_colored_bands_match_affine_bands():
    # The colored-seed linearize (the path without affine bands) gives the
    # bands the affine decomposition reconstructs.
    _, tm = _games()
    x, y, _, theta = (torch.from_numpy(a) for a in _point(3))
    fast = gh_banded_fast(tm, tm.time_structure, x[None], y[None], theta[None])
    colored = gh_banded(tm, tm.time_structure, x, y, theta)
    for a, b in zip(fast, colored):
        a = a[0] if a.dim() == b.dim() + 1 else a
        torch.testing.assert_close(a, b, rtol=0, atol=1e-10)


def test_banded_newton_step_matches_jax():
    # 1e-9: one Newton direction of a regularized (reg = 1e-4) saddle system;
    # JAX solves it by XLA LU per block, the port by the Householder sweep.
    jm, tm = _games()
    x, y, s, theta = _point(4)
    rC = s * y - 0.1
    reg = 1e-4
    jx, jy, js, jt = (jnp.asarray(a) for a in (x, y, s, theta))
    g, h, *bands = jax_gh_banded_fast(jm, jm.time_structure, jx, jy, jt)
    want = jax_newton_step(*bands, jy, js, g, h - js, jnp.asarray(rC), reg,
                           jm.time_structure)
    tx, ty, ts, tt = (torch.from_numpy(a)[None] for a in (x, y, s, theta))
    tg, th, *tbands = gh_banded_fast(tm, tm.time_structure, tx, ty, tt)
    np.testing.assert_allclose(tg[0].numpy(), np.asarray(g), rtol=0, atol=1e-12)
    got = banded_newton_step_compressed(
        *tbands, ty, ts, tg, th - ts, torch.from_numpy(rC)[None], reg,
        tm.time_structure, algorithm=thomas_solve,
    )
    for a, b in zip(got, want):
        np.testing.assert_allclose(a[0].numpy(), np.asarray(b), rtol=0, atol=1e-9)


def test_residual_parts_match():
    jm, tm = _games()
    x, y, s, theta = _point(5)
    want = jm.F_parts(*(jnp.asarray(a) for a in (x, y, s, theta)), 0.1)
    got = tm.F_parts(*(torch.from_numpy(a) for a in (x, y, s, theta)), 0.1)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        tm.F(*(torch.from_numpy(a) for a in (x, y, s, theta)), 0.1).numpy(),
        np.concatenate([np.asarray(b) for b in want]), rtol=0, atol=1e-12,
    )


def test_from_k_matches_jax():
    from mcp_tpu.mcp import PrimalDualMCP as JaxMCP
    from mcp_tpu_torch.mcp import PrimalDualMCP

    M = np.array([[2.0, 1.0, 0.0], [1.0, 3.0, 1.0], [0.0, 1.0, 4.0]])
    lb, ub = [-np.inf, 0.0, -np.inf], [np.inf] * 3
    jm = JaxMCP.from_k(lambda z, th: jnp.asarray(M) @ z - th, lb, ub, parameter_dimension=3)
    tm = PrimalDualMCP.from_k(
        lambda z, th: torch.from_numpy(M) @ z - th, lb, ub, parameter_dimension=3
    )
    assert (tm.unconstrained_dimension, tm.constrained_dimension) == (2, 1)
    x, y, th = np.array([0.3, -1.2]), np.array([0.7]), np.array([1.0, 2.0, 3.0])
    for a, b in zip(tm.gh(*(torch.from_numpy(v) for v in (x, y, th))),
                    jm.gh(*(jnp.asarray(v) for v in (x, y, th)))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-15)
    J = tm.gh_linearized(*(torch.from_numpy(v) for v in (x, y, th)))
    Jj = jm.gh_linearized(*(jnp.asarray(v) for v in (x, y, th)))
    for a, b in zip(J, Jj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-15)
    with pytest.raises(ValueError, match="upper"):
        PrimalDualMCP.from_k(lambda z, th: z, [0.0], [1.0], parameter_dimension=0)
    with pytest.raises(ValueError, match="lower"):
        PrimalDualMCP.from_k(lambda z, th: z, [1.0], [np.inf], parameter_dimension=0)


def test_theta_sampler_matches_jax_support():
    """The port's sampler matches JAX's in distribution (not values): the
    same support, the same lane centers, the same separation rule."""
    jb = jlc.generate_test_problem(horizon=10)
    tb = tlc.generate_test_problem(horizon=10, device="cpu")
    got = tlc.generate_parameter_batch(
        torch.Generator().manual_seed(0), 4000, tb, dtype=torch.float64, device="cpu"
    ).numpy()
    want = np.asarray(jlc.generate_parameter_batch(jax.random.PRNGKey(0), 4000, jb))
    for th in (got, want):
        assert th.shape[1] == 10
        px, py = th[:, [0, 5]], th[:, [1, 6]]
        assert ((px >= 0.5) & (px <= 3.5)).all()
        assert (py[:, 0] >= 1.0).all() and (py[:, 0] <= 25.0).all()
        assert (py[:, 1] <= 27.5).all()
        assert ((th[:, [2, 3, 7, 8]] >= 0.0) & (th[:, [2, 3, 7, 8]] <= 2.0)).all()
        assert set(np.unique(th[:, [4, 9]])) == {1.0, 3.0}
        d2 = (px[:, 0] - px[:, 1]) ** 2 + (py[:, 0] - py[:, 1]) ** 2
        pushed = np.isclose(py[:, 1], py[:, 0] + 2.5)
        assert (d2[~pushed] >= 6.25 - 1e-9).all()
    # Means agree within sampling error (4000 draws, stds ≤ 7.2).
    np.testing.assert_allclose(got.mean(axis=0), want.mean(axis=0), atol=0.5)
