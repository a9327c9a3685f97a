"""The banded tiers on a trajectory game without a row time structure, in
the PyTorch port against the JAX package: the lane-change game (T=10, b=20)
with its inequality-row permutation removed, so both packages linearize the
Jacobian densely and solve the Schur system permuted to time-major bands
(``linalg.newton_step_tridiag``), in float64 on the CPU (the JAX Pallas
kernels in interpret mode, the port's plain versions). Also: the float32
lanes of the pivot-free blocked cyclic-reduction tiers against the JAX
package's float32 lanes (see the note above those tests)."""

import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcp_tpu import solve as jax_solve
from mcp_tpu.bench import lane_change as jlc
from mcp_tpu.kernels import block_tridiag as JBT
from mcp_tpu.parallel.batch import solve_batch as jax_solve_batch
from mcp_tpu.solver import SolverOptions as JaxOptions
from mcp_tpu_torch import SOLVED, SolverOptions, solve, solve_batch
from mcp_tpu_torch import linalg
from mcp_tpu_torch.bench import lane_change as tlc
from mcp_tpu_torch.kernels import block_tridiag as TBT

torch.set_num_threads(1)

#: The headline options (bench.py) with the tier under test.
OPTIONS = dict(tol=1e-4, algorithm="ip", polish=True, retry=0, refinement_steps=1,
               tightening_rate=0.02)


def _without_rows(mcp):
    st = mcp.time_structure._replace(row_permutation=None, rows_per_block=None)
    return dataclasses.replace(mcp, time_structure=st)


@functools.lru_cache(maxsize=None)
def _lane_change():
    jb = jlc.generate_test_problem(horizon=10)
    tb = tlc.generate_test_problem(horizon=10, device="cpu")
    thetas = np.array(
        jlc.generate_parameter_batch(jax.random.PRNGKey(4), 2, jb, dtype=jnp.float64))
    return (_without_rows(jb.parametric_game.mcp), _without_rows(tb.parametric_game.mcp),
            thetas)


@pytest.mark.parametrize("tier", ["tridiag", "tridiag_pallas", "tridiag_cr"])
def test_banded_tier_without_row_structure_matches_jax(tier):
    jm, tm, thetas = _lane_change()
    assert tm.time_structure.row_permutation is None
    want = jax.tree.map(np.asarray, jax_solve_batch(
        jm, jnp.asarray(thetas), options=JaxOptions(linear_solver=tier, **OPTIONS)))
    got = solve_batch(tm, torch.from_numpy(thetas),
                      options=SolverOptions(linear_solver=tier, **OPTIONS))
    np.testing.assert_array_equal(got.status.numpy(), want.status)
    np.testing.assert_array_equal(got.outer_iters.numpy(), want.outer_iters)
    assert (want.status == SOLVED).all()
    # 1e-8: float64 iterates of the same algorithm, differing by rounding.
    np.testing.assert_allclose(got.x.numpy(), want.x, rtol=0, atol=1e-8)


def test_mehrotra_without_row_structure_matches_jax():
    """The Mehrotra body's dense-linearize banded branch (one lane)."""
    jm, tm, thetas = _lane_change()
    opts = dict(OPTIONS, algorithm="hybrid", linear_solver="tridiag", refinement_steps=0)
    want = jax.tree.map(np.asarray, jax_solve_batch(
        jm, jnp.asarray(thetas[:1]), options=JaxOptions(**opts)))
    got = solve_batch(tm, torch.from_numpy(thetas[:1]), options=SolverOptions(**opts))
    np.testing.assert_array_equal(got.status.numpy(), want.status)
    np.testing.assert_array_equal(got.outer_iters.numpy(), want.outer_iters)
    np.testing.assert_allclose(got.x.numpy(), want.x, rtol=0, atol=1e-8)


def test_gradient_without_row_structure_matches_jax():
    """The IFT's "tridiag" branch on the dense Schur matrix
    (``tridiag_solve_permuted``): the gradient of Σx² of one solve."""
    jm, tm, thetas = _lane_change()
    opts = dict(OPTIONS, linear_solver="tridiag", sensitivity_solver="tridiag", tol=1e-6)
    g_jax = np.asarray(jax.grad(
        lambda t: jnp.sum(jax_solve(jm, t, options=JaxOptions(**opts)).x ** 2)
    )(jnp.asarray(thetas[0])))
    theta = torch.from_numpy(thetas[0]).requires_grad_()
    res = solve(tm, theta, options=SolverOptions(**opts))
    assert int(res.status) == SOLVED
    (g,) = torch.autograd.grad((res.x ** 2).sum(), theta)
    # rtol 1e-6: two float64 IFT solves of the same system at solutions
    # equal to ~1e-9.
    np.testing.assert_allclose(g.numpy(), g_jax, rtol=1e-6, atol=1e-8)


def test_newton_step_tridiag_matches_jax_on_both_branches():
    """``linalg.newton_step_tridiag`` (the permuted dense Schur system) with
    and without row structure against the JAX package's, which takes its
    band-only assembly on the first and the permuted dense system on the
    second, on the lane-change Jacobian."""
    jb = jlc.generate_test_problem(horizon=10)
    tb = tlc.generate_test_problem(horizon=10, device="cpu")
    jm, tm = jb.parametric_game.mcp, tb.parametric_game.mcp
    n, m = jm.unconstrained_dimension, jm.constrained_dimension
    rng = np.random.default_rng(5)
    theta = _lane_change()[2][0]
    x = 0.1 * rng.standard_normal(n)
    y, s = rng.uniform(0.5, 2.0, m), rng.uniform(0.5, 2.0, m)
    rG, rH, rC = rng.standard_normal(n), rng.standard_normal(m), rng.standard_normal(m)
    Gx, Gy, Hx, Hy = (np.asarray(a) for a in jm.gh_jacobians(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(theta)))
    for st_j, st_t in ((jm.time_structure, tm.time_structure),
                       (_without_rows(jm).time_structure, _without_rows(tm).time_structure)):
        from mcp_tpu.linalg import newton_step_tridiag as jax_step

        want = jax_step(*(jnp.asarray(a) for a in (Gx, Gy, Hx, Hy, y, s, rG, rH, rC)), 1e-4,
                        structure=st_j)
        got = linalg.newton_step_tridiag(
            *(torch.from_numpy(a)[None] for a in (Gx, Gy, Hx, Hy, y, s, rG, rH, rC)), 1e-4,
            structure=st_t)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[0].numpy(), np.asarray(w), rtol=0, atol=1e-10)


def test_block_thomas_solve_matches_the_multi_version():
    """``block_thomas_solve`` is the one-column case of
    ``block_thomas_solve_multi``, bit for bit, and the JAX package's."""
    rng = np.random.default_rng(6)
    T, b = 4, 3
    diag = rng.standard_normal((2, T, b, b)) + 4 * np.eye(b)
    lower, upper = rng.standard_normal((2, 2, T - 1, b, b))
    rhs = rng.standard_normal((2, T, b))
    got = TBT.block_thomas_solve(*(torch.from_numpy(a) for a in (diag, lower, upper, rhs)))
    want = jax.vmap(JBT.block_thomas_solve)(*(jnp.asarray(a) for a in (diag, lower, upper, rhs)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-13)


# -- the pivot-free blocked cyclic-reduction tiers in float32 ---------------
#
# Gauss–Jordan without pivoting meets the structural zero diagonals of the
# game blocks on the first Newton step, so its float32 result there turns on
# how each product is rounded. The port's plain version rounds every
# multiply and every add (as PyTorch's CPU kernels do). The JAX package's
# kernel, compiled by XLA for a CPU with FMA, contracts a + u·s into one
# fused multiply-add: the same eight θ then blow up on every lane (x ~ 1e20
# on the first step; no lane solves) where the port solves 7. Run op by op
# (``jax.disable_jit``), or compiled for a CPU without FMA
# (``--xla_cpu_max_isa=SSE4_2``), the JAX package matches the port: the
# first-step solves to float32 rounding, and every lane's status. Which lanes blow
# up is also not stable under a 1-ulp perturbation of the bands in either
# package (the last test below).


@functools.lru_cache(maxsize=None)
def _f32_lanes():
    jb = jlc.generate_test_problem(horizon=10)
    tb = tlc.generate_test_problem(horizon=10, device="cpu")
    thetas = np.array(jlc.generate_parameter_batch(
        jax.random.PRNGKey(8), 8, jb, dtype=jnp.float32))
    return jb.parametric_game.mcp, tb.parametric_game.mcp, thetas


CR_F32_TIERS = ("tridiag_pallas_crgjb", "tridiag_pallas_crgjbr")

#: The JAX package's float32 statuses on the pivot-free blocked CR tiers,
#: run in a child process whose XLA compiles for a CPU without FMA.
_UNFUSED_JAX = """
import json, sys
import jax
import jax.numpy as jnp
import numpy as np
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
from mcp_tpu.bench import lane_change as jlc
from mcp_tpu.parallel.batch import solve_batch
from mcp_tpu.solver import SolverOptions
thetas, opts = np.load(sys.argv[1]), json.loads(sys.argv[2])
mcp = jlc.generate_test_problem(horizon=10).parametric_game.mcp
out = {tier: np.asarray(solve_batch(mcp, jnp.asarray(thetas), options=SolverOptions(
    linear_solver=tier, **opts)).status).tolist() for tier in sys.argv[3:]}
print(json.dumps(out))
"""


@functools.lru_cache(maxsize=None)
def _unfused_jax_status(tmp_dir):
    path = os.path.join(tmp_dir, "thetas.npy")
    np.save(path, _f32_lanes()[2])
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=root,
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") + " --xla_cpu_max_isa=SSE4_2").strip())
    out = subprocess.run(
        [sys.executable, "-c", _UNFUSED_JAX, path, json.dumps(OPTIONS), *CR_F32_TIERS],
        cwd=root, env=env, capture_output=True, text=True, timeout=600, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def _first_newton_bands(mcp, thetas):
    """The (diag, lower, upper, rhs) of the first Newton step of a batch
    cold-started at x = 0, y = s = 1, as numpy (lower/upper per lane)."""
    B = thetas.shape[0]
    n, m = mcp.unconstrained_dimension, mcp.constrained_dimension
    x = thetas.new_zeros((B, n))
    y = s = thetas.new_ones((B, m))
    ab = mcp.affine_bands.to(dtype=thetas.dtype)
    g, h, *bands = TBT.gh_banded_fast(mcp, mcp.time_structure, x, y, thetas, affine_bands=ab)
    out = []
    TBT.banded_newton_step_compressed(
        *bands, y, s, g, h - s, s * y - 1.0, 1e-4, mcp.time_structure,
        algorithm=lambda *a: out.append(a) or torch.zeros_like(a[3]))
    return [np.ascontiguousarray(a.expand(B, *a.shape[1:]).numpy()) for a in out[0]]


@pytest.mark.parametrize("tier", CR_F32_TIERS)
def test_float32_pivot_free_blocked_cr_lanes_against_jax(tier, tmp_path_factory):
    """A float32 batch of 8 on the pivot-free blocked CR tiers, the same θ to
    both packages: the per-lane status equals the JAX package's with the
    port's rounding (no fused multiply-add, see above), and every lane the
    port reports SOLVED is certified by its true residual."""
    from mcp_tpu_torch.bench.harness import true_kkt_errors

    _, tm, thetas = _f32_lanes()
    want = np.asarray(_unfused_jax_status(str(tmp_path_factory.getbasetemp()))[tier])
    got = solve_batch(tm, torch.from_numpy(thetas),
                      options=SolverOptions(linear_solver=tier, **OPTIONS))
    assert got.x.dtype == torch.float32
    np.testing.assert_array_equal(got.status.numpy(), want)
    ok = got.status.numpy() == SOLVED
    assert ok.any() and not ok.all()
    tk = true_kkt_errors(tm, got, torch.from_numpy(thetas)).numpy()
    assert (tk[ok] <= OPTIONS["tol"]).all()


@pytest.mark.parametrize("fact", ["gjb", "gjbr"])
def test_float32_pivot_free_blocked_cr_matches_jax_op_by_op(fact):
    """The port's plain CR with the pivot-free blocked fact on the float32
    first-Newton bands of the batch above agrees with the JAX package's CR
    algebra (``_cr_solve``) run op by op, on every lane."""
    from mcp_tpu.kernels import thomas_pallas as jtp
    from mcp_tpu_torch.kernels import cyclic_reduction as C

    _, tm, thetas = _f32_lanes()
    diag, lower, upper, rhs = _first_newton_bands(tm, torch.from_numpy(thetas))
    B, _, b, _ = diag.shape
    zero = np.zeros((B, 1, b, b), np.float32)
    padded = (diag, np.concatenate([zero, lower], 1), np.concatenate([upper, zero], 1),
              rhs[..., None])
    with jax.disable_jit():
        want = np.asarray(jtp._cr_solve(*(jnp.asarray(a) for a in padded), b=b,
                                        fact=fact))[..., 0]
    got = C.cr_thomas_solve(*(torch.from_numpy(a) for a in (diag, lower, upper, rhs)),
                            fact=fact).numpy()
    # 1e-4 of each lane's max|x|: float32 rounding of the same operations in
    # another order of summation (measured ≤ 7e-6); the compile with fused
    # multiply-adds is ~1e19 of max|x| away, or NaN.
    scale = np.abs(want).reshape(B, -1).max(axis=1)[:, None, None]
    assert np.isfinite(got).all() and (np.abs(got - want) <= 1e-4 * scale).all()


def test_float32_pivot_free_blocked_cr_is_chaotic_in_both_packages():
    """K3 with the pivot-free blocked fact on the float32 first-Newton bands
    of the batch above: a 1-ulp perturbation of the bands changes which
    lanes blow up in the JAX package's kernel (interpret mode) and in the
    port's plain version alike, while in float64 the two agree to 1e-9."""
    from mcp_tpu.kernels import thomas_pallas as jtp
    from mcp_tpu_torch.kernels import cyclic_reduction as C

    _, tm, thetas = _f32_lanes()
    bands = _first_newton_bands(tm, torch.from_numpy(thetas))
    rng = np.random.default_rng(0)
    ulp = [(a * (1 + 2.0 ** -23 * rng.choice([-1, 0, 1], size=a.shape))).astype(np.float32)
           for a in bands]

    def blown(x):
        x = x.reshape(x.shape[0], -1)
        return ~(np.isfinite(x).all(axis=1) & (np.abs(x).max(axis=1) < 1e6))

    def jax_cr(arrs):
        return np.asarray(jtp.pallas_block_thomas(*(jnp.asarray(a) for a in arrs), mode="cr",
                                                  fact="gjb", interpret=True))

    def port_cr(arrs):
        return C.cr_thomas_solve(*(torch.from_numpy(a) for a in arrs), fact="gjb").numpy()

    for solve_cr in (jax_cr, port_cr):
        assert (blown(solve_cr(bands)) != blown(solve_cr(ulp))).any()
    b64 = [a.astype(np.float64) for a in bands]
    want, got = jax_cr(b64), port_cr(b64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9 * np.abs(want).max())
