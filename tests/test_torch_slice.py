"""The port's main path against the JAX package's: the lane-change game at
T=10 solved with the headline options (annealed "ip", auto tightening,
terminal polish, retry 0, tier "tridiag_pallas" with the fused linesearch)
on the same θ, in float64 on the CPU (JAX Pallas kernels in interpret
mode)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcp_tpu.bench import lane_change as jlc
from mcp_tpu.bench.harness import true_kkt_errors as jax_true_kkt
from mcp_tpu.parallel.batch import solve_batch as jax_solve_batch
from mcp_tpu.solver import SolverOptions as JaxOptions
from mcp_tpu_torch import (
    SOLVED,
    SolverOptions,
    auto_tightening_rate,
    batch_statistics,
    solve_batch,
    solve_batches_streamed,
)
from mcp_tpu_torch.bench import lane_change as tlc
from mcp_tpu_torch.bench.harness import true_kkt_errors

torch.set_num_threads(1)

HEADLINE = dict(
    tol=1e-4,
    linear_solver="tridiag_pallas",
    algorithm="ip",
    polish=True,
    retry=0,
    refinement_steps=1,
    tightening_rate=0.02,
)


@functools.lru_cache(maxsize=None)
def _setup():
    jb = jlc.generate_test_problem(horizon=10)
    tb = tlc.generate_test_problem(horizon=10, device="cpu")
    thetas = np.array(
        jlc.generate_parameter_batch(jax.random.PRNGKey(1), 8, jb, dtype=jnp.float64)
    )
    jm = jb.parametric_game.mcp
    want = jax_solve_batch(jm, jnp.asarray(thetas), options=JaxOptions(**HEADLINE))
    want = jax.tree.map(np.asarray, want)
    return jm, tb.parametric_game.mcp, thetas, want


@functools.lru_cache(maxsize=None)
def _port_result():
    _, tm, thetas, _ = _setup()
    return solve_batch(tm, torch.from_numpy(thetas), options=SolverOptions(**HEADLINE))


def test_auto_tightening_rate_is_the_headline_rate():
    _, tm, _, _ = _setup()
    assert auto_tightening_rate(tm) == HEADLINE["tightening_rate"]


def test_headline_solve_matches_jax_per_lane():
    _, _, _, want = _setup()
    got = _port_result()
    np.testing.assert_array_equal(got.status.numpy(), want.status)
    np.testing.assert_array_equal(got.outer_iters.numpy(), want.outer_iters)
    assert (want.status == SOLVED).all()
    # 1e-7: float64 iterates of the same algorithm; the two packages differ
    # only by rounding (Householder sweep order, summation order), which the
    # annealing loop does not amplify past ~1e-9 at this size.
    np.testing.assert_allclose(got.x.numpy(), want.x, rtol=0, atol=1e-7)
    np.testing.assert_allclose(got.kkt_error.numpy(), want.kkt_error, rtol=1e-4, atol=1e-9)


def test_true_kkt_certifies_and_matches_jax():
    jm, tm, thetas, want = _setup()
    got = _port_result()
    tk = true_kkt_errors(tm, got, torch.from_numpy(thetas)).numpy()
    tk_j = np.asarray(jax_true_kkt(jm, got._replace(
        **{k: jnp.asarray(getattr(got, k).numpy()) for k in ("x", "y", "s")}
    ), jnp.asarray(thetas)))
    np.testing.assert_allclose(tk, tk_j, rtol=1e-10, atol=1e-14)
    assert (tk <= HEADLINE["tol"]).all()
    # With polish, kkt_error is the true residual at the returned point.
    np.testing.assert_allclose(got.kkt_error.numpy(), tk, rtol=1e-10)


def test_unfused_linesearch_gives_the_same_solve():
    _, tm, thetas, _ = _setup()
    fused = _port_result()
    unfused = solve_batch(
        tm, torch.from_numpy(thetas[:4]),
        options=SolverOptions(**HEADLINE, fused_linesearch=False),
    )
    np.testing.assert_array_equal(unfused.status.numpy(), fused.status.numpy()[:4])
    np.testing.assert_array_equal(unfused.outer_iters.numpy(), fused.outer_iters.numpy()[:4])
    np.testing.assert_allclose(unfused.x.numpy(), fused.x.numpy()[:4], rtol=0, atol=1e-10)


def test_colored_seed_path_gives_the_same_solve():
    """Without affine bands each Newton step linearizes every lane by
    colored forward seeds; the lane-change game is quadratic, so both paths
    see the same bands."""
    import dataclasses

    _, tm, thetas, _ = _setup()
    colored = solve_batch(
        dataclasses.replace(tm, affine_bands=None), torch.from_numpy(thetas[:2]),
        options=SolverOptions(**HEADLINE),
    )
    fused = _port_result()
    np.testing.assert_array_equal(colored.status.numpy(), fused.status.numpy()[:2])
    np.testing.assert_array_equal(colored.outer_iters.numpy(), fused.outer_iters.numpy()[:2])
    np.testing.assert_allclose(colored.x.numpy(), fused.x.numpy()[:2], rtol=0, atol=1e-10)


def test_streamed_batches_match_single_batches():
    _, tm, thetas, _ = _setup()
    stack = torch.from_numpy(thetas).reshape(2, 4, -1)
    res = solve_batches_streamed(tm, stack, options=SolverOptions(**HEADLINE))
    assert tuple(res.x.shape) == (2, 4, 200)
    single = _port_result()
    np.testing.assert_array_equal(res.status.reshape(-1).numpy(), single.status.numpy())
    np.testing.assert_allclose(res.x.reshape(8, -1).numpy(), single.x.numpy(), rtol=0, atol=1e-10)
    tk = true_kkt_errors(tm, res, stack)
    assert tuple(tk.shape) == (2, 4)
    assert bool((tk[res.status == SOLVED] <= HEADLINE["tol"]).all())
    stats = batch_statistics(res)
    assert stats["num_instances"] == 8 and stats["success_rate"] == 1.0


def test_warm_chain_streams_from_the_previous_solution():
    _, tm, thetas, _ = _setup()
    stack = torch.from_numpy(np.stack([thetas[:4], thetas[:4]]))
    res = solve_batches_streamed(
        tm, stack, options=SolverOptions(**HEADLINE), warm_chain=True, warm_slacks=True
    )
    assert bool((res.status == SOLVED).all())
    # Re-solving the same θ from its own solution needs no more iterations.
    assert bool((res.outer_iters[1] <= res.outer_iters[0]).all())


#: The options that once raised on the headline path, each solved by the
#: port on lane 0 and held to the JAX package. gmres runs with a restart of
#: n = 200: a full Krylov space solves each Newton system (with the
#: default restart of 50, five restarts leave the game's nonsymmetric Schur
#: systems unsolved and both packages FAIL the lane after 50 outer
#: iterations, where rounding sets x). Where the JAX package's iterates for
#: the option equal its headline solve's on the CPU, that solve is the
#: reference: a retry round after every lane SOLVED is gated off, XLA's CPU
#: backend computes float64 products alike at every precision, and verbose
#: only prints (and runs the unfused linesearch, the same algebra).
PORTED_OPTIONS = [
    (dict(linear_solver="gmres", gmres_restart=200), False),
    (dict(retry=1, retry_linear_solver="gmres"), True),
    (dict(matmul_precision="high"), True),
    (dict(verbose=True), True),
]


@pytest.mark.parametrize("override, same_as_headline", PORTED_OPTIONS,
                         ids=[f"override{i}-item 3" for i in range(len(PORTED_OPTIONS))])
def test_unported_options_raise(override, same_as_headline):
    """The gmres tier as the solve tier and the retry tier, verbose and
    reduced matmul precision run (each raised before its port) and agree
    with the JAX package: status, outer iterations, x to 1e-8.
    matmul_precision="high" equals "highest" on the CPU bit for bit and
    leaves the precision flags as it found them."""
    jm, tm, thetas, want = _setup()
    opts = {**HEADLINE, **override}
    th = thetas[:1]
    if same_as_headline:
        want = jax.tree.map(lambda a: a[:1], want)
    else:
        want = jax.tree.map(np.asarray, jax_solve_batch(jm, jnp.asarray(th),
                                                        options=JaxOptions(**opts)))
    flags = (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    got = solve_batch(tm, torch.from_numpy(th), options=SolverOptions(**opts))
    np.testing.assert_array_equal(got.status.numpy(), want.status)
    assert (want.status == SOLVED).all()
    np.testing.assert_array_equal(got.outer_iters.numpy(), want.outer_iters)
    np.testing.assert_allclose(got.x.numpy(), want.x, rtol=0, atol=1e-8)
    assert flags == (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
    if "matmul_precision" in override:
        highest = solve_batch(tm, torch.from_numpy(th), options=SolverOptions(**HEADLINE))
        for g, h in zip(got, highest):
            torch.testing.assert_close(g, h, rtol=0, atol=0)


def test_float32_solves_every_lane():
    """The card's working precision: f32 iterates from θ's dtype; parity
    with float64 is by status and certified true KKT, not equal iterates."""
    _, tm, thetas, want = _setup()
    th = torch.from_numpy(thetas[:4]).to(torch.float32)
    res = solve_batch(tm, th, options=SolverOptions(**HEADLINE))
    assert res.x.dtype == torch.float32
    np.testing.assert_array_equal(res.status.numpy(), want.status[:4])
    assert bool((true_kkt_errors(tm, res, th) <= HEADLINE["tol"]).all())
