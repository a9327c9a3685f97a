"""The random-QP path of the PyTorch port against the JAX package: the QP
suite's MCP, its affine fast path, and whole solves on every dense tier and
algorithm, on the same θ, in float64 on the CPU (JAX Pallas kernels in
interpret mode). The QP is the reference's benchmark at n=8 primals and
m=6 inequalities, dense (sparsity 0; at these sizes the benchmark's 0.9
masking leaves most draws infeasible)."""

import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcp_tpu import PrimalDualMCP as JaxMCP
from mcp_tpu.bench import qp as jqp
from mcp_tpu.bench.harness import true_kkt_errors as jax_true_kkt
from mcp_tpu.mcp import verify_affine as jax_verify_affine
from mcp_tpu.parallel.batch import solve_batch as jax_solve_batch
from mcp_tpu.solver import SolverOptions as JaxOptions
from mcp_tpu_torch import (
    SOLVED,
    PrimalDualMCP,
    SolverOptions,
    auto_tightening_rate,
    solve_batch,
    solve_batches_streamed,
    verify_affine,
)
from mcp_tpu_torch.bench import qp
from mcp_tpu_torch.bench.harness import true_kkt_errors

torch.set_num_threads(1)

N, M = 8, 6
# The QP suite's options (bench.py --suite qp) at the CPU's tolerance.
QP = dict(
    tol=1e-4,
    linear_solver="schur_pallas_gj",
    algorithm="mehrotra",
    refinement_steps=0,
    max_outer_iters=25,
    retry=0,
    retry_max_outer_iters=8,
    retry_linear_solver="schur_pallas",
    polish=True,
)


@functools.lru_cache(maxsize=None)
def _setup():
    jp = jqp.generate_test_problem(num_primals=N, num_inequalities=M)
    tp = qp.generate_test_problem(num_primals=N, num_inequalities=M, device="cpu")
    thetas = np.array(
        jqp.generate_parameter_batch(
            jax.random.PRNGKey(5), 4, num_primals=N, num_inequalities=M,
            sparsity_rate=0.0, dtype=jnp.float64,
        )
    )
    return jp.mcp, tp.mcp, thetas


@functools.lru_cache(maxsize=None)
def _solve_both(items):
    """(JAX result as numpy, port result) for the options ``dict(items)``."""
    jm, tm, thetas = _setup()
    opts = dict(items)
    want = jax.tree.map(
        np.asarray, jax_solve_batch(jm, jnp.asarray(thetas), options=JaxOptions(**opts))
    )
    got = solve_batch(tm, torch.from_numpy(thetas), options=SolverOptions(**opts))
    return want, got


def _assert_same_solve(want, got):
    np.testing.assert_array_equal(got.status.numpy(), want.status)
    np.testing.assert_array_equal(got.outer_iters.numpy(), want.outer_iters)
    # 1e-7: float64 iterates of the same algorithm; the packages differ only
    # by rounding order, which the loops do not amplify past ~1e-13 here.
    np.testing.assert_allclose(got.x.numpy(), want.x, rtol=0, atol=1e-7)
    np.testing.assert_allclose(got.kkt_error.numpy(), want.kkt_error, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(got.epsilon.numpy(), want.epsilon, rtol=1e-6, atol=1e-12)


# -- the MCP ----------------------------------------------------------------


def test_parameter_layout_matches_jax():
    _, _, thetas = _setup()
    assert qp.parameter_dimension(N, M) == jqp.parameter_dimension(N, M) == thetas.shape[1]
    want = jqp.unpack_parameters(jnp.asarray(thetas[0]), num_primals=N, num_inequalities=M)
    got = qp.unpack_parameters(torch.from_numpy(thetas), num_primals=N, num_inequalities=M)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))


def test_gh_affine_data_matches_jax():
    jm, tm, thetas = _setup()
    want = jax.vmap(lambda t: jm.gh_affine_data(t))(jnp.asarray(thetas))
    got = tm.gh_affine_data(torch.from_numpy(thetas))
    assert [tuple(g.shape) for g in got] == [(4, N), (4, M), (4, N, N), (4, N, M), (4, M, N), (4, M, M)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-12)


def test_gh_affine_data_casts_to_dtype():
    _, tm, thetas = _setup()
    got = tm.gh_affine_data(torch.from_numpy(thetas), dtype=torch.float32)
    assert all(g.dtype == torch.float32 for g in got)


def test_verify_affine_agrees_with_jax():
    jm, tm, thetas = _setup()
    assert tm.affine
    assert jax_verify_affine(jm, jnp.asarray(thetas[0]))
    assert verify_affine(tm, torch.from_numpy(thetas[0]))
    assert verify_affine(tm, torch.from_numpy(thetas), generator=torch.Generator().manual_seed(3))

    nonaffine_j = JaxMCP.from_gh(
        lambda x, y, t: x**2 - t, lambda x, y, t: x + 1.0,
        unconstrained_dimension=2, constrained_dimension=2, parameter_dimension=2,
    )
    nonaffine_t = PrimalDualMCP.from_gh(
        lambda x, y, t: x**2 - t, lambda x, y, t: x + 1.0,
        unconstrained_dimension=2, constrained_dimension=2, parameter_dimension=2,
    )
    assert not jax_verify_affine(nonaffine_j, jnp.ones(2))
    assert not verify_affine(nonaffine_t, torch.ones(2, dtype=torch.float64))


def test_sampler_draws_sparse_convex_qps():
    gen = torch.Generator().manual_seed(0)
    th = qp.generate_parameter_batch(gen, 64, num_primals=20, num_inequalities=30,
                                     dtype=torch.float64, device="cpu")
    assert tuple(th.shape) == (64, qp.parameter_dimension(20, 30))
    Mq, A, b, phi = qp.unpack_parameters(th, num_primals=20, num_inequalities=30)
    torch.testing.assert_close(Mq, Mq.mT, rtol=0, atol=0)
    assert bool((torch.linalg.eigvalsh(Mq) > -1e-9).all())  # PSD: (P∘mask)ᵀ(P∘mask)
    kept = float((A != 0).double().mean())
    assert 0.07 < kept < 0.13  # sparsity rate 0.9
    one = qp.generate_random_parameter(torch.Generator().manual_seed(0), num_primals=20,
                                       num_inequalities=30, device="cpu")
    assert one.dtype == torch.float32 and tuple(one.shape) == (th.shape[1],)
    again = qp.generate_parameter_batch(torch.Generator().manual_seed(0), 64, num_primals=20,
                                        num_inequalities=30, dtype=torch.float64, device="cpu")
    torch.testing.assert_close(again, th, rtol=0, atol=0)


# -- whole solves -----------------------------------------------------------


@pytest.mark.parametrize(
    "tier, algorithm",
    [
        ("schur_pallas_gj", "mehrotra"),
        ("schur_pallas", "mehrotra"),
        ("schur_pallas_gjr", "mehrotra"),
        ("schur", "mehrotra"),
        ("condensed", "mehrotra"),
        ("dense", "mehrotra"),
        ("schur_pallas_gj", "ip"),
        ("schur_pallas_gj", "hybrid"),
        ("schur_pallas_gjr", "ip"),
    ],
)
def test_qp_solve_matches_jax(tier, algorithm):
    opts = dict(QP, linear_solver=tier, algorithm=algorithm)
    want, got = _solve_both(tuple(sorted(opts.items())))
    _assert_same_solve(want, got)
    assert (want.status == SOLVED).all()


def test_qp_solve_certifies_in_both_packages():
    jm, tm, thetas = _setup()
    want, got = _solve_both(tuple(sorted(QP.items())))
    tk = true_kkt_errors(tm, got, torch.from_numpy(thetas)).numpy()
    tk_j = np.asarray(jax_true_kkt(jm, jax.tree.map(jnp.asarray, want), jnp.asarray(thetas)))
    np.testing.assert_allclose(tk, tk_j, rtol=1e-6, atol=1e-14)
    assert (tk <= QP["tol"]).all()
    # With polish, kkt_error is the true residual at the returned point.
    np.testing.assert_allclose(got.kkt_error.numpy(), tk, rtol=1e-10)


def test_mehrotra_refinement_matches_jax():
    opts = dict(QP, linear_solver="schur", refinement_steps=2, tol=1e-6)
    want, got = _solve_both(tuple(sorted(opts.items())))
    _assert_same_solve(want, got)


@pytest.mark.parametrize(
    "override",
    [
        # The shipped config of tests/test_kernels.py:323-350.
        dict(tol=1e-5, retry=1),
        # A primary cap of 5 fails every lane; the retry on the QR tier
        # rescues them (and pays its iterations).
        dict(tol=1e-5, max_outer_iters=5, retry=1, retry_max_outer_iters=30),
        # Two rounds that both fail: status and accounting stay FAILED.
        dict(tol=1e-5, max_outer_iters=5, retry=2, retry_max_outer_iters=3,
             polish=False, refinement_steps=1),
    ],
    ids=["shipped", "rescued", "still_failed"],
)
def test_retry_matches_jax(override):
    opts = dict(QP, **override)
    want, got = _solve_both(tuple(sorted(opts.items())))
    _assert_same_solve(want, got)


def test_failed_step_stops_mehrotra_lane():
    """A lane whose Newton direction is non-finite stops with status FAILED
    and keeps its last iterate; the other lanes are untouched."""
    _, tm, thetas = _setup()
    th = torch.from_numpy(thetas.copy())
    th[1, 0] = np.nan  # lane 1's M[0, 0]
    res = solve_batch(tm, th, options=SolverOptions(**QP))
    assert res.status.tolist()[1] == 1 and res.outer_iters.tolist()[1] == 2
    ref = solve_batch(tm, torch.from_numpy(thetas), options=SolverOptions(**QP))
    keep = [0, 2, 3]
    torch.testing.assert_close(res.x[keep], ref.x[keep], rtol=0, atol=0)


def test_float32_solves_every_lane():
    """The card's working precision: float32 iterates from θ's dtype;
    parity with float64 is by status and certified true KKT."""
    _, tm, thetas = _setup()
    th = torch.from_numpy(thetas).to(torch.float32)
    res = solve_batch(tm, th, options=SolverOptions(**QP))
    assert res.x.dtype == torch.float32
    assert bool((res.status == SOLVED).all())
    res64 = res._replace(x=res.x.double(), y=res.y.double(), s=res.s.double())
    assert bool((true_kkt_errors(tm, res64, th.double()) <= QP["tol"]).all())


def test_streamed_batches_take_the_dtype_of_theta():
    _, tm, thetas = _setup()
    stack = torch.from_numpy(thetas).reshape(2, 2, -1)
    res = solve_batches_streamed(tm, stack, options=SolverOptions(**QP))
    assert tuple(res.x.shape) == (2, 2, N) and res.x.dtype == torch.float64
    _, single = _solve_both(tuple(sorted(QP.items())))
    np.testing.assert_array_equal(res.status.reshape(-1).numpy(), single.status.numpy())
    np.testing.assert_allclose(res.x.reshape(4, -1).numpy(), single.x.numpy(), rtol=0, atol=1e-12)
    res32 = solve_batches_streamed(tm, stack.float(), options=SolverOptions(**QP))
    assert res32.x.dtype == res32.y.dtype == res32.s.dtype == torch.float32


def test_auto_tightening_rate_of_the_qp_is_the_reference_default():
    _, tm, _ = _setup()
    assert auto_tightening_rate(tm) == 0.1


def test_gj_tier_on_a_non_affine_mcp_warns():
    _, tm, thetas = _setup()
    generic = dataclasses.replace(tm, affine=False)
    with pytest.warns(UserWarning, match="no-pivot Gauss"):
        res = solve_batch(generic, torch.from_numpy(thetas[:2]), options=SolverOptions(**QP))
    # Without the affine fast path every step linearizes by forward mode;
    # the QP is affine, so the solve is the same.
    _, ref = _solve_both(tuple(sorted(QP.items())))
    np.testing.assert_array_equal(res.outer_iters.numpy(), ref.outer_iters.numpy()[:2])
    np.testing.assert_allclose(res.x.numpy(), ref.x.numpy()[:2], rtol=0, atol=1e-10)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        solve_batch(tm, torch.from_numpy(thetas[:1]), options=SolverOptions(**QP))


#: The options that once raised, each now solved by the port and held to
#: the JAX package. Where the JAX package's iterates for the option equal
#: its suite solve's on the CPU, that cached solve is the reference: a
#: retry round after every lane SOLVED is gated off (its result is the first
#: pass's), verbose only prints (nothing fails here), and XLA's CPU backend
#: computes float64 products alike at every precision.
PORTED_OPTIONS = [
    (dict(linear_solver="gmres"), False),
    (dict(retry=1, retry_linear_solver="gmres"), True),
    (dict(verbose=True), True),
    (dict(matmul_precision="high"), True),
    (dict(algorithm="hybrid", linear_solver="gmres"), False),
]


@pytest.mark.parametrize("override, same_as_suite", PORTED_OPTIONS,
                         ids=[f"override{i}-item 3" for i in range(len(PORTED_OPTIONS))])
def test_unported_options_raise(override, same_as_suite):
    """Each option runs (it raised before its port) and agrees with the JAX
    package: status, outer iterations, x to 1e-8. matmul_precision="high"
    equals "highest" on the CPU bit for bit, and leaves the precision
    flags as it found them."""
    opts = {**QP, **override}
    want, base = _solve_both(tuple(sorted(QP.items())))
    if not same_as_suite:
        want, _ = _solve_both(tuple(sorted(opts.items())))
    flags = (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    _, tm, thetas = _setup()
    got = solve_batch(tm, torch.from_numpy(thetas), options=SolverOptions(**opts))
    _assert_same_solve(want, got)
    np.testing.assert_allclose(got.x.numpy(), want.x, rtol=0, atol=1e-8)
    assert flags == (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
    if "matmul_precision" in override:
        for g, b in zip(got, base):
            torch.testing.assert_close(g, b, rtol=0, atol=0)


def test_bad_options_raise():
    _, tm, thetas = _setup()
    th = torch.from_numpy(thetas[:1])
    with pytest.raises(ValueError, match="unknown algorithm"):
        solve_batch(tm, th, options=SolverOptions(**{**QP, "algorithm": "newton"}))
    with pytest.raises(ValueError, match="unknown linear_solver"):
        solve_batch(tm, th, options=SolverOptions(**{**QP, "linear_solver": "lu"}))
    with pytest.raises(ValueError, match="time_structure"):
        solve_batch(tm, th, options=SolverOptions(**{**QP, "linear_solver": "tridiag_pallas",
                                                      "algorithm": "ip"}))


def test_mehrotra_without_inequalities_runs_the_annealed_loop():
    """m = 0 (a pure root-find): Mehrotra's predictor is its corrector, so
    the annealed Newton loop runs, as in the JAX package."""
    Aj = np.array([[3.0, 1.0], [1.0, 2.0]])

    def jG(x, y, t):
        return jnp.asarray(Aj) @ x - t

    def tG(x, y, t):
        return torch.from_numpy(Aj) @ x - t

    jm = JaxMCP.from_gh(jG, lambda x, y, t: jnp.zeros(0, x.dtype), unconstrained_dimension=2,
                        constrained_dimension=0, parameter_dimension=2, affine=True)
    tm = PrimalDualMCP.from_gh(tG, lambda x, y, t: x.new_zeros(0), unconstrained_dimension=2,
                               constrained_dimension=0, parameter_dimension=2, affine=True)
    th = np.array([[1.0, -0.5], [0.25, 2.0]])
    opts = dict(tol=1e-8, linear_solver="schur_pallas", algorithm="mehrotra")
    want = jax_solve_batch(jm, jnp.asarray(th), options=JaxOptions(**opts))
    got = solve_batch(tm, torch.from_numpy(th), options=SolverOptions(**opts))
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(want.status))
    np.testing.assert_array_equal(got.outer_iters.numpy(), np.asarray(want.outer_iters))
    np.testing.assert_allclose(got.x.numpy(), np.linalg.solve(Aj, th.T).T, atol=1e-8)
