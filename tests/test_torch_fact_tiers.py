"""Every banded tier of the JAX package on the PyTorch port: the route each
tier takes (kernel and in-block factorization) against the JAX package's
``pallas_block_thomas`` choice over a (B, T, b) grid, the plain versions of
the sweeps K1′ and K7a and of cyclic reduction K3 with each factorization
against the JAX package's kernels in interpret mode, and a masked-game solve
on tier "tridiag_pallas_gjp" through K7a's plain version; float64 on the CPU,
the same numpy inputs to both packages. The lane-change solves on these
tiers are in test_torch_fact_tiers_sweep.py and test_torch_fact_tiers_cr.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcp_tpu import solver as jsolver
from mcp_tpu.bench.flagships import masked_game_setup as jax_setup
from mcp_tpu.kernels import thomas_pallas as jtp
from mcp_tpu.parallel.batch import solve_batch as jax_solve_batch
from mcp_tpu.solver import SolverOptions as JaxOptions
from mcp_tpu_torch import SOLVED, SolverOptions, solve_batch
from mcp_tpu_torch.bench.flagships import masked_game_setup
from mcp_tpu_torch.kernels import cyclic_reduction as C
from mcp_tpu_torch.kernels import thomas as K1
from mcp_tpu_torch.kernels import thomas_babe as K7
from mcp_tpu_torch.kernels import thomas_dispatch as TD
from mcp_tpu_torch.kernels.solve_aug import FACTS
from mcp_tpu_torch.solver import BANDED_SOLVERS

torch.set_num_threads(1)

#: The JAX package's tiers whose solve is ``pallas_block_thomas``.
PALLAS_TIERS = tuple(t for t in jsolver._TRIDIAG_TIERS if t not in ("tridiag", "tridiag_cr"))
#: T = 64 sends every sweep tier to CR; b = 43..64 is the unpacked (padded)
#: route, which drops the factorization; b > 64 is wide-block CR.
GRID = [(T, b) for T in (2, 10, 19, 20, 30, 63, 64)
        for b in (8, 20, 33, 40, 42, 43, 50, 64, 65, 100)]


def _bands(B, T, b, seed):
    """Diagonally dominant random bands (K1's layout), as numpy."""
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((B, T, b, b)) + 6 * np.eye(b),
        0.3 * rng.standard_normal((B, T - 1, b, b)),
        0.3 * rng.standard_normal((B, T - 1, b, b)),
        rng.standard_normal((B, T, b)),
    )


def _t(arrs):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrs)


def test_every_jax_banded_tier_is_a_port_tier():
    assert set(jsolver._TRIDIAG_TIERS) <= set(BANDED_SOLVERS)
    assert set(PALLAS_TIERS) == set(TD.PALLAS_TIERS) | {"tridiag_auto"}


#: The port's kernel for each launcher of ``pallas_block_thomas`` and the
#: factorization it was handed: the lane-major sweep takes QR only and the
#: unpacked one-way sweep (K7b) drops the factorization.
def _port_name(route, fact):
    if route in ("lanes", "padded"):
        return "K1-qr"
    return {"packed": "K1", "babe": "K7a", "cr": "K3"}[route] + f"-{fact}"


def _jax_tier_route(tier, B, T, b, dtype):
    """The (launcher, factorization) the JAX tier's batched solve reaches: its
    custom_vmap batching rule (what ``vmap`` of the tier's solve runs) traced
    abstractly at batch B, nothing runs."""
    names = {"_pallas_block_thomas_cr": "cr", "_pallas_block_thomas_babe": "babe",
             "_pallas_block_thomas_lanes": "lanes", "_pallas_block_thomas_packed": "packed",
             "_pallas_block_thomas_padded": "padded"}
    seen, saved = [], {n: getattr(jtp, n) for n in names}

    def recorder(route):
        def impl(diag, lower_pad, upper_pad, rhs, batch_tile, interpret, fact="qr"):
            seen.append(_port_name(route, fact))
            return jnp.zeros(rhs.shape, rhs.dtype)
        return impl

    rule = jsolver._tridiag_algorithm(JaxOptions(linear_solver=tier), None).vmap_rule
    sds = lambda *s: jax.ShapeDtypeStruct(s, dtype)
    try:
        for n, route in names.items():
            setattr(jtp, n, recorder(route))
        jax.eval_shape(lambda *a: rule(B, [True] * 4, *a)[0], sds(B, T, b, b),
                       sds(B, T - 1, b, b), sds(B, T - 1, b, b), sds(B, T, b))
    finally:
        for n, fn in saved.items():
            setattr(jtp, n, fn)
    assert len(seen) == 1
    return seen[0]


@pytest.fixture
def port_route(monkeypatch):
    """Replace every kernel wrapper the dispatcher can reach by a recorder;
    returns route(tier, B, T, b, dtype) → "K1-gjp", "K7a-qr", "K3-gjbpr", …"""
    seen = []

    def recorder(name):
        def solve(diag, lower, upper, rhs, fact="qr"):
            seen.append(f"{name}-{fact}")
            return rhs
        return solve

    monkeypatch.setattr(TD, "thomas_solve", recorder("K1"))
    monkeypatch.setattr(TD, "babe_thomas_solve", recorder("K7a"))
    for fact in TD.CR_SOLVERS:
        monkeypatch.setitem(TD.CR_SOLVERS, fact, functools.partial(recorder("K3"), fact=fact))

    def route(tier, B, T, b, dtype):
        zero = torch.zeros((), dtype=dtype)
        BANDED_SOLVERS[tier](zero.expand(B, T, b, b), zero.expand(B, T - 1, b, b),
                             zero.expand(B, T - 1, b, b), zero.expand(B, T, b))
        assert len(seen) == 1
        return seen.pop()

    return route


@pytest.mark.parametrize("tier", PALLAS_TIERS)
def test_tier_route_matches_jax(tier, port_route):
    """Each tier's (kernel, factorization) over every (B, T, b) of the grid is
    the JAX package's: the one-way packed sweep and the two-way sweep keep
    the tier's factorization, the unpacked and lane-major sweeps run QR, and
    long chains and wide blocks go to cyclic reduction. The dtype enters the
    route only through the lane-major sweep's scratch gate (B ≥ 128), so
    float64 is checked there."""
    for dtype, jdtype, batches in ((torch.float32, jnp.float32, (1, 8, 127, 128, 256)),
                                   (torch.float64, jnp.float64, (128, 256))):
        for B in batches:
            for T, b in GRID:
                assert port_route(tier, B, T, b, dtype) == _jax_tier_route(
                    tier, B, T, b, jdtype), (B, T, b, dtype)


@pytest.mark.parametrize("tier, shape, want", [
    ("tridiag_pallas_gjpr", (256, 10, 20), "K1-gjpr"),  # the lane-change headline
    ("tridiag_pallas_gjp", (8, 30, 40), "K7a-gjp"),  # the N=4 flagship
    ("tridiag_pallas_gj", (8, 21, 20), "K7a-gj"),
    ("tridiag_pallas_gjp", (8, 10, 50), "K1-qr"),  # padded: the fact is dropped
    ("tridiag_pallas_gjpr", (8, 64, 20), "K3-gjpr"),  # long chain: CR keeps it
    ("tridiag_pallas_lanes", (8, 30, 40), "K1-qr"),
    ("tridiag_pallas_crgjbprl", (8, 30, 100), "K3-gjbprl"),
])
def test_tier_route_examples(tier, shape, want, port_route):
    assert port_route(tier, *shape, torch.float32) == want


@pytest.mark.parametrize("fact", K1.SWEEP_FACTS)
@pytest.mark.parametrize("T, b", [(1, 5), (5, 6), (4, 20)])
def test_one_way_sweep_plain_matches_jax(fact, T, b):
    """K1′: the packed one-way sweep with each factorization against the
    JAX package's ``_thomas_kernel_packed`` in interpret mode. 1e-10 of
    max|x|: the same eliminations in float64, summed in another order."""
    arrs = _bands(2, T, b, seed=10 * T + b)
    want = np.asarray(jtp.pallas_block_thomas(*(jnp.asarray(a) for a in arrs), mode="oneway",
                                              fact=fact, interpret=True))
    got = K1.thomas_solve(*_t(arrs), fact=fact).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * np.abs(want).max())


@pytest.mark.parametrize("fact", K1.SWEEP_FACTS)
@pytest.mark.parametrize("T", [20, 21])
def test_two_way_sweep_plain_matches_jax(fact, T):
    """K7a with each factorization in both chains and the junction against
    ``_thomas_kernel_babe`` in interpret mode; T = 21 puts the JAX package's
    identity pad block at the right chain's start, which the port skips (it
    solves to [C | d] = 0 under every factorization)."""
    arrs = _bands(2, T, 4, seed=T)
    want = np.asarray(jtp.pallas_block_thomas(*(jnp.asarray(a) for a in arrs), mode="babe",
                                              fact=fact, interpret=True))
    got = K7.babe_thomas_solve(*_t(arrs), fact=fact).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * np.abs(want).max())


@pytest.mark.parametrize("fact", FACTS)
def test_cyclic_reduction_plain_matches_jax(fact):
    """K3 with each factorization against ``_thomas_kernel_cr_packed`` in
    interpret mode (odd T: the identity pad; b = 6: one partial panel)."""
    arrs = _bands(2, 5, 6, seed=5)
    want = np.asarray(jtp.pallas_block_thomas(*(jnp.asarray(a) for a in arrs), mode="cr",
                                              fact=fact, interpret=True))
    got = C.cr_thomas_solve(*_t(arrs), fact=fact).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * np.abs(want).max())


@pytest.mark.parametrize("fact", ["gjbr", "gjbprl"])
def test_cyclic_reduction_two_panels_matches_jax(fact):
    """A full and a partial panel (b = 36 = 32 + 4) in every odd block."""
    arrs = _bands(2, 3, 36, seed=36)
    want = np.asarray(jtp.pallas_block_thomas(*(jnp.asarray(a) for a in arrs), mode="cr",
                                              fact=fact, interpret=True))
    got = C.cr_thomas_solve(*_t(arrs), fact=fact).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * np.abs(want).max())


def test_sweep_wrappers_refuse_other_facts_and_count_no_cpu_launch():
    arrs = _t(_bands(2, 4, 5, seed=1))
    before = (dict(K1.thomas_solve.launches), dict(K7.babe_thomas_solve.launches))
    for fact in K1.SWEEP_FACTS:
        K1.thomas_solve(*arrs, fact=fact)
        K7.babe_thomas_solve(*arrs, fact=fact)
    assert (K1.thomas_solve.launches, K7.babe_thomas_solve.launches) == before
    for wrapper in (K1.thomas_solve, K7.babe_thomas_solve):
        with pytest.raises(ValueError, match="fact"):
            wrapper(*arrs, fact="gjbpr")


def test_shared_memory_plans_per_fact():
    """One direction (K1) or two (K7a) of the sweep's working set per block:
    every factorization fits at the packed sweeps' b ≤ 42 in both dtypes;
    gjpr at b = 64 in float64 does not fit even one direction, and the
    wrappers refuse instead of falling back. K3's facts fit at b = 100 in
    both dtypes (column slabs over a cluster of CTAs), not at b = 300 in
    float64."""
    for fact in K1.SWEEP_FACTS:
        for dtype in (torch.float32, torch.float64):
            K1.check_fits(42, fact, dtype)
            K7.check_fits(42, dtype, fact)
    K1.check_fits(64, "gjp", torch.float64)
    with pytest.raises(ValueError, match="shared memory"):
        K1.check_fits(64, "gjpr", torch.float64)
    for fact in FACTS:
        C.check_fits(100, fact, torch.float32)
        C.check_fits(100, fact, torch.float64)
        with pytest.raises(ValueError, match="shared memory"):
            C.check_fits(300, fact, torch.float64)


MB, MN, MH = 2, 2, 20
MASKED_OPTS = dict(tol=1e-4, polish=True, tightening_rate=0.05)


def test_masked_game_on_gjp_runs_the_two_way_sweep_and_matches_jax(monkeypatch):
    """The masked N=2 game at horizon 20 (b = 20, T = 20, batch 2) on tier
    "tridiag_pallas_gjp": the port's route is the two-way sweep K7a with
    pivoted Gauss–Jordan blocks, whose plain version runs every Newton step.
    The JAX side runs tier "tridiag" (its Pallas two-way sweep in interpret
    mode inside the solver would compile for minutes): the same systems,
    solved exactly in float64, so status, outer iterations and x agree to
    rounding (1e-7)."""
    js = jax_setup(MB, MN, MH)
    ts = masked_game_setup(MB, MN, MH, device="cpu", dtype=torch.float64)
    thetas = np.asarray(js.thetas, dtype=np.float64)
    x0 = np.asarray(js.x0, dtype=np.float64)
    want = jax_solve_batch(js.mcp, jnp.asarray(thetas), x0=jnp.asarray(x0),
                           options=JaxOptions(linear_solver="tridiag", **MASKED_OPTS))
    facts, plain = [], K7.babe_solve_plain

    def counted(*args):
        facts.append(args[4])
        return plain(*args)

    monkeypatch.setattr(K7, "babe_solve_plain", counted)
    got = solve_batch(ts.mcp, torch.from_numpy(thetas), x0=torch.from_numpy(x0),
                      options=SolverOptions(linear_solver="tridiag_pallas_gjp", **MASKED_OPTS))
    assert facts and set(facts) == {"gjp"}
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(want.status))
    assert (got.status.numpy() == SOLVED).all()
    np.testing.assert_array_equal(got.outer_iters.numpy(), np.asarray(want.outer_iters))
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0, atol=1e-7)
