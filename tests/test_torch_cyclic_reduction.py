"""K3 (block cyclic reduction with the qr/gjp/gjpr factorizations) and the
tridiag_pallas and tridiag_auto dispatchers of the PyTorch port, held
against the JAX package on the same numpy inputs, in float64 on the CPU. The JAX in-block facts and
``_cr_solve`` are plain jnp code, called directly (as tests/test_tridiag.py
calls the facts); the route of ``pallas_block_thomas`` is read under
``jax.eval_shape`` with its kernel launchers replaced by recorders."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcp_tpu.kernels import thomas_pallas as jtp
from mcp_tpu.kernels.block_tridiag import banded_jac_mv as jax_banded_jac_mv
from mcp_tpu.kernels.block_tridiag import block_cyclic_reduction_solve as jax_bcr
from mcp_tpu_torch.kernels import cyclic_reduction as C
from mcp_tpu_torch.kernels import solve_aug as SA
from mcp_tpu_torch.kernels import thomas_dispatch as TD
from mcp_tpu_torch.kernels.block_tridiag import (
    TimeStructure,
    banded_jac_mv,
    block_cyclic_reduction_solve,
)
from mcp_tpu_torch.kernels.thomas import thomas_solve_plain
from mcp_tpu_torch.kernels.thomas_babe import babe_solve_plain
from mcp_tpu_torch.solver import BANDED_SOLVERS

torch.set_num_threads(1)

FACTS = ("qr", "gjp", "gjpr")
JAX_FACTS = {"gjp": jtp._gjp_solve_aug, "gjpr": jtp._gjpr_solve_aug}


def _adversarial_blocks(S, b, nrhs, seed):
    """[A | N] with a structural zero leading pivot and row scales spread
    over 10^±3 (the adversary of test_gjbp_pivoted_blocked_matches_unblocked)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((S, b, b))
    A[:, 0, 0] = 0.0
    A = A * 10.0 ** rng.uniform(-3, 3, (S, b, 1))
    return np.concatenate([A, rng.standard_normal((S, b, nrhs))], axis=2)


def _bands(B, T, b, seed):
    """Diagonally dominant random bands (K1's layout), as numpy."""
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((B, T, b, b)) + 6 * np.eye(b),
        0.3 * rng.standard_normal((B, max(T - 1, 0), b, b)),
        0.3 * rng.standard_normal((B, max(T - 1, 0), b, b)),
        rng.standard_normal((B, T, b)),
    )


def _t(arrs):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrs)


@pytest.mark.parametrize("fact", ["gjp", "gjpr"])
@pytest.mark.parametrize("b, nrhs", [(4, 1), (20, 5), (40, 121 - 40)])
def test_pivoted_gauss_jordan_matches_jax(fact, b, nrhs):
    # 1e-10 relative: the same elimination (pivot order included) in float64;
    # the two differ only where XLA and PyTorch round the head contraction
    # and the refinement products differently.
    M = _adversarial_blocks(3, b, nrhs, seed=b + nrhs)
    want = np.asarray(JAX_FACTS[fact](jnp.asarray(M), b=b))
    got = C.solve_aug_plain(torch.from_numpy(M), b, fact).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * np.abs(want).max())
    # And it is a solve: the pivoted elimination survives the zero pivot.
    X = np.linalg.solve(M[:, :, :b], M[:, :, b:])
    np.testing.assert_allclose(got, X, rtol=0, atol=1e-8 * np.abs(X).max())


def test_gjp_first_row_wins_ties():
    """Equal |entries| in the pivot column: the lowest unused row is the
    pivot in both packages (row 0 here, though row 1 ties with it)."""
    A = np.array([[[1.0, 2.0], [-1.0, 3.0]]])
    M = np.concatenate([A, np.array([[[1.0], [2.0]]])], axis=2)
    want = np.asarray(jtp._gjp_solve_aug(jnp.asarray(M), b=2))
    got = SA.gjp_solve_aug_plain(torch.from_numpy(M), 2).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)
    np.testing.assert_allclose(got[0, :, 0], np.linalg.solve(A[0], [1.0, 2.0]))


@pytest.mark.parametrize("fact", FACTS)
@pytest.mark.parametrize("T", [1, 2, 3, 5, 6, 8, 13])
@pytest.mark.parametrize("b", [8, 40])
def test_cr_solve_plain_matches_jax(fact, T, b):
    """Odd T pads, H = 1 levels and the T = 1 base, per factorization."""
    diag, lower, upper, rhs = _bands(2, T, b, seed=10 * T + b)
    z = np.zeros((2, 1, b, b))
    want = np.asarray(jtp._cr_solve(
        jnp.asarray(diag), jnp.asarray(np.concatenate([z, lower], 1)),
        jnp.asarray(np.concatenate([upper, z], 1)), jnp.asarray(rhs[..., None]),
        b=b, fact=fact,
    ))[..., 0]
    got = C.cr_solve_plain(*_t((diag, lower, upper, rhs)), fact).numpy()
    # 1e-10 of max|x|: the b=40 blocks (+6I on a standard normal) are far
    # from diagonally dominant, so the two packages' rounding shows at ~1e-13.
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * np.abs(want).max())


@pytest.mark.parametrize("T", [1, 2, 3, 5, 8, 13])
def test_block_cyclic_reduction_matches_jax(T):
    arrs = _bands(3, T, 6, seed=T)
    want = np.asarray(jax.vmap(jax_bcr)(*(jnp.asarray(a) for a in arrs)))
    got = block_cyclic_reduction_solve(*_t(arrs)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    # Shared (batch-stride 0) bands, as the affine-band games pass them.
    diag, lower, upper, rhs = _t(arrs)
    if T > 1:
        shared = block_cyclic_reduction_solve(
            diag, lower[:1].expand_as(lower), upper[:1].expand_as(upper), rhs)
        ref = block_cyclic_reduction_solve(diag, lower[:1].repeat(3, 1, 1, 1),
                                           upper[:1].repeat(3, 1, 1, 1), rhs)
        torch.testing.assert_close(shared, ref, rtol=0, atol=1e-14)


def test_wrapper_on_cpu_is_the_plain_version_and_counts_no_launch():
    diag, lower, upper, rhs = _t(_bands(4, 7, 5, seed=3))
    before = dict(C.cr_thomas_solve.launches)
    for fact in FACTS:
        torch.testing.assert_close(C.cr_thomas_solve(diag, lower, upper, rhs, fact=fact),
                                   C.cr_solve_plain(diag, lower, upper, rhs, fact),
                                   rtol=0, atol=0)
        shared = C.cr_thomas_solve(diag, lower[:1].expand(4, -1, -1, -1),
                                   upper[:1].expand(4, -1, -1, -1), rhs, fact=fact)
        ref = C.cr_solve_plain(diag, lower[:1].repeat(4, 1, 1, 1),
                               upper[:1].repeat(4, 1, 1, 1), rhs, fact)
        torch.testing.assert_close(shared, ref, rtol=0, atol=0)
    assert C.cr_thomas_solve.launches == before
    with pytest.raises(ValueError, match="fact"):
        C.cr_thomas_solve(diag, lower, upper, rhs, fact="lu")
    with pytest.raises(ValueError, match="lower"):
        C.cr_thomas_solve(diag, lower[:, :2], upper, rhs)


def test_shared_memory_plan_refuses_what_a_block_cannot_hold():
    """The card's kernel splits each odd-block solve over a cluster of at
    most 8 CTAs, each holding a column slab in its shared memory: the
    flagship shapes fit in both dtypes, b=100 in float64 included; b=300 in
    float64 does not fit even in slabs of a cluster of 8, and the wrapper
    refuses it instead of falling back."""
    for b, fact, dtype in ((40, "gjp", torch.float32), (40, "gjp", torch.float64),
                           (40, "gjpr", torch.float64), (100, "gjpr", torch.float32),
                           (100, "qr", torch.float32), (20, "qr", torch.float64)):
        C.check_fits(b, fact, dtype)
    for fact in FACTS:
        C.check_fits(100, fact, torch.float64)
        with pytest.raises(ValueError, match="shared memory"):
            C.check_fits(300, fact, torch.float64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("fact", SA.FACTS)
@pytest.mark.parametrize("b", [20, 40, 50, 60, 64, 100])
def test_cluster_plan_covers_every_column_and_fits(b, fact, dtype):
    """K3's launch plan at the block sizes the routes reach (the lane change
    b=20, N=4 b=40, the padded sweeps' 50-64, N=10 b=100), at the flagship
    (8, 30), the path-B (256, 10) and the T=64 (1, 64) shapes: per level and
    for the base a cluster of 1, 2, 4 or 8 CTAs of 256 threads on a grid of
    one cluster per solve, slab bounds that cover every column of the
    working matrix exactly once, a slab that fits 232,448 bytes of shared
    memory with the layout of ``csrc/solve_aug_slab.cuh``, and for the
    blocked facts no panel of 32 head columns split between two slabs."""
    family, refine = SA.FACT_CODES[fact]
    itemsize = torch.empty((), dtype=dtype).element_size()
    for B, T in ((8, 30), (256, 10), (1, 64)):
        plan = C.cr_plan(B, T, b, fact, dtype)
        shapes = C._level_shapes(T)
        assert len(plan.levels) == len(shapes)
        ld_red, ld_base = 3 * b + 1 + (b if refine else 0), b + 1 + (b if refine else 0)
        for lp, ld, nsys in zip(plan.launches, [ld_red] * len(shapes) + [ld_base],
                                [H * B for H in shapes] + [B]):
            assert lp.cluster in (1, 2, 4, 8) and lp.threads == 256 and lp.grid == nsys
            assert (lp.cluster * lp.grid) % lp.cluster == 0
            assert len(lp.bounds) == lp.cluster + 1
            cover = [c for lo, hi in zip(lp.bounds, lp.bounds[1:]) for c in range(lo, hi)]
            assert cover == list(range(ld))
            wsmax = max(hi - lo for lo, hi in zip(lp.bounds, lp.bounds[1:]))
            assert lp.smem_per_cta == C.slab_smem_bytes(b, wsmax, family, refine, itemsize)
            assert lp.smem_per_cta <= 232448
            if family >= 3:
                owner = lambda c: sum(lo <= c for lo in lp.bounds[1:-1])
                for k0 in range(0, b, SA.GJB_PANEL):
                    assert owner(k0) == owner(min(k0 + SA.GJB_PANEL, b) - 1)


@pytest.mark.parametrize("fact", FACTS)
@pytest.mark.parametrize("kind", ["zero row and column", "zero block"])
def test_singular_block_fails_only_its_system(fact, kind):
    """A singular odd block. QR divides by its zero pivot: inf/NaN in that
    system. Gauss–Jordan clamps the pivot to 1e-30 and then contracts with
    the head, whose column of the missing pivot is zero: finite values, the
    same in both packages. The other system is untouched either way."""
    diag, lower, upper, rhs = _bands(2, 4, 6, seed=9)
    diag = diag.copy()
    if kind == "zero block":
        diag[1, 1] = 0.0
    else:
        diag[1, 1, :, 2] = 0.0
        diag[1, 1, 2, :] = 0.0
    got = C.cr_solve_plain(*_t((diag, lower, upper, rhs)), fact).numpy()
    z = np.zeros((2, 1, 6, 6))
    want = np.asarray(jtp._cr_solve(
        jnp.asarray(diag), jnp.asarray(np.concatenate([z, lower], 1)),
        jnp.asarray(np.concatenate([upper, z], 1)), jnp.asarray(rhs[..., None]),
        b=6, fact=fact))[..., 0]
    assert np.isfinite(got[0]).all() and np.isfinite(want[0]).all()
    if fact == "qr":
        assert not np.isfinite(got[1]).all() and not np.isfinite(want[1]).all()
        got, want = got[0], want[0]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def _jax_route(B, T, b, dtype, mode, fact):
    """Which launcher pallas_block_thomas calls for these shapes (traced
    abstractly, nothing runs)."""
    names = {"_pallas_block_thomas_cr": "cr", "_pallas_block_thomas_babe": "babe",
             "_pallas_block_thomas_lanes": "lanes", "_pallas_block_thomas_packed": "packed",
             "_pallas_block_thomas_padded": "padded"}
    seen, saved = [], {n: getattr(jtp, n) for n in names}

    def recorder(route):
        def impl(diag, lower_pad, upper_pad, rhs, batch_tile, interpret, fact="qr"):
            seen.append(route)
            return jnp.zeros(rhs.shape, rhs.dtype)
        return impl

    try:
        for n, route in names.items():
            setattr(jtp, n, recorder(route))
        sds = lambda *s: jax.ShapeDtypeStruct(s, dtype)
        jax.eval_shape(
            lambda d, lo, up, r: jtp.pallas_block_thomas(d, lo, up, r, mode=mode, fact=fact),
            sds(B, T, b, b), sds(B, T - 1, b, b), sds(B, T - 1, b, b), sds(B, T, b),
        )
    finally:
        for n, fn in saved.items():
            setattr(jtp, n, fn)
    assert len(seen) == 1
    return seen[0]


GRID = [(T, b) for T in (2, 10, 19, 20, 30, 63, 64, 70)
        for b in (8, 20, 32, 33, 40, 42, 43, 48, 64, 65, 100)]


def test_auto_route_grid_reaches_every_branch():
    routes = {TD.kernel_mode(B, T, b, 4, *TD.auto_pick(B, T, b))
              for B in (1, 8, 127, 128, 256) for T, b in GRID}
    assert routes == {"cr", "lanes", "babe", "packed", "padded"}


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
@pytest.mark.parametrize("B", [1, 8, 127, 128, 256])
def test_auto_route_matches_jax(B, dtype):
    """_auto_pick and the sweep-mode choice over a grid that reaches every
    branch: CR (wide blocks, long chains, mid blocks at small batch), the
    lane-major sweep and its scratch gate, the two-way sweep, and the packed
    and unpacked one-way sweeps."""
    itemsize = jnp.dtype(dtype).itemsize
    for T, b in GRID:
        pick = TD.auto_pick(B, T, b)
        assert pick == jtp._auto_pick(B, T, b)
        assert TD.kernel_mode(B, T, b, itemsize, *pick) == _jax_route(B, T, b, dtype, *pick), (
            B, T, b)
    # An explicit mode and fact, as the fixed tiers ask for them.
    for T, b, mode, fact in ((1, 8, "babe", "qr"), (30, 40, None, "gjp"), (10, 20, "cr", "qr")):
        assert TD.kernel_mode(B, T, b, itemsize, mode, fact) == _jax_route(
            B, T, b, dtype, mode, fact)


def _tier_routes(monkeypatch):
    """Replace the kernel wrappers the dispatcher can reach by recorders;
    returns (seen, route of one call of a tier's solve at (B, T, b))."""
    seen = []

    def recorder(name):
        def solve(diag, lower, upper, rhs):
            seen.append(name)
            return rhs
        return solve

    monkeypatch.setattr(TD, "thomas_solve", recorder("K1"))
    monkeypatch.setattr(TD, "babe_thomas_solve", recorder("K7a"))
    for fact in TD.CR_SOLVERS:
        monkeypatch.setitem(TD.CR_SOLVERS, fact, recorder(f"K3-{fact}"))

    def route(tier, B, T, b, dtype):
        zero = torch.zeros((), dtype=dtype)
        BANDED_SOLVERS[tier](zero.expand(B, T, b, b), zero.expand(B, T - 1, b, b),
                             zero.expand(B, T - 1, b, b), zero.expand(B, T, b))
        return seen.pop()

    return route


#: The port's kernel for each launcher of ``pallas_block_thomas``: the
#: lane-major, packed and unpacked (K7b) one-way sweeps are K1's algebra.
PORT_KERNEL = {"babe": "K7a", "lanes": "K1", "packed": "K1", "padded": "K1"}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B", [1, 8, 127, 128, 256])
def test_pallas_tier_route_matches_jax(B, dtype, monkeypatch):
    """Tier "tridiag_pallas" dispatches every (B, T, b) of the grid to the
    counterpart of the launcher the JAX package's ``thomas_solve`` (mode
    None, fact "qr") reaches."""
    route = _tier_routes(monkeypatch)
    jdtype = {torch.float32: jnp.float32, torch.float64: jnp.float64}[dtype]
    for T, b in GRID:
        want = _jax_route(B, T, b, jdtype, None, "qr")
        assert route("tridiag_pallas", B, T, b, dtype) == PORT_KERNEL.get(want, "K3-qr"), (
            B, T, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B", [1, 8, 127, 128, 256])
def test_auto_tier_route_matches_jax(B, dtype, monkeypatch):
    """Tier "tridiag_auto" likewise, with ``_auto_pick``'s mode and fact."""
    route = _tier_routes(monkeypatch)
    jdtype = {torch.float32: jnp.float32, torch.float64: jnp.float64}[dtype]
    for T, b in GRID:
        mode, fact = jtp._auto_pick(B, T, b)
        want = _jax_route(B, T, b, jdtype, mode, fact)
        assert route("tridiag_auto", B, T, b, dtype) == PORT_KERNEL.get(want, f"K3-{fact}"), (
            B, T, b)


@pytest.mark.parametrize("shape, kernel", [((8, 20, 20), "K7a"), ((128, 30, 64), "K1")])
def test_auto_routes_to_unported_sweeps_raise(shape, kernel, monkeypatch):
    """The two shapes whose routes once raised NotImplementedError (the
    two-way sweep K7a, and the unpacked one-way sweep K7b, which is K1's
    algebra) now reach babe_thomas_solve and K1; the tier raises on no
    route any more."""
    B, T, b = shape
    assert _tier_routes(monkeypatch)("tridiag_auto", B, T, b, torch.float32) == kernel
    monkeypatch.undo()
    arrs = _t(_bands(2, T, b, seed=b))
    want = (babe_solve_plain if kernel == "K7a" else thomas_solve_plain)(*arrs)
    torch.testing.assert_close(TD.route_solver(B, T, b, 8, *TD.auto_pick(B, T, b))(*arrs),
                               want, rtol=0, atol=0)


@pytest.mark.parametrize("shape, fact", [((2, 6, 40), "gjp"), ((2, 5, 65), "gjpr"),
                                         ((2, 64, 4), "qr")])
def test_auto_cr_routes_solve_as_the_picked_fact(shape, fact):
    B, T, b = shape
    arrs = _t(_bands(B, T, b, seed=b))
    assert TD.auto_pick(B, T, b) == ("cr", fact)
    torch.testing.assert_close(TD.auto_thomas_solve(*arrs), C.cr_solve_plain(*arrs, fact),
                               rtol=0, atol=0)


def test_auto_sweep_route_is_k1():
    arrs = _t(_bands(128, 10, 20, seed=1))
    assert TD.kernel_mode(128, 10, 20, 8, *TD.auto_pick(128, 10, 20)) == "lanes"
    torch.testing.assert_close(TD.auto_thomas_solve(*arrs), thomas_solve_plain(*arrs),
                               rtol=0, atol=0)


@pytest.mark.parametrize("shared", [False, True])
def test_banded_jac_mv_matches_jax(shared):
    T, b, mt, B = 4, 3, 2, 3
    n, m = T * b, T * mt
    rng = np.random.default_rng(5 + shared)
    st = TimeStructure(tuple(int(i) for i in rng.permutation(n)), T, b,
                       tuple(int(i) for i in rng.permutation(m)), mt)
    diag = rng.standard_normal((B, T, b, b))
    lower = rng.standard_normal((T - 1, b, b) if shared else (B, T - 1, b, b))
    upper = rng.standard_normal((T - 1, b, b) if shared else (B, T - 1, b, b))
    Gy, Hx = rng.standard_normal((B, T, b, mt)), rng.standard_normal((B, T, mt, b))
    y, s, dy, ds = (rng.standard_normal((B, m)) for _ in range(4))
    dx = rng.standard_normal((B, n))
    lo_ax = None if shared else 0
    want = jax.vmap(
        lambda d, lo, up, gy, hx, y_, s_, dx_, dy_, ds_: jax_banded_jac_mv(
            d, lo, up, gy, hx, y_, s_, dx_, dy_, ds_, st),
        in_axes=(0, lo_ax, lo_ax, 0, 0, 0, 0, 0, 0, 0),
    )(*(jnp.asarray(a) for a in (diag, lower, upper, Gy, Hx, y, s, dx, dy, ds)))
    got = banded_jac_mv(*_t((diag, lower, upper, Gy, Hx, y, s, dx, dy, ds)), st)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-12)
