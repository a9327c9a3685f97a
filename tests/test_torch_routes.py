"""The launch plans of K1/K1′ (``thomas.thomas_plan``: the "warp" route, one
warp per system with the working matrix in registers, or the "block" route)
and of K4a/K5 (``linear_solve.gj_plan``: the "tile" route, the n + 1 slots
of [A | b] in registers over an 8 × 32 thread grid, or the "block" route):
the route per shape and dtype as a table written out by hand, the plans'
constants against the kernel sources, the C entries' own checks of a plan,
and the refusals. The kernels run only on the card; here the plans are
plain functions of the shapes, and the tile route's in-place inverse (slot
k turns from column k of A into identity column k at step k) is modelled op
by op in PyTorch and held bit for bit against K5's plain version, which the
JAX package's own kernel is held against in ``test_torch_linear_solve.py``."""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcp_tpu.kernels.linear_solve import pallas_gji_lanes_solve
from mcp_tpu_torch.kernels import linear_solve as L
from mcp_tpu_torch.kernels import thomas as K1

torch.set_num_threads(1)

F32, F64 = torch.float32, torch.float64
FACTS = ("qr", "gj", "gjp", "gjpr")
CSRC = pathlib.Path(K1.__file__).parent / "csrc"
REFUSED = "refused"


# -- the route tables --------------------------------------------------------

#: K1: the largest b on the warp route per (dtype, fact). float64 doubles
#: the register tile: 32 rows are over the budget in every fact, and so are
#: gjpr's 24 rows (three column groups of [A | N | I]).
WARP_UP_TO = {(F32, f): 32 for f in FACTS} | {(F64, "qr"): 24, (F64, "gj"): 24,
                                              (F64, "gjp"): 24, (F64, "gjpr"): 16}
#: The warp route's row template at b.
WARP_ROWS_AT = {1: 8, 8: 8, 9: 16, 16: 16, 17: 24, 20: 24, 24: 24, 25: 32, 32: 32}


def _thomas_cases():
    for dtype in (F32, F64):
        for fact in FACTS:
            for b in (*WARP_ROWS_AT, 33, 50, 64):
                if b <= WARP_UP_TO[dtype, fact]:
                    want = ("warp", WARP_ROWS_AT[b])
                elif (dtype, fact, b) == (F64, "gjpr", 64):
                    want = REFUSED  # over one block's shared memory
                else:
                    want = ("block", 0)
                yield pytest.param(b, fact, dtype, want, id=f"{str(dtype)[6:]}-{fact}-b{b}")


@pytest.mark.parametrize("b, fact, dtype, want", list(_thomas_cases()))
def test_thomas_plan_route_table(b, fact, dtype, want):
    if want == REFUSED:
        with pytest.raises(ValueError, match=rf"fact='{fact}' at b={b} in {dtype} needs \d+ "
                                             r"bytes of shared memory, over the card's 232448"):
            K1.thomas_plan(b, fact, dtype)
        return
    plan = K1.thomas_plan(b, fact, dtype)
    assert (plan.route, plan.rows) == want
    assert K1.thomas_plan(b, fact, dtype, route="block") == K1.ThomasPlan("block", 0)
    if plan.route == "block" and b <= 32:
        with pytest.raises(ValueError, match="warp route does not take"):
            K1.thomas_plan(b, fact, dtype, route="warp")


#: K4a/K5: the tile route's rows per thread at n (every n ≤ 128 in both
#: dtypes); above it, the block route where [A | b (| I)] fits a block's
#: shared memory.
TILE_ROWS_AT = {1: 2, 12: 2, 16: 2, 17: 4, 100: 14, 112: 14, 113: 16, 128: 16}
BLOCK_FITS = {(129, False, F32), (129, True, F32), (129, False, F64), (200, False, F32)}


def _gj_cases():
    for dtype in (F32, F64):
        for inverse in (False, True):
            for n in (*TILE_ROWS_AT, 129, 200):
                if n in TILE_ROWS_AT:
                    want = ("tile", TILE_ROWS_AT[n])
                else:
                    want = ("block", 0) if (n, inverse, dtype) in BLOCK_FITS else REFUSED
                yield pytest.param(n, inverse, dtype, want,
                                   id=f"{str(dtype)[6:]}-{'gji' if inverse else 'gj'}-n{n}")


@pytest.mark.parametrize("n, inverse, dtype, want", list(_gj_cases()))
def test_gj_plan_route_table(n, inverse, dtype, want):
    name = "gji_solve" if inverse else "gj_solve"
    if want == REFUSED:
        with pytest.raises(ValueError, match=rf"{name}: n={n} in {dtype} needs \d+ bytes of "
                                             r"shared memory"):
            L.gj_plan(n, inverse, dtype)
        return
    plan = L.gj_plan(n, inverse, dtype)
    assert (plan.route, plan.rows) == want
    if (n, inverse, dtype) == (128, True, F64):
        # The forced block route: [A | b | I] at n=128 is over a block's
        # shared memory in float64 (the block route takes gji up to n=119).
        with pytest.raises(ValueError, match="gji_solve: n=128 .* shared memory"):
            L.gj_plan(n, inverse, dtype, route="block")
    elif n <= 128:
        assert L.gj_plan(n, inverse, dtype, route="block") == L.GJPlan("block", 0)
    else:
        with pytest.raises(ValueError, match=f"tile route does not take n={n}"):
            L.gj_plan(n, inverse, dtype, route="tile")


# -- the plans against the kernel sources -------------------------------------


def _source_ints(name, pattern):
    """Every integer that ``pattern``'s groups capture in ``csrc/name``."""
    found = re.findall(pattern, (CSRC / name).read_text())
    return tuple(int(v) for m in found for v in (m if isinstance(m, tuple) else (m,)))


@pytest.mark.parametrize("python, source, pattern", [
    (K1.WARP_REGS, "thomas.cu", r"constexpr int kWarpRegs = (\d+);"),
    (K1.WARP_ROWS, "thomas.cu", r"case (\d+): return launch_warp<"),
    (L.TILE_REGS, "gauss_jordan.cu", r"constexpr int kTileRegs = (\d+);"),
    (L.TILE_GRID, "gauss_jordan.cu", r"constexpr int kTY = (\d+), kTX = (\d+);"),
    (L.TILE_ROWS, "gauss_jordan.cu", r"case (\d+): return launch_tile<"),
], ids=["kWarpRegs", "warp-rows", "kTileRegs", "tile-grid", "tile-rows"])
def test_plan_constants_are_the_kernels_own(python, source, pattern):
    assert _source_ints(source, pattern) == (python if isinstance(python, tuple) else (python,))


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("fact", FACTS)
def test_every_warp_plan_passes_the_c_entrys_checks(dtype, fact):
    # mcp_thomas_solve: rows is one of dispatch_warp's templates and b ≤ rows.
    rows = _source_ints("thomas.cu", r"case (\d+): return launch_warp<")
    for b in range(1, 65):
        plan = K1.thomas_plan(b, fact, dtype) if (dtype, fact, b) != (F64, "gjpr", 64) \
            else K1.ThomasPlan("block", 0)
        assert plan.route == ("warp" if b <= WARP_UP_TO[dtype, fact] else "block")
        if plan.route == "warp":
            assert plan.rows in rows and 1 <= b <= plan.rows
            assert plan.rows == min(r for r in rows if r >= b)


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("inverse", [False, True])
def test_every_tile_plan_covers_its_matrix_exactly_once(dtype, inverse):
    # launch_tile's check (n ≤ TY·R, n + 1 ≤ TX·C, C = (TY·R + TX)/TX), and
    # thread (ty, tx) holding rows ty + TY·r and slots tx + TX·c gives every
    # element of the n × (n + 1) slots of [A | b] exactly one owner.
    ty_n, tx_n = _source_ints("gauss_jordan.cu", r"constexpr int kTY = (\d+), kTX = (\d+);")
    for n in range(1, 129):
        plan = L.gj_plan(n, inverse, dtype)
        cols = (ty_n * plan.rows + tx_n) // tx_n
        assert plan.route == "tile" and n <= ty_n * plan.rows and n + 1 <= tx_n * cols
        if n in (1, 12, 31, 32, 100, 128):
            i = np.add.outer(np.arange(ty_n), ty_n * np.arange(plan.rows)).ravel()
            j = np.add.outer(np.arange(tx_n), tx_n * np.arange(cols)).ravel()
            count = np.zeros((n, n + 1), dtype=int)
            np.add.at(count, np.ix_(i[i < n], j[j <= n]), 1)
            assert (count == 1).all()


def test_refusals_keep_their_messages():
    # b=65: the sweep's own range, in the wrapper and in the plan alike.
    diag = torch.zeros((1, 2, 65, 65))
    lower = upper = torch.zeros((1, 1, 65, 65))
    with pytest.raises(ValueError, match="takes blocks up to b=64, got b=65"):
        K1.thomas_solve(diag, lower, upper, torch.zeros((1, 2, 65)))
    with pytest.raises(ValueError, match="takes blocks up to b=64, got b=65"):
        K1.thomas_plan(65, "qr", F32)
    with pytest.raises(ValueError, match="route must be one of"):
        K1.thomas_plan(20, "qr", F32, route="lanes")
    with pytest.raises(ValueError, match="fact must be one of"):
        K1.thomas_plan(20, "gjb", F32)
    with pytest.raises(ValueError, match="route must be one of"):
        L.gj_plan(100, False, F32, route="warp")


# -- the tile route's in-place inverse, op by op ----------------------------


def _tile_model(A, b, inverse):
    """The tile route's elimination on the n + 1 slots of [A | b], one
    PyTorch op per rounded device op: at step k, 1/p from the pivot
    M[k][k], f_i = M[i][k]·(1/p), row k ← row k·(1/p), every other row i ←
    M_i − f_i·(row k) on the live slots (K4a: right of the pivot; K5: every
    slot, slot k reset to identity column k first, its row-k entry 1)."""
    B, n, _ = A.shape
    M = torch.cat([A, b[:, :, None]], dim=2).clone()
    slots = torch.arange(n + 1)
    for k in range(n):
        col = M[:, :, k].clone()
        rk = M[:, k, :].clone()
        p = col[:, k]
        ik = 1.0 / torch.where(p.abs() > 1e-30, p, torch.full_like(p, 1e-30))
        if inverse:
            M[:, :, k] = 0.0
            rk[:, k] = 1.0
        f = col * ik[:, None]
        new = M - f[:, :, None] * rk[:, None, :]
        new[:, k, :] = rk * ik[:, None]
        live = slots >= 0 if inverse else slots > k
        M = torch.where(live[None, None, :], new, M)
    return M[:, :, n], M[:, :, :n]


def _spd(B, n, dtype, seed):
    rng = np.random.default_rng(seed)
    P = rng.standard_normal((B, n, n))
    A = P @ P.transpose(0, 2, 1) + n * np.eye(n)
    return (torch.from_numpy(A.astype(dtype)),
            torch.from_numpy(rng.standard_normal((B, n)).astype(dtype)))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", [1, 12, 33])
def test_tile_model_equals_the_plain_versions_bit_for_bit(dtype, n):
    A, b = _spd(3, n, dtype, 80 + n)
    A[1, 0, :] = 0.0  # a zero pivot: huge finite values in system 1
    A[1, :, 0] = 0.0
    x, inv = _tile_model(A, b, inverse=True)
    xp, invp = L.gji_solve_plain(A, b)
    assert torch.equal(x, xp) and torch.equal(inv, invp)
    x4, _ = _tile_model(A, b, inverse=False)
    assert torch.equal(x4, L.gj_solve_plain(A, b))
    # ... and within K5's parity bound of the JAX package's kernel on the
    # regular systems (tests/test_torch_linear_solve.py's tolerances).
    ok = [0, 2]
    want_x, want_inv = (np.asarray(a) for a in pallas_gji_lanes_solve(
        jnp.asarray(A[ok].numpy()), jnp.asarray(b[ok].numpy())))
    tol = {np.float32: 1e-5, np.float64: 1e-12}[dtype]
    np.testing.assert_allclose(x[ok].numpy(), want_x, rtol=0, atol=tol)
    np.testing.assert_allclose(inv[ok].numpy(), want_inv, rtol=0, atol=tol)
