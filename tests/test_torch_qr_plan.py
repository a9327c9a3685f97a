"""The launch plans of K4b/K4c (``linear_solve.qr_plan``: the "pair" route,
lanes 2c and 2c + 1 holding column c of [A | b] in registers, or the
"block" route) and of K6 (``thomas_multi.multi_plan``: the "group" route,
one thread per column of the step's working matrix in registers, or the
"block" route): the route per shape and dtype as a table written out by
hand, the forced routes and the refusals, the plans' constants against the
kernel sources, and the horizon rank worker's launch counts per K6 route.
The kernels run only on the card; here the plans are plain functions of
the shapes, and the pair route's summation order (each half-column's sums in
four partial sums, joined across the pair; the back substitution column by
column with 1/R[k][k]) is modelled in numpy and held against the plain
version and the JAX package's kernel (interpret mode, as
``test_torch_linear_solve.py`` runs it)."""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcp_tpu.kernels.linear_solve import pallas_qr_solve_fused
from mcp_tpu_torch.bench import horizon as worker
from mcp_tpu_torch.kernels import linear_solve as L
from mcp_tpu_torch.kernels import thomas_multi as K6

torch.set_num_threads(1)

F32, F64 = torch.float32, torch.float64
CSRC = pathlib.Path(L.__file__).parent / "csrc"
REFUSED = "refused"


# -- the route tables --------------------------------------------------------

#: K4b/K4c: the pair route's rows per thread at n (every n ≤ 127 in float32:
#: n + 1 columns on 128 lane pairs; in float64 up to n = 104, 2 · 52 rows:
#: 64 rows of doubles are over the register budget); above it the block
#: route where [A | b] fits a block's shared memory.
PAIR_ROWS_AT = {1: 8, 5: 8, 12: 8, 16: 8, 17: 16, 32: 16, 33: 24, 48: 24, 49: 32, 64: 32,
                65: 40, 80: 40, 81: 48, 96: 48, 97: 52, 100: 52, 104: 52, 105: 64, 127: 64}
PAIR_UP_TO = {F32: 127, F64: 104}
QR_BLOCK_FITS = {(105, F64), (127, F64), (128, F32), (128, F64), (129, F32), (129, F64),
                 (200, F32)}


def _qr_cases():
    for dtype in (F32, F64):
        for n in (*PAIR_ROWS_AT, 128, 129, 200):
            if n <= PAIR_UP_TO[dtype]:
                want = ("pair", PAIR_ROWS_AT[n])
            else:
                want = ("block", 0) if (n, dtype) in QR_BLOCK_FITS else REFUSED
            yield pytest.param(n, dtype, want, id=f"{str(dtype)[6:]}-n{n}")


@pytest.mark.parametrize("n, dtype, want", list(_qr_cases()))
def test_qr_plan_route_table(n, dtype, want):
    if want == REFUSED:
        with pytest.raises(ValueError, match=rf"gauss_solve: n={n} in {dtype} needs \d+ bytes "
                                             r"of shared memory, over the card's 232448"):
            L.qr_plan(n, dtype)
        return
    plan = L.qr_plan(n, dtype)
    assert (plan.route, plan.rows) == want
    assert L.qr_plan(n, dtype, route="block") == L.QRPlan("block", 0)
    if plan.route == "block":
        with pytest.raises(ValueError, match=f"pair route does not take n={n}"):
            L.qr_plan(n, dtype, route="pair")
    else:
        assert L.qr_plan(n, dtype, route="pair") == plan


#: K6: the group route's row template at (b, k) where it takes the shape
#: (2b + k ≤ 256 columns, b ≤ 48, the tiles within a block's shared memory;
#: float64 (48, 160) is over it), else the block route; float64 b=64, k=193
#: fits neither (the block route's refusal).
MULTI_TABLE = {
    (1, 1): ("group", 8), (4, 9): ("group", 8), (8, 17): ("group", 8),
    (9, 19): ("group", 16), (20, 41): ("group", 24), (24, 49): ("group", 24),
    (32, 64): ("group", 32), (40, 81): ("group", 40), (48, 1): ("group", 48),
    (48, 160): ("group", 48), (49, 1): ("block", 0), (20, 217): ("block", 0),
    (64, 193): ("block", 0),
}
MULTI_F64 = {(48, 160): ("block", 0), (64, 193): REFUSED}


def _multi_cases():
    for dtype in (F32, F64):
        for (b, k), want in MULTI_TABLE.items():
            if dtype == F64:
                want = MULTI_F64.get((b, k), want)
            yield pytest.param(b, k, dtype, want, id=f"{str(dtype)[6:]}-b{b}-k{k}")


@pytest.mark.parametrize("b, k, dtype, want", list(_multi_cases()))
def test_multi_plan_route_table(b, k, dtype, want):
    if want == REFUSED:
        with pytest.raises(ValueError, match=rf"thomas_solve_multi: fact='qr' at b={b}, k={k} "
                                             rf"in {dtype} needs \d+ bytes of shared memory"):
            K6.multi_plan(b, k, dtype)
        return
    plan = K6.multi_plan(b, k, dtype)
    assert (plan.route, plan.rows) == want
    assert K6.multi_plan(b, k, dtype, route="block") == K6.MultiPlan("block", 0)
    if plan.route == "block":
        with pytest.raises(ValueError, match=f"group route does not take b={b}, k={k}"):
            K6.multi_plan(b, k, dtype, route="group")
    else:
        assert K6.multi_plan(b, k, dtype, route="group") == plan


def test_refusals_keep_their_messages():
    with pytest.raises(ValueError, match="qr_plan: route must be one of"):
        L.qr_plan(100, F32, route="tile")
    with pytest.raises(ValueError, match="multi_plan: route must be one of"):
        K6.multi_plan(20, 41, F32, route="warp")
    # The wrapper's own refusals are unchanged (tests/test_torch_thomas_multi.py).
    diag = torch.zeros((1, 2, 64, 64), dtype=F64)
    band = torch.zeros((1, 1, 64, 64), dtype=F64)
    with pytest.raises(ValueError, match="fact"):
        K6.thomas_solve_multi(diag, band, band, torch.zeros((1, 2, 64, 3), dtype=F64),
                              fact="gjp")


def test_cpu_tensors_take_the_plain_versions_whatever_the_plan():
    rng = np.random.default_rng(5)
    A = torch.from_numpy(rng.standard_normal((3, 12, 12)) + 12 * np.eye(12))
    b = torch.from_numpy(rng.standard_normal((3, 12)))
    before = dict(L.gauss_solve.route_launches)
    for plan in (None, L.qr_plan(12, F64, route="block")):
        assert torch.equal(L.gauss_solve(A, b, plan=plan), L.qr_solve_plain(A, b))
    assert L.gauss_solve.route_launches == before
    diag = torch.from_numpy(rng.standard_normal((2, 3, 4, 4)) + 6 * np.eye(4))
    lower, upper = (torch.from_numpy(0.3 * rng.standard_normal((2, 2, 4, 4))) for _ in "lu")
    R = torch.from_numpy(rng.standard_normal((2, 3, 4, 9)))
    before = dict(K6.thomas_solve_multi.route_launches)
    for plan in (None, K6.multi_plan(4, 9, F64, route="block")):
        got = K6.thomas_solve_multi(diag, lower, upper, R, plan=plan)
        assert torch.equal(got, K6.thomas_solve_multi_plain(diag, lower, upper, R))
    assert K6.thomas_solve_multi.route_launches == before


# -- the plans against the kernel sources -------------------------------------


def _source_ints(name, pattern):
    """Every integer that ``pattern``'s groups capture in ``csrc/name``."""
    found = re.findall(pattern, (CSRC / name).read_text())
    return tuple(int(v) for m in found for v in (m if isinstance(m, tuple) else (m,)))


@pytest.mark.parametrize("python, source, pattern", [
    (L.PAIR_REGS, "qr_dense.cu", r"constexpr int kPairRegs = (\d+);"),
    (L.PAIR_ROWS, "qr_dense.cu", r"case (\d+): return launch_pair<"),
    (2 * L.PAIR_COLS, "qr_dense.cu", r"constexpr int kThreads = (\d+);"),
    (K6.GROUP_ROWS, "thomas_multi.cu", r"case (\d+): return launch_group<"),
    (K6.GROUP_MAX_THREADS, "thomas_multi.cu", r"constexpr int kMaxGroup = (\d+);"),
], ids=["kPairRegs", "pair-rows", "pair-cols", "group-rows", "kMaxGroup"])
def test_plan_constants_are_the_kernels_own(python, source, pattern):
    assert _source_ints(source, pattern) == (python if isinstance(python, tuple) else (python,))


def test_route_codes_are_the_c_entries_own():
    # mcp_qr_solve and mcp_thomas_solve_multi: route 0 "block", 1 the new one.
    for src in ("qr_dense.cu", "thomas_multi.cu"):
        text = (CSRC / src).read_text()
        assert "if (route == 0) {" in text and "if (route != 1) return" in text
    assert L._QR_ROUTE_CODES == {"block": 0, "pair": 1}
    assert K6._ROUTE_CODES == {"block": 0, "group": 1}


@pytest.mark.parametrize("dtype", [F32, F64])
def test_every_pair_plan_covers_its_columns(dtype):
    # launch_pair's check (1 ≤ n, n + 1 ≤ kPairCols, n ≤ 2H, H words within
    # kPairRegs) and the smallest template that holds n; the pair's halves
    # give every row exactly one owner.
    rows = _source_ints("qr_dense.cu", r"case (\d+): return launch_pair<")
    regs = _source_ints("qr_dense.cu", r"constexpr int kPairRegs = (\d+);")[0]
    words = torch.empty((), dtype=dtype).element_size() // 4
    for n in range(1, 128):
        plan = L.qr_plan(n, dtype)
        if n > PAIR_UP_TO[dtype]:
            assert plan.route == "block" and min(r for r in rows if 2 * r >= n) * words > regs
            continue
        assert plan.route == "pair" and plan.rows in rows and plan.rows * words <= regs
        assert n <= 2 * plan.rows and plan.rows == min(r for r in rows if 2 * r >= n)
        owners = np.concatenate([np.arange(plan.rows) + h * plan.rows for h in (0, 1)])
        assert np.array_equal(np.sort(owners), np.arange(2 * plan.rows))


@pytest.mark.parametrize("dtype", [F32, F64])
def test_every_group_plan_passes_the_c_entrys_checks(dtype):
    # launch_group's check: 1 ≤ b ≤ BM, k ≥ 1, 2b + k ≤ kMaxGroup, the tiles
    # within the shared memory; BM the smallest template that holds b.
    rows = _source_ints("thomas_multi.cu", r"case (\d+): return launch_group<")
    itemsize = torch.empty((), dtype=dtype).element_size()
    for b in range(1, 50):
        for k in (1, 2 * b + 1, 256 - 2 * b):
            if k < 1:
                continue
            plan = K6.multi_plan(b, k, dtype)
            if plan.route == "group":
                assert 1 <= b <= plan.rows and 2 * b + k <= K6.GROUP_MAX_THREADS
                assert plan.rows == min(r for r in rows if r >= b)
                assert K6.group_smem_bytes(b, k, plan.rows, itemsize) <= 232448
            else:
                assert b > 48 or (dtype == F64 and
                                  K6.group_smem_bytes(b, k, 48 if b > 40 else 40, itemsize)
                                  > 232448)


# -- the pair route's summation order, modelled --------------------------------


def _sum4(a, b):
    """Σ_i a[i]·b[i] over axis 0 in four partial sums (i mod 4), as
    ``dot4`` and the pair route's sum of squares run over a half-column."""
    s = [np.zeros(a.shape[1:]) for _ in range(4)]
    for i in range(a.shape[0]):
        s[i & 3] = s[i & 3] + a[i] * b[i]
    return (s[0] + s[1]) + (s[2] + s[3])


def _pair_model(A, b):
    """The pair route on one system, float64: [A | b] padded to 2H rows,
    the pivot row kept at physical row 0 (each step drops the finished row
    and shifts a zero in); norm and uᵀM as two half-column sums joined; the
    back substitution column by column with the reciprocal diagonal."""
    n = A.shape[0]
    H = L.qr_plan(n, F64).rows
    M = np.zeros((2 * H, n + 1))
    M[:n, :n], M[:n, n] = A, b
    R = np.zeros((n, n + 1))
    halves = (slice(0, H), slice(H, 2 * H))
    for k in range(n):
        v = M[:, k]
        ss = sum(_sum4(v[h], v[h]) for h in halves)
        norm = np.sqrt(ss + 1e-30)
        u = v.copy()
        u[0] = v[0] + (1.0 if v[0] >= 0 else -1.0) * norm
        beta = 1.0 / (norm * (norm + abs(v[0])) + 1e-30)
        live = M[:, k:]
        w = sum(_sum4(live[h], u[h][:, None]) for h in halves)
        new = live - u[:, None] * (beta * w)[None, :]
        R[k, k:] = new[0]
        M[:, k:] = np.vstack([new[1:], np.zeros((1, n + 1 - k))])
    with np.errstate(divide="ignore", invalid="ignore"):
        rinv = 1.0 / np.diag(R[:, :n])
        y = R[:, n].copy()
        for k in range(n - 1, -1, -1):
            y[k] = y[k] * rinv[k]
            y[:k] = y[:k] - R[:k, k] * y[k]
    return y


def _systems(kind, Bn, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "spd":
        P = rng.standard_normal((Bn, n, n))
        A = P @ P.transpose(0, 2, 1) + n * np.eye(n)
    elif kind == "random":
        A = rng.standard_normal((Bn, n, n)) + n * np.eye(n)
    else:  # saddle (n even): [[M, C], [Cᵀ, 1e-4 I]], ill-conditioned, QR-stable
        h = n // 2
        P = rng.standard_normal((Bn, h, h))
        C = rng.standard_normal((Bn, h, h))
        A = np.concatenate([
            np.concatenate([P @ P.transpose(0, 2, 1) + np.eye(h), C], 2),
            np.concatenate([C.transpose(0, 2, 1), np.broadcast_to(1e-4 * np.eye(h), (Bn, h, h))],
                           2)], 1)
    return A, rng.standard_normal((Bn, n))


#: Two backward-stable solves of one system differ by up to cond(A)·ε·|x|
#: per system; the bound is on max_i |x − x_ref|_i / (|x_ref|_i · κ₂(A_i)),
#: 100 ε (chip_smoke.py's QR_TOL), and each backward error
#: ‖Ax − b‖∞/(‖A‖∞‖x‖∞ + ‖b‖∞) within 100 ε (QR_BWD_TOL).
EPS100 = 100 * 2.0**-52


@pytest.mark.parametrize("n, kind", [(5, "spd"), (5, "random"), (12, "spd"), (12, "random"),
                                     (12, "saddle"), (100, "spd"), (100, "random"),
                                     (100, "saddle")])
def test_pair_model_matches_plain_and_the_jax_kernel(n, kind):
    A, b = _systems(kind, 2, n, 90 + n)
    got = np.stack([_pair_model(A[i], b[i]) for i in range(2)])
    plain = L.qr_solve_plain(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    jax_x = np.asarray(pallas_qr_solve_fused(jnp.asarray(A), jnp.asarray(b)))
    kappa = np.linalg.cond(A)
    for ref in (plain, jax_x):
        per = np.abs(got - ref).max(axis=1) / np.abs(ref).max(axis=1)
        assert (per / kappa).max() <= EPS100
    res = np.abs(np.einsum("bij,bj->bi", A, got) - b).max(axis=1)
    bwd = res / (np.abs(A).sum(axis=2).max(axis=1) * np.abs(got).max(axis=1)
                 + np.abs(b).max(axis=1))
    assert bwd.max() <= EPS100


def test_pair_model_zero_pivot_gives_non_finite_as_plain():
    A, b = _systems("spd", 3, 12, 7)
    A[1, 0, :] = 0.0
    A[1, :, 0] = 0.0
    got = np.stack([_pair_model(A[i], b[i]) for i in range(3)])
    plain = L.qr_solve_plain(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    assert (~np.isfinite(got).all(axis=1)).tolist() == [False, True, False]
    assert (~np.isfinite(plain).all(axis=1)).tolist() == [False, True, False]


# -- the rank worker's counts --------------------------------------------------


def test_horizon_worker_counts_carry_k6_routes():
    saved = (K6.thomas_solve_multi.launches, dict(K6.thomas_solve_multi.route_launches))
    try:
        K6.thomas_solve_multi.launches = 5
        K6.thomas_solve_multi.route_launches = {"group": 4, "block": 1}
        counts = worker._counts()
        assert counts["multi"] == 5
        assert counts["multi_routes"] == {"group": 4, "block": 1}
        worker._reset()
        counts = worker._counts()
        assert counts["multi"] == 0 and counts["multi_routes"] == {"group": 0, "block": 0}
        assert set(counts) == {*worker.WRAPPERS, "multi_routes"}
    finally:
        K6.thomas_solve_multi.launches, K6.thomas_solve_multi.route_launches = saved
