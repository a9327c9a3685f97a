"""The launch plans of K2 (``linesearch.ls_plan``: the "cluster" route, a
thread block cluster per lane holding 16-byte chunks of every row in
registers; or the "block" route) and of K8b (``linear_solve.wy_plan``: the
"pair" route, K4b's lane pair per column of [A | b] with panels factored by
one half-warp, in float32; or the "block" route): the route per shape and
dtype as a table written out by hand, the forced routes and the refusals,
the plans' constants against the kernel sources, and the wrappers on CPU
tensors, which run the plain versions whatever the plan. The kernels run
only on the card; here the plans are plain functions of the shapes. A
numpy model of K8b's pair route (its rows shifted up as they retire, larft
from the earlier owners' dots, the lookahead) is held against the plain
version. Also the colored-seed matrix of the banded residual, converted
once per dtype and device."""

import pathlib
import re

import numpy as np
import pytest
import torch

from mcp_tpu_torch import _device
from mcp_tpu_torch.kernels import block_tridiag as BT
from mcp_tpu_torch.kernels import linear_solve as L
from mcp_tpu_torch.kernels import linesearch as LS
from mcp_tpu_torch.kernels.block_tridiag import TimeStructure
from mcp_tpu_torch.solver import linesearch_candidates

torch.set_num_threads(1)

F32, F64 = torch.float32, torch.float64
CSRC = pathlib.Path(L.__file__).parent / "csrc"
REFUSED = "refused"


def _source_ints(name, pattern):
    """Every integer that ``pattern``'s groups capture in ``csrc/name``."""
    found = re.findall(pattern, (CSRC / name).read_text())
    return tuple(int(v) for m in found for v in (m if isinstance(m, tuple) else (m,)))


# -- K2 ---------------------------------------------------------------------

#: (B, n, m, dtype) → (route, group, slots, cluster). A row of n float32
#: values is ⌈n/4⌉ 16-byte chunks (⌈n/2⌉ in float64). Clusters double while
#: B·P ≤ 132, P ≤ 16 and each CTA keeps ≥ 8 chunks of the longer row; the
#: group is the fewest threads (32…256) that hold a CTA's chunks one each,
#: else the widest group (32·32/P) with ≤ 4 each; no cluster of 2 or more,
#: or no group, is the block route.
BLOCK = ("block", 256, 0, 1)
LS_TABLE = {
    (256, 200, 250, F32): BLOCK,  # 256·2 > 132
    (256, 200, 250, F64): BLOCK,
    (8, 1200, 1470, F32): ("cluster", 32, 1, 16),  # 368 chunks: 23 a CTA
    (8, 1200, 1470, F64): ("cluster", 64, 1, 16),  # 735: 46
    (8, 3000, 3630, F32): ("cluster", 64, 1, 16),  # 908: 57
    (8, 3000, 3630, F64): ("cluster", 64, 2, 16),  # 1815: 114 > 64
    (16, 37, 23, F64): ("cluster", 32, 1, 2),  # 19 chunks: 10 a CTA
    (16, 37, 23, F32): BLOCK,  # 10 chunks: 5 < 8 a CTA
    (1, 5, 3, F32): BLOCK,
    (66, 200, 250, F32): ("cluster", 32, 1, 2),  # 66·2 = 132
    (67, 200, 250, F32): BLOCK,  # 67·2 > 132
    (2, 5000, 4000, F32): ("cluster", 64, 2, 16),  # 1250: 79 a CTA
    (256, 1200, 1470, F32): BLOCK,
    (256, 3000, 3630, F32): BLOCK,
    (256, 3000, 3630, F64): BLOCK,
    (8, 100000, 10, F32): BLOCK,  # 1563 a CTA > 64·4
}


def _ls_cases():
    for (B, n, m, dtype), want in LS_TABLE.items():
        yield pytest.param(B, n, m, dtype, want, id=f"{str(dtype)[6:]}-{B}x{n}x{m}")


@pytest.mark.parametrize("B, n, m, dtype, want", list(_ls_cases()))
def test_ls_plan_route_table(B, n, m, dtype, want):
    plan = LS.ls_plan(B, n, m, dtype)
    assert (plan.route, plan.group, plan.slots, plan.cluster) == want
    assert LS.ls_plan(B, n, m, dtype, route="block") == LS.LSPlan(*BLOCK)
    assert LS.ls_plan(B, n, m, dtype, route=plan.route) == plan
    # A grid the cluster route's scan does not take goes to the block route.
    assert LS.ls_plan(B, n, m, dtype, monotone=False) == LS.LSPlan(*BLOCK)
    with pytest.raises(ValueError, match="cluster route does not take"):
        LS.ls_plan(B, n, m, dtype, route="cluster", monotone=False)
    if plan.route != "cluster":
        with pytest.raises(ValueError, match="cluster route does not take"):
            LS.ls_plan(B, n, m, dtype, route="cluster")


def test_ls_plan_has_no_lane_route():
    # One thread group per lane at a batch that fills the card ran no faster
    # on the card than the block route; the plan has no such route.
    assert LS.LS_ROUTES == ("cluster", "block")
    with pytest.raises(ValueError, match="route must be one of"):
        LS.ls_plan(256, 200, 250, F32, route="lane")
    assert "ls_group_kernel<T, Q, false>" not in (CSRC / "linesearch.cu").read_text()


def test_ls_plan_refusals():
    with pytest.raises(ValueError, match="route must be one of"):
        LS.ls_plan(8, 10, 10, F32, route="warp")
    with pytest.raises(ValueError, match="float32/float64"):
        LS.ls_plan(8, 10, 10, torch.float16)
    with pytest.raises(ValueError, match="n > 0 and m > 0"):
        LS.ls_plan(8, 0, 10, F32)


def _c_entry_takes(plan, n, m, itemsize):
    """mcp_linesearch_launch's checks of a plan (``launch`` in the source)."""
    if plan.route == "block":
        return plan.group == 256 and plan.slots == 0 and plan.cluster == 1
    G, Q, P = plan.group, plan.slots, plan.cluster
    ok = 32 <= G <= 256 and G & (G - 1) == 0 and 1 <= Q <= 4
    ok &= 2 <= P <= 16 and P & (P - 1) == 0 and P * (G // 32) <= 32
    return ok and max(LS._chunks(n, itemsize, P), LS._chunks(m, itemsize, P)) <= G * Q


@pytest.mark.parametrize("dtype", [F32, F64])
def test_every_ls_plan_passes_the_c_entrys_checks(dtype):
    itemsize = torch.empty((), dtype=dtype).element_size()
    for B in (1, 3, 8, 16, 33, 66, 67, 256):
        for n in (1, 2, 7, 37, 200, 1200, 3000, 9000):
            for m in (1, 3, 23, 250, 1470, 3630):
                for route in LS.LS_ROUTES:
                    try:
                        plan = LS.ls_plan(B, n, m, dtype, route=route)
                    except ValueError:
                        continue
                    assert plan.route == route and _c_entry_takes(plan, n, m, itemsize)


@pytest.mark.parametrize("B, n, m, dtype", [(16, 37, 23, F64), (8, 70, 150, F32),
                                            (3, 5, 1, F32), (4, 200, 250, F64)])
def test_ls_chunks_give_every_element_one_owner(B, n, m, dtype):
    # The source's ownership: CTA r of P holds chunks [r S, min(N, (r+1) S)),
    # S = ⌈N/P⌉; thread t slot q chunk r S + t + G q; chunk j elements
    # j·CH .. j·CH + CH − 1 below the row's length.
    ch = 16 // torch.empty((), dtype=dtype).element_size()
    try:
        plan = LS.ls_plan(B, n, m, dtype, route="cluster")
    except ValueError:
        assert LS.ls_plan(B, n, m, dtype).route == "block"
        return
    for length in (n, m):
        N = -(-length // ch)
        S = -(-N // plan.cluster)
        seen = np.zeros(length, dtype=int)
        for r in range(plan.cluster):
            for t in range(plan.group):
                for q in range(plan.slots):
                    j = r * S + t + plan.group * q
                    if j < min(N, (r + 1) * S):
                        e = np.arange(j * ch, j * ch + ch)
                        seen[e[e < length]] += 1
        assert (seen == 1).all()


@pytest.mark.parametrize("python, pattern", [
    (LS.LS_MAX_CANDIDATES, r"constexpr int kMaxCands = (\d+);"),
    (LS.LS_GROUPS[-1], r"constexpr int kMaxGroup = (\d+);"),
    (LS.LS_MAX_SLOTS, r"constexpr int kMaxSlots = (\d+);"),
    (LS.LS_MAX_CLUSTER, r"constexpr int kMaxCluster = (\d+);"),
    (LS.LS_MAX_PARTIALS, r"constexpr int kMaxPartials = (\d+);"),
    (tuple(range(1, LS.LS_MAX_SLOTS + 1)), r"case (\d+): return launch_group<T, \d+>"),
    (256, r"constexpr int kThreads = (\d+);"),
], ids=["kMaxCands", "kMaxGroup", "kMaxSlots", "kMaxCluster", "kMaxPartials", "slots",
        "kThreads"])
def test_ls_constants_are_the_kernels_own(python, pattern):
    assert _source_ints("linesearch.cu", pattern) == (
        python if isinstance(python, tuple) else (python,))


def test_ls_config_is_the_c_entrys_struct():
    text = (CSRC / "linesearch.cu").read_text()
    body = re.search(r"struct LSConfig \{(.*?)\};", text, re.S).group(1)
    names = re.findall(r"\b(\w+)(?:\[\w+\])?(?:,|;)", re.sub(r"//.*", "", body))
    assert names == [f for f, _ in LS._LSConfig._fields_]
    assert "if (c.route == 0) {" in text and "if (c.route != 1 || G < 32" in text
    assert LS._LS_ROUTE_CODES == {"block": 0, "cluster": 1}


def test_ls_output_layout_is_16_byte_aligned():
    # x', s', y', kkt and the flags at 16-byte boundaries of one buffer: the
    # byte offsets for the kernel, element offsets (bytes for the flags)
    # for the views.
    plan = LS.ls_plan(7, 13, 11, F32)
    _, cfg, _, off, size = LS._config(plan, F32, 7, 13, 11, 0.995, (1.0, 0.5))
    assert tuple(cfg.off) == (0, 368, 688, 1008, 1040) and size * 4 == 1056
    assert off == (0, 92, 172, 252, 1040)
    _, cfg, _, off, size = LS._config(plan, F64, 7, 13, 11, 0.995, (1.0, 0.5))
    assert tuple(cfg.off) == (0, 736, 1360, 1984, 2048) and size * 8 == 2064
    assert off == (0, 92, 170, 248, 2048)


@pytest.mark.parametrize("candidates, monotone", [
    (linesearch_candidates(0.5, 1e-4), 1), ((1.0, 1.0, 0.5), 1), ((0.5, 1.0), 0),
    ((1.0, 0.0), 0), ((1.0, float("inf")), 0), ((1.0, -0.5), 0), ((1.0, 1e-50), 1),
])
def test_ls_scan_only_on_a_positive_non_increasing_grid(candidates, monotone):
    # The kernel's scan of the candidates (scan_of, the cluster route) holds
    # only for a finite, positive, non-increasing grid in the iterate dtype;
    # 1e-50 rounds to 0 in float32. Any other grid takes the block route,
    # and a forced cluster plan refuses it.
    cluster = LS.ls_plan(8, 1200, 1470, F64)
    assert cluster.route == "cluster"
    for dtype, want in ((F64, monotone), (F32, monotone and min(candidates) > 1e-45)):
        assert LS._monotone(candidates, dtype) == want
        plan = LS._config(None, dtype, 8, 1200, 1470, 0.995, candidates)[0]
        assert plan.route == ("cluster" if want else "block")
        if not want:
            with pytest.raises(ValueError, match="cluster route takes only"):
                LS._config(cluster, dtype, 8, 1200, 1470, 0.995, candidates)


@pytest.mark.parametrize("dtype", [F32, F64])
def test_ls_wrapper_on_cpu_is_the_plain_version_whatever_the_plan(dtype):
    rng = np.random.default_rng(3)
    B, n, m = 6, 9, 7
    x, dx, rg = (torch.from_numpy(rng.standard_normal((B, n))).to(dtype) for _ in range(3))
    s, y = (torch.from_numpy(rng.uniform(0.01, 2.0, (B, m))).to(dtype) for _ in range(2))
    ds, dy, rh, rc = (torch.from_numpy(rng.standard_normal((B, m))).to(dtype)
                      for _ in range(4))
    args = (x, dx, s, ds, y, dy, rg, rh, rc)
    cands = linesearch_candidates(0.5, 1e-4)
    before = (LS.linesearch_update.launches, dict(LS.linesearch_update.route_launches))
    want = LS.linesearch_update_plain(*args, tau=0.995, candidates=cands)
    for plan in (None, LS.ls_plan(B, n, m, dtype, route="block"), LS.ls_plan(8, 1200, 1470, dtype)):
        got = LS.linesearch_update(*args, tau=0.995, candidates=cands, plan=plan)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert (LS.linesearch_update.launches, LS.linesearch_update.route_launches) == before
    with pytest.raises(ValueError, match="x, dx, rg must be"):
        LS.linesearch_update(x, dx, s, ds, y, dy, rg[:, 1:], rh, rc, tau=0.995,
                             candidates=cands)
    with pytest.raises(ValueError, match="share dtype and device"):
        LS.linesearch_update(x, dx.float() if dtype == F64 else dx.double(), s, ds, y, dy, rg,
                             rh, rc, tau=0.995, candidates=cands)


# -- K8b --------------------------------------------------------------------

#: n → (route, rows) at panel 8: n is padded to a multiple of 8; the pair
#: route in float32 for padded n + 1 ≤ 128 columns with H the smallest row
#: template with 2H ≥ padded n; float64 always on the block route.
WY_TABLE = {8: ("pair", 8), 16: ("pair", 8), 17: ("pair", 16), 40: ("pair", 24),
            100: ("pair", 52), 104: ("pair", 52), 105: ("pair", 64), 120: ("pair", 64),
            121: ("block", 0), 127: ("block", 0)}


def _wy_cases():
    for dtype in (F32, F64):
        for n, want in WY_TABLE.items():
            if dtype == F64:
                want = ("block", 0)
            yield pytest.param(n, dtype, want, id=f"{str(dtype)[6:]}-n{n}")
    yield pytest.param(160, F64, REFUSED, id="float64-n160")


@pytest.mark.parametrize("n, dtype, want", list(_wy_cases()))
def test_wy_plan_route_table(n, dtype, want):
    if want == REFUSED:
        with pytest.raises(ValueError, match=rf"wy_solve: n={n} in {dtype} needs \d+ bytes"):
            L.wy_plan(n, 8, dtype)
        return
    plan = L.wy_plan(n, 8, dtype)
    assert (plan.route, plan.rows) == want
    assert L.wy_plan(n, 8, dtype, route="block") == L.WYPlan("block", 0)
    if plan.route == "block":
        with pytest.raises(ValueError, match=f"pair route does not take n={n}"):
            L.wy_plan(n, 8, dtype, route="pair")
    else:
        assert L.wy_plan(n, 8, dtype, route="pair") == plan


def test_wy_plan_other_panels_take_the_block_route():
    assert L.wy_plan(100, 4, F32) == L.WYPlan("block", 0)
    with pytest.raises(ValueError, match="pair route does not take n=100 .* panel 16"):
        L.wy_plan(100, 16, F32, route="pair")
    with pytest.raises(ValueError, match="route must be one of"):
        L.wy_plan(100, 8, F32, route="tile")
    with pytest.raises(ValueError, match="panel must be in"):
        L.wy_plan(100, 17, F32)


@pytest.mark.parametrize("python, pattern", [
    (L.WY_PAIR_PANEL, r"constexpr int kNb = (\d+);"),
    (L.PAIR_ROWS, r"case (\d+): return launch_pair<"),
    (2 * L.PAIR_COLS, r"constexpr int kThreads = (\d+);"),
    (L.WY_MAX_PANEL, r"constexpr int kMaxPanel = (\d+);"),
], ids=["kNb", "pair-rows", "pair-cols", "kMaxPanel"])
def test_wy_constants_are_the_kernels_own(python, pattern):
    assert _source_ints("wy_qr.cu", pattern) == (
        python if isinstance(python, tuple) else (python,))


@pytest.mark.parametrize("dtype", [F32, F64])
def test_every_wy_pair_plan_passes_the_c_entrys_checks(dtype):
    # launch_pair's check (n ≥ kNb, n a multiple of kNb, n + 1 ≤ kPairCols,
    # n ≤ 2H; float32 only), n the padded order; the route codes are
    # dispatch's.
    text = (CSRC / "wy_qr.cu").read_text()
    assert "if (route == 0) {" in text
    assert "if (route != 1 || nb != kNb || sizeof(T) != sizeof(float)) return" in text
    assert L._WY_ROUTE_CODES == {"block": 0, "pair": 1}
    for n in range(1, 128):
        plan = L.wy_plan(n, 8, dtype)
        npad = -(-n // 8) * 8
        if plan.route == "pair":
            assert dtype == F32
            assert 8 <= npad and npad + 1 <= 128 and npad <= 2 * plan.rows
            assert plan.rows == min(r for r in L.PAIR_ROWS if 2 * r >= npad)


def test_wy_plan_pair_route_is_float32_only():
    # In float64 the pair route ran no faster on the card than the block
    # route; the kernel has no float64 instance of it.
    assert L.wy_plan(104, 8, F32, route="pair") == L.WYPlan("pair", 52)
    for n in (8, 100, 104):
        with pytest.raises(ValueError, match=f"pair route does not take n={n}"):
            L.wy_plan(n, 8, F64, route="pair")
    assert "launch_pair<T," not in (CSRC / "wy_qr.cu").read_text()


def test_wy_wrapper_on_cpu_is_the_plain_version_whatever_the_plan():
    rng = np.random.default_rng(5)
    A = torch.from_numpy(rng.standard_normal((3, 12, 12)) + 12 * np.eye(12))
    b = torch.from_numpy(rng.standard_normal((3, 12)))
    before = (L.wy_solve.launches, dict(L.wy_solve.route_launches))
    for plan in (None, L.wy_plan(12, 8, F32), L.wy_plan(12, 8, F64, route="block")):
        assert torch.equal(L.wy_solve(A, b, plan=plan), L.wy_solve_plain(A, b))
    assert (L.wy_solve.launches, L.wy_solve.route_launches) == before


def _wy_pair_model(A, b, H, nb=8):
    """wy_qr.cu's pair route in numpy for one padded system: column c of
    [A | b] as two halves of H rows, physical row 0 the first row not yet
    retired; per panel the owner's K8a reflector, the panel's update, larft
    from the earlier owners' dots, then each trailing column's block
    reflector and a shift by nb; back substitution with 1/R[k][k]."""
    n = A.shape[0]
    cols = np.zeros((n + 1, 2 * H))
    cols[:, :n] = np.concatenate([A, b[:, None]], 1).T
    R = np.zeros((n + 1, n))
    eps = 1e-30

    def shift(v, k):
        return np.concatenate([v[k:], np.zeros(k)])

    def factor(j0):
        U, T = np.zeros((2 * H, nb)), np.zeros((nb, nb))
        for k in range(nb):
            v = cols[j0 + k]
            norm = np.sqrt(v @ v + eps)
            u = v.copy()
            u[0] = v[0] + norm if v[0] >= 0 else v[0] - norm
            beta = 2 / (u @ u + eps) if u @ u > eps else 0.0
            w = cols[j0:j0 + nb] @ u
            for kc in range(nb):
                c = j0 + kc
                upd = cols[c] - u * (beta * w[kc])
                if kc >= k:
                    R[c, j0 + k] = upd[0]
                cols[c] = shift(upd if kc > k else u if kc == k else cols[c], 1)
            U[k:, k] = u[:2 * H - k]
            T[:k, k] = -beta * (T[:k, :k] @ w[:k])
            T[k, k] = beta
        return U, T

    U, T = factor(0)
    for j0 in range(0, n, nb):
        for c in range(j0 + nb, n + 1):
            v = cols[c] - U @ (T.T @ (U.T @ cols[c]))
            R[c, j0:j0 + nb] = v[:nb]
            cols[c] = shift(v, nb)
        if j0 + nb < n:
            U, T = factor(j0 + nb)
    x = np.zeros(n)
    for k in range(n - 1, -1, -1):
        x[k] = (R[n, k] - R[k + 1:n, k] @ x[k + 1:]) / R[k, k]
    return x


@pytest.mark.parametrize("n", [8, 20, 37])
def test_wy_pair_model_matches_plain(n):
    rng = np.random.default_rng(n)
    A = rng.standard_normal((2, n, n)) + n * np.eye(n)
    b = rng.standard_normal((2, n))
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    want = L.wy_solve_plain(At, bt).numpy()
    Ap, bp = L._pad_to_panel(At, bt, 8)
    H = L.wy_plan(n, 8, F32).rows
    got = np.stack([_wy_pair_model(Ap[i].numpy(), bp[i].numpy(), H)[:n] for i in range(2)])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


def test_wy_pair_model_zero_pivot_gives_non_finite_as_plain():
    rng = np.random.default_rng(1)
    A = rng.standard_normal((16, 16)) + 3 * np.eye(16)
    A[0, :] = A[:, 0] = 0.0
    b = rng.standard_normal(16)
    with np.errstate(all="ignore"):
        got = _wy_pair_model(A, b, 8)
    want = L.wy_solve_plain(torch.from_numpy(A)[None], torch.from_numpy(b)[None])[0].numpy()
    assert not np.isfinite(got).all() and not np.isfinite(want).all()


# -- the colored seeds of the banded residual ---------------------------------


def _toy_banded_mcp(T=4, b=3, mt=2):
    """A nonlinear MCP with T time blocks of b primals and mt inequality
    rows: g couples neighbouring blocks of x and its own block of y, h its
    own block of x; both permutations reversed within each block."""
    n, m = T * b, T * mt
    rng = np.random.default_rng(0)
    bt = np.arange(n) // b
    rt = np.arange(m) // mt
    Gx = rng.standard_normal((n, n)) * (np.abs(bt[:, None] - bt[None, :]) <= 1)
    Gy = rng.standard_normal((n, m)) * (bt[:, None] == rt[None, :])
    Hx = rng.standard_normal((m, n)) * (rt[:, None] == bt[None, :])
    Gx, Gy, Hx = (torch.from_numpy(a) for a in (Gx, Gy, Hx))
    perm = tuple(int(t * b + b - 1 - o) for t in range(T) for o in range(b))
    rperm = tuple(int(t * mt + mt - 1 - q) for t in range(T) for q in range(mt))
    st = TimeStructure(perm, T, b, rperm, mt)

    class Toy:
        unconstrained_dimension, constrained_dimension = n, m

        @staticmethod
        def gh(x, y, theta):
            xp, yp = x[list(perm)], y[list(rperm)]  # time-major coordinates
            g = Gx.to(x.dtype) @ xp + 0.1 * xp**3 + Gy.to(x.dtype) @ yp + theta[0]
            h = Hx.to(x.dtype) @ xp
            h = h + 0.1 * h**2
            inv, rinv = np.argsort(perm), np.argsort(rperm)
            return g[list(inv)], h[list(rinv)]

    return Toy(), st


@pytest.mark.parametrize("dtype", [F32, F64])
def test_colored_seeds_convert_once_per_dtype_and_device(monkeypatch, dtype):
    mcp, st = _toy_banded_mcp()
    n, m = mcp.unconstrained_dimension, mcp.constrained_dimension
    rng = np.random.default_rng(2)
    x, y, theta = (torch.from_numpy(rng.standard_normal(k)).to(dtype) for k in (n, m, 2))
    seeds = BT._colored_seeds(st, n, m)
    given = []

    def spy(array, dt, device):
        t = _device.const(array, dt, device)
        if array is seeds:
            given.append(t)
        return t

    monkeypatch.setattr(BT, "const", spy)
    first = BT.gh_banded(mcp, st, x, y, theta)
    second = BT.gh_banded(mcp, st, x, y, theta)
    assert len(given) == 2 and given[0] is given[1]
    assert given[0] is _device.const(seeds, dtype, x.device)
    assert given[0].dtype == dtype and torch.equal(given[0], torch.as_tensor(seeds, dtype=dtype))
    # The bands as the per-call conversion of the seeds gave them.
    monkeypatch.setattr(BT, "const", lambda a, dt, dev: (
        torch.as_tensor(a, dtype=dt, device=dev) if a is seeds else _device.const(a, dt, dev)))
    before = BT.gh_banded(mcp, st, x, y, theta)
    for a, c, d in zip(first, second, before):
        assert torch.equal(a, c) and torch.equal(a, d)
