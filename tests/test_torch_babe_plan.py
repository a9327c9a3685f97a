"""The launch plan of K7a, the two-way block-Thomas sweep
(``thomas_babe.babe_plan``: the "group" route, one 128-thread group per
sweep direction with a column of the step's working matrix per thread in
registers, or the "block" route): the route per shape and dtype as a table
written out by hand, the plan's constants against the kernel source, the
C entry's own checks of a plan, the refusals, and the wrapper on CPU
tensors. The kernels run only on the card; here the plan is a plain
function of the shapes. The group route's pivot search (four interleaved
scans, then the larger of their maxima) is modelled in numpy and held
against the plain version's pivot rule."""

import pathlib
import re

import numpy as np
import pytest
import torch

from mcp_tpu_torch.kernels import thomas_babe as K
from mcp_tpu_torch.kernels.solve_aug import _gjp_elimination

torch.set_num_threads(1)

F32, F64 = torch.float32, torch.float64
FACTS = ("qr", "gj", "gjp", "gjpr")
CSRC = pathlib.Path(K.__file__).parent / "csrc"
REFUSED = "refused"


# -- the route table ---------------------------------------------------------

#: The largest b on the group route per (dtype, fact): b ≤ 48 rows, and with
#: refinement (gjpr's [A | N | I], 3b + 1 columns) b ≤ 42 for one thread a
#: column; in float64 the two directions' tiles are over the block's shared
#: memory from b=42 on (gjpr, with A⁻¹ in its out tile, from b=41 on).
GROUP_UP_TO = {(F32, "qr"): 48, (F32, "gj"): 48, (F32, "gjp"): 48, (F32, "gjpr"): 42,
               (F64, "qr"): 41, (F64, "gj"): 41, (F64, "gjp"): 41, (F64, "gjpr"): 40}
#: The group route's row template at b.
ROWS_AT = {1: 8, 8: 8, 9: 16, 16: 16, 17: 24, 20: 24, 24: 24, 25: 32, 32: 32, 33: 40,
           40: 40, 41: 48, 42: 48, 43: 48, 45: 48, 48: 48}
#: What neither route takes (the block route's shared memory): the refusals
#: of ``check_fits``, unchanged by the group route.
REFUSED_AT = {(F32, "gjpr"): range(64, 65)} | {(F64, f): range(60, 65)
                                               for f in ("qr", "gj", "gjp")} \
    | {(F64, "gjpr"): range(45, 65)}


def _cases():
    for dtype in (F32, F64):
        for fact in FACTS:
            for b in (*ROWS_AT, 49, 59, 60, 64):
                if b in REFUSED_AT.get((dtype, fact), ()):
                    want = REFUSED
                elif b <= GROUP_UP_TO[dtype, fact]:
                    want = ("group", ROWS_AT[b])
                else:
                    want = ("block", 0)
                yield pytest.param(b, fact, dtype, want, id=f"{str(dtype)[6:]}-{fact}-b{b}")


@pytest.mark.parametrize("b, fact, dtype, want", list(_cases()))
def test_babe_plan_route_table(b, fact, dtype, want):
    if want == REFUSED:
        with pytest.raises(ValueError, match=rf"babe_thomas_solve: fact='{fact}' at b={b} in "
                                             rf"{dtype} needs \d+ bytes of shared memory, "
                                             r"over the card's 232448"):
            K.babe_plan(b, fact, dtype)
        return
    plan = K.babe_plan(b, fact, dtype)
    assert (plan.route, plan.rows) == want
    assert K.babe_plan(b, fact, dtype, route="block") == K.BabePlan("block", 0)
    if plan.route == "block":
        with pytest.raises(ValueError, match="group route does not take"):
            K.babe_plan(b, fact, dtype, route="group")


def test_the_paths_shapes_take_the_group_route():
    # The training step and path C (b=40, every fact, float32 and float64:
    # the float64 gradient checks at (2, 30, 40)) and the lane-change bands
    # at horizon 20 (b=20).
    for dtype in (F32, F64):
        for fact in FACTS:
            assert K.babe_plan(40, fact, dtype) == K.BabePlan("group", 40)
            assert K.babe_plan(20, fact, dtype) == K.BabePlan("group", 24)


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("fact", FACTS)
def test_refusals_are_no_broader_than_the_block_routes(dtype, fact):
    for b in range(1, 65):
        try:
            K.check_fits(b, dtype, fact)
            fits = True
        except ValueError:
            fits = False
        try:
            K.babe_plan(b, fact, dtype)
            planned = True
        except ValueError:
            planned = False
        assert planned == fits, b


# -- the plan against the kernel source --------------------------------------


def _source_ints(name, pattern):
    """Every integer that ``pattern``'s groups capture in ``csrc/name``."""
    found = re.findall(pattern, (CSRC / name).read_text())
    return tuple(int(v) for m in found for v in (m if isinstance(m, tuple) else (m,)))


@pytest.mark.parametrize("python, source, pattern", [
    (K.GROUP_REGS, "thomas_babe.cu", r"constexpr int kGroupRegs = (\d+);"),
    (K.GROUP_ROWS, "thomas_babe.cu", r"case (\d+): return launch_group<"),
    (K.GROUP_THREADS, "thomas_babe.cu", r"constexpr int kGroup = (\d+);"),
    (K.SMEM_LIMIT, "thomas_babe.cu", r"constexpr long long kSmemLimit = (\d+);"),
], ids=["kGroupRegs", "group-rows", "kGroup", "kSmemLimit"])
def test_plan_constants_are_the_kernels_own(python, source, pattern):
    assert _source_ints(source, pattern) == (python if isinstance(python, tuple) else (python,))


def test_group_smem_is_the_kernels_layout():
    # solve_aug_group.cuh's regions, counted by hand for two shapes: two
    # staging buffers of [D | U | r] (2b + 1 columns) and a side region
    # (b + 1 columns) at the stride rows + 1, the out tile (b + 1 columns,
    # + b with refinement), two slots of rows + 4 and rows of 1/R[k][k];
    # each region rounded up to 4 elements; two directions.
    # float32 qr at b=40: 2·(3324 + 1684) + 1684 + 2·44 + 40 = 11828.
    assert K.group_smem_bytes(40, 40, "qr", 4) == 2 * 4 * 11828
    # float64 gjpr at b=40: the out tile holds [C | d | A⁻¹], 81 columns.
    assert K.group_smem_bytes(40, 40, "gjpr", 8) == 2 * 8 * (2 * 5008 + 3324 + 88 + 40)
    text = (CSRC / "solve_aug_group.cuh").read_text()
    for name in ("group_cols_elems", "group_stage_elems", "group_out_elems",
                 "group_slot_elems", "group_dir_elems"):
        assert f"constexpr long long {name}(" in text


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("fact", FACTS)
def test_every_group_plan_passes_the_c_entrys_checks(dtype, fact):
    # mcp_babe_solve's launch_group: rows is one of dispatch_group's
    # templates, 1 ≤ b ≤ rows, the working matrix at most kGroup columns,
    # the tiles within kSmemLimit, a column within kGroupRegs.
    rows = _source_ints("thomas_babe.cu", r"case (\d+): return launch_group<")
    (regs,) = _source_ints("thomas_babe.cu", r"constexpr int kGroupRegs = (\d+);")
    itemsize = torch.empty((), dtype=dtype).element_size()
    refine = fact == "gjpr"
    for b in range(1, GROUP_UP_TO[dtype, fact] + 1):
        plan = K.babe_plan(b, fact, dtype)
        assert plan.route == "group"
        assert plan.rows in rows and 1 <= b <= plan.rows
        assert plan.rows == min(r for r in rows if r >= b)
        assert 2 * b + 1 + (b if refine else 0) <= K.GROUP_THREADS
        assert K.group_smem_bytes(b, plan.rows, fact, itemsize) <= K.SMEM_LIMIT
        assert plan.rows * itemsize // 4 <= regs
        # group_instance: the template is compiled where the smallest b it
        # serves fits (float64 gjpr at 48 rows is not).
        least = 1 if plan.rows <= 8 else plan.rows - 7
        assert K.group_smem_bytes(least, plan.rows, fact, itemsize) <= K.SMEM_LIMIT


def test_refusals_keep_their_messages():
    with pytest.raises(ValueError, match="takes blocks up to b=64, got b=65"):
        K.babe_plan(65, "qr", F32)
    with pytest.raises(ValueError, match="route must be one of"):
        K.babe_plan(20, "qr", F32, route="warp")
    with pytest.raises(ValueError, match="fact must be one of"):
        K.babe_plan(20, "gjb", F32)
    with pytest.raises(ValueError, match=r"the group route does not take fact='gjpr' at b=43 "
                                         r"in torch.float32"):
        K.babe_plan(43, "gjpr", F32, route="group")
    with pytest.raises(ValueError, match=r"the group route does not take fact='qr' at b=42 "
                                         r"in torch.float64"):
        K.babe_plan(42, "qr", F64, route="group")


# -- the wrapper on CPU tensors ----------------------------------------------


def _bands(B, T, b, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    arrs = (rng.standard_normal((B, T, b, b)) + 3 * b * np.eye(b),
            0.3 * rng.standard_normal((B, T - 1, b, b)),
            0.3 * rng.standard_normal((B, T - 1, b, b)),
            rng.standard_normal((B, T, b)))
    return tuple(torch.from_numpy(a.astype(dtype)) for a in arrs)


@pytest.mark.parametrize("fact", FACTS)
def test_a_plan_on_cpu_tensors_is_the_plain_version(fact):
    args = _bands(2, 5, 6, 7)
    want = K.babe_solve_plain(*args, fact)
    launches = dict(K.babe_thomas_solve.launches)
    routes = dict(K.babe_thomas_solve.route_launches)
    for plan in (K.babe_plan(6, fact, F64), K.babe_plan(6, fact, F64, route="block"), None):
        assert torch.equal(K.babe_thomas_solve(*args, fact=fact, plan=plan), want)
    assert K.babe_thomas_solve.launches == launches
    assert K.babe_thomas_solve.route_launches == routes
    assert set(routes) == {"group", "block"}


# -- the pivot search of gjp_form, modelled ----------------------------------


def _scan_pivot(col, used, b, rows):
    """solve_aug_group.cuh::gjp_form's pivot row for one column (rows ≥ b
    are padding, counted as used): scores |c| or |c|·0 − 1, four
    interleaved scans (residue i mod 4) each keeping its first strict
    maximum from −2, the larger of the four (the lower row on ties); b when
    a real row scores NaN."""
    col = np.concatenate([col, np.zeros(rows - b)])
    used = np.concatenate([used, np.ones(rows - b, dtype=bool)])
    best, bi = [-2.0] * 4, [rows] * 4
    nan = False
    for i in range(rows):
        a = abs(col[i])
        v = (a - a) - 1.0 if used[i] else a
        if np.isnan(v) and i < b:
            nan = True
        if v > best[i & 3]:
            best[i & 3], bi[i & 3] = v, i
    for r in range(1, 4):
        if best[r] > best[0] or (best[r] == best[0] and bi[r] < bi[0]):
            best[0], bi[0] = best[r], bi[r]
    return b if nan or bi[0] >= b else bi[0]


@pytest.mark.parametrize("b, rows", [(5, 8), (20, 24), (40, 40), (41, 48)])
def test_pivot_scan_model_picks_the_plain_pivot(b, rows):
    # Every pivot of the plain gjp elimination on matrices with ties (values
    # drawn from a few levels, signs and -0 included), and each step's
    # column and used rows fed to the model.
    rng = np.random.default_rng(b)
    levels = np.array([0.0, -0.0, 1.0, -1.0, 2.0, -2.0, 0.5])
    M = levels[rng.integers(0, len(levels), size=(6, b, b + 1))]
    M[:, :, :b] += np.eye(b) * rng.integers(0, 2, size=(6, 1, 1))
    M[1, 3 % b, 0] = np.nan  # a NaN score: no pivot at that step
    M[2, :, 0] = np.inf  # ties at inf
    Mt = torch.from_numpy(M)
    _, pivots = _gjp_elimination(Mt, b)
    # Replay the elimination step by step to read each step's column.
    cur = Mt.clone()
    used = np.zeros((6, b), dtype=bool)
    for k in range(b):
        for s in range(6):
            got = _scan_pivot(cur[s, :, k].numpy(), used[s], b, rows)
            assert got == int(pivots[s, k]), (s, k)
        step, _ = _gjp_elimination_step(cur, k, pivots[:, k], b)
        cur = step
        for s in range(6):
            if int(pivots[s, k]) < b:
                used[s, int(pivots[s, k])] = True


def _gjp_elimination_step(M, k, first, b):
    """Step k of ``_gjp_elimination`` with its pivot rows given."""
    rows = torch.arange(b)
    ar = torch.arange(M.shape[0])
    has = (first < b)[:, None]
    prow = torch.where(has, M[ar, first.clamp(max=b - 1)], torch.zeros_like(M[:, 0]))
    piv = prow[:, k]
    inv = 1.0 / torch.where(piv.abs() > 1e-30, piv, torch.full_like(piv, 1e-30))
    f = M[:, :, k] * inv[:, None]
    onehot = rows[None, :] == first[:, None]
    out = torch.where(onehot[:, :, None], (prow * inv[:, None])[:, None, :],
                      M - f[:, :, None] * prow[:, None, :])
    return out, first
