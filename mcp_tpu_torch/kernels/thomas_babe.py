"""K7a: batched block-tridiagonal solve by the two-way ("burn at both ends")
block-Thomas sweep.

``babe_thomas_solve(diag, lower, upper, rhs, *, fact)`` takes K1's layout: diag
(B,T,b,b), lower/upper (B,T-1,b,b) (lower[t] couples block t+1 to block t;
each band stored per system or expanded over the batch with stride 0), rhs
(B,T,b) → x (B,T,b), T ≥ 2. It computes what the JAX package's
``_thomas_kernel_babe`` computes (``mcp_tpu/kernels/thomas_pallas.py:737``),
with ml = ⌈T/2⌉:

* left sweep, t = 0..ml−1: (D_t − L_t C_{t−1}) [C_t | d_t] =
  [U_t | r_t − L_t d_{t−1}], so x_t = d_t − C_t x_{t+1};
* right sweep, t = T−1 down to ml: the same recursion on the time-reversed
  system, whose "previous" coupling is U_t and "next" coupling is L_{t−1}:
  (D_t − U_t E_{t+1}) [E_t | e_t] = [L_{t−1} | r_t − U_t e_{t+1}], so
  x_t = e_t − E_t x_{t−1} (the JAX package's identity pad block for odd T
  solves to C = 0, d = 0 exactly under every fact and is skipped);
* junction: (I − C_{ml−1} E_{ml}) x_{ml−1} = d_{ml−1} − C_{ml−1} e_{ml}, by
  one more in-block solve, then x_{ml} = e_{ml} − E_{ml} x_{ml−1};
* back substitution of both chains.

Every in-block solve, the junction's included, is the fact ``fact`` of K1's
sweep (``solve_aug``: "qr", "gj", "gjp" or "gjpr"; the JAX package's
``_solve_aug`` at ``:779`` and ``:798``). A zero or non-finite QR pivot gives
inf/NaN in x; a Gauss–Jordan pivot is clamped to 1e-30; nothing sanitizes x.

A CUDA tensor launches the hand-written kernel ``csrc/thomas_babe.cu`` or
raises; a CPU tensor runs ``babe_solve_plain``, the same algebra in batched
PyTorch ops. The kernel has two routes, both one thread block per system
with one 128-thread group per sweep direction, and ``babe_plan(b, fact,
dtype)``, a plain function of the shapes, picks one: ``"group"`` (thread j
of a group owns column j of the step's working matrix [D − LC | U | r (| I)]
with all its rows in registers, rows templated to ``GROUP_ROWS``; one barrier
per elimination step; b ≤ 48, the matrix at most 128 columns wide, both
directions' tiles within the card's shared memory: every b the tier routes
to K7a in float32, and in float64 up to b=41, gjpr up to b=40) or
``"block"`` (the working matrix in shared memory, K1's block-route facts;
every other shape, and the A/B of the group route). ``babe_thomas_solve.
launches`` counts kernel launches per fact and ``babe_thomas_solve.
route_launches`` per route (dicts).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from .solve_aug import FACT_CODES, SMEM_LIMIT, solve_aug_plain
from .thomas import MAX_BLOCK, SWEEP_FACTS, _batch_stride, _check
from .thomas import check_fits as _sweep_fits

Tensor = torch.Tensor


def _sweep_step(D, L, U, r, prev, b, fact):
    """One step of a one-way sweep over a batch: [C | d] of
    (D − L C_prev) [C | d] = [U | r − L d_prev]; ``L`` None at the chain's
    start."""
    if L is not None:
        C_prev, d_prev = prev
        D = D - L @ C_prev
        r = r - (L @ d_prev[..., None])[..., 0]
    X = solve_aug_plain(torch.cat([D, U, r[..., None]], dim=2), b, fact)
    return X[..., :b], X[..., b]


def babe_solve_plain(diag: Tensor, lower: Tensor, upper: Tensor, rhs: Tensor,
                     fact: str = "qr") -> Tensor:
    """The two-way sweep in batched PyTorch ops, on any device (the
    reference the kernel is held against)."""
    B, T, b, _ = diag.shape
    if T < 2:
        raise ValueError("the two-way sweep needs T >= 2 (T = 1 takes the one-way sweep)")
    lower = lower.expand(B, T - 1, b, b)
    upper = upper.expand(B, T - 1, b, b)
    ml = (T + 1) // 2
    left = [_sweep_step(diag[:, 0], None, upper[:, 0], rhs[:, 0], None, b, fact)]
    for t in range(1, ml):  # [C_t | d_t], t = 0..ml−1
        left.append(_sweep_step(diag[:, t], lower[:, t - 1], upper[:, t], rhs[:, t],
                                left[-1], b, fact))
    right = [_sweep_step(diag[:, T - 1], None, lower[:, T - 2], rhs[:, T - 1], None, b, fact)]
    for t in range(T - 2, ml - 1, -1):  # [E_t | e_t], t = T−1 down to ml
        right.append(_sweep_step(diag[:, t], upper[:, t], lower[:, t - 1], rhs[:, t],
                                 right[-1], b, fact))

    mv = lambda A, v: (A @ v[..., None])[..., 0]
    (C_L, d_L), (E_R, e_R) = left[-1], right[-1]
    eye = torch.eye(b, dtype=diag.dtype, device=diag.device).expand(B, b, b)
    Mj = torch.cat([eye - C_L @ E_R, (d_L - mv(C_L, e_R))[..., None]], dim=2)
    xs = [None] * T
    xs[ml - 1] = solve_aug_plain(Mj, b, fact)[..., 0]
    xs[ml] = e_R - mv(E_R, xs[ml - 1])
    for k in range(ml - 2, -1, -1):  # left chain: x_k = d_k − C_k x_{k+1}
        C, d = left[k]
        xs[k] = d - mv(C, xs[k + 1])
    for t in range(ml + 1, T):  # right chain: x_t = e_t − E_t x_{t−1}
        E, e = right[T - 1 - t]
        xs[t] = e - mv(E, xs[t - 1])
    return torch.stack(xs, dim=1)


def check_fits(b: int, dtype, fact: str = "qr"):
    """Raise when both directions' working sets of the block route (K1's,
    ``thomas.sweep_smem_bytes``) do not fit one block's shared memory (b=64
    in float64)."""
    _sweep_fits(b, fact, dtype, directions=2, name="babe_thomas_solve")


#: The group route's row templates (b ≤ BM rows per column, BM the smallest
#: that holds b), its register budget (one BM-long column per thread, in
#: 32-bit registers) and its threads per direction (one column each). All
#: three are the kernel's own (``csrc/thomas_babe.cu``: ``dispatch_group``'s
#: cases, ``kGroupRegs``, ``kGroup``).
GROUP_ROWS = (8, 16, 24, 32, 40, 48)
GROUP_REGS = 96
GROUP_THREADS = 128
ROUTES = ("group", "block")
_ROUTE_CODES = {"block": 0, "group": 1}


@dataclasses.dataclass(frozen=True)
class BabePlan:
    """K7a's launch for one (b, fact, dtype): ``route`` "group" (a column of
    the working matrix per thread, in registers) or "block" (the working
    matrix in shared memory), and on the group route the row template
    ``rows`` (BM; 0 on the block route)."""

    route: str
    rows: int


def group_smem_bytes(b: int, rows: int, fact: str, itemsize: int) -> int:
    """Shared memory of the group route (``csrc/solve_aug_group.cuh``,
    ``group_dir_elems``, twice: one set per direction), each region rounded
    up to 4 elements: two staging buffers, each [D | U | r] (2b + 1 columns)
    and a side region (b + 1 columns), every column at the odd stride
    rows + 1; the out tile [C | d] (b + 1 columns, plus b for A⁻¹ with
    refinement); two broadcast slots of rows + 4; R's reciprocal diagonal
    (rows)."""
    r4 = lambda n: -(-n // 4) * 4
    s = rows + 1
    stage = r4((2 * b + 1) * s) + r4((b + 1) * s)
    out = r4((b + 1 + (b if FACT_CODES[fact][1] else 0)) * s)
    return 2 * itemsize * (2 * stage + out + 2 * r4(rows + 4) + r4(rows))


def _group_rows(b: int, fact: str, itemsize: int):
    """The group route's row template at (b, fact, itemsize), or None where
    b > 48, the working matrix is over GROUP_THREADS columns, a column is
    over the register budget or the tiles over one block's shared memory."""
    rows = next((r for r in GROUP_ROWS if b <= r), None)
    if rows is None:
        return None
    ld = 2 * b + 1 + (b if FACT_CODES[fact][1] else 0)
    if (ld > GROUP_THREADS or rows * (itemsize // 4) > GROUP_REGS
            or group_smem_bytes(b, rows, fact, itemsize) > SMEM_LIMIT):
        return None
    return rows


def babe_plan(b: int, fact: str, dtype, route: str | None = None) -> BabePlan:
    """K7a's plan for blocks of b with ``fact`` in ``dtype``: the group route
    where it takes the shape, else the block route. ``route`` forces one
    (the A/B comparison of ``chip_smoke.py``); raises ``ValueError`` where
    the route does not take the shape, and for what no route takes (b > 64;
    the block route's shared memory, e.g. qr and gjpr at b=64 in
    float64)."""
    if fact not in SWEEP_FACTS:
        raise ValueError(f"babe_thomas_solve: fact must be one of {SWEEP_FACTS}, got {fact!r}")
    if b > MAX_BLOCK:
        raise ValueError(f"babe_thomas_solve takes blocks up to b={MAX_BLOCK}, got b={b}")
    if route not in (None, *ROUTES):
        raise ValueError(f"babe_plan: route must be one of {ROUTES}, got {route!r}")
    if route != "block":
        rows = _group_rows(b, fact, torch.empty((), dtype=dtype).element_size())
        if rows is not None:
            return BabePlan("group", rows)
        if route == "group":
            raise ValueError(f"babe_plan: the group route does not take fact={fact!r} at "
                             f"b={b} in {dtype}")
    check_fits(b, dtype, fact)
    return BabePlan("block", 0)


def babe_thomas_solve(diag: Tensor, lower: Tensor, upper: Tensor, rhs: Tensor, *,
                      fact: str = "qr", plan: BabePlan | None = None) -> Tensor:
    """Batched block-tridiagonal solve by the two-way sweep (see the module
    docstring); ``plan`` (default ``babe_plan``'s) is for A/B comparisons of
    the routes."""
    _check(diag, lower, upper, rhs, name="babe_thomas_solve", max_block=MAX_BLOCK)
    lower_bs, upper_bs = _batch_stride(lower, "lower"), _batch_stride(upper, "upper")
    B, T, b, _ = diag.shape
    if T < 2:
        raise ValueError("babe_thomas_solve needs T >= 2 (T = 1 takes the one-way sweep)")
    if fact not in SWEEP_FACTS:
        raise ValueError(f"babe_thomas_solve: fact must be one of {SWEEP_FACTS}, got {fact!r}")
    if diag.device.type == "cpu":
        return babe_solve_plain(diag, lower, upper, rhs, fact)
    if diag.device.type != "cuda":
        raise ValueError(f"babe_thomas_solve runs on cuda or cpu, not {diag.device}")
    if plan is None:
        plan = babe_plan(b, fact, diag.dtype)
    x = torch.empty_like(rhs)
    if B == 0:
        return x
    cd = torch.empty((B, T, b, b + 1), dtype=diag.dtype, device=diag.device)
    with torch.cuda.device(diag.device):
        err = _entry()(
            0 if diag.dtype == torch.float32 else 1, *FACT_CODES[fact],
            diag.data_ptr(), lower.data_ptr(), upper.data_ptr(), rhs.data_ptr(),
            cd.data_ptr(), x.data_ptr(), B, T, b, lower_bs, upper_bs,
            _ROUTE_CODES[plan.route], plan.rows,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"two-way thomas kernel launch failed: CUDA error {err}")
    babe_thomas_solve.launches[fact] += 1
    babe_thomas_solve.route_launches[plan.route] += 1
    return x


babe_thomas_solve.launches = dict.fromkeys(SWEEP_FACTS, 0)
babe_thomas_solve.route_launches = dict.fromkeys(ROUTES, 0)


def _entry():
    from ._build import load

    fn = load("thomas_babe").mcp_babe_solve
    if fn.argtypes is None:
        vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [ci, ci, ci, vp, vp, vp, vp, vp, vp, ci, ci, ci, ll, ll, ci, ci, vp]
        fn.restype = ci
    return fn
