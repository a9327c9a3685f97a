"""K1: batched block-tridiagonal solve by the one-way block-Thomas sweep.

``thomas_solve(diag, lower, upper, rhs, *, fact)`` solves, per system, the block-
tridiagonal system with diagonal blocks diag (B,T,b,b), sub-diagonal blocks
lower (B,T-1,b,b) (lower[t] couples block t+1 to block t), super-diagonal
blocks upper (B,T-1,b,b) and right-hand side rhs (B,T,b) → x (B,T,b): the
layout of the JAX package's ``pallas_block_thomas``. lower/upper may be one
band expanded over the batch (batch stride 0).

Forward sweep: (D_t − L_t C_{t−1}) [C_t | d_t] = [U_t | r_t − L_t d_{t−1}]
by the in-block factorization ``fact`` (``solve_aug``: ``"qr"``, pivot-free
Householder QR, the default; ``"gj"``, ``"gjp"`` or ``"gjpr"``, the
Gauss–Jordan facts); backward: x_t = d_t − C_t x_{t+1}. A zero or non-finite
QR pivot gives inf/NaN in x; a Gauss–Jordan pivot is clamped to 1e-30.

A CUDA tensor launches the hand-written kernel ``csrc/thomas.cu`` (which
replaces ``mcp_tpu/kernels/thomas_pallas.py::_thomas_kernel_lanes``, QR only,
and ``_thomas_kernel_packed`` with its facts) or raises; a CPU tensor runs
``thomas_solve_plain``, the same algebra in batched PyTorch ops. The kernel
has two routes, and ``thomas_plan(b, fact, dtype)``, a plain function of the
shapes, picks one: ``"warp"`` (one warp per system, the step's working
matrix in registers, column-owned by the lanes; b ≤ 32 within the register
budget) or ``"block"`` (one thread block per system, the working matrix in
shared memory; every other shape). ``thomas_solve.launches`` counts kernel
launches per fact and ``thomas_solve.route_launches`` per route (dicts).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from .solve_aug import FACT_CODES, SMEM_LIMIT, aug_smem_bytes, solve_aug_plain

Tensor = torch.Tensor

#: Largest block size the sweep takes (the Pallas sweep's own range).
MAX_BLOCK = 64
#: The facts of the sweeps K1 and K7a (the JAX package's packed sweeps).
SWEEP_FACTS = ("qr", "gj", "gjp", "gjpr")


def thomas_solve_plain(diag: Tensor, lower: Tensor, upper: Tensor, rhs: Tensor,
                       fact: str = "qr") -> Tensor:
    """The block-Thomas sweep in batched PyTorch ops, on any device (the
    reference the kernel is held against)."""
    B, T, b, _ = diag.shape
    zero = torch.zeros_like(diag[:, 0])
    Cs, ds = [], []
    for t in range(T):
        D, r = diag[:, t], rhs[:, t]
        if t > 0:
            L = lower[:, t - 1]
            D = D - L @ Cs[-1]
            r = r - (L @ ds[-1][..., None])[..., 0]
        U = upper[:, t] if t < T - 1 else zero
        X = solve_aug_plain(torch.cat([D, U, r[..., None]], dim=2), b, fact)
        Cs.append(X[..., :b])
        ds.append(X[..., b])
    xs = [None] * T
    x_next = torch.zeros_like(rhs[:, 0])
    for t in range(T - 1, -1, -1):
        x_next = ds[t] - (Cs[t] @ x_next[..., None])[..., 0]
        xs[t] = x_next
    return torch.stack(xs, dim=1)


def _check(diag: Tensor, lower: Tensor, upper: Tensor, rhs: Tensor, name="thomas_solve",
           max_block=MAX_BLOCK):
    """Shapes, dtypes, devices and contiguity of a block-tridiagonal solve's
    operands (K1's layout, shared by K3)."""
    if diag.dim() != 4 or diag.shape[2] != diag.shape[3]:
        raise ValueError(f"diag must be (B, T, b, b), got {tuple(diag.shape)}")
    B, T, b, _ = diag.shape
    if T < 1:
        raise ValueError(f"{name} needs T >= 1")
    if max_block is not None and b > max_block:
        raise ValueError(f"{name} takes blocks up to b={max_block}, got b={b}")
    for name, a in (("lower", lower), ("upper", upper)):
        if tuple(a.shape) != (B, T - 1, b, b):
            raise ValueError(
                f"{name} must be {(B, T - 1, b, b)}, got {tuple(a.shape)}"
            )
    if tuple(rhs.shape) != (B, T, b):
        raise ValueError(f"rhs must be {(B, T, b)}, got {tuple(rhs.shape)}")
    for a in (lower, upper, rhs):
        if a.dtype != diag.dtype or a.device != diag.device:
            raise ValueError("diag, lower, upper, rhs must share dtype and device")
    if diag.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{name} takes float32/float64, got {diag.dtype}")
    if not (diag.is_contiguous() and rhs.is_contiguous()):
        raise ValueError("diag and rhs must be contiguous")


def _batch_stride(a: Tensor, name: str) -> int:
    """Batch stride (elements) of a band that is contiguous per system and
    either stored per system or expanded from one band (stride 0)."""
    if a.shape[0] == 0:
        return 0
    per = a[0].numel()
    if a.shape[0] > 1 and a.stride(0) not in (0, per):
        raise ValueError(f"{name} must be contiguous or expanded over the batch")
    if per and not a[0].is_contiguous():
        raise ValueError(f"{name} must be contiguous within a system")
    return 0 if a.shape[0] > 1 and a.stride(0) == 0 else per


def sweep_smem_bytes(b: int, fact: str, itemsize: int, k: int = 1) -> int:
    """Shared memory of one direction of the sweep with k right-hand-side
    columns (``csrc/thomas.cu::dir_bytes`` at k = 1, ``csrc/thomas_multi.cu``
    for K6): the working set of ``solve_aug.cuh`` for [D − LC | U | r] (plus
    I with refinement), the original [D − LC | U | r] with refinement, L
    (b×b, then the scratch slab) and [C | d] (b×(b+k))."""
    family, refine = FACT_CODES[fact]
    ld = 2 * b + k + (b if refine else 0)
    extra = (b * (2 * b + k) if refine else 0) + b * b + b * (b + k)
    return aug_smem_bytes(b, ld, family, 0, itemsize) + itemsize * extra


def check_fits(b: int, fact: str, dtype, directions: int = 1, name: str = "thomas_solve",
               k: int = 1):
    """Raise when ``directions`` working sets of the sweep at (b, fact, dtype)
    with k right-hand sides do not fit one block's shared memory (e.g. gjpr
    at b=64 in float64)."""
    need = directions * sweep_smem_bytes(
        b, fact, torch.empty((), dtype=dtype).element_size(), k)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"{name}: fact={fact!r} at b={b}" + (f", k={k}" if k != 1 else "")
            + f" in {dtype} needs {need} bytes of shared "
            f"memory, over the card's {SMEM_LIMIT} per block"
        )


#: The warp route's row templates (``csrc/thomas.cu``: b ≤ BM rows per
#: column, BM the smallest that holds b) and its register budget: the
#: lane's column groups plus one vector of BM values (the Householder vector
#: or the multipliers), in 32-bit registers. Both are the kernel's own
#: (``dispatch_warp``'s cases and ``kWarpRegs``); the C entry derives the
#: shared memory of either route itself.
WARP_ROWS = (8, 16, 24, 32)
WARP_REGS = 168
ROUTES = ("warp", "block")
_ROUTE_CODES = {"block": 0, "warp": 1}


@dataclasses.dataclass(frozen=True)
class ThomasPlan:
    """K1's launch for one (b, fact, dtype): ``route`` "warp" (one warp per
    system) or "block" (128 threads per system), and on the warp route the
    row template ``rows`` (BM; 0 on the block route)."""

    route: str
    rows: int


def _warp_rows(b: int, fact: str, itemsize: int):
    """The warp route's row template at (b, fact, itemsize), or None where
    b > 32 or the tile is over the register budget. Lane l holds columns
    l + 32 g of the [A | N] working matrix (2 BM + 1 columns, plus BM
    identity columns with refinement)."""
    rows = next((r for r in WARP_ROWS if b <= r), None)
    if rows is None:
        return None
    groups = -(-(2 * rows + 1 + (rows if FACT_CODES[fact][1] else 0)) // 32)
    return rows if (groups + 1) * rows * (itemsize // 4) <= WARP_REGS else None


def thomas_plan(b: int, fact: str, dtype, route: str | None = None) -> ThomasPlan:
    """K1's plan for blocks of b with ``fact`` in ``dtype``: the warp route
    where it takes the shape (b ≤ 32 and the tile within ``WARP_REGS``),
    else the block route. ``route`` forces one (the A/B comparison of
    ``chip_smoke.py``); raises ``ValueError`` where the route does not take
    the shape, and for what no route takes (b > 64; the block route's shared
    memory, e.g. gjpr at b=64 in float64)."""
    if fact not in SWEEP_FACTS:
        raise ValueError(f"thomas_solve: fact must be one of {SWEEP_FACTS}, got {fact!r}")
    if b > MAX_BLOCK:
        raise ValueError(f"thomas_solve takes blocks up to b={MAX_BLOCK}, got b={b}")
    if route not in (None, *ROUTES):
        raise ValueError(f"thomas_plan: route must be one of {ROUTES}, got {route!r}")
    if route != "block":
        rows = _warp_rows(b, fact, torch.empty((), dtype=dtype).element_size())
        if rows is not None:
            return ThomasPlan("warp", rows)
        if route == "warp":
            raise ValueError(f"thomas_plan: the warp route does not take fact={fact!r} at "
                             f"b={b} in {dtype}")
    check_fits(b, fact, dtype)
    return ThomasPlan("block", 0)


def thomas_solve(diag: Tensor, lower: Tensor, upper: Tensor, rhs: Tensor, *,
                 fact: str = "qr", plan: ThomasPlan | None = None) -> Tensor:
    """Batched block-tridiagonal solve (see the module docstring); ``plan``
    (default ``thomas_plan``'s) is for A/B comparisons of the routes."""
    _check(diag, lower, upper, rhs)
    lower_bs, upper_bs = _batch_stride(lower, "lower"), _batch_stride(upper, "upper")
    if fact not in SWEEP_FACTS:
        raise ValueError(f"thomas_solve: fact must be one of {SWEEP_FACTS}, got {fact!r}")
    if diag.device.type == "cpu":
        return thomas_solve_plain(diag, lower, upper, rhs, fact)
    if diag.device.type != "cuda":
        raise ValueError(f"thomas_solve runs on cuda or cpu, not {diag.device}")
    B, T, b, _ = diag.shape
    if plan is None:
        plan = thomas_plan(b, fact, diag.dtype)
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
        raise RuntimeError(f"thomas kernel launch failed: CUDA error {err}")
    thomas_solve.launches[fact] += 1
    thomas_solve.route_launches[plan.route] += 1
    return x


thomas_solve.launches = dict.fromkeys(SWEEP_FACTS, 0)
thomas_solve.route_launches = dict.fromkeys(ROUTES, 0)


def _entry():
    from ._build import load

    fn = load("thomas").mcp_thomas_solve
    if fn.argtypes is None:
        vp = ctypes.c_void_p
        ci, ll = ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [ci, ci, ci, vp, vp, vp, vp, vp, vp, ci, ci, ci, ll, ll, ci, ci, vp]
        fn.restype = ctypes.c_int
    return fn
