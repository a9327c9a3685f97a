"""K6: batched block-tridiagonal solve with k right-hand-side columns by the
one-way block-Thomas sweep.

``thomas_solve_multi(diag, lower, upper, rhs, *, fact="qr")`` solves, per
system, the block-tridiagonal system with diagonal blocks diag (B,T,b,b),
sub-diagonal blocks lower (B,T-1,b,b) (lower[t] couples block t+1 to t),
super-diagonal blocks upper (B,T-1,b,b) and k right-hand sides rhs (B,T,b,k)
→ x (B,T,b,k): the JAX package's ``pallas_block_thomas_multi``
(``mcp_tpu/kernels/thomas_pallas.py:628``), run by the SPIKE local stage of
the horizon-sharded solve (``parallel/horizon.py``, k = 2b+1).

Forward sweep: (D_t − L_t C_{t−1}) [C_t | d_t] = [U_t | R_t − L_t d_{t−1}] by
pivot-free Householder QR (``solve_aug``'s ``"qr"``); backward: x_t = d_t −
C_t x_{t+1} on all k columns. A zero or non-finite pivot gives inf/NaN in x.
The JAX package gates its kernel at 3b + k ≤ 128, a TPU lane rule; the card
takes every shape whose working set fits one block's shared memory and
refuses the rest.

diag, lower and upper are contiguous within each system; each may have any
batch stride, 0 included (a band expanded over the batch), so a T-slab view
of a longer band is taken as it is. rhs is contiguous.

A CUDA tensor launches the hand-written kernel ``csrc/thomas_multi.cu``
(which replaces ``mcp_tpu/kernels/thomas_pallas.py::
_thomas_kernel_packed_multi``, :572) or raises; a CPU tensor runs
``thomas_solve_multi_plain``, the same algebra in batched PyTorch ops. The
kernel has two routes, and ``multi_plan(b, k, dtype)``, a plain function of
the shapes, picks one: ``"group"`` (one thread per column of the step's
working matrix [D − LC | U | R − Ld], 2b + k ≤ 256 columns, with all its
rows in registers; b ≤ 48 where its tiles fit a block) or ``"block"`` (the
working matrix in shared memory; every other shape).
``thomas_solve_multi.launches`` counts kernel launches and
``thomas_solve_multi.route_launches`` launches per route.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from .solve_aug import SMEM_LIMIT, solve_aug_plain
from .thomas import check_fits

Tensor = torch.Tensor

#: The facts K6 takes (the JAX package's SPIKE stage runs QR only).
MULTI_FACTS = ("qr",)


def thomas_solve_multi_plain(diag: Tensor, lower: Tensor, upper: Tensor, rhs: Tensor,
                             fact: str = "qr") -> Tensor:
    """The multi-right-hand-side sweep in batched PyTorch ops, on any device
    (the reference the kernel is held against)."""
    B, T, b, _ = diag.shape
    zero = torch.zeros_like(diag[:, 0])
    Cs, ds = [], []
    for t in range(T):
        D, R = diag[:, t], rhs[:, t]
        if t > 0:
            L = lower[:, t - 1]
            D = D - L @ Cs[-1]
            R = R - L @ ds[-1]
        U = upper[:, t] if t < T - 1 else zero
        X = solve_aug_plain(torch.cat([D, U, R], dim=2), b, fact)
        Cs.append(X[..., :b])
        ds.append(X[..., b:])
    xs = [None] * T
    x_next = torch.zeros_like(rhs[:, 0])
    for t in range(T - 1, -1, -1):
        x_next = ds[t] - Cs[t] @ x_next
        xs[t] = x_next
    return torch.stack(xs, dim=1)


def _check(diag: Tensor, lower: Tensor, upper: Tensor, rhs: Tensor):
    if diag.dim() != 4 or diag.shape[2] != diag.shape[3]:
        raise ValueError(f"diag must be (B, T, b, b), got {tuple(diag.shape)}")
    B, T, b, _ = diag.shape
    if T < 1:
        raise ValueError("thomas_solve_multi needs T >= 1")
    for name, a in (("lower", lower), ("upper", upper)):
        if tuple(a.shape) != (B, T - 1, b, b):
            raise ValueError(f"{name} must be {(B, T - 1, b, b)}, got {tuple(a.shape)}")
    if rhs.dim() != 4 or tuple(rhs.shape[:3]) != (B, T, b):
        raise ValueError(f"rhs must be {(B, T, b)} + (k,), got {tuple(rhs.shape)}")
    for a in (lower, upper, rhs):
        if a.dtype != diag.dtype or a.device != diag.device:
            raise ValueError("diag, lower, upper, rhs must share dtype and device")
    if diag.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"thomas_solve_multi takes float32/float64, got {diag.dtype}")
    if not rhs.is_contiguous():
        raise ValueError("rhs must be contiguous")


def _system_stride(a: Tensor, name: str) -> int:
    """Batch stride (elements) of a band whose every system is contiguous:
    any stride, 0 for a band expanded over the batch."""
    if a.shape[0] == 0 or a[0].numel() == 0:
        return 0
    if not a[0].is_contiguous():
        raise ValueError(f"{name} must be contiguous within a system")
    return a.stride(0) if a.shape[0] > 1 else 0


#: The group route (``csrc/thomas_multi.cu``): its row templates (b ≤ BM
#: rows per column, BM the smallest that holds b; one BM-long column per
#: thread, 96 registers of doubles at BM = 48) and its widest group (one
#: thread per column of [D − LC | U | R − Ld]: 128 threads where 2b + k ≤
#: 128, else 256). These are the kernel's own (``dispatch``'s cases,
#: ``kMaxGroup``); the C entry derives the shared memory of either route
#: itself.
GROUP_ROWS = (8, 16, 24, 32, 40, 48)
GROUP_MAX_THREADS = 256
ROUTES = ("group", "block")
_ROUTE_CODES = {"block": 0, "group": 1}


@dataclasses.dataclass(frozen=True)
class MultiPlan:
    """K6's launch for one (b, k, dtype): ``route`` "group" (one thread per
    column of the working matrix) or "block" (256 threads per system), and
    on the group route the row template ``rows`` (BM; 0 on the block
    route)."""

    route: str
    rows: int


def group_smem_bytes(b: int, k: int, rows: int, itemsize: int) -> int:
    """Shared memory of the group route (``mg_elems`` of
    ``csrc/thomas_multi.cu``), each region rounded up to 4 elements: two
    staging buffers, each [D | U | R] (2b + k columns at the odd stride
    BM + 1) and L^T or R^T (b rows of BM); [C | d] (b + k columns at stride
    BM + 1); two slots of BM + 4 values; 1/R[k][k] (BM)."""
    r4 = lambda v: -(-v // 4) * 4
    stage = r4((2 * b + k) * (rows + 1)) + r4(b * rows)
    return itemsize * (2 * stage + r4((b + k) * (rows + 1)) + 2 * r4(rows + 4) + r4(rows))


def _group_rows(b: int, k: int, itemsize: int):
    """The group route's row template at (b, k, itemsize), or None where it
    does not take the shape."""
    rows = next((r for r in GROUP_ROWS if b <= r), None)
    if (rows is None or k < 1 or 2 * b + k > GROUP_MAX_THREADS
            or group_smem_bytes(b, k, rows, itemsize) > SMEM_LIMIT):
        return None
    return rows


def multi_plan(b: int, k: int, dtype, route: str | None = None) -> MultiPlan:
    """K6's plan for blocks of b with k right-hand sides in ``dtype``: the
    group route where it takes the shape, else the block route. ``route``
    forces one (the A/B comparison of ``chip_smoke.py``); raises
    ``ValueError`` where the route does not take the shape, and where the
    block route's working set does not fit one block's shared memory."""
    if route not in (None, *ROUTES):
        raise ValueError(f"multi_plan: route must be one of {ROUTES}, got {route!r}")
    if route != "block":
        rows = _group_rows(b, k, torch.empty((), dtype=dtype).element_size())
        if rows is not None:
            return MultiPlan("group", rows)
        if route == "group":
            raise ValueError(f"multi_plan: the group route does not take b={b}, k={k} "
                             f"in {dtype}")
    check_fits(b, "qr", dtype, name="thomas_solve_multi", k=k)
    return MultiPlan("block", 0)


def thomas_solve_multi(diag: Tensor, lower: Tensor, upper: Tensor, rhs: Tensor, *,
                       fact: str = "qr", plan: MultiPlan | None = None) -> Tensor:
    """Batched block-tridiagonal solve with k right-hand sides (see the
    module docstring); ``plan`` (default ``multi_plan``'s) is for A/B
    comparisons of the routes."""
    _check(diag, lower, upper, rhs)
    strides = [_system_stride(a, n) for a, n in ((diag, "diag"), (lower, "lower"),
                                                  (upper, "upper"))]
    if fact not in MULTI_FACTS:
        raise ValueError(f"thomas_solve_multi: fact must be one of {MULTI_FACTS}, "
                         f"got {fact!r}")
    if diag.device.type == "cpu":
        return thomas_solve_multi_plain(diag, lower, upper, rhs, fact)
    if diag.device.type != "cuda":
        raise ValueError(f"thomas_solve_multi runs on cuda or cpu, not {diag.device}")
    B, T, b, _ = diag.shape
    k = rhs.shape[3]
    if plan is None:
        plan = multi_plan(b, k, diag.dtype)
    x = torch.empty_like(rhs)
    if B == 0 or k == 0:
        return x
    cd = torch.empty((B, T, b, b + k), dtype=diag.dtype, device=diag.device)
    with torch.cuda.device(diag.device):
        err = _entry()(
            0 if diag.dtype == torch.float32 else 1,
            diag.data_ptr(), lower.data_ptr(), upper.data_ptr(), rhs.data_ptr(),
            cd.data_ptr(), x.data_ptr(), B, T, b, k, *strides,
            _ROUTE_CODES[plan.route], plan.rows, torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"thomas_multi kernel launch failed: CUDA error {err}")
    thomas_solve_multi.launches += 1
    thomas_solve_multi.route_launches[plan.route] += 1
    return x


thomas_solve_multi.launches = 0
thomas_solve_multi.route_launches = dict.fromkeys(ROUTES, 0)


def _entry():
    from ._build import load

    fn = load("thomas_multi").mcp_thomas_solve_multi
    if fn.argtypes is None:
        vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [ci, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ll, ll, ll, ci, ci, vp]
        fn.restype = ctypes.c_int
    return fn
