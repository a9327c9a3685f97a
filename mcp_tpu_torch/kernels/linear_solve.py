"""K4a, K4b/K4c, K5, K8a, K8b: batched dense solves of the Schur-condensed
Newton step.

Every function takes the JAX package's public layout: A (B, n, n), b (B, n),
float32 or float64.

* ``gj_solve(A, b) -> x``: Gauss–Jordan elimination without pivoting on
  [A | b] (K4a; replaces ``mcp_tpu/kernels/linear_solve.py::_gj_lanes_kernel``).
* ``gji_solve(A, b) -> (x, A⁻¹)``: the same elimination on [A | b | I], which
  leaves A⁻¹ on the identity columns (K5; replaces ``::_gji_lanes_kernel``).
* ``gauss_solve(A, b) -> x``: Householder QR without pivoting on [A | b],
  β = 1/(‖v‖(‖v‖+|v_k|)+eps), then back substitution (K4b/K4c; replaces
  ``::_qr_lanes_kernel`` and ``::_qr_solve_aug_kernel``, one function: the
  JAX package's B ≥ 128 gate between them is a TPU layout rule). A batch of
  one system goes to ``pallas_gauss_solve`` instead.
* ``pallas_gauss_solve(A, b) -> x``: Householder QR without pivoting with b
  kept apart from A, α = −sign(v_k)‖v‖ (‖v‖ = sqrt(v·v + eps)), u = v − α e_k,
  β = 2/(u·u + eps) (0 when u·u ≤ eps), A ← A − βu(uᵀA), b ← b − β(u·b)u,
  then back substitution with the raw R diagonal (K8a; replaces
  ``::_qr_solve_kernel``). On the card one thread block cluster solves one
  system, its CTAs holding column slabs of whole panels of
  ``QR_SEP_PANEL`` columns; each panel's reflections go to the other
  slabs as one compact-WY block reflector (``qr_sep_plan``, and the
  source's header). The JAX package reaches it by an unbatched
  ``gauss_solve``, i.e. every one-instance solve on "schur_pallas"; this
  port's one-instance solve is a batch of one, so ``gauss_solve`` routes
  B = 1 here. (A vmapped batch of one goes to K4c in the JAX package: the
  two round differently, not in what they solve.)
* ``wy_solve(A, b, *, panel=8) -> x``: the same reflections (K8a's β) in
  panels of ``panel`` columns accumulated as a compact-WY block reflector
  I − U·T·Uᵀ (LAPACK's larft, forward and columnwise: T[:k, k] = −β·T·(Uᵀu),
  T[k, k] = β), the trailing matrix and b updated once per panel,
  A ← A − U·(Tᵀ·(UᵀA)); n is padded to a multiple of ``panel`` with identity
  rows and columns (K8b; replaces ``::_wy_qr_solve_kernel``; no tier reaches
  it, the JAX package's ``scripts/profile_qp_phases.py`` times it beside
  the unblocked QR). Two routes, picked by ``wy_plan(n, panel, dtype)``:
  ``"pair"`` (float32, panel 8, K4b's pair layout in registers; each panel
  factored warp-synchronously by one half-warp, then one block barrier and
  the block reflector applied by every trailing pair) or ``"block"``
  ([A | b], the panel, U and T in shared memory); ``wy_solve`` counts
  launches per route in ``.route_launches``.

Failure semantics are the reference's. GJ guards its pivot as
``1/where(|p| > 1e-30, p, 1e-30)``: a zero pivot gives huge values, not NaN.
QR keeps eps = 1e-30 inside the norm and in β and divides by the raw R
diagonal: a zero pivot gives inf/NaN, which the solver reads as a failed
linear solve. GJ is stable only on (near-)SPD systems, the convex-QP Schur
matrices; the QR solve takes any nonsingular system.

The TPU kernels pad n to a multiple of 8 and B to 128 lanes and store the
batch column-major on lanes; none of that is carried over (the padded
identity rows are decoupled, so dropping them changes no result).

A CUDA tensor launches the hand-written kernel (``csrc/gauss_jordan.cu``,
``csrc/qr_dense.cu``, ``csrc/qr_sep.cu``, ``csrc/wy_qr.cu``) or raises; a
CPU tensor runs the plain PyTorch version of the same algebra
(``gj_solve_plain``, ``gji_solve_plain``, ``qr_solve_plain``,
``qr_solve_sep_plain``, ``wy_solve_plain``). Each wrapper counts its kernel
launches in ``.launches``. K4a and K5 have two routes, picked by
``gj_plan(n, inverse, dtype)``, a plain function of the shapes: ``"tile"``
(n ≤ 128: the n + 1 slots of [A | b] in registers, cyclically over an
8 × 32 thread grid; K5 turns slot k into identity column k at step k) or
``"block"`` (the augmented matrix in shared memory); ``gj_solve`` and
``gji_solve`` count launches per route in ``.route_launches``. K4b/K4c has
two routes as well, picked by ``qr_plan(n, dtype)``: ``"pair"`` (n + 1 ≤
128 in float32, n ≤ 104 in float64, within the register budget: lanes 2c
and 2c + 1 hold column c of [A | b] in registers, half its
rows each, the owner pair's reflector broadcast through shared memory with
one barrier a reflection; R retired to shared memory and back-substituted
by one warp) or ``"block"`` ([A | b] in shared memory); ``gauss_solve``
counts launches per route in ``.route_launches``.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from .solve_aug import qr_solve_aug_plain

Tensor = torch.Tensor

_EPS = 1e-30
#: Shared memory one block may use on an H100 (232,448 bytes), less what the
#: kernels keep beside the augmented matrix.
_SMEM_LIMIT = 232448


def _gj_eliminate(M: Tensor, n: int) -> Tensor:
    """Gauss–Jordan without pivoting on the (B, n, nc) augmented M, column
    by column, as the TPU kernels do: f = M[:, k]·inv, every other row minus
    f·(row k), row k times inv. With identity columns (nc = 2n+1) step k
    touches only the columns before identity column k+1: row k is 0 on the
    later ones, so the update would leave them as they are."""
    nc = M.shape[2]
    rows = torch.arange(n, device=M.device)
    for k in range(n):
        hi = min(nc, n + 2 + k)
        p = M[:, k, k]
        inv = 1.0 / torch.where(p.abs() > _EPS, p, torch.full_like(p, _EPS))
        f = M[:, :, k] * inv[:, None]
        fm = torch.where(rows == k, torch.zeros_like(f), f)
        rowk = M[:, k : k + 1, :hi]
        M = torch.cat([M[:, :, :hi] - fm[:, :, None] * rowk, M[:, :, hi:]], dim=2)
        M[:, k, :hi] = rowk[:, 0, :] * inv[:, None]
    return M


def gj_solve_plain(A: Tensor, b: Tensor) -> Tensor:
    """K4a's algebra in batched PyTorch ops, on any device."""
    n = A.shape[-1]
    return _gj_eliminate(torch.cat([A, b[:, :, None]], dim=2), n)[:, :, n]


def gji_solve_plain(A: Tensor, b: Tensor) -> tuple[Tensor, Tensor]:
    """K5's algebra in batched PyTorch ops, on any device."""
    B, n, _ = A.shape
    eye = torch.eye(n, dtype=A.dtype, device=A.device).expand(B, n, n)
    M = _gj_eliminate(torch.cat([A, b[:, :, None], eye], dim=2), n)
    return M[:, :, n], M[:, :, n + 1 :]


def qr_solve_plain(A: Tensor, b: Tensor) -> Tensor:
    """K4b/K4c's algebra in batched PyTorch ops, on any device: the
    Householder solve of K1's steps (``solve_aug.qr_solve_aug_plain``) on [A | b]."""
    n = A.shape[-1]
    return qr_solve_aug_plain(torch.cat([A, b[:, :, None]], dim=2), n)[:, :, 0]


def _reflector(v: Tensor, k: int):
    """K8a's Householder reflector of the column v (S, n), zero above row
    k: (u, β) with α = −sign(v_k)·sqrt(v·v + eps), u = v − α e_k and
    β = 2/(u·u + eps), or 0 when u·u ≤ eps."""
    vk = v[:, k]
    norm = torch.sqrt((v * v).sum(dim=1) + _EPS)
    alpha = -torch.where(vk >= 0, 1.0, -1.0).to(v.dtype) * norm
    u = v.clone()
    u[:, k] = vk - alpha
    uu = (u * u).sum(dim=1)
    beta = torch.where(uu > _EPS, 2.0 / (uu + _EPS), torch.zeros_like(uu))
    return u, beta


def _back_substitute(R: Tensor, c: Tensor) -> Tensor:
    """x with R x = c for the upper triangle of R (S, n, n), the raw
    diagonal as the divisor."""
    x = torch.zeros_like(c)
    for k in range(R.shape[1] - 1, -1, -1):
        x[:, k] = (c[:, k] - (R[:, k] * x).sum(dim=1)) / R[:, k, k]
    return x


def qr_solve_sep_plain(A: Tensor, b: Tensor) -> Tensor:
    """K8a's algebra in batched PyTorch ops, on any device: n reflections
    each applied to A and to b apart, then back substitution."""
    n = A.shape[-1]
    rows = torch.arange(n, device=A.device)
    for k in range(n):
        u, beta = _reflector(torch.where(rows >= k, A[:, :, k], 0.0), k)
        w = (u[:, None, :] @ A)[:, 0]
        A = A - (beta[:, None] * u)[:, :, None] * w[:, None, :]
        b = b - (beta * (u * b).sum(dim=1))[:, None] * u
    return _back_substitute(A, b)


def _pad_to_panel(A: Tensor, b: Tensor, panel: int):
    """A, b padded with identity rows and columns to n a multiple of
    ``panel`` (the pad is decoupled: x there is 0)."""
    B, n, _ = A.shape
    npad = -n % panel
    if npad == 0:
        return A, b
    Ap = A.new_zeros((B, n + npad, n + npad))
    Ap[:, :n, :n] = A
    Ap[:, n:, n:] = torch.eye(npad, dtype=A.dtype, device=A.device)
    return Ap, torch.cat([b, b.new_zeros((B, npad))], dim=1)


def wy_solve_plain(A: Tensor, b: Tensor, panel: int = 8) -> Tensor:
    """K8b's algebra in batched PyTorch ops, on any device: per panel of
    ``panel`` columns, the reflections confined to the panel with T
    accumulated by larft, then A ← A − U·(Tᵀ·(UᵀA)) and b likewise; back
    substitution on the padded system."""
    n0 = A.shape[-1]
    A, b = _pad_to_panel(A, b, panel)
    S, n, _ = A.shape
    rows = torch.arange(n, device=A.device)
    for j0 in range(0, n, panel):
        P = A[:, :, j0 : j0 + panel]
        U = A.new_zeros((S, n, panel))
        T = A.new_zeros((S, panel, panel))
        for k in range(panel):
            u, beta = _reflector(torch.where(rows >= j0 + k, P[:, :, k], 0.0), j0 + k)
            w = (u[:, None, :] @ P)[:, 0]
            P = P - (beta[:, None] * u)[:, :, None] * w[:, None, :]
            z = -beta[:, None] * (T @ (u[:, None, :] @ U)[:, 0, :, None])[..., 0]
            T = T.clone()
            T[:, :, k] += z
            T[:, k, k] += beta
            U = U.clone()
            U[:, :, k] = u
        A = A - U @ (T.mT @ (U.mT @ A))
        b = b - (U @ (T.mT @ (U.mT @ b[..., None])))[..., 0]
    return _back_substitute(A, b)[:, :n0]


def _check(name: str, A: Tensor, b: Tensor):
    if A.dim() != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"{name}: A must be (B, n, n), got {tuple(A.shape)}")
    if tuple(b.shape) != tuple(A.shape[:2]):
        raise ValueError(f"{name}: b must be {tuple(A.shape[:2])}, got {tuple(b.shape)}")
    if A.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{name} takes float32/float64, got {A.dtype}")
    if b.dtype != A.dtype or b.device != A.device:
        raise ValueError(f"{name}: A and b must share dtype and device")
    if not (A.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{name}: A and b must be contiguous")
    if A.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {A.device}")


def _smem_bytes(n: int, cols: int, itemsize: int) -> int:
    """The kernels' shared memory: the (n, cols) augmented matrix plus two
    vectors of n and cols entries (multipliers or u, and row k or w)."""
    return itemsize * (n * cols + n + cols + 1)


#: K8a's panel width (``kNb`` of ``csrc/qr_sep.cu``) and its largest cluster
#: (the portable maximum).
QR_SEP_PANEL = 8
MAX_CLUSTER = 8


@dataclasses.dataclass(frozen=True)
class SepPlan:
    """K8a's launch for one system of order n: ``cluster`` CTAs of
    ``threads`` threads, CTA r owning columns ``bounds[r]:bounds[r+1]``
    (whole panels; the last CTA also holds b), ``smem_per_cta`` bytes of
    dynamic shared memory in each."""

    cluster: int
    threads: int
    bounds: tuple
    smem_per_cta: int


def _qr_sep_smem_bytes(n: int, wsmax: int, itemsize: int) -> int:
    """K8a's shared memory per CTA (``sep_elems`` of ``csrc/qr_sep.cu``):
    the slab (n rows, row stride odd and above ``wsmax`` + 1 for b), U
    and T twice (double-buffered), the two panel-row products W, larft's
    Uᵀu and β, the right-hand side and one 32-column chunk of x."""
    nb = QR_SEP_PANEL
    lda = (wsmax + 1) | 1
    return itemsize * (n * lda + 2 * n * (nb + 1) + 2 * nb * nb + 2 * nb * lda + nb * nb
                       + nb + n + 32)


def qr_sep_plan(n: int, dtype) -> SepPlan:
    """K8a's cluster plan for order n: C = 8 CTAs from 16 panels of
    ``QR_SEP_PANEL`` columns on (n ≥ 121), 4 from 8, 2 from 4, else 1, the
    panels spread evenly with the extra ones on the first CTAs. Raises
    ``ValueError`` when a slab does not fit the card's shared memory per
    block even with C = 8."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    npan = -(-n // QR_SEP_PANEL)
    C = next(c for c in (8, 4, 2, 1) if npan >= 2 * c or c == 1)
    per, extra = divmod(npan, C)
    bounds = [0]
    for r in range(C):
        bounds.append(min(n, bounds[-1] + QR_SEP_PANEL * (per + (r < extra))))
    wsmax = max(bounds[r + 1] - bounds[r] for r in range(C))
    need = _qr_sep_smem_bytes(n, wsmax, itemsize)
    if need > _SMEM_LIMIT:
        raise ValueError(
            f"pallas_gauss_solve: n={n} in {dtype} needs {need} bytes of shared memory "
            f"per CTA in a cluster of {C}, over the card's {_SMEM_LIMIT} per block"
        )
    return SepPlan(C, 256, tuple(bounds), need)


def _wy_smem_bytes(n: int, panel: int, itemsize: int) -> int:
    """K8b's shared memory (``csrc/wy_qr.cu``) at the padded n: A (row
    stride n+1), b, u, the panel P and U (n × panel each), T (panel²), the
    (panel × (n+1)) product Tᵀ(Uᵀ[A | b]), w, Uᵀu and four scalars."""
    return itemsize * (n * (n + 1) + 2 * n + 2 * n * panel + panel * panel
                       + panel * (n + 1) + 2 * panel + 4)


def _check_fits(name: str, n: int, cols: int, dtype, need=None):
    if need is None:
        need = _smem_bytes(n, cols, torch.empty((), dtype=dtype).element_size())
    if need > _SMEM_LIMIT:
        raise ValueError(
            f"{name}: n={n} in {dtype} needs {need} bytes of shared memory, "
            f"over the card's {_SMEM_LIMIT} per block"
        )


#: The tile route of K4a/K5 (``csrc/gauss_jordan.cu``): thread (ty, tx) of
#: a TY × TX = 8 × 32 grid holds rows ty + 8 r, r < R, and slots tx + 32 c,
#: c < C, of the n + 1 slots of [A | b], with R an even number of rows up to
#: 16 (n ≤ 128) and C = ⌈(8 R + 1)/32⌉; its register budget is the R × C
#: tile plus row k's C values and the R multipliers, in 32-bit registers.
#: These are the kernel's own (``kTY``, ``kTX``, ``dispatch``'s cases,
#: ``kTileRegs``).
TILE_GRID = (8, 32)
TILE_ROWS = (2, 4, 6, 8, 10, 12, 14, 16)
TILE_REGS = 208
GJ_ROUTES = ("tile", "block")
_GJ_ROUTE_CODES = {"block": 0, "tile": 1}


@dataclasses.dataclass(frozen=True)
class GJPlan:
    """K4a's or K5's launch for one (n, inverse, dtype): ``route`` "tile" or
    "block" (256 threads and one system per block either way), and on the
    tile route the rows per thread ``rows`` (R; 0 on the block route)."""

    route: str
    rows: int


def gj_plan(n: int, inverse: bool, dtype, route: str | None = None) -> GJPlan:
    """K4a's (``inverse`` False) or K5's plan at order n in ``dtype``: the
    tile route for n ≤ 128 where the tile is within ``TILE_REGS``, else the
    block route. ``route`` forces one (the A/B comparison of
    ``chip_smoke.py``); raises ``ValueError`` where the route does not take
    the shape, or where the block route's matrix does not fit a block's
    shared memory."""
    if route not in (None, *GJ_ROUTES):
        raise ValueError(f"gj_plan: route must be one of {GJ_ROUTES}, got {route!r}")
    itemsize = torch.empty((), dtype=dtype).element_size()
    ty, tx = TILE_GRID
    rows = next((r for r in TILE_ROWS if n <= ty * r), None)
    if route != "block" and rows is not None:
        cols = -(-(ty * rows + 1) // tx)
        if ((rows + 1) * cols + rows) * (itemsize // 4) <= TILE_REGS:
            return GJPlan("tile", rows)
    if route == "tile":
        raise ValueError(f"gj_plan: the tile route does not take n={n} in {dtype}")
    _check_fits("gji_solve" if inverse else "gj_solve", n, 2 * n + 1 if inverse else n + 1,
                dtype)
    return GJPlan("block", 0)


def _gj_launch(wrapper, A: Tensor, b: Tensor, x: Tensor, inv, plan: GJPlan):
    B, n, _ = A.shape
    with torch.cuda.device(A.device):
        err = _entry("gauss_jordan", "mcp_gj_solve")(
            0 if A.dtype == torch.float32 else 1, A.data_ptr(), b.data_ptr(), x.data_ptr(),
            0 if inv is None else inv.data_ptr(), B, n, _GJ_ROUTE_CODES[plan.route],
            plan.rows, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"mcp_gj_solve launch failed: CUDA error {err}")
    wrapper.launches += 1
    wrapper.route_launches[plan.route] += 1


def gj_solve(A: Tensor, b: Tensor, *, plan: GJPlan | None = None) -> Tensor:
    """Gauss–Jordan solve without pivoting, A (B, n, n), b (B, n) → x (B, n)
    (K4a; see the module docstring); ``plan`` (default ``gj_plan``'s) is for
    A/B comparisons of the routes."""
    _check("gj_solve", A, b)
    if A.device.type == "cpu":
        return gj_solve_plain(A, b)
    n = A.shape[-1]
    x = torch.empty_like(b)
    if A.shape[0] and n:
        _gj_launch(gj_solve, A, b, x, None, plan or gj_plan(n, False, A.dtype))
    return x


gj_solve.launches = 0
gj_solve.route_launches = dict.fromkeys(GJ_ROUTES, 0)


def gji_solve(A: Tensor, b: Tensor, *, plan: GJPlan | None = None) -> tuple[Tensor, Tensor]:
    """Gauss–Jordan solve and explicit inverse without pivoting, A (B, n, n),
    b (B, n) → (x (B, n), A⁻¹ (B, n, n)) (K5; see the module docstring);
    ``plan`` (default ``gj_plan``'s) is for A/B comparisons of the routes."""
    _check("gji_solve", A, b)
    if A.device.type == "cpu":
        return gji_solve_plain(A, b)
    n = A.shape[-1]
    x, inv = torch.empty_like(b), torch.empty_like(A)
    if A.shape[0] and n:
        _gj_launch(gji_solve, A, b, x, inv, plan or gj_plan(n, True, A.dtype))
    return x, inv


gji_solve.launches = 0
gji_solve.route_launches = dict.fromkeys(GJ_ROUTES, 0)


#: The pair route of K4b/K4c (``csrc/qr_dense.cu``): lanes 2c and 2c + 1 of
#: a 256-thread block hold column c ≤ n of [A | b] (so n + 1 ≤ ``PAIR_COLS``),
#: each with H rows in registers, H the smallest row template with 2H ≥ n;
#: its register budget is the H values of one half-column, in 32-bit
#: registers. These are the kernel's own (``kPairCols``, ``dispatch``'s
#: cases, ``kPairRegs``).
PAIR_COLS = 128
PAIR_ROWS = (8, 16, 24, 32, 40, 48, 52, 64)
PAIR_REGS = 104
QR_ROUTES = ("pair", "block")
_QR_ROUTE_CODES = {"block": 0, "pair": 1}


@dataclasses.dataclass(frozen=True)
class QRPlan:
    """K4b/K4c's launch for one (n, dtype): ``route`` "pair" or "block"
    (256 threads and one system per block either way), and on the pair
    route the rows per thread ``rows`` (H; 0 on the block route)."""

    route: str
    rows: int


def qr_plan(n: int, dtype, route: str | None = None) -> QRPlan:
    """K4b/K4c's plan at order n in ``dtype``: the pair route for n + 1 ≤
    ``PAIR_COLS`` where the half-column is within ``PAIR_REGS``, else the
    block route. ``route`` forces one (the A/B comparison of
    ``chip_smoke.py``); raises ``ValueError`` where the route does not take
    the shape, or where the block route's matrix does not fit a block's
    shared memory. (The pair route's shared memory, R and two slots, fits
    a block at every n it takes.)"""
    if route not in (None, *QR_ROUTES):
        raise ValueError(f"qr_plan: route must be one of {QR_ROUTES}, got {route!r}")
    itemsize = torch.empty((), dtype=dtype).element_size()
    if route != "block":
        rows = next((r for r in PAIR_ROWS if n <= 2 * r), None)
        if (rows is not None and 1 <= n and n + 1 <= PAIR_COLS
                and rows * (itemsize // 4) <= PAIR_REGS):
            return QRPlan("pair", rows)
        if route == "pair":
            raise ValueError(f"qr_plan: the pair route does not take n={n} in {dtype}")
    _check_fits("gauss_solve", n, n + 1, dtype)
    return QRPlan("block", 0)


def gauss_solve(A: Tensor, b: Tensor, *, plan: QRPlan | None = None) -> Tensor:
    """Householder-QR solve without pivoting, A (B, n, n), b (B, n) →
    x (B, n): K4b/K4c, or K8a (``pallas_gauss_solve``) for a batch of one
    system (see the module docstring); ``plan`` (default ``qr_plan``'s) is
    for A/B comparisons of K4b/K4c's routes."""
    _check("gauss_solve", A, b)
    if A.shape[0] == 1:
        return pallas_gauss_solve(A, b)
    if A.device.type == "cpu":
        return qr_solve_plain(A, b)
    n = A.shape[-1]
    x = torch.empty_like(b)
    if A.shape[0] and n:
        plan = plan or qr_plan(n, A.dtype)
        with torch.cuda.device(A.device):
            err = _entry("qr_dense", "mcp_qr_solve")(
                0 if A.dtype == torch.float32 else 1, A.data_ptr(), b.data_ptr(),
                x.data_ptr(), A.shape[0], n, _QR_ROUTE_CODES[plan.route], plan.rows,
                torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"mcp_qr_solve launch failed: CUDA error {err}")
        gauss_solve.launches += 1
        gauss_solve.route_launches[plan.route] += 1
    return x


gauss_solve.launches = 0
gauss_solve.route_launches = dict.fromkeys(QR_ROUTES, 0)


def pallas_gauss_solve(A: Tensor, b: Tensor) -> Tensor:
    """Householder-QR solve without pivoting with b kept apart from A,
    A (B, n, n), b (B, n) → x (B, n) (K8a; see the module docstring)."""
    _check("pallas_gauss_solve", A, b)
    if A.device.type == "cpu":
        return qr_solve_sep_plain(A, b)
    B, n, _ = A.shape
    plan = qr_sep_plan(n, A.dtype) if n else None
    x = torch.empty_like(b)
    if B and n:
        bounds = (ctypes.c_int * (plan.cluster + 1))(*plan.bounds)
        with torch.cuda.device(A.device):
            err = _entry("qr_sep", "mcp_qr_sep_solve")(
                0 if A.dtype == torch.float32 else 1, A.data_ptr(), b.data_ptr(),
                x.data_ptr(), B, n, plan.cluster, bounds, plan.smem_per_cta,
                torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"mcp_qr_sep_solve launch failed: CUDA error {err}")
        pallas_gauss_solve.launches += 1
    return x


pallas_gauss_solve.launches = 0


#: The pair route of K8b (``csrc/wy_qr.cu``): K4b's pair layout and limits
#: (``PAIR_COLS``, ``PAIR_ROWS``), panels of ``WY_PAIR_PANEL`` columns
#: factored by one half-warp each (the kernel's ``kNb``), float32 only: in
#: float64 at (256, 104) it ran no faster on an H100 than the block route
#: (PERF.md), so the kernel has no float64 instance of it.
WY_PAIR_PANEL = 8
WY_ROUTES = ("pair", "block")
_WY_ROUTE_CODES = {"block": 0, "pair": 1}


@dataclasses.dataclass(frozen=True)
class WYPlan:
    """K8b's launch for one (padded n, panel, dtype): ``route`` "pair" or
    "block" (256 threads and one system per block either way), and on the
    pair route the rows per thread ``rows`` (H; 0 on the block route)."""

    route: str
    rows: int


def wy_plan(n: int, panel: int, dtype, route: str | None = None) -> WYPlan:
    """K8b's plan at order n (padded by the wrapper to a multiple of
    ``panel``) in ``dtype``: the pair route in float32 for ``panel`` =
    ``WY_PAIR_PANEL`` and n + 1 ≤ ``PAIR_COLS``, else the block route.
    ``route`` forces one
    (the A/B comparison of ``chip_smoke.py``); raises ``ValueError`` where
    the route does not take the shape, or where the block route's matrix
    does not fit a block's shared memory."""
    if route not in (None, *WY_ROUTES):
        raise ValueError(f"wy_plan: route must be one of {WY_ROUTES}, got {route!r}")
    if not 1 <= panel <= WY_MAX_PANEL:
        raise ValueError(f"wy_plan: panel must be in 1..{WY_MAX_PANEL}, got {panel}")
    itemsize = torch.empty((), dtype=dtype).element_size()
    npad = -(-n // panel) * panel
    if route != "block":
        rows = next((r for r in PAIR_ROWS if npad <= 2 * r), None)
        if (rows is not None and panel == WY_PAIR_PANEL and dtype == torch.float32
                and 1 <= npad and npad + 1 <= PAIR_COLS):
            return WYPlan("pair", rows)
        if route == "pair":
            raise ValueError(f"wy_plan: the pair route does not take n={n} (padded {npad}), "
                             f"panel {panel} in {dtype}")
    _check_fits("wy_solve", npad, npad + 1, dtype, _wy_smem_bytes(npad, panel, itemsize))
    return WYPlan("block", 0)


def wy_solve(A: Tensor, b: Tensor, *, panel: int = 8, plan: WYPlan | None = None) -> Tensor:
    """Compact-WY blocked Householder-QR solve, A (B, n, n), b (B, n) →
    x (B, n), in panels of ``panel`` ≤ 16 columns (K8b; see the module
    docstring); ``plan`` (default ``wy_plan``'s) is for A/B comparisons of
    its routes."""
    _check("wy_solve", A, b)
    if not 1 <= panel <= WY_MAX_PANEL:
        raise ValueError(f"wy_solve: panel must be in 1..{WY_MAX_PANEL}, got {panel}")
    if A.device.type == "cpu":
        return wy_solve_plain(A, b, panel)
    n0 = A.shape[-1]
    plan = plan or wy_plan(n0, panel, A.dtype)
    Ap, bp = _pad_to_panel(A, b, panel)
    n = Ap.shape[-1]
    x = torch.empty_like(bp)
    if A.shape[0] and n:
        B = A.shape[0]
        with torch.cuda.device(A.device):
            err = _entry("wy_qr", "mcp_wy_solve")(
                0 if A.dtype == torch.float32 else 1, Ap.data_ptr(), bp.data_ptr(),
                x.data_ptr(), B, n, panel, _WY_ROUTE_CODES[plan.route], plan.rows,
                torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"mcp_wy_solve launch failed: CUDA error {err}")
        wy_solve.launches += 1
        wy_solve.route_launches[plan.route] += 1
    return x[:, :n0]


wy_solve.launches = 0
wy_solve.route_launches = dict.fromkeys(WY_ROUTES, 0)
#: The widest panel K8b's kernel takes (its per-thread column products).
WY_MAX_PANEL = 16


def _entry(lib: str, symbol: str):
    from ._build import load

    fn = getattr(load(lib), symbol)
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        if lib == "qr_sep":
            fn.argtypes = [ci, vp, vp, vp, ci, ci, ci, ctypes.POINTER(ci), ctypes.c_longlong,
                           vp]
        else:
            nptr = 4 if lib == "gauss_jordan" else 3
            extra = {"wy_qr": [ci] * 3, "gauss_jordan": [ci, ci], "qr_dense": [ci, ci]}.get(lib, [])
            fn.argtypes = [ci] + [vp] * nptr + [ci, ci] + extra + [vp]
        fn.restype = ctypes.c_int
    return fn
