"""K3: batched block-tridiagonal solve by block cyclic reduction.

``cr_thomas_solve(diag, lower, upper, rhs, *, fact)`` takes K1's layout:
diag (B,T,b,b), lower/upper (B,T-1,b,b) (lower[t] couples block t+1 to block
t; each band stored per system or expanded over the batch with stride 0),
rhs (B,T,b) → x (B,T,b). It computes what the JAX package's ``_cr_solve``
computes (``mcp_tpu/kernels/thomas_pallas.py:1055``, inside
``_thomas_kernel_cr_packed`` and ``_thomas_kernel_cr_split``):

* an odd T is padded with one decoupled identity block (x there is 0);
* each level solves the odd blocks against [L_odd | U_odd | r_odd] with one
  augmented b×(3b+1) solve per block, folds them into the even rows
      D' = D_e − U_e·D_o⁻¹L_o − L_e·D_{o−1}⁻¹U_{o−1},  r' likewise,
      L' = −L_e·D_{o−1}⁻¹L_{o−1},  U' = −U_e·D_o⁻¹U_o,
  recurses on the half-size system (T=30 → 16 → 8 → 4 → 2 → 1) and
  back-substitutes x_o = D_o⁻¹r_o − D_o⁻¹L_o·x_e − D_o⁻¹U_o·x_{e+1};
* the T=1 base solves [D | r].

The in-block factorization ``fact`` is any fact of ``solve_aug`` (the JAX
package's ``_solve_aug``, ``:431``): ``"qr"``, ``"gj"``, ``"gjp"``,
``"gjpr"``, the blocked ``"gjb"``, ``"gjbr"``, ``"gjbr2"`` and the blocked
pivoted ``"gjbp"``, ``"gjbpr"``, ``"gjbpr2"``, ``"gjbprl"`` (gjbpr's algebra,
one kernel for both; their launches are counted apart), and ``"lu"`` in the
plain version only (``torch.linalg.solve``, the per-block LU of tier
"tridiag_cr").

Failure semantics are the JAX package's: a Gauss–Jordan pivot below 1e-30 in
magnitude is clamped to 1e-30 (with pivoting, a singular block's pivot row
is scaled by 1e30, but its head column stays zero, so the contraction leaves
finite values in that system); a zero QR pivot gives inf/NaN.

A CUDA tensor launches the hand-written kernel ``csrc/cyclic_reduction.cu``
or raises; a CPU tensor runs ``cr_solve_plain``, the same algebra in batched
PyTorch ops. On the card every odd-block solve runs on a thread block
cluster whose CTAs hold column slabs of the block's working matrix; the
launch plan (cluster size per level, slab bounds, shared memory per CTA)
comes from ``cr_plan``, a plain function of the shapes. A shape whose slab
does not fit a block even in a cluster of 8 raises ``ValueError``.
``cr_thomas_solve.launches`` counts the solves that launched the kernel, per
factorization (a dict keyed by ``fact``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from .solve_aug import FACT_CODES, FACTS, GJB_PANEL, SMEM_LIMIT, solve_aug_plain
from .thomas import _batch_stride, _check

Tensor = torch.Tensor


def _cr(D: Tensor, L: Tensor, U: Tensor, r: Tensor, b: int, fact: str) -> Tensor:
    """CR on padded bands: L[:, t] couples t to t−1 (L[:, 0] = 0), U[:, t]
    couples t to t+1 (U[:, T−1] = 0); r (S, T, b, 1) → x (S, T, b, 1)."""
    S, T = D.shape[:2]
    if T == 1:
        return solve_aug_plain(torch.cat([D[:, 0], r[:, 0]], dim=2), b, fact)[:, None]
    if T % 2:
        eye = torch.eye(b, dtype=D.dtype, device=D.device).expand(S, 1, b, b)
        zb = D.new_zeros((S, 1, b, b))
        x = _cr(torch.cat([D, eye], 1), torch.cat([L, zb], 1), torch.cat([U, zb], 1),
                torch.cat([r, r.new_zeros((S, 1, b, 1))], 1), b, fact)
        return x[:, :T]
    H = T // 2
    De, Do = D[:, 0::2], D[:, 1::2]
    Le, Lo = L[:, 0::2], L[:, 1::2]
    Ue, Uo = U[:, 0::2], U[:, 1::2]
    re, ro = r[:, 0::2], r[:, 1::2]
    M = torch.cat([Do, Lo, Uo, ro], dim=3).reshape(S * H, b, 3 * b + 1)
    sol = solve_aug_plain(M, b, fact).reshape(S, H, b, 2 * b + 1)
    DL, DU, Dr = sol[..., :b], sol[..., b : 2 * b], sol[..., 2 * b :]

    def shift_prev(A):  # pair k ← pair k−1, zero at k = 0
        return torch.cat([torch.zeros_like(A[:, :1]), A[:, :-1]], dim=1)

    DL_prev, DU_prev, Dr_prev = shift_prev(DL), shift_prev(DU), shift_prev(Dr)
    D_new = De - Ue @ DL - Le @ DU_prev
    r_new = re - Ue @ Dr - Le @ Dr_prev
    L_new = -(Le @ DL_prev)
    U_new = -(Ue @ DU)
    x_even = _cr(D_new, L_new, U_new, r_new, b, fact)
    x_next = torch.cat([x_even[:, 1:], torch.zeros_like(x_even[:, :1])], dim=1)
    x_odd = Dr - DL @ x_even - DU @ x_next
    return torch.stack([x_even, x_odd], dim=2).reshape(S, T, b, 1)


def cr_solve_plain(diag: Tensor, lower: Tensor, upper: Tensor, rhs: Tensor,
                   fact: str = "qr") -> Tensor:
    """Block cyclic reduction in batched PyTorch ops, on any device (the
    reference the kernel is held against); K1's layout."""
    B, T, b, _ = diag.shape
    zero = diag.new_zeros((B, 1, b, b))
    Lp = torch.cat([zero, lower.expand(B, T - 1, b, b)], dim=1)
    Up = torch.cat([upper.expand(B, T - 1, b, b), zero], dim=1)
    return _cr(diag, Lp, Up, rhs[..., None], b, fact)[..., 0]


#: The largest cluster (the portable maximum) and the threads of a CTA.
MAX_CLUSTER = 8
THREADS = 256
#: A working matrix wider than this many columns is split over a cluster:
#: a cluster barrier per elimination step costs more than a narrow slab
#: saves (``chip_smoke.py`` times the plan against uniform cluster sizes at
#: b=40 and b=100).
WIDE_SLAB = 256
#: At most this many solves per launch take the largest cluster.
FEW_SYSTEMS = 16
#: Rows of the left operand the products stage per pass (``kKT`` of
#: ``csrc/solve_aug_slab.cuh``).
_STAGE_ROWS = 16


@dataclasses.dataclass(frozen=True)
class SlabPlan:
    """One launch: clusters of ``cluster`` CTAs of ``threads`` threads, CTA
    r holding columns ``bounds[r]:bounds[r+1]`` of the working matrix (all
    b rows), ``smem_per_cta`` bytes of dynamic shared memory in each, on a
    grid of ``grid`` clusters."""

    cluster: int
    threads: int
    bounds: tuple
    smem_per_cta: int
    grid: int


@dataclasses.dataclass(frozen=True)
class CRPlan:
    """K3's launches: one per reduction level, then the T=1 base."""

    levels: tuple
    base: SlabPlan

    @property
    def launches(self):
        return self.levels + (self.base,)


def slab_smem_bytes(b: int, lds: int, family: int, refine: int, itemsize: int) -> int:
    """Shared-memory bytes of one CTA's working set (``slab_bytes`` of
    ``csrc/solve_aug_slab.cuh``): the slab (b × lds), two step buffers, the
    pivot rows, used flags and scalars, W (blocked facts), the scratch
    (blocked facts and refinement: kPanel × max(lds, b)), the staged left
    operand of the products (16 × b) and the pivot rows (ints)."""
    blocked = family >= 3
    scratch = GJB_PANEL * max(lds, b) if (blocked or refine) else 0
    elems = (b * lds + 2 * (b + 2) + max(lds, GJB_PANEL) + GJB_PANEL + b + 4
             + (b * GJB_PANEL if blocked else 0) + scratch + _STAGE_ROWS * b)
    return itemsize * elems + 4 * b


def slab_bounds(ld: int, C: int, b: int, blocked: bool):
    """The C + 1 slab bounds of ld columns, as even as the rule allows: for
    the blocked facts a bound inside the head (< b) sits on a multiple of
    the panel width, so no panel straddles two slabs. None when two bounds
    meet."""
    bounds = [0]
    for r in range(1, C):
        x = (2 * r * ld + C) // (2 * C)
        if blocked and x < b:
            x = GJB_PANEL * max(1, (2 * x + GJB_PANEL) // (2 * GJB_PANEL))
        bounds.append(x)
    bounds.append(ld)
    if any(hi <= lo for lo, hi in zip(bounds, bounds[1:])):
        return None
    return tuple(bounds)


def _launch_plan(nsys: int, b: int, ld: int, family: int, refine: int, itemsize: int):
    """The launch of ``nsys`` solves of b × ld: one CTA per solve when the
    working matrix is at most ``WIDE_SLAB`` columns wide, else clusters of
    2, or of 8 for at most ``FEW_SYSTEMS`` solves (which leave most of the
    card's SMs idle otherwise); the smallest cluster from there up whose
    widest slab fits the shared memory of a block. None when no cluster of
    ≤ MAX_CLUSTER holds a slab."""
    want = 1 if ld <= WIDE_SLAB else (MAX_CLUSTER if nsys <= FEW_SYSTEMS else 2)
    C = 1
    while C <= MAX_CLUSTER:
        bounds = slab_bounds(ld, C, b, family >= 3)
        if C >= want and bounds is not None:
            wsmax = max(hi - lo for lo, hi in zip(bounds, bounds[1:]))
            smem = slab_smem_bytes(b, wsmax, family, refine, itemsize)
            if smem <= SMEM_LIMIT:
                return SlabPlan(C, THREADS, bounds, smem, nsys)
        C *= 2
    return None


def _level_shapes(T: int):
    """Pairs H of each reduction level (T = 30 → 15, 8, 4, 2, 1)."""
    out, t = [], T
    while t > 1:
        H = (t + (t & 1)) // 2
        out.append(H)
        t = H
    return out


@functools.lru_cache(maxsize=None)
def _cached_plan(B, T, b, fact, itemsize):
    family, refine = FACT_CODES[fact]
    nc_red = 3 * b + 1 + (b if refine else 0)
    nc_base = b + 1 + (b if refine else 0)
    levels = []
    for H in _level_shapes(T):
        lp = _launch_plan(H * B, b, nc_red, family, refine, itemsize)
        if lp is None:
            return None
        levels.append(lp)
    base = _launch_plan(B, b, nc_base, family, refine, itemsize)
    return None if base is None else CRPlan(tuple(levels), base)


def cr_plan(B: int, T: int, b: int, fact: str, dtype) -> CRPlan:
    """K3's launch plan for B systems of T blocks of b with ``fact``: per
    level (H·B odd-block solves of b × (3b+1), plus b identity columns with
    refinement) and for the base (B solves of b × (b+1)), the cluster size
    C ∈ {1, 2, 4, 8} of ``_launch_plan``, whose widest slab fits the card's
    232,448 bytes of shared memory per block. Raises ``ValueError`` when
    none does."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    plan = _cached_plan(B, T, b, fact, itemsize)
    if plan is None:
        raise ValueError(
            f"cr_thomas_solve: fact={fact!r} at b={b} in {dtype} does not fit the card's "
            f"{SMEM_LIMIT} bytes of shared memory per block even in a cluster of "
            f"{MAX_CLUSTER}"
        )
    return plan


def check_fits(b: int, fact: str, dtype):
    """Raise ``ValueError`` when no cluster of ≤ 8 CTAs holds an odd-block
    solve of b × (3b+1) (plus b identity columns with refinement) with
    ``fact`` in slabs of the card's shared memory per block."""
    cr_plan(1, 2, b, fact, dtype)


@functools.lru_cache(maxsize=None)
def _plan_ints(plan: CRPlan):
    """The plan as the C entry reads it: per launch C, threads, shared
    memory per CTA and the C + 1 bounds, padded to 12 ints."""
    flat = []
    for lp in plan.launches:
        rec = [lp.cluster, lp.threads, lp.smem_per_cta, *lp.bounds]
        flat += rec + [0] * (3 + MAX_CLUSTER + 1 - len(rec))
    return (ctypes.c_int * len(flat))(*flat)


def cr_thomas_solve(diag: Tensor, lower: Tensor, upper: Tensor, rhs: Tensor, *,
                    fact: str = "qr") -> Tensor:
    """Batched block-tridiagonal solve by cyclic reduction (see the module
    docstring)."""
    if fact not in FACTS:
        raise ValueError(f"fact must be one of {FACTS}, got {fact!r}")
    _check(diag, lower, upper, rhs, name="cr_thomas_solve", max_block=None)
    lower_bs, upper_bs = _batch_stride(lower, "lower"), _batch_stride(upper, "upper")
    if diag.device.type == "cpu":
        return cr_solve_plain(diag, lower, upper, rhs, fact)
    if diag.device.type != "cuda":
        raise ValueError(f"cr_thomas_solve runs on cuda or cpu, not {diag.device}")
    B, T, b, _ = diag.shape
    x = torch.empty_like(rhs)
    if B == 0:
        check_fits(b, fact, diag.dtype)
        return x
    plan = cr_plan(B, T, b, fact, diag.dtype)
    lib = _lib()
    work = torch.empty(lib.mcp_cr_workspace(B, T, b), dtype=diag.dtype, device=diag.device)
    with torch.cuda.device(diag.device):
        err = lib.mcp_cr_solve(
            0 if diag.dtype == torch.float32 else 1, *FACT_CODES[fact],
            diag.data_ptr(), lower.data_ptr(), upper.data_ptr(), rhs.data_ptr(),
            work.data_ptr(), x.data_ptr(), B, T, b, lower_bs, upper_bs, _plan_ints(plan),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"cyclic reduction kernel launch failed: CUDA error {err}")
    cr_thomas_solve.launches[fact] += 1
    return x


cr_thomas_solve.launches = dict.fromkeys(FACTS, 0)


def _lib():
    from ._build import load

    lib = load("cyclic_reduction")
    if lib.mcp_cr_solve.argtypes is None:
        vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.mcp_cr_workspace.argtypes = [ci, ci, ci]
        lib.mcp_cr_workspace.restype = ll
        lib.mcp_cr_solve.argtypes = [ci, ci, ci, vp, vp, vp, vp, vp, vp, ci, ci, ci, ll, ll,
                                     ctypes.POINTER(ci), vp]
        lib.mcp_cr_solve.restype = ci
    return lib
