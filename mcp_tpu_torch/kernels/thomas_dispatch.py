"""The shape- and batch-aware block-tridiagonal solves of the tiers
``"tridiag_pallas*"`` and ``"tridiag_auto"``: the mode choice of the JAX
package's ``pallas_block_thomas``, its ``_auto_pick`` and its tier table
(``mcp_tpu/kernels/thomas_pallas.py:1359-1393, 1512-1573, 1608-1646``),
routed to this port's kernels.

The thresholds are the JAX package's, copied so that both packages take the
same route for the same (B, T, b); they were measured on a TPU, and the
card's own numbers for them are in PERF.md (``chip_smoke.py`` times K1, K3
and K7a at the N=4 flagship shape).

Routes (``route_solver``): ``"cr"`` → K3 (``cyclic_reduction.cr_thomas_solve``)
with the requested factorization; ``"babe"`` → K7a
(``thomas_babe.babe_thomas_solve``, the two-way sweep) with it; ``"packed"``
→ K1 (``thomas.thomas_solve``) with it; ``"lanes"`` and ``"padded"`` → K1
with QR whatever the factorization, as in the JAX package (its lane-major
sweep ``_thomas_kernel_lanes`` takes QR only, and its unpacked sweep
``_thomas_kernel``, K7b, drops ``fact``: ``thomas_pallas.py:975, 1446-1449``).
The lane-major, packed and unpacked one-way sweeps all run K1's algebra;
which of them the JAX package takes is a TPU layout rule (a 128-lane tile of
systems, or [D|L|U|r] fitting one lane tile).
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from .cyclic_reduction import FACTS, cr_thomas_solve
from .thomas import thomas_solve
from .thomas_babe import babe_thomas_solve

Tensor = torch.Tensor

#: Above this block size the auto tier takes CR with refined pivoted
#: Gauss–Jordan (the sweep's pivot-free QR loses accuracy on wide blocks).
PALLAS_THOMAS_MAX_BLOCK = 64
#: From this chain length on every sweep variant is replaced by CR (block LU
#: without inter-block pivoting stalls on long lane-change chains).
PALLAS_THOMAS_CR_MIN_T = 64
#: Mid blocks (32 < b ≤ 64) at batch < 128 take CR with pivoted Gauss–Jordan.
PALLAS_THOMAS_MIDBLOCK = 32
#: The lane-major sweep's [C | d] scratch budget (a TPU VMEM size; it only
#: decides the route here, so that both packages take the same one).
LANES_CD_VMEM_BYTES = 40 * 2**20

#: K3 with each factorization, one callable per fact.
CR_SOLVERS = {fact: functools.partial(cr_thomas_solve, fact=fact) for fact in FACTS}


def auto_pick(B: int, T: int, b: int) -> tuple[Optional[str], str]:
    """(mode, fact) of the auto tier: ``_auto_pick`` of the JAX package."""
    if b > PALLAS_THOMAS_MAX_BLOCK:
        return "cr", "gjpr"
    if T >= PALLAS_THOMAS_CR_MIN_T:
        return "cr", "qr"
    if b > PALLAS_THOMAS_MIDBLOCK and B < 128:
        return "cr", "gjp"
    return None, "qr"


def kernel_mode(B: int, T: int, b: int, itemsize: int, mode: Optional[str] = None,
                fact: str = "qr") -> str:
    """The sweep variant ``pallas_block_thomas`` runs for (B, T, b) and a
    requested mode: "cr", "lanes", "babe", "packed" (one-way, [D|L|U|r] fits
    one 128-lane tile) or "padded" (one-way, wider blocks)."""
    packed = 3 * b + 1 <= 128
    if mode is None:
        b8 = -(-b // 8) * 8
        cd_bytes = T * (b8 + 1) * b8 * 128 * itemsize
        if T >= PALLAS_THOMAS_CR_MIN_T:
            mode = "cr"
        elif B >= 128 and cd_bytes <= LANES_CD_VMEM_BYTES and fact == "qr":
            mode = "lanes"
        else:
            mode = "babe" if (packed and T >= 20) else "oneway"
    if mode == "babe" and not (packed and T >= 2):
        mode = "oneway"
    if mode == "oneway":
        mode = "packed" if packed else "padded"
    return mode


def route_solver(B: int, T: int, b: int, itemsize: int, mode: Optional[str] = None,
                 fact: str = "qr") -> Callable[[Tensor, Tensor, Tensor, Tensor], Tensor]:
    """The kernel wrapper that runs ``kernel_mode``'s route for (B, T, b)."""
    mode = kernel_mode(B, T, b, itemsize, mode, fact)
    if mode == "cr":
        return CR_SOLVERS[fact]
    if mode in ("lanes", "padded"):
        fact = "qr"
    sweep = babe_thomas_solve if mode == "babe" else thomas_solve
    return sweep if fact == "qr" else functools.partial(sweep, fact=fact)


#: The JAX package's fixed-route tiers (``_make_thomas_solve``'s table):
#: tier → (mode, fact) of ``pallas_block_thomas``.
PALLAS_TIERS = {
    "tridiag_pallas": (None, "qr"),
    "tridiag_pallas_cr": ("cr", "qr"),
    "tridiag_pallas_gj": (None, "gj"),
    "tridiag_pallas_gjp": (None, "gjp"),
    "tridiag_pallas_gjpr": (None, "gjpr"),
    "tridiag_pallas_crgj": ("cr", "gj"),
    "tridiag_pallas_crgjp": ("cr", "gjp"),
    "tridiag_pallas_crgjpr": ("cr", "gjpr"),
    "tridiag_pallas_crgjb": ("cr", "gjb"),
    "tridiag_pallas_crgjbr": ("cr", "gjbr"),
    "tridiag_pallas_crgjbr2": ("cr", "gjbr2"),
    "tridiag_pallas_crgjbpr": ("cr", "gjbpr"),
    "tridiag_pallas_crgjbpr2": ("cr", "gjbpr2"),
    "tridiag_pallas_crgjbprl": ("cr", "gjbprl"),
    "tridiag_pallas_lanes": ("lanes", "qr"),
}


def pallas_thomas_solve(diag: Tensor, lower: Tensor, upper: Tensor, rhs: Tensor, *,
                        mode: Optional[str] = None, fact: str = "qr") -> Tensor:
    """The block-tridiagonal solve (K1's layout) on the route
    ``pallas_block_thomas`` takes for this (B, T, b) with ``mode`` and
    ``fact`` asked for: tier "tridiag_pallas" with the defaults, the other
    fixed-route tiers with theirs (``PALLAS_TIERS``)."""
    B, T, b, _ = diag.shape
    return route_solver(B, T, b, diag.element_size(), mode, fact)(diag, lower, upper, rhs)


def auto_thomas_solve(diag: Tensor, lower: Tensor, upper: Tensor, rhs: Tensor) -> Tensor:
    """Tier "tridiag_auto": the block-tridiagonal solve (K1's layout) on the
    route the JAX package takes for this (B, T, b)."""
    B, T, b, _ = diag.shape
    mode, fact = auto_pick(B, T, b)
    return route_solver(B, T, b, diag.element_size(), mode, fact)(diag, lower, upper, rhs)
