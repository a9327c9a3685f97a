"""The shape- and batch-aware block-tridiagonal solve of tier
``"tridiag_auto"``: the JAX package's ``_auto_pick`` and the mode choice of
``pallas_block_thomas`` (``mcp_tpu/kernels/thomas_pallas.py:1359-1393,
1512-1573``), routed to this port's kernels.

The thresholds are the JAX package's, copied so that both packages take the
same route for the same (B, T, b); they were measured on a TPU, and the
card's own numbers for them are in PERF.md (``chip_smoke.py`` times K1 and
K3 at the N=4 flagship shape).

Routes: ``"cr"`` → K3 (``cyclic_reduction.cr_thomas_solve``) with the
picked factorization; ``"lanes"`` and the one-way packed sweep → K1
(``thomas.thomas_solve``). The two-way sweep (``"babe"``, K7a) and the
unpacked one-way sweep for wide blocks (``"padded"``, K7b) are not ported:
they raise ``NotImplementedError`` rather than run another algorithm.
"""

from __future__ import annotations

from typing import Optional

import torch

from .cyclic_reduction import cr_thomas_solve
from .thomas import thomas_solve

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


def auto_thomas_solve(diag: Tensor, lower: Tensor, upper: Tensor, rhs: Tensor) -> Tensor:
    """Tier "tridiag_auto": the block-tridiagonal solve (K1's layout) on the
    route the JAX package takes for this (B, T, b)."""
    B, T, b, _ = diag.shape
    mode, fact = auto_pick(B, T, b)
    mode = kernel_mode(B, T, b, diag.element_size(), mode, fact)
    if mode == "cr":
        return cr_thomas_solve(diag, lower, upper, rhs, fact=fact)
    if mode in ("lanes", "packed") and fact == "qr":
        return thomas_solve(diag, lower, upper, rhs)
    kernel = {"babe": "K7a (the two-way sweep, thomas_pallas.py:737)",
              "padded": "K7b (the unpacked sweep, thomas_pallas.py:463)"}.get(mode, mode)
    raise NotImplementedError(
        f"tridiag_auto routes (B={B}, T={T}, b={b}) to {kernel}, which is not "
        "ported yet (ROADMAP Queue 2)"
    )
