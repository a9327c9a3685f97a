"""Double-word (compensated-float32) refinement for the tol-1e-6 QP
protocol.

The reference QP protocol certifies at tol 1e-6 in float64. In float32 the
measurable true residual floors at about 6e-6: near the root, G = Mx − ϕ −
Aᵀy is catastrophic cancellation and its float32 evaluation carries about
u·‖M‖·‖x‖ of noise. This module closes that gap with float32 arithmetic:

  * iterates kept as double-words (x_hi + x_lo, ``utils/twofloat.py``);
  * KKT residuals evaluated with compensated matvecs (``mv2``, doubled
    precision, a floor near u²);
  * Newton corrections from the ordinary float32 Schur step
    (``linalg.newton_step_schur_pallas``: K4b/K4c on a batch; iterative
    refinement with a doubled-precision residual converges to the
    doubled-precision floor, Higham ch. 12);
  * certification (``true_kkt_dw``) measured in the same doubled
    arithmetic.

Everything is batch-first over (B, ·): θ (B, p), x (B, n), y and s (B, m).
The card has float64, so this protocol keeps parity with the JAX package's
row rather than filling a gap of the hardware.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import twofloat as tf
from . import qp as qp_mod

Tensor = torch.Tensor


class DWState(NamedTuple):
    x_hi: Tensor
    x_lo: Tensor
    y_hi: Tensor
    y_lo: Tensor
    s_hi: Tensor
    s_lo: Tensor


def _unpack(theta: Tensor, n: int, m: int):
    return qp_mod.unpack_parameters(theta, num_primals=n, num_inequalities=m)


def residuals_dw(theta: Tensor, st: DWState, *, n: int, m: int):
    """(rG, rH, rC) as double-words at doubled precision: rG = Mx − ϕ − Aᵀy,
    rH = Ax − b − s, rC = s∘y (the true KKT residual triple of the QP MCP,
    ``bench/qp.py``)."""
    M, A, b, phi = _unpack(theta, n, m)
    x = (st.x_hi, st.x_lo)
    y = (st.y_hi, st.y_lo)
    s = (st.s_hi, st.s_lo)
    rG = tf.dw_sub(tf.dw_mv(M, x), tf.dw_mv(A.mT, y))
    rG = tf.dw_sub(rG, tf.dw(phi))
    rH = tf.dw_sub(tf.dw_mv(A, x), tf.dw(b))
    rH = tf.dw_sub(rH, s)
    rC = tf.dw_mul(s, y)
    return rG, rH, rC


def true_kkt_dw(theta: Tensor, st: DWState, *, n: int, m: int) -> Tensor:
    """‖F‖∞ per instance, (B,), every component evaluated in doubled
    precision: the certification metric of the tol-1e-6 row (a float32
    evaluation floors at about 6e-6 however good the iterate)."""
    with torch.no_grad():
        rG, rH, rC = residuals_dw(theta, st, n=n, m=m)
        norms = [(r[0] + r[1]).abs().amax(dim=-1) for r in (rG, rH, rC) if r[0].shape[-1]]
        return torch.stack(norms).amax(dim=0)


def dw_state(x: Tensor, y: Tensor, s: Tensor) -> DWState:
    """Float32 iterates as double-words with zero low parts."""
    return DWState(x, torch.zeros_like(x), y, torch.zeros_like(y), s, torch.zeros_like(s))


def polish_dw(
    theta: Tensor,
    x: Tensor,
    y: Tensor,
    s: Tensor,
    *,
    n: int,
    m: int,
    tol: float = 1e-6,
    iters: int = 8,
    reg: float | None = None,
    tau: float = 0.995,
):
    """Refine solved QP instances to true ‖F‖∞ ≤ tol (measured in doubled
    precision): ``iters`` Newton corrections, each a float32 Schur step
    (``newton_step_schur_pallas``), doubled residuals and double-word
    updates with a fraction-to-the-boundary guard on (s, y). θ (B, p), x
    (B, n), y and s (B, m). Complementarity targets ϵ = tol/2, not 0, as the
    solver's terminal polish does: driving s∘y → 0 degenerates the Schur
    diagonal w = reg + s/(y+reg) on active constraints and the float32
    factorization returns garbage steps. Returns (state, true_kkt (B,))."""
    from ..linalg import newton_step_schur_pallas
    from ..solver import fraction_to_the_boundary_linesearch_pair

    if reg is None:
        reg = tol
    eps_p = 0.5 * tol
    M, A, b, phi = _unpack(theta, n, m)
    Gx, Gy, Hx = M, -A.mT, A
    Hy = torch.zeros(A.shape[:-2] + (m, m), dtype=x.dtype, device=x.device)
    # Keep s, y strictly positive before the first residual evaluation: the
    # complementarity target is below tol, so clamp at tol/100.
    floor = tol * 1e-2
    st = dw_state(x, torch.clamp(y, min=floor), torch.clamp(s, min=floor))
    with torch.no_grad():
        for _ in range(iters):
            rG, rH, rC = residuals_dw(theta, st, n=n, m=m)
            # Newton right-hand sides: hi + lo collapsed to float32 (the
            # correction needs the residual only to float32 relative
            # accuracy; the doubled part removed the cancellation noise).
            rGf = rG[0] + rG[1]
            rHf = rH[0] + rH[1]
            rCf = (rC[0] - eps_p) + rC[1]
            dx, dy, ds = newton_step_schur_pallas(
                Gx, Gy, Hx, Hy, st.y_hi, st.s_hi, rGf, rHf, rCf, reg
            )
            # A lane whose step is not finite anywhere takes no step.
            finite = (
                torch.isfinite(dx).all(dim=-1)
                & torch.isfinite(dy).all(dim=-1)
                & torch.isfinite(ds).all(dim=-1)
            )[:, None]
            safe = lambda d: torch.where(finite, d, torch.zeros_like(d))
            alphas = fraction_to_the_boundary_linesearch_pair(
                torch.stack([st.s_hi, st.y_hi]),
                torch.stack([safe(ds), safe(dy)]),
                tau=tau,
                decay=0.5,
                min_stepsize=1e-7,
            )
            alphas = torch.nan_to_num(alphas, nan=0.0)[..., None]
            a_s, a_y = alphas[0], alphas[1]
            upd = lambda hi, lo, a, d: tf.dw_add((hi, lo), tf.dw(a * safe(d)))
            x2 = upd(st.x_hi, st.x_lo, a_s, dx)
            s2 = upd(st.s_hi, st.s_lo, a_s, ds)
            y2 = upd(st.y_hi, st.y_lo, a_y, dy)
            st = DWState(x2[0], x2[1], y2[0], y2[1], s2[0], s2[1])
    return st, true_kkt_dw(theta, st, n=n, m=m)


def polish_batch_dw(
    thetas: Tensor,
    x: Tensor,
    y: Tensor,
    s: Tensor,
    *,
    n: int,
    m: int,
    tol: float = 1e-6,
    iters: int = 8,
):
    """``polish_dw`` over a batch (the JAX package's vmapped entry point);
    returns (states, true_kkt (B,))."""
    return polish_dw(thetas, x, y, s, n=n, m=m, tol=tol, iters=iters)
