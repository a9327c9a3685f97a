"""Interior-point MCP solver over a batch, written batch-first.

  outer loop (≤ max_outer_iters): anneal ϵ from 1.0
    inner Newton loop (≤ max_inner_iters): while ‖F‖∞ > ϵ
      δz ← (∇F + tol·I)⁻¹ (-F)
      α_s ← frac-to-boundary on (s, δs); α_y on (y, δy)
      x += α_s δx;  s += α_s δs;  y += α_y δy
      kkt_error ← ‖F‖∞ (at the pre-step point)
    ϵ *= (1 - exp(-tightening·inner))  on success
    ϵ *= (1 + exp(-loosening·inner))   on failure
  status := failed if outer_iters hits max_outer_iters
  optional terminal polish at ϵ = tol/2 against the true residual.

The JAX package runs a per-instance ``lax.while_loop`` nest under ``vmap``;
a vmapped while loop runs while ANY lane's condition holds, applies the body
to every lane and keeps the new carry only where that lane's condition was
true. This port writes exactly that over (B, ·) tensors: the outer loop runs
while ``outer_live.any()``, the inner loop while
``(outer_live & inner_live).any()``, and a lane outside the mask is frozen
with ``torch.where`` (never by multiplying by 0: 0·NaN = NaN). Each loop
test is one host sync (a ``.any()`` read), a known cost of this version.

This slice ports the banded tier ``linear_solver="tridiag_pallas"`` of the
annealed algorithm ``"ip"``: each inner step is the vmapped residual, the
affine-bands rebuild, ``banded_newton_step_compressed`` with the K1 sweep
(kernels/thomas.py) and the fused K2 linesearch (kernels/linesearch.py);
each polish step is K1 with the unfused linesearch. Options that select a
path not ported yet raise ``NotImplementedError`` naming the ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch.profiler import record_function

from .kernels.block_tridiag import banded_newton_step_compressed, gh_banded_fast
from .kernels.linesearch import _candidate_tensor, linesearch_update
from .kernels.thomas import thomas_solve
from .mcp import PrimalDualMCP
from .types import FAILED, SOLVED, SolveResult

# A float32 matmul on the card may run in TF32 (about three decimal digits);
# Newton steps and residual metrics need full float32, the analogue of the
# JAX package's matmul_precision="highest". Set once, here, for every
# solver-path matmul and convolution.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# Profiler span names (torch.profiler.record_function; near-free when no
# profiler runs): chip_smoke.py's profile phase splits the host time of an
# iteration by them.
SPAN_RESIDUAL = "mcp.residual_bands"
SPAN_NEWTON = "mcp.newton_solve"
SPAN_LINESEARCH = "mcp.linesearch"
SPAN_LOOP_TEST = "mcp.loop_test"


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """Solver options: every field and default of the JAX package's
    ``SolverOptions``, so options carry over unchanged. Fields that select
    a path this port does not have yet are rejected by ``ip_solve``."""

    tol: float = 1e-4
    max_inner_iters: int = 20
    max_outer_iters: int = 50
    tightening_rate: float = 0.1
    loosening_rate: float = 0.5
    min_stepsize: float = 1e-4
    tau: float = 0.995  # fraction-to-the-boundary parameter
    decay: float = 0.5  # linesearch halving factor
    linear_solver: str = "condensed"
    sensitivity_solver: str = "lu"
    matmul_precision: str = "highest"
    verbose: bool = False
    algorithm: str = "ip"
    centering_floor: float = 0.01
    refinement_steps: int = 1
    gmres_tol: float = 1e-8
    gmres_restart: int = 50
    gmres_maxiter: int = 5
    gmres_preconditioner: str = "none"
    # None = the fused K2 linesearch for the "tridiag_pallas" tier.
    fused_linesearch: Optional[bool] = None
    # Newton-system regularization; None = tol·I.
    regularization: Optional[float] = None
    hybrid_switch_tol: float = 1e-2
    # Terminal polish: up to max_inner_iters extra Newton steps at ϵ = tol/2
    # until the TRUE residual ‖(g, h−s, s∘y)‖∞ ≤ polish_margin·tol.
    polish: bool = False
    retry: int = 0
    retry_tightening_rate: float = 0.1
    retry_linear_solver: Optional[str] = None
    retry_max_outer_iters: Optional[int] = None
    polish_margin: float = 0.85


def auto_tightening_rate(mcp) -> float:
    """Shape-keyed ϵ-annealing rate: 0.02 for small-block trajectory games
    (b < 64), 0.05 for large blocks, the reference default 0.1 for problems
    without time structure."""
    st = getattr(mcp, "time_structure", None)
    if st is None:
        return 0.1
    return 0.05 if st.block_size >= 64 else 0.02


def linesearch_candidates(decay: float, min_stepsize: float) -> tuple[float, ...]:
    """The backtracking grid as a static tuple: decay^k for k = 0..K where
    decay^K is the first value below min_stepsize (that last candidate is
    still tested)."""
    K = max(0, math.ceil(math.log(min_stepsize) / math.log(decay)))
    while decay**K >= min_stepsize:  # guard rounding at the boundary
        K += 1
    return tuple(decay**k for k in range(K + 1))


def fraction_to_the_boundary_linesearch(
    v: torch.Tensor, dv: torch.Tensor, *, tau: float, decay: float, min_stepsize: float
) -> torch.Tensor:
    """Per lane, α = the first power of ``decay`` in {1, decay, decay², …}
    with v + α·δ ≥ (1-τ)·v everywhere, or NaN if none down to min_stepsize
    does. v, dv (B, m) → α (B,)."""
    c = _candidate_tensor(linesearch_candidates(decay, min_stepsize), v.dtype, v.device)
    feasible = (c[None, :, None] * dv[:, None, :] >= (-tau * v)[:, None, :]).all(dim=2)
    first = torch.argmax(feasible.to(torch.int8), dim=1)  # first True (0 if none)
    return torch.where(
        feasible.any(dim=1), c[first], torch.full_like(c[first], math.nan)
    )


def fraction_to_the_boundary_linesearch_pair(
    v: torch.Tensor, dv: torch.Tensor, *, tau: float, decay: float, min_stepsize: float
) -> torch.Tensor:
    """The linesearch over a leading pair axis: v, dv (2, B, m) → (2, B)."""
    return fraction_to_the_boundary_linesearch(
        v.reshape(-1, v.shape[-1]), dv.reshape(-1, dv.shape[-1]),
        tau=tau, decay=decay, min_stepsize=min_stepsize,
    ).reshape(v.shape[:-1])


def _check_supported(mcp: PrimalDualMCP, options: SolverOptions):
    if options.algorithm != "ip":
        raise NotImplementedError(
            f"algorithm={options.algorithm!r} is not ported yet "
            "(ROADMAP Queue 1 item 8: Mehrotra and hybrid)"
        )
    if options.linear_solver != "tridiag_pallas":
        raise NotImplementedError(
            f"linear_solver={options.linear_solver!r} is not ported yet "
            "(ROADMAP Queue 1 item 8: dense tiers; Queue 2 K3/K7: other "
            "banded factorizations); this port has 'tridiag_pallas'"
        )
    if options.retry:
        raise NotImplementedError(
            "retry > 0 is not ported yet (ROADMAP Queue 1 item 5: _retry_failed)"
        )
    if options.verbose:
        raise NotImplementedError(
            "verbose=True is not ported yet (ROADMAP Queue 1 item 5)"
        )
    if options.matmul_precision != "highest":
        raise NotImplementedError(
            "only matmul_precision='highest' (TF32 off) is ported "
            "(ROADMAP Queue 1 item 5)"
        )
    st = mcp.time_structure
    if st is None or st.row_permutation is None:
        raise NotImplementedError(
            "the banded tier needs an MCP with a time structure and a row "
            "time structure (trajectory games); dense tiers are ROADMAP "
            "Queue 1 item 8"
        )


def ip_solve(
    mcp: PrimalDualMCP,
    options: SolverOptions,
    theta: torch.Tensor,
    x0: torch.Tensor,
    y0: torch.Tensor,
    s0: torch.Tensor,
) -> SolveResult:
    """One batched interior-point solve: θ (B, p), x0 (B, n), y0/s0 (B, m).
    The iterate dtype and device are x0's; θ must match them."""
    _check_supported(mcp, options)
    for name, a in (("theta", theta), ("y0", y0), ("s0", s0)):
        if a.dtype != x0.dtype or a.device != x0.device:
            raise ValueError(
                f"{name} must have the iterates' dtype and device "
                f"({x0.dtype}, {x0.device}), got ({a.dtype}, {a.device})"
            )
    ab = mcp.affine_bands
    if ab is not None and ab.diag0.device != x0.device:
        raise ValueError(
            f"the game was built on {ab.diag0.device} but the iterates are "
            f"on {x0.device}"
        )
    return _ip_solve_body(mcp, options, theta, x0, y0, s0)


def _newton_step(mcp, ab, theta, x, y, s, eps, reg):
    """Residual, banded linearization and Newton direction of every lane.
    Returns (rG, rH, rC, dx, dy, ds)."""
    st = mcp.time_structure
    with record_function(SPAN_RESIDUAL):
        g, h, diag_b, lower_b, upper_b, Gy_b, Hx_b = gh_banded_fast(
            mcp, st, x, y, theta, affine_bands=ab
        )
    rG, rH, rC = g, h - s, s * y - eps[:, None]
    with record_function(SPAN_NEWTON):
        dx, dy, ds = banded_newton_step_compressed(
            diag_b, lower_b, upper_b, Gy_b, Hx_b, y, s, rG, rH, rC, reg, st,
            algorithm=thomas_solve,
        )
    return rG, rH, rC, dx, dy, ds


def _any(live: torch.Tensor) -> bool:
    """A loop test: one host sync."""
    with record_function(SPAN_LOOP_TEST):
        return bool(live.any())


@record_function(SPAN_LINESEARCH)
def _unfused_step(options, x, dx, s, ds, y, dy):
    """The unfused linesearch and update: (x', s', y', step_failed)."""
    lin_failed = ~(
        torch.isfinite(dx).all(dim=1)
        & torch.isfinite(dy).all(dim=1)
        & torch.isfinite(ds).all(dim=1)
    )
    keep = ~lin_failed[:, None]
    safe = lambda d: torch.where(keep, d, torch.zeros_like(d))
    alphas = fraction_to_the_boundary_linesearch_pair(
        torch.stack([s, y]),
        torch.stack([safe(ds), safe(dy)]),
        tau=options.tau,
        decay=options.decay,
        min_stepsize=options.min_stepsize,
    )
    step_failed = lin_failed | torch.isnan(alphas[0]) | torch.isnan(alphas[1])
    zero = torch.zeros_like(alphas[0])
    a_s = torch.where(step_failed, zero, alphas[0])[:, None]
    a_y = torch.where(step_failed, zero, alphas[1])[:, None]
    # The reference breaks before applying the update: a failed step leaves
    # the iterate untouched (safe(): 0·NaN would poison it).
    return x + a_s * safe(dx), s + a_s * safe(ds), y + a_y * safe(dy), step_failed


def _kkt(rG, rH, rC):
    return torch.maximum(
        rG.abs().amax(dim=1), torch.maximum(rH.abs().amax(dim=1), rC.abs().amax(dim=1))
    )


def _ip_solve_body(mcp, options, theta, x0, y0, s0) -> SolveResult:
    B = theta.shape[0]
    dtype, device = x0.dtype, x0.device
    tol = options.tol
    reg = options.regularization if options.regularization is not None else tol
    ab = None if mcp.affine_bands is None else mcp.affine_bands.to(dtype=dtype)
    use_fused_ls = (
        options.fused_linesearch if options.fused_linesearch is not None else True
    )
    candidates = linesearch_candidates(options.decay, options.min_stepsize)

    def inner_body(x, y, s, eps):
        """(x', y', s', F_norm, step_failed) of every lane."""
        rG, rH, rC, dx, dy, ds = _newton_step(mcp, ab, theta, x, y, s, eps, reg)
        if use_fused_ls:
            with record_function(SPAN_LINESEARCH):
                x, s, y, F_norm, failed = linesearch_update(
                    x, dx, s, ds, y, dy, rG, rH, rC,
                    tau=options.tau, candidates=candidates,
                )
            return x, y, s, F_norm, failed
        x, s, y, failed = _unfused_step(options, x, dx, s, ds, y, dy)
        return x, y, s, _kkt(rG, rH, rC), failed

    where = torch.where
    x, y, s = x0, y0, s0
    kkt = torch.full((B,), math.inf, dtype=dtype, device=device)
    eps = torch.ones((B,), dtype=dtype, device=device)
    outer = torch.ones((B,), dtype=torch.int32, device=device)
    failed = torch.zeros((B,), dtype=torch.bool, device=device)

    def outer_cond(kkt, eps, outer):
        return (kkt > tol) & (eps > tol) & (outer < options.max_outer_iters)

    outer_live = outer_cond(kkt, eps, outer)
    while _any(outer_live):
        # Inner loop from the outer carry; status resets each outer step.
        xi, yi, si, ki = x, y, s, kkt
        inner = torch.ones((B,), dtype=torch.int32, device=device)
        ifailed = torch.zeros((B,), dtype=torch.bool, device=device)
        live = outer_live & (ki > eps) & (inner < options.max_inner_iters) & ~ifailed
        while _any(live):
            xn, yn, sn, F_norm, step_failed = inner_body(xi, yi, si, eps)
            lv = live[:, None]
            xi, yi, si = where(lv, xn, xi), where(lv, yn, yi), where(lv, sn, si)
            ki = where(live & ~step_failed, F_norm, ki)
            inner = where(live & ~step_failed, inner + 1, inner)
            ifailed = where(live, step_failed, ifailed)
            live = outer_live & (ki > eps) & (inner < options.max_inner_iters) & ~ifailed
        inner_f = inner.to(dtype)
        eps_new = eps * where(
            ifailed,
            1.0 + torch.exp(-options.loosening_rate * inner_f),
            1.0 - torch.exp(-options.tightening_rate * inner_f),
        )
        ol = outer_live[:, None]
        x, y, s = where(ol, xi, x), where(ol, yi, y), where(ol, si, s)
        kkt = where(outer_live, ki, kkt)
        eps = where(outer_live, eps_new, eps)
        failed = where(outer_live, ifailed, failed)
        outer = where(outer_live, outer + 1, outer)
        outer_live = outer_cond(kkt, eps, outer)
    failed = failed | (outer == options.max_outer_iters)

    if options.polish:
        x, y, s, kkt, failed = _terminal_polish(
            mcp, options, ab, theta, x, y, s, failed, reg
        )
    status = where(
        failed,
        torch.full_like(outer, FAILED),
        torch.full_like(outer, SOLVED),
    )
    return SolveResult(
        x=x, y=y, s=s, kkt_error=kkt, epsilon=eps, outer_iters=outer, status=status
    )


def _terminal_polish(mcp, options, ab, theta, x, y, s, failed, reg):
    """Terminal polish at fixed ϵ = tol/2 against the TRUE residual
    ‖(g, h−s, s∘y)‖∞: exits below polish_margin·tol so an independently
    rounded recompute does not flip boundary lanes. Returns
    (x, y, s, true_kkt, failed | true_kkt > tol)."""
    tol = options.tol
    exit_tol = options.polish_margin * tol
    B = x.shape[0]
    eps_p = torch.full((B,), 0.5 * tol, dtype=x.dtype, device=x.device)

    def true_kkt_at(x, y, s):
        with record_function(SPAN_RESIDUAL):
            g, h = mcp.gh_batched(x, y, theta)
        return _kkt(g, h - s, s * y)

    where = torch.where
    tk = true_kkt_at(x, y, s)
    iters = 0
    p_failed = torch.zeros_like(failed)
    live = (tk > exit_tol) & ~p_failed
    while iters < options.max_inner_iters and _any(live):
        _, _, _, dx, dy, ds = _newton_step(mcp, ab, theta, x, y, s, eps_p, reg)
        xn, sn, yn, step_failed = _unfused_step(options, x, dx, s, ds, y, dy)
        tkn = true_kkt_at(xn, yn, sn)
        lv = live[:, None]
        x, y, s = where(lv, xn, x), where(lv, yn, y), where(lv, sn, s)
        tk = where(live, tkn, tk)
        p_failed = where(live, step_failed, p_failed)
        iters += 1
        live = (tk > exit_tol) & ~p_failed
    return x, y, s, tk, failed | (tk > tol)
