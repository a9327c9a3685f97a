"""Interior-point MCP solvers over a batch, written batch-first.

``algorithm="ip"``, the reference's annealed loop:

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

``algorithm="mehrotra"``: a predictor-corrector loop, one Jacobian and one
factorization per iteration shared by the affine predictor and the centered
corrector (see ``_mehrotra_solve_body``). ``algorithm="hybrid"``: the
annealed loop down to ϵ ≤ hybrid_switch_tol, then Mehrotra from there.
``retry > 0`` re-solves failed lanes from the cold start under the annealed
schedule (``_retry_failed``).

The JAX package runs a per-instance ``lax.while_loop`` nest under ``vmap``;
a vmapped while loop runs while ANY lane's condition holds, applies the body
to every lane and keeps the new carry only where that lane's condition was
true. This port writes exactly that over (B, ·) tensors: each loop runs
while its live mask has a lane, and a lane outside the mask is frozen with
``torch.where`` (never by multiplying by 0: 0·NaN = NaN). Each loop test is
one host sync (a ``.any()`` read).

Linear-solver tiers: the banded tiers of trajectory games (``BANDED_SOLVERS``:
``"tridiag"`` and ``"tridiag_cr"``, the plain LU block-Thomas and cyclic
reduction; ``"tridiag_pallas"``, the JAX package's shape- and batch-aware
route to K1, the two-way sweep K7a or K3 with QR; every other
``"tridiag_pallas_*"`` tier of the JAX package on its fixed mode and
in-block factorization (``thomas_dispatch.PALLAS_TIERS``: ``_gj``, ``_gjp``,
``_gjpr`` → K1 or K7a with that factorization where the JAX package's route
keeps it, ``_cr`` and ``_crgj*`` → K3 with it, ``_lanes`` → K1 with QR);
``"tridiag_auto"``, the JAX package's shape- and batch-aware route to K1,
K7a or K3; the fused K2 linesearch on ``"tridiag_pallas"`` and
``"tridiag_auto"``) and the dense tiers of ``linalg.py``
(``"dense"``, ``"condensed"``, ``"schur"``, ``"schur_pallas"`` → K4b/K4c,
``"schur_pallas_gj"`` → K4a, ``"schur_pallas_gjr"`` → K5). The dense tiers
linearize by ``_make_linearizer``: an affine MCP (the QP benchmark) has its
Jacobian extracted once per solve. A banded tier on a game without a row
time structure linearizes the same way and solves the dense Schur system
permuted to time-major bands (``linalg.newton_step_tridiag``), as the JAX
package does.

``tridiag_solver``, a callable (diag, lower, upper, rhs) → x, overrides the
block-tridiagonal solve of the banded tiers (the horizon-sharded SPIKE solve
of ``parallel/horizon.py``); the tier still decides everything else, e.g.
the fused K2 linesearch on ``"tridiag_pallas"``. ``newton_solver``, a
callable of the ``NEWTON_STEPS`` signature, replaces the Newton step of the
other tiers under ``algorithm="ip"`` (the tensor-parallel factorization of
``parallel/tensor.py``); the polish reuses it.

``ip_solve`` runs the whole solve at ``options.matmul_precision``
(``_device.matmul_precision``). With ``verbose`` it prints one line per lane
whose inner step failed, the JAX package's debug messages; each print costs
one host sync, and without ``verbose`` the loops sync as before.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import warnings
from typing import Optional

import torch
from torch.func import vmap
from torch.profiler import record_function

from ._device import matmul_precision
from .kernels.block_tridiag import (
    banded_jac_mv,
    banded_newton_step_compressed,
    block_cyclic_reduction_solve,
    block_thomas_solve,
    gh_banded_fast,
)
from .kernels.linesearch import _candidate_tensor, linesearch_update
from .kernels.thomas_dispatch import PALLAS_TIERS, auto_thomas_solve, pallas_thomas_solve
from .linalg import NEWTON_STEPS, factored_newton_solver, newton_step_tridiag
from .mcp import PrimalDualMCP
from .types import FAILED, SOLVED, SolveResult

# A float32 matmul on the card may run in TF32 (about three decimal digits);
# Newton steps and residual metrics need full float32, the analogue of the
# JAX package's matmul_precision="highest". Set once, here, for every
# matmul and convolution outside a solve; ip_solve sets its own precision.
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
    ``SolverOptions``, so options carry over unchanged.

    matmul_precision: the float32 matrix products of the solve, as
    ``jax.default_matmul_precision`` takes it: "highest"/"float32" (full
    float32), "high"/"tensorfloat32" (TF32 on the card) or
    "default"/"bfloat16" (bf16 passes; on a CPU with bf16 units oneDNN
    takes it too). The hand-written kernels ignore it: they compute in full
    float32, as the Pallas kernels pin ``Precision.HIGHEST`` (DESIGN.md §7).
    The true-KKT metrics, ``bench.harness.true_kkt_errors`` and the
    polish's exit test, stay at full float32 inside a reduced-precision
    solve, as the JAX package pins "highest" for its metrics
    (``bench/harness.py``, ``mcp.verify_affine``).
    """

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
    # Mehrotra: the complementarity target is floored at
    # centering_floor·‖(rG, rH)‖∞; refinement_steps back-solves against the
    # unregularized Jacobian follow each solve.
    centering_floor: float = 0.01
    refinement_steps: int = 1
    gmres_tol: float = 1e-8
    gmres_restart: int = 50
    gmres_maxiter: int = 5
    gmres_preconditioner: str = "none"
    # None = the fused K2 linesearch exactly for "tridiag_pallas" and
    # "tridiag_auto".
    fused_linesearch: Optional[bool] = None
    # Newton-system regularization; None = tol·I.
    regularization: Optional[float] = None
    # Hybrid: annealed warm-up until ϵ ≤ hybrid_switch_tol, then Mehrotra.
    hybrid_switch_tol: float = 1e-2
    # Terminal polish: up to max_inner_iters extra Newton steps at ϵ = tol/2
    # until the TRUE residual ‖(g, h−s, s∘y)‖∞ ≤ polish_margin·tol.
    polish: bool = False
    # Retry rounds: failed lanes re-solve from x = 0, y = s = 1 under the
    # annealed schedule at retry_tightening_rate, on retry_linear_solver
    # (None = the primary tier) within retry_max_outer_iters (None =
    # max_outer_iters).
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
    """The linesearch over a leading pair axis: v, dv (2, B, m) → (2, B)
    (m = 0 included: every candidate is feasible, α = 1)."""
    flat = (v.shape[0] * v.shape[1], v.shape[-1])
    return fraction_to_the_boundary_linesearch(
        v.reshape(flat), dv.reshape(flat),
        tau=tau, decay=decay, min_stepsize=min_stepsize,
    ).reshape(v.shape[:-1])


#: Banded tier → the block-tridiagonal solve (diag, lower, upper, rhs) → x
#: that its Newton step runs (the JAX package's ``_tridiag_algorithm``).
BANDED_SOLVERS = {
    "tridiag": block_thomas_solve,
    "tridiag_cr": block_cyclic_reduction_solve,
    **{tier: functools.partial(pallas_thomas_solve, mode=mode, fact=fact)
       for tier, (mode, fact) in PALLAS_TIERS.items()},
    "tridiag_auto": auto_thomas_solve,
}


def _tridiag_algorithm(options: SolverOptions, tridiag_solver=None):
    """The block-tridiagonal solve of a banded tier: the override callable
    ``tridiag_solver`` (e.g. the horizon-sharded SPIKE solve) wins over the
    tier's own."""
    return tridiag_solver if tridiag_solver is not None else BANDED_SOLVERS[
        options.linear_solver]


def _check_tier(mcp: PrimalDualMCP, tier: str):
    if tier in BANDED_SOLVERS:
        if mcp.time_structure is None:
            raise ValueError(
                "linear_solver='tridiag' requires an MCP with time_structure "
                "(built by build_parametric_game for trajectory games)."
            )
    elif tier not in NEWTON_STEPS:
        raise ValueError(f"unknown linear_solver {tier!r}")


def _check_supported(mcp: PrimalDualMCP, options: SolverOptions):
    if options.algorithm not in ("ip", "mehrotra", "hybrid"):
        raise ValueError(f"unknown algorithm {options.algorithm!r}")
    _check_tier(mcp, options.linear_solver)
    if options.retry:
        _check_tier(mcp, options.retry_linear_solver or options.linear_solver)


def _gmres_options(options: SolverOptions) -> dict:
    """The keywords of ``linalg.newton_step_gmres`` from the gmres_* fields."""
    return dict(tol=options.gmres_tol, restart=options.gmres_restart,
                maxiter=options.gmres_maxiter, preconditioner=options.gmres_preconditioner)


def _report_failed(live, template: str, value, *why):
    """verbose: print ``template`` once for every lane of ``live`` whose
    step failed, with its flags ``why`` (each (B,) bool) and ``value`` (B,),
    formatted as the JAX package's ``jax.debug.print`` formats them."""
    live = live.cpu()
    if not bool(live.any()):
        return
    value = value.detach().cpu().numpy()
    why = [w.cpu().numpy() for w in why]
    for i in live.nonzero().flatten().tolist():
        print(template.format(*(w[i] for w in why), value[i]))


def default_initialization(
    mcp: PrimalDualMCP,
    theta: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    y0: Optional[torch.Tensor] = None,
    s0: Optional[torch.Tensor] = None,
    dtype=None,
):
    """The reference cold start x₀ = 0, y₀ = s₀ = 1 where not given, shaped
    after θ's leading axes (θ (p,) → (n,), θ (B, p) → (B, n)), in ``dtype``
    (default θ's) on θ's device."""
    theta = torch.as_tensor(theta)
    lead = tuple(theta.shape[:-1])
    kw = dict(dtype=dtype or theta.dtype, device=theta.device)
    n, m = mcp.unconstrained_dimension, mcp.constrained_dimension
    x0 = torch.zeros(lead + (n,), **kw) if x0 is None else torch.as_tensor(x0, **kw)
    y0 = torch.ones(lead + (m,), **kw) if y0 is None else torch.as_tensor(y0, **kw)
    s0 = torch.ones(lead + (m,), **kw) if s0 is None else torch.as_tensor(s0, **kw)
    return x0, y0, s0


def ip_solve(
    mcp: PrimalDualMCP,
    options: SolverOptions,
    theta: torch.Tensor,
    x0: torch.Tensor,
    y0: torch.Tensor,
    s0: torch.Tensor,
    tridiag_solver=None,
    newton_solver=None,
) -> SolveResult:
    """One batched interior-point solve: θ (B, p), x0 (B, n), y0/s0 (B, m).
    The iterate dtype and device are x0's; θ must match them.
    ``tridiag_solver`` overrides the banded tiers' block-tridiagonal solve,
    ``newton_solver`` the other tiers' Newton step (``algorithm="ip"``
    only; see the module docstring)."""
    _check_supported(mcp, options)
    if newton_solver is not None and options.algorithm != "ip":
        raise NotImplementedError("newton_solver override currently supports algorithm='ip'")
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
    if options.linear_solver.startswith("schur_pallas_gj") and not mcp.affine:
        # No-pivot Gauss–Jordan is backward-stable only on (near-)SPD Schur
        # systems, the affine convex-QP path.
        warnings.warn(
            f"linear_solver={options.linear_solver!r} (no-pivot Gauss-"
            "Jordan) selected for a non-affine MCP: only valid when the "
            "schur matrix is SPD (convex QPs). Game systems should use "
            "the QR tiers ('schur_pallas'); enable polish=True to at "
            "least certify the terminal residual.",
            stacklevel=2,
        )
    with matmul_precision(options.matmul_precision):
        return _ip_solve(mcp, options, theta, x0, y0, s0, tridiag_solver, newton_solver)


def _ip_solve(mcp, options, theta, x0, y0, s0, tridiag_solver, newton_solver) -> SolveResult:
    if options.algorithm == "mehrotra":
        res = _mehrotra_solve_body(mcp, options, theta, x0, y0, s0, tridiag_solver)
    elif options.algorithm == "hybrid":
        # Phase 1: annealed warm-up to ϵ ≤ hybrid_switch_tol with the final
        # tolerance's regularization and no polish; phase 2: Mehrotra from
        # that interior point, slacks and duals carried.
        warm_options = dataclasses.replace(
            options,
            algorithm="ip",
            tol=options.hybrid_switch_tol,
            regularization=(
                options.regularization
                if options.regularization is not None
                else options.tol
            ),
            polish=False,
        )
        r1 = _ip_solve_body(mcp, warm_options, theta, x0, y0, s0, tridiag_solver)
        r2 = _mehrotra_solve_body(mcp, options, theta, r1.x, r1.y, r1.s, tridiag_solver)
        res = r2._replace(outer_iters=r1.outer_iters + r2.outer_iters)
    else:
        res = _ip_solve_body(mcp, options, theta, x0, y0, s0, tridiag_solver,
                             newton_solver=newton_solver)
    for _ in range(int(options.retry)):
        res = _retry_failed(mcp, options, theta, res, tridiag_solver, newton_solver)
    return res


def _retry_failed(mcp, options, theta, res: SolveResult, tridiag_solver=None,
                  newton_solver=None) -> SolveResult:
    """One gated retry round: lanes that did not solve re-solve from the
    cold start x = 0, y = s = 1 under the annealed schedule; the other
    lanes' loops are gated off, so when every lane solved the round costs
    one residual evaluation. Lanes that entered the retry pay its
    iterations whether or not it rescued them."""
    need = res.status != SOLVED
    retry_options = dataclasses.replace(
        options,
        algorithm="ip",
        tightening_rate=options.retry_tightening_rate,
        linear_solver=options.retry_linear_solver or options.linear_solver,
        retry=0,
        max_outer_iters=(
            options.retry_max_outer_iters
            if options.retry_max_outer_iters is not None
            else options.max_outer_iters
        ),
    )
    r2 = _ip_solve_body(
        mcp, retry_options, theta,
        torch.zeros_like(res.x), torch.ones_like(res.y), torch.ones_like(res.s),
        tridiag_solver, newton_solver=newton_solver, gate=need,
    )
    take = need & (r2.status == SOLVED)

    def pick(a, b):
        return torch.where(take.reshape(-1, *([1] * (a.dim() - 1))), a, b)

    return SolveResult(
        x=pick(r2.x, res.x),
        y=pick(r2.y, res.y),
        s=pick(r2.s, res.s),
        kkt_error=pick(r2.kkt_error, res.kkt_error),
        epsilon=pick(r2.epsilon, res.epsilon),
        outer_iters=res.outer_iters + torch.where(need, r2.outer_iters, 0),
        status=torch.where(take, SOLVED, res.status),
    )


def _make_linearizer(mcp: PrimalDualMCP, theta: torch.Tensor, dtype):
    """Per-solve batched linearizer ``lin(x, y) -> (g, h, Gx, Gy, Hx, Hy)``.

    For an affine MCP (constant (x, y)-Jacobians, e.g. the QP benchmark's
    KKT system) the Jacobians and offsets are extracted ONCE here, outside
    the Newton loop; each step's residual then costs two batched matvecs.
    Otherwise every call linearizes every lane by forward mode."""
    if mcp.affine:
        g0, h0, Gx, Gy, Hx, Hy = (
            t.to(dtype) for t in mcp.gh_affine_data(theta, dtype=dtype)
        )

        def lin(x, y):
            g = g0 + (Gx @ x[..., None])[..., 0] + (Gy @ y[..., None])[..., 0]
            h = h0 + (Hx @ x[..., None])[..., 0] + (Hy @ y[..., None])[..., 0]
            return g, h, Gx, Gy, Hx, Hy

        return lin
    return lambda x, y: vmap(mcp.gh_linearized)(x, y, theta)


def _make_step(mcp, options, theta, dtype, reg, lin=None, tridiag_solver=None,
               newton_solver=None):
    """``step(x, y, s, eps) -> (rG, rH, rC, dx, dy, ds)``: the residual of
    every lane at (x, y, s) and its regularized Newton direction, on the
    tier of ``options.linear_solver`` (a banded tier's block-tridiagonal
    solve overridden by ``tridiag_solver``, another tier's Newton step by
    ``newton_solver``). A dense tier, and a banded tier without a row time
    structure, linearize by ``lin`` (default: a new ``_make_linearizer``)."""
    banded = options.linear_solver in BANDED_SOLVERS
    st = mcp.time_structure
    if banded and st.row_permutation is not None:
        ab = None if mcp.affine_bands is None else mcp.affine_bands.to(dtype=dtype)
        tsolve = _tridiag_algorithm(options, tridiag_solver)

        def step(x, y, s, eps):
            with record_function(SPAN_RESIDUAL):
                g, h, diag_b, lower_b, upper_b, Gy_b, Hx_b = gh_banded_fast(
                    mcp, st, x, y, theta, affine_bands=ab
                )
            rG, rH, rC = g, h - s, s * y - eps[:, None]
            with record_function(SPAN_NEWTON):
                dx, dy, ds = banded_newton_step_compressed(
                    diag_b, lower_b, upper_b, Gy_b, Hx_b, y, s, rG, rH, rC, reg, st,
                    algorithm=tsolve,
                )
            return rG, rH, rC, dx, dy, ds

        return step
    lin = lin or _make_linearizer(mcp, theta, dtype)
    if banded:
        newton = functools.partial(newton_step_tridiag, structure=st,
                                   algorithm=_tridiag_algorithm(options, tridiag_solver))
    elif newton_solver is not None:
        newton = newton_solver
    elif options.linear_solver == "gmres":
        newton = functools.partial(NEWTON_STEPS["gmres"], **_gmres_options(options))
    else:
        newton = NEWTON_STEPS[options.linear_solver]

    def step(x, y, s, eps):
        with record_function(SPAN_RESIDUAL):
            g, h, Gx, Gy, Hx, Hy = lin(x, y)
        rG, rH, rC = g, h - s, s * y - eps[:, None]
        with record_function(SPAN_NEWTON):
            dx, dy, ds = newton(Gx, Gy, Hx, Hy, y, s, rG, rH, rC, reg)
        return rG, rH, rC, dx, dy, ds

    return step


def _any(live: torch.Tensor) -> bool:
    """A loop test: one host sync."""
    with record_function(SPAN_LOOP_TEST):
        return bool(live.any())


@record_function(SPAN_LINESEARCH)
def _unfused_step(options, x, dx, s, ds, y, dy):
    """The unfused linesearch and update: (x', s', y', step_failed, (lin_failed,
    ls_failed)), a lane's step failing on a non-finite direction or on the
    linesearch."""
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
    ls_failed = torch.isnan(alphas[0]) | torch.isnan(alphas[1])
    step_failed = lin_failed | ls_failed
    zero = torch.zeros_like(alphas[0])
    a_s = torch.where(step_failed, zero, alphas[0])[:, None]
    a_y = torch.where(step_failed, zero, alphas[1])[:, None]
    # The reference breaks before applying the update: a failed step leaves
    # the iterate untouched (safe(): 0·NaN would poison it).
    return (x + a_s * safe(dx), s + a_s * safe(ds), y + a_y * safe(dy), step_failed,
            (lin_failed, ls_failed))


def _absmax(r: torch.Tensor) -> torch.Tensor:
    """Per-lane ‖r‖∞ of (B, k), 0 for k = 0."""
    if r.shape[1] == 0:
        return r.new_zeros(r.shape[0])
    return r.abs().amax(dim=1)


def _kkt(rG, rH, rC):
    return torch.maximum(_absmax(rG), torch.maximum(_absmax(rH), _absmax(rC)))


def _ip_solve_body(mcp, options, theta, x0, y0, s0, tridiag_solver=None,
                   newton_solver=None, gate=None) -> SolveResult:
    """The annealed loop. ``gate`` (B,) bool, when given, runs only the lanes
    it marks; the others come back FAILED with their iterate untouched. The
    terminal polish reuses its Newton step (and so ``tridiag_solver`` and
    ``newton_solver``)."""
    B = theta.shape[0]
    dtype, device = x0.dtype, x0.device
    tol = options.tol
    reg = options.regularization if options.regularization is not None else tol
    step = _make_step(mcp, options, theta, dtype, reg, tridiag_solver=tridiag_solver,
                      newton_solver=newton_solver)
    if options.fused_linesearch and options.verbose:
        warnings.warn(
            "fused_linesearch=True is incompatible with verbose=True (the "
            "debug print needs the split linear/linesearch failure flags); "
            "falling back to the unfused path.",
            stacklevel=3,
        )
    use_fused_ls = (
        options.fused_linesearch
        if options.fused_linesearch is not None
        else options.linear_solver in ("tridiag_pallas", "tridiag_auto")
    ) and not options.verbose
    candidates = linesearch_candidates(options.decay, options.min_stepsize)

    def inner_body(x, y, s, eps):
        """(x', y', s', F_norm, step_failed, why) of every lane; why is the
        unfused step's (lin_failed, ls_failed), None after the fused kernel."""
        rG, rH, rC, dx, dy, ds = step(x, y, s, eps)
        if use_fused_ls:
            with record_function(SPAN_LINESEARCH):
                x, s, y, F_norm, failed = linesearch_update(
                    x, dx, s, ds, y, dy, rG, rH, rC,
                    tau=options.tau, candidates=candidates,
                )
            return x, y, s, F_norm, failed, None
        x, s, y, failed, why = _unfused_step(options, x, dx, s, ds, y, dy)
        return x, y, s, _kkt(rG, rH, rC), failed, why

    where = torch.where
    x, y, s = x0, y0, s0
    kkt = torch.full((B,), math.inf, dtype=dtype, device=device)
    eps = torch.ones((B,), dtype=dtype, device=device)
    outer = torch.ones((B,), dtype=torch.int32, device=device)
    failed = torch.zeros((B,), dtype=torch.bool, device=device)

    def outer_cond(kkt, eps, outer):
        live = (kkt > tol) & (eps > tol) & (outer < options.max_outer_iters)
        return live if gate is None else live & gate

    outer_live = outer_cond(kkt, eps, outer)
    while _any(outer_live):
        # Inner loop from the outer carry; status resets each outer step.
        xi, yi, si, ki = x, y, s, kkt
        inner = torch.ones((B,), dtype=torch.int32, device=device)
        ifailed = torch.zeros((B,), dtype=torch.bool, device=device)
        live = outer_live & (ki > eps) & (inner < options.max_inner_iters) & ~ifailed
        while _any(live):
            xn, yn, sn, F_norm, step_failed, why = inner_body(xi, yi, si, eps)
            if options.verbose:  # the unfused path: why is set
                _report_failed(live & step_failed,
                               "inner step failed (linear={}, linesearch={}) at eps={}",
                               eps, *why)
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
            mcp, options, step, theta, x, y, s, failed, gate=gate
        )
    status = where(failed, FAILED, SOLVED).to(torch.int32)
    if gate is not None:
        # A gated-off lane never ran: it reports FAILED, so its untouched
        # cold-start iterate is never mistaken for a solution.
        status = where(gate, status, FAILED).to(torch.int32)
    return SolveResult(
        x=x, y=y, s=s, kkt_error=kkt, epsilon=eps, outer_iters=outer, status=status
    )


def _terminal_polish(mcp, options, step, theta, x, y, s, failed, gate=None):
    """Terminal polish at fixed ϵ = tol/2 against the TRUE residual
    ‖(g, h−s, s∘y)‖∞, with the caller's Newton ``step``: exits below
    polish_margin·tol so an independently rounded recompute does not flip
    boundary lanes. Returns (x, y, s, true_kkt, failed | true_kkt > tol)."""
    tol = options.tol
    exit_tol = options.polish_margin * tol
    B = x.shape[0]
    eps_p = torch.full((B,), 0.5 * tol, dtype=x.dtype, device=x.device)

    def true_kkt_at(x, y, s):
        with record_function(SPAN_RESIDUAL), matmul_precision("highest"):
            g, h = mcp.gh_batched(x, y, theta)
            return _kkt(g, h - s, s * y)

    def polish_live(tk, p_failed):
        live = (tk > exit_tol) & ~p_failed
        return live if gate is None else live & gate

    where = torch.where
    tk = true_kkt_at(x, y, s)
    iters = 0
    p_failed = torch.zeros_like(failed)
    live = polish_live(tk, p_failed)
    while iters < options.max_inner_iters and _any(live):
        _, _, _, dx, dy, ds = step(x, y, s, eps_p)
        xn, sn, yn, step_failed, _ = _unfused_step(options, x, dx, s, ds, y, dy)
        tkn = true_kkt_at(xn, yn, sn)
        lv = live[:, None]
        x, y, s = where(lv, xn, x), where(lv, yn, y), where(lv, sn, s)
        tk = where(live, tkn, tk)
        p_failed = where(live, step_failed, p_failed)
        iters += 1
        live = polish_live(tk, p_failed)
    return x, y, s, tk, failed | (tk > tol)


def _max_step_to_boundary(v: torch.Tensor, dv: torch.Tensor, frac) -> torch.Tensor:
    """Per lane, the closed-form fraction-to-the-boundary step
    α = min(1, frac · min over δᵢ<0 of −vᵢ/δᵢ): v, dv (B, m) → (B,)."""
    tiny = torch.finfo(v.dtype).tiny
    ratios = torch.where(dv < 0, -v / torch.clamp(dv, max=-tiny), math.inf)
    return torch.clamp(frac * ratios.amin(dim=1), max=1.0)


def _mehrotra_solve_body(mcp, options, theta, x0, y0, s0, tridiag_solver=None) -> SolveResult:
    """Mehrotra predictor-corrector over a batch.

    Per iteration: one Jacobian evaluation and one factorization
    (``linalg.factored_newton_solver``). The affine predictor (rC = s∘y)
    sets σ = (μ_aff/μ)³ per lane; the corrector re-solves with rC = s∘y +
    δs_aff∘δy_aff − target, target = max(σμ, centering_floor·‖(rG, rH)‖∞).
    Each solve is followed by ``refinement_steps`` back-solves against the
    unregularized Jacobian. A non-finite direction fails the lane and stops
    it; ``epsilon`` reports the last mean complementarity μ. With m = 0
    (a pure root-find) the annealed loop runs instead."""
    n, m = mcp.unconstrained_dimension, mcp.constrained_dimension
    if m == 0:
        return _ip_solve_body(mcp, options, theta, x0, y0, s0, tridiag_solver)
    B = theta.shape[0]
    dtype, device = x0.dtype, x0.device
    tol = options.tol
    reg = options.regularization if options.regularization is not None else tol
    st = mcp.time_structure
    tridiag_family = options.linear_solver in BANDED_SOLVERS
    banded = tridiag_family and st.row_permutation is not None
    if tridiag_family:
        tsolve = _tridiag_algorithm(options, tridiag_solver)
    if banded:
        ab = None if mcp.affine_bands is None else mcp.affine_bands.to(dtype=dtype)
        lin = None
    else:
        lin = _make_linearizer(mcp, theta, dtype)
        if tridiag_family:
            # No row time structure: the dense Schur system, permuted to
            # time-major bands, solved afresh per right-hand side.
            make_solver = lambda Gx, Gy, Hx, Hy, y, s, reg: (
                lambda bG, bH, bC: newton_step_tridiag(
                    Gx, Gy, Hx, Hy, y, s, bG, bH, bC, reg, structure=st, algorithm=tsolve))
        elif options.linear_solver == "gmres":
            make_solver = functools.partial(factored_newton_solver("gmres"),
                                            gmres_options=_gmres_options(options))
        else:
            make_solver = factored_newton_solver(options.linear_solver)
    refine_steps = int(options.refinement_steps)
    where = torch.where

    def mv(J, v):
        return (J @ v[..., None])[..., 0]

    def linearize(x, y):
        """(g, h, newton) at the iterate: one Jacobian per iteration;
        ``newton(s)`` factors it once and returns (solve_f, jac_mv), jac_mv
        being the true (unregularized) ∇F_z · δ, in band form on the banded
        tiers."""
        if banded:
            g, h, *bands = gh_banded_fast(mcp, st, x, y, theta, affine_bands=ab)
            return g, h, lambda s: (
                lambda bG, bH, bC: banded_newton_step_compressed(
                    *bands, y, s, bG, bH, bC, reg, st, algorithm=tsolve),
                lambda dx, dy, ds: banded_jac_mv(*bands, y, s, dx, dy, ds, st),
            )
        g, h, Gx, Gy, Hx, Hy = lin(x, y)
        return g, h, lambda s: (
            make_solver(Gx, Gy, Hx, Hy, y, s, reg),
            lambda dx, dy, ds: (mv(Gx, dx) + mv(Gy, dy), mv(Hx, dx) + mv(Hy, dy) - ds,
                                s * dy + y * ds),
        )

    def body(x, y, s):
        with record_function(SPAN_RESIDUAL):
            g, h, newton = linearize(x, y)
        rG, rH = g, h - s
        with record_function(SPAN_NEWTON):
            solve_f, jac_mv = newton(s)

            def solve_refined(bG, bH, bC):
                dx, dy, ds = solve_f(bG, bH, bC)
                for _ in range(refine_steps):
                    eG, eH, eC = jac_mv(dx, dy, ds)
                    cx, cy, cs = solve_f(bG + eG, bH + eH, bC + eC)
                    dx, dy, ds = dx + cx, dy + cy, ds + cs
                return dx, dy, ds

            comp = s * y
            feas = torch.maximum(_absmax(rG), _absmax(rH))
            # Affine predictor: full Newton step toward complementarity 0.
            dx_a, dy_a, ds_a = solve_refined(rG, rH, comp)
            a_s_aff = _max_step_to_boundary(s, ds_a, 1.0)[:, None]
            a_y_aff = _max_step_to_boundary(y, dy_a, 1.0)[:, None]
            mu = comp.sum(dim=1) / m
            mu_aff = ((s + a_s_aff * ds_a) * (y + a_y_aff * dy_a)).sum(dim=1) / m
            sigma = where(
                mu > 0.0,
                torch.clamp((mu_aff / torch.clamp(mu, min=1e-300)) ** 3, 0.0, 1.0),
                0.0,
            ).to(dtype)
            # Corrector: same factorization, centered + second-order rC.
            target = torch.maximum(sigma * mu, options.centering_floor * feas)
            rC = comp + ds_a * dy_a - target[:, None]
            dx, dy, ds = solve_refined(rG, rH, rC)

        finite = lambda d: torch.isfinite(d).all(dim=1)
        lin_failed = ~(
            finite(dx) & finite(dy) & finite(ds) & finite(ds_a) & finite(dy_a)
        )
        keep = ~lin_failed[:, None]
        safe = lambda d: where(keep, d, torch.zeros_like(d))
        a_s = where(lin_failed, 0.0, _max_step_to_boundary(s, safe(ds), options.tau))
        a_y = where(lin_failed, 0.0, _max_step_to_boundary(y, safe(dy), options.tau))
        # safe(): 0·NaN = NaN; a failed step keeps the last good iterate.
        x = x + a_s[:, None] * safe(dx)
        s = s + a_s[:, None] * safe(ds)
        y = y + a_y[:, None] * safe(dy)
        F_norm = torch.maximum(feas, _absmax(comp))
        return x, y, s, F_norm, lin_failed, mu

    x, y, s = x0, y0, s0
    kkt = torch.full((B,), math.inf, dtype=dtype, device=device)
    iters = torch.ones((B,), dtype=torch.int32, device=device)
    failed = torch.zeros((B,), dtype=torch.bool, device=device)
    mu = torch.ones((B,), dtype=dtype, device=device)

    def cond(kkt, iters, failed):
        return (kkt > tol) & (iters < options.max_outer_iters) & ~failed

    live = cond(kkt, iters, failed)
    while _any(live):
        xn, yn, sn, F_norm, step_failed, mu_n = body(x, y, s)
        if options.verbose:
            _report_failed(live & step_failed,
                           "mehrotra step failed (non-finite direction) at mu={}", mu_n)
        lv = live[:, None]
        x, y, s = where(lv, xn, x), where(lv, yn, y), where(lv, sn, s)
        kkt = where(live & ~step_failed, F_norm, kkt)
        iters = where(live, iters + 1, iters)
        failed = where(live, step_failed, failed)
        mu = where(live, mu_n, mu)
        live = cond(kkt, iters, failed)
    failed = failed | ((iters == options.max_outer_iters) & (kkt > tol))

    if options.polish:
        # Mehrotra's own exit tests the pre-step residual; the polish drives
        # the residual at the returned iterate to ≤ tol, with the tier's
        # direct (unfactored) Newton step.
        step = _make_step(mcp, options, theta, dtype, reg, lin=lin,
                          tridiag_solver=tridiag_solver)
        x, y, s, kkt, failed = _terminal_polish(
            mcp, options, step, theta, x, y, s, failed
        )
    status = where(failed, FAILED, SOLVED).to(torch.int32)
    return SolveResult(
        x=x, y=y, s=s, kkt_error=kkt, epsilon=mu, outer_iters=iters, status=status
    )
