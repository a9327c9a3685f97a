"""Differentiation through the interior-point solve via the implicit function
theorem (IFT), batch-first.

At a solution F(z*; θ, ϵ) = 0, so ∂z*/∂θ = −(∇F_z)⁻¹ ∇F_θ (the JAX
package's ``mcp_tpu/diff.py``). ``_IFTSolve`` is a ``torch.autograd.Function``
around ``ip_solve``: its forward solves without a graph; its backward (reverse
mode) solves the transposed system (−∇F_z)ᵀ w = z̄ at the solution and
returns θ̄ = ∇F_θᵀ w, one vector–Jacobian product of F in θ; its ``jvp``
(forward mode, ``torch.autograd.forward_ad``) returns ż = (−∇F_z)⁻¹ ∇F_θ θ̇,
one Jacobian–vector product of F in θ and one solve. ∇F_θ is never
materialized. ∇F_z is evaluated at the final ϵ and without the tol·I
regularization. Warm starts get no tangent; status, outer_iters, kkt_error
and epsilon are not differentiable. Lanes that did not solve get whatever
tangent the algebra gives, as in the JAX package.

The solve with ∇F_z follows ``options.sensitivity_solver``, as the JAX
package's three branches do:

* ``"tridiag"`` on a game with Hy ≡ 0 and a row time structure: the banded
  IFT. The colored-seed bands at the solution give A = Gx − Gy·diag(y/s)·Hx
  block by block; A (forward mode) or Aᵀ (reverse mode, the transposed
  bands) is solved by the block-tridiagonal solve of ``options.linear_solver``
  ("tridiag_pallas" → its kernel route, e.g. K7a; "tridiag_auto" → its route;
  "tridiag_cr" → cyclic reduction; every other tier → the plain LU
  block-Thomas), or by the override ``tridiag_solver`` of ``_solve_ts``
  (the horizon-sharded SPIKE solve of ``parallel/horizon.py``);
* ``"condensed"``, or ``"tridiag"`` without row structure, with Hy ≡ 0: the
  same elimination on the dense n×n A, solved by ``torch.linalg.solve``
  (``"tridiag"``: ``block_tridiag.tridiag_solve_permuted``; ``"condensed"``
  with a ``newton_solver`` that has ``ift_solve`` and ``ift_solve_t``: by
  those, e.g. the tensor-parallel LU of ``parallel/tensor.py``);
* otherwise: the dense (n+2m) ∇F_z, LU-factored once (``lu_solve`` with
  ``adjoint=True`` for the transpose).

Spans ``mcp.ift_bands`` (the Jacobian or bands at the solution) and
``mcp.ift_solve`` (the linear solves) mark the host time of each part.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.func import jacfwd, jvp, vjp, vmap
from torch.profiler import record_function

from .kernels.block_tridiag import (
    _indices,
    block_thomas_solve,
    gh_banded_fast,
    tridiag_solve_permuted,
)
from .linalg import assemble_dense_jacobian
from .mcp import PrimalDualMCP
from .solver import BANDED_SOLVERS, SolverOptions, default_initialization, ip_solve
from .types import SolveResult

Tensor = torch.Tensor

SPAN_IFT_BANDS = "mcp.ift_bands"
SPAN_IFT_SOLVE = "mcp.ift_solve"

_MISSING = (
    "Missing sensitivities. Set `compute_sensitivities=True` when "
    "constructing the PrimalDualMCP."
)

#: The Newton tiers whose block-tridiagonal solve the banded IFT also runs
#: (the JAX package's ``diff.py:254-267``); every other tier takes the plain
#: LU sweep.
IFT_NEWTON_TIERS = ("tridiag_pallas", "tridiag_auto", "tridiag_cr")


def _band_solve(tier: str, diag: Tensor, lower: Tensor, upper: Tensor, rhs: Tensor, *,
                tridiag_solver=None) -> Tensor:
    """The banded IFT's block-tridiagonal solve on tier ``tier``, or by the
    override ``tridiag_solver`` when one is given."""
    if tridiag_solver is not None:
        solver = tridiag_solver
    else:
        solver = BANDED_SOLVERS[tier] if tier in IFT_NEWTON_TIERS else block_thomas_solve
    return solver(diag, lower, upper, rhs)


def _mv(A: Tensor, v: Tensor) -> Tensor:
    return (A @ v[..., None])[..., 0]


def _eliminated(n, y, s, A_solve, AT_solve, Gy_mv, GyT_mv, Hx_mv, HxT_mv):
    """(solve, transpose_solve) of −∇F_z with Hy ≡ 0: the slack and dual rows
    eliminate through diagonals, leaving one n-sized solve with A (or Aᵀ)."""

    def solve(bvec):
        b1, b2, b3 = bvec[:, :n], bvec[:, n : n + y.shape[1]], bvec[:, n + y.shape[1] :]
        zx = A_solve(b1 - Gy_mv((b3 + y * b2) / s))
        zs = Hx_mv(zx) - b2
        zy = (b3 - y * zs) / s
        return -torch.cat([zx, zy, zs], dim=1)

    def transpose_solve(c):
        c1, c2, c3 = c[:, :n], c[:, n : n + y.shape[1]], c[:, n + y.shape[1] :]
        w1 = AT_solve(c1 - HxT_mv(y * c2 / s) + HxT_mv(c3))
        w3 = (c2 - GyT_mv(w1)) / s
        w2 = y * w3 - c3
        return -torch.cat([w1, w2, w3], dim=1)

    return solve, transpose_solve


def _banded_operators(mcp, options, x, y, s, theta, tridiag_solver=None):
    """The banded IFT: colored-seed (or affine) bands at the solution, the
    n×n core solves on (diag, lower, upper) or their transposes."""
    ts = mcp.time_structure
    B = x.shape[0]
    T, b, mt = ts.num_blocks, ts.block_size, ts.rows_per_block
    perm, rperm, inv, rinv = _indices(ts, x.device)
    ab = None if mcp.affine_bands is None else mcp.affine_bands.to(dtype=x.dtype)
    with record_function(SPAN_IFT_BANDS):
        _, _, diag_b, lower_b, upper_b, Gy_b, Hx_b = gh_banded_fast(
            mcp, ts, x, y, theta, affine_bands=ab
        )
        r_blocks = (y / s)[:, rperm].reshape(B, T, mt)
        # A = Gx − Gy·diag(y/s)·Hx: the reduction is block-diagonal in time.
        A_diag = (diag_b - (Gy_b * r_blocks[:, :, None, :]) @ Hx_b).contiguous()
        AT_diag = A_diag.mT.contiguous()
        # The kernels take bands contiguous within a system; a band shared
        # by every lane (affine games) stays shared (batch stride 0).
        band = lambda a: a.contiguous().expand(B, T - 1, b, b)
        lower, upper = band(lower_b), band(upper_b)
        AT_lower, AT_upper = band(upper_b.mT), band(lower_b.mT)
    def core(diag, lo, up):
        def solve(rhs):
            out = _band_solve(options.linear_solver, diag, lo, up,
                              rhs[:, perm].reshape(B, T, b).contiguous(),
                              tridiag_solver=tridiag_solver)
            return out.reshape(B, -1)[:, inv]

        return solve

    blocks = lambda v, idx, k: v[:, idx].reshape(B, T, k)
    return _eliminated(
        x.shape[1], y, s, core(A_diag, lower, upper), core(AT_diag, AT_lower, AT_upper),
        lambda v: _mv(Gy_b, blocks(v, rperm, mt)).reshape(B, -1)[:, inv],
        lambda w: _mv(Gy_b.mT, blocks(w, perm, b)).reshape(B, -1)[:, rinv],
        lambda v: _mv(Hx_b, blocks(v, perm, b)).reshape(B, -1)[:, rinv],
        lambda w: _mv(Hx_b.mT, blocks(w, rperm, mt)).reshape(B, -1)[:, inv],
    )


def _ift_operators(mcp: PrimalDualMCP, options: SolverOptions, x, y, s, theta,
                   tridiag_solver=None, newton_solver=None):
    """(solve, transpose_solve) of −∇F_z at the solution: ``solve(b)`` is
    z with −∇F_z z = b, ``transpose_solve(c)`` is w with (−∇F_z)ᵀ w = c,
    both over the batch ((B, n+2m) → (B, n+2m)). ``tridiag_solver`` reaches
    the banded branch only, ``newton_solver`` the condensed one, as in the
    JAX package."""
    sens = options.sensitivity_solver
    ts = mcp.time_structure
    if (sens == "tridiag" and mcp.assume_hy_zero and ts is not None
            and ts.row_permutation is not None):
        return _banded_operators(mcp, options, x, y, s, theta, tridiag_solver)
    with record_function(SPAN_IFT_BANDS):
        Gx, Gy, Hx, Hy = vmap(mcp.gh_jacobians)(x, y, theta)
    if sens in ("condensed", "tridiag") and mcp.assume_hy_zero:
        A = Gx - (Gy * (y / s)[:, None, :]) @ Hx
        if sens == "tridiag":
            if ts is None:
                raise ValueError(
                    "sensitivity_solver='tridiag' requires an MCP with "
                    "time_structure (trajectory games)."
                )
            A_solve = lambda r: tridiag_solve_permuted(A, r, ts)
            AT_solve = lambda r: tridiag_solve_permuted(A.mT, r, ts)
        elif hasattr(newton_solver, "ift_solve"):
            # The backend's own core solves: the backward pass rides the
            # same ranks as the forward.
            A_solve = lambda r: newton_solver.ift_solve(A, r)
            AT_solve = lambda r: newton_solver.ift_solve_t(A, r)
        else:
            A_solve = lambda r: torch.linalg.solve(A, r)
            AT_solve = lambda r: torch.linalg.solve(A.mT, r)
        return _eliminated(
            x.shape[1], y, s, A_solve, AT_solve,
            lambda v: _mv(Gy, v), lambda w: _mv(Gy.mT, w),
            lambda v: _mv(Hx, v), lambda w: _mv(Hx.mT, w),
        )
    LU, piv = torch.linalg.lu_factor(-assemble_dense_jacobian(Gx, Gy, Hx, Hy, y, s))
    return (
        lambda bvec: torch.linalg.lu_solve(LU, piv, bvec[..., None])[..., 0],
        lambda c: torch.linalg.lu_solve(LU, piv, c[..., None], adjoint=True)[..., 0],
    )


def _F_of_theta(mcp, x, y, s, eps):
    """θ (B, p) ↦ F(x, y, s; θ, ϵ) (B, n+2m) at the solution."""
    return lambda th: vmap(mcp.F)(x, y, s, th, eps)


class _IFTSolve(torch.autograd.Function):
    """``ip_solve`` with IFT derivatives in θ (reverse and forward mode);
    ``tridiag_solver`` overrides the banded block-tridiagonal solves of both
    the solve and the IFT, ``newton_solver`` the Newton steps and (see
    ``_ift_operators``) the condensed IFT's core solves."""

    @staticmethod
    def forward(mcp, options, tridiag_solver, newton_solver, theta, x0, y0, s0):
        out = ip_solve(mcp, options, theta, x0, y0, s0, tridiag_solver, newton_solver)
        # A solve whose loop never runs (max_outer_iters ≤ 1) returns its
        # starting point itself; autograd saves no input as an output, so
        # such an output leaves as a view.
        inputs = (theta, x0, y0, s0)
        return tuple(v.view_as(v) if any(v is a for a in inputs) else v for v in out)

    @staticmethod
    def setup_context(ctx, inputs, output):
        mcp, options, tridiag_solver, newton_solver, theta = inputs[:5]
        x, y, s, kkt, eps, outer, status = output
        ctx.mark_non_differentiable(kkt, eps, outer, status)
        ctx.mcp, ctx.options, ctx.tridiag_solver = mcp, options, tridiag_solver
        ctx.newton_solver = newton_solver
        ctx.save_for_backward(theta, x, y, s, eps)
        ctx.save_for_forward(theta, x, y, s, eps)

    @staticmethod
    def backward(ctx, gx, gy, gs, *_):
        if not ctx.mcp.compute_sensitivities:
            raise ValueError(_MISSING)
        theta, x, y, s, eps = ctx.saved_tensors
        zbar = torch.cat([torch.zeros_like(v) if g is None else g
                          for g, v in ((gx, x), (gy, y), (gs, s))], dim=1)
        _, transpose_solve = _ift_operators(ctx.mcp, ctx.options, x, y, s, theta,
                                            ctx.tridiag_solver, ctx.newton_solver)
        with record_function(SPAN_IFT_SOLVE):
            w = transpose_solve(zbar)
        _, F_vjp = vjp(_F_of_theta(ctx.mcp, x, y, s, eps), theta)
        return None, None, None, None, F_vjp(w)[0], None, None, None

    @staticmethod
    def jvp(ctx, _mcp, _options, _tridiag_solver, _newton_solver, theta_dot, *_):
        if not ctx.mcp.compute_sensitivities:
            raise ValueError(_MISSING)
        theta, x, y, s, eps = ctx.saved_tensors
        n, m = x.shape[1], y.shape[1]
        if theta_dot is None:
            z = torch.zeros((x.shape[0], n + 2 * m), dtype=x.dtype, device=x.device)
        else:
            _, F_dot = jvp(_F_of_theta(ctx.mcp, x, y, s, eps), (theta,), (theta_dot,))
            solve, _ = _ift_operators(ctx.mcp, ctx.options, x, y, s, theta,
                                      ctx.tridiag_solver, ctx.newton_solver)
            with record_function(SPAN_IFT_SOLVE):
                z = solve(F_dot)
        return z[:, :n], z[:, n : n + m], z[:, n + m :], None, None, None, None


def _solve_ts(mcp: PrimalDualMCP, options: SolverOptions, tridiag_solver, newton_solver,
              theta, x0, y0, s0) -> SolveResult:
    """One batched solve (θ (B, p), warm starts (B, ·)), differentiable in θ
    through the IFT, with the banded block-tridiagonal solves of the Newton
    steps and of the IFT overridden by ``tridiag_solver`` and the other
    tiers' Newton steps by ``newton_solver`` (None: the tier's own; see
    ``_ift_operators`` for the IFT's). The solve itself runs without a
    graph, so a θ that carries no gradient and no tangent costs what
    ``ip_solve`` costs."""
    return SolveResult(*_IFTSolve.apply(mcp, options, tridiag_solver, newton_solver,
                                        theta, x0, y0, s0))


def _solve(mcp: PrimalDualMCP, options: SolverOptions, theta, x0, y0, s0) -> SolveResult:
    """``_solve_ts`` without overrides."""
    return _solve_ts(mcp, options, None, None, theta, x0, y0, s0)


def solve(
    mcp: PrimalDualMCP,
    theta: Tensor,
    *,
    x0: Optional[Tensor] = None,
    y0: Optional[Tensor] = None,
    s0: Optional[Tensor] = None,
    options: Optional[SolverOptions] = None,
    **option_overrides,
) -> SolveResult:
    """Solve an MCP, differentiable in θ (``torch.autograd`` and
    ``torch.autograd.forward_ad``). θ (p,) solves one instance and returns
    fields without a batch axis; θ (B, p) solves a batch. Option keywords
    take the reference names (tol, max_inner_iters, max_outer_iters,
    tightening_rate, loosening_rate, min_stepsize) and every other
    ``SolverOptions`` field. The iterates take θ's dtype and device."""
    if options is None:
        options = SolverOptions(**option_overrides)
    elif option_overrides:
        options = dataclasses.replace(options, **option_overrides)
    theta = torch.as_tensor(theta)
    x0, y0, s0 = default_initialization(mcp, theta, x0, y0, s0)
    if theta.dim() == 1:
        res = _solve(mcp, options, theta[None], x0[None], y0[None], s0[None])
        return SolveResult(*(f[0] for f in res))
    return _solve(mcp, options, theta, x0, y0, s0)


def solve_jacobian_theta(
    mcp: PrimalDualMCP, sol: SolveResult, theta: Tensor, *, method: str = "lu"
) -> Tensor:
    """The full ∂z*/∂θ (the reference's ``_solve_jacobian_θ``): θ (p,) and an
    unbatched ``sol`` give (n+2m, p); θ (B, p) and a batched ``sol`` give
    (B, n+2m, p). ``method`` "lstsq" is the rank-revealing least-squares
    solve, anything else the LU solve."""
    if not mcp.compute_sensitivities:
        raise ValueError(_MISSING)
    single = theta.dim() == 1
    if single:
        sol = SolveResult(*(f[None] for f in sol))
        theta = theta[None]
    x, y, s, eps = sol.x, sol.y, sol.s, sol.epsilon
    Gx, Gy, Hx, Hy = vmap(mcp.gh_jacobians)(x, y, theta)
    Jz = assemble_dense_jacobian(Gx, Gy, Hx, Hy, y, s)
    J_theta = vmap(jacfwd(mcp.F, argnums=3))(x, y, s, theta, eps)
    if method == "lstsq":
        out = torch.linalg.lstsq(-Jz, J_theta).solution
    else:
        out = torch.linalg.solve(-Jz, J_theta)
    return out[0] if single else out
