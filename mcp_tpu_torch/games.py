"""N-player parametric games → MCP via stacked KKT conditions.

  * ``OptimizationProblem``: one player's objective plus private equality /
    inequality constraints.
  * ``ParametricGame``: N coupled problems plus shared equality/inequality
    constraints, compiled to a ``PrimalDualMCP``.
  * ``game_to_mcp``: builds each player's Lagrangian gradient ∇ₓᵢLᵢ with
    ``torch.func.grad`` and stacks K = [∇L₁..∇L_N; g; g̃; h; h̃],
    z = [x; λ; λ̃; μ; μ̃] with free (x, λ, λ̃) and nonnegative (μ, μ̃).
  * ``dimensions``: dual sizes found by evaluating the constraints once at a
    test point.

Conventions: the joint primal reaches user callables as a tuple of
per-player tensors ``xs``; private callables receive their own parameter
block ``theta_i``, shared callables the tuple ``thetas`` of all blocks.

    objective(xs, theta_i) -> scalar
    private_equality/inequality(xs, theta_i) -> vector
    shared_equality/inequality(xs, thetas) -> vector

The stacked layout puts every unconstrained row first, so the MCP's G/H
split is contiguous slicing, and g/h compare entry by entry with the JAX
package's layout.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple, Optional, Sequence

import torch
from torch.func import grad

from . import diff as _diff
from .blocks import Blocking, concat_blocks
from .mcp import PrimalDualMCP
from .solver import SolverOptions


@dataclasses.dataclass(frozen=True, eq=False)
class OptimizationProblem:
    """One player's parameterized problem."""

    objective: Callable
    private_equality: Optional[Callable] = None
    private_inequality: Optional[Callable] = None


class GameDimensions(NamedTuple):
    """Static per-player/shared dimensions."""

    x: tuple[int, ...]  # per-player primal sizes
    theta: tuple[int, ...]  # per-player parameter sizes
    lam: tuple[int, ...]  # per-player private-equality dual sizes (λ)
    mu: tuple[int, ...]  # per-player private-inequality dual sizes (μ)
    shared_lam: int  # shared-equality dual size (λ̃)
    shared_mu: int  # shared-inequality dual size (μ̃)


def _eval_len(fn, xs, arg) -> int:
    return int(fn(xs, arg).numel())


def dimensions(
    test_point: Sequence[torch.Tensor],
    test_parameter: Sequence[torch.Tensor],
    problems: Sequence[OptimizationProblem],
    shared_equality: Optional[Callable],
    shared_inequality: Optional[Callable],
) -> GameDimensions:
    xs = tuple(torch.as_tensor(b) for b in test_point)
    thetas = tuple(torch.as_tensor(b) for b in test_parameter)
    lam = tuple(
        0 if p.private_equality is None else _eval_len(p.private_equality, xs, ti)
        for p, ti in zip(problems, thetas)
    )
    mu = tuple(
        0 if p.private_inequality is None else _eval_len(p.private_inequality, xs, ti)
        for p, ti in zip(problems, thetas)
    )
    shared_lam = 0 if shared_equality is None else _eval_len(shared_equality, xs, thetas)
    shared_mu = (
        0 if shared_inequality is None else _eval_len(shared_inequality, xs, thetas)
    )
    return GameDimensions(
        x=tuple(int(b.numel()) for b in xs),
        theta=tuple(int(b.numel()) for b in thetas),
        lam=lam,
        mu=mu,
        shared_lam=shared_lam,
        shared_mu=shared_mu,
    )


class GameMCPComponents(NamedTuple):
    G: Callable
    H: Callable
    GH: Callable
    dims: GameDimensions
    unconstrained_dimension: int
    constrained_dimension: int


def game_to_mcp(
    *,
    test_point: Sequence[torch.Tensor],
    test_parameter: Sequence[torch.Tensor],
    problems: Sequence[OptimizationProblem],
    shared_equality: Optional[Callable] = None,
    shared_inequality: Optional[Callable] = None,
) -> GameMCPComponents:
    """Stack the KKT conditions of all players into MCP residuals.

    Variable layout:
        unconstrained u = [x₁..x_N ; λ₁..λ_N ; λ̃]      (free)
        constrained   v = [μ₁..μ_N ; μ̃]                (≥ 0)
    Residual layout:
        G(u, v, θ) = [∇ₓ₁L₁..∇ₓ_NL_N ; g₁..g_N ; g̃]
        H(u, v, θ) = [h₁..h_N ; h̃]
    """
    problems = tuple(problems)
    N = len(problems)
    dims = dimensions(
        test_point, test_parameter, problems, shared_equality, shared_inequality
    )
    x_blocking = Blocking(dims.x)
    lam_blocking = Blocking(dims.lam)
    mu_blocking = Blocking(dims.mu)
    theta_blocking = Blocking(dims.theta)

    nx, nlam = x_blocking.total, lam_blocking.total
    n_unconstrained = nx + nlam + dims.shared_lam
    n_constrained = mu_blocking.total + dims.shared_mu

    def GH(u, v, theta):
        xs = x_blocking.split(u[:nx])
        lams = lam_blocking.split(u[nx : nx + nlam])
        shared_lam = u[nx + nlam :]
        mus = mu_blocking.split(v[: mu_blocking.total])
        shared_mu = v[mu_blocking.total :]
        thetas = theta_blocking.split(theta)

        # Each player's private Lagrangian, differentiated in its own block.
        def lagrangian(xi, i):
            xs_i = xs[:i] + (xi,) + xs[i + 1 :]
            p = problems[i]
            L = p.objective(xs_i, thetas[i])
            if p.private_equality is not None:
                L = L - lams[i] @ p.private_equality(xs_i, thetas[i])
            if p.private_inequality is not None:
                L = L - mus[i] @ p.private_inequality(xs_i, thetas[i])
            return L

        grad_Ls = [
            grad(functools.partial(lagrangian, i=i))(xs[i]) for i in range(N)
        ]
        g_shared, h_shared = [], []
        if shared_equality is not None or shared_inequality is not None:
            # The shared terms λ̃·g̃ + μ̃·h̃ enter every player's Lagrangian
            # alike: one gradient over the joint primal gives each player's
            # block, and one evaluation gives the residual rows (evaluating
            # them once per player multiplied the residual's operation count
            # by about N).
            def shared(x):
                xs_x = x_blocking.split(x)
                S, vals = 0.0, ([], [])
                if shared_equality is not None:
                    vals[0].append(shared_equality(xs_x, thetas))
                    S = S + shared_lam @ vals[0][0]
                if shared_inequality is not None:
                    vals[1].append(shared_inequality(xs_x, thetas))
                    S = S + shared_mu @ vals[1][0]
                return S, vals

            grad_S, (g_shared, h_shared) = grad(shared, has_aux=True)(u[:nx])
            grad_Ls = [
                gL - gS for gL, gS in zip(grad_Ls, x_blocking.split(grad_S))
            ]
        gs = [
            p.private_equality(xs, ti)
            for p, ti in zip(problems, thetas)
            if p.private_equality is not None
        ]
        hs = [
            p.private_inequality(xs, ti)
            for p, ti in zip(problems, thetas)
            if p.private_inequality is not None
        ]
        return (
            concat_blocks(grad_Ls + gs + g_shared, dtype=u.dtype),
            concat_blocks(hs + h_shared, dtype=u.dtype),
        )

    return GameMCPComponents(
        G=lambda u, v, theta: GH(u, v, theta)[0],
        H=lambda u, v, theta: GH(u, v, theta)[1],
        GH=GH,
        dims=dims,
        unconstrained_dimension=n_unconstrained,
        constrained_dimension=n_constrained,
    )


@dataclasses.dataclass(frozen=True, eq=False)
class ParametricGame:
    """An N-player parametric game compiled to a PrimalDualMCP."""

    problems: tuple[OptimizationProblem, ...]
    shared_equality: Optional[Callable]
    shared_inequality: Optional[Callable]
    dims: GameDimensions
    mcp: PrimalDualMCP

    @staticmethod
    def create(
        *,
        test_point: Sequence[torch.Tensor],
        test_parameter: Sequence[torch.Tensor],
        problems: Sequence[OptimizationProblem],
        shared_equality: Optional[Callable] = None,
        shared_inequality: Optional[Callable] = None,
        compute_sensitivities: bool = True,
    ) -> "ParametricGame":
        comps = game_to_mcp(
            test_point=test_point,
            test_parameter=test_parameter,
            problems=problems,
            shared_equality=shared_equality,
            shared_inequality=shared_inequality,
        )
        mcp = PrimalDualMCP(
            G=comps.G,
            H=comps.H,
            GH=comps.GH,
            unconstrained_dimension=comps.unconstrained_dimension,
            constrained_dimension=comps.constrained_dimension,
            parameter_dimension=sum(comps.dims.theta),
            compute_sensitivities=compute_sensitivities,
            # Game h-rows are functions of the primal x only (Hy ≡ 0).
            assume_hy_zero=True,
        )
        return ParametricGame(
            problems=tuple(problems),
            shared_equality=shared_equality,
            shared_inequality=shared_inequality,
            dims=comps.dims,
            mcp=mcp,
        )

    @property
    def num_players(self) -> int:
        return len(self.problems)

    @property
    def primal_blocking(self) -> Blocking:
        return Blocking(self.dims.x)

    @property
    def parameter_blocking(self) -> Blocking:
        return Blocking(self.dims.theta)


class GameSolveResult(NamedTuple):
    """A game solve: the per-player primals and the raw MCP variables (the
    JAX package's ``GameSolveResult``)."""

    primals: tuple[torch.Tensor, ...]
    x: torch.Tensor
    y: torch.Tensor
    s: torch.Tensor
    kkt_error: torch.Tensor
    epsilon: torch.Tensor
    outer_iters: torch.Tensor
    status: torch.Tensor

    @property
    def variables(self):
        """The raw MCP variables as a bundle ``(x, y, s)``, for warm starts."""
        from types import SimpleNamespace

        return SimpleNamespace(x=self.x, y=self.y, s=self.s)


def solve_game(
    game: ParametricGame,
    theta,
    *,
    x0=None,
    y0=None,
    s0=None,
    options: Optional[SolverOptions] = None,
    **option_overrides,
) -> GameSolveResult:
    """Solve one instance of a parametric game. ``theta`` is a flat vector
    (the per-player blocks concatenated) or a sequence of per-player blocks;
    the iterates take its dtype and device. Without ``options``, the tier
    defaults to ``linear_solver="schur"`` and
    ``sensitivity_solver="condensed"`` (game MCPs have Hy ≡ 0, so both are
    exact), as in the JAX package. Differentiable in θ (``diff.solve``)."""
    if isinstance(theta, (list, tuple)):
        theta = concat_blocks(theta)
    else:
        theta = torch.as_tensor(theta).reshape(-1)
    if options is None:
        option_overrides.setdefault("linear_solver", "schur")
        option_overrides.setdefault("sensitivity_solver", "condensed")
    sol = _diff.solve(game.mcp, theta, x0=x0, y0=y0, s0=s0, options=options,
                      **option_overrides)
    return GameSolveResult(
        primals=game.primal_blocking.split(sol.x[: sum(game.dims.x)]),
        x=sol.x,
        y=sol.y,
        s=sol.s,
        kkt_error=sol.kkt_error,
        epsilon=sol.epsilon,
        outer_iters=sol.outer_iters,
        status=sol.status,
    )


def num_players(game: ParametricGame) -> int:
    """The number of players (the JAX package's ``num_players``)."""
    return game.num_players
