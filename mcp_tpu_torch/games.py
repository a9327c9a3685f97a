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

from .blocks import Blocking, concat_blocks
from .mcp import PrimalDualMCP


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

        # Each player's Lagrangian, differentiated in its own block.
        def lagrangian(xi, i):
            xs_i = xs[:i] + (xi,) + xs[i + 1 :]
            p = problems[i]
            L = p.objective(xs_i, thetas[i])
            if p.private_equality is not None:
                L = L - lams[i] @ p.private_equality(xs_i, thetas[i])
            if p.private_inequality is not None:
                L = L - mus[i] @ p.private_inequality(xs_i, thetas[i])
            if shared_equality is not None:
                L = L - shared_lam @ shared_equality(xs_i, thetas)
            if shared_inequality is not None:
                L = L - shared_mu @ shared_inequality(xs_i, thetas)
            return L

        grad_Ls = [
            grad(functools.partial(lagrangian, i=i))(xs[i]) for i in range(N)
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
        g_shared = [] if shared_equality is None else [shared_equality(xs, thetas)]
        h_shared = [] if shared_inequality is None else [shared_inequality(xs, thetas)]
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
