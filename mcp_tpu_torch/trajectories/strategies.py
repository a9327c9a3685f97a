"""Open-loop and joint strategies, closed-loop rollout, and warm-started
receding-horizon control of trajectory games.

The first solve of a scenario seeds the primal with a zero-control rollout
of the dynamics and zero equality duals; later solves warm-start from the
last solution's (x, y); the receding-horizon strategy re-plans when its
plan ages past ``turn_length``. The solves run on the card (or wherever θ
lives); the strategy that owns the warm start across re-plans is host-side
Python, since which solution to keep depends on each solve's status.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Sequence

import torch

from ..games import GameSolveResult, ParametricGame, solve_game
from ..solver import SolverOptions
from ..types import SOLVED
from .costs import TrajectoryGame
from .packing import (
    PlayerTrajectory,
    pack_parameters,
    pack_trajectory,
    unpack_parameters,
    unpack_trajectory,
)


@dataclasses.dataclass
class OpenLoopStrategy:
    """Replays a precomputed open-loop plan (ignores the observed state)."""

    xs: torch.Tensor  # (T, state_dim_i)
    us: torch.Tensor  # (T, control_dim_i)

    def __call__(self, state, t: int) -> torch.Tensor:
        return self.us[t]


@dataclasses.dataclass
class JointStrategy:
    """Per-player substrategies applied to the joint state."""

    substrategies: Sequence[Callable]

    def __call__(self, state, t: int) -> torch.Tensor:
        return torch.cat([sub(state, t) for sub in self.substrategies])


class Rollout(NamedTuple):
    xs: torch.Tensor  # (T, state_dim)
    us: torch.Tensor  # (T, control_dim)
    infos: list


def rollout(dynamics, strategy, initial_state, steps: int, *, get_info=None) -> Rollout:
    """Closed-loop rollout: T states and T controls with the dynamics applied
    T−1 times (the packed trajectory layout needs equal-length xs and us)."""
    x = torch.as_tensor(initial_state)
    xs, us, infos = [], [], []
    for t in range(steps):
        u = strategy(x, t)
        xs.append(x)
        us.append(u)
        if get_info is not None:
            infos.append(get_info(strategy, x, t))
        if t < steps - 1:
            x = dynamics(x, u)
    return Rollout(xs=torch.stack(xs), us=torch.stack(us), infos=infos)


def zero_input_trajectory(
    *, game: TrajectoryGame, horizon: int, initial_state
) -> tuple[PlayerTrajectory, ...]:
    """Per-player trajectories of the zero-control rollout from the joint
    ``initial_state`` (state_dim,)."""
    dynamics = game.dynamics
    x0 = torch.as_tensor(initial_state)
    zero = x0.new_zeros(dynamics.control_dim())
    r = rollout(dynamics, lambda x, t: zero, x0, horizon)
    sb, cb = dynamics.state_blocking, dynamics.control_blocking
    return tuple(
        PlayerTrajectory(xs=r.xs[:, so : so + ss], us=r.us[:, co : co + cs])
        for so, ss, co, cs in zip(sb.offsets, sb.sizes, cb.offsets, cb.sizes)
    )


def cold_start_primal(
    game: TrajectoryGame, parametric_game: ParametricGame, horizon: int, initial_state
) -> torch.Tensor:
    """x₀ = [zero-input trajectory; zero equality duals], (n,), from the
    joint initial state (state_dim,)."""
    trajs = zero_input_trajectory(game=game, horizon=horizon, initial_state=initial_state)
    tau = torch.cat(pack_trajectory(trajs))
    dims = parametric_game.dims
    return torch.cat([tau, tau.new_zeros(sum(dims.lam) + dims.shared_lam)])


def solve_trajectory_game(
    game: TrajectoryGame,
    horizon: int,
    parameter_blocks: Sequence[torch.Tensor],
    *,
    parametric_game: ParametricGame,
    last_solution: Optional[GameSolveResult] = None,
    options: Optional[SolverOptions] = None,
    warm_start_slacks: bool = False,
    **solve_kwargs,
) -> tuple[JointStrategy, GameSolveResult]:
    """One receding-horizon plan update: warm-starts from ``last_solution``
    when it SOLVED (its (x, y), and its s too under ``warm_start_slacks``:
    an off-central s₀ = 1 stalls Mehrotra, which re-solves in ~3 iterations
    from s₀ = s*); otherwise cold-starts from the zero-input rollout
    (``cold_start_primal``). θ's blocks set the dtype and device."""
    if last_solution is not None and int(last_solution.status) == SOLVED:
        if warm_start_slacks:
            solve_kwargs = dict(solve_kwargs, s0=last_solution.s)
        sol = solve_game(
            parametric_game,
            parameter_blocks,
            x0=last_solution.x,
            y0=last_solution.y,
            options=options,
            **solve_kwargs,
        )
    else:
        initial_blocks, _ = unpack_parameters(parameter_blocks, dynamics=game.dynamics)
        x0 = cold_start_primal(game, parametric_game, horizon, torch.cat(initial_blocks))
        sol = solve_game(parametric_game, parameter_blocks, x0=x0, options=options,
                         **solve_kwargs)
    trajs = unpack_trajectory(sol.primals, dynamics=game.dynamics, horizon=horizon)
    strategy = JointStrategy([OpenLoopStrategy(t.xs, t.us) for t in trajs])
    return strategy, sol


@dataclasses.dataclass
class WarmStartRecedingHorizonStrategy:
    """Receding-horizon strategy with warm starting, callable as (state,
    time) inside ``rollout``: it re-plans when the current plan ages past
    ``turn_length``. A failed solve does not overwrite the warm start."""

    game: TrajectoryGame
    parametric_game: ParametricGame
    turn_length: int
    horizon: int
    parameters: Sequence[torch.Tensor]  # per-player extra params (beyond initial state)
    options: Optional[SolverOptions] = None
    receding_horizon_strategy: Optional[JointStrategy] = None
    time_last_updated: int = 0
    last_solution: Optional[GameSolveResult] = None
    solution_status: Optional[int] = None

    def __call__(self, state, time: int) -> torch.Tensor:
        plan_exists = self.receding_horizon_strategy is not None
        time_along_plan = time - self.time_last_updated
        plan_is_valid = 0 <= time_along_plan < self.turn_length

        if not plan_exists or not plan_is_valid:
            state_blocks = self.game.dynamics.state_blocking.split(torch.as_tensor(state))
            theta_blocks = pack_parameters(state_blocks, self.parameters)
            strategy, sol = solve_trajectory_game(
                self.game,
                self.horizon,
                theta_blocks,
                parametric_game=self.parametric_game,
                last_solution=self.last_solution,
                options=self.options,
            )
            self.receding_horizon_strategy = strategy
            status = int(sol.status)
            if status == SOLVED:
                self.last_solution = sol
            self.solution_status = status
            self.time_last_updated = time
            time_along_plan = 0

        return self.receding_horizon_strategy(state, time_along_plan)
