"""Closed-loop rollout and the zero-input cold start of trajectory-game
solves (the JAX package's ``trajectories/strategies.py:62-113``): the first
solve of a scenario seeds the primal with a zero-control rollout of the
dynamics and zero equality duals.

The warm-started receding-horizon strategy is not ported yet (ROADMAP
Queue 1 item 5).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..games import ParametricGame
from .costs import TrajectoryGame
from .packing import PlayerTrajectory, pack_trajectory


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
