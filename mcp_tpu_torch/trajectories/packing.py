"""Flat-vector ↔ structured trajectory/parameter layouts.

  * per-player primal block τᵢ = [x₁; …; x_T; u₁; …; u_T] (states then
    controls, time-major within each);
  * θᵢ = [initial-stateᵢ; extra-paramsᵢ] per player.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from ..blocks import Blocking
from .dynamics import ProductDynamics


class PlayerTrajectory(NamedTuple):
    xs: torch.Tensor  # (T, state_dim)
    us: torch.Tensor  # (T, control_dim)


def trajectory_blocking(dynamics: ProductDynamics, horizon: int) -> Blocking:
    """Per-player primal sizes T·(state_dim + control_dim)."""
    return Blocking(
        tuple(
            horizon * (dynamics.state_dim(i) + dynamics.control_dim(i))
            for i in range(dynamics.num_players)
        )
    )


def unpack_trajectory(
    flat_blocks: Sequence[torch.Tensor], *, dynamics: ProductDynamics, horizon: int
) -> tuple[PlayerTrajectory, ...]:
    """Per-player flat block → (xs, us) matrices."""
    out = []
    for i, tau in enumerate(flat_blocks):
        sd, cd = dynamics.state_dim(i), dynamics.control_dim(i)
        xs = tau[: sd * horizon].reshape(horizon, sd)
        us = tau[sd * horizon :].reshape(horizon, cd)
        out.append(PlayerTrajectory(xs=xs, us=us))
    return tuple(out)


def pack_trajectory(trajs: Sequence[PlayerTrajectory]) -> tuple[torch.Tensor, ...]:
    """(xs, us) per player → flat per-player blocks."""
    return tuple(torch.cat([t.xs.reshape(-1), t.us.reshape(-1)]) for t in trajs)


def pack_parameters(
    initial_state_blocks: Sequence[torch.Tensor],
    other_param_blocks: Sequence[torch.Tensor],
) -> tuple[torch.Tensor, ...]:
    """θᵢ = [x₀ᵢ; extraᵢ] per player."""
    return tuple(
        torch.cat([torch.as_tensor(x0), torch.as_tensor(p).reshape(-1)])
        for x0, p in zip(initial_state_blocks, other_param_blocks)
    )


def unpack_parameters(
    theta_blocks: Sequence[torch.Tensor], *, dynamics: ProductDynamics
) -> tuple[tuple[torch.Tensor, ...], tuple[torch.Tensor, ...]]:
    """Inverse of pack_parameters."""
    initial, other = [], []
    for i, ti in enumerate(theta_blocks):
        sd = dynamics.state_dim(i)
        initial.append(ti[:sd])
        other.append(ti[sd:])
    return tuple(initial), tuple(other)
