"""Trajectory-game cost containers and the TrajectoryGame bundle."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from .dynamics import ProductDynamics
from .environment import PolygonEnvironment


@dataclasses.dataclass(frozen=True, eq=False)
class TimeSeparableTrajectoryGameCost:
    """Per-player stage costs + reducer + discounting.

    stage_costs[i] has signature (xs, us, t, theta_i) -> scalar where xs/us
    are tuples of per-player state/control vectors at time t and t is the
    0-based stage index. The total cost is
        reducer([γ^t · stage_cost(x_t, u_t, t, θi) for t in 0..T-1]).
    """

    stage_costs: tuple[Callable, ...]
    reducer: Callable[[torch.Tensor], torch.Tensor]
    discount_factor: float = 1.0

    def __post_init__(self):
        object.__setattr__(self, "stage_costs", tuple(self.stage_costs))


def mean_reducer(stage_cost_values: torch.Tensor) -> torch.Tensor:
    """reduce(+)/length over the stage costs."""
    return stage_cost_values.mean()


@dataclasses.dataclass(frozen=True, eq=False)
class TrajectoryGame:
    """Bundle of dynamics, cost, environment, and coupling constraints."""

    dynamics: ProductDynamics
    cost: TimeSeparableTrajectoryGameCost
    env: Optional[PolygonEnvironment]
    # coupling_constraints(xs, us, thetas) -> vector of residuals ≥ 0, where
    # xs/us are tuples over players of (T, dim) tensors and thetas is the
    # tuple of per-player parameter blocks. None disables coupling rows.
    coupling_constraints: Optional[Callable] = None

    @property
    def num_players(self) -> int:
        return self.dynamics.num_players
