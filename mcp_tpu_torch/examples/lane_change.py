"""Two-player lane-change trajectory game.

Two planar double integrators on a two-lane road; each player tracks a lane
preference (its per-player parameter) and a nominal forward speed and
penalizes effort; players must stay ≥ 2 m apart (squared-distance ≥ 4
coupling rows).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..games import ParametricGame
from ..trajectories import (
    PolygonEnvironment,
    ProductDynamics,
    TimeSeparableTrajectoryGameCost,
    TrajectoryGame,
    build_parametric_game,
    mean_reducer,
    planar_double_integrator,
)


class RoadEnvironment(NamedTuple):
    lane_centers: tuple[float, ...]
    environment: PolygonEnvironment


def setup_road_environment(
    *, lane_width: float = 2.0, num_lanes: int = 2, height: float = 50.0
) -> RoadEnvironment:
    """Rectangular road polygon with lane centers."""
    lane_centers = tuple((i + 0.5) * lane_width for i in range(num_lanes))
    lo = lane_centers[0] - 0.5 * lane_width
    hi = lane_centers[-1] + 0.5 * lane_width
    vertices = [[lo, 0.0], [hi, 0.0], [hi, height], [lo, height]]
    return RoadEnvironment(
        lane_centers=lane_centers,
        environment=PolygonEnvironment.from_vertices(vertices),
    )


def setup_trajectory_game(
    *, environment: PolygonEnvironment, state_bounds=None
) -> TrajectoryGame:
    """Costs, collision coupling, and bounded double-integrator dynamics.
    ``state_bounds`` overrides the ±10 m/s velocity box."""

    def make_stage_cost(i):
        def stage_cost(xs, us, t, theta_i):
            lane_preference = theta_i[-1]
            x_i, u_i = xs[i], us[i]
            # The nominal velocity (0, 2) enters as scalars: a tensor literal
            # here would be a host-to-device copy per residual evaluation.
            return (
                (x_i[0] - lane_preference) ** 2
                + 0.5 * ((x_i[2] - 0.0) ** 2 + (x_i[3] - 2.0) ** 2)
                + 0.1 * torch.sum(u_i**2)
            )

        return stage_cost

    cost = TimeSeparableTrajectoryGameCost(
        stage_costs=[make_stage_cost(i) for i in range(2)],
        reducer=mean_reducer,
        discount_factor=1.0,
    )

    def coupling_constraints(xs, us, thetas):
        # ‖p₁ - p₂‖² - 4 ≥ 0 at every step.
        d = xs[0][:, :2] - xs[1][:, :2]
        return torch.sum(d * d, dim=1) - 4.0

    if state_bounds is None:
        state_bounds = {
            "lb": [-math.inf, -math.inf, -10.0, 0.0],
            "ub": [math.inf, math.inf, 10.0, 10.0],
        }
    agent_dynamics = planar_double_integrator(
        state_bounds=state_bounds,
        control_bounds={"lb": [-5.0, -5.0], "ub": [3.0, 3.0]},
    )
    return TrajectoryGame(
        dynamics=ProductDynamics([agent_dynamics, agent_dynamics]),
        cost=cost,
        env=environment,
        coupling_constraints=coupling_constraints,
    )


def build_lane_change_game(
    *, horizon: int = 10, num_lanes: int = 2, lane_width: float = 2.0,
    height: float = 50.0, state_bounds=None, device="cuda",
) -> tuple[TrajectoryGame, ParametricGame, RoadEnvironment]:
    """Build the lane-change game; its build-time constants live on
    ``device`` (default ``"cuda"``, which raises on a machine without a
    GPU)."""
    road = setup_road_environment(
        lane_width=lane_width, num_lanes=num_lanes, height=height
    )
    game = setup_trajectory_game(
        environment=road.environment, state_bounds=state_bounds
    )
    parametric_game = build_parametric_game(
        game=game, horizon=horizon, params_per_player=1, device=device
    )
    return game, parametric_game, road
