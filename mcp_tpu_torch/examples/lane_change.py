"""Two-player lane-change trajectory game, and its receding-horizon demos.

Two planar double integrators on a two-lane road; each player tracks a lane
preference (its per-player parameter) and a nominal forward speed and
penalizes effort; players must stay ≥ 2 m apart (squared-distance ≥ 4
coupling rows).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .._device import resolve_device
from ..games import ParametricGame
from ..solver import SolverOptions
from ..trajectories import (
    PolygonEnvironment,
    ProductDynamics,
    TimeSeparableTrajectoryGameCost,
    TrajectoryGame,
    WarmStartRecedingHorizonStrategy,
    build_parametric_game,
    mean_reducer,
    planar_double_integrator,
    rollout,
)

#: Both demos' initial joint state: P1 in the left lane, P2 in the right.
DEMO_INITIAL_STATE = (1.0, 1.0, 0.0, 1.0, 3.2, 0.9, 0.0, 1.0)


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


def _receding_horizon_rollout(game, parametric_game, road, initial_state, *, horizon,
                              turn_length, num_sim_steps, options):
    """Both players prefer the left lane; roll the warm-started receding-
    horizon strategy out from ``initial_state``, recording each step's
    latest solve status."""
    lane = initial_state.new_tensor([road.lane_centers[0]])
    strategy = WarmStartRecedingHorizonStrategy(
        game=game,
        parametric_game=parametric_game,
        turn_length=turn_length,
        horizon=horizon,
        parameters=[lane, lane],
        options=options,
    )
    sim = rollout(
        game.dynamics,
        strategy,
        initial_state,
        num_sim_steps,
        get_info=lambda strat, x, t: strat.solution_status,
    )
    return sim, strategy


def run_lane_change_example(
    *,
    initial_state=None,
    horizon: int = 10,
    height: float = 50.0,
    num_lanes: int = 2,
    lane_width: float = 2.0,
    num_sim_steps: int = 10,
    turn_length: int = 2,
    options: Optional[SolverOptions] = None,
    device="cuda",
    dtype=torch.float32,
):
    """End-to-end receding-horizon lane-change demo: both players prefer the
    left lane; P2 starts in the right lane and must merge behind or ahead
    while keeping the 2 m separation. The game's constants and the states
    live on ``device`` (default ``"cuda"``, which raises without a GPU) in
    ``dtype``; each re-plan is one ``solve_game`` on the tier ``options``
    names (default "schur"). Returns (rollout, strategy)."""
    device = resolve_device(device)
    game, parametric_game, road = build_lane_change_game(
        horizon=horizon, num_lanes=num_lanes, lane_width=lane_width, height=height,
        device=device,
    )
    if initial_state is None:
        initial_state = DEMO_INITIAL_STATE
    initial_state = torch.as_tensor(initial_state, dtype=dtype, device=device)
    return _receding_horizon_rollout(
        game, parametric_game, road, initial_state, horizon=horizon,
        turn_length=turn_length, num_sim_steps=num_sim_steps, options=options,
    )


def run_lane_change_origin_example(
    *, num_sim_steps: int = 150, options: Optional[SolverOptions] = None, device="cuda",
    dtype=torch.float32,
):
    """The reference's original lane-change demo: the same game as
    ``run_lane_change_example`` but a tighter velocity box (±5 m/s lateral,
    0–5 m/s forward), 150 simulation steps with a re-plan every 3, and no
    gradient probe inside the receding-horizon solve."""
    device = resolve_device(device)
    game, parametric_game, road = build_lane_change_game(
        horizon=10,
        state_bounds={
            "lb": [-math.inf, -math.inf, -5.0, 0.0],
            "ub": [math.inf, math.inf, 5.0, 5.0],
        },
        device=device,
    )
    initial_state = torch.tensor(DEMO_INITIAL_STATE, dtype=dtype, device=device)
    return _receding_horizon_rollout(
        game, parametric_game, road, initial_state, horizon=10, turn_length=3,
        num_sim_steps=num_sim_steps, options=options,
    )
