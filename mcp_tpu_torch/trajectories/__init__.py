"""Trajectory-game front end: dynamics, environment and cost types, the
TrajectoryGame → MCP compiler, and warm-started receding-horizon control."""

from .dynamics import Bounds, LinearDynamics, ProductDynamics, planar_double_integrator
from .environment import PolygonEnvironment, box_constraint_fn
from .costs import TimeSeparableTrajectoryGameCost, TrajectoryGame, mean_reducer
from .packing import (
    PlayerTrajectory,
    pack_parameters,
    pack_trajectory,
    trajectory_blocking,
    unpack_parameters,
    unpack_trajectory,
)
from .game_builder import build_parametric_game
from .strategies import (
    JointStrategy,
    OpenLoopStrategy,
    Rollout,
    WarmStartRecedingHorizonStrategy,
    cold_start_primal,
    rollout,
    solve_trajectory_game,
    zero_input_trajectory,
)

__all__ = [
    "Bounds",
    "LinearDynamics",
    "ProductDynamics",
    "planar_double_integrator",
    "PolygonEnvironment",
    "box_constraint_fn",
    "TimeSeparableTrajectoryGameCost",
    "TrajectoryGame",
    "mean_reducer",
    "PlayerTrajectory",
    "pack_parameters",
    "pack_trajectory",
    "trajectory_blocking",
    "unpack_parameters",
    "unpack_trajectory",
    "build_parametric_game",
    "JointStrategy",
    "OpenLoopStrategy",
    "Rollout",
    "WarmStartRecedingHorizonStrategy",
    "cold_start_primal",
    "rollout",
    "solve_trajectory_game",
    "zero_input_trajectory",
]
