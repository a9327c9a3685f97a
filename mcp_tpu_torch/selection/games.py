"""Masked N-player goal-reaching games for learned player selection (the
JAX package's ``selection/games.py``): per-player parameters
θᵢ = [initial-stateᵢ (4); goalᵢ (2); mask (N)] and the stage cost

    goal_w·‖pᵢ − goalᵢ‖² + ‖vᵢ‖² + 0.1‖uᵢ‖² + rep_w·Σ_{j≠i} maskᵢ·maskⱼ / ‖pᵢ − pⱼ‖²

whose pairwise repulsion is soft-masked at the cost level: zeroing mask
entries removes those players' interactions. The repulsion is not
quadratic, so these games carry no affine bands: every Newton step
linearizes by colored forward seeds. The "real" variant carries the
pedestrian-dataset-fitted bounds.
"""

from __future__ import annotations

import math

import torch

from ..trajectories import (
    PolygonEnvironment,
    ProductDynamics,
    TimeSeparableTrajectoryGameCost,
    TrajectoryGame,
    build_parametric_game,
    mean_reducer,
    planar_double_integrator,
)


def setup_road_environment(*, length: float = 10.0) -> PolygonEnvironment:
    """Square environment of side ``length`` centered at the origin."""
    h = 0.5 * length
    return PolygonEnvironment.from_vertices([[-h, -h], [h, -h], [h, h], [-h, h]])


def setup_real_environment(
    *, xmin: float, xmax: float, ymin: float, ymax: float
) -> PolygonEnvironment:
    """Axis-aligned box environment."""
    return PolygonEnvironment.from_vertices(
        [[xmin, ymin], [xmax, ymin], [xmax, ymax], [xmin, ymax]]
    )


def _masked_game(
    *,
    environment: PolygonEnvironment,
    N: int,
    goal_weight: float,
    repulsion_weight: float,
    state_bounds,
    control_bounds,
    trivial_coupling: bool = True,
) -> TrajectoryGame:
    def make_stage_cost(i):
        def stage_cost(xs, us, t, theta_i):
            goal = theta_i[-(N + 2) : -N]
            mask = theta_i[-N:]
            p_i = xs[i][:2]
            repulsion = sum(
                (mask[i] * mask[j]) / torch.sum((p_i - xs[j][:2]) ** 2)
                for j in range(N)
                if j != i
            )
            return (
                goal_weight * torch.sum((p_i - goal) ** 2)
                + torch.sum(xs[i][2:4] ** 2)
                + 0.1 * torch.sum(us[i] ** 2)
                + repulsion_weight * repulsion
            )

        return stage_cost

    cost = TimeSeparableTrajectoryGameCost(
        stage_costs=[make_stage_cost(i) for i in range(N)],
        reducer=mean_reducer,
        discount_factor=1.0,
    )

    # A constant [1] row per time step (the reference's placeholder coupling:
    # collision avoidance lives in the soft-masked cost), kept for shape
    # parity; trivial_coupling=False drops the rows.
    coupling = None
    if trivial_coupling:

        def coupling(xs, us, thetas):
            return torch.ones(xs[0].shape[0], dtype=xs[0].dtype, device=xs[0].device)

    agent_dynamics = planar_double_integrator(
        state_bounds=state_bounds, control_bounds=control_bounds
    )
    return TrajectoryGame(
        dynamics=ProductDynamics([agent_dynamics] * N),
        cost=cost,
        env=environment,
        coupling_constraints=coupling,
    )


def setup_trajectory_game(
    *, environment: PolygonEnvironment, N: int, trivial_coupling: bool = True
) -> TrajectoryGame:
    """The synthetic masked game."""
    return _masked_game(
        environment=environment,
        N=N,
        goal_weight=1.0,
        repulsion_weight=2.0,
        state_bounds={"lb": [-math.inf, -math.inf, -2.0, -2.0],
                      "ub": [math.inf, math.inf, 2.0, 2.0]},
        control_bounds={"lb": [-1.0, -1.0], "ub": [1.0, 1.0]},
        trivial_coupling=trivial_coupling,
    )


def setup_real_game(
    *, environment: PolygonEnvironment, N: int, trivial_coupling: bool = True
) -> TrajectoryGame:
    """The pedestrian-data variant with dataset-fitted bounds."""
    return _masked_game(
        environment=environment,
        N=N,
        goal_weight=0.3,
        repulsion_weight=1.0,
        state_bounds={"lb": [18.5, 2.0, -1.0, -2.3], "ub": [26.0, 23.5, 1.2, 2.2]},
        control_bounds={"lb": [-0.5, -0.5], "ub": [0.5, 0.5]},
        trivial_coupling=trivial_coupling,
    )


def build_masked_parametric_game(
    game: TrajectoryGame, *, N: int, horizon: int = 30,
    compute_sensitivities: bool = True, probes=None, device="cuda",
):
    """Compile a masked game with params_per_player = N + 2 (goal and the
    full mask vector); its build-time constants live on ``device``.
    ``probes`` (``trajectories.GameProbes``) skips the build's probes."""
    return build_parametric_game(
        game=game,
        horizon=horizon,
        params_per_player=N + 2,
        compute_sensitivities=compute_sensitivities,
        probes=probes,
        device=device,
    )


def pack_masked_theta(
    initial_states: torch.Tensor, goals: torch.Tensor, mask: torch.Tensor, *,
    ego_index: int = 0,
) -> torch.Tensor:
    """θ blocks per player [x0ᵢ; goalᵢ; maskᵢ]: the learned mask goes into the
    ego player's block, the other players see all-ones.

    initial_states (N, 4); goals (N, 2); mask (N,) with mask[ego] == 1.
    """
    N = initial_states.shape[0]
    ones = torch.ones((N,), dtype=mask.dtype, device=mask.device)
    return torch.cat([
        torch.cat([initial_states[i], goals[i], mask if i == ego_index else ones])
        for i in range(N)
    ])
