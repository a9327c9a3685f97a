"""Subgame decomposition by hard mask (the JAX package's
``selection/subgame.py``; the reference's masked_game_solver.jl:92-223).

Given a binary player mask, the selected players play a reduced masked game
among themselves, and every unselected player solves a solo goal-reaching
optimal-control problem: the hard-selection counterpart of the cost-level
soft masks. Runners are built once per (players, horizon, arena, device,
options): a game build for a new shape takes seconds.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from .._device import resolve_device
from ..solver import SolverOptions
from ..types import SOLVED
from .games import setup_road_environment, setup_trajectory_game
from .runner import MaskedGameRunner


@functools.lru_cache(maxsize=None)
def _cached_runner(n_players: int, horizon: int, arena_length: float, device: str,
                   options: Optional[SolverOptions]) -> MaskedGameRunner:
    game = setup_trajectory_game(environment=setup_road_environment(length=arena_length),
                                 N=n_players)
    return MaskedGameRunner.create(game, N=n_players, horizon=horizon, options=options,
                                   device=device)


def _closed_loop(runner: MaskedGameRunner, init, goals, steps):
    """Closed-loop rollout re-planning every step, warm-started from the
    last SOLVED step: ((steps + 1, n, 4) states, (steps, n, 2) controls)."""
    states, controls = [np.asarray(init)], []
    goals_t = torch.as_tensor(np.asarray(goals)).to(device=runner.device,
                                                    dtype=torch.float32)[None]
    ones = torch.ones((1, runner.N), dtype=torch.float32, device=runner.device)
    x0 = y0 = None
    for _ in range(steps):
        cur = torch.as_tensor(states[-1]).to(device=runner.device, dtype=torch.float32)[None]
        nxt, ctrl, bs = runner.step_closed_loop(cur, goals_t, ones, x0=x0, y0=y0)
        if int(bs.result.status[0]) == SOLVED:
            x0, y0 = bs.result.x, bs.result.y
        states.append(nxt[0].cpu().numpy())
        controls.append(ctrl[0].cpu().numpy())
    return np.stack(states), np.stack(controls)


def solve_subgames(
    initial_states: np.ndarray,  # (N, 4)
    goals: np.ndarray,  # (N, 2)
    mask: np.ndarray,  # (N,) binary; ego convention: mask[0] == 1
    *,
    horizon: int = 3,
    num_sim_steps: int = 10,
    arena_length: float = 7.0,
    device="cuda",
    options: Optional[SolverOptions] = None,
) -> dict:
    """Decompose and solve: the selected players in one joint game, each
    unselected player alone, each a closed loop of ``num_sim_steps`` steps
    on ``device`` (default ``"cuda"``, which raises without a GPU) with the
    runner's default options unless ``options`` are given. Returns the
    reference's per-player dict ("Player i Initial State", "Goal",
    "Trajectory", "Control") and "Mask"."""
    device = str(resolve_device(device))
    mask = np.asarray(mask).astype(int)
    results = {}

    def store(player_id, states, controls, sub_index):
        results[f"Player {player_id + 1} Initial State"] = initial_states[player_id].tolist()
        results[f"Player {player_id + 1} Goal"] = goals[player_id].tolist()
        results[f"Player {player_id + 1} Trajectory"] = states[:, sub_index, :].tolist()
        results[f"Player {player_id + 1} Control"] = controls[:, sub_index, :].tolist()

    selected = np.flatnonzero(mask == 1)
    unselected = np.flatnonzero(mask == 0)

    # A true one-player game for each unselected player (the reference wraps
    # the solo player in a two-player game with a dummy second player).
    if len(unselected):
        solo = _cached_runner(1, horizon, arena_length, device, options)
        for i in unselected:
            states, controls = _closed_loop(solo, initial_states[i : i + 1],
                                            goals[i : i + 1], num_sim_steps)
            store(int(i), states, controls, 0)

    if len(selected):
        sub = _cached_runner(int(len(selected)), horizon, arena_length, device, options)
        states, controls = _closed_loop(sub, initial_states[selected], goals[selected],
                                        num_sim_steps)
        for sub_index, i in enumerate(selected):
            store(int(i), states, controls, sub_index)

    results["Mask"] = mask.tolist()
    return results
