"""Real-pedestrian-data evaluation (the JAX package's
``selection/real_data.py``; the reference's examples/test_real_data.jl):
evaluate selection modes on recorded scenarios with the dataset-fitted game
bounds. A scenario CSV has one row per player with columns x, y, vx, vy,
goal_x, goal_y and an optional sim_steps (the recording's length; each
scenario's closed loop is trimmed to it).
"""

from __future__ import annotations

import csv
import functools
import os
from typing import Optional, Sequence

import numpy as np

from .._device import resolve_device
from ..solver import SolverOptions
from .data import Scenario
from .evaluate import evaluate_modes
from .games import setup_real_environment, setup_real_game
from .model import MaskMLP
from .runner import MaskedGameRunner

# Reference real-data environment extent (train_and_test_utils.jl:435-438
# state bounds give the dataset's spatial range).
REAL_BOUNDS = {"xmin": 18.5, "xmax": 26.0, "ymin": 2.0, "ymax": 23.5}


def load_scenario_csv(path: str, *, num_players: Optional[int] = None) -> Scenario:
    """Load one scenario CSV (columns: x, y, vx, vy, goal_x, goal_y; one row
    per player; an optional ``sim_steps`` column carries the recording's
    duration — the reference keeps these out-of-band in a hardcoded
    time_dict, test_real_data.jl:135)."""
    rows = []
    sim_steps = None
    with open(path) as f:
        for row in csv.DictReader(f):
            rows.append(
                (
                    float(row["x"]),
                    float(row["y"]),
                    float(row["vx"]),
                    float(row["vy"]),
                    float(row["goal_x"]),
                    float(row["goal_y"]),
                )
            )
            if "sim_steps" in row and row["sim_steps"]:
                sim_steps = int(row["sim_steps"])
    if num_players is not None:
        rows = rows[:num_players]
    arr = np.asarray(rows)
    return Scenario(
        initial_states=arr[:, :4], goals=arr[:, 4:6], sim_steps=sim_steps
    )


def convert_recording(
    positions: np.ndarray, *, dt: float = 0.1, num_players: Optional[int] = None
) -> Scenario:
    """Convert one raw pedestrian recording — positions (steps, N, 2) per
    frame per agent — into a scenario: initial state = first-frame position
    + finite-difference velocity, goal = last-frame position, sim_steps =
    recording length (the reference derives its scenario CSVs + time_dict
    from such recordings the same way; test_real_data.jl:135-145)."""
    p = np.asarray(positions, dtype=np.float64)
    if p.ndim != 3 or p.shape[2] != 2 or p.shape[0] < 2:
        raise ValueError("positions must be (steps >= 2, N, 2)")
    if num_players is not None:
        p = p[:, :num_players]
    v0 = (p[1] - p[0]) / dt
    initial_states = np.concatenate([p[0], v0], axis=1)  # (N, 4)
    return Scenario(
        initial_states=initial_states, goals=p[-1], sim_steps=int(p.shape[0])
    )


def convert_raw_csv(
    path: str,
    out_path: Optional[str] = None,
    *,
    dt: float = 0.1,
    num_players: Optional[int] = None,
) -> Scenario:
    """Convert a raw trajectory CSV with columns ``frame, agent_id, x, y``
    (the common pedestrian-dataset layout, e.g. ETH/UCY exports) into the
    scenario schema; agents are kept only if present in every frame. When
    ``out_path`` is given, the converted scenario CSV (with its sim_steps
    column) is written there."""
    frames: dict[int, dict[int, tuple[float, float]]] = {}
    with open(path) as f:
        for row in csv.DictReader(f):
            frame = int(float(row["frame"]))
            agent = int(float(row["agent_id"]))
            frames.setdefault(frame, {})[agent] = (float(row["x"]), float(row["y"]))
    frame_ids = sorted(frames)
    if len(frame_ids) < 2:
        raise ValueError(f"{path}: need at least 2 frames")
    agents = sorted(set.intersection(*(set(frames[f]) for f in frame_ids)))
    if not agents:
        raise ValueError(f"{path}: no agent is present in every frame")
    positions = np.asarray(
        [[frames[f][a] for a in agents] for f in frame_ids]
    )  # (steps, N, 2)
    scenario = convert_recording(positions, dt=dt, num_players=num_players)
    if out_path is not None:
        save_scenario_csv(scenario, out_path)
    return scenario


def save_scenario_csv(scenario: Scenario, path: str) -> None:
    """Write a scenario in the reference CSV schema (+ sim_steps)."""
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["x", "y", "vx", "vy", "goal_x", "goal_y", "sim_steps"])
        for state, goal in zip(scenario.initial_states, scenario.goals):
            writer.writerow(
                [f"{v:.6g}" for v in (*state, *goal)]
                + [scenario.sim_steps if scenario.sim_steps else ""]
            )


def load_scenario_dir(directory: str, *, num_players: Optional[int] = None) -> list[Scenario]:
    out = []
    for name in sorted(os.listdir(directory)):
        if name.endswith(".csv"):
            out.append(
                load_scenario_csv(os.path.join(directory, name), num_players=num_players)
            )
    return out


@functools.lru_cache(maxsize=None)
def _real_runner(N, horizon, bounds, trivial_coupling, device, options):
    env = setup_real_environment(**dict(bounds))
    game = setup_real_game(environment=env, N=N, trivial_coupling=trivial_coupling)
    return MaskedGameRunner.create(game, N=N, horizon=horizon, options=options, device=device)


def make_real_runner(
    *, N: int, horizon: int = 30, bounds: dict = REAL_BOUNDS,
    trivial_coupling: bool = True, device="cuda", options: Optional[SolverOptions] = None,
) -> MaskedGameRunner:
    """The real-data game's runner on ``device`` (default ``"cuda"``, which
    raises without a GPU), built once per (N, horizon, bounds, coupling,
    device, options)."""
    return _real_runner(N, horizon, tuple(sorted(bounds.items())), trivial_coupling,
                        str(resolve_device(device)), options)


def evaluate_real_scenarios(
    scenarios: Sequence[Scenario],
    modes_and_parameters: dict,
    out_dir: str,
    *,
    N: int,
    horizon: int = 30,
    num_sim_steps: int = 50,
    model: Optional[MaskMLP] = None,
    input_horizon: int = 10,
    scenario_offset: int = 0,
    verbose: bool = True,
    device="cuda",
    options: Optional[SolverOptions] = None,
) -> None:
    """Evaluation sweep on real scenarios with the real game's dynamics and
    bounds (test_real_data.jl:135-209), on ``make_real_runner(N=N,
    horizon=horizon, device=device, options=options)``. Scenarios carrying
    their own ``sim_steps`` are trimmed to that length; outputs are named
    trajectories_[sid]_[mode]_[param].json as in the reference
    (test_real_data.jl:203)."""
    runner = make_real_runner(N=N, horizon=horizon, device=device, options=options)
    evaluate_modes(
        runner,
        scenarios,
        modes_and_parameters,
        out_dir,
        num_sim_steps=num_sim_steps,
        model=model,
        input_horizon=input_horizon,
        scenario_offset=scenario_offset,
        verbose=verbose,
        file_prefix="trajectories",
    )
