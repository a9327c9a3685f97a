"""Closed-loop receding-horizon evaluation of selection strategies (the JAX
package's ``selection/evaluate.py``; the reference's
examples/test_receding_horizon.jl:217-289 and test_real_data.jl).

For each (mode, mode_parameter, scenario), a closed-loop simulation where
every step (a) computes the ego mask from the current histories with the
selected heuristic or the trained MLP (host numpy, ``baselines.py``), (b)
re-solves the masked game on the runner's device, warm-started from the
scenario's last SOLVED step, and (c) advances to the plan's next state; one
JSON per scenario holds the trajectories, controls, masks and statuses.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..types import SOLVED
from .baselines import mask_computation
from .data import Scenario
from .model import MaskMLP
from .runner import MaskedGameRunner


def model_callable(model: Optional[MaskMLP]) -> Optional[Callable[[np.ndarray], np.ndarray]]:
    """The MLP as the numpy → numpy scorer ``mask_computation`` takes: the
    history is cast to the model's dtype and device, the scores come back
    as a numpy array."""
    if model is None:
        return None
    p = next(model.parameters())

    def scores(x: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            return model(torch.as_tensor(np.asarray(x)).to(device=p.device, dtype=p.dtype)
                         ).cpu().numpy()

    return scores


def _step_mask(history, controls, mode, sim_step, mode_parameter, model, input_horizon, N):
    """The (N,) mask [1; ego mask] of one sim step from a scenario's state
    history (list of (N, 4)) and applied controls (list of (N, 2)). The
    histories are the reference's flat vectors: the last ``input_horizon``
    states per player; "Partial" modes feed the MLP positions only, the
    others full states."""
    isd = 2 if "Partial" in mode else 4
    window = history[-input_horizon:]
    trajectory = [np.concatenate([step[i] for step in window]) for i in range(N)]
    input_traj = None
    if sim_step > 10:
        input_traj = np.concatenate(
            [np.concatenate([step[i][:isd] for step in window]) for i in range(N)])
    latest_control = [controls[-1][i] for i in range(N)] if controls else []
    mask = mask_computation(input_traj, trajectory, latest_control, mode, sim_step,
                            mode_parameter, model=model)
    return np.concatenate([[1.0], mask])


def _result(scenario: Scenario, history, controls, masks, statuses, N) -> dict:
    result = {}
    for i in range(N):
        result[f"Player {i + 1} Trajectory"] = [h[i].tolist() for h in history]
        result[f"Player {i + 1} Control"] = [c[i].tolist() for c in controls]
        result[f"Player {i + 1} Initial State"] = np.asarray(scenario.initial_states[i]).tolist()
        result[f"Player {i + 1} Goal"] = np.asarray(scenario.goals[i]).tolist()
    result["Player 1 Mask"] = [m.tolist() for m in masks]
    result["Statuses"] = statuses
    return result


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a)).to(device=device, dtype=torch.float32)


def evaluate_scenario(
    runner: MaskedGameRunner,
    scenario: Scenario,
    mode: str,
    mode_parameter: float,
    *,
    num_sim_steps: int = 50,
    model: Optional[MaskMLP] = None,
    input_horizon: int = 10,
    ego_index: int = 0,
) -> dict:
    """Closed-loop rollout of one scenario under one selection mode, one
    batch-1 solve per sim step, warm-started from the last SOLVED step.

    Returns the reference's receding_horizon_result dict: per-player
    trajectories (num_sim_steps + 1 states) and controls, the ego mask
    sequence ("Player 1 Mask"), initial states, goals and "Statuses"."""
    N, device = runner.N, runner.device
    scorer = model_callable(model)
    states = np.asarray(scenario.initial_states, dtype=np.float64)  # (N, 4)
    goals = _f32(scenario.goals, device)[None]
    history, controls, masks, statuses = [states.copy()], [], [], []
    last = None

    for sim_step in range(1, num_sim_steps + 1):
        full_mask = _step_mask(history, controls, mode, sim_step, mode_parameter, scorer,
                               input_horizon, N)
        masks.append(full_mask.copy())
        mask_t = _f32(full_mask, device)[None]
        next_states, applied, bs = runner.step_closed_loop(
            _f32(states, device)[None], goals, mask_t,
            mask_rows=runner.ego_masked_mask_rows(mask_t, ego_index=ego_index),
            x0=None if last is None else last.x,
            y0=None if last is None else last.y,
        )
        status = int(bs.result.status[0])
        if status == SOLVED:
            last = bs.result
        statuses.append(status)
        states = next_states[0].cpu().numpy().astype(np.float64)
        controls.append(applied[0].cpu().numpy().astype(np.float64))
        history.append(states.copy())

    return _result(scenario, history, controls, masks, statuses, N)


def evaluate_scenarios_batched(
    runner: MaskedGameRunner,
    scenarios: Sequence[Scenario],
    mode: str,
    mode_parameter: float,
    *,
    num_sim_steps: int = 50,
    model: Optional[MaskMLP] = None,
    input_horizon: int = 10,
    ego_index: int = 0,
) -> list[dict]:
    """Closed-loop rollout of many scenarios under one selection mode, each
    sim step one batched solve over every scenario.

    The masks are computed per scenario on the host as in
    ``evaluate_scenario``; each row warm-starts from its own last SOLVED
    solution (a row with none starts cold: the zero-input rollout and
    y0 = 1); a scenario with its own ``sim_steps`` stops recording at that
    length (finished rows ride along with their last mask and their solves
    are discarded). Returns one result dict per scenario, the schema of
    ``evaluate_scenario``."""
    N, B, device = runner.N, len(scenarios), runner.device
    scorer = model_callable(model)
    lengths = [s.sim_steps if getattr(s, "sim_steps", None) else num_sim_steps
               for s in scenarios]

    states = np.stack([np.asarray(s.initial_states, dtype=np.float64) for s in scenarios])
    goals = _f32(np.stack([np.asarray(s.goals) for s in scenarios]), device)
    histories = [[states[b].copy()] for b in range(B)]
    controls: list[list[np.ndarray]] = [[] for _ in range(B)]
    masks_hist: list[list[np.ndarray]] = [[] for _ in range(B)]
    statuses: list[list[int]] = [[] for _ in range(B)]

    warm_x = warm_y = None
    has_warm = torch.zeros((B, 1), dtype=torch.bool, device=device)

    for sim_step in range(1, max(lengths) + 1):
        masks = np.ones((B, N))
        for b in range(B):
            if sim_step > lengths[b]:
                continue
            masks[b] = _step_mask(histories[b], controls[b], mode, sim_step, mode_parameter,
                                  scorer, input_horizon, N)
            masks_hist[b].append(masks[b].copy())

        init = _f32(states, device)
        masks_t = _f32(masks, device)
        cold = runner.cold_starts(init)
        if warm_x is None:
            x0, y0 = cold, None
        else:
            x0 = torch.where(has_warm, warm_x, cold)
            y0 = torch.where(has_warm, warm_y, torch.ones_like(warm_y))
        next_states, applied, bs = runner.step_closed_loop(
            init, goals, masks_t,
            mask_rows=runner.ego_masked_mask_rows(masks_t, ego_index=ego_index), x0=x0, y0=y0,
        )
        ok = (bs.result.status == SOLVED)[:, None]
        if warm_x is None:
            warm_x = torch.where(ok, bs.result.x, torch.zeros_like(bs.result.x))
            warm_y = torch.where(ok, bs.result.y, torch.ones_like(bs.result.y))
        else:
            warm_x = torch.where(ok, bs.result.x, warm_x)
            warm_y = torch.where(ok, bs.result.y, warm_y)
        has_warm |= ok

        status_np = bs.result.status.cpu().numpy()
        next_np = next_states.cpu().numpy().astype(np.float64)
        ctrl_np = applied.cpu().numpy().astype(np.float64)
        for b in range(B):
            if sim_step > lengths[b]:
                continue
            statuses[b].append(int(status_np[b]))
            states[b] = next_np[b]
            controls[b].append(ctrl_np[b])
            histories[b].append(states[b].copy())

    return [_result(s, histories[b], controls[b], masks_hist[b], statuses[b], N)
            for b, s in enumerate(scenarios)]


def evaluate_modes(
    runner: MaskedGameRunner,
    scenarios: Sequence[Scenario],
    modes_and_parameters: dict,
    out_dir: str,
    *,
    num_sim_steps: int = 50,
    model: Optional[MaskMLP] = None,
    input_horizon: int = 10,
    scenario_offset: int = 0,
    verbose: bool = True,
    file_prefix: str = "receding_horizon_trajectories",
    batch_scenarios: bool = True,
) -> None:
    """Evaluation sweep over modes × parameters × scenarios, one JSON per
    combination, ``{file_prefix}_[{sid}]_[{mode}]_[{param}].json`` with sid =
    scenario_offset + index. With ``batch_scenarios`` (default) each (mode,
    parameter)'s scenarios roll out together (``evaluate_scenarios_batched``);
    False runs them one by one (``evaluate_scenario``, each for its own
    ``sim_steps`` where it has one)."""
    os.makedirs(out_dir, exist_ok=True)
    for mode, params in modes_and_parameters.items():
        for mode_parameter in params:
            if batch_scenarios:
                if verbose:
                    print(f"mode={mode} param={mode_parameter} "
                          f"scenarios=0..{len(scenarios) - 1} (batched)")
                results = evaluate_scenarios_batched(
                    runner, scenarios, mode, mode_parameter, num_sim_steps=num_sim_steps,
                    model=model, input_horizon=input_horizon)
            else:
                results = []
                for k, scenario in enumerate(scenarios):
                    steps = (scenario.sim_steps if getattr(scenario, "sim_steps", None)
                             else num_sim_steps)
                    if verbose:
                        print(f"mode={mode} param={mode_parameter} "
                              f"scenario={scenario_offset + k} steps={steps}")
                    results.append(evaluate_scenario(
                        runner, scenario, mode, mode_parameter, num_sim_steps=steps,
                        model=model, input_horizon=input_horizon))
            for k, result in enumerate(results):
                path = os.path.join(
                    out_dir,
                    f"{file_prefix}_[{scenario_offset + k}]_[{mode}]_[{mode_parameter}].json")
                with open(path, "w") as f:
                    json.dump(result, f)
