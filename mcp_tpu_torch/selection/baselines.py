"""Heuristic player-selection baselines (a copy of the JAX package's
``selection/baselines.py``, which is numpy only).

Mirror of the reference's ``mask_computation``
(examples/test_receding_horizon.jl:21-203): 10 selection modes producing a
binary mask over the N-1 non-ego players. Host-side numpy — these run once
per MPC step on tiny vectors; the solver stays on device.

Faithful quirks preserved (noted inline): rank-based modes select
``mode_parameter - 1`` players (the reference's ``1:mode_parameter-1`` loop),
and NN modes bootstrap from a heuristic for the first 10 sim steps.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

MODES = (
    "All",
    "Distance Threshold",
    "Nearest Neighbor",
    "Neural Network Threshold",
    "Neural Network Partial Threshold",
    "Neural Network Rank",
    "Neural Network Partial Rank",
    "Jacobian",
    "Hessian",
    "Cost Evolution",
    "Barrier Function",
    "Control Barrier Function",
)

# Default per-mode parameter tables (train_and_test_utils.jl:656-725).
MODE_PARAMETERS_N4 = {
    "Nearest Neighbor": [2, 3],
    "Distance Threshold": [1.5, 2, 2.5],
    "Jacobian": [2, 3],
    "Hessian": [2, 3],
    "Cost Evolution": [2, 3],
    "Barrier Function": [2, 3],
    "Control Barrier Function": [2, 3],
    "Neural Network Threshold": [0.1, 0.3, 0.5],
    "Neural Network Rank": [2, 3],
    "Neural Network Partial Threshold": [0.1, 0.3, 0.5],
    "Neural Network Partial Rank": [2, 3],
    "All": [1],
}
MODE_PARAMETERS_N10 = {
    "Nearest Neighbor": [5],
    "Distance Threshold": [2.5],
    "Jacobian": [5],
    "Hessian": [5],
    "Cost Evolution": [5],
    "Barrier Function": [5],
    "Control Barrier Function": [3, 5, 7],
    "Neural Network Threshold": [0.5],
    "Neural Network Rank": [5],
    "Neural Network Partial Threshold": [0.5],
    "Neural Network Partial Rank": [5],
    "All": [1],
}


def _model_scores(model, input_traj) -> np.ndarray:
    """Run the NN mask model with an informative error on input-size
    mismatch: "Partial" modes feed positions-only histories
    (input_state_dim=2), non-partial modes feed full states (4) — the model
    must have been trained with the matching input_state_dim (the reference
    has the same constraint: its real-data eval uses only Partial modes,
    test_real_data.jl)."""
    x = np.asarray(input_traj)
    try:
        return np.asarray(model(x))
    except Exception as e:
        raise ValueError(
            f"NN mask model failed on input of length {x.size}. Partial "
            f"modes feed input_state_dim=2 histories, non-Partial modes "
            f"feed full 4-dim states; select the mode family matching the "
            f"trained model's input size."
        ) from e


def _top_k_mask(scores: np.ndarray, k: int, *, largest: bool) -> np.ndarray:
    """Binary mask selecting the reference's `1:mode_parameter-1` top entries
    — i.e. k-1 players (test_receding_horizon.jl:63-65 et al.)."""
    mask = np.zeros(len(scores))
    order = np.argsort(scores)
    if largest:
        order = order[::-1]
    mask[order[: max(0, k - 1)]] = 1.0
    return mask


def mask_computation(
    input_traj: Optional[np.ndarray],
    trajectory: Sequence[np.ndarray],
    control: Sequence[np.ndarray],
    mode: str,
    sim_step: int,
    mode_parameter: float,
    *,
    model: Optional[Callable[[np.ndarray], np.ndarray]] = None,
) -> np.ndarray:
    """Compute the (N-1,) ego mask for one MPC step.

    Args:
      input_traj: flattened history fed to the NN (or None before step 11).
      trajectory: per-player state histories; trajectory[i] is a flat vector
        whose last 4 entries are player i's latest state [px, py, vx, vy]
        (the reference's Dict of growing flat vectors).
      control: per-player latest control vectors (index 0 = ego).
      mode: one of MODES; sim_step is 1-based as in the reference.
      model: callable giving NN mask scores; required for NN modes past the
        bootstrap phase.
    """
    N = len(trajectory)

    def latest(i):
        return np.asarray(trajectory[i])[-4:]

    if mode == "All":
        return np.ones(N - 1)

    if mode in ("Neural Network Threshold", "Neural Network Partial Threshold"):
        # First 10 steps bootstrap with Distance Threshold(2)
        # (test_receding_horizon.jl:25-45).
        if sim_step <= 10:
            return mask_computation(
                input_traj, trajectory, control, "Distance Threshold", sim_step, 2
            )
        scores = _model_scores(model, input_traj)
        return (scores > mode_parameter).astype(float)

    if mode in ("Neural Network Rank", "Neural Network Partial Rank"):
        if sim_step <= 10:
            return mask_computation(
                input_traj, trajectory, control, "Nearest Neighbor", sim_step, mode_parameter
            )
        scores = _model_scores(model, input_traj)
        return _top_k_mask(scores, int(mode_parameter), largest=True)

    if mode == "Distance Threshold":
        mask = np.zeros(N - 1)
        for j in range(1, N):
            d = np.linalg.norm(latest(0)[:2] - latest(j)[:2])
            mask[j - 1] = 1.0 if d <= mode_parameter else 0.0
        return mask

    if mode == "Nearest Neighbor":
        d = np.array([np.linalg.norm(latest(0)[:2] - latest(j)[:2]) for j in range(1, N)])
        return _top_k_mask(d, int(mode_parameter), largest=False)

    if mode == "Jacobian":
        # ‖∂l_col/∂uⱼ‖ of the 1/D collision cost after one Euler step
        # (test_receding_horizon.jl:89-111).
        if sim_step == 1:
            return mask_computation(
                input_traj, trajectory, control, "Nearest Neighbor", sim_step, mode_parameter
            )
        dt = 0.1
        scores = np.zeros(N - 1)
        for j in range(1, N):
            s = latest(0) - latest(j)
            dpx = (s[0] + dt * s[2]) ** 2
            dpy = (s[1] + dt * s[3]) ** 2
            uj = np.asarray(control[j]) if len(control) > j else np.zeros(2)
            dvx = (s[2] + dt * uj[0]) ** 2
            dvy = (s[3] + dt * uj[1]) ** 2
            D = dpx + dpy + dvx + dvy
            J1 = 1.0 / D**2 * 2.0 * dvx * dt
            J2 = 1.0 / D**2 * 2.0 * dvy * dt
            scores[j - 1] = np.hypot(J1, J2)
        return _top_k_mask(scores, int(mode_parameter), largest=True)

    if mode == "Hessian":
        # Frobenius norm of ∂²l_col/∂uⱼ² (test_receding_horizon.jl:112-135).
        if sim_step == 1:
            return mask_computation(
                input_traj, trajectory, control, "Nearest Neighbor", sim_step, mode_parameter
            )
        dt = 0.1
        scores = np.zeros(N - 1)
        for j in range(1, N):
            s = latest(0) - latest(j)
            dpx = (s[0] + dt * s[2]) ** 2
            dpy = (s[1] + dt * s[3]) ** 2
            uj = np.asarray(control[j]) if len(control) > j else np.zeros(2)
            dvx = (s[2] + dt * uj[0]) ** 2
            dvy = (s[3] + dt * uj[1]) ** 2
            D = dpx + dpy + dvx + dvy
            H11 = 2 * dt**2 / D**3 * (4 * dvx**2 - D)
            H12 = 8 * dt**2 / D**3 * dvx * dvy
            H22 = 2 * dt**2 / D**3 * (4 * dvy**2 - D)
            scores[j - 1] = np.linalg.norm(np.array([[H11, H12], [H12, H22]]))
        return _top_k_mask(scores, int(mode_parameter), largest=True)

    if mode == "Cost Evolution":
        # Δ(μ/d²) between consecutive steps (test_receding_horizon.jl:136-157).
        if sim_step == 1:
            return mask_computation(
                input_traj, trajectory, control, "Nearest Neighbor", sim_step, mode_parameter
            )
        mu = 1.0
        scores = np.zeros(N - 1)
        for j in range(1, N):
            tr0, trj = np.asarray(trajectory[0]), np.asarray(trajectory[j])
            D = np.sum((tr0[-4:-2] - trj[-4:-2]) ** 2)
            D_prev = np.sum((tr0[-8:-6] - trj[-8:-6]) ** 2)
            scores[j - 1] = mu / D - mu / D_prev
        return _top_k_mask(scores, int(mode_parameter), largest=True)

    if mode == "Barrier Function":
        # ḣ + κh with h = d² - R² (test_receding_horizon.jl:158-174);
        # small value = imminent danger → selected.
        R, kappa = 0.5, 5.0
        scores = np.zeros(N - 1)
        for j in range(1, N):
            dp = latest(0)[:2] - latest(j)[:2]
            dv = latest(0)[2:] - latest(j)[2:]
            h = np.sum(dp**2) - R**2
            h_dot = 2.0 * dp @ dv
            scores[j - 1] = h_dot + kappa * h
        return _top_k_mask(-scores, int(mode_parameter), largest=True)

    if mode == "Control Barrier Function":
        # ḧ + 2κḣ + κ²h (test_receding_horizon.jl:175-197).
        if sim_step == 1:
            return mask_computation(
                input_traj, trajectory, control, "Nearest Neighbor", sim_step, mode_parameter
            )
        R, kappa = 0.5, 5.0
        scores = np.zeros(N - 1)
        u0 = np.asarray(control[0]) if len(control) > 0 else np.zeros(2)
        for j in range(1, N):
            dp = latest(0)[:2] - latest(j)[:2]
            dv = latest(0)[2:] - latest(j)[2:]
            uj = np.asarray(control[j]) if len(control) > j else np.zeros(2)
            da = u0 - uj
            h = np.sum(dp**2) - R**2
            h_dot = 2.0 * dp @ dv
            h_ddot = 2.0 * (dv @ dv + dp @ da)
            scores[j - 1] = h_ddot + 2 * kappa * h_dot + kappa**2 * h
        return _top_k_mask(-scores, int(mode_parameter), largest=True)

    raise ValueError(f"Invalid mode: {mode}")


def masks_from_ground_truth_dump(
    path: str,
    *,
    ego_index: Optional[int] = None,
    threshold: float = 4.0,
    num_neighbors: int = 3,
):
    """Standalone mask probe over a saved ground-truth scenario dump — the
    port of the reference's one-off `examples/baseline.jl` driver (:1-62):
    load one simulation-results JSON, take the FIRST recorded step's
    positions, and compute (a) the distance-threshold mask (baseline.jl:21-34)
    and (b) the `num_neighbors`-nearest-neighbor mask (:36-58). Masks are
    full N-vectors with the ego entry always 1, as in the original (vs the
    (N-1)-sized ego masks of `mask_computation`). Reads this framework's
    dump schema (scripts/datagen.py: trajectories (N, T, 4), ego_index)
    rather than the reference's per-player JSON keys.
    """
    import json

    with open(path) as f:
        data = json.load(f)
    traj = np.asarray(data["trajectories"])  # (N, T, 4)
    N = traj.shape[0]
    ego = int(data.get("ego_index", 0)) if ego_index is None else int(ego_index)
    pos0 = traj[:, 0, :2]  # first sim step, as baseline.jl:14 ("only first")
    dists = np.linalg.norm(pos0 - pos0[ego], axis=1)

    dist_mask = np.zeros(N)
    dist_mask[ego] = 1.0
    dist_mask[(dists < threshold) & (np.arange(N) != ego)] = 1.0

    nn_mask = np.zeros(N)
    nn_mask[ego] = 1.0
    d = dists.copy()
    d[ego] = 0.0  # the original includes ego's zero distance in the top-k loop
    for _ in range(int(num_neighbors)):
        j = int(np.argmin(d))
        nn_mask[j] = 1.0
        d[j] = np.inf
    return {"distance_threshold": dist_mask, "nearest_neighbors": nn_mask}
