"""Evaluation metrics over closed-loop trajectories (a copy of the JAX
package's ``analysis/metrics.py``, which is numpy only).

Mirror of the reference's Python analysis metrics
(scripts/result_analysis.py:5-50, scripts/radar_plot_10.py:7-37): similarity
to a reference trajectory, smoothness (direction-change magnitude), path
length, min-inter-player-distance safety, mask sum, and the solve-rate proxy
rate = 1/(Σmask)³ per step.

Trajectories are (T, ≥2) arrays of ego states (positions in the first two
columns); per-player dicts map 1-based player ids to such arrays, matching
the evaluation JSON layout.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np


def trajectory_similarity(trajectory: np.ndarray, ref_trajectory: np.ndarray) -> float:
    """Mean per-step position distance (result_analysis.py:5-9)."""
    t = np.asarray(trajectory)[:, :2]
    r = np.asarray(ref_trajectory)[: len(t), :2]
    return float(np.round(np.mean(np.linalg.norm(t - r, axis=1)), 3))


def trajectory_smoothness(trajectory: np.ndarray) -> float:
    """Σ ‖unit-direction change‖ / T (result_analysis.py:11-21)."""
    p = np.asarray(trajectory)[:, :2]
    smooth = 0.0
    for i in range(1, len(p) - 1):
        v1, v2 = p[i] - p[i - 1], p[i + 1] - p[i]
        n1, n2 = np.linalg.norm(v1), np.linalg.norm(v2)
        if n1 == 0 or n2 == 0:
            continue
        smooth += float(np.linalg.norm(v2 / n2 - v1 / n1))
    return float(np.round(smooth / len(p), 3))


def trajectory_length(trajectory: np.ndarray) -> float:
    """Total path length (result_analysis.py:23-27)."""
    p = np.asarray(trajectory)[:, :2]
    return float(np.round(np.sum(np.linalg.norm(np.diff(p, axis=0), axis=1)), 3))


def safety(trajectories: Mapping[int, np.ndarray], *, ego: int = 1) -> float:
    """Min distance between the ego and any other player over the rollout
    (result_analysis.py:29-36)."""
    ego_p = np.asarray(trajectories[ego])[:, :2]
    dmin = np.inf
    for pid, traj in trajectories.items():
        if pid == ego:
            continue
        p = np.asarray(traj)[: len(ego_p), :2]
        dmin = min(dmin, float(np.min(np.linalg.norm(ego_p[: len(p)] - p, axis=1))))
    return float(np.round(dmin, 3))


def mask_sum(masks: Sequence[np.ndarray]) -> float:
    """Mean Σmask per step (result_analysis.py:38-40)."""
    return float(np.sum(masks) / len(masks))


def rate(masks: Sequence[np.ndarray]) -> float:
    """Mean 1/(Σmask)³ — the O(N³) solve-cost proxy
    (radar_plot_10.py:146,36-37)."""
    rates = [1.0 / (np.sum(m) ** 3) for m in masks]
    return float(np.mean(rates))


def analyze_result(result: dict, *, num_players: int, ref_result: dict | None = None) -> dict:
    """Compute the full metric set for one evaluation JSON
    (radar_plot_10.py:140-166)."""
    # Skip absent players (real-data scenarios carry fewer than the nominal
    # count; the reference's loaders do the same, paper_vis.py:17-43).
    trajectories = {
        pid: np.asarray(result[f"Player {pid} Trajectory"])
        for pid in range(1, num_players + 1)
        if f"Player {pid} Trajectory" in result
    }
    masks = [np.asarray(m) for m in result["Player 1 Mask"]]
    metrics = {
        "Smoothness": trajectory_smoothness(trajectories[1]),
        "Length": trajectory_length(trajectories[1]),
        "Safety": safety(trajectories),
        "Mask Sum": mask_sum(masks),
        "Rate": rate(masks),
    }
    if ref_result is not None:
        ref_traj = np.asarray(ref_result["Player 1 Trajectory"])
        metrics["Similarity"] = trajectory_similarity(trajectories[1], ref_traj)
    return metrics


def quantiles(array: Sequence[float]) -> tuple[float, float, float]:
    """Q1/median/Q3 (result_analysis.py:42-46)."""
    a = np.asarray(array)
    return (
        float(np.quantile(a, 0.25)),
        float(np.quantile(a, 0.5)),
        float(np.quantile(a, 0.75)),
    )
