"""Radar charts, paper figures, runtime-scaling plots and loss-curve plots
(the JAX package's ``analysis/plots.py``; the reference's visualization
suite: scripts/radar_plot_{4,10,ped}.py, scripts/paper_vis.py,
scripts/time_plot.py, examples/loss_visualize.py).

numpy only. matplotlib (Agg backend: figures are written to files, never
shown) is imported inside the functions that draw, so that the package
imports where matplotlib is not installed; a call that draws then raises
ImportError. The presets, the metric aggregation (``collect_mode_metrics``)
and the radius map need no matplotlib.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Mapping, Optional, Sequence

import numpy as np


def _pyplot():
    """matplotlib's pyplot on the Agg backend; ImportError naming
    matplotlib where it is not installed."""
    try:
        import matplotlib
    except ImportError as exc:
        raise ImportError("mcp_tpu_torch.analysis draws its figures with matplotlib, "
                          "which is not installed") from exc
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def radar_plot(
    metrics_by_mode: Mapping[str, Mapping[str, float]],
    out_path: str,
    *,
    metric_names: Optional[Sequence[str]] = None,
    title: str = "Selection-mode comparison",
) -> None:
    """Radar chart over modes with per-axis min/max normalization
    (radar_plot_10.py:99-165: each metric axis is scaled to its min..max
    range across modes)."""
    plt = _pyplot()
    modes = list(metrics_by_mode)
    if metric_names is None:
        metric_names = list(next(iter(metrics_by_mode.values())))
    K = len(metric_names)
    values = np.array(
        [[metrics_by_mode[m][k] for k in metric_names] for m in modes]
    )  # (modes, K)
    lo, hi = values.min(axis=0), values.max(axis=0)
    span = np.where(hi > lo, hi - lo, 1.0)
    normalized = (values - lo) / span

    angles = np.linspace(0, 2 * np.pi, K, endpoint=False)
    fig, ax = plt.subplots(figsize=(8, 8), subplot_kw={"projection": "polar"})
    for mode, row in zip(modes, normalized):
        closed = np.concatenate([row, row[:1]])
        ax.plot(np.concatenate([angles, angles[:1]]), closed, label=mode)
        ax.fill(np.concatenate([angles, angles[:1]]), closed, alpha=0.08)
    ax.set_xticks(angles)
    ax.set_xticklabels(metric_names)
    ax.set_title(title)
    ax.legend(loc="upper right", bbox_to_anchor=(1.35, 1.1), fontsize=8)
    fig.savefig(out_path, bbox_inches="tight", dpi=150)
    plt.close(fig)


# ---------------------------------------------------------------------------
# Publication-grade radar charts with per-axis min/mean/max anchoring
# (scripts/radar_plot_10.py:168-212 and the per-dataset preset variants
# radar_plot_4.py / radar_plot_ped.py).

#: Metrics where smaller is better: their radius mapping is inverted so
#: "outward = better" holds on every axis (radar_plot_10.py:171).
RADAR_INVERT_METRICS = frozenset({"Smoothness", "Length", "Mask Sum"})

#: Radius of the dashed "mean" reference ring: values at the per-axis mean
#: map to 0.7, min→0 and max→1 piecewise-linearly (radar_plot_10.py:195-212).
RADAR_MEAN_RADIUS = 0.7


@dataclasses.dataclass(frozen=True)
class RadarPreset:
    """One dataset's radar configuration: which (mode, parameter) grid to
    aggregate, which method groups to draw per figure, and the hand-tuned
    per-axis tick anchors (the reference hardcodes these per dataset,
    radar_plot_10.py:184-193, radar_plot_4.py:165-174,
    radar_plot_ped.py:178-183)."""

    num_players: int
    file_prefix: str
    modes_with_params: Mapping[str, tuple]
    #: figure name -> the method keys drawn in that figure ("All [1]" always).
    option_groups: Mapping[str, frozenset]
    #: metric -> (min, max) override; the mean anchor stays data-derived.
    tick_overrides: Mapping[str, tuple]


_RANK_MODES = (
    "Neural Network Rank",
    "Neural Network Partial Rank",
    "Nearest Neighbor",
    "Jacobian",
    "Hessian",
    "Cost Evolution",
    "Barrier Function",
    "Control Barrier Function",
)


def _ranking_group(k: int, modes: Sequence[str] = _RANK_MODES) -> frozenset:
    return frozenset({f"{m} [{k}]" for m in modes} | {"All [1]"})


_THRESHOLD_GROUP_25 = frozenset(
    {
        "Neural Network Threshold [0.5]",
        "Neural Network Partial Threshold [0.5]",
        "Distance Threshold [2.5]",
        "All [1]",
    }
)

RADAR_PRESETS: dict[str, RadarPreset] = {
    # 10-player, 30-step synthetic dataset (radar_plot_10.py:42-62,184-193).
    "n10": RadarPreset(
        num_players=10,
        file_prefix="receding_horizon_trajectories",
        modes_with_params={
            "All": (1,),
            "Distance Threshold": (1.5, 2.0, 2.5),
            "Nearest Neighbor": (3, 5, 7),
            "Jacobian": (3, 5, 7),
            "Hessian": (3, 5, 7),
            "Cost Evolution": (3, 5, 7),
            "Barrier Function": (3, 5, 7),
            "Control Barrier Function": (3, 5, 7),
            "Neural Network Threshold": (0.1, 0.3, 0.5),
            "Neural Network Partial Threshold": (0.1, 0.3, 0.5),
            "Neural Network Rank": (3, 5, 7),
            "Neural Network Partial Rank": (3, 5, 7),
        },
        option_groups={
            "threshold": _THRESHOLD_GROUP_25,
            "ranking3": _ranking_group(3),
            "ranking5": _ranking_group(5),
            "ranking7": _ranking_group(7),
        },
        tick_overrides={
            "Smoothness": (0.01, 0.04),
            "Length": (5.5, 6.5),
            "Safety": (0.5, 2.0),
            "Mask Sum": (1, 10),
            "Rate": (0, 1),
        },
    ),
    # 4-player dataset (radar_plot_4.py:42-58,165-174).
    "n4": RadarPreset(
        num_players=4,
        file_prefix="receding_horizon_trajectories",
        modes_with_params={
            "All": (1,),
            "Distance Threshold": (1.5, 2, 2.5),
            "Nearest Neighbor": (2, 3),
            "Jacobian": (2, 3),
            "Hessian": (2, 3),
            "Cost Evolution": (2, 3),
            "Barrier Function": (2, 3),
            "Control Barrier Function": (2, 3),
            "Neural Network Threshold": (0.1, 0.3, 0.5),
            "Neural Network Partial Threshold": (0.1, 0.3, 0.5),
            "Neural Network Rank": (2, 3),
            "Neural Network Partial Rank": (2, 3),
        },
        option_groups={
            "threshold": frozenset(
                {
                    "Neural Network Threshold [0.5]",
                    "Neural Network Partial Threshold [0.5]",
                    "Distance Threshold [2]",
                    "All [1]",
                }
            ),
            "ranking2": _ranking_group(2),
            "ranking3": _ranking_group(3),
        },
        tick_overrides={
            "Smoothness": (0.02, 0.08),
            "Length": (2, 2.6),
            "Safety": (0.5, 1.5),
            "Mask Sum": (1, 4),
            "Rate": (0, 1),
        },
    ),
    # Pedestrian real-data recordings (radar_plot_ped.py:42-53,178-183;
    # no Jacobian/Hessian/CBF modes, files named trajectories_[...]).
    "ped": RadarPreset(
        num_players=10,
        file_prefix="trajectories",
        modes_with_params={
            "All": (1,),
            "Distance Threshold": (1.5, 2.0, 2.5),
            "Nearest Neighbor": (3, 5, 7),
            "Cost Evolution": (3, 5, 7),
            "Barrier Function": (3, 5, 7),
            "Neural Network Threshold": (0.1, 0.3, 0.5),
            "Neural Network Partial Threshold": (0.1, 0.3, 0.5),
            "Neural Network Rank": (3, 5, 7),
        },
        option_groups={
            "threshold": _THRESHOLD_GROUP_25,
            "ranking5": _ranking_group(
                5,
                (
                    "Neural Network Rank",
                    "Neural Network Partial Rank",
                    "Nearest Neighbor",
                    "Cost Evolution",
                    "Barrier Function",
                ),
            ),
        },
        tick_overrides={
            "Smoothness": (0.001, 0.02),
            "Length": (11, 17),
            "Safety": (0.3, 1.5),
            "Mask Sum": (1, 10),
            "Rate": (0, 1),
        },
    ),
}


def collect_mode_metrics(
    result_dir: str,
    *,
    num_players: int,
    modes_with_params: Mapping[str, Sequence],
    scenario_ids: Optional[Sequence[int]] = None,
    file_prefix: str = "receding_horizon_trajectories",
) -> dict:
    """Aggregate per-(mode, parameter) metric means over a directory of
    closed-loop evaluation JSONs (radar_plot_10.py:124-166 collection loop).
    Missing files are skipped, as in the reference. When ``scenario_ids`` is
    None, every scenario id present for the mode is used."""
    from .metrics import analyze_result

    out: dict[str, dict[str, float]] = {}
    for mode, params in modes_with_params.items():
        for param in params:
            if scenario_ids is None:
                import glob
                import re

                pattern = os.path.join(
                    result_dir, f"{file_prefix}_[[]*[]]_[[]{mode}[]]_[[]{param}[]].json"
                )
                sids = sorted(
                    int(m.group(1))
                    for f in glob.glob(pattern)
                    for m in [re.search(r"_\[(\d+)\]_\[", os.path.basename(f))]
                    if m
                )
            else:
                sids = list(scenario_ids)
            rows = []
            for sid in sids:
                path = os.path.join(
                    result_dir, f"{file_prefix}_[{sid}]_[{mode}]_[{param}].json"
                )
                try:
                    with open(path) as f:
                        result = json.load(f)
                except FileNotFoundError:
                    continue
                rows.append(analyze_result(result, num_players=num_players))
            if rows:
                out[f"{mode} [{param}]"] = {
                    k: float(np.mean([r[k] for r in rows])) for k in rows[0]
                }
    return out


def _radius(value: float, ticks: Mapping[str, float], invert: bool) -> float:
    """Piecewise-linear raw→radius map: min→0, mean→0.7, max→1 (inverted
    axes flip min/max), exactly radar_plot_10.py:195-212."""
    lo, mid, hi = ticks["min"], ticks["mean"], ticks["max"]
    if invert:
        if value <= mid:
            return RADAR_MEAN_RADIUS + (1 - RADAR_MEAN_RADIUS) * (value - mid) / (
                lo - mid + 1e-6
            )
        return RADAR_MEAN_RADIUS * (value - hi) / (mid - hi + 1e-6)
    if value <= mid:
        return RADAR_MEAN_RADIUS * (value - lo) / (mid - lo + 1e-6)
    return RADAR_MEAN_RADIUS + (1 - RADAR_MEAN_RADIUS) * (value - mid) / (
        hi - mid + 1e-6
    )


def _legend_name(method: str, *, keep_parameter: bool) -> str:
    """Shortened legend labels (radar_plot_10.py:216-246): PSN-Full /
    PSN-Partial for the NN modes, Distance for the distance heuristics,
    BF/CBF abbreviations; ranking figures drop the parameter suffix."""
    param = method[method.index("[") :] if "[" in method else ""
    suffix = f" {param}" if keep_parameter else ""
    if "Neural Network Partial" in method:
        return "PSN-Partial" + suffix
    if "Neural Network" in method:
        return "PSN-Full" + suffix
    if "Distance Threshold" in method or "Nearest Neighbor" in method:
        return "Distance" + suffix
    if "Control Barrier Function" in method:
        return "CBF" + suffix
    if "Barrier Function" in method:
        return "BF" + suffix
    for name in ("Jacobian", "Hessian", "Cost Evolution"):
        if name in method:
            return name + suffix
    return method


def radar_plot_anchored(
    metrics_by_mode: Mapping[str, Mapping[str, float]],
    out_path: str,
    *,
    selected: Optional[Sequence[str]] = None,
    tick_overrides: Optional[Mapping[str, tuple]] = None,
    metric_names: Sequence[str] = ("Smoothness", "Length", "Safety", "Mask Sum", "Rate"),
    invert_metrics: frozenset = RADAR_INVERT_METRICS,
    keep_parameter_in_legend: bool = False,
    annotate_ticks: bool = True,
) -> dict:
    """Anchored radar chart: each axis maps raw metric values through its
    (min, mean, max) anchors — min/max from ``tick_overrides`` when given,
    otherwise from the data; the mean is always data-derived across ALL
    aggregated modes (radar_plot_10.py:173-193) — with the dashed mean ring
    at r=0.7 and the "All [1]" baseline in black. Returns the per-axis tick
    anchors actually used. ``annotate_ticks`` writes each axis's min/mean/max
    values along the axis (the reference prints them to the console; here
    they live on the figure)."""
    plt = _pyplot()
    ticks: dict[str, dict[str, float]] = {}
    for metric in metric_names:
        values = [m[metric] for m in metrics_by_mode.values()]
        ticks[metric] = {
            "min": float(min(values)),
            "mean": float(np.mean(values)),
            "max": float(max(values)),
        }
        if tick_overrides and metric in tick_overrides:
            lo, hi = tick_overrides[metric]
            ticks[metric]["min"] = float(lo)
            ticks[metric]["max"] = float(hi)

    K = len(metric_names)
    angles = np.linspace(0, 2 * np.pi, K, endpoint=False).tolist()
    angles += angles[:1]

    fig, ax = plt.subplots(figsize=(10, 10), subplot_kw={"projection": "polar"})
    ax.set_theta_offset(np.pi / 2)
    ax.set_theta_direction(-1)
    ax.set_xticks(angles[:-1])
    ax.set_xticklabels(metric_names, fontsize=18)
    ax.set_yticklabels([])
    ax.set_ylim(0, 1)
    ax.spines["polar"].set_visible(False)
    ax.plot(
        angles,
        [RADAR_MEAN_RADIUS] * (K + 1),
        linestyle="--",
        color="gray",
        linewidth=2,
        label="mean",
    )
    if annotate_ticks:
        for ang, metric in zip(angles[:-1], metric_names):
            t = ticks[metric]
            inv = metric in invert_metrics
            for radius, key in ((0.0, "min"), (RADAR_MEAN_RADIUS, "mean"), (1.0, "max")):
                value = t["max" if (inv and key == "min") else
                          "min" if (inv and key == "max") else key]
                ax.annotate(
                    f"{value:.3g}",
                    xy=(ang, radius),
                    fontsize=8,
                    color="dimgray",
                    ha="center",
                    va="bottom",
                )

    drawn = selected if selected is not None else list(metrics_by_mode)
    for method in metrics_by_mode:
        if method not in drawn:
            continue
        vals = [
            _radius(
                metrics_by_mode[method][metric],
                ticks[metric],
                metric in invert_metrics,
            )
            for metric in metric_names
        ]
        vals += vals[:1]
        if method == "All [1]":
            ax.plot(angles, vals, linewidth=2.5, color="black", label="All")
        else:
            label = _legend_name(method, keep_parameter=keep_parameter_in_legend)
            ax.plot(angles, vals, linewidth=3, label=label)
            ax.fill(angles, vals, alpha=0.07)

    ax.legend(loc="upper right", bbox_to_anchor=(1.05, 1.1), fontsize=14)
    fig.tight_layout()
    fig.savefig(out_path, bbox_inches="tight", dpi=150)
    plt.close(fig)
    return ticks


def radar_report(
    result_dir: str,
    out_dir: str,
    *,
    preset: str | RadarPreset = "n10",
    scenario_ids: Optional[Sequence[int]] = None,
    stem: str = "radar",
) -> dict:
    """One-call per-dataset radar suite: aggregate every (mode, parameter)
    JSON in ``result_dir`` and write one anchored radar per option group —
    the reference's per-dataset scripts (radar_plot_{10,4,ped}.py) as a
    single parameterized entry point. Returns {figure name: written path}."""
    p = RADAR_PRESETS[preset] if isinstance(preset, str) else preset
    metrics = collect_mode_metrics(
        result_dir,
        num_players=p.num_players,
        modes_with_params=p.modes_with_params,
        scenario_ids=scenario_ids,
        file_prefix=p.file_prefix,
    )
    if not metrics:
        raise FileNotFoundError(
            f"no evaluation JSONs matching the preset found in {result_dir}"
        )
    os.makedirs(out_dir, exist_ok=True)
    written = {}
    for option, group in p.option_groups.items():
        out_path = os.path.join(out_dir, f"{stem}_{option}.pdf")
        radar_plot_anchored(
            metrics,
            out_path,
            selected=[m for m in group if m in metrics],
            tick_overrides=p.tick_overrides,
            keep_parameter_in_legend=(option == "threshold"),
        )
        written[option] = out_path
    return written


# ---------------------------------------------------------------------------
# Paper trajectory grid (scripts/paper_vis.py:1-236): methods as rows,
# snapshot time steps as columns, segments colored by the ego's mask.

PAPER_COLOR_EGO = "#66B3FF"
PAPER_COLOR_ON = "#FF9999"
PAPER_COLOR_OFF = "#99FF99"


def _result_players(result: dict) -> list[int]:
    """1-based player ids present in an evaluation JSON (paper_vis.py:17-43
    skips players without an Initial State)."""
    pids = []
    pid = 1
    while f"Player {pid} Trajectory" in result:
        if result.get(f"Player {pid} Initial State"):
            pids.append(pid)
        pid += 1
    return pids


def paper_trajectory_grid(
    results: Sequence[dict],
    method_labels: Sequence[str],
    out_path: str,
    *,
    step_indices: Sequence[int] = (30, 50, 70, 90),
    time_labels: Optional[Sequence[str]] = None,
    step_dt: Optional[float] = None,
    padding: float = 0.5,
) -> None:
    """Publication trajectory-snapshot grid (paper_vis.py:60-236): one row
    per method result, one column per snapshot step; each player's history
    up to the snapshot is drawn segment-by-segment colored by whether the
    ego's mask included them at that step (blue ego / red included / green
    excluded), with shared square axis limits adapted to the union of all
    trajectories and a three-entry legend.

    ``results`` are loaded evaluation JSONs (evaluate.py output shape, the
    same schema as the reference's receding_horizon_trajectories files).
    ``time_labels`` overrides the bottom-row column captions; with
    ``step_dt`` they default to "t = step·dt s".
    """
    plt = _pyplot()
    n_rows, n_cols = len(results), len(step_indices)
    fig, axes = plt.subplots(
        n_rows,
        n_cols,
        figsize=(3.75 * n_cols, 4.5 * n_rows),
        sharex=True,
        sharey=True,
        squeeze=False,
    )

    # Shared adaptive square limits over every trajectory of every method
    # (paper_vis.py:74-98).
    pts = []
    for result in results:
        for pid in _result_players(result):
            pts.append(np.asarray(result[f"Player {pid} Trajectory"])[:, :2])
    allp = np.concatenate(pts, axis=0)
    center = (allp.min(axis=0) + allp.max(axis=0)) / 2.0
    half = float((allp.max(axis=0) - allp.min(axis=0)).max()) / 2.0 + padding
    x_lim = (center[0] - half, center[0] + half)
    y_lim = (center[1] - half, center[1] + half)

    if time_labels is None:
        time_labels = [
            (f"$t={step * step_dt:g}\\,\\mathrm{{s}}$" if step_dt else f"step {step}")
            for step in step_indices
        ]

    for row, (result, label) in enumerate(zip(results, method_labels)):
        masks = np.asarray(result["Player 1 Mask"])
        pids = _result_players(result)
        trajs = {
            pid: np.asarray(result[f"Player {pid} Trajectory"])[:, :2]
            for pid in pids
        }
        for col, step in enumerate(step_indices):
            ax = axes[row, col]
            for pid in pids:
                traj = trajs[pid]
                # Mask-colored history segments (paper_vis.py:171-188).
                upto = min(step, len(traj) - 1)
                for idx in range(upto):
                    on = idx < len(masks) and masks[idx][pid - 1] == 1
                    color = (
                        PAPER_COLOR_EGO
                        if pid == 1
                        else (PAPER_COLOR_ON if on else PAPER_COLOR_OFF)
                    )
                    ax.plot(
                        traj[idx : idx + 2, 0],
                        traj[idx : idx + 2, 1],
                        color=color,
                        linewidth=1.5,
                    )
                if step < len(traj):
                    on = step < len(masks) and masks[step][pid - 1] == 1
                    color = (
                        PAPER_COLOR_EGO
                        if pid == 1
                        else (PAPER_COLOR_ON if on else PAPER_COLOR_OFF)
                    )
                    ax.plot(
                        traj[step, 0], traj[step, 1], marker="o", color=color,
                        markersize=8,
                    )
            ax.set_xlim(x_lim)
            ax.set_ylim(y_lim)
            ax.set_aspect("equal", adjustable="box")
            ax.grid(False)
            if row == n_rows - 1 and col < len(time_labels):
                ax.annotate(
                    time_labels[col],
                    xy=(0.5, -0.15),
                    xycoords="axes fraction",
                    ha="center",
                    va="center",
                    fontsize=11,
                )
            if col == 0:
                ax.annotate(
                    label,
                    xy=(-0.1, 0.5),
                    xycoords="axes fraction",
                    ha="center",
                    va="center",
                    rotation=90,
                    fontsize=12,
                    fontweight="bold",
                )

    from matplotlib.lines import Line2D

    fig.legend(
        handles=[
            Line2D([], [], color=PAPER_COLOR_EGO, marker="o", markersize=8,
                   linewidth=2, label="Ego"),
            Line2D([], [], color=PAPER_COLOR_ON, marker="o", markersize=8,
                   linewidth=2, label="Included in Game"),
            Line2D([], [], color=PAPER_COLOR_OFF, marker="o", markersize=8,
                   linewidth=2, label="Excluded from Game"),
        ],
        loc="upper center",
        bbox_to_anchor=(0.5, 0.98),
        ncol=3,
        fontsize=12,
    )
    fig.subplots_adjust(hspace=0.05, wspace=0.05)
    fig.savefig(out_path, bbox_inches="tight", dpi=200)
    plt.close(fig)


def time_scaling_plot(
    player_counts: Sequence[int],
    step_times_s: Sequence[float],
    out_path: str,
    *,
    fit_cubic: bool = True,
) -> None:
    """Per-step runtime vs player count with an O(N³) fit overlay
    (scripts/time_plot.py:5-29)."""
    plt = _pyplot()
    n = np.asarray(player_counts, dtype=float)
    t = np.asarray(step_times_s, dtype=float)
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(n, t, "o-", label="measured")
    if fit_cubic and len(n) >= 2:
        c = float(np.mean(t / n**3))
        ax.plot(n, c * n**3, "--", label=f"O(N³)·{c:.2e}")
    ax.set_xlabel("number of players N")
    ax.set_ylabel("per-step solve time (s)")
    ax.legend()
    fig.savefig(out_path, bbox_inches="tight", dpi=150)
    plt.close(fig)


def loss_curves_plot(history: Mapping[str, Sequence[float]], out_path: str) -> None:
    """Train/val loss curves (examples/loss_visualize.py)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 4))
    for name, values in history.items():
        if values:
            ax.plot(values, label=name)
    ax.set_xlabel("epoch")
    ax.set_ylabel("loss")
    ax.legend()
    fig.savefig(out_path, bbox_inches="tight", dpi=150)
    plt.close(fig)


def loss_landscape_plot(
    grid_x: np.ndarray, grid_y: np.ndarray, losses: np.ndarray, out_path: str
) -> None:
    """2-D mask loss-landscape heatmap (examples/gradient_test.jl:7-55)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 5))
    im = ax.pcolormesh(grid_x, grid_y, losses, shading="auto")
    fig.colorbar(im, ax=ax, label="loss")
    ax.set_xlabel("mask component 1")
    ax.set_ylabel("mask component 2")
    fig.savefig(out_path, bbox_inches="tight", dpi=150)
    plt.close(fig)
