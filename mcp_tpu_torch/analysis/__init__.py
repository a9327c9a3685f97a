"""Metrics, plots and stand-alone experiments (the JAX package's
``analysis/``: the reference's scripts/ analysis suite plus the time and
loss-landscape probes). The figures need matplotlib, imported only by the
functions that draw (``plots._pyplot``); everything else imports without
it."""

from .animate import animate_result
from .experiments import mask_loss_landscape, n_scaling_experiment
from .metrics import (
    analyze_result,
    mask_sum,
    quantiles,
    rate,
    safety,
    trajectory_length,
    trajectory_similarity,
    trajectory_smoothness,
)
from .plots import (
    RADAR_PRESETS,
    RadarPreset,
    collect_mode_metrics,
    loss_curves_plot,
    loss_landscape_plot,
    paper_trajectory_grid,
    radar_plot,
    radar_plot_anchored,
    radar_report,
    time_scaling_plot,
)

__all__ = [
    "RADAR_PRESETS",
    "RadarPreset",
    "collect_mode_metrics",
    "paper_trajectory_grid",
    "radar_plot_anchored",
    "radar_report",
    "animate_result",
    "mask_loss_landscape",
    "n_scaling_experiment",
    "analyze_result",
    "mask_sum",
    "quantiles",
    "rate",
    "safety",
    "trajectory_length",
    "trajectory_similarity",
    "trajectory_smoothness",
    "loss_curves_plot",
    "loss_landscape_plot",
    "radar_plot",
    "time_scaling_plot",
]
