"""Metrics over closed-loop evaluation results (the JAX package's
``analysis/``). The plots, the animation and the stand-alone experiments
are not ported yet."""

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

__all__ = [
    "analyze_result",
    "mask_sum",
    "quantiles",
    "rate",
    "safety",
    "trajectory_length",
    "trajectory_similarity",
    "trajectory_smoothness",
]
