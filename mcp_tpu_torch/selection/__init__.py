"""Player-selection layer: the masked N-player games and their batched
runner. The mask predictor, training, data, baselines and evaluation are
not ported yet (ROADMAP Queue 1 item 11)."""

from .games import (
    build_masked_parametric_game,
    pack_masked_theta,
    setup_real_environment,
    setup_real_game,
    setup_road_environment,
    setup_trajectory_game,
)
from .runner import BatchSolution, MaskedGameRunner

__all__ = [
    "build_masked_parametric_game",
    "pack_masked_theta",
    "setup_real_environment",
    "setup_real_game",
    "setup_road_environment",
    "setup_trajectory_game",
    "BatchSolution",
    "MaskedGameRunner",
]
