"""Player-selection layer: the masked N-player games, their batched
runner, the mask-predictor MLP, the composite loss and the solver-in-the-loop
training step. The data layer, the training loop, baselines and evaluation
are not ported yet (ROADMAP Queue 1 item 4)."""

from .games import (
    build_masked_parametric_game,
    pack_masked_theta,
    setup_real_environment,
    setup_real_game,
    setup_road_environment,
    setup_trajectory_game,
)
from .loss import DEFAULT_WEIGHTS, clamp_cotangent, composite_loss
from .model import HIDDEN_SIZES, MaskMLP, input_size, prepare_input
from .runner import BatchSolution, MaskedGameRunner
from .train import TrainConfig, make_train_step

__all__ = [
    "build_masked_parametric_game",
    "pack_masked_theta",
    "setup_real_environment",
    "setup_real_game",
    "setup_road_environment",
    "setup_trajectory_game",
    "BatchSolution",
    "MaskedGameRunner",
    "DEFAULT_WEIGHTS",
    "clamp_cotangent",
    "composite_loss",
    "HIDDEN_SIZES",
    "MaskMLP",
    "input_size",
    "prepare_input",
    "TrainConfig",
    "make_train_step",
]
