"""Player-selection research layer: masked N-player games, the mask-predictor
MLP, solver-in-the-loop training, heuristic baselines and closed-loop
evaluation (the JAX package's ``selection/``). The pipeline: scenarios
(``generate_scenarios``) → ground truth (``generate_ground_truth``) →
``train`` → the evaluation sweep (``evaluate_modes``), with the subgame
decomposition (``solve_subgames``) and the real-data sweep (``real_data``)
beside it. The JAX package's ``MLPParams``/``init_mlp``/``apply_mlp`` are
the ``MaskMLP`` module here."""

from .baselines import MODE_PARAMETERS_N4, MODE_PARAMETERS_N10, MODES, mask_computation
from .data import (
    DataLoader,
    Example,
    Scenario,
    batch_arrays,
    generate_scenarios,
    load_all_json_data,
    load_example,
    save_example,
)
from .evaluate import evaluate_modes, evaluate_scenario, evaluate_scenarios_batched
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
from .runner import BatchSolution, MaskedGameRunner, generate_ground_truth
from .subgame import solve_subgames
from . import real_data
from .train import (
    MetricsLogger,
    TrainConfig,
    load_checkpoint,
    make_train_step,
    save_checkpoint,
    train,
)

__all__ = [
    "MODES",
    "MODE_PARAMETERS_N4",
    "MODE_PARAMETERS_N10",
    "mask_computation",
    "DataLoader",
    "Example",
    "Scenario",
    "batch_arrays",
    "generate_scenarios",
    "load_all_json_data",
    "load_example",
    "save_example",
    "evaluate_modes",
    "evaluate_scenario",
    "evaluate_scenarios_batched",
    "build_masked_parametric_game",
    "pack_masked_theta",
    "setup_real_environment",
    "setup_real_game",
    "setup_road_environment",
    "setup_trajectory_game",
    "DEFAULT_WEIGHTS",
    "clamp_cotangent",
    "composite_loss",
    "HIDDEN_SIZES",
    "MaskMLP",
    "input_size",
    "prepare_input",
    "BatchSolution",
    "MaskedGameRunner",
    "generate_ground_truth",
    "solve_subgames",
    "real_data",
    "MetricsLogger",
    "TrainConfig",
    "load_checkpoint",
    "make_train_step",
    "save_checkpoint",
    "train",
]
