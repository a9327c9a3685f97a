"""Command-line entry points of the player-selection pipeline, each run as
``python -m mcp_tpu_torch.scripts.<name>`` with the flags of the JAX
package's scripts of the same name, plus ``--tier`` (the runner's Newton
tier, default "tridiag"); ``--cpu`` runs on the CPU, otherwise on the card:

* ``datagen``: scenarios and their ground truth in train/, val/ and test/;
* ``train_selection``: trains the mask predictor, writing checkpoints and
  ``losses.json``;
* ``evaluate_selection``: the closed-loop sweep over selection modes and
  ``metrics.json``.

The JAX scripts' plots (loss curves, radar chart) are not written.
"""

from __future__ import annotations


def road_runner(players: int, horizon: int, *, length: float, tier: str, device):
    """The masked road game's runner with Newton tier ``tier`` and the banded
    IFT (for tier "tridiag" the runner's default options)."""
    from ..selection import MaskedGameRunner, setup_road_environment, setup_trajectory_game
    from ..solver import SolverOptions

    game = setup_trajectory_game(environment=setup_road_environment(length=length), N=players)
    return MaskedGameRunner.create(
        game, N=players, horizon=horizon, device=device,
        options=SolverOptions(linear_solver=tier, sensitivity_solver="tridiag"),
    )
