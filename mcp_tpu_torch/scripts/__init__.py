"""Command-line entry points of the player-selection pipeline and the
analysis suite, each run as ``python -m mcp_tpu_torch.scripts.<name>`` with
the flags of the JAX package's script of the same name. Those that solve
also take ``--tier`` (the runner's Newton tier, default "tridiag") and
``--cpu`` (run on the CPU; otherwise on the card):

* ``datagen``: scenarios and their ground truth in train/, val/ and test/;
* ``train_selection``: trains the mask predictor, writing checkpoints,
  ``losses.json`` and ``loss_curves.png``;
* ``evaluate_selection``: the closed-loop sweep over selection modes,
  ``metrics.json`` and ``radar.png``;
* ``loss_landscape``: the 2-D mask loss landscape of one training example
  (one batched solve of grid² lanes) and its heatmap;
* ``time_test``: solve time against the player count N, as JSON, and its
  plot.

``paper_vis`` (the anchored radar suite and the trajectory grid) and
``animate_results`` (one GIF or MP4 per evaluation JSON) only draw, so they
run on the CPU alone.

The figures need matplotlib. A CLI that solves prints (and, where it
writes JSON, writes) its numbers first; where matplotlib is not installed,
as on the card's machine, it then prints one line naming each figure it did
not write and exits 0 (``figure``).
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


def figure(what: str, draw) -> bool:
    """Call ``draw()``, which writes the figure(s) named by ``what``; where
    matplotlib is not installed, print one line saying that ``what`` was
    not written instead. Returns whether it was written."""
    try:
        draw()
    except ImportError as exc:
        if "matplotlib" not in str(exc):
            raise
        print(f"{what} not written: matplotlib is not installed")
        return False
    return True
