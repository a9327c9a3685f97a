"""The masked-game flagship shapes: N players on the circle-crossing road
scenario, all-ones masks, horizon 30, the reference's own timing workload
(N=4 gives blocks of b=40, N=10 of b=100; the JAX package's
``bench/flagships.py:10-14, 28``), and the solver-in-the-loop training step
on it (``train_step_setup``, the JAX package's ``:62-118``).

The initial-state noise is drawn from a ``torch.Generator``: it matches the
JAX package's draw in distribution, not in values.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from types import SimpleNamespace
from typing import Optional

import torch

from .._device import resolve_device


@functools.lru_cache(maxsize=None)
def _runner(players: int, horizon: int, device: str):
    from ..selection.games import setup_road_environment, setup_trajectory_game
    from ..selection.runner import MaskedGameRunner

    game = setup_trajectory_game(environment=setup_road_environment(length=10.0), N=players)
    return MaskedGameRunner.create(game, N=players, horizon=horizon, device=device)


def masked_game_setup(
    batch: int, players: int, horizon: int, *,
    generator: Optional[torch.Generator] = None, device="cuda", dtype=torch.float32,
):
    """The circle-crossing masked-game flagship: players start on a circle of
    radius 3 (plus 0.05·N(0,1) noise from ``generator``, a CPU generator;
    default seed 0) with goals at the antipodes. The game is built once per
    (players, horizon, device). Returns a namespace with runner, mcp,
    thetas (B, p), x0 (B, n), init (B, N, 4), goals (B, N, 2), masks (B, N)."""
    device = resolve_device(device)
    runner = _runner(players, horizon, str(device))
    generator = torch.Generator().manual_seed(0) if generator is None else generator
    ang = torch.arange(players, dtype=torch.float64) * (2 * math.pi / players)
    base = torch.stack([3.0 * torch.cos(ang), 3.0 * torch.sin(ang)], dim=1)
    init = torch.cat([base, torch.zeros(players, 2, dtype=torch.float64)], dim=1)
    init = init.expand(batch, players, 4) + 0.05 * torch.randn(
        batch, players, 4, generator=generator, dtype=torch.float64
    )
    init = init.to(device=device, dtype=dtype)
    goals = (-base).expand(batch, players, 2).to(device=device, dtype=dtype)
    masks = torch.ones((batch, players), dtype=dtype, device=device)
    thetas = runner.pack_thetas(init, goals, masks[:, None, :].expand(batch, players, players))
    return SimpleNamespace(
        runner=runner,
        mcp=runner.parametric_game.mcp,
        thetas=thetas,
        x0=runner.cold_starts(init),
        init=init,
        goals=goals,
        masks=masks,
    )


def train_step_setup(
    batch: int = 8,
    players: int = 4,
    horizon: int = 30,
    *,
    tier: str = "tridiag",
    polish: bool = True,
    seed: int = 0,
    device="cuda",
    dtype=torch.float32,
):
    """The solver-in-the-loop training-step flagship (N=4, horizon 30, batch
    8 by default): the masked game of ``masked_game_setup`` (θ noise from
    ``seed``) on Newton tier ``tier`` with the banded IFT
    (``sensitivity_solver="tridiag"``), tightening rate max(auto, 0.05)
    (partial-mask games need the faster anneal), the terminal polish, the
    all-ones-mask solve as ground truth and the MLP initialized from a
    generator seeded 3. Returns a namespace with train_step, eval_step,
    sgd_update, config, runner, model, trajectories, init, goals, gt (the
    ground-truth BatchSolution), gt_success and rate."""
    from ..selection.model import MaskMLP, input_size
    from ..selection.train import TrainConfig, make_train_step
    from ..solver import SolverOptions, auto_tightening_rate

    s = masked_game_setup(batch, players, horizon, device=device, dtype=dtype,
                          generator=torch.Generator().manual_seed(seed))
    rate = max(auto_tightening_rate(s.mcp), 0.05)
    runner = dataclasses.replace(
        s.runner,
        options=SolverOptions(linear_solver=tier, sensitivity_solver="tridiag",
                              tightening_rate=rate, polish=polish),
    )
    config = TrainConfig(num_players=players, horizon=horizon, batch_size=batch)
    train_step, eval_step, sgd_update = make_train_step(runner, config)
    gt = runner.solve(s.init, s.goals, torch.ones_like(s.masks))
    model = MaskMLP(input_size(players, config.input_horizon, config.input_state_dim),
                    players, generator=torch.Generator().manual_seed(3), dtype=dtype,
                    device=s.thetas.device)
    return SimpleNamespace(
        train_step=train_step,
        eval_step=eval_step,
        sgd_update=sgd_update,
        config=config,
        runner=runner,
        model=model,
        trajectories=gt.trajectories,
        init=s.init,
        goals=s.goals,
        gt=gt,
        gt_success=float((gt.result.status == 0).double().mean()),
        rate=rate,
    )
