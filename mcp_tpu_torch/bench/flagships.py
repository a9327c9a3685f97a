"""The masked-game flagship shapes: N players on the circle-crossing road
scenario, all-ones masks, horizon 30, the reference's own timing workload
(N=4 gives blocks of b=40, N=10 of b=100; the JAX package's
``bench/flagships.py:10-14, 28``).

The initial-state noise is drawn from a ``torch.Generator``: it matches the
JAX package's draw in distribution, not in values.
"""

from __future__ import annotations

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
