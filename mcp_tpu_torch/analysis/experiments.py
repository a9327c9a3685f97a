"""Stand-alone experiment harnesses: solver time against the player count N,
and the 2-D mask loss landscape (the JAX package's
``analysis/experiments.py``).

Parity targets: the reference's solver wall time against player count
(examples/time_test.jl:21-80, measured per receding-horizon step) and its
2-D mask loss-landscape grid sweep (examples/gradient_test.jl:7-55). The
landscape solves the whole mask grid as one batch; the N-scaling harness
times batched solves and reports the cost per instance.
"""

from __future__ import annotations

import math
import time
from typing import Optional, Sequence

import torch

from .._device import resolve_device
from ..selection.games import setup_road_environment, setup_trajectory_game
from ..selection.loss import composite_loss
from ..selection.runner import MaskedGameRunner
from ..solver import SolverOptions


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def n_scaling_experiment(
    player_counts: Sequence[int] = (2, 3, 4),
    *,
    horizon: int = 30,
    batch: int = 1,
    repeats: int = 3,
    seed: int = 0,
    options: Optional[SolverOptions] = None,
    verbose: bool = True,
    device="cuda",
) -> dict:
    """Masked-game solve time against N (examples/time_test.jl:21-80; the
    reference's own numbers are in BASELINE.md): for each N, players on a
    circle of radius 3 heading across it, with noise of scale 0.1 from a
    ``torch.Generator`` seeded ``seed`` (the JAX package draws its noise
    from ``jax.random``: the two agree in distribution only), all-ones
    masks, ``batch`` copies of the instance in float32. One warm solve,
    then ``repeats`` timed solves, each ending in a synchronize on the
    card. Returns {N: least seconds of a timed solve / batch}."""
    device = resolve_device(device)
    results = {}
    for N in player_counts:
        env = setup_road_environment(length=10.0)
        game = setup_trajectory_game(environment=env, N=N)
        runner = MaskedGameRunner.create(game, N=N, horizon=horizon,
                                         options=options or SolverOptions(), device=device)
        gen = torch.Generator().manual_seed(seed)
        # Spread players on a circle for guaranteed separation.
        ang = torch.arange(N, dtype=torch.float64) * (2 * math.pi / N)
        base = torch.stack([3.0 * torch.cos(ang), 3.0 * torch.sin(ang)], dim=1)
        init = torch.cat([base + 0.1 * torch.randn((N, 2), generator=gen, dtype=torch.float64),
                          torch.zeros((N, 2), dtype=torch.float64)], dim=1)
        goals = -base + 0.1 * torch.randn((N, 2), generator=gen, dtype=torch.float64)
        init, goals = (a[None].expand(batch, *a.shape).to(device=device, dtype=torch.float32)
                       for a in (init, goals))
        masks = torch.ones((batch, N), dtype=torch.float32, device=device)

        bs = runner.solve(init, goals, masks)  # warm
        _sync(device)
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            bs = runner.solve(init, goals, masks)
            _sync(device)
            times.append(time.perf_counter() - t0)
        per_solve = min(times) / batch
        results[N] = per_solve
        if verbose:
            print(f"N={N}: {per_solve:.4f} s/solve (batch {batch}), "
                  f"status={bs.result.status[:4].cpu().numpy()}")
    return results


def mask_loss_landscape(
    runner: MaskedGameRunner,
    initial_states,  # (N, 4)
    goals,  # (N, 2)
    target_ego_states,  # (T, 4) ground-truth ego plan
    *,
    mask_indices: tuple[int, int] = (1, 2),
    grid_points: int = 11,
    input_horizon: int = 10,
    ego_index: int = 0,
) -> dict:
    """Sweep two mask entries over [0, 1]² and evaluate the composite loss at
    each grid point (the reference's loss-landscape probe,
    examples/gradient_test.jl:7-55) as one batched solve of grid_points²
    lanes on the runner's device, in float32 whatever the inputs' dtype (as
    the JAX package forces). Returns numpy ``grid_x``, ``grid_y``,
    ``losses`` and ``statuses``, each (grid_points, grid_points)."""
    N, dev, f32 = runner.N, runner.device, torch.float32
    g = torch.linspace(0.0, 1.0, grid_points, dtype=f32, device=dev)
    gx, gy = torch.meshgrid(g, g, indexing="xy")
    flat_x, flat_y = gx.reshape(-1), gy.reshape(-1)
    B = flat_x.shape[0]

    masks = torch.ones((B, N), dtype=f32, device=dev)
    masks[:, mask_indices[0]] = flat_x
    masks[:, mask_indices[1]] = flat_y
    init, gls = (torch.as_tensor(a).to(device=dev, dtype=f32)[None].expand(B, N, -1)
                 for a in (initial_states, goals))
    target = torch.as_tensor(target_ego_states).to(device=dev, dtype=f32)
    mask_rows = runner.ego_masked_mask_rows(masks, ego_index=ego_index)
    bs = runner.solve(init, gls, masks, mask_rows=mask_rows)

    losses = composite_loss(bs.trajectories[:, ego_index], target, masks[:, 1:],
                            horizon=runner.horizon,
                            input_horizon=min(input_horizon, runner.horizon))
    shape = (grid_points, grid_points)
    return {
        "grid_x": gx.cpu().numpy(),
        "grid_y": gy.cpu().numpy(),
        "losses": losses.reshape(shape).cpu().numpy(),
        "statuses": bs.result.status.reshape(shape).cpu().numpy(),
    }
