"""Lane-change trajectory-game benchmark problem: the two-player lane-change
game at horizon 10, with random initial states inside the road polygon and
random lane preferences.

The θ samplers draw from a ``torch.Generator`` on its own device; they match
the JAX package's samplers in distribution, not in values.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from .._device import resolve_device
from ..examples.lane_change import build_lane_change_game
from ..games import ParametricGame
from ..trajectories import TrajectoryGame


class LaneChangeBenchmark(NamedTuple):
    game: TrajectoryGame
    parametric_game: ParametricGame
    lane_centers: tuple[float, ...]
    horizon: int


def generate_test_problem(
    *, horizon: int = 10, height: float = 50.0, device="cuda"
) -> LaneChangeBenchmark:
    """Build (once per horizon, height and device) the benchmark problem.
    ``height`` scales the road for long horizons (a T-step game at the
    2 m/s nominal speed travels 2T m)."""
    return _build_test_problem(horizon, height, str(resolve_device(device)))


@functools.lru_cache(maxsize=None)
def _build_test_problem(horizon: int, height: float, device: str) -> LaneChangeBenchmark:
    game, pg, road = build_lane_change_game(
        horizon=horizon, height=height, device=device
    )
    return LaneChangeBenchmark(
        game=game, parametric_game=pg, lane_centers=road.lane_centers, horizon=horizon
    )


def generate_parameter_batch(
    generator: torch.Generator,
    batch: int,
    bench: LaneChangeBenchmark,
    *,
    height: float = 50.0,
    lane_width: float = 2.0,
    dtype=torch.float32,
    device="cuda",
) -> torch.Tensor:
    """(batch, 10) θ = per-player [px, py, vx, vy, lane preference]:
    positions uniform inside the road (0.5 m margin) in its lower half,
    player 2 pushed 2.5 m ahead when the two start closer than 2.5 m, small
    forward velocities, and a uniformly chosen preferred lane center. Drawn
    in float64 on the generator's device (a CPU generator draws on the
    CPU, a CUDA one on the card), then moved to ``device``."""
    device = resolve_device(device)
    num_lanes = len(bench.lane_centers)
    road_width = num_lanes * lane_width
    g = generator
    kw = dict(generator=g, dtype=torch.float64, device=g.device)
    px = 0.5 + (road_width - 1.0) * torch.rand(batch, 2, **kw)
    py = 1.0 + (0.5 * height - 1.0) * torch.rand(batch, 2, **kw)
    too_close = (px[:, 0] - px[:, 1]) ** 2 + (py[:, 0] - py[:, 1]) ** 2 < 6.25
    py[:, 1] = torch.where(too_close, py[:, 0] + 2.5, py[:, 1])
    v = 2.0 * torch.rand(batch, 2, 2, **kw)
    lane_idx = torch.randint(0, num_lanes, (batch, 2), generator=g, device=g.device)
    lanes = torch.as_tensor(bench.lane_centers, dtype=torch.float64, device=g.device)[lane_idx]
    theta = torch.stack(
        [px[:, 0], py[:, 0], v[:, 0, 0], v[:, 0, 1], lanes[:, 0],
         px[:, 1], py[:, 1], v[:, 1, 0], v[:, 1, 1], lanes[:, 1]],
        dim=1,
    )
    return theta.to(device=device, dtype=dtype)


def generate_random_parameter(
    generator: torch.Generator, bench: LaneChangeBenchmark, **kwargs
) -> torch.Tensor:
    """One θ, (10,); see ``generate_parameter_batch``."""
    return generate_parameter_batch(generator, 1, bench, **kwargs)[0]
