"""The lane-change configuration: the port's two-player lane-change game and
the benchmark's own θ sampler.

``sample`` is a frozen copy of the port's ``bench/lane_change.py`` sampler,
itself the upstream's ``generate_random_parameter``
(benchmark/trajectory_game_benchmark.jl:62-87): positions uniform inside the
road (0.5 m margin) in its lower half, player 2 pushed 2.5 m ahead when the
two start closer than 2.5 m, forward velocities uniform in [0, 2) m/s, and
a lane preference drawn uniformly from the lane centers. θ per player is
[px, py, vx, vy, lane preference].
"""

from __future__ import annotations

import torch

from perfbench.problem import Problem, solver_options


def lane_centers(cfg: dict) -> tuple[float, ...]:
    w = cfg["lane_width"]
    return tuple((i + 0.5) * w for i in range(cfg["num_lanes"]))


def build(cfg: dict, device: torch.device) -> Problem:
    """The port's lane-change MCP on ``device`` and the configuration's
    solver options."""
    from mcp_tpu_torch.examples.lane_change import build_lane_change_game

    _, pg, _ = build_lane_change_game(
        horizon=cfg["horizon"], num_lanes=cfg["num_lanes"], lane_width=cfg["lane_width"],
        height=cfg["height"], device=device)
    mcp = pg.mcp
    dims = (mcp.unconstrained_dimension, mcp.constrained_dimension, mcp.parameter_dimension)
    want = (cfg["num_primals"], cfg["num_inequalities"], cfg["parameter_dimension"])
    if dims != want:
        raise ValueError(f"the port's lane-change MCP has (n, m, p) = {dims}, "
                         f"the configuration states {want}")
    return Problem(mcp=mcp, options=solver_options(cfg, mcp))


def sample(cfg: dict, generator: torch.Generator, batch: int) -> torch.Tensor:
    """(batch, 10) θ in float64 on the generator's device."""
    g = generator
    kw = dict(generator=g, dtype=torch.float64, device=g.device)
    centers = lane_centers(cfg)
    road_width = len(centers) * cfg["lane_width"]
    height = cfg["height"]
    px = 0.5 + (road_width - 1.0) * torch.rand(batch, 2, **kw)
    py = 1.0 + (0.5 * height - 1.0) * torch.rand(batch, 2, **kw)
    too_close = (px[:, 0] - px[:, 1]) ** 2 + (py[:, 0] - py[:, 1]) ** 2 < 6.25
    py[:, 1] = torch.where(too_close, py[:, 0] + 2.5, py[:, 1])
    v = 2.0 * torch.rand(batch, 2, 2, **kw)
    lane_idx = torch.randint(0, len(centers), (batch, 2), generator=g, device=g.device)
    lanes = torch.as_tensor(centers, dtype=torch.float64, device=g.device)[lane_idx]
    return torch.stack(
        [px[:, 0], py[:, 0], v[:, 0, 0], v[:, 0, 1], lanes[:, 0],
         px[:, 1], py[:, 1], v[:, 1, 0], v[:, 1, 1], lanes[:, 1]],
        dim=1,
    )
