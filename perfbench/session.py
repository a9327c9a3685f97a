"""One cell's system under test: the configuration's problem built on the
device, θ drawn from the seed, and the program's entry that the window
drives (``mcp_tpu_torch.parallel.batch.solve_batch``)."""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.profiler import record_function

from perfbench import seeds, spec
from perfbench.problem import DTYPES

#: Host spans the harness records around its own work in a traced run.
SPAN_CALL = "perfbench.call"
SPAN_DRAW = "perfbench.draw"
SPAN_FETCH = "perfbench.fetch"
SPAN_WINDOW = "perfbench.window"


class Answer(NamedTuple):
    """What one call returned, on the host: status (B,) and x, y, s."""
    status: torch.Tensor
    x: torch.Tensor
    y: torch.Tensor
    s: torch.Tensor


class Session:
    """``draw(stream, index[, seed])`` → θ on the device in the configuration's
    dtype; ``solve(θ)`` → the program's SolveResult; ``fetch(result)`` →
    an ``Answer`` on the host."""

    def __init__(self, cell: spec.Cell, seed: int, device: torch.device):
        self.cell, self.seed, self.device = cell, seed, device
        self.cfg = cell.config
        self.batch = int(cell.traffic["batch"])
        self.dtype = DTYPES[self.cfg["dtype"]]
        self.config = spec.config_module(cell)
        self.problem = self.config.build(self.cfg, device)

    def draw(self, stream: int, index: int, seed: int | None = None) -> torch.Tensor:
        """θ of (seed, stream, index); the run's seed by default."""
        with record_function(SPAN_DRAW):
            g = seeds.generator(self.device, self.seed if seed is None else seed, stream, index)
            return self.config.sample(self.cfg, g, self.batch).to(self.dtype)

    def solve(self, theta: torch.Tensor):
        from mcp_tpu_torch.parallel.batch import solve_batch

        with record_function(SPAN_CALL):
            return solve_batch(self.problem.mcp, theta, options=self.problem.options)

    @staticmethod
    def fetch(result) -> Answer:
        with record_function(SPAN_FETCH):
            return Answer(*(t.detach().cpu() for t in
                            (result.status, result.x, result.y, result.s)))
