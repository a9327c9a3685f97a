"""Result and status types of the interior-point MCP solver.

The solver returns one ``SolveResult`` per batch: every field carries a
leading batch axis. Status is an int32 code, ``SOLVED`` or ``FAILED``, the
counterpart of the reference's ``:solved`` / ``:failed`` symbols.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

SOLVED = 0
FAILED = 1


class SolveResult(NamedTuple):
    """Result of a batched interior-point solve.

    x: unconstrained primal block, (B, n).
    y: constrained dual block, (B, m).
    s: slack block, (B, m).
    kkt_error: ‖F‖∞ at the last accepted iterate (stale by one step, as the
      residual is evaluated before the Newton update), or the true residual
      at the returned point when the solve polished, (B,).
    epsilon: final central-path relaxation ϵ, (B,).
    outer_iters: outer (ϵ-annealing) iterations performed, int32 (B,).
    status: SOLVED or FAILED, int32 (B,).
    """

    x: torch.Tensor
    y: torch.Tensor
    s: torch.Tensor
    kkt_error: torch.Tensor
    epsilon: torch.Tensor
    outer_iters: torch.Tensor
    status: torch.Tensor

    @property
    def solved(self) -> torch.Tensor:
        return self.status == SOLVED
