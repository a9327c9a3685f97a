"""Batched and streamed MCP solving over a leading batch axis.

Every lane of a batch runs inside one solve; lanes that converge early are
frozen (see solver.py) while the rest iterate. Tensors follow θ: its device
and dtype set those of the iterates, and they must match the device the game
was built on. ``solve_batch`` is differentiable in θ (``diff.py``, the
implicit function theorem) when θ carries a gradient or a forward-mode
tangent; otherwise, and in ``solve_batches_streamed``, it solves under
``no_grad``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..diff import _solve
from ..mcp import PrimalDualMCP
from ..solver import SolverOptions, default_initialization, ip_solve
from ..types import SOLVED, SolveResult


def _options(options: Optional[SolverOptions], overrides: dict) -> SolverOptions:
    if options is None:
        return SolverOptions(**overrides)
    return dataclasses.replace(options, **overrides) if overrides else options


def solve_batch(
    mcp: PrimalDualMCP,
    thetas: torch.Tensor,
    *,
    x0: Optional[torch.Tensor] = None,
    y0: Optional[torch.Tensor] = None,
    s0: Optional[torch.Tensor] = None,
    options: Optional[SolverOptions] = None,
    **option_overrides,
) -> SolveResult:
    """Solve a batch of MCP instances.

    thetas: (B, p) on the game's device; its dtype is the iterate dtype.
    x0/y0/s0: optional (B, n)/(B, m)/(B, m) warm starts.
    Returns a SolveResult whose fields carry a leading batch axis; x, y
    and s are differentiable in θ when θ requires grad.
    """
    options = _options(options, option_overrides)
    thetas = torch.as_tensor(thetas)
    x0, y0, s0 = default_initialization(mcp, thetas, x0, y0, s0)
    return _solve(mcp, options, thetas, x0, y0, s0)


def solve_batches_streamed(
    mcp: PrimalDualMCP,
    theta_stack: torch.Tensor,
    *,
    x0: Optional[torch.Tensor] = None,
    y0: Optional[torch.Tensor] = None,
    s0: Optional[torch.Tensor] = None,
    options: Optional[SolverOptions] = None,
    warm_chain: bool = False,
    warm_slacks: bool = False,
    **option_overrides,
) -> SolveResult:
    """Solve K batches back to back: theta_stack (K, B, p).

    warm_chain: batch k warm-starts from batch k-1's solution (x, y); lanes
      that failed keep their previous warm start. When False, every batch
      solves from x0/y0/s0.
    warm_slacks: also chain s.

    Returns a SolveResult whose fields carry leading (K, B) axes.
    """
    options = _options(options, option_overrides)
    theta_stack = torch.as_tensor(theta_stack)
    x, y, s = default_initialization(mcp, theta_stack[0], x0, y0, s0)
    results = []
    with torch.no_grad():
        for th in theta_stack:
            res = ip_solve(mcp, options, th, x, y, s)
            if warm_chain:
                ok = (res.status == SOLVED)[:, None]
                x = torch.where(ok, res.x, x)
                y = torch.where(ok, res.y, y)
                if warm_slacks:
                    s = torch.where(ok, res.s, s)
            results.append(res)
    return SolveResult(*(torch.stack(f) for f in zip(*results)))


def batch_statistics(result: SolveResult) -> dict:
    """Success rate and iteration statistics over a batched SolveResult
    (any leading shape)."""
    solved = result.status.reshape(-1) == SOLVED
    outer = result.outer_iters.reshape(-1).to(torch.float64)
    kkt = result.kkt_error.reshape(-1)
    return {
        "num_instances": int(solved.numel()),
        "success_rate": float(solved.to(torch.float64).mean()),
        "median_outer_iters": float(torch.quantile(outer, 0.5)),
        "mean_outer_iters": float(outer.mean()),
        "max_kkt_error_solved": float(
            torch.where(solved, kkt, torch.full_like(kkt, -torch.inf)).max()
        ),
    }
