"""Batched and streamed MCP solving over a leading batch axis.

Every lane of a batch runs inside one solve; lanes that converge early are
frozen (see solver.py) while the rest iterate. Tensors follow θ: its device
and dtype set those of the iterates, and they must match the device the game
was built on.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..mcp import PrimalDualMCP
from ..solver import SolverOptions, ip_solve
from ..types import SOLVED, SolveResult


def _options(options: Optional[SolverOptions], overrides: dict) -> SolverOptions:
    if options is None:
        return SolverOptions(**overrides)
    return dataclasses.replace(options, **overrides) if overrides else options


def _initial(mcp: PrimalDualMCP, B: int, like: torch.Tensor, x0, y0, s0):
    """The reference cold start x = 0, y = s = 1 where not given."""
    n, m = mcp.unconstrained_dimension, mcp.constrained_dimension
    kw = dict(dtype=like.dtype, device=like.device)
    x0 = torch.zeros((B, n), **kw) if x0 is None else torch.as_tensor(x0, **kw)
    y0 = torch.ones((B, m), **kw) if y0 is None else torch.as_tensor(y0, **kw)
    s0 = torch.ones((B, m), **kw) if s0 is None else torch.as_tensor(s0, **kw)
    return x0, y0, s0


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
    Returns a SolveResult whose fields carry a leading batch axis.
    """
    options = _options(options, option_overrides)
    thetas = torch.as_tensor(thetas)
    x0, y0, s0 = _initial(mcp, thetas.shape[0], thetas, x0, y0, s0)
    with torch.no_grad():
        return ip_solve(mcp, options, thetas, x0, y0, s0)


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
    _, B, _ = theta_stack.shape
    x, y, s = _initial(mcp, B, theta_stack, x0, y0, s0)
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
