"""Benchmark harness: certification of solve results."""

from __future__ import annotations

import torch

from ..mcp import PrimalDualMCP


def true_kkt_errors(mcp: PrimalDualMCP, result, thetas: torch.Tensor) -> torch.Tensor:
    """‖F‖∞ recomputed at the FINAL iterates, per instance: max(‖g‖∞,
    ‖h − s‖∞, ‖s∘y‖∞).

    The solver's own kkt_error is the stale pre-step metric and its exit
    can be triggered by ϵ ≤ tol rather than kkt ≤ tol, so an honest report
    re-evaluates the residual at the returned point. Leading axes of
    ``result``/``thetas`` (a batch, or K batches) are kept. Float32 matmuls
    run without TF32 (solver.py turns it off)."""
    x, y, s = result.x, result.y, result.s
    lead = x.shape[:-1]
    x, y, s = x.reshape(-1, x.shape[-1]), y.reshape(-1, y.shape[-1]), s.reshape(-1, s.shape[-1])
    thetas = torch.as_tensor(thetas).reshape(-1, thetas.shape[-1])
    with torch.no_grad():
        g, h = mcp.gh_batched(x, y, thetas)
        kkt = torch.maximum(
            g.abs().amax(dim=1),
            torch.maximum((h - s).abs().amax(dim=1), (s * y).abs().amax(dim=1)),
        )
    return kkt.reshape(lead)
