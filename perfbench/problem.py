"""What a configuration module hands the harness: the port's MCP and its
solver options, built from the configuration's file."""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

DTYPES = {"float32": torch.float32, "float64": torch.float64}


class Problem(NamedTuple):
    mcp: Any  # mcp_tpu_torch.PrimalDualMCP
    options: Any  # mcp_tpu_torch.SolverOptions


def solver_options(cfg: dict, mcp):
    """``SolverOptions`` from the configuration's ``solver`` entry;
    ``"tightening_rate": "auto"`` takes the port's ``auto_tightening_rate``."""
    from mcp_tpu_torch import SolverOptions, auto_tightening_rate

    kw = dict(cfg["solver"])
    if kw.get("tightening_rate") == "auto":
        kw["tightening_rate"] = auto_tightening_rate(mcp)
    return SolverOptions(**kw)
