"""mcp_tpu_torch — the mcp_tpu solver ported to PyTorch and CUDA.

This slice covers the batched lane-change interior-point solve: the game
front end (parametric games, trajectory games, the lane-change example), the
banded Newton tier "tridiag_pallas" of the annealed algorithm "ip" with the
terminal polish, batched and streamed serving, and the true-KKT certifier.
Its two kernels, the block-Thomas sweep (K1) and the fused linesearch (K2),
are hand-written CUDA for Hopper (kernels/csrc/); on CPU tensors each runs
its plain PyTorch version.

Entry points that create state take ``device=`` (default ``"cuda"``, which
raises on a machine without a GPU); solves follow the device of θ.
"""

from .mcp import PrimalDualMCP
from .solver import SolverOptions, auto_tightening_rate, ip_solve
from .types import FAILED, SOLVED, SolveResult
from .games import OptimizationProblem, ParametricGame, game_to_mcp
from .parallel.batch import batch_statistics, solve_batch, solve_batches_streamed

__all__ = [
    "PrimalDualMCP",
    "SolverOptions",
    "SolveResult",
    "SOLVED",
    "FAILED",
    "auto_tightening_rate",
    "ip_solve",
    "OptimizationProblem",
    "ParametricGame",
    "game_to_mcp",
    "solve_batch",
    "solve_batches_streamed",
    "batch_statistics",
]

__version__ = "0.1.0"
