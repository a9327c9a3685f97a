"""mcp_tpu_torch — the mcp_tpu solver ported to PyTorch and CUDA.

The port covers the batched lane-change interior-point solve (the game
front end, the banded Newton tier "tridiag_pallas"), the masked N-player
flagship games (``selection/``, ``bench/flagships.py``; the banded tiers
"tridiag", "tridiag_cr", "tridiag_pallas_cr", "tridiag_pallas_crgjp",
"tridiag_pallas_crgjpr" and "tridiag_auto") and the random-QP suite (the
dense tiers "dense", "condensed", "schur", "schur_pallas",
"schur_pallas_gj", "schur_pallas_gjr"), under the "ip", "mehrotra" and
"hybrid" algorithms with retry rounds, the terminal polish, batched and
streamed serving, and the true-KKT certifier. Its kernels, the
block-Thomas sweep (K1), the fused linesearch (K2), the block cyclic
reduction with QR and pivoted Gauss–Jordan blocks (K3), the Gauss–Jordan
solve (K4a) and solve-and-inverse (K5) and the Householder-QR dense solve
(K4b/K4c), are hand-written CUDA for Hopper (kernels/csrc/); on CPU
tensors each runs its plain PyTorch version.

Entry points that create state take ``device=`` (default ``"cuda"``, which
raises on a machine without a GPU); solves follow the device of θ.
"""

from .mcp import PrimalDualMCP, verify_affine
from .solver import SolverOptions, auto_tightening_rate, default_initialization, ip_solve
from .diff import solve, solve_jacobian_theta
from .types import FAILED, SOLVED, SolveResult
from .games import OptimizationProblem, ParametricGame, game_to_mcp
from .parallel.batch import batch_statistics, solve_batch, solve_batches_streamed

__all__ = [
    "PrimalDualMCP",
    "verify_affine",
    "SolverOptions",
    "SolveResult",
    "SOLVED",
    "FAILED",
    "auto_tightening_rate",
    "ip_solve",
    "default_initialization",
    "solve",
    "solve_jacobian_theta",
    "OptimizationProblem",
    "ParametricGame",
    "game_to_mcp",
    "solve_batch",
    "solve_batches_streamed",
    "batch_statistics",
]

__version__ = "0.1.0"
