"""mcp_tpu_torch — the mcp_tpu solver ported to PyTorch and CUDA.

The port covers the JAX package's solve paths: the batched lane-change
interior-point solve (the game front end, the banded Newton tiers), the
masked N-player flagship games (``selection/``, ``bench/flagships.py``) and
the random-QP suite, under the "ip", "mehrotra" and "hybrid" algorithms with
retry rounds, the terminal polish, batched and streamed serving and the
true-KKT certifier; differentiation through the solve by the implicit
function theorem (``diff.py``) and the solver-in-the-loop training step
(``selection/train.py``); the one-instance entry points ``solve`` and
``solve_game``; the warm-started receding horizon
(``trajectories/strategies.py``, the lane-change demos); the benchmark
harness and entry point (``bench/harness.py``, ``bench/main.py``, run as
``bench_cuda.py``) with the double-word QP refinement (``utils/twofloat.py``,
``bench/qp_dw.py``); the player-selection pipeline (``selection/``:
scenarios and ground truth, the training loop with checkpoints, the
heuristic baselines, the closed-loop evaluation, subgames and real data;
the C++ scenario sampler in ``native/``; ``analysis/metrics.py``; the CLIs
in ``scripts/``); and, over ``torch.distributed`` ranks, batch-sharded
solves, the horizon-sharded SPIKE solve, the tensor-parallel Newton
factorization (the ``newton_solver`` backend) and shape-bucket routing
(``parallel/mesh.py``, ``parallel/horizon.py``, ``parallel/tensor.py``,
``parallel/routing.py``). Linear-solver tiers: every banded tier of the JAX
package ("tridiag", "tridiag_cr", "tridiag_auto" and each
"tridiag_pallas*", with a row time structure or without one) and the dense
tiers "dense", "condensed", "schur", "schur_pallas", "schur_pallas_gj",
"schur_pallas_gjr" and "gmres"; every ``SolverOptions`` field, ``verbose``
and ``matmul_precision`` included.

Every kernel the JAX package wrote in Pallas is hand-written CUDA for Hopper
(``kernels/csrc/``): the one-way block-Thomas sweep with QR and the
Gauss–Jordan in-block factorizations (K1/K1′/K7b, ``thomas.cu``), the fused
linesearch (K2), block cyclic reduction with every factorization (K3), the
Gauss–Jordan solve and solve-and-inverse (K4a, K5), the batched Householder
QR (K4b/K4c), the multi-right-hand-side sweep of the SPIKE stage (K6), the
two-way sweep (K7a), the single-system QR with a separate right-hand side
(K8a) and the compact-WY blocked QR (K8b). On CPU tensors each runs its
plain PyTorch version. Not ported yet (ROADMAP Queue 1): ``analysis/``'s
plots, animations and experiments, the Orbax checkpoint backend, the
JAX-only staging helpers of ``bench/flagships.py`` and ``utils/devices.py``.

Entry points that create state take ``device=`` (default ``"cuda"``, which
raises on a machine without a GPU); solves follow the device of θ.
"""

from .mcp import PrimalDualMCP, verify_affine
from .solver import SolverOptions, auto_tightening_rate, default_initialization, ip_solve
from .diff import solve, solve_jacobian_theta
from .types import FAILED, SOLVED, SolveResult
from .games import (
    GameSolveResult,
    OptimizationProblem,
    ParametricGame,
    game_to_mcp,
    num_players,
    solve_game,
)
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
    "GameSolveResult",
    "OptimizationProblem",
    "ParametricGame",
    "game_to_mcp",
    "solve_game",
    "num_players",
    "solve_batch",
    "solve_batches_streamed",
    "batch_statistics",
]

__version__ = "0.1.0"
