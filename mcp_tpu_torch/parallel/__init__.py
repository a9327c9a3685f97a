"""Batched, batch-sharded and horizon-sharded solving.

Axes: dp (batch.py, mesh.py: ``torch.distributed`` ranks), sp (horizon.py:
SPIKE over a horizon axis of ranks). The JAX package's tp (tensor.py) and
ep (routing.py) axes are not ported yet (ROADMAP Queue 1 item 8)."""

from .batch import batch_statistics, solve_batch, solve_batches_streamed
from .mesh import BATCH_AXIS, make_batch_mesh, solve_batch_sharded

__all__ = [
    "BATCH_AXIS",
    "batch_statistics",
    "make_batch_mesh",
    "solve_batch",
    "solve_batches_streamed",
    "solve_batch_sharded",
]
