"""Batched, batch-sharded, horizon-sharded, tensor-parallel and routed
solving.

Axes: dp (batch.py, mesh.py: ``torch.distributed`` ranks), sp (horizon.py:
SPIKE over a horizon axis of ranks), tp (tensor.py: one factorization
sharded over ranks) and ep (routing.py: shape buckets on groups of ranks)."""

from .batch import batch_statistics, solve_batch, solve_batches_streamed
from .mesh import BATCH_AXIS, make_batch_mesh, make_tp_mesh, solve_batch_sharded
from .routing import ShapeBucket, partition_devices, solve_routed
from .tensor import lu_solve_tp, solve_single_tp

__all__ = [
    "BATCH_AXIS",
    "ShapeBucket",
    "batch_statistics",
    "lu_solve_tp",
    "make_batch_mesh",
    "make_tp_mesh",
    "partition_devices",
    "solve_batch",
    "solve_batches_streamed",
    "solve_batch_sharded",
    "solve_routed",
    "solve_single_tp",
]
