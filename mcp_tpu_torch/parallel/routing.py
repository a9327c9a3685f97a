"""Heterogeneous-shape routing: each shape bucket on its own group of ranks,
the JAX package's ``parallel/routing.py`` over ``torch.distributed``.

Games arrive in many shapes (player counts, horizons, QP sizes). Routing
runs different shape buckets on different ranks at the same time, the way
expert-parallel layers route tokens to experts:

* ``partition_devices`` splits the ranks into one contiguous group per
  bucket, sized by largest-remainder proportional allocation over the
  buckets' estimated costs (batch × (n+m)³ by default: the factorization
  dominates).
* Every rank builds each bucket's 1-D batch mesh over its group
  (``make_batch_mesh(ranks=...)``: creating a group is collective), and the
  ranks of a group run ``solve_batch_sharded`` on their bucket; the groups
  are disjoint, so the buckets solve concurrently.
* Batches are padded by edge replication to a multiple of the group size
  and unpadded on return. Every rank returns every bucket's result: the
  first rank of each group broadcasts it to all (the ``mesh.py``
  convention, "every rank returns the global result").

Ranks that share one card exchange over gloo, through host memory.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .._device import resolve_device
from ..mcp import PrimalDualMCP
from ..solver import SolverOptions
from ..types import SolveResult
from .mesh import broadcast, make_batch_mesh, solve_batch_sharded

Tensor = torch.Tensor


@dataclass
class ShapeBucket:
    """One same-shape group of instances: θ batch (B, p), optional warm
    starts (B, n)/(B, m), its options, and an optional cost ``weight`` that
    overrides the estimate."""

    mcp: PrimalDualMCP
    thetas: Tensor
    x0: Optional[Tensor] = None
    y0: Optional[Tensor] = None
    s0: Optional[Tensor] = None
    options: Optional[SolverOptions] = None
    weight: Optional[float] = None

    def cost(self) -> float:
        if self.weight is not None:
            return float(self.weight)
        n = self.mcp.unconstrained_dimension + self.mcp.constrained_dimension
        return float(self.thetas.shape[0]) * float(n) ** 3


def partition_devices(costs: Sequence[float], devices=None) -> list[list]:
    """Split ``devices`` (default: the ranks of the default group) into
    len(costs) contiguous groups, sizes proportional to costs
    (largest-remainder; every bucket gets ≥ 1). Requires len(devices) ≥
    len(costs)."""
    if devices is None:
        devices = range(dist.get_world_size())
    devices = list(devices)
    k, D = len(costs), len(devices)
    if k == 0:
        return []
    if D < k:
        raise ValueError(f"{k} buckets need at least {k} devices, got {D}")
    total = float(sum(costs)) or 1.0
    # One device per bucket; the other D − k by cost.
    spare = D - k
    quotas = [spare * c / total for c in costs]
    sizes = [1 + int(q) for q in quotas]
    remainders = [q - int(q) for q in quotas]
    for i in np.argsort(remainders)[::-1][: D - sum(sizes)]:
        sizes[int(i)] += 1
    groups, at = [], 0
    for sz in sizes:
        groups.append(devices[at : at + sz])
        at += sz
    return groups


def _pad_batch(arr: Optional[Tensor], B_pad: int) -> Optional[Tensor]:
    if arr is None or arr.shape[0] == B_pad:
        return arr
    # Edge replication: padded lanes solve a real instance.
    return torch.cat([arr, arr[-1:].expand(B_pad - arr.shape[0], *arr.shape[1:])])


def _result_like(mcp: PrimalDualMCP, B: int, dtype, device) -> SolveResult:
    """Buffers of a batched result of ``mcp`` (what a broadcast fills)."""
    n, m = mcp.unconstrained_dimension, mcp.constrained_dimension
    f = lambda *shape: torch.empty(shape, dtype=dtype, device=device)
    i = lambda: torch.empty((B,), dtype=torch.int32, device=device)
    return SolveResult(x=f(B, n), y=f(B, m), s=f(B, m), kkt_error=f(B), epsilon=f(B),
                       outer_iters=i(), status=i())


def solve_routed(buckets: Sequence[ShapeBucket], devices=None, *,
                 device="cuda") -> list[SolveResult]:
    """Solve every bucket, each on its own group of ranks (``devices``:
    default every rank of the default group), all at once. Every rank of
    the default group calls it with the same buckets and gets one batched
    SolveResult per bucket (original batch sizes, padding stripped) on
    ``device`` (default the card, which raises without one)."""
    device = resolve_device(device)
    groups = partition_devices([b.cost() for b in buckets], devices)
    meshes = [make_batch_mesh(ranks=g, device=device) for g in groups]
    pads = [-(-b.thetas.shape[0] // len(g)) * len(g) for b, g in zip(buckets, groups)]
    solved = {}
    for k, (bucket, mesh, B_pad) in enumerate(zip(buckets, meshes, pads)):
        if mesh is None:
            continue  # another group's bucket
        pad = lambda a: _pad_batch(None if a is None else torch.as_tensor(a).to(device), B_pad)
        solved[k], _ = solve_batch_sharded(
            bucket.mcp, pad(bucket.thetas), mesh=mesh,
            x0=pad(bucket.x0), y0=pad(bucket.y0), s0=pad(bucket.s0),
            options=bucket.options or SolverOptions(),
        )
    results = []
    for k, (bucket, group, B_pad) in enumerate(zip(buckets, groups, pads)):
        src = solved.get(k) or _result_like(bucket.mcp, B_pad,
                                            torch.as_tensor(bucket.thetas).dtype, device)
        sol = [broadcast(f, group[0], dist.group.WORLD) for f in src]
        results.append(SolveResult(*(f[: bucket.thetas.shape[0]] for f in sol)))
    return results
