"""Process meshes over ``torch.distributed`` and batch-sharded solving.

The JAX package shards over a device mesh (``jax.sharding.Mesh``) inside
one program; here every rank is a process, and a mesh names the ranks of the
default process group along named axes. ``Mesh`` is a small object: its axis
names and sizes, one process group per axis (the ranks that differ from this
rank along that axis only), this rank's index on each axis and the device the
rank computes on. It is written out rather than taken from
``torch.distributed.device_mesh``, which ties a mesh to one device type per
rank and expects a card per rank; here several ranks may share one card
(their collectives then run over gloo, through host memory).

Every rank calls the same entry point with the same global arguments (θ and
warm starts replicated); each solves its share and the results are gathered,
so every rank returns the global result. Tensors of the collectives move to
the host when the backend is gloo and the device is a card.

Entry: ``initialize_distributed`` (a thin wrapper over
``torch.distributed.init_process_group``; the caller names the backend, the
rendezvous, the world size and the rank), then ``make_batch_mesh`` (or
``parallel.horizon.make_horizon_mesh``/``make_dp_horizon_mesh``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from .._device import resolve_device
from ..diff import _solve_ts
from ..mcp import PrimalDualMCP
from ..solver import SolverOptions, default_initialization
from ..types import SOLVED, SolveResult
from .batch import _options

BATCH_AXIS = "batch"


def initialize_distributed(**kwargs) -> None:
    """Initialize the default process group: a thin wrapper over
    ``torch.distributed.init_process_group`` (kwargs: backend, init_method,
    world_size, rank, timeout, ...). Call once per process before building a
    mesh."""
    dist.init_process_group(**kwargs)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Ranks ``0..size-1`` of the default group laid out row-major over
    ``axis_names`` (the last axis minor: its neighbours are adjacent ranks).

    groups: one process group per axis, holding the ranks that share this
      rank's index on every other axis (in axis order).
    coords: this rank's index on each axis.
    device: where this rank's tensors live."""

    axis_names: tuple[str, ...]
    shape: tuple[int, ...]
    groups: tuple
    coords: tuple[int, ...]
    device: torch.device

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    def axis_size(self, name: str) -> int:
        return self.shape[self.axis_names.index(name)]

    def group(self, name: str):
        return self.groups[self.axis_names.index(name)]

    def index(self, name: str) -> int:
        return self.coords[self.axis_names.index(name)]


def make_mesh(shape, axis_names, *, device="cuda") -> Mesh:
    """A mesh of ``shape`` over all ranks of the default group. Every rank
    must call it, in the same order as every other collective (it creates
    one process group per line of each axis)."""
    device = resolve_device(device)
    shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} and axes {axis_names} differ in length")
    world, rank = dist.get_world_size(), dist.get_rank()
    size = 1
    for s in shape:
        size *= s
    if size != world:
        raise ValueError(f"mesh shape {shape} needs {size} ranks, got {world}")
    strides = [1] * len(shape)
    for a in range(len(shape) - 2, -1, -1):
        strides[a] = strides[a + 1] * shape[a + 1]
    coords = tuple((rank // strides[a]) % shape[a] for a in range(len(shape)))
    groups = []
    for a in range(len(shape)):
        mine = None
        # One group per line along axis a: the ranks with every other index
        # fixed. new_group is collective, so every rank creates every line.
        for base in range(world):
            if (base // strides[a]) % shape[a]:
                continue
            ranks = [base + i * strides[a] for i in range(shape[a])]
            g = dist.new_group(ranks)
            if rank in ranks:
                mine = g
        groups.append(mine)
    return Mesh(axis_names, shape, tuple(groups), coords, device)


def make_batch_mesh(*, axis_name: str = BATCH_AXIS, device="cuda") -> Mesh:
    """1-D mesh over every rank for batch-parallel solving."""
    return make_mesh((dist.get_world_size(),), (axis_name,), device=device)


def _host_hop(t: torch.Tensor, group) -> bool:
    return dist.get_backend(group) == "gloo" and t.device.type != "cpu"


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """The tensors ``t`` of every rank of ``group`` stacked on a new leading
    axis in group-rank order, on ``t``'s device (through the host over
    gloo)."""
    src = t.cpu() if _host_hop(t, group) else t
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src.contiguous(), group=group)
    return torch.stack(parts).to(t.device)


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``group``, on ``t``'s device."""
    src = t.cpu().clone() if _host_hop(t, group) else t.clone()
    dist.all_reduce(src, op=dist.ReduceOp.SUM, group=group)
    return src.to(t.device)


def gather_result(res: SolveResult, group) -> SolveResult:
    """A batched result sharded over ``group`` (each rank its rows, in group
    order) gathered into the global batch on every rank."""
    return SolveResult(*(all_gather(f, group).reshape(-1, *f.shape[1:]) for f in res))


def _shard_rows(a: torch.Tensor, parts: int, index: int) -> torch.Tensor:
    rows = a.shape[0] // parts
    return a[index * rows:(index + 1) * rows]


def solve_batch_sharded(
    mcp: PrimalDualMCP,
    thetas: torch.Tensor,
    *,
    mesh: Optional[Mesh] = None,
    x0: Optional[torch.Tensor] = None,
    y0: Optional[torch.Tensor] = None,
    s0: Optional[torch.Tensor] = None,
    options: Optional[SolverOptions] = None,
    **option_overrides,
) -> tuple[SolveResult, torch.Tensor]:
    """Solve a global batch sharded over the mesh's ranks: each rank solves
    its B / size rows (the batch size must be divisible by the mesh size).
    Returns (the global SolveResult on every rank, the global count of
    SOLVED lanes by an all-reduce). θ and the warm starts are the global
    batch, the same on every rank; they move to the mesh's device."""
    options = _options(options, option_overrides)
    if mesh is None:
        mesh = make_batch_mesh()
    if len(mesh.shape) != 1:
        raise ValueError(f"solve_batch_sharded takes a 1-D mesh, got shape {mesh.shape}")
    thetas = torch.as_tensor(thetas).to(mesh.device)
    B, D = thetas.shape[0], mesh.size
    if B % D != 0:
        raise ValueError(f"batch size {B} must be divisible by mesh size {D}")
    x0, y0, s0 = default_initialization(mcp, thetas, x0, y0, s0)
    group, index = mesh.groups[0], mesh.coords[0]
    local = _solve_ts(mcp, options, None, None,
                      *(_shard_rows(a, D, index) for a in (thetas, x0, y0, s0)))
    num_solved = all_reduce_sum((local.status == SOLVED).sum().to(torch.int64), group)
    return gather_result(local, group), num_solved
