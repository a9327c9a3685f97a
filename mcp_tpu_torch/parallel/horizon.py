"""Horizon-sharded block-tridiagonal solves over a process mesh: the JAX
package's ``parallel/horizon.py`` (SPIKE, the partitioned Schur complement)
over ``torch.distributed``.

A game too long for one card is split into D contiguous time slabs of
T/D blocks, one per rank of the mesh's horizon axis:

  1. each rank solves its slab against 1 + 2b right-hand sides
     [r | e₀⊗L_bound | e_last⊗U_bound] with one multi-right-hand-side
     block-Thomas sweep (K6 on a card, ``block_thomas_solve_multi`` on the
     CPU): x_loc = v − W_L·x_lastᵈ⁻¹ − W_R·x_firstᵈ⁺¹
     (``spike_local_solve``);
  2. the first and last rows of that identity give a reduced
     block-tridiagonal system in the 2b interface unknowns wᵈ = [x_firstᵈ;
     x_lastᵈ], D blocks instead of T; the six (b, ·) interface quantities
     (the first and last block rows of the local solution) are gathered
     over the axis, the only exchange, and every rank solves the reduced
     system by the plain LU block-Thomas (``spike_reduced_solve``), as the
     JAX package does outside any kernel;
  3. each rank back-substitutes with its neighbours' interface values
     (``spike_back_substitute``), and one more gather assembles x.

The three stages are plain functions on tensors, so the algebra runs for any
D in one process; ``_spike_replicated`` wraps them with the collectives.
Every function is batch-first: the batch axis B of the solver's Newton
systems rides along, one SPIKE per lane.

The interior-point loop runs replicated on every rank of the axis (iterates
are O(T·b), the band assembly O(T·b²)); each block-tridiagonal solve of the
Newton steps and of the IFT goes through ``_spike_replicated`` (the solver's
``tridiag_solver`` override). Every rank of an axis must therefore make the
same calls in the same order: ranks that share a card run the collectives
over gloo, through host memory.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.distributed as dist

from ..diff import _solve_ts
from ..kernels.block_tridiag import block_thomas_solve, block_thomas_solve_multi
from ..kernels.thomas_multi import thomas_solve_multi
from ..solver import BANDED_SOLVERS, default_initialization
from ..types import SolveResult
from .batch import _options as batch_options
from .mesh import Mesh, all_gather, gather_result, make_mesh

Tensor = torch.Tensor

HORIZON_AXIS = "horizon"


def _local_multi_solve(diag, lower, upper, R):
    """The SPIKE local multi-right-hand-side slab solve: K6 on a card, the
    plain LU block-Thomas on the CPU (where the JAX package runs its XLA
    slab)."""
    if diag.device.type == "cuda":
        return thomas_solve_multi(diag, lower, upper, R)
    return block_thomas_solve_multi(diag, lower, upper, R)


def spike_local_operands(diag, lower_int, L_bound, upper_int, U_bound, rhs):
    """Stage 1's multi-right-hand-side system on one slab: diag (B, Tl, b, b),
    lower_int/upper_int (B, Tl−1, b, b), L_bound/U_bound (B, b, b) (the
    couplings to the neighbouring slabs, zero at the ends), rhs (B, Tl, b) →
    (diag, lower_int, upper_int, R), R (B, Tl, b, 1+2b) = [r | e₀⊗L_bound |
    e_last⊗U_bound]."""
    B, Tl, b, _ = diag.shape
    R = diag.new_zeros((B, Tl, b, 1 + 2 * b))
    R[..., 0] = rhs
    R[:, 0, :, 1 : 1 + b] = L_bound
    R[:, Tl - 1, :, 1 + b :] = U_bound
    return diag, lower_int, upper_int, R


def spike_local_solve(diag, lower_int, L_bound, upper_int, U_bound, rhs):
    """Stage 1 on one slab (``spike_local_operands``'s arguments) → X (B, Tl,
    b, 1+2b) = [v | W_L | W_R]. The interface quantities are X[:, (0, −1)]."""
    return _local_multi_solve(*spike_local_operands(diag, lower_int, L_bound, upper_int,
                                                    U_bound, rhs))


def spike_reduced_solve(iface: Tensor) -> Tensor:
    """Stage 2: the interface quantities of every slab, iface (D, B, 2, b,
    1+2b) (``spike_local_solve``'s X[:, (0, −1)] stacked in slab order) →
    w (B, D, 2b), wᵈ = [x_firstᵈ; x_lastᵈ], from the reduced system

        wᵈ + [0 W_Lᶠ; 0 W_Lˡ]ᵈ wᵈ⁻¹ + [W_Rᶠ 0; W_Rˡ 0]ᵈ wᵈ⁺¹ = [vᶠ; vˡ]ᵈ

    (the edge slabs' W_L/W_R vanish with their zero boundary couplings)."""
    D, B, _, b, _ = iface.shape
    f, l = iface[:, :, 0].transpose(0, 1), iface[:, :, 1].transpose(0, 1)  # (B, D, b, k)
    v_f, WL_f, WR_f = f[..., 0], f[..., 1 : 1 + b], f[..., 1 + b :]
    v_l, WL_l, WR_l = l[..., 0], l[..., 1 : 1 + b], l[..., 1 + b :]
    zero = iface.new_zeros((B, D - 1, b, b))
    lower_r = torch.cat([torch.cat([zero, WL_f[:, 1:]], dim=3),
                         torch.cat([zero, WL_l[:, 1:]], dim=3)], dim=2)
    upper_r = torch.cat([torch.cat([WR_f[:, :-1], zero], dim=3),
                         torch.cat([WR_l[:, :-1], zero], dim=3)], dim=2)
    eye = torch.eye(2 * b, dtype=iface.dtype, device=iface.device).expand(B, D, 2 * b, 2 * b)
    return block_thomas_solve(eye, lower_r, upper_r, torch.cat([v_f, v_l], dim=2))


def spike_back_substitute(X: Tensor, w: Tensor, d: int) -> Tensor:
    """Stage 3 on slab d: X (B, Tl, b, 1+2b) of stage 1 and w (B, D, 2b) of
    stage 2 → the slab's x (B, Tl, b) = v − W_L·x_lastᵈ⁻¹ − W_R·x_firstᵈ⁺¹
    (the clamped neighbour indices meet zero W at the ends)."""
    b = X.shape[2]
    D = w.shape[1]
    x_prev_last = w[:, max(d - 1, 0), b:]
    x_next_first = w[:, min(d + 1, D - 1), :b]
    v, WL, WR = X[..., 0], X[..., 1 : 1 + b], X[..., 1 + b :]
    return (v - (WL @ x_prev_last[:, None, :, None])[..., 0]
            - (WR @ x_next_first[:, None, :, None])[..., 0])


def _slab(diag, lower, upper, rhs, d: int, D: int):
    """Slab d of D of a (B, T, b, b) system as stage 1's operands (views;
    lower/upper may be bands expanded over the batch)."""
    T = diag.shape[1]
    Tl = T // D
    t0 = d * Tl
    zero = diag.new_zeros((diag.shape[0], diag.shape[2], diag.shape[3]))
    L_bound = lower[:, t0 - 1] if d > 0 else zero
    U_bound = upper[:, t0 + Tl - 1] if d < D - 1 else zero
    return (diag[:, t0 : t0 + Tl], lower[:, t0 : t0 + Tl - 1], L_bound,
            upper[:, t0 : t0 + Tl - 1], U_bound, rhs[:, t0 : t0 + Tl])


def spike_solve(diag, lower, upper, rhs, *, num_slabs: int):
    """The SPIKE algebra with every slab in this process: diag (B, T, b, b),
    lower/upper (B, T−1, b, b), rhs (B, T, b) → x (B, T, b). The one-process
    reference of ``_spike_replicated`` (same stages, same kernels, no
    exchange); T must be a multiple of ``num_slabs``."""
    B, T, b, _ = diag.shape
    lower, upper = (a.expand(B, *a.shape[1:]) for a in (lower, upper))
    Xs = [spike_local_solve(*_slab(diag, lower, upper, rhs, d, num_slabs))
          for d in range(num_slabs)]
    w = spike_reduced_solve(torch.stack([X[:, [0, X.shape[1] - 1]] for X in Xs]))
    return torch.cat([spike_back_substitute(X, w, d) for d, X in enumerate(Xs)], dim=1)


def _spike_replicated(diag, lower, upper, rhs, *, group, index: int, num_devices: int):
    """The SPIKE solve of a batch of systems that every rank of ``group``
    holds whole: diag (B, T, b, b), lower/upper (B, T−1, b, b), rhs (B, T, b)
    → x (B, T, b) on every rank, this rank working on slab ``index``. The
    ``tridiag_solver`` of the horizon-sharded interior-point solves."""
    B, T, b, _ = diag.shape
    D = num_devices
    X = spike_local_solve(*_slab(diag, lower, upper, rhs, index, D))
    iface = all_gather(X[:, [0, X.shape[1] - 1]], group)
    w = spike_reduced_solve(iface)
    x_loc = spike_back_substitute(X, w, index)
    return all_gather(x_loc, group).transpose(0, 1).reshape(B, T, b)


def make_horizon_mesh(*, axis_name: str = HORIZON_AXIS, device="cuda") -> Mesh:
    """1-D mesh over every rank of the default group for horizon-parallel
    solving."""
    return make_mesh((dist.get_world_size(),), (axis_name,), device=device)


def make_dp_horizon_mesh(dp: int, horizon: int, *, batch_axis: str = "dp",
                         axis_name: str = HORIZON_AXIS, device="cuda") -> Mesh:
    """2-D (dp, horizon) mesh: batch-parallel teams of horizon-parallel
    ranks. The horizon axis is minor, so each team holds contiguous ranks."""
    world = dist.get_world_size()
    if dp * horizon != world:
        raise ValueError(f"mesh shape ({dp}, {horizon}) needs {dp * horizon} devices, "
                         f"got {world}")
    return make_mesh((dp, horizon), (batch_axis, axis_name), device=device)


def horizon_solver(mesh: Mesh, axis_name: str = HORIZON_AXIS):
    """This rank's SPIKE solve over the mesh's ``axis_name``: a callable
    (diag, lower, upper, rhs) → x for the solver's ``tridiag_solver``."""
    return functools.partial(_spike_replicated, group=mesh.group(axis_name),
                             index=mesh.index(axis_name),
                             num_devices=mesh.axis_size(axis_name))


def _options(options, overrides):
    """The JAX package's default here: tier "tridiag" when no options are
    given."""
    return batch_options(options, overrides if options else {"linear_solver": "tridiag",
                                                              **overrides})


def _validate(mcp, options, D: int, who: str, axis_words: str = "the mesh size"):
    if options.linear_solver not in BANDED_SOLVERS:
        raise ValueError(f"{who} requires a tridiag-family linear_solver")
    ts = mcp.time_structure
    if ts is None:
        raise ValueError("MCP has no time_structure (not a trajectory game)")
    T = ts.num_blocks
    if T % D != 0 or T // D < 2:
        raise ValueError(f"horizon {T} must be a multiple of {axis_words} {D} "
                         "with at least 2 blocks per device")


def _maybe_batch(fn, theta, x0, y0, s0) -> SolveResult:
    """Solve one instance (θ (p,)) as a batch of one, or a batch as it is."""
    if theta.dim() == 1:
        res = fn(theta[None], x0[None], y0[None], s0[None])
        return SolveResult(*(f[0] for f in res))
    return fn(theta, x0, y0, s0)


def horizon_sharded_solve_fn(mcp, *, mesh: Optional[Mesh] = None,
                             axis_name: str = HORIZON_AXIS, options=None, **option_overrides):
    """The differentiable horizon-sharded solve ``(θ, x0, y0, s0) ->
    SolveResult`` (θ (p,) or (B, p), on the mesh's device): the Newton
    factorizations and, through the IFT, the sensitivity solves (set
    ``sensitivity_solver="tridiag"`` to keep them banded) run SPIKE over the
    mesh's ``axis_name``. Same validation as ``solve_horizon_sharded``."""
    options = _options(options, option_overrides)
    if mesh is None:
        mesh = make_horizon_mesh(axis_name=axis_name)
    _validate(mcp, options, mesh.axis_size(axis_name), "solve_horizon_sharded")
    solver = horizon_solver(mesh, axis_name)

    def fn(theta, x0, y0, s0):
        return _maybe_batch(
            lambda t, x, y, s: _solve_ts(mcp, options, solver, None, t, x, y, s),
            theta, x0, y0, s0)

    return fn


def solve_horizon_sharded(mcp, theta, *, mesh: Optional[Mesh] = None,
                          axis_name: str = HORIZON_AXIS, x0=None, y0=None, s0=None,
                          options=None, **option_overrides) -> SolveResult:
    """Interior-point solve of one large trajectory-game MCP (θ (p,)), or of
    a batch (θ (B, p)), with the horizon of every Newton factorization
    sharded over the mesh (SPIKE; see the module docstring). Every rank
    passes the same θ and warm starts and gets the whole result. Requires a
    tridiag-family ``linear_solver`` and T divisible by the mesh size with
    T/D ≥ 2."""
    options = _options(options, option_overrides)
    if mesh is None:
        mesh = make_horizon_mesh(axis_name=axis_name)
    _validate(mcp, options, mesh.axis_size(axis_name), "solve_horizon_sharded")
    theta = torch.as_tensor(theta).to(mesh.device)
    x0, y0, s0 = default_initialization(mcp, theta, x0, y0, s0)
    return horizon_sharded_solve_fn(mcp, mesh=mesh, axis_name=axis_name,
                                    options=options)(theta, x0, y0, s0)


def solve_batch_horizon_sharded(mcp, thetas, *, mesh: Mesh, batch_axis: str = "dp",
                                axis_name: str = HORIZON_AXIS, x0=None, y0=None, s0=None,
                                options=None, **option_overrides) -> SolveResult:
    """Composed dp × horizon solve: a batch θ (B, p) sharded over
    ``batch_axis`` while every lane's Newton factorizations are
    horizon-sharded over ``axis_name`` (a mesh from
    ``make_dp_horizon_mesh``). B must be divisible by the dp size, the game
    horizon by the horizon-axis size with ≥ 2 blocks per rank. Every rank
    passes the global batch and gets the global result."""
    options = _options(options, option_overrides)
    _validate(mcp, options, mesh.axis_size(axis_name), "solve_batch_horizon_sharded",
              "the horizon-axis size")
    thetas = torch.as_tensor(thetas).to(mesh.device)
    B, dp = thetas.shape[0], mesh.axis_size(batch_axis)
    if B % dp != 0:
        raise ValueError(f"batch size {B} must be divisible by dp size {dp}")
    x0, y0, s0 = default_initialization(mcp, thetas, x0, y0, s0)
    rows = B // dp
    i = mesh.index(batch_axis)
    local = _solve_ts(mcp, options, horizon_solver(mesh, axis_name), None,
                      *(a[i * rows:(i + 1) * rows] for a in (thetas, x0, y0, s0)))
    return gather_result(local, mesh.group(batch_axis))


def horizon_sharded_tridiag_solve(diag: Tensor, lower: Tensor, upper: Tensor, rhs: Tensor, *,
                                  mesh: Optional[Mesh] = None,
                                  axis_name: str = HORIZON_AXIS) -> Tensor:
    """Distributed solve of a block-tridiagonal system that every rank holds
    whole: diag (T, b, b), lower/upper (T−1, b, b), rhs (T, b) → x (T, b),
    or the same with a leading batch axis, with the T axis sharded in
    contiguous slabs over the mesh. Requires T divisible by the mesh size
    with T/D ≥ 2. Numerically the plain block-Thomas solve's result."""
    if mesh is None:
        mesh = make_horizon_mesh(axis_name=axis_name)
    D = mesh.axis_size(axis_name)
    single = diag.dim() == 3
    if single:
        diag, lower, upper, rhs = (a[None] for a in (diag, lower, upper, rhs))
    T = diag.shape[1]
    if T % D != 0 or T // D < 2:
        raise ValueError(f"horizon length {T} must be a multiple of the mesh size {D} "
                         "with at least 2 blocks per device")
    x = horizon_solver(mesh, axis_name)(diag, lower, upper, rhs)
    return x[0] if single else x
