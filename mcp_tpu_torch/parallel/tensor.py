"""Tensor parallelism: one Newton factorization sharded over the ranks of a
``"tp"`` axis, the JAX package's ``parallel/tensor.py`` over
``torch.distributed``.

A distributed right-looking blocked LU with partial pivoting, the ScaLAPACK
layout:

* The (n, n) matrix is block-COLUMN-sharded: rank d holds the contiguous
  column slab ``A[:, d·C:(d+1)·C]`` (C = n/D); the right-hand side is
  replicated. n is padded with an identity tail to a multiple of D·nb, so
  that every panel of nb columns lies on one rank.
* Per panel: its owner broadcasts it (the JAX package sums a one-hot
  contribution over the axis, which gives the same values); every rank
  factors the active rows (≥ the panel's offset) with partial pivoting,
  updates the right-hand side, and applies the row permutation and the
  rank-nb update to its own trailing columns.
* Back-substitution keeps x replicated: each block row's inner products
  against later columns are taken where those columns live and
  all-reduced; the diagonal block is broadcast like a panel.

Every function is batch-first: a leading lane axis B rides along, one
factorization per lane. The JAX package slices the active rows by rolling
the panel and zeroing the finished rows, because XLA needs fixed shapes;
here they are sliced, with the same pivots and the same result.

``TPNewtonBackend`` plugs this into the interior-point loop as
``newton_solver`` (``solver.ip_solve``, ``diff._solve_ts``): the condensed
(n+m) system, assembled replicated, solved sharded; its ``ift_solve`` and
``ift_solve_t`` shard the condensed IFT's core solves. ``solve_single_tp``
is the user entry: one game, every Newton factorization sharded,
differentiable in θ. The interior-point loop runs replicated on every rank,
so every rank of the axis must make the same calls in the same order; ranks
that share a card exchange over gloo, through host memory.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..diff import _solve_ts
from ..linalg import _condensed_matrix
from ..mcp import PrimalDualMCP
from ..solver import SolverOptions, default_initialization
from ..types import SolveResult
from .mesh import TP_AXIS, Mesh, all_reduce_sum, broadcast, make_tp_mesh

Tensor = torch.Tensor


def padded_dimension(n: int, num_devices: int, panel: int) -> int:
    """Smallest n' ≥ n with n' a multiple of num_devices·panel (so every
    panel lives entirely on one rank's contiguous column slab)."""
    q = num_devices * panel
    return -(-n // q) * q


def _lu_permutation(P: Tensor) -> Tensor:
    """The row order of ``torch.linalg.lu``'s P (A = P L U): row i of L U is
    row perm[i] of A, the permutation ``lax.linalg.lu`` returns."""
    return P.argmax(dim=-2)


def _rows(a: Tensor, perm: Tensor) -> Tensor:
    """a (B, r, ·) with its rows taken in the order perm (B, r)."""
    return torch.take_along_dim(a, perm[..., None], dim=1)


def lu_solve_tp_local(A_loc: Tensor, b: Tensor, *, mesh: Mesh, axis_name: str = TP_AXIS,
                      panel: int = 64) -> Tensor:
    """Solve A x = b with A block-column-sharded over the ``axis_name`` ranks
    of ``mesh``; every rank of the axis calls it.

    A_loc: (B, n, C) this rank's contiguous column slab, C = n/D; n must be
      a multiple of D·panel (pad with an identity tail, see ``lu_solve_tp``).
      A must be nonsingular (the IP Newton matrix is regularized); the
      pivoting is partial.
    b: (B, n) the replicated right-hand side.
    Returns x: (B, n), replicated.
    """
    group, idx = mesh.group(axis_name), mesh.index(axis_name)
    D = mesh.axis_size(axis_name)
    Bn, n, C = A_loc.shape
    nb = panel
    if C * D != n or C % nb != 0:
        raise ValueError(f"column slab {C}x{D} ranks must tile n={n} in whole {nb}-column panels")
    col0 = idx * C
    A_loc, b = A_loc.clone(), b.clone()
    for p in range(n // nb):
        j0 = p * nb
        owner, local = divmod(j0, C)
        pl = broadcast(A_loc[:, :, local:local + nb] if idx == owner
                       else A_loc.new_empty((Bn, n, nb)), owner, group)
        # Pivoted LU of the active rows (≥ j0).
        P, L, U11 = torch.linalg.lu(pl[:, j0:])
        perm = _lu_permutation(P)
        L11, L21 = L[:, :nb], L[:, nb:]
        # Replicated right-hand side update.
        brp = _rows(b[:, j0:, None], perm)
        y1 = torch.linalg.solve_triangular(L11, brp[:, :nb], upper=False, unitriangular=True)
        b[:, j0:] = torch.cat([y1, brp[:, nb:] - L21 @ y1], dim=1)[..., 0]
        # Trailing update of this slab's columns right of the panel.
        t0 = max(0, min(C, j0 + nb - col0))
        if t0 < C:
            Ar = _rows(A_loc[:, j0:, t0:], perm)
            U12 = torch.linalg.solve_triangular(L11, Ar[:, :nb], upper=False, unitriangular=True)
            A_loc[:, j0:, t0:] = torch.cat([U12, Ar[:, nb:] - L21 @ U12], dim=1)
        if idx == owner:
            # The panel becomes U: earlier U rows stay, the diagonal block is
            # U11, eliminated rows are 0 (back-substitution reads U rows).
            A_loc[:, j0:j0 + nb, local:local + nb] = U11
            A_loc[:, j0 + nb:, local:local + nb] = 0.0
    # Back-substitution: x replicated; each block row's inner products with
    # later columns where those columns live, all-reduced.
    x = torch.zeros_like(b)
    cols = torch.arange(col0, col0 + C, device=A_loc.device)
    for p in reversed(range(n // nb)):
        j0 = p * nb
        owner, local = divmod(j0, C)
        U11 = broadcast(A_loc[:, j0:j0 + nb, local:local + nb] if idx == owner
                        else A_loc.new_empty((Bn, nb, nb)), owner, group)
        later = torch.where(cols >= j0 + nb, x[:, col0:col0 + C], torch.zeros_like(x[:, :C]))
        c = all_reduce_sum((A_loc[:, j0:j0 + nb] @ later[..., None])[..., 0], group)
        x[:, j0:j0 + nb] = torch.linalg.solve_triangular(
            U11, (b[:, j0:j0 + nb] - c)[..., None], upper=True)[..., 0]
    return x


def _embed_padded(A: Tensor, b: Tensor, n_pad: int):
    """Embed (B, n, n) A into an n_pad identity-extended system (the tail
    decouples: x_pad[n:] = 0)."""
    n = A.shape[-1]
    if n_pad == n:
        return A, b
    A_pad = torch.eye(n_pad, dtype=A.dtype, device=A.device).repeat(A.shape[0], 1, 1)
    A_pad[:, :n, :n] = A
    return A_pad, torch.cat([b, b.new_zeros((b.shape[0], n_pad - n))], dim=1)


def _sharded_solve(A: Tensor, rhs: Tensor, mesh: Mesh, axis_name: str, panel: int) -> Tensor:
    """The replicated (B, k, k) system solved by ``lu_solve_tp_local`` on
    this rank's column slab; the replicated (B, k) solution."""
    k = A.shape[-1]
    D = mesh.axis_size(axis_name)
    A_pad, rhs_pad = _embed_padded(A, rhs, padded_dimension(k, D, panel))
    C = A_pad.shape[-1] // D
    i = mesh.index(axis_name)
    return lu_solve_tp_local(A_pad[:, :, i * C:(i + 1) * C], rhs_pad, mesh=mesh,
                             axis_name=axis_name, panel=panel)[:, :k]


def lu_solve_tp(A: Tensor, b: Tensor, *, mesh: Optional[Mesh] = None,
                axis_name: str = TP_AXIS, panel: int = 64) -> Tensor:
    """Solve the dense system A x = b ((n, n) and (n,), or a batch (B, n, n)
    and (B, n)) with the factorization sharded over the mesh's ranks. Every
    rank calls it with the same A and b and gets x; A is padded to whole
    panels per rank and x unpadded."""
    if mesh is None:
        mesh = make_tp_mesh(axis_name=axis_name)
    A = torch.as_tensor(A).to(mesh.device)
    b = torch.as_tensor(b).to(mesh.device)
    if A.dim() == 2:
        return _sharded_solve(A[None], b[None], mesh, axis_name, panel)[0]
    return _sharded_solve(A, b, mesh, axis_name, panel)


class TPNewtonBackend:
    """``newton_solver`` backend of ``solver.ip_solve`` / ``diff._solve_ts``:
    every rank of the mesh's ``axis_name`` axis calls it with the same
    operands.

    As a callable it is the Newton step: the condensed (n+m) system
    (``linalg.newton_step_condensed``'s), assembled replicated, solved by the
    column-sharded LU. ``ift_solve``/``ift_solve_t`` shard the condensed
    IFT's core solves (``diff._ift_operators``), so the backward pass rides
    the same ranks as the forward."""

    def __init__(self, mesh: Mesh, *, axis_name: str = TP_AXIS, panel: int = 64):
        self.mesh = mesh
        self.axis_name = axis_name
        self.panel = panel

    def _solve(self, A: Tensor, rhs: Tensor) -> Tensor:
        return _sharded_solve(A, rhs, self.mesh, self.axis_name, self.panel)

    def __call__(self, Gx, Gy, Hx, Hy, y, s, rG, rH, rC, reg):
        n = rG.shape[1]
        A, d = _condensed_matrix(Gx, Gy, Hx, Hy, y, s, reg)
        dxy = self._solve(A, torch.cat([-rG, -rH - d * rC], dim=1))
        dx, dy = dxy[:, :n], dxy[:, n:]
        return dx, dy, -(rC + s * dy) * d

    def ift_solve(self, A: Tensor, rhs: Tensor) -> Tensor:
        return self._solve(A, rhs)

    def ift_solve_t(self, A: Tensor, rhs: Tensor) -> Tensor:
        return self._solve(A.mT, rhs)


def make_newton_step_condensed_tp(*, mesh: Mesh, axis_name: str = TP_AXIS,
                                  panel: int = 64) -> TPNewtonBackend:
    """The callable backend over ``mesh`` (the JAX package's factory)."""
    return TPNewtonBackend(mesh, axis_name=axis_name, panel=panel)


def solve_single_tp(
    mcp: PrimalDualMCP,
    theta: Tensor,
    *,
    mesh: Optional[Mesh] = None,
    axis_name: str = TP_AXIS,
    panel: int = 64,
    x0: Optional[Tensor] = None,
    y0: Optional[Tensor] = None,
    s0: Optional[Tensor] = None,
    options: Optional[SolverOptions] = None,
    **option_overrides,
) -> SolveResult:
    """Interior-point solve of ONE game (θ (p,)) with every Newton
    factorization tensor-parallel over the mesh's ranks (default: a
    ``make_tp_mesh`` over every rank, on the card).

    The condensed (n+m) system (exact against the dense tier); the loop runs
    replicated on every rank in lockstep, and only the factorizations are
    sharded. ``algorithm="ip"`` only. Differentiable in θ (the IFT); with
    ``sensitivity_solver="condensed"`` on an ``assume_hy_zero`` MCP the
    backward core solves are sharded too. θ and the warm starts move to the
    mesh's device; the result has no batch axis."""
    if options is None:
        options = SolverOptions(**option_overrides)
    elif option_overrides:
        options = dataclasses.replace(options, **option_overrides)
    if options.linear_solver not in ("condensed", "dense"):
        raise ValueError(
            "solve_single_tp shards the condensed Newton system; pass "
            "linear_solver='condensed' (default) or 'dense'"
        )
    if mesh is None:
        mesh = make_tp_mesh(axis_name=axis_name)
    theta = torch.as_tensor(theta).to(mesh.device)
    to = lambda v: None if v is None else torch.as_tensor(v).to(mesh.device)
    x0, y0, s0 = default_initialization(mcp, theta, to(x0), to(y0), to(s0))
    step = make_newton_step_condensed_tp(mesh=mesh, axis_name=axis_name, panel=panel)
    res = _solve_ts(mcp, options, None, step, theta[None], x0[None], y0[None], s0[None])
    return SolveResult(*(f[0] for f in res))
