"""TrajectoryGame → ParametricGame (MCP) compilation.

Per-player discounted stage-cost objectives; shared equalities = initial-state
pin + dynamics defects; shared inequalities = coupling + polygon environment
+ control box + state box, in the same stacking order as the JAX package so
residuals compare entry by entry.

The build runs its numeric probes (bandwidth check, row assignment, affine
bands) on the CPU in float64, once; only the attached affine bands move to
the game's device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.func import vmap

from .._device import resolve_device
from ..games import OptimizationProblem, ParametricGame
from .costs import TrajectoryGame
from .environment import box_constraint_fn
from .packing import trajectory_blocking, unpack_parameters, unpack_trajectory


def build_objectives(game: TrajectoryGame, horizon: int):
    """Per-player objective closures over the flat joint primal."""
    N = game.num_players
    gamma = game.cost.discount_factor

    def make_objective(i):
        stage_cost = game.cost.stage_costs[i]

        def objective(taus, theta_i):
            trajs = unpack_trajectory(taus, dynamics=game.dynamics, horizon=horizon)
            xs = tuple(t.xs for t in trajs)  # each (T, sd_i)
            us = tuple(t.us for t in trajs)
            ts = torch.arange(horizon, device=theta_i.device)
            per_stage = vmap(
                lambda x_t, u_t, t: stage_cost(x_t, u_t, t, theta_i)
            )(xs, us, ts)
            discount = gamma ** ts.to(per_stage.dtype)
            return game.cost.reducer(discount * per_stage)

        return objective

    return [make_objective(i) for i in range(N)]


def build_shared_equality(game: TrajectoryGame, horizon: int):
    """Initial-state pin + dynamics defects. Row order: joint initial-state
    residual, then per time step the joint defect x_t − f(x_{t−1}, u_{t−1})."""

    def shared_equality(taus, thetas):
        trajs = unpack_trajectory(taus, dynamics=game.dynamics, horizon=horizon)
        X = torch.cat([t.xs for t in trajs], dim=1)  # (T, sd_total)
        U = torch.cat([t.us for t in trajs], dim=1)  # (T, cd_total)
        initial_blocks, _ = unpack_parameters(thetas, dynamics=game.dynamics)
        g1 = X[0] - torch.cat(initial_blocks)
        g2 = (X[1:] - game.dynamics(X[:-1], U[:-1])).reshape(-1)
        return torch.cat([g1, g2])

    return shared_equality


def build_shared_inequality(game: TrajectoryGame, horizon: int):
    """Coupling + environment + control box + state box rows."""
    dynamics = game.dynamics
    control_box = box_constraint_fn(*dynamics.control_bounds)
    state_box = box_constraint_fn(*dynamics.state_bounds)
    env = game.env

    def shared_inequality(taus, thetas):
        trajs = unpack_trajectory(taus, dynamics=game.dynamics, horizon=horizon)
        xs = tuple(t.xs for t in trajs)
        us = tuple(t.us for t in trajs)
        X = torch.cat(xs, dim=1)  # (T, sd_total)
        U = torch.cat(us, dim=1)

        parts = []
        if game.coupling_constraints is not None:
            parts.append(game.coupling_constraints(xs, us, thetas).reshape(-1))
        if env is not None:
            # Per time, per player, per polygon edge.
            parts.append(
                torch.cat(
                    [
                        env.position_constraints(blk[:, :2])
                        for blk in dynamics.state_blocking.split(X)
                    ],
                    dim=1,
                ).reshape(-1)
            )
        if control_box.num_constraints:
            parts.append(control_box(U).reshape(-1))
        if state_box.num_constraints:
            parts.append(state_box(X).reshape(-1))
        if not parts:
            return torch.zeros((0,), dtype=X.dtype, device=X.device)
        return torch.cat(parts)

    return shared_inequality


def build_time_structure(game: TrajectoryGame, horizon: int):
    """Time-major permutation of the unconstrained variables [τ; λ̃].

    Block t gathers [x_{i,t} ∀i; u_{i,t} ∀i; λ̃ rows of step t] where λ̃
    block 0 is the initial-state pin and block t≥1 the dynamics defect at t.
    Stage costs and per-time inequality rows couple only within a block and
    defect duals couple adjacent blocks, so the schur-condensed Newton matrix
    is block tridiagonal in this ordering.
    """
    from ..kernels.block_tridiag import TimeStructure

    dynamics = game.dynamics
    N = dynamics.num_players
    sd = [dynamics.state_dim(i) for i in range(N)]
    cd = [dynamics.control_dim(i) for i in range(N)]
    sd_total, cd_total = sum(sd), sum(cd)
    T = horizon
    b = sd_total + cd_total + sd_total

    player_offsets = np.cumsum([0] + [T * (sd[i] + cd[i]) for i in range(N)])
    nx = int(player_offsets[-1])

    perm = []
    for t in range(T):
        for i in range(N):  # states at t
            base = player_offsets[i] + t * sd[i]
            perm.extend(range(base, base + sd[i]))
        for i in range(N):  # controls at t
            base = player_offsets[i] + T * sd[i] + t * cd[i]
            perm.extend(range(base, base + cd[i]))
        # λ̃ rows for step t (initial pin at t=0, defect t otherwise)
        base = nx + t * sd_total
        perm.extend(range(base, base + sd_total))
    return TimeStructure(
        permutation=tuple(int(i) for i in perm), num_blocks=T, block_size=b
    )


def _probe_point(pg: ParametricGame, seed: int):
    """A pseudo-random float64 CPU point (x, y, s, θ) for build probes."""
    mcp = pg.mcp
    n, m = mcp.unconstrained_dimension, mcp.constrained_dimension
    gen = torch.Generator().manual_seed(seed)
    f64 = torch.float64
    x = 0.1 * torch.randn(n, generator=gen, dtype=f64)
    y = 1.0 + 0.1 * torch.rand(m, generator=gen, dtype=f64)
    s = 1.0 + 0.1 * torch.rand(m, generator=gen, dtype=f64)
    theta = 0.1 * torch.randn(sum(pg.dims.theta), generator=gen, dtype=f64)
    return x, y, s, theta


def build_row_time_structure(pg: ParametricGame, structure):
    """Assign each inequality row to a time block by the numeric support of
    its Hx row and Gy column at a pseudo-random point. Rows with empty
    support are distributed to balance block counts. Returns
    (row_permutation, rows_per_block) or None when rows straddle blocks or
    counts cannot be made uniform."""
    mcp = pg.mcp
    n, m = mcp.unconstrained_dimension, mcp.constrained_dimension
    T, b = structure.num_blocks, structure.block_size
    x, y, _, theta = _probe_point(pg, 1)
    _, _, _, Gy, Hx, _ = (a.numpy() for a in mcp.gh_linearized(x, y, theta))

    blk_of_col = np.empty(n, dtype=np.int64)
    blk_of_col[np.asarray(structure.permutation)] = np.arange(n) // b

    tol = 1e-10
    assignment = np.full(m, -1, dtype=np.int64)
    for r in range(m):
        support = np.flatnonzero((np.abs(Hx[r]) > tol) | (np.abs(Gy[:, r]) > tol))
        if support.size == 0:
            continue  # constant row; fill later
        blocks = np.unique(blk_of_col[support])
        if blocks.size > 1:
            return None
        assignment[r] = blocks[0]

    counts = np.bincount(assignment[assignment >= 0], minlength=T)
    free_rows = np.flatnonzero(assignment < 0)
    if counts.max() * T > m:
        return None
    mt = m // T
    if m % T != 0 or counts.max() > mt:
        return None
    fi = 0
    for t in range(T):
        need = mt - counts[t]
        assignment[free_rows[fi : fi + need]] = t
        fi += need
    if fi != free_rows.size:
        return None

    row_perm = np.concatenate([np.flatnonzero(assignment == t) for t in range(T)])
    return tuple(int(i) for i in row_perm), int(mt)


def _schur_system(Gx, Gy, Hx, y, s, rG, rH, rC, reg):
    """The doubly-condensed n×n Newton system (valid when Hy ≡ 0)."""
    n = rG.shape[0]
    d = 1.0 / (y + reg)
    w = reg + d * s
    b2 = -rH - d * rC
    A = Gx + reg * torch.eye(n, dtype=Gx.dtype) - (Gy / w[None, :]) @ Hx
    b = -rG - Gy @ (b2 / w)
    return A, b, b2, w, d


def validate_time_structure(pg: ParametricGame, structure) -> float:
    """One-time numeric bandwidth check: the max |off-tridiagonal| entry of
    the schur matrix at a pseudo-random point."""
    x, y, s, theta = _probe_point(pg, 0)
    g, h, Gx, Gy, Hx, _ = pg.mcp.gh_linearized(x, y, theta)
    A, *_ = _schur_system(Gx, Gy, Hx, y, s, g, h - s, s * y - 0.1, 1e-4)
    perm = np.asarray(structure.permutation)
    A_perm = A.numpy()[perm][:, perm]
    T, b = structure.num_blocks, structure.block_size
    A4 = A_perm.reshape(T, b, T, b).transpose(0, 2, 1, 3)  # (T, T, b, b)
    mask = np.abs(np.arange(T)[:, None] - np.arange(T)[None, :]) > 1
    return float(np.max(np.abs(A4[mask])) if mask.any() else 0.0)


def build_parametric_game(
    *,
    game: TrajectoryGame,
    horizon: int = 10,
    params_per_player: int = 0,  # not counting the initial state, always a param
    compute_sensitivities: bool = True,
    time_structure: bool = True,
    affine_bands: bool = True,
    device="cuda",
) -> ParametricGame:
    """Compile a TrajectoryGame into a ParametricGame/MCP.

    With ``time_structure`` (default) the time-major block-tridiagonal
    reordering of the Newton system is computed, validated numerically and
    attached to the MCP (the banded Newton tier needs it). With
    ``affine_bands`` (default), when the banded Jacobian probes as affine in
    the iterate and θ-independent (quadratic games such as lane change), its
    exact decomposition is attached too, as float64 tensors on ``device``.
    """
    device = resolve_device(device)
    dynamics = game.dynamics
    N = game.num_players
    primal_blocking = trajectory_blocking(dynamics, horizon)
    problems = [OptimizationProblem(objective=f) for f in build_objectives(game, horizon)]

    f64 = torch.float64
    pg = ParametricGame.create(
        test_point=[torch.zeros(s, dtype=f64) for s in primal_blocking.sizes],
        test_parameter=[
            torch.zeros(dynamics.state_dim(i) + params_per_player, dtype=f64)
            for i in range(N)
        ],
        problems=problems,
        shared_equality=build_shared_equality(game, horizon),
        shared_inequality=build_shared_inequality(game, horizon),
        compute_sensitivities=compute_sensitivities,
    )
    if not time_structure:
        return pg
    structure = build_time_structure(game, horizon)
    if len(structure.permutation) != pg.mcp.unconstrained_dimension:
        return pg
    if validate_time_structure(pg, structure) >= 1e-8:
        return pg
    rows = build_row_time_structure(pg, structure)
    if rows is not None:
        structure = structure._replace(row_permutation=rows[0], rows_per_block=rows[1])
    mcp = dataclasses.replace(pg.mcp, time_structure=structure)
    if affine_bands and structure.row_permutation is not None:
        from ..kernels.block_tridiag import build_affine_bands

        ab = build_affine_bands(mcp, structure, sum(pg.dims.theta))
        if ab is not None:
            mcp = dataclasses.replace(mcp, affine_bands=ab.to(device=device))
    return dataclasses.replace(pg, mcp=mcp)
