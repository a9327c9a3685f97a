"""Banded (block-tridiagonal-in-time) Newton step for trajectory-game KKT
systems.

The schur-condensed n×n Newton matrix of a trajectory game is block
tridiagonal when its variables are reordered time-major: stage costs and
per-time inequality rows couple only within a time step, and dynamics-defect
duals couple adjacent steps. With T time blocks of size b the factorization
costs O(T·b³) instead of O((Tb)³).

Batch convention: the solver-path functions (``reconstruct_bands``,
``gh_banded_fast``, ``banded_newton_step_compressed``,
``block_thomas_solve``) take a leading batch axis B on every iterate-shaped
argument. ``gh_banded`` and ``build_affine_bands`` work on one instance (the
game build probes them once).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.func import jvp, vmap

from .._device import const

Tensor = torch.Tensor


class TimeStructure(NamedTuple):
    """Static time-major reordering metadata for a trajectory-game MCP.

    permutation: length-n tuple — time-major index i holds original
      unconstrained index permutation[i].
    num_blocks: T (time steps).
    block_size: b = state_total + control_total + defect-dual rows per step.
    row_permutation: optional length-m tuple — inequality rows grouped
      time-major (rows_per_block per step). When present, the schur reduction
      term Gy·diag·Hx is block-diagonal in time and assembled band-only.
    rows_per_block: m_t, uniform inequality-row count per time step.
    """

    permutation: tuple[int, ...]
    num_blocks: int
    block_size: int
    row_permutation: tuple[int, ...] | None = None
    rows_per_block: int = 0


@functools.lru_cache(maxsize=None)
def _index_arrays(structure: TimeStructure):
    """Host index maps (perm, row perm, and their inverses)."""
    perm = np.asarray(structure.permutation, dtype=np.int64)
    rperm = np.asarray(structure.row_permutation, dtype=np.int64)
    return perm, rperm, np.argsort(perm), np.argsort(rperm)


def _indices(structure: TimeStructure, device):
    """(perm, rperm, inv, rinv) as long tensors on ``device``."""
    return tuple(const(a, torch.long, device) for a in _index_arrays(structure))


@functools.lru_cache(maxsize=None)
def _eye(b: int) -> np.ndarray:
    return np.eye(b)


def block_thomas_solve(diag: Tensor, lower: Tensor, upper: Tensor, rhs: Tensor) -> Tensor:
    """Block-Thomas by per-block LU solves, batched: diag (B, T, b, b);
    lower/upper (B, T-1, b, b) (lower[t] couples block t+1 to t, upper[t]
    block t to t+1); rhs (B, T, b) → x (B, T, b). A second reference for the
    Householder sweep of kernels/thomas.py."""
    B, T, b, _ = diag.shape
    C_prev = torch.zeros_like(diag[:, 0])
    d_prev = torch.zeros_like(rhs[:, 0, :, None])
    zero = torch.zeros_like(diag[:, 0])
    Cs, ds = [], []
    for t in range(T):
        L = lower[:, t - 1] if t > 0 else zero
        U = upper[:, t] if t < T - 1 else zero
        denom = diag[:, t] - L @ C_prev
        sol = torch.linalg.solve(
            denom, torch.cat([U, rhs[:, t, :, None] - L @ d_prev], dim=2)
        )
        C_prev, d_prev = sol[..., :b], sol[..., b:]
        Cs.append(C_prev)
        ds.append(d_prev)
    xs = [None] * T
    x_next = torch.zeros_like(d_prev)
    for t in range(T - 1, -1, -1):
        x_next = ds[t] - Cs[t] @ x_next
        xs[t] = x_next[..., 0]
    return torch.stack(xs, dim=1)


@functools.lru_cache(maxsize=None)
def _colored_seeds(structure: TimeStructure, n: int, m: int) -> np.ndarray:
    """Compressed Jacobian seed matrix by 3-phase time coloring.

    The Newton step needs only the tridiagonal bands of Gx plus the
    block-diagonal Gy/Hx blocks. Columns of time blocks ≥3 apart have
    disjoint row supports, so one forward seed carries every third block's
    column: 3·b x-seeds + 3·m_t y-seeds recover every needed entry instead
    of n+m seeds.
    """
    T, b, mt = structure.num_blocks, structure.block_size, structure.rows_per_block
    perm = np.asarray(structure.permutation)
    rperm = np.asarray(structure.row_permutation)
    S = np.zeros((3 * b + 3 * mt, n + m))
    for t in range(T):
        p = t % 3
        for o in range(b):
            S[p * b + o, perm[t * b + o]] = 1.0
        for q in range(mt):
            S[3 * b + p * mt + q, n + rperm[t * mt + q]] = 1.0
    return S


def gh_banded(mcp, structure: TimeStructure, x: Tensor, y: Tensor, theta: Tensor):
    """Residual + banded Jacobian of ONE instance via colored forward seeds.

    Returns (g, h, diag, lower, upper, Gy_blocks, Hx_blocks): the
    unregularized Gx bands (T,b,b)/(T-1,b,b) and the per-time coupling
    blocks Gy (T,b,mt) / Hx (T,mt,b). No n² object is materialized.
    """
    n = mcp.unconstrained_dimension
    m = mcp.constrained_dimension
    T, b, mt = structure.num_blocks, structure.block_size, structure.rows_per_block
    perm, rperm, _, _ = _indices(structure, x.device)
    seeds = torch.as_tensor(_colored_seeds(structure, n, m), dtype=x.dtype,
                            device=x.device)

    def stacked(w):
        g, h = mcp.gh(w[:n], w[n:], theta)
        return torch.cat([g, h])

    w0 = torch.cat([x, y])
    val = stacked(w0)
    outs = vmap(lambda sd: jvp(stacked, (w0,), (sd,))[1])(seeds)  # (S, n+m)
    g, h = val[:n], val[n:]

    G_rows = outs[:, :n][:, perm].reshape(-1, T, b)  # (seed, row block, ro)
    H_rows = outs[:, n:][:, rperm].reshape(-1, T, mt)
    GX = G_rows[: 3 * b].reshape(3, b, T, b)  # (phase, col o, row block, ro)
    GY = G_rows[3 * b :].reshape(3, mt, T, b)  # (phase, q, row block, ro)
    HX = H_rows[: 3 * b].reshape(3, b, T, mt)  # (phase, col o, row block, q)

    t_idx = torch.arange(T, device=x.device)
    phases = t_idx % 3
    tu = torch.arange(T - 1, device=x.device)
    # diag(t): rows t, cols t (phase t%3) → (T, ro, co)
    diag = GX[phases, :, t_idx, :].permute(0, 2, 1)
    # upper(t): rows t, cols t+1 (phase (t+1)%3), t = 0..T-2
    upper = GX[(tu + 1) % 3, :, tu, :].permute(0, 2, 1)
    # lower(t): rows t+1, cols t (phase t%3)
    lower = GX[tu % 3, :, tu + 1, :].permute(0, 2, 1)
    # Gy block t: rows t, y-cols of block t → (T, ro, q)
    Gy_blocks = GY[phases, :, t_idx, :].permute(0, 2, 1)
    # Hx block t: H rows of block t, x-cols of block t → (T, q, co)
    Hx_blocks = HX[phases, :, t_idx, :].permute(0, 2, 1)
    return g, h, diag, lower, upper, Gy_blocks, Hx_blocks


class AffineBands(NamedTuple):
    """Exact affine decomposition of the banded Jacobian of a quadratic game.

    For quadratic trajectory games (quadratic costs, quadratic/affine
    constraints, affine dynamics; e.g. lane change) every entry of the banded
    Jacobian (diag, lower, upper, Gy, Hx) is affine in the iterate z = (x, y)
    and independent of θ:

        bands(z) = bands0 + T_x · x_blocks + T_y · y_blocks,

    with the source variables of band block t in block t. Built once at game
    build (``build_affine_bands``); each Newton iteration then costs one
    residual evaluation plus a few small contractions.

    Layouts ([t, source, out-row, out-col]); None = identically zero:
      diag_x (T, b, b, b), diag_y (T, mt, b, b)
      Gy_x (T, b, b, mt),  Gy_y (T, mt, b, mt)
      Hx_x (T, b, mt, b),  Hx_y (T, mt, mt, b)
    lower/upper are constant (validated).
    """

    diag0: Tensor
    lower0: Tensor
    upper0: Tensor
    Gy0: Tensor
    Hx0: Tensor
    diag_x: Optional[Tensor]
    diag_y: Optional[Tensor]
    Gy_x: Optional[Tensor]
    Gy_y: Optional[Tensor]
    Hx_x: Optional[Tensor]
    Hx_y: Optional[Tensor]

    def to(self, device=None, dtype=None) -> "AffineBands":
        """Every present leaf moved/cast (None leaves stay None)."""
        return AffineBands(
            *(None if a is None else a.to(device=device, dtype=dtype) for a in self)
        )


def reconstruct_bands(ab: AffineBands, structure: TimeStructure, x: Tensor, y: Tensor):
    """bands(z) = bands0 + T_x·x_blocks + T_y·y_blocks over a batch:
    x (B, n), y (B, m) → diag (B,T,b,b), lower/upper (T-1,b,b) (shared by
    every lane), Gy (B,T,b,mt), Hx (B,T,mt,b). The leaves of ``ab`` must
    already have x's dtype and device."""
    B = x.shape[0]
    T, b, mt = structure.num_blocks, structure.block_size, structure.rows_per_block
    perm, rperm, _, _ = _indices(structure, x.device)
    xb = x[:, perm].reshape(B, T, b)
    yb = y[:, rperm].reshape(B, T, mt)

    def lin(base, tx, ty):
        out = base.expand(B, *base.shape)
        if tx is not None:
            out = out + torch.einsum("zto,tors->ztrs", xb, tx)
        if ty is not None:
            out = out + torch.einsum("ztq,tqrs->ztrs", yb, ty)
        return out

    diag = lin(ab.diag0, ab.diag_x, ab.diag_y)
    Gy = lin(ab.Gy0, ab.Gy_x, ab.Gy_y)
    Hx = lin(ab.Hx0, ab.Hx_x, ab.Hx_y)
    return diag, ab.lower0, ab.upper0, Gy, Hx


def gh_banded_fast(
    mcp, structure: TimeStructure, x: Tensor, y: Tensor, theta: Tensor,
    affine_bands: Optional[AffineBands] = None,
):
    """Batched residual + bands: one vmapped residual evaluation plus
    ``reconstruct_bands`` when the MCP carries an affine decomposition
    (``affine_bands`` overrides ``mcp.affine_bands``, e.g. with leaves
    already cast to the iterate dtype), else the colored-seed linearize of
    every lane. Returns (g, h, diag, lower, upper, Gy, Hx)."""
    ab = affine_bands if affine_bands is not None else mcp.affine_bands
    if ab is None:
        return vmap(functools.partial(gh_banded, mcp, structure))(x, y, theta)
    g, h = mcp.gh_batched(x, y, theta)
    return (g, h) + reconstruct_bands(ab, structure, x, y)


def build_affine_bands(
    mcp,
    structure: TimeStructure,
    theta_dim: int,
    *,
    dtype=torch.float64,
    rtol: float | None = None,
    max_bytes: int = 32 * 2**20,
) -> Optional[AffineBands]:
    """Probe whether the banded Jacobian is affine in z and θ-independent;
    if so, materialize its AffineBands decomposition (on the CPU, once per
    game build). Returns None when any probe fails: non-quadratic games keep
    the per-iteration colored-seed path.

    Probes (numeric):
      1. curvature:      bands(2z) - 2·bands(z) + bands(0) ≈ 0
      2. θ-independence: bands(z; θ₁) ≈ bands(z; θ₂)
      3. reconstruction: bands0 + tensors·z ≈ bands(z) at a fresh point
      4. lower/upper linear parts ≈ 0 (affine dynamics)
    Any non-finite probe value fails.

    rtol defaults to near-probe-noise for an exact decomposition: 1e-8 in
    float64, 1e-5 in float32. max_bytes caps the attached tensor size.
    """
    if structure.row_permutation is None:
        return None
    if rtol is None:
        rtol = 1e-8 if dtype == torch.float64 else 1e-5
    n = mcp.unconstrained_dimension
    m = mcp.constrained_dimension
    T, b, mt = structure.num_blocks, structure.block_size, structure.rows_per_block

    def bands_of(z, th):
        return gh_banded(mcp, structure, z[:n], z[n:], th)[2:]

    gen = torch.Generator().manual_seed(7)
    th0 = torch.randn(theta_dim, generator=gen, dtype=dtype)
    th1 = 1.0 + torch.randn(theta_dim, generator=gen, dtype=dtype)
    z1 = torch.randn(n + m, generator=gen, dtype=dtype)
    z2 = 0.5 + torch.randn(n + m, generator=gen, dtype=dtype)
    zeros = torch.zeros(n + m, dtype=dtype)

    def np_tree(t):
        return tuple(a.detach().numpy() for a in t)

    B0 = np_tree(bands_of(zeros, th0))
    B1 = np_tree(bands_of(z1, th0))
    B2 = np_tree(bands_of(2.0 * z1, th0))
    B1b = np_tree(bands_of(z1, th1))

    def allfinite(*trees):
        return all(np.all(np.isfinite(a)) for t in trees for a in t)

    if not allfinite(B0, B1, B2, B1b):
        return None
    tol = rtol * max(1.0, max(np.max(np.abs(a)) for a in B1))

    def maxdiff(A, B):
        return max(np.max(np.abs(a - c)) for a, c in zip(A, B))

    curvature = maxdiff(B2, tuple(2.0 * a - c for a, c in zip(B1, B0)))
    if curvature > tol or maxdiff(B1, B1b) > tol:
        return None

    itemsize = torch.empty((), dtype=dtype).element_size()
    est_attached = sum((b + mt) * a.size for a in B0) * itemsize
    if est_attached > max_bytes:
        import warnings

        warnings.warn(
            f"affine-bands decomposition skipped: estimated attached size "
            f"{est_attached / 2**20:.0f} MiB exceeds max_bytes="
            f"{max_bytes / 2**20:.0f} MiB (T={T}, b={b}, m_t={mt}); "
            "keeping the per-iteration colored-seed linearize.",
            stacklevel=2,
        )
        return None

    seeds = torch.as_tensor(_colored_seeds(structure, n, m), dtype=dtype)
    cols = np_tree(
        vmap(lambda sd: jvp(lambda z: bands_of(z, th0), (zeros,), (sd,))[1])(seeds)
    )
    if not allfinite(cols):
        return None
    c_diag, c_lower, c_upper, c_Gy, c_Hx = cols
    if max(np.max(np.abs(c_lower)), np.max(np.abs(c_upper)), 0.0) > tol:
        return None  # cross-time quadratic coupling: not supported

    t_idx = np.arange(T)
    ph = t_idx % 3

    def same_block(c):
        # c: (3b+3mt, T, r, s) — keep only the same-block (phase-matched)
        # derivatives: x-part (T, b, r, s) and y-part (T, mt, r, s).
        cx = c[: 3 * b].reshape(3, b, T, *c.shape[2:])
        cy = c[3 * b :].reshape(3, mt, T, *c.shape[2:])
        X = cx[ph, :, t_idx]
        Y = cy[ph, :, t_idx]
        return (
            torch.tensor(np.ascontiguousarray(X), dtype=dtype) if np.any(X) else None,
            torch.tensor(np.ascontiguousarray(Y), dtype=dtype) if np.any(Y) else None,
        )

    diag_x, diag_y = same_block(c_diag)
    Gy_x, Gy_y = same_block(c_Gy)
    Hx_x, Hx_y = same_block(c_Hx)
    ab = AffineBands(
        *(torch.tensor(np.ascontiguousarray(a), dtype=dtype) for a in B0),
        diag_x=diag_x, diag_y=diag_y,
        Gy_x=Gy_x, Gy_y=Gy_y,
        Hx_x=Hx_x, Hx_y=Hx_y,
    )

    # Final end-to-end check at a fresh point (catches aliasing too).
    diag, lower, upper, Gy, Hx = reconstruct_bands(
        ab, structure, z2[None, :n], z2[None, n:]
    )
    rec = np_tree((diag[0], lower, upper, Gy[0], Hx[0]))
    ref = np_tree(bands_of(z2, th1))
    # `not (… <= tol)` so a NaN in either side fails.
    if not allfinite(rec, ref) or not (maxdiff(rec, ref) <= tol):
        return None
    return ab


def banded_newton_step_compressed(
    diag, lower, upper, Gy_blocks, Hx_blocks,
    y, s, rG, rH, rC, reg, structure: TimeStructure, *, algorithm="thomas",
):
    """Schur-condensed Newton step entirely in banded form, over a batch.

    diag (B,T,b,b); lower/upper (T-1,b,b) shared by every lane, or
    (B,T-1,b,b); Gy (B,T,b,mt); Hx (B,T,mt,b); y, s, rH, rC (B, m); rG (B, n).
    ``algorithm`` is a callable (diag, lower, upper, rhs) → x with the
    batched layout of kernels/thomas.thomas_solve, or "thomas" for the
    LU-based ``block_thomas_solve``. Returns (dx, dy, ds) in the original
    variable order.
    """
    B = y.shape[0]
    T, b, mt = structure.num_blocks, structure.block_size, structure.rows_per_block
    perm, rperm, inv, rinv = _indices(structure, y.device)
    dtype = diag.dtype

    d = 1.0 / (y + reg)
    w = reg + d * s
    b2 = -rH - d * rC

    w_blocks = w[:, rperm].reshape(B, T, mt)
    b2_blocks = b2[:, rperm].reshape(B, T, mt)
    rC_blocks = rC[:, rperm].reshape(B, T, mt)
    s_blocks = s[:, rperm].reshape(B, T, mt)
    d_blocks = d[:, rperm].reshape(B, T, mt)

    inv_w = 1.0 / w_blocks
    A_diag = (
        diag
        + reg * const(_eye(b), dtype, y.device)
        - (Gy_blocks * inv_w[:, :, None, :]) @ Hx_blocks
    )
    rhs = -rG[:, perm].reshape(B, T, b) - (
        Gy_blocks @ (b2_blocks * inv_w)[..., None]
    )[..., 0]

    lower, upper = lower.contiguous(), upper.contiguous()
    if lower.dim() == 3:  # one band shared by every lane
        lower = lower.expand(B, *lower.shape)
        upper = upper.expand(B, *upper.shape)
    solver = block_thomas_solve if algorithm == "thomas" else algorithm
    dx_blocks = solver(A_diag.contiguous(), lower, upper, rhs.contiguous())  # (B, T, b)

    dy_blocks = (b2_blocks - (Hx_blocks @ dx_blocks[..., None])[..., 0]) / w_blocks
    ds_blocks = -(rC_blocks + s_blocks * dy_blocks) * d_blocks

    dx = dx_blocks.reshape(B, -1)[:, inv]
    dy = dy_blocks.reshape(B, -1)[:, rinv]
    ds = ds_blocks.reshape(B, -1)[:, rinv]
    return dx, dy, ds
