"""Newton-step linear solvers of the dense tiers, batch-first.

The Newton system of the interior-point iteration is ``(∇F_z + reg·I) δ =
-(rG, rH, rC)`` with

        ┌ Gx   Gy    0 ┐
  ∇F_z =│ Hx   Hy   -I │        rows: [G; H - s; s∘y - ϵ]
        └  0    S    Y ┘        cols: [x; y; s]

Every function here takes a batch: Gx (B,n,n), Gy (B,n,m), Hx (B,m,n),
Hy (B,m,m), y, s (B,m), rG (B,n), rH, rC (B,m) → dx (B,n), dy, ds (B,m).

Tiers:
  * "dense": the full (n+2m) system, batched LU (``torch.linalg``).
  * "condensed": δs eliminated through the diagonal third block row; an
    (n+m) system, batched LU.
  * "schur": valid when Hy ≡ 0 (every KKT-stacked MCP); a second exact
    elimination leaves the n×n Schur system
        (Gx + tI − Gy·diag(1/w)·Hx) δx = −rG + Gy·((rH + d·rC)/w),
        d = 1/(y+t), w = t + d·s,
    solved by batched LU.
  * "schur_pallas": the Schur system by the Householder-QR kernels
    (``kernels.linear_solve.gauss_solve``: K4b/K4c on a batch, K8a on a
    single system).
  * "schur_pallas_gj": by the no-pivot Gauss–Jordan kernel (K4a,
    ``gj_solve``); SPD Schur matrices only (convex QPs).
  * "schur_pallas_gjr": by the Gauss–Jordan solve-and-inverse kernel (K5,
    ``gji_solve``) plus one refinement with A⁻¹ against the true matrix.

  * "gmres": the Schur system by restarted GMRES (``newton_step_gmres``),
    lane by lane what ``jax.scipy.sparse.linalg.gmres(...,
    solve_method="batched")`` does under the JAX package's vmap.

The LU tiers use ``torch.linalg`` as the JAX package leaves them to XLA; the
Schur product (Gy/w)·Hx is a plain batched matmul, and so are GMRES's
matvecs and projections (the JAX package runs them outside any kernel).
``newton_step_tridiag`` is the banded tiers' step on an MCP whose Jacobian
is linearized densely (no row time structure).
"""

from __future__ import annotations

import torch

from .kernels.block_tridiag import banded_newton_step, tridiag_solve_permuted
from .kernels.linear_solve import gauss_solve, gj_solve, gji_solve

Tensor = torch.Tensor

def _mv(A: Tensor, v: Tensor) -> Tensor:
    """Batched matrix-vector product: A (B,r,c), v (B,c) → (B,r)."""
    return (A @ v[..., None])[..., 0]


def _eye(k: int, like: Tensor) -> Tensor:
    return torch.eye(k, dtype=like.dtype, device=like.device)


def assemble_dense_jacobian(Gx, Gy, Hx, Hy, y, s) -> Tensor:
    """∇F_z (unregularized), (B, n+2m, n+2m)."""
    B, n, m = Gx.shape[0], Gx.shape[1], Hy.shape[1]
    zero_nm = Gx.new_zeros((B, n, m))
    zero_mn = Gx.new_zeros((B, m, n))
    minus_eye = (-_eye(m, Gx)).expand(B, m, m)
    return torch.cat(
        [
            torch.cat([Gx, Gy, zero_nm], dim=2),
            torch.cat([Hx, Hy, minus_eye], dim=2),
            torch.cat([zero_mn, torch.diag_embed(s), torch.diag_embed(y)], dim=2),
        ],
        dim=1,
    )


def _condensed_matrix(Gx, Gy, Hx, Hy, y, s, reg):
    n, m = Gx.shape[1], Hy.shape[1]
    d = 1.0 / (y + reg)
    A = torch.cat(
        [
            torch.cat([Gx + reg * _eye(n, Gx), Gy], dim=2),
            torch.cat([Hx, Hy + reg * _eye(m, Gx) + torch.diag_embed(d * s)], dim=2),
        ],
        dim=1,
    )
    return A, d


def newton_step_dense(Gx, Gy, Hx, Hy, y, s, rG, rH, rC, reg):
    """Full-system Newton step with ``∇F + reg·I``, batched LU."""
    n, m = rG.shape[1], rH.shape[1]
    A = assemble_dense_jacobian(Gx, Gy, Hx, Hy, y, s) + reg * _eye(n + 2 * m, Gx)
    dz = torch.linalg.solve(A, -torch.cat([rG, rH, rC], dim=1)[..., None])[..., 0]
    return dz[:, :n], dz[:, n : n + m], dz[:, n + m :]


def newton_step_condensed(Gx, Gy, Hx, Hy, y, s, rG, rH, rC, reg):
    """δs-eliminated Newton step on the (n+m) system; exact against the
    dense tier."""
    n = rG.shape[1]
    A, d = _condensed_matrix(Gx, Gy, Hx, Hy, y, s, reg)
    b = torch.cat([-rG, -rH - d * rC], dim=1)
    dxy = torch.linalg.solve(A, b[..., None])[..., 0]
    dx, dy = dxy[:, :n], dxy[:, n:]
    return dx, dy, -(rC + s * dy) * d


def _schur_matrix(Gx, Gy, Hx, y, s, reg):
    """(A, w, d) of the n×n Schur system; A is contiguous."""
    d = 1.0 / (y + reg)
    w = reg + d * s
    A = Gx + reg * _eye(Gx.shape[1], Gx) - (Gy / w[:, None, :]) @ Hx
    return A.contiguous(), w, d


def _schur_system(Gx, Gy, Hx, y, s, rG, rH, rC, reg):
    """The doubly-condensed n×n system (see newton_step_schur):
    (A, b, b2, w, d), A and b contiguous."""
    A, w, d = _schur_matrix(Gx, Gy, Hx, y, s, reg)
    b2 = -rH - d * rC
    b = -rG - _mv(Gy, b2 / w)
    return A, b.contiguous(), b2, w, d


def _schur_recover(dx, Hx, b2, w, d, s, rC):
    dy = (b2 - _mv(Hx, dx)) / w
    ds = -(rC + s * dy) * d
    return dx, dy, ds


def newton_step_schur(Gx, Gy, Hx, Hy, y, s, rG, rH, rC, reg):
    """Doubly-condensed Newton step on the n×n Schur system, batched LU.
    Valid when Hy ≡ 0 (``schur_assumption_violation`` checks it):

        (Gx + tI − Gy·diag(1/w)·Hx) δx = −rG + Gy·((rH + d·rC)/w)
        δy = (−rH − d·rC − Hx δx)/w
        δs = −(rC + s∘δy)·d,          d = 1/(y+t), w = t + d·s.
    """
    A, b, b2, w, d = _schur_system(Gx, Gy, Hx, y, s, rG, rH, rC, reg)
    dx = torch.linalg.solve(A, b[..., None])[..., 0]
    return _schur_recover(dx, Hx, b2, w, d, s, rC)


def newton_step_schur_pallas(Gx, Gy, Hx, Hy, y, s, rG, rH, rC, reg):
    """Schur step with the n×n solve by the Householder-QR kernel (K4b/K4c)."""
    A, b, b2, w, d = _schur_system(Gx, Gy, Hx, y, s, rG, rH, rC, reg)
    return _schur_recover(gauss_solve(A, b), Hx, b2, w, d, s, rC)


def newton_step_schur_pallas_gj(Gx, Gy, Hx, Hy, y, s, rG, rH, rC, reg):
    """Schur step with the n×n solve by the no-pivot Gauss–Jordan kernel
    (K4a): valid only when the Schur matrix is SPD (convex QPs, A = M + tI
    + AᵀDA); game (nonsymmetric) systems keep the QR tier."""
    A, b, b2, w, d = _schur_system(Gx, Gy, Hx, y, s, rG, rH, rC, reg)
    return _schur_recover(gj_solve(A, b), Hx, b2, w, d, s, rC)


def newton_step_schur_pallas_gjr(Gx, Gy, Hx, Hy, y, s, rG, rH, rC, reg):
    """Schur step by the Gauss–Jordan solve-and-inverse kernel (K5) plus one
    refinement matvec pair against the true Schur matrix, dx = x0 +
    A⁻¹(b − A·x0). SPD Schur matrices only. This direct path starts from the
    kernel's elimination solve, so it certifies; the factored variant
    (Mehrotra) applies A⁻¹ alone, whose residual floors at cond(A)·ε·‖b‖."""
    A, b, b2, w, d = _schur_system(Gx, Gy, Hx, y, s, rG, rH, rC, reg)
    dx0, Ainv = gji_solve(A, b)
    dx = dx0 + _mv(Ainv, b - _mv(A, dx0))
    return _schur_recover(dx, Hx, b2, w, d, s, rC)


def _safe_normalize(v: Tensor, thresh=None):
    """(v/‖v‖, ‖v‖) per lane of v (B, k), both 0 where ‖v‖ ≤ ``thresh``
    (a scalar or (B,); default the dtype's ε): jax.scipy's
    ``_safe_normalize``."""
    norm = torch.sqrt((v * v).sum(dim=1))
    if thresh is None:
        thresh = torch.finfo(v.dtype).eps
    use = norm > thresh
    unit = torch.where(use[:, None], v / norm[:, None], torch.zeros_like(v))
    return unit, torch.where(use, norm, torch.zeros_like(norm))


def _gmres_restart(matvec, M, b, x0, unit_r, r_norm, restart):
    """One restart of jax.scipy's batched GMRES (``_gmres_batched``) on every
    lane: ``restart`` Arnoldi steps on M(A(·)) from the unit residual, then
    the least-squares solve of the Hessenberg system through its normal
    equations. A lane whose new Krylov vector vanishes (breakdown) stops:
    its later steps are computed and discarded, as a vmapped while loop
    discards them. Returns (x, unit residual, residual norm), the residual
    preconditioned."""
    B, n = b.shape
    eps = torch.finfo(b.dtype).eps
    V = b.new_zeros((B, n, restart + 1))
    V[:, :, 0] = unit_r
    # H starts as the identity's rows, so that rows a breakdown leaves
    # unused keep the normal equations nonsingular.
    H = torch.eye(restart, restart + 1, dtype=b.dtype, device=b.device).repeat(B, 1, 1)
    broken = torch.zeros(B, dtype=torch.bool, device=b.device)
    for k in range(restart):
        v = M(matvec(V[:, :, k]))
        _, v_norm0 = _safe_normalize(v)
        # Classical Gram–Schmidt against every column (the unset ones are
        # 0). jax.scipy's "twice is enough" loop makes one pass: its second
        # pass runs only while k < max_iterations − 1, and its first pass
        # leaves k = 1 = max_iterations − 1.
        h = (v[:, None, :] @ V)[:, 0]
        v = v - _mv(V, h)
        unit_v, v_norm1 = _safe_normalize(v, eps * v_norm0)
        h[:, k + 1] = v_norm1
        keep = ~broken[:, None]
        V[:, :, k + 1] = torch.where(keep, unit_v, V[:, :, k + 1])
        H[:, k, :] = torch.where(keep, h, H[:, k, :])
        broken = broken | (v_norm1 == 0)
    beta = b.new_zeros((B, restart + 1))
    beta[:, 0] = r_norm
    # jax.scipy's _lstsq: (H Hᵀ) y = H β by Cholesky; a factorization that
    # fails gives NaN, as XLA's Cholesky does.
    L, info = torch.linalg.cholesky_ex(H @ H.mT)
    y = torch.cholesky_solve(_mv(H, beta)[..., None], L)[..., 0]
    y = torch.where((info == 0)[:, None], y, torch.full_like(y, torch.nan))
    x = x0 + _mv(V[:, :, :-1], y)
    unit_r, r_norm = _safe_normalize(M(b - matvec(x)))
    return x, unit_r, r_norm


def _gmres_inner(A, b, *, tol, restart, maxiter, preconditioner):
    """Restarted GMRES on every lane of A (B,n,n) x = b (B,n), from x = 0:
    per lane ``jax.scipy.sparse.linalg.gmres(A, b, tol=tol,
    restart=min(n, restart), maxiter=maxiter, M=M, solve_method="batched")``.
    A lane stops once its preconditioned residual ‖M(b − A x)‖ ≤ tol·‖b‖,
    or after ``maxiter`` restarts. ``preconditioner`` "jacobi" takes
    M = diag(A)⁻¹ (|A_ii| ≤ 1e-30 read as 1), applied on the LEFT as
    jax.scipy applies M: the Krylov vectors are M(A(v)); "none" takes M = I."""
    if preconditioner == "jacobi":
        dA = torch.diagonal(A, dim1=-2, dim2=-1)
        dinv = 1.0 / torch.where(dA.abs() > 1e-30, dA, torch.ones_like(dA))
        M = lambda v: dinv * v
    elif preconditioner == "none":
        M = lambda v: v
    else:
        raise ValueError(f"unknown gmres preconditioner {preconditioner!r}")
    matvec = lambda v: _mv(A, v)
    restart = min(b.shape[1], restart)
    atol = tol * torch.sqrt((b * b).sum(dim=1))
    x = torch.zeros_like(b)
    unit_r, r_norm = _safe_normalize(M(b))  # the residual at x = 0
    live = r_norm > atol
    for _ in range(maxiter):
        if not bool(live.any()):
            break
        xn, un, rn = _gmres_restart(matvec, M, b, x, unit_r, r_norm, restart)
        lv = live[:, None]
        x, unit_r = torch.where(lv, xn, x), torch.where(lv, un, unit_r)
        r_norm = torch.where(live, rn, r_norm)
        live = live & (r_norm > atol)
    return x


def newton_step_gmres(Gx, Gy, Hx, Hy, y, s, rG, rH, rC, reg, *, tol: float = 1e-8,
                      restart: int = 50, maxiter: int = 5, preconditioner: str = "none"):
    """Schur step with the n×n system solved by restarted GMRES (the
    reference's KrylovJL_GMRES tier); tol, restart, maxiter and the
    preconditioner are the ``gmres_*`` fields of ``SolverOptions``."""
    A, b, b2, w, d = _schur_system(Gx, Gy, Hx, y, s, rG, rH, rC, reg)
    dx = _gmres_inner(A, b, tol=tol, restart=restart, maxiter=maxiter,
                      preconditioner=preconditioner)
    return _schur_recover(dx, Hx, b2, w, d, s, rC)


def newton_step_tridiag(Gx, Gy, Hx, Hy, y, s, rG, rH, rC, reg, *, structure,
                        algorithm=None):
    """Schur step solved by the time-major block-tridiagonal solve
    ``algorithm`` (diag, lower, upper, rhs) → x, "thomas" or "cr" (default
    the plain LU block-Thomas), from dense Jacobians. With a row time
    structure (``row_permutation``) the Schur system is assembled band by
    band (``block_tridiag.banded_newton_step``); without one the dense n×n
    Schur system is permuted to time-major bands
    (``block_tridiag.tridiag_solve_permuted``). No solver path reaches the
    banded branch: the solver calls this only without ``row_permutation``,
    and with one its banded tiers linearize band by band
    (``banded_newton_step_compressed``). The branch is the counterpart of
    the JAX package's public function."""
    if structure.row_permutation is not None:
        return banded_newton_step(Gx, Gy, Hx, y, s, rG, rH, rC, reg, structure,
                                  algorithm=algorithm)
    A, b, b2, w, d = _schur_system(Gx, Gy, Hx, y, s, rG, rH, rC, reg)
    dx = tridiag_solve_permuted(A, b, structure, algorithm=algorithm)
    return _schur_recover(dx, Hx, b2, w, d, s, rC)


def factored_newton_solver(tier: str):
    """Factor-once / solve-many variant of the Newton tiers, for algorithms
    that solve the same KKT matrix against several right-hand sides at one
    iterate (Mehrotra's predictor and corrector, iterative refinement).

    Returns ``make(Gx, Gy, Hx, Hy, y, s, reg) -> solve_f`` where
    ``solve_f(bG, bH, bC) -> (dx, dy, ds)`` solves ``(∇F_z + reg·I) δ =
    -(bG, bH, bC)``. LU tiers factor once and back-substitute per call; the
    kernel tiers and GMRES re-solve per call, except "schur_pallas_gjr",
    which applies one explicit inverse with one refinement pass per call.
    The Schur tiers' ``make`` takes ``gmres_options`` (the keywords of
    ``newton_step_gmres``; default its defaults) for "gmres"."""
    if tier == "dense":

        def make(Gx, Gy, Hx, Hy, y, s, reg):
            n, m = Gx.shape[1], Hy.shape[1]
            A = assemble_dense_jacobian(Gx, Gy, Hx, Hy, y, s) + reg * _eye(n + 2 * m, Gx)
            LU, piv = torch.linalg.lu_factor(A)

            def solve_f(bG, bH, bC):
                rhs = -torch.cat([bG, bH, bC], dim=1)[..., None]
                dz = torch.linalg.lu_solve(LU, piv, rhs)[..., 0]
                return dz[:, :n], dz[:, n : n + m], dz[:, n + m :]

            return solve_f

    elif tier == "condensed":

        def make(Gx, Gy, Hx, Hy, y, s, reg):
            n = Gx.shape[1]
            A, d = _condensed_matrix(Gx, Gy, Hx, Hy, y, s, reg)
            LU, piv = torch.linalg.lu_factor(A)

            def solve_f(bG, bH, bC):
                rhs = torch.cat([-bG, -bH - d * bC], dim=1)[..., None]
                dxy = torch.linalg.lu_solve(LU, piv, rhs)[..., 0]
                dx, dy = dxy[:, :n], dxy[:, n:]
                return dx, dy, -(bC + s * dy) * d

            return solve_f

    elif tier in ("schur", "schur_pallas", "schur_pallas_gj", "schur_pallas_gjr", "gmres"):

        def make(Gx, Gy, Hx, Hy, y, s, reg, gmres_options=None):
            A, w, d = _schur_matrix(Gx, Gy, Hx, y, s, reg)
            if tier == "schur":
                LU, piv = torch.linalg.lu_factor(A)
                inner = lambda b: torch.linalg.lu_solve(LU, piv, b[..., None])[..., 0]
            elif tier == "schur_pallas":
                inner = lambda b: gauss_solve(A, b.contiguous())
            elif tier == "schur_pallas_gj":
                inner = lambda b: gj_solve(A, b.contiguous())
            elif tier == "schur_pallas_gjr":
                # One elimination serves every solve at this iterate: each
                # is a matvec with A⁻¹ plus one refinement matvec pair.
                _, Ainv = gji_solve(A, A.new_zeros(A.shape[:2]))

                def inner(b):
                    x0 = _mv(Ainv, b)
                    return x0 + _mv(Ainv, b - _mv(A, x0))

            else:
                kw = gmres_options or dict(tol=1e-8, restart=50, maxiter=5,
                                           preconditioner="none")
                inner = lambda b: _gmres_inner(A, b, **kw)

            def solve_f(bG, bH, bC):
                b2 = -bH - d * bC
                dx = inner(-bG - _mv(Gy, b2 / w))
                return _schur_recover(dx, Hx, b2, w, d, s, bC)

            return solve_f

    else:
        raise ValueError(f"no factored solver for tier {tier!r}")

    return make


def schur_assumption_violation(mcp, x, y, theta) -> float:
    """Max |∂H/∂y| at one instance (x (n,), y (m,), θ (p,)): it must be 0
    for the Schur tiers to be exact."""
    from torch.func import jacfwd

    Hy = jacfwd(lambda yy: mcp.H(x, yy, theta))(y)
    return float(Hy.abs().max()) if Hy.numel() else 0.0


NEWTON_STEPS = {
    "dense": newton_step_dense,
    "condensed": newton_step_condensed,
    "schur": newton_step_schur,
    "schur_pallas": newton_step_schur_pallas,
    "schur_pallas_gj": newton_step_schur_pallas_gj,
    "schur_pallas_gjr": newton_step_schur_pallas_gjr,
    "gmres": newton_step_gmres,
}


def solve_unregularized(Jz: Tensor, B: Tensor) -> Tensor:
    """Solve ∇F_z X = B (no regularization), batched LU."""
    return torch.linalg.solve(Jz, B)
