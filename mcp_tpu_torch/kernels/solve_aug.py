"""The in-block augmented solves ("facts") of the banded kernels, in plain
PyTorch: the single home of every fact's plain version.

``solve_aug_plain(M, b, fact)`` takes M (S, b, nc) and returns X (S, b, nc − b)
with M[:, :, :b]·X = M[:, :, b:]: the JAX package's ``_solve_aug``
(``mcp_tpu/kernels/thomas_pallas.py:431``), which the one-way sweep K1′, the
two-way sweep K7a and cyclic reduction K3 run on every block. The facts:

* ``"qr"``: pivot-free Householder QR and back substitution (``_qr_solve_aug``);
* ``"gj"``: pivot-free Gauss–Jordan, row k the pivot of column k, no
  unscramble (``_gj_solve_aug``);
* ``"gjp"``: Gauss–Jordan with implicit partial pivoting, the largest |entry|
  among unused rows (lowest row on ties, used rows scored −1), rows
  unscrambled by one contraction with the eliminated head (``_gjp_solve_aug``);
* ``"gjpr"``: gjp on [M | I], which also yields A⁻¹, then one refinement step
  X += A⁻¹(N − A·X) (``_gjpr_solve_aug``);
* ``"gjb"``, ``"gjbr"``, ``"gjbr2"``: pivot-free Gauss–Jordan blocked in
  panels of ``GJB_PANEL`` columns, with 0, 1 or 2 refinement steps against
  the inverse of [M | I] (``_gjb_solve_aug``);
* ``"gjbp"``, ``"gjbpr"``, ``"gjbpr2"``, ``"gjbprl"``: the same blocking with
  gjp's pivot sequence (``_gjbp_solve_aug``); ``"gjbprl"`` is gjbpr's algebra
  (the JAX package's loop-traced variant of it);
* ``"lu"`` (plain version only): ``torch.linalg.solve``, the per-block LU of
  tier "tridiag_cr".

Every fact clamps a Gauss–Jordan pivot of magnitude ≤ 1e-30 to 1e-30 and
keeps the JAX package's update forms, so that each rounds as the JAX
function does: the blocked facts update the pivot row as
``slab[r] + (1/piv − 1)·slab[r]``, not ``slab[r]/piv``. The pivoted facts
extract the pivot row and unscramble with one-hot contractions, as the JAX
package does: for finite entries a one-hot contraction is the gather of the
pivot row, but a non-finite entry in another row makes it NaN (0·inf).
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor

#: Panel width of the blocked facts (the JAX package's ``GJB_PANEL``).
GJB_PANEL = 32
_EPS = 1e-30

#: Every fact the kernels take, and the (family, refinement steps) the CUDA
#: sources read: 0 qr, 1 gj, 2 gjp, 3 gjb, 4 gjbp (``csrc/solve_aug.cuh``).
FACT_CODES = {
    "qr": (0, 0), "gj": (1, 0), "gjp": (2, 0), "gjpr": (2, 1),
    "gjb": (3, 0), "gjbr": (3, 1), "gjbr2": (3, 2),
    "gjbp": (4, 0), "gjbpr": (4, 1), "gjbpr2": (4, 2), "gjbprl": (4, 1),
}
FACTS = tuple(FACT_CODES)
#: Shared memory one block may use on an H100 (232,448 bytes).
SMEM_LIMIT = 232448


def aug_smem_bytes(b: int, ld: int, family: int, chunk: int, itemsize: int) -> int:
    """Shared-memory bytes of one working set of ``csrc/solve_aug.cuh``
    (``aug_bytes``): M (b×ld), three vectors, W's pivot row, four scalars,
    the panel W (b×GJB_PANEL, blocked families), a b×chunk scratch slab and
    the pivot rows (ints, blocked pivoted family)."""
    elems = (b * ld + 2 * b + ld + GJB_PANEL + 4 + (b * GJB_PANEL if family >= 3 else 0)
             + b * chunk)
    return itemsize * elems + (4 * b if family == 4 else 0)


def _clamped_inverse(piv: Tensor) -> Tensor:
    return 1.0 / torch.where(piv.abs() > _EPS, piv, torch.full_like(piv, _EPS))


def qr_solve_aug_plain(M: Tensor, b: int) -> Tensor:
    """Pivot-free Householder QR of M[:, :, :b] applied to all of M, then back
    substitution (the algebra of ``_qr_solve_aug``). A zero pivot gives
    inf/NaN."""
    rows = torch.arange(b, device=M.device)
    for k in range(b):
        below = (rows >= k).to(M.dtype)
        pivot = (rows == k).to(M.dtype)
        v = M[:, :, k] * below  # (S, b)
        vk = v[:, k : k + 1]
        norm = torch.sqrt((v * v).sum(dim=1, keepdim=True) + _EPS)
        sign = torch.where(vk >= 0, 1.0, -1.0).to(M.dtype)
        u = v + (sign * norm) * pivot
        beta = 1.0 / (norm * (norm + vk.abs()) + _EPS)
        w = (u[:, None, :] @ M)[:, 0, :]  # (S, nc)
        M = M - (beta * u)[:, :, None] * w[:, None, :]
    xs = [None] * b
    for k in range(b - 1, -1, -1):
        acc = M[:, k, b:]
        if k < b - 1:
            acc = acc - (M[:, k : k + 1, k + 1 : b] @ torch.stack(xs[k + 1 :], dim=1))[:, 0]
        xs[k] = acc / M[:, k, k : k + 1]
    return torch.stack(xs, dim=1)


def gj_solve_aug_plain(M: Tensor, b: int) -> Tensor:
    """Pivot-free Gauss–Jordan: per column k, every other row loses
    (M[i, k]/piv)·row_k and row k is scaled by 1/piv."""
    rows = torch.arange(b, device=M.device)[None, :, None]
    for k in range(b):
        row_k = M[:, k : k + 1, :]  # (S, 1, nc)
        inv = _clamped_inverse(row_k[:, :, k : k + 1])
        factors = M[:, :, k : k + 1] * inv
        M = torch.where(rows == k, row_k * inv, M - factors * row_k)
    return M[:, :, b:]


def gjp_solve_aug_plain(M: Tensor, b: int) -> Tensor:
    """Gauss–Jordan with implicit partial pivoting; the rows come out in pivot
    order and one contraction with the eliminated head unscrambles them. A
    NaN in the pivot column leaves the step without a pivot (no row is
    scaled, the clamped 1/1e-30 multiplies the column)."""
    M, _ = _gjp_elimination(M, b)
    # After full Jordan elimination the head is the pivot permutation: row
    # p_k holds e_k, so X[k] = Σ_j head[j, k]·M[j, b:].
    return M[:, :, :b].transpose(1, 2) @ M[:, :, b:]


def _gjp_elimination(M: Tensor, b: int) -> tuple[Tensor, Tensor]:
    """gjp's elimination: the eliminated M and the pivot row of each column
    (S, b), b where a column had no pivot."""
    S, _, nc = M.shape
    rows = torch.arange(b, device=M.device)
    rows_f = rows.to(M.dtype)
    ar = torch.arange(S, device=M.device)
    used = M.new_zeros((S, b))
    pivots = []
    for k in range(b):
        col = M[:, :, k]
        score = col.abs() * (1.0 - used) - used
        top = score.amax(dim=1, keepdim=True)  # NaN propagates: no pivot then
        first = torch.where(score == top, rows_f, float(b)).amin(dim=1).long()
        has = (first < b)[:, None]
        prow = torch.where(has, M[ar, first.clamp(max=b - 1)], torch.zeros_like(M[:, 0]))
        inv = _clamped_inverse(prow[:, k])
        f = col * inv[:, None]
        onehot = rows[None, :] == first[:, None]
        M = torch.where(
            onehot[:, :, None],
            (prow * inv[:, None])[:, None, :],
            M - f[:, :, None] * prow[:, None, :],
        )
        used = used + onehot.to(M.dtype)
        pivots.append(first)
    return M, torch.stack(pivots, dim=1)


def _with_identity(M: Tensor, b: int) -> Tensor:
    eye = torch.eye(b, dtype=M.dtype, device=M.device).expand(M.shape[0], b, b)
    return torch.cat([M, eye], dim=2)


def _refine(X: Tensor, Ainv: Tensor, M: Tensor, b: int, steps: int) -> Tensor:
    """``steps`` passes of X += A⁻¹(N − A·X), A = M[:, :, :b], N = M[:, :, b:]."""
    A, N = M[:, :, :b], M[:, :, b:]
    for _ in range(steps):
        X = X + Ainv @ (N - A @ X)
    return X


def gjpr_solve_aug_plain(M: Tensor, b: int) -> Tensor:
    """gjp on [M | I] (the same elimination also yields A⁻¹), then one
    refinement step."""
    nrhs = M.shape[2] - b
    sol = gjp_solve_aug_plain(_with_identity(M, b), b)
    return _refine(sol[:, :, :nrhs], sol[:, :, nrhs:], M, b, 1)


def gjb_solve_aug_plain(M: Tensor, b: int, refine: int) -> Tensor:
    """Blocked pivot-free Gauss–Jordan (``_gjb_solve_aug``). Per panel of w ≤
    GJB_PANEL columns k0.. the rank-one steps touch only the panel's slab and
    accumulate W (S, b, w): for j < w, r = k0 + j,
        u = (1/piv − 1 at row r, −col/piv elsewhere),
        slab += u·slab[r],  W += u·(W[r] + e_j);
    then the trailing columns take trail += W·trail[k0:k0+w]. With refine > 0
    the elimination runs on [M | I] and ``refine`` refinement steps follow."""
    S, _, nc = M.shape
    nrhs = nc - b
    rows = torch.arange(b, device=M.device)[None, :, None]
    live = _with_identity(M, b) if refine else M
    k0 = 0
    while k0 < b:
        w = min(GJB_PANEL, b - k0)
        slab, trail = live[:, :, :w], live[:, :, w:]
        lane_w = torch.arange(w, device=M.device)
        W = M.new_zeros((S, b, w))
        for j in range(w):
            r = k0 + j
            col = slab[:, :, j : j + 1]
            inv = _clamped_inverse(slab[:, r : r + 1, j : j + 1])
            u = torch.where(rows == r, inv - 1.0, -col * inv)
            slab = slab + u * slab[:, r : r + 1, :]
            W = W + u * (W[:, r : r + 1, :] + (lane_w == j).to(M.dtype))
        live = trail + W @ trail[:, k0 : k0 + w, :]
        k0 += w
    X = live[:, :, :nrhs]
    return _refine(X, live[:, :, nrhs:], M, b, refine) if refine else X


def gjbp_solve_aug_plain(M: Tensor, b: int, refine: int) -> Tensor:
    """Blocked Gauss–Jordan with gjp's pivot sequence (``_gjbp_solve_aug``).
    Step j of a panel pivots on the one-hot row o (largest |entry| among
    unused rows), u = o·(1/piv − 1) − (1 − o)·col/piv, slab += u·(oᵀslab),
    W += u·(oᵀW + e_j), and column j of the panel's O is o; the trailing
    columns take trail += W·(Oᵀtrail). At the end each panel's Oᵀ brings its
    variables' rows back in order, then ``refine`` refinement steps run."""
    nrhs = M.shape[2] - b
    live, _ = _gjbp_elimination(M, b, refine)
    X = live[:, :, :nrhs]
    return _refine(X, live[:, :, nrhs:], M, b, refine) if refine else X


def _gjbp_elimination(M: Tensor, b: int, refine: int) -> tuple[Tensor, Tensor]:
    """gjbp's elimination and unscramble: [X | A⁻¹ (refine)] and the pivot
    row of each column (S, b), b where a column had no pivot."""
    S = M.shape[0]
    dtype = M.dtype
    rows_f = torch.arange(b, device=M.device, dtype=dtype)[None, :, None]
    live = _with_identity(M, b) if refine else M
    used = M.new_zeros((S, b, 1))
    panels, pivots = [], []
    k0 = 0
    while k0 < b:
        w = min(GJB_PANEL, b - k0)
        slab, trail = live[:, :, :w], live[:, :, w:]
        lane_w = torch.arange(w, device=M.device)
        W = M.new_zeros((S, b, w))
        O = M.new_zeros((S, b, w))
        for j in range(w):
            e_j = (lane_w == j).to(dtype)
            col = slab[:, :, j : j + 1]
            score = col.abs() * (1.0 - used) - used
            top = score.amax(dim=1, keepdim=True)
            first = torch.where(score == top, rows_f, float(b)).amin(dim=1, keepdim=True)
            o = (rows_f == first).to(dtype)  # (S, b, 1); all zero when no pivot
            inv = _clamped_inverse((col * o).sum(dim=1, keepdim=True))
            u = o * (inv - 1.0) - (1.0 - o) * col * inv
            slab = slab + u * (slab * o).sum(dim=1, keepdim=True)
            W = W + u * ((W * o).sum(dim=1, keepdim=True) + e_j)
            O = O + o * e_j
            used = used + o
            pivots.append(first[:, 0, 0].long())
        live = trail + W @ (O.transpose(1, 2) @ trail)
        panels.append(O)
        k0 += w
    live = torch.cat([O.transpose(1, 2) @ live for O in panels], dim=1)
    return live, torch.stack(pivots, dim=1)


def solve_aug_plain(M: Tensor, b: int, fact: str) -> Tensor:
    """The in-block augmented solve of factorization ``fact`` (see the module
    docstring)."""
    if fact == "lu":
        return torch.linalg.solve(M[:, :, :b], M[:, :, b:])
    if fact not in FACT_CODES:
        raise ValueError(f"fact must be one of {FACTS + ('lu',)}, got {fact!r}")
    family, refine = FACT_CODES[fact]
    if family == 0:
        return qr_solve_aug_plain(M, b)
    if family == 1:
        return gj_solve_aug_plain(M, b)
    if family == 2:
        return gjpr_solve_aug_plain(M, b) if refine else gjp_solve_aug_plain(M, b)
    if family == 3:
        return gjb_solve_aug_plain(M, b, refine)
    return gjbp_solve_aug_plain(M, b, refine)
