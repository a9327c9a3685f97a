"""Operations and bytes of the hand-written kernels, counted from shapes, and
the card's peaks. Frozen copies of ``chip_smoke.py``'s ``aug_flops``,
``thomas_counts``, ``dense_counts`` and ``ls_counts``, with the port's
``solve_aug.FACT_CODES`` and ``GJB_PANEL`` written in as constants, so that a
change to the program cannot move the yardstick. A count depends on the
shapes alone, whatever implements the kernel. Each returns (bytes, flops):
every input byte read once and every output byte written once."""

from __future__ import annotations

#: NVIDIA's published peaks of one H100 SXM at its 700 W limit: float32 and
#: float64 outside the tensor cores (the hand-written kernels use none), and
#: HBM3 bandwidth.
FLOP_PER_S = {"float32": 67e12, "float64": 34e12}
HBM_BYTES_PER_S = 3.35e12

#: fact -> (family, refinement steps): 0 qr, 1 gj, 2 gjp, 3 gjb, 4 gjbp.
FACT_CODES = {
    "qr": (0, 0), "gj": (1, 0), "gjp": (2, 0), "gjpr": (2, 1),
    "gjb": (3, 0), "gjbr": (3, 1), "gjbr2": (3, 2),
    "gjbp": (4, 0), "gjbpr": (4, 1), "gjbpr2": (4, 2), "gjbprl": (4, 1),
}
GJB_PANEL = 32


def bound_s(nbytes: float, flops: float, dtype: str = "float32") -> float:
    """The least seconds the card could take: bytes over peak bandwidth or
    operations over the dtype's peak rate, whichever is larger."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FLOP_PER_S[dtype])


def bound_by(nbytes: float, flops: float, dtype: str = "float32") -> str:
    return "bytes" if nbytes / HBM_BYTES_PER_S >= flops / FLOP_PER_S[dtype] else "operations"


def aug_flops(b: int, nrhs: int, fact: str) -> int:
    """Operations of one in-block solve of b×(b + nrhs) by ``fact``: QR's
    column norms, uᵀM and rank-1 updates and the back substitution;
    Gauss–Jordan's multipliers, pivot-row scaling and row updates over the
    columns each step touches (every column for gjp, those right of the
    pivot for gj), gjp's pivot scores and head contraction; the blocked
    facts' panel steps and trailing products; with refinement the identity
    columns and per step A·X, the residual, A⁻¹·E and the update."""
    family, refine = FACT_CODES[fact]
    ld = b + nrhs + (b if refine else 0)
    if family == 0:
        return (sum(2 * (b - k) + 4 * (b - k) * (ld - k) for k in range(b))
                + nrhs * sum(2 * (b - 1 - k) + 1 for k in range(b)))
    if family == 1:
        flops = sum(b + (ld - k - 1) * (2 * b - 1) for k in range(b))
    elif family == 2:
        flops = b * (3 * b + b + ld * (2 * b - 1)) + 2 * b * b * (ld - b)
    else:
        flops = 0
        for k0 in range(0, b, GJB_PANEL):
            w = min(GJB_PANEL, b - k0)
            for j in range(w):
                flops += b + 2 * b * (w - j - 1) + w + 2 * b * w + (3 * b if family == 4 else 0)
            flops += (2 * w + 1) * b * (ld - k0 - w)
    return flops + refine * (4 * b * b * nrhs + 2 * b * nrhs)


def thomas_counts(batch: int, T: int, b: int, shared_bands: bool, fact: str = "qr",
                  itemsize: int = 4) -> tuple[int, int]:
    """K1, the one-way block-Thomas sweep over (batch, T, b): the diagonal
    blocks, the off-diagonal bands (once when the batch shares them) and the
    right-hand side read once, x written once; the forward elimination, the
    in-block solve of each step and both substitutions."""
    band = (T - 1) * b * b * itemsize * (1 if shared_bands else batch)
    nbytes = batch * T * b * b * itemsize + 2 * band + 2 * batch * T * b * itemsize
    elim = 2 * b * b * (b + 1)  # L·[C | d], steps t ≥ 1
    bwd = 2 * b * b
    flops = batch * (T * (aug_flops(b, b + 1, fact) + bwd) + (T - 1) * elim)
    return nbytes, flops


def dense_counts(kind: str, batch: int, n: int, itemsize: int = 4) -> tuple[int, int]:
    """One batched dense solve (K4a "gj", K5 "gji", K4b/K4c "qr"): A and b
    read once, x (and A⁻¹) written once. GJ: per step the n multipliers,
    row k scaled and n−1 rows updated over the live columns (the n−k right
    of the pivot for [A | b], n+1 with the inverse). QR: per reflection the
    column norm, uᵀM and the rank-1 update, then the back substitution."""
    if kind == "qr":
        per = sum(2 * j + 4 * j * (j + 1) for j in range(1, n + 1)) + n * (n + 1)
        out = n
    else:
        live = [n + 1 if kind == "gji" else n - k for k in range(n)]
        per = sum(n + 1 + (2 * n - 1) * c for c in live)
        out = n + (n * n if kind == "gji" else 0)
    return batch * (n * n + n + out) * itemsize, batch * per


def gj_counts(batch: int, n: int, itemsize: int = 4) -> tuple[int, int]:
    """K4a, the no-pivot Gauss–Jordan solve (``dense_counts("gj", ...)``)."""
    return dense_counts("gj", batch, n, itemsize)


def ls_counts(batch: int, n: int, m: int, candidates: int,
              itemsize: int = 4) -> tuple[int, int]:
    """K2, the fused linesearch and update: x, dx, rg, s, ds, y, dy, rh, rc
    read once, x', s', y', the residual norm and the flag written once; per
    inequality and candidate a product and a compare for each of the two
    masks, per entry the update's multiply and add and the norm's compare."""
    nbytes = batch * ((3 * n + 6 * m) + (n + 2 * m) + 1) * itemsize + batch
    return nbytes, batch * (2 * candidates * 2 * m + 2 * (n + 2 * m) + (n + 2 * m))
