"""Error-free transformations and double-word (two-float) arithmetic.

Evaluating the QP's KKT residual G = Mx − ϕ − Aᵀy near its root is
catastrophic cancellation: in float32 the evaluation itself carries about
u·‖M‖·‖x‖ ≈ 6e-6 of noise, so a float32 residual cannot certify tol 1e-6.
Error-free transformations remove that noise with float32 arithmetic only:
TwoSum (Knuth) and Dekker's split/TwoProduct decompose each float32 add or
multiply into its result plus its exact rounding error. Stacked, they give
a compensated matvec (``mv2``) accurate to about u²·n·cond, doubled
precision, and a double-word value (hi, lo) with unevaluated-sum semantics
for iterates.

Every operation here is a separate eager tensor op. Nothing may fuse or
contract them (``torch.addcmul`` or a compiled kernel would round a·b − p
once and destroy the identity), so none is used; eager PyTorch rounds each
op on the CPU and on the card alike.

Used by the tol-1e-6 QP protocol (``bench/qp_dw.py``). References: Dekker
1971; Ogita, Rump & Oishi, "Accurate Sum and Dot Product", 2005; Higham,
Accuracy and Stability, ch. 4.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

#: Dekker split factor for float32 (24-bit mantissa): 2^12 + 1.
_SPLIT = 4097.0


def two_sum(a: Tensor, b: Tensor):
    """s, e with s = fl(a+b) and a + b = s + e exactly (Knuth, 6 flops,
    branch-free: valid for any ordering of |a|, |b|)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum(a: Tensor, b: Tensor):
    """s, e with a + b = s + e exactly; requires |a| ≥ |b| (or a == 0)."""
    s = a + b
    e = b - (s - a)
    return s, e


def split(a: Tensor):
    """a = hi + lo exactly with hi, lo of at most 12 mantissa bits each."""
    c = _SPLIT * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a: Tensor, b: Tensor):
    """p, e with p = fl(a·b) and a·b = p + e exactly (Dekker: products of
    12-bit halves are exact in float32)."""
    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def _sum2_leading(x: Tensor):
    """Neumaier compensated sum over the leading axis: a serial carry of
    two_sum, one step per slice (the JAX package's ``lax.scan``)."""
    s = torch.zeros_like(x[0])
    c = torch.zeros_like(x[0])
    for xi in x:
        s, e = two_sum(s, xi)
        c = c + e
    return s, c


def sum2(x: Tensor, axis: int = -1, *, chunk: int = 16):
    """Compensated sum along ``axis``: (s, e) with s + e ≈ Σx to about
    u²·n·Σ|x| relative error. Two levels: Neumaier within ``chunk``-element
    groups, then across the group sums; serial depth chunk + n/chunk (≈29 at
    n=200) instead of n, with the groups' own error terms summed in plain
    float32 (their rounding is O(u²))."""
    x = torch.movedim(x, axis, -1)
    pad = (-x.shape[-1]) % chunk
    if pad:
        x = F.pad(x, (0, pad))
    xc = x.reshape(*x.shape[:-1], -1, chunk)
    s, c = _sum2_leading(torch.movedim(xc, -1, 0))  # within chunks
    s2, c2 = _sum2_leading(torch.movedim(s, -1, 0))  # across chunk sums
    return s2, c2 + c.sum(dim=-1)


def mv2(A: Tensor, v: Tensor):
    """Compensated matvec A @ v: (hi, lo) with hi + lo ≈ A·v to doubled
    precision (Dot2 of Ogita, Rump & Oishi, vectorized over rows; A (..., n,
    k), v (..., k) → (..., n)): elementwise Dekker products, then the
    compensated sum."""
    p, e = two_prod(A, v[..., None, :])
    s, es = sum2(p, axis=-1)
    lo = es + e.sum(dim=-1)
    return fast_two_sum(s, lo)


# ---- double-word values: unevaluated (hi, lo) pairs ----------------------


def dw(hi: Tensor, lo: Optional[Tensor] = None):
    return (hi, torch.zeros_like(hi) if lo is None else lo)


def dw_add(a, b):
    """(ahi+alo) + (bhi+blo) as a normalized double-word (Dekker's add,
    about u² relative error)."""
    s, e = two_sum(a[0], b[0])
    e = e + (a[1] + b[1])
    return fast_two_sum(s, e)


def dw_neg(a):
    return (-a[0], -a[1])


def dw_sub(a, b):
    return dw_add(a, dw_neg(b))


def dw_mul(a, b):
    """Elementwise double-word product (the lo·lo term dropped: O(u²))."""
    p, e = two_prod(a[0], b[0])
    e = e + (a[0] * b[1] + a[1] * b[0])
    return fast_two_sum(p, e)


def dw_mv(A: Tensor, x_dw):
    """A @ (x_hi + x_lo) in doubled precision: the compensated matvec of the
    hi part plus a plain matvec of the lo part (its rounding is O(u·|lo|) =
    O(u²))."""
    hi, lo = mv2(A, x_dw[0])
    lo = lo + (A @ x_dw[1][..., None])[..., 0]
    return fast_two_sum(hi, lo)
