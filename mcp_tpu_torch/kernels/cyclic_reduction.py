"""K3: batched block-tridiagonal solve by block cyclic reduction.

``cr_thomas_solve(diag, lower, upper, rhs, *, fact)`` takes K1's layout:
diag (B,T,b,b), lower/upper (B,T-1,b,b) (lower[t] couples block t+1 to block
t; each band stored per system or expanded over the batch with stride 0),
rhs (B,T,b) → x (B,T,b). It computes what the JAX package's ``_cr_solve``
computes (``mcp_tpu/kernels/thomas_pallas.py:1055``, inside
``_thomas_kernel_cr_packed`` and ``_thomas_kernel_cr_split``):

* an odd T is padded with one decoupled identity block (x there is 0);
* each level solves the odd blocks against [L_odd | U_odd | r_odd] with one
  augmented b×(3b+1) solve per block, folds them into the even rows
      D' = D_e − U_e·D_o⁻¹L_o − L_e·D_{o−1}⁻¹U_{o−1},  r' likewise,
      L' = −L_e·D_{o−1}⁻¹L_{o−1},  U' = −U_e·D_o⁻¹U_o,
  recurses on the half-size system (T=30 → 16 → 8 → 4 → 2 → 1) and
  back-substitutes x_o = D_o⁻¹r_o − D_o⁻¹L_o·x_e − D_o⁻¹U_o·x_{e+1};
* the T=1 base solves [D | r].

The in-block factorization ``fact`` is any fact of ``solve_aug`` (the JAX
package's ``_solve_aug``, ``:431``): ``"qr"``, ``"gj"``, ``"gjp"``,
``"gjpr"``, the blocked ``"gjb"``, ``"gjbr"``, ``"gjbr2"`` and the blocked
pivoted ``"gjbp"``, ``"gjbpr"``, ``"gjbpr2"``, ``"gjbprl"`` (gjbpr's algebra,
one kernel for both; their launches are counted apart), and ``"lu"`` in the
plain version only (``torch.linalg.solve``, the per-block LU of tier
"tridiag_cr").

Failure semantics are the JAX package's: a Gauss–Jordan pivot below 1e-30 in
magnitude is clamped to 1e-30 (with pivoting, a singular block's pivot row
is scaled by 1e30, but its head column stays zero, so the contraction leaves
finite values in that system); a zero QR pivot gives inf/NaN.

A CUDA tensor launches the hand-written kernel ``csrc/cyclic_reduction.cu``
or raises; a CPU tensor runs ``cr_solve_plain``, the same algebra in batched
PyTorch ops. ``cr_thomas_solve.launches`` counts the solves that launched
the kernel, per factorization (a dict keyed by ``fact``).
"""

from __future__ import annotations

import ctypes

import torch

from .solve_aug import FACT_CODES, FACTS, SMEM_LIMIT, aug_smem_bytes, solve_aug_plain
from .thomas import _batch_stride, _check

Tensor = torch.Tensor


def _cr(D: Tensor, L: Tensor, U: Tensor, r: Tensor, b: int, fact: str) -> Tensor:
    """CR on padded bands: L[:, t] couples t to t−1 (L[:, 0] = 0), U[:, t]
    couples t to t+1 (U[:, T−1] = 0); r (S, T, b, 1) → x (S, T, b, 1)."""
    S, T = D.shape[:2]
    if T == 1:
        return solve_aug_plain(torch.cat([D[:, 0], r[:, 0]], dim=2), b, fact)[:, None]
    if T % 2:
        eye = torch.eye(b, dtype=D.dtype, device=D.device).expand(S, 1, b, b)
        zb = D.new_zeros((S, 1, b, b))
        x = _cr(torch.cat([D, eye], 1), torch.cat([L, zb], 1), torch.cat([U, zb], 1),
                torch.cat([r, r.new_zeros((S, 1, b, 1))], 1), b, fact)
        return x[:, :T]
    H = T // 2
    De, Do = D[:, 0::2], D[:, 1::2]
    Le, Lo = L[:, 0::2], L[:, 1::2]
    Ue, Uo = U[:, 0::2], U[:, 1::2]
    re, ro = r[:, 0::2], r[:, 1::2]
    M = torch.cat([Do, Lo, Uo, ro], dim=3).reshape(S * H, b, 3 * b + 1)
    sol = solve_aug_plain(M, b, fact).reshape(S, H, b, 2 * b + 1)
    DL, DU, Dr = sol[..., :b], sol[..., b : 2 * b], sol[..., 2 * b :]

    def shift_prev(A):  # pair k ← pair k−1, zero at k = 0
        return torch.cat([torch.zeros_like(A[:, :1]), A[:, :-1]], dim=1)

    DL_prev, DU_prev, Dr_prev = shift_prev(DL), shift_prev(DU), shift_prev(Dr)
    D_new = De - Ue @ DL - Le @ DU_prev
    r_new = re - Ue @ Dr - Le @ Dr_prev
    L_new = -(Le @ DL_prev)
    U_new = -(Ue @ DU)
    x_even = _cr(D_new, L_new, U_new, r_new, b, fact)
    x_next = torch.cat([x_even[:, 1:], torch.zeros_like(x_even[:, :1])], dim=1)
    x_odd = Dr - DL @ x_even - DU @ x_next
    return torch.stack([x_even, x_odd], dim=2).reshape(S, T, b, 1)


def cr_solve_plain(diag: Tensor, lower: Tensor, upper: Tensor, rhs: Tensor,
                   fact: str = "qr") -> Tensor:
    """Block cyclic reduction in batched PyTorch ops, on any device (the
    reference the kernel is held against); K1's layout."""
    B, T, b, _ = diag.shape
    zero = diag.new_zeros((B, 1, b, b))
    Lp = torch.cat([zero, lower.expand(B, T - 1, b, b)], dim=1)
    Up = torch.cat([upper.expand(B, T - 1, b, b), zero], dim=1)
    return _cr(diag, Lp, Up, rhs[..., None], b, fact)[..., 0]


def check_fits(b: int, fact: str, dtype):
    """Raise when the kernel cannot hold one odd-block solve in a block's
    shared memory (every fact at b=100 in float64): the working set of
    ``csrc/solve_aug.cuh`` for [D | L | U | r] (plus I with refinement) with
    a one-column scratch slab (``aug_smem_bytes``)."""
    family, refine = FACT_CODES[fact]
    nc = 3 * b + 1 + (b if refine else 0)
    need = aug_smem_bytes(b, nc, family, 1, torch.empty((), dtype=dtype).element_size())
    if need > SMEM_LIMIT:
        raise ValueError(
            f"cr_thomas_solve: fact={fact!r} at b={b} in {dtype} needs {need} bytes "
            f"of shared memory, over the card's {SMEM_LIMIT} per block"
        )


def cr_thomas_solve(diag: Tensor, lower: Tensor, upper: Tensor, rhs: Tensor, *,
                    fact: str = "qr") -> Tensor:
    """Batched block-tridiagonal solve by cyclic reduction (see the module
    docstring)."""
    if fact not in FACTS:
        raise ValueError(f"fact must be one of {FACTS}, got {fact!r}")
    _check(diag, lower, upper, rhs, name="cr_thomas_solve", max_block=None)
    lower_bs, upper_bs = _batch_stride(lower, "lower"), _batch_stride(upper, "upper")
    if diag.device.type == "cpu":
        return cr_solve_plain(diag, lower, upper, rhs, fact)
    if diag.device.type != "cuda":
        raise ValueError(f"cr_thomas_solve runs on cuda or cpu, not {diag.device}")
    B, T, b, _ = diag.shape
    check_fits(b, fact, diag.dtype)
    x = torch.empty_like(rhs)
    if B == 0:
        return x
    lib = _lib()
    work = torch.empty(lib.mcp_cr_workspace(B, T, b), dtype=diag.dtype, device=diag.device)
    with torch.cuda.device(diag.device):
        err = lib.mcp_cr_solve(
            0 if diag.dtype == torch.float32 else 1, *FACT_CODES[fact],
            diag.data_ptr(), lower.data_ptr(), upper.data_ptr(), rhs.data_ptr(),
            work.data_ptr(), x.data_ptr(), B, T, b, lower_bs, upper_bs,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"cyclic reduction kernel launch failed: CUDA error {err}")
    cr_thomas_solve.launches[fact] += 1
    return x


cr_thomas_solve.launches = dict.fromkeys(FACTS, 0)


def _lib():
    from ._build import load

    lib = load("cyclic_reduction")
    if lib.mcp_cr_solve.argtypes is None:
        vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.mcp_cr_workspace.argtypes = [ci, ci, ci]
        lib.mcp_cr_workspace.restype = ll
        lib.mcp_cr_solve.argtypes = [ci, ci, ci, vp, vp, vp, vp, vp, vp, ci, ci, ci, ll, ll,
                                     vp]
        lib.mcp_cr_solve.restype = ci
    return lib
