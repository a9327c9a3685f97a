"""K4a, K4b/K4c, K5: batched dense solves of the Schur-condensed Newton step.

Every function takes the JAX package's public layout: A (B, n, n), b (B, n),
float32 or float64.

* ``gj_solve(A, b) -> x``: Gauss–Jordan elimination without pivoting on
  [A | b] (K4a; replaces ``mcp_tpu/kernels/linear_solve.py::_gj_lanes_kernel``).
* ``gji_solve(A, b) -> (x, A⁻¹)``: the same elimination on [A | b | I], which
  leaves A⁻¹ on the identity columns (K5; replaces ``::_gji_lanes_kernel``).
* ``gauss_solve(A, b) -> x``: Householder QR without pivoting on [A | b],
  β = 1/(‖v‖(‖v‖+|v_k|)+eps), then back substitution (K4b/K4c; replaces
  ``::_qr_lanes_kernel`` and ``::_qr_solve_aug_kernel``, one function: the
  JAX package's B ≥ 128 gate between them is a TPU layout rule).

Failure semantics are the reference's. GJ guards its pivot as
``1/where(|p| > 1e-30, p, 1e-30)``: a zero pivot gives huge values, not NaN.
QR keeps eps = 1e-30 inside the norm and in β and divides by the raw R
diagonal: a zero pivot gives inf/NaN, which the solver reads as a failed
linear solve. GJ is stable only on (near-)SPD systems, the convex-QP Schur
matrices; the QR solve takes any nonsingular system.

The TPU kernels pad n to a multiple of 8 and B to 128 lanes and store the
batch column-major on lanes; none of that is carried over (the padded
identity rows are decoupled, so dropping them changes no result).

A CUDA tensor launches the hand-written kernel (``csrc/gauss_jordan.cu``,
``csrc/qr_dense.cu``) or raises; a CPU tensor runs the plain PyTorch version
of the same algebra (``gj_solve_plain``, ``gji_solve_plain``,
``qr_solve_plain``). Each wrapper counts its kernel launches in
``.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from .solve_aug import qr_solve_aug_plain

Tensor = torch.Tensor

_EPS = 1e-30
#: Shared memory one block may use on an H100 (232,448 bytes), less what the
#: kernels keep beside the augmented matrix.
_SMEM_LIMIT = 232448


def _gj_eliminate(M: Tensor, n: int) -> Tensor:
    """Gauss–Jordan without pivoting on the (B, n, nc) augmented M, column
    by column, as the TPU kernels do: f = M[:, k]·inv, every other row minus
    f·(row k), row k times inv. With identity columns (nc = 2n+1) step k
    touches only the columns before identity column k+1: row k is 0 on the
    later ones, so the update would leave them as they are."""
    nc = M.shape[2]
    rows = torch.arange(n, device=M.device)
    for k in range(n):
        hi = min(nc, n + 2 + k)
        p = M[:, k, k]
        inv = 1.0 / torch.where(p.abs() > _EPS, p, torch.full_like(p, _EPS))
        f = M[:, :, k] * inv[:, None]
        fm = torch.where(rows == k, torch.zeros_like(f), f)
        rowk = M[:, k : k + 1, :hi]
        M = torch.cat([M[:, :, :hi] - fm[:, :, None] * rowk, M[:, :, hi:]], dim=2)
        M[:, k, :hi] = rowk[:, 0, :] * inv[:, None]
    return M


def gj_solve_plain(A: Tensor, b: Tensor) -> Tensor:
    """K4a's algebra in batched PyTorch ops, on any device."""
    n = A.shape[-1]
    return _gj_eliminate(torch.cat([A, b[:, :, None]], dim=2), n)[:, :, n]


def gji_solve_plain(A: Tensor, b: Tensor) -> tuple[Tensor, Tensor]:
    """K5's algebra in batched PyTorch ops, on any device."""
    B, n, _ = A.shape
    eye = torch.eye(n, dtype=A.dtype, device=A.device).expand(B, n, n)
    M = _gj_eliminate(torch.cat([A, b[:, :, None], eye], dim=2), n)
    return M[:, :, n], M[:, :, n + 1 :]


def qr_solve_plain(A: Tensor, b: Tensor) -> Tensor:
    """K4b/K4c's algebra in batched PyTorch ops, on any device: the
    Householder solve of K1's steps (``solve_aug.qr_solve_aug_plain``) on [A | b]."""
    n = A.shape[-1]
    return qr_solve_aug_plain(torch.cat([A, b[:, :, None]], dim=2), n)[:, :, 0]


def _check(name: str, A: Tensor, b: Tensor):
    if A.dim() != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"{name}: A must be (B, n, n), got {tuple(A.shape)}")
    if tuple(b.shape) != tuple(A.shape[:2]):
        raise ValueError(f"{name}: b must be {tuple(A.shape[:2])}, got {tuple(b.shape)}")
    if A.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{name} takes float32/float64, got {A.dtype}")
    if b.dtype != A.dtype or b.device != A.device:
        raise ValueError(f"{name}: A and b must share dtype and device")
    if not (A.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{name}: A and b must be contiguous")
    if A.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {A.device}")


def _smem_bytes(n: int, cols: int, itemsize: int) -> int:
    """The kernels' shared memory: the (n, cols) augmented matrix plus two
    vectors of n and cols entries (multipliers or u, and row k or w)."""
    return itemsize * (n * cols + n + cols + 1)


def _check_fits(name: str, n: int, cols: int, dtype):
    need = _smem_bytes(n, cols, torch.empty((), dtype=dtype).element_size())
    if need > _SMEM_LIMIT:
        raise ValueError(
            f"{name}: n={n} in {dtype} needs {need} bytes of shared memory, "
            f"over the card's {_SMEM_LIMIT} per block"
        )


def _launch(lib: str, symbol: str, wrapper, A: Tensor, ptrs: list[int]):
    B, n, _ = A.shape
    with torch.cuda.device(A.device):
        err = _entry(lib, symbol)(
            0 if A.dtype == torch.float32 else 1, *ptrs, B, n,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {err}")
    wrapper.launches += 1


def gj_solve(A: Tensor, b: Tensor) -> Tensor:
    """Gauss–Jordan solve without pivoting, A (B, n, n), b (B, n) → x (B, n)
    (K4a; see the module docstring)."""
    _check("gj_solve", A, b)
    if A.device.type == "cpu":
        return gj_solve_plain(A, b)
    n = A.shape[-1]
    _check_fits("gj_solve", n, n + 1, A.dtype)
    x = torch.empty_like(b)
    if A.shape[0] and n:
        _launch("gauss_jordan", "mcp_gj_solve", gj_solve, A,
                [A.data_ptr(), b.data_ptr(), x.data_ptr(), 0])
    return x


gj_solve.launches = 0


def gji_solve(A: Tensor, b: Tensor) -> tuple[Tensor, Tensor]:
    """Gauss–Jordan solve and explicit inverse without pivoting, A (B, n, n),
    b (B, n) → (x (B, n), A⁻¹ (B, n, n)) (K5; see the module docstring)."""
    _check("gji_solve", A, b)
    if A.device.type == "cpu":
        return gji_solve_plain(A, b)
    n = A.shape[-1]
    _check_fits("gji_solve", n, 2 * n + 1, A.dtype)
    x, inv = torch.empty_like(b), torch.empty_like(A)
    if A.shape[0] and n:
        _launch("gauss_jordan", "mcp_gj_solve", gji_solve, A,
                [A.data_ptr(), b.data_ptr(), x.data_ptr(), inv.data_ptr()])
    return x, inv


gji_solve.launches = 0


def gauss_solve(A: Tensor, b: Tensor) -> Tensor:
    """Householder-QR solve without pivoting, A (B, n, n), b (B, n) →
    x (B, n) (K4b/K4c; see the module docstring)."""
    _check("gauss_solve", A, b)
    if A.device.type == "cpu":
        return qr_solve_plain(A, b)
    n = A.shape[-1]
    _check_fits("gauss_solve", n, n + 1, A.dtype)
    x = torch.empty_like(b)
    if A.shape[0] and n:
        _launch("qr_dense", "mcp_qr_solve", gauss_solve, A,
                [A.data_ptr(), b.data_ptr(), x.data_ptr()])
    return x


gauss_solve.launches = 0


def _entry(lib: str, symbol: str):
    from ._build import load

    fn = getattr(load(lib), symbol)
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        nptr = 4 if lib == "gauss_jordan" else 3
        fn.argtypes = [ci] + [vp] * nptr + [ci, ci, vp]
        fn.restype = ctypes.c_int
    return fn
