"""K1: batched block-tridiagonal solve, pivot-free Householder block-Thomas.

``thomas_solve(diag, lower, upper, rhs)`` solves, per system, the block-
tridiagonal system with diagonal blocks diag (B,T,b,b), sub-diagonal blocks
lower (B,T-1,b,b) (lower[t] couples block t+1 to block t), super-diagonal
blocks upper (B,T-1,b,b) and right-hand side rhs (B,T,b) → x (B,T,b): the
layout of the JAX package's ``pallas_block_thomas``. lower/upper may be one
band expanded over the batch (batch stride 0).

Forward sweep: (D_t − L_t C_{t−1}) [C_t | d_t] = [U_t | r_t − L_t d_{t−1}]
by Householder QR without pivoting; backward: x_t = d_t − C_t x_{t+1}. A
zero or non-finite pivot gives inf/NaN in x.

A CUDA tensor launches the hand-written kernel ``csrc/thomas.cu`` (which
replaces ``mcp_tpu/kernels/thomas_pallas.py::_thomas_kernel_lanes`` and
``_thomas_kernel_packed``) or raises; a CPU tensor runs
``thomas_solve_plain``, the same algebra in batched PyTorch ops.
``thomas_solve.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

Tensor = torch.Tensor

#: Largest block size the sweep takes (the Pallas sweep's own range).
MAX_BLOCK = 64
_EPS = 1e-30


def _qr_solve_aug(M: Tensor, b: int) -> Tensor:
    """Solve M[:, :, :b] X = M[:, :, b:] for a batch, M (B, b, nc), by
    pivot-free Householder QR (the algebra of the JAX package's
    ``_qr_solve_aug``). Returns X (B, b, nc - b)."""
    rows = torch.arange(b, device=M.device)
    for k in range(b):
        below = (rows >= k).to(M.dtype)
        pivot = (rows == k).to(M.dtype)
        v = M[:, :, k] * below  # (B, b)
        vk = v[:, k : k + 1]
        norm = torch.sqrt((v * v).sum(dim=1, keepdim=True) + _EPS)
        sign = torch.where(vk >= 0, 1.0, -1.0).to(M.dtype)
        u = v + (sign * norm) * pivot
        beta = 1.0 / (norm * (norm + vk.abs()) + _EPS)
        w = (u[:, None, :] @ M)[:, 0, :]  # (B, nc)
        M = M - (beta * u)[:, :, None] * w[:, None, :]
    xs = [None] * b
    for k in range(b - 1, -1, -1):
        acc = M[:, k, b:]
        if k < b - 1:
            acc = acc - (M[:, k : k + 1, k + 1 : b] @ torch.stack(xs[k + 1 :], dim=1))[:, 0]
        xs[k] = acc / M[:, k, k : k + 1]
    return torch.stack(xs, dim=1)


def thomas_solve_plain(diag: Tensor, lower: Tensor, upper: Tensor, rhs: Tensor) -> Tensor:
    """The Householder block-Thomas sweep in batched PyTorch ops, on any
    device (the reference the kernel is held against)."""
    B, T, b, _ = diag.shape
    zero = torch.zeros_like(diag[:, 0])
    Cs, ds = [], []
    for t in range(T):
        D, r = diag[:, t], rhs[:, t]
        if t > 0:
            L = lower[:, t - 1]
            D = D - L @ Cs[-1]
            r = r - (L @ ds[-1][..., None])[..., 0]
        U = upper[:, t] if t < T - 1 else zero
        X = _qr_solve_aug(torch.cat([D, U, r[..., None]], dim=2), b)
        Cs.append(X[..., :b])
        ds.append(X[..., b])
    xs = [None] * T
    x_next = torch.zeros_like(rhs[:, 0])
    for t in range(T - 1, -1, -1):
        x_next = ds[t] - (Cs[t] @ x_next[..., None])[..., 0]
        xs[t] = x_next
    return torch.stack(xs, dim=1)


def _check(diag: Tensor, lower: Tensor, upper: Tensor, rhs: Tensor):
    if diag.dim() != 4 or diag.shape[2] != diag.shape[3]:
        raise ValueError(f"diag must be (B, T, b, b), got {tuple(diag.shape)}")
    B, T, b, _ = diag.shape
    if T < 1:
        raise ValueError("thomas_solve needs T >= 1")
    if b > MAX_BLOCK:
        raise ValueError(f"thomas_solve takes blocks up to b={MAX_BLOCK}, got b={b}")
    for name, a in (("lower", lower), ("upper", upper)):
        if tuple(a.shape) != (B, T - 1, b, b):
            raise ValueError(
                f"{name} must be {(B, T - 1, b, b)}, got {tuple(a.shape)}"
            )
    if tuple(rhs.shape) != (B, T, b):
        raise ValueError(f"rhs must be {(B, T, b)}, got {tuple(rhs.shape)}")
    for a in (lower, upper, rhs):
        if a.dtype != diag.dtype or a.device != diag.device:
            raise ValueError("diag, lower, upper, rhs must share dtype and device")
    if diag.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"thomas_solve takes float32/float64, got {diag.dtype}")
    if not (diag.is_contiguous() and rhs.is_contiguous()):
        raise ValueError("diag and rhs must be contiguous")


def _batch_stride(a: Tensor, name: str) -> int:
    """Batch stride (elements) of a band that is contiguous per system and
    either stored per system or expanded from one band (stride 0)."""
    if a.shape[0] == 0:
        return 0
    per = a[0].numel()
    if a.shape[0] > 1 and a.stride(0) not in (0, per):
        raise ValueError(f"{name} must be contiguous or expanded over the batch")
    if per and not a[0].is_contiguous():
        raise ValueError(f"{name} must be contiguous within a system")
    return 0 if a.shape[0] > 1 and a.stride(0) == 0 else per


def thomas_solve(diag: Tensor, lower: Tensor, upper: Tensor, rhs: Tensor) -> Tensor:
    """Batched block-tridiagonal solve (see the module docstring)."""
    _check(diag, lower, upper, rhs)
    lower_bs, upper_bs = _batch_stride(lower, "lower"), _batch_stride(upper, "upper")
    if diag.device.type == "cpu":
        return thomas_solve_plain(diag, lower, upper, rhs)
    if diag.device.type != "cuda":
        raise ValueError(f"thomas_solve runs on cuda or cpu, not {diag.device}")
    B, T, b, _ = diag.shape
    x = torch.empty_like(rhs)
    if B == 0:
        return x
    cd = torch.empty((B, T, b, b + 1), dtype=diag.dtype, device=diag.device)
    with torch.cuda.device(diag.device):
        err = _entry()(
            0 if diag.dtype == torch.float32 else 1,
            diag.data_ptr(), lower.data_ptr(), upper.data_ptr(), rhs.data_ptr(),
            cd.data_ptr(), x.data_ptr(), B, T, b, lower_bs, upper_bs,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"thomas kernel launch failed: CUDA error {err}")
    thomas_solve.launches += 1
    return x


thomas_solve.launches = 0


def _entry():
    from ._build import load

    fn = load("thomas").mcp_thomas_solve
    if fn.argtypes is None:
        vp = ctypes.c_void_p
        fn.argtypes = [ctypes.c_int, vp, vp, vp, vp, vp, vp, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_longlong, vp]
        fn.restype = ctypes.c_int
    return fn
