"""K7a: batched block-tridiagonal solve by the two-way ("burn at both ends")
Householder block-Thomas sweep.

``babe_thomas_solve(diag, lower, upper, rhs)`` takes K1's layout: diag
(B,T,b,b), lower/upper (B,T-1,b,b) (lower[t] couples block t+1 to block t;
each band stored per system or expanded over the batch with stride 0), rhs
(B,T,b) → x (B,T,b), T ≥ 2. It computes what the JAX package's
``_thomas_kernel_babe`` computes (``mcp_tpu/kernels/thomas_pallas.py:737``),
with ml = ⌈T/2⌉:

* left sweep, t = 0..ml−1: (D_t − L_t C_{t−1}) [C_t | d_t] =
  [U_t | r_t − L_t d_{t−1}], so x_t = d_t − C_t x_{t+1};
* right sweep, t = T−1 down to ml: the same recursion on the time-reversed
  system, whose "previous" coupling is U_t and "next" coupling is L_{t−1}:
  (D_t − U_t E_{t+1}) [E_t | e_t] = [L_{t−1} | r_t − U_t e_{t+1}], so
  x_t = e_t − E_t x_{t−1} (the JAX package's identity pad block for odd T
  solves to C = 0, d = 0 exactly and is skipped);
* junction: (I − C_{ml−1} E_{ml}) x_{ml−1} = d_{ml−1} − C_{ml−1} e_{ml}, by
  one more in-block solve, then x_{ml} = e_{ml} − E_{ml} x_{ml−1};
* back substitution of both chains.

Every in-block solve is K1's pivot-free Householder QR (``thomas._qr_solve_aug``,
the JAX package's ``_qr_solve_aug``). A zero or non-finite pivot gives
inf/NaN in x; nothing sanitizes it.

A CUDA tensor launches the hand-written kernel ``csrc/thomas_babe.cu`` or
raises; a CPU tensor runs ``babe_solve_plain``, the same algebra in batched
PyTorch ops. ``babe_thomas_solve.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from .thomas import MAX_BLOCK, _batch_stride, _check, _qr_solve_aug

Tensor = torch.Tensor

#: Shared memory one block may use on an H100 (232,448 bytes).
_SMEM_LIMIT = 232448


def _sweep_step(D, L, U, r, prev, b):
    """One step of a one-way sweep over a batch: [C | d] of
    (D − L C_prev) [C | d] = [U | r − L d_prev]; ``L`` None at the chain's
    start."""
    if L is not None:
        C_prev, d_prev = prev
        D = D - L @ C_prev
        r = r - (L @ d_prev[..., None])[..., 0]
    X = _qr_solve_aug(torch.cat([D, U, r[..., None]], dim=2), b)
    return X[..., :b], X[..., b]


def babe_solve_plain(diag: Tensor, lower: Tensor, upper: Tensor, rhs: Tensor) -> Tensor:
    """The two-way sweep in batched PyTorch ops, on any device (the
    reference the kernel is held against)."""
    B, T, b, _ = diag.shape
    if T < 2:
        raise ValueError("the two-way sweep needs T >= 2 (T = 1 takes the one-way sweep)")
    lower = lower.expand(B, T - 1, b, b)
    upper = upper.expand(B, T - 1, b, b)
    ml = (T + 1) // 2
    left = [_sweep_step(diag[:, 0], None, upper[:, 0], rhs[:, 0], None, b)]
    for t in range(1, ml):  # [C_t | d_t], t = 0..ml−1
        left.append(_sweep_step(diag[:, t], lower[:, t - 1], upper[:, t], rhs[:, t],
                                left[-1], b))
    right = [_sweep_step(diag[:, T - 1], None, lower[:, T - 2], rhs[:, T - 1], None, b)]
    for t in range(T - 2, ml - 1, -1):  # [E_t | e_t], t = T−1 down to ml
        right.append(_sweep_step(diag[:, t], upper[:, t], lower[:, t - 1], rhs[:, t],
                                 right[-1], b))

    mv = lambda A, v: (A @ v[..., None])[..., 0]
    (C_L, d_L), (E_R, e_R) = left[-1], right[-1]
    eye = torch.eye(b, dtype=diag.dtype, device=diag.device).expand(B, b, b)
    Mj = torch.cat([eye - C_L @ E_R, (d_L - mv(C_L, e_R))[..., None]], dim=2)
    xs = [None] * T
    xs[ml - 1] = _qr_solve_aug(Mj, b)[..., 0]
    xs[ml] = e_R - mv(E_R, xs[ml - 1])
    for k in range(ml - 2, -1, -1):  # left chain: x_k = d_k − C_k x_{k+1}
        C, d = left[k]
        xs[k] = d - mv(C, xs[k + 1])
    for t in range(ml + 1, T):  # right chain: x_t = e_t − E_t x_{t−1}
        E, e = right[T - 1 - t]
        xs[t] = e - mv(E, xs[t - 1])
    return torch.stack(xs, dim=1)


def smem_bytes(b: int, dtype) -> int:
    """Shared memory of one launch (``csrc/thomas_babe.cu::smem_bytes``): per
    direction K1's working set [D − LC | U | r] (b×(2b+1)), L (b×b),
    [C | d] (b×(b+1)), the Householder vector (b), uᵀM (2b+1) and β."""
    nc = 2 * b + 1
    per = b * nc + b * b + b * (b + 1) + b + nc + 1
    return 2 * per * torch.empty((), dtype=dtype).element_size()


def check_fits(b: int, dtype):
    """Raise when both directions' working sets do not fit one block's
    shared memory (b=64 in float64)."""
    need = smem_bytes(b, dtype)
    if need > _SMEM_LIMIT:
        raise ValueError(
            f"babe_thomas_solve: b={b} in {dtype} needs {need} bytes of shared "
            f"memory, over the card's {_SMEM_LIMIT} per block"
        )


def babe_thomas_solve(diag: Tensor, lower: Tensor, upper: Tensor, rhs: Tensor) -> Tensor:
    """Batched block-tridiagonal solve by the two-way sweep (see the module
    docstring)."""
    _check(diag, lower, upper, rhs, name="babe_thomas_solve", max_block=MAX_BLOCK)
    lower_bs, upper_bs = _batch_stride(lower, "lower"), _batch_stride(upper, "upper")
    B, T, b, _ = diag.shape
    if T < 2:
        raise ValueError("babe_thomas_solve needs T >= 2 (T = 1 takes the one-way sweep)")
    if diag.device.type == "cpu":
        return babe_solve_plain(diag, lower, upper, rhs)
    if diag.device.type != "cuda":
        raise ValueError(f"babe_thomas_solve runs on cuda or cpu, not {diag.device}")
    check_fits(b, diag.dtype)
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
        raise RuntimeError(f"two-way thomas kernel launch failed: CUDA error {err}")
    babe_thomas_solve.launches += 1
    return x


babe_thomas_solve.launches = 0


def _entry():
    from ._build import load

    fn = load("thomas_babe").mcp_babe_solve
    if fn.argtypes is None:
        vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [ci, vp, vp, vp, vp, vp, vp, ci, ci, ci, ll, ll, vp]
        fn.restype = ci
    return fn
