"""K2: fused fraction-to-the-boundary linesearch + iterate update + ‖F‖∞.

``linesearch_update(x, dx, s, ds, y, dy, rg, rh, rc, *, tau, candidates)``
over a batch: x, dx, rg (B, n); s, ds, y, dy, rh, rc (B, m) →
(x', s', y', kkt (B,), step_failed (B,) bool). Per lane:

  * a non-finite direction (dx, ds or dy) is a linear-solve failure, and
    the direction is zeroed with a select (0·NaN = NaN);
  * α_s is the largest candidate c with c·δs ≥ −τ·s everywhere (the first
    feasible one of the halving grid), α_y likewise over (y, δy); no
    feasible candidate is a linesearch failure;
  * the update x += α_s·δx, s += α_s·δs, y += α_y·δy applies only when
    neither failed;
  * kkt = max(‖rg‖∞, ‖rh‖∞, ‖rc‖∞) at the pre-step point.

``candidates`` is the static grid of ``solver.linesearch_candidates``.

A CUDA tensor launches the hand-written kernel ``csrc/linesearch.cu``
(which replaces ``mcp_tpu/kernels/linesearch_pallas.py::_ls_update_kernel``)
or raises; a CPU tensor runs ``linesearch_update_plain``.
``linesearch_update.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

Tensor = torch.Tensor


@functools.lru_cache(maxsize=None)
def _candidate_tensor(candidates: tuple, dtype, device) -> Tensor:
    return torch.tensor(candidates, dtype=dtype, device=device)


def linesearch_update_plain(x, dx, s, ds, y, dy, rg, rh, rc, *, tau, candidates):
    """The same semantics in batched PyTorch ops, on any device."""
    lin_ok = (
        torch.isfinite(dx).all(dim=1)
        & torch.isfinite(ds).all(dim=1)
        & torch.isfinite(dy).all(dim=1)
    )
    keep = lin_ok[:, None]
    dx_s = torch.where(keep, dx, torch.zeros_like(dx))
    ds_s = torch.where(keep, ds, torch.zeros_like(ds))
    dy_s = torch.where(keep, dy, torch.zeros_like(dy))
    c = _candidate_tensor(tuple(candidates), x.dtype, x.device)

    def alpha(v, dv):
        feasible = (c[None, :, None] * dv[:, None, :] >= (-tau * v)[:, None, :]).all(dim=2)
        a = torch.where(feasible, c[None, :], torch.zeros_like(c)[None, :]).amax(dim=1)
        return a, feasible.any(dim=1)

    a_s, any_s = alpha(s, ds_s)
    a_y, any_y = alpha(y, dy_s)
    ok = lin_ok & any_s & any_y
    sc_s = torch.where(ok, a_s, torch.zeros_like(a_s))[:, None]
    sc_y = torch.where(ok, a_y, torch.zeros_like(a_y))[:, None]
    kkt = torch.maximum(
        rg.abs().amax(dim=1),
        torch.maximum(rh.abs().amax(dim=1), rc.abs().amax(dim=1)),
    )
    return x + sc_s * dx_s, s + sc_s * ds_s, y + sc_y * dy_s, kkt, ~ok


def linesearch_update(x, dx, s, ds, y, dy, rg, rh, rc, *, tau, candidates):
    """Fused linesearch + update (see the module docstring)."""
    B, n = x.shape
    m = s.shape[1]
    if n == 0 or m == 0:
        raise ValueError("linesearch_update needs n > 0 and m > 0")
    for name, a, d in (("x", x, n), ("dx", dx, n), ("rg", rg, n), ("s", s, m),
                       ("ds", ds, m), ("y", y, m), ("dy", dy, m), ("rh", rh, m),
                       ("rc", rc, m)):
        if tuple(a.shape) != (B, d):
            raise ValueError(f"{name} must be {(B, d)}, got {tuple(a.shape)}")
        if a.dtype != x.dtype or a.device != x.device:
            raise ValueError("all linesearch operands must share dtype and device")
    if x.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"linesearch_update takes float32/float64, got {x.dtype}")
    if not 0 < len(candidates) <= 32:
        raise ValueError("linesearch_update takes 1 to 32 candidates")
    if x.device.type == "cpu":
        return linesearch_update_plain(
            x, dx, s, ds, y, dy, rg, rh, rc, tau=tau, candidates=candidates
        )
    if x.device.type != "cuda":
        raise ValueError(f"linesearch_update runs on cuda or cpu, not {x.device}")
    ins = [a.contiguous() for a in (x, dx, s, ds, y, dy, rg, rh, rc)]
    xo, so, yo = torch.empty_like(x), torch.empty_like(s), torch.empty_like(y)
    kkt = torch.empty((B,), dtype=x.dtype, device=x.device)
    failed = torch.empty((B,), dtype=torch.bool, device=x.device)
    if B == 0:
        return xo, so, yo, kkt, failed
    cands = _candidate_tensor(tuple(candidates), x.dtype, x.device)
    with torch.cuda.device(x.device):
        err = _entry()(
            0 if x.dtype == torch.float32 else 1,
            *(a.data_ptr() for a in ins), cands.data_ptr(), len(candidates),
            float(tau), B, n, m, xo.data_ptr(), so.data_ptr(), yo.data_ptr(),
            kkt.data_ptr(), failed.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"linesearch kernel launch failed: CUDA error {err}")
    linesearch_update.launches += 1
    return xo, so, yo, kkt, failed


linesearch_update.launches = 0


def _entry():
    from ._build import load

    fn = load("linesearch").mcp_linesearch_update
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([ci] + [vp] * 10 + [ci, ctypes.c_double, ci, ci, ci]
                       + [vp] * 6)
        fn.restype = ctypes.c_int
    return fn
