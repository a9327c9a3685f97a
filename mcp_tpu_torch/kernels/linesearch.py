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
``linesearch_update.launches`` counts kernel launches,
``linesearch_update.route_launches`` those of each route.

The kernel has two routes, picked by ``ls_plan(B, n, m, dtype)``, a plain
function of the shapes and of whether the candidate grid is monotone:
``"cluster"`` (a thread block cluster of 2 to 16 CTAs per lane, each
thread holding 16-byte chunks of every row in registers, the partial
results exchanged through distributed shared memory under one cluster
barrier: one pass over device memory), for a batch too small to fill the
card and the solver's finite, positive, non-increasing grid; and
``"block"`` (one 256-thread block per lane in three passes), for a batch
that fills the card, for other grids and as the cluster route's A/B.
"""

from __future__ import annotations

import ctypes
import dataclasses
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


#: The routes of K2 (``csrc/linesearch.cu``) and the limits of the cluster
#: route, the kernel's own: CTAs of ``LS_GROUPS`` threads, each holding up
#: to ``LS_MAX_SLOTS`` 16-byte chunks of every row (``kMaxGroup``,
#: ``kMaxSlots``), clusters of up to ``LS_MAX_CLUSTER`` CTAs whose warps'
#: partial results one warp reduces (CTAs × warps ≤ ``LS_MAX_PARTIALS``:
#: ``kMaxCluster``, ``kMaxPartials``). The plan takes the fewest threads that
#: hold a CTA's chunks in ``LS_TARGET_SLOTS`` chunks each (one: on the card,
#: threads holding two chunks of every row ran slower than twice as many
#: holding one), clusters that give a batch about one CTA per SM of the card
#: (``CARD_SMS``), and no CTA fewer than ``LS_MIN_CHUNKS`` chunks. A batch
#: that fills the card stays on the block route: at (256, 200, 250) one
#: thread group per lane holding its rows in registers ran no faster on an
#: H100 than the block route (PERF.md).
LS_ROUTES = ("cluster", "block")
_LS_ROUTE_CODES = {"block": 0, "cluster": 1}
LS_GROUPS = (32, 64, 128, 256)
LS_MAX_SLOTS = 4
LS_TARGET_SLOTS = 1
LS_MAX_CLUSTER = 16
LS_MAX_PARTIALS = 32
LS_MIN_CHUNKS = 8
LS_MAX_CANDIDATES = 32
CARD_SMS = 132


@dataclasses.dataclass(frozen=True)
class LSPlan:
    """K2's launch for one (B, n, m, dtype): ``route`` "cluster" or
    "block"; ``group`` threads per CTA (cluster route) or 256 (block
    route); ``slots`` 16-byte chunks of each row per thread (0 on the block
    route); ``cluster`` CTAs per lane (1 on the block route)."""

    route: str
    group: int
    slots: int
    cluster: int


def _chunks(length: int, itemsize: int, parts: int) -> int:
    """16-byte chunks of a row of ``length`` elements that one of ``parts``
    CTAs holds (``chunks`` of the source)."""
    chunks = -(-length * itemsize // 16)
    return -(-chunks // parts)


def _group(n: int, m: int, itemsize: int, parts: int, max_group: int):
    """(group, slots) for rows cut ``parts`` ways: the fewest threads whose
    slots are within ``LS_TARGET_SLOTS``, else the widest group within
    ``LS_MAX_SLOTS``; None when no group holds the rows."""
    c = max(_chunks(n, itemsize, parts), _chunks(m, itemsize, parts))
    groups = [g for g in LS_GROUPS if g <= max_group]
    for g in groups:
        if -(-c // g) <= LS_TARGET_SLOTS:
            return g, -(-c // g)
    q = -(-c // groups[-1])
    return (groups[-1], q) if q <= LS_MAX_SLOTS else None


def _monotone(candidates: tuple, dtype) -> bool:
    """Whether the grid, in ``dtype``, is finite, positive and
    non-increasing (the solver's decay^k is): the cluster route's scan of
    the grid needs it (``scan_of`` of the source)."""
    c = torch.tensor(candidates, dtype=dtype)
    return bool(torch.isfinite(c).all() and (c > 0).all() and (c[:-1] >= c[1:]).all())


@functools.lru_cache(maxsize=None)
def ls_plan(B: int, n: int, m: int, dtype, route: str | None = None,
            monotone: bool = True) -> LSPlan:
    """K2's plan for a batch of B lanes of (n, m) rows in ``dtype``: the
    cluster route where clusters of 2 or more CTAs per lane fit the batch
    to the card (B·P ≤ ``CARD_SMS``, P ≤ ``LS_MAX_CLUSTER``, each CTA at
    least ``LS_MIN_CHUNKS`` chunks of the longer row) and the candidate
    grid is ``monotone`` (``_monotone``), else the block route. ``route``
    forces one (the A/B comparison of ``chip_smoke.py``); raises
    ``ValueError`` where the route does not take the shape or the grid."""
    if route not in (None, *LS_ROUTES):
        raise ValueError(f"ls_plan: route must be one of {LS_ROUTES}, got {route!r}")
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"ls_plan takes float32/float64, got {dtype}")
    if n < 1 or m < 1 or B < 0:
        raise ValueError(f"ls_plan needs B >= 0, n > 0 and m > 0, got {(B, n, m)}")
    if route in (None, "cluster"):
        itemsize = torch.empty((), dtype=dtype).element_size()
        longest = max(_chunks(n, itemsize, 1), _chunks(m, itemsize, 1))
        P = 1
        while (2 * P <= LS_MAX_CLUSTER and B * 2 * P <= CARD_SMS
               and longest // (2 * P) >= LS_MIN_CHUNKS):
            P *= 2
        fit = _group(n, m, itemsize, P, 32 * (LS_MAX_PARTIALS // P)) if P > 1 else None
        if fit is not None and monotone:
            return LSPlan("cluster", fit[0], fit[1], P)
        if route == "cluster":
            raise ValueError(f"ls_plan: the cluster route does not take (B, n, m) = "
                             f"{(B, n, m)} in {dtype}" + ("" if monotone else
                                                          " with a non-monotone grid"))
    return LSPlan("block", 256, 0, 1)


class _LSConfig(ctypes.Structure):
    """``LSConfig`` of ``csrc/linesearch.cu``: the plan, the shapes, the
    candidate grid and the output buffer's layout of one configuration."""

    _fields_ = [(name, ctypes.c_int32) for name in
                ("dtype", "route", "group", "slots", "cluster", "B", "n", "m", "K")]
    _fields_ += [("off", ctypes.c_int64 * 5), ("tau", ctypes.c_double),
                 ("cands", ctypes.c_double * LS_MAX_CANDIDATES)]


_Pointers = ctypes.c_uint64 * 11  # x, dx, s, ds, y, dy, rg, rh, rc, outputs, stream


def _align16(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


@functools.lru_cache(maxsize=None)
def _config(plan, dtype, B: int, n: int, m: int, tau: float, candidates: tuple):
    """(the plan, ``plan`` or ``ls_plan``'s for this grid; the launch
    configuration and its address; the element offsets of x', s', y' and
    kkt and the byte offset of the failure flags in one output buffer of
    the iterate dtype; the buffer's elements), built once. Raises
    ``ValueError`` for the cluster route with a non-monotone grid."""
    monotone = _monotone(candidates, dtype)
    plan = plan or ls_plan(B, n, m, dtype, monotone=monotone)
    if plan.route == "cluster" and not monotone:
        raise ValueError("linesearch_update: the cluster route takes only a finite, "
                         f"positive, non-increasing grid, got {candidates}")
    isz = 4 if dtype == torch.float32 else 8
    off = [0]
    for nbytes in (B * n * isz, B * m * isz, B * m * isz, B * isz):
        off.append(off[-1] + _align16(nbytes))
    cfg = _LSConfig(0 if isz == 4 else 1, _LS_ROUTE_CODES[plan.route], plan.group, plan.slots,
                    plan.cluster, B, n, m, len(candidates), (ctypes.c_int64 * 5)(*off), tau,
                    (ctypes.c_double * LS_MAX_CANDIDATES)(*candidates))
    return (plan, cfg, ctypes.addressof(cfg), tuple(o // isz for o in off[:4]) + (off[4],),
            _align16(off[-1] + B) // isz)


def linesearch_update(x, dx, s, ds, y, dy, rg, rh, rc, *, tau, candidates, plan=None):
    """Fused linesearch + update (see the module docstring); ``plan``
    (default ``ls_plan``'s for the shapes and the grid) is for A/B
    comparisons of the routes. The outputs on the card are views of one
    buffer."""
    ops = (x, dx, s, ds, y, dy, rg, rh, rc)
    B, n = x.shape
    m = s.shape[1]
    if not (x.shape == dx.shape == rg.shape
            and s.shape == ds.shape == y.shape == dy.shape == rh.shape == rc.shape
            and s.shape[0] == B):
        raise ValueError("linesearch_update: x, dx, rg must be (B, n) and s, ds, y, dy, rh, "
                         f"rc (B, m), got {[tuple(a.shape) for a in ops]}")
    if n == 0 or m == 0:
        raise ValueError("linesearch_update needs n > 0 and m > 0")
    dt, dev = x.dtype, x.get_device()
    if any(a.dtype is not dt or a.get_device() != dev for a in ops):
        raise ValueError("all linesearch operands must share dtype and device")
    if dt is not torch.float32 and dt is not torch.float64:
        raise ValueError(f"linesearch_update takes float32/float64, got {dt}")
    if not 0 < len(candidates) <= LS_MAX_CANDIDATES:
        raise ValueError("linesearch_update takes 1 to 32 candidates")
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"linesearch_update runs on cuda or cpu, not {x.device}")
        return linesearch_update_plain(
            x, dx, s, ds, y, dy, rg, rh, rc, tau=tau, candidates=candidates
        )
    plan, _, addr, off, size = _config(plan, dt, B, n, m, float(tau), tuple(candidates))
    out = torch.empty(size, dtype=dt, device=x.device)
    xo = out.as_strided((B, n), (n, 1), off[0])
    so = out.as_strided((B, m), (m, 1), off[1])
    yo = out.as_strided((B, m), (m, 1), off[2])
    kkt = out.as_strided((B,), (1,), off[3])
    failed = out.view(torch.bool)[off[4]:off[4] + B]
    if B == 0:
        return xo, so, yo, kkt, failed
    # Copies of non-contiguous operands stay referenced until the launch.
    ins = [a if a.is_contiguous() else a.contiguous() for a in ops]
    ptrs = _Pointers(*[a.data_ptr() for a in ins], out.data_ptr(),
                     torch._C._cuda_getCurrentRawStream(dev))
    if dev == torch.cuda.current_device():
        err = _entry()(addr, ptrs)
    else:
        with torch.cuda.device(dev):
            err = _entry()(addr, ptrs)
    if err != 0:
        raise RuntimeError(f"linesearch kernel launch failed: CUDA error {err}")
    linesearch_update.launches += 1
    linesearch_update.route_launches[plan.route] += 1
    return xo, so, yo, kkt, failed


linesearch_update.launches = 0
linesearch_update.route_launches = dict.fromkeys(LS_ROUTES, 0)


def _entry():
    from ._build import load

    fn = load("linesearch").mcp_linesearch_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, _Pointers]
        fn.restype = ctypes.c_int
    return fn
