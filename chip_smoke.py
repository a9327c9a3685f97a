#!/usr/bin/env python3
"""Smoke run of the PyTorch port (mcp_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written kernels from the sources in this checkout, holds
each against its plain PyTorch version on the card, drives the main path
(the lane-change game at T=10, 2048 instances in batches of 256, float32,
tol 1e-4, the headline options) through the user entry points, certifies
the result with the true KKT residual, times each kernel beside its bound,
its plain version and a library call, and prints as its last line

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

It exits non-zero, printing no result, when no CUDA device is available or
any phase fails. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

# Peak rates of one H100 SXM (NVIDIA data sheet) for the bound columns.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

HEADLINE = dict(
    tol=1e-4,
    linear_solver="tridiag_pallas",
    algorithm="ip",
    polish=True,
    retry=0,
    refinement_steps=1,
)
B, K_BATCHES = 256, 8  # 2048 instances on the main path
K1_TOL = 1e-4  # max |kernel - plain| on O(1) diagonally dominant systems, f32
K1_REAL_TOL = 1e-3  # relative to max |x| on the lane-change Newton systems, f32
K1_F64_TOL = 1e-10
K1_RESIDUAL_TOL = 1e-4  # ‖Ax − r‖/‖r‖ in float32
K2_TOL = 1e-6  # relative, x'/s'/y' (the kernel rounds as the plain version)


class PhaseFailed(Exception):
    pass


def check(cond: bool, what: str):
    if not cond:
        raise PhaseFailed(what)


def log(msg: str):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls, CUDA-event timed
    after one warm call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# -- K1 --------------------------------------------------------------------


def random_bands(shape, dtype, device, seed):
    import torch

    Bn, T, b = shape
    rng = np.random.default_rng(seed)
    # 3b on the diagonal keeps every one of the B·T random blocks well
    # conditioned (a +6I shift leaves a few of 2560 near-singular in float32).
    arrs = (
        rng.standard_normal((Bn, T, b, b)) + 3 * b * np.eye(b),
        0.3 * rng.standard_normal((Bn, T - 1, b, b)),
        0.3 * rng.standard_normal((Bn, T - 1, b, b)),
        rng.standard_normal((Bn, T, b)),
    )
    return tuple(torch.tensor(a, dtype=dtype, device=device) for a in arrs)


def block_residual(diag, lower, upper, rhs, x):
    """‖Ax − r‖/‖r‖ per system, in float64."""
    import torch

    d, lo, up, r, x = (a.double() for a in (diag, lower, upper, rhs, x))
    Ax = (d @ x[..., None])[..., 0]
    Ax[:, 1:] += (lo @ x[:, :-1, :, None])[..., 0]
    Ax[:, :-1] += (up @ x[:, 1:, :, None])[..., 0]
    num = (Ax - r).flatten(1).norm(dim=1)
    return num / r.flatten(1).norm(dim=1)


def first_newton_bands(mcp, thetas):
    """The (diag, lower, upper, rhs) the solver hands K1 in the first inner
    step of a cold-started batch."""
    import torch

    from mcp_tpu_torch.kernels.block_tridiag import (
        banded_newton_step_compressed,
        gh_banded_fast,
    )

    Bn, dtype, dev = thetas.shape[0], thetas.dtype, thetas.device
    n, m = mcp.unconstrained_dimension, mcp.constrained_dimension
    x = torch.zeros((Bn, n), dtype=dtype, device=dev)
    y = torch.ones((Bn, m), dtype=dtype, device=dev)
    s = torch.ones((Bn, m), dtype=dtype, device=dev)
    st = mcp.time_structure
    ab = mcp.affine_bands.to(dtype=dtype)
    g, h, *bands = gh_banded_fast(mcp, st, x, y, thetas, affine_bands=ab)
    captured = []

    def capture(diag, lower, upper, rhs):
        captured.append((diag, lower, upper, rhs))
        return torch.zeros_like(rhs)

    banded_newton_step_compressed(*bands, y, s, g, h - s, s * y - 1.0, HEADLINE["tol"],
                                  st, algorithm=capture)
    return captured[0]


def k1_check(name, args, tol, relative=False):
    import torch

    from mcp_tpu_torch.kernels.thomas import thomas_solve, thomas_solve_plain

    xk = thomas_solve(*args)
    torch.cuda.synchronize()
    xp = thomas_solve_plain(*args)
    scale = float(xp.abs().max()) if relative else 1.0
    err = float((xk - xp).abs().max()) / max(scale, 1e-30)
    res_k = float(block_residual(*args, xk).max())
    res_p = float(block_residual(*args, xp).max())
    log(f"  K1 {name}: max|kernel-plain|{'/max|x|' if relative else ''}={err:.3e} "
        f"(tol {tol:g})  residual kernel={res_k:.3e} plain={res_p:.3e}")
    check(bool(torch.isfinite(xk).all()), f"K1 {name}: non-finite kernel output")
    check(err <= tol, f"K1 {name}: kernel and plain differ by {err:.3e} > {tol:g}")
    if args[0].dtype == torch.float32:
        check(res_k <= K1_RESIDUAL_TOL, f"K1 {name}: kernel residual {res_k:.3e}")
    return err * scale


def phase_k1(mcp, device):
    import torch

    from mcp_tpu_torch.kernels.thomas import thomas_solve, thomas_solve_plain

    f32, f64 = torch.float32, torch.float64
    k1_check("random (256,10,20) f32", random_bands((256, 10, 20), f32, device, 1), K1_TOL)
    k1_check("random (64,10,20) f32", random_bands((64, 10, 20), f32, device, 2), K1_TOL)
    k1_check("random (3,7,5) f32", random_bands((3, 7, 5), f32, device, 3), K1_TOL)
    k1_check("random (256,10,20) f64", random_bands((256, 10, 20), f64, device, 4), K1_F64_TOL)
    k1_check("random (2,1,64) f64", random_bands((2, 1, 64), f64, device, 5), K1_F64_TOL)
    gen = torch.Generator().manual_seed(11)
    from mcp_tpu_torch.bench import lane_change as lc

    bench = lc.generate_test_problem(horizon=10, device=device)
    thetas = lc.generate_parameter_batch(gen, B, bench, dtype=f32, device=device)
    real = first_newton_bands(mcp, thetas)
    err = k1_check("lane-change first Newton step (256,10,20) f32", real,
                   K1_REAL_TOL, relative=True)
    # A zero pivot gives non-finite x in both versions, on that system only.
    diag, lower, upper, rhs = random_bands((4, 5, 20), f32, device, 6)
    diag[2, 0] = 0.0
    xk = thomas_solve(diag, lower, upper, rhs)
    xp = thomas_solve_plain(diag, lower, upper, rhs)
    torch.cuda.synchronize()
    bad_k = ~torch.isfinite(xk).flatten(1).all(dim=1)
    bad_p = ~torch.isfinite(xp).flatten(1).all(dim=1)
    log(f"  K1 zero pivot: non-finite systems kernel={bad_k.tolist()} plain={bad_p.tolist()}")
    check(bad_k.tolist() == [False, False, True, False], "K1 zero pivot: kernel")
    check(bad_p.tolist() == [False, False, True, False], "K1 zero pivot: plain")
    return real, err


# -- K2 --------------------------------------------------------------------


def ls_case(kind, dtype, device, n=200, m=250, seed=0):
    import torch

    rng = np.random.default_rng(seed)
    x, dx, rg = (rng.standard_normal((B, n)) for _ in range(3))
    s, y = rng.uniform(0.01, 2.0, (B, m)), rng.uniform(0.01, 2.0, (B, m))
    ds, dy = 0.1 * rng.standard_normal((B, m)), 0.1 * rng.standard_normal((B, m))
    rh, rc = rng.standard_normal((B, m)), rng.standard_normal((B, m))
    if kind == "partly_feasible":
        ds[::2] = -7.3 * s[::2]
        dy[::2] = -2.9 * y[::2]
    elif kind == "infeasible":
        ds[1::2] = -s[1::2] / (1e-4 * 0.5 * 0.5)
    elif kind == "nan_direction":
        dx[0, 0] = np.nan
        ds[5, 1] = np.inf
        dy[10, 2] = np.nan
    return tuple(
        torch.tensor(a, dtype=dtype, device=device)
        for a in (x, dx, s, ds, y, dy, rg, rh, rc)
    )


def phase_k2(device):
    import torch

    from mcp_tpu_torch.kernels.linesearch import linesearch_update, linesearch_update_plain
    from mcp_tpu_torch.solver import SolverOptions, linesearch_candidates

    o = SolverOptions()
    cands = linesearch_candidates(o.decay, o.min_stepsize)
    worst = 0.0
    for dtype in (torch.float32, torch.float64):
        for kind in ("feasible", "partly_feasible", "infeasible", "nan_direction"):
            args = ls_case(kind, dtype, device)
            got = linesearch_update(*args, tau=o.tau, candidates=cands)
            torch.cuda.synchronize()
            want = linesearch_update_plain(*args, tau=o.tau, candidates=cands)
            errs = [
                float(((g - w).abs() / w.abs().clamp(min=1.0)).max())
                for g, w in zip(got[:3], want[:3])
            ]
            same_flags = bool(torch.equal(got[4], want[4]))
            same_kkt = bool(torch.equal(got[3], want[3]))
            nfail = int(got[4].sum())
            log(f"  K2 {kind} {str(dtype)[6:]}: failed lanes {nfail}/{B}, flags equal "
                f"{same_flags}, kkt equal {same_kkt}, max rel err x/s/y "
                f"{max(errs):.3e} (tol {K2_TOL:g})")
            check(same_flags and same_kkt, f"K2 {kind}: flags or kkt differ")
            check(max(errs) <= K2_TOL, f"K2 {kind}: iterates differ")
            expect = {"feasible": nfail == 0, "partly_feasible": True,
                      "infeasible": 0 < nfail < B, "nan_direction": nfail == 3}
            check(expect[kind], f"K2 {kind}: unexpected failure count {nfail}")
            if dtype == torch.float32:
                worst = max(worst, max(float((g - w).abs().max()) for g, w in
                                       zip(got[:3], want[:3])))
    return worst


# -- main path -------------------------------------------------------------


def phase_main_path(device, batch=B, k_batches=K_BATCHES, seed=2026):
    """Drive the user entry points; returns (stats dict, launch counts)."""
    import torch

    from mcp_tpu_torch import (
        SOLVED,
        SolverOptions,
        auto_tightening_rate,
        batch_statistics,
        solve_batch,
        solve_batches_streamed,
    )
    from mcp_tpu_torch.bench import lane_change as lc
    from mcp_tpu_torch.bench.harness import true_kkt_errors
    from mcp_tpu_torch.kernels.linesearch import linesearch_update
    from mcp_tpu_torch.kernels.thomas import thomas_solve

    t0 = time.perf_counter()
    bench = lc.generate_test_problem(horizon=10, device=device)
    mcp = bench.parametric_game.mcp
    log(f"  game built in {time.perf_counter() - t0:.2f} s: n={mcp.unconstrained_dimension} "
        f"m={mcp.constrained_dimension} p={mcp.parameter_dimension} "
        f"T={mcp.time_structure.num_blocks} b={mcp.time_structure.block_size}")
    options = SolverOptions(**HEADLINE, tightening_rate=auto_tightening_rate(mcp))
    gen = torch.Generator().manual_seed(seed)
    warm = lc.generate_parameter_batch(gen, batch, bench, dtype=torch.float32, device=device)
    stack = torch.stack([
        lc.generate_parameter_batch(gen, batch, bench, dtype=torch.float32, device=device)
        for _ in range(k_batches)
    ])
    solve_batch(mcp, warm, options=options)  # warm batch, untimed
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()

    thomas_solve.launches = 0
    linesearch_update.launches = 0
    t1 = time.perf_counter()
    if device == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    res = solve_batches_streamed(mcp, stack, options=options)
    if device == "cuda":
        end.record()
    sync()
    wall_s = time.perf_counter() - t1
    launches = {"thomas": thomas_solve.launches, "linesearch": linesearch_update.launches}
    device_s = start.elapsed_time(end) / 1e3 if device == "cuda" else float("nan")

    tk = true_kkt_errors(mcp, res, stack)
    stats = batch_statistics(res)
    solved = res.status == SOLVED
    n_inst = batch * k_batches
    stats.update(
        instances=n_inst,
        frac_true_kkt_at_tol=float((tk <= options.tol).double().mean()),
        true_kkt_max_solved=float(tk[solved].max()) if bool(solved.any()) else float("nan"),
        solves_per_s=n_inst / device_s,
        window_s_events=device_s,
        window_s_host=wall_s,
        launches=launches,
    )
    log("  main path: " + json.dumps(stats))
    check(tuple(res.x.shape) == (k_batches, batch, mcp.unconstrained_dimension),
          "main path: result shape")
    check(bool(torch.isfinite(res.x[solved]).all()), "main path: non-finite solved x")
    check(stats["success_rate"] >= 0.99, f"main path: success {stats['success_rate']} < 0.99")
    check(not bool((solved & (tk > options.tol)).any()),
          "main path: a SOLVED lane has true KKT above tol")
    check(launches["thomas"] > 0 and launches["linesearch"] > 0,
          f"main path: a kernel never launched {launches}")
    return mcp, options, stack, res, launches


def phase_reference(options, stack, res):
    """Eight lanes solved on the CPU in float64 with the plain versions
    must agree with the card's float32 kernels: same status, x within
    1e-2 (f32 and f64 iterates differ by ~1e-3 at this tolerance)."""
    import torch

    from mcp_tpu_torch import solve_batch
    from mcp_tpu_torch.bench import lane_change as lc

    cpu_mcp = lc.generate_test_problem(horizon=10, device="cpu").parametric_game.mcp
    th = stack[0, :8].double().cpu()
    ref = solve_batch(cpu_mcp, th, options=options)
    card = (res.status[0, :8].cpu(), res.x[0, :8].double().cpu())
    dx = float((ref.x - card[1]).abs().max())
    log(f"  reference (CPU f64 plain) vs card (f32 kernels), 8 lanes: status "
        f"{ref.status.tolist()} vs {card[0].tolist()}, max|dx|={dx:.3e}")
    check(torch.equal(ref.status, card[0]), "reference: status differs")
    check(dx <= 1e-2, f"reference: x differs by {dx:.3e}")


# -- profile ---------------------------------------------------------------


def phase_profile(mcp, options, thetas):
    """One batch under torch.profiler: host time per solver span, the
    device's busy and idle share, the kernels that ran, the host syncs.
    (The profiler itself slows the host; shares, not times, are the point.)"""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mcp_tpu_torch import solve_batch
    from mcp_tpu_torch import solver as S

    span_names = (S.SPAN_RESIDUAL, S.SPAN_NEWTON, S.SPAN_LINESEARCH, S.SPAN_LOOP_TEST)
    on_card = thetas.device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    if on_card:
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        solve_batch(mcp, thetas, options=options)
        if on_card:
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    host = {name: {"ms": 0.0, "count": 0} for name in span_names}
    by_kernel, intervals = {}, []
    for e in events:
        if e.name in span_names:  # a span: its CPU range (and a GPU mirror)
            if e.device_type == DeviceType.CPU:
                host[e.name]["ms"] += e.time_range.elapsed_us() / 1e3
                host[e.name]["count"] += 1
        elif e.device_type == DeviceType.CUDA:
            intervals.append((e.time_range.start, e.time_range.end))
            t = by_kernel.setdefault(e.name, [0.0, 0])
            t[0] += e.time_range.elapsed_us()
            t[1] += 1
    busy, cur = 0.0, None
    for a, b in sorted(intervals):  # union of kernel intervals (us)
        if cur is None or a > cur[1]:
            busy += 0.0 if cur is None else cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        busy += cur[1] - cur[0]
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:8]
    out = {
        "wall_ms_profiled": wall_ms,
        "device_busy_ms": busy / 1e3,
        "device_idle_share": 1.0 - busy / 1e3 / wall_ms,
        "kernel_launches": len(intervals),
        "host_syncs": sum(1 for e in events if e.name == "cudaStreamSynchronize"),
        "host_spans": host,
        "top_kernels": {k[:70]: [round(v[0] / 1e3, 3), v[1]] for k, v in top},
    }
    log("  profile (one batch): " + json.dumps(out))
    check(not on_card or len(intervals) > 0, "profile: no device activity recorded")
    return out


# -- timing ----------------------------------------------------------------


def thomas_counts(Bn, T, b, shared_bands, itemsize=4):
    """(bytes, flops) the sweep needs: inputs read once, x written once;
    flops of the forward elimination, the QR of each step and both
    substitutions."""
    band = (T - 1) * b * b * itemsize * (1 if shared_bands else Bn)
    nbytes = Bn * T * b * b * itemsize + 2 * band + 2 * Bn * T * b * itemsize
    nc = 2 * b + 1
    qr = sum(4 * (b - k) * (nc - k) for k in range(b))
    backsub = sum(2 * (b - 1 - k) * (b + 1) + (b + 1) for k in range(b))
    elim = 2 * b * b * (b + 1)  # L·[C | d], steps t ≥ 1
    bwd = 2 * b * b
    flops = Bn * (T * (qr + backsub + bwd) + (T - 1) * elim)
    return nbytes, flops


def phase_timing(real_bands, k1_err, k2_err, launches, device):
    import torch

    from mcp_tpu_torch.kernels.linesearch import linesearch_update, linesearch_update_plain
    from mcp_tpu_torch.kernels.thomas import thomas_solve, thomas_solve_plain
    from mcp_tpu_torch.solver import SolverOptions, linesearch_candidates

    diag, lower, upper, rhs = real_bands
    Bn, T, b, _ = diag.shape
    shared = lower.stride(0) == 0
    k1_ms = cuda_ms(lambda: thomas_solve(diag, lower, upper, rhs), 50)
    k1_plain = cuda_ms(lambda: thomas_solve_plain(diag, lower, upper, rhs), 3)
    # Library yardstick: the same system assembled dense (B, Tb, Tb) outside
    # the timing, solved by torch.linalg.solve (the port never calls it).
    A = torch.zeros((Bn, T * b, T * b), dtype=diag.dtype, device=device)
    for t in range(T):
        A[:, t * b:(t + 1) * b, t * b:(t + 1) * b] = diag[:, t]
        if t > 0:
            A[:, t * b:(t + 1) * b, (t - 1) * b:t * b] = lower[:, t - 1]
            A[:, (t - 1) * b:t * b, t * b:(t + 1) * b] = upper[:, t - 1]
    r = rhs.reshape(Bn, T * b, 1).contiguous()
    k1_lib = cuda_ms(lambda: torch.linalg.solve(A, r), 10)
    nbytes, flops = thomas_counts(Bn, T, b, shared)
    k1_bound = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S) * 1e3
    k1_by = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / FP32_FLOP_PER_S else "operations"

    o = SolverOptions()
    cands = linesearch_candidates(o.decay, o.min_stepsize)
    args = ls_case("partly_feasible", torch.float32, device)
    k2_ms = cuda_ms(lambda: linesearch_update(*args, tau=o.tau, candidates=cands), 200)
    k2_plain = cuda_ms(lambda: linesearch_update_plain(*args, tau=o.tau, candidates=cands), 20)
    n, m = args[0].shape[1], args[2].shape[1]
    k2_bytes = Bn * ((3 * n + 6 * m) + (n + 2 * m) + 1) * 4 + Bn
    k2_ops = Bn * (2 * len(cands) * 2 * m + 2 * (n + 2 * m) + (n + 2 * m))
    k2_bound = max(k2_bytes / HBM_BYTES_PER_S, k2_ops / FP32_FLOP_PER_S) * 1e3
    k2_by = "bytes" if k2_bytes / HBM_BYTES_PER_S >= k2_ops / FP32_FLOP_PER_S else "operations"
    kernels = [
        {"name": "thomas_solve", "route": "cuda",
         "source": "mcp_tpu_torch/kernels/csrc/thomas.cu",
         "replaces": "mcp_tpu/kernels/thomas_pallas.py:852",
         "launches": launches["thomas"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": k1_lib},
        {"name": "linesearch_update", "route": "cuda",
         "source": "mcp_tpu_torch/kernels/csrc/linesearch.cu",
         "replaces": "mcp_tpu/kernels/linesearch_pallas.py:70",
         "launches": launches["linesearch"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": None},
    ]
    for k in kernels:
        log(f"  {k['name']}: {k['ms']:.4f} ms (plain {k['plain_ms']:.3f} ms, bound "
            f"{k['bound_ms']:.5f} ms by {k['bound_by']}, library {k['library_ms']})")
    return kernels


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a "
              "CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    from mcp_tpu_torch.kernels import _build

    log("phase 1: build kernels")
    t0 = time.perf_counter()
    logs = _build.build()
    log(f"  built {sorted(logs) or 'nothing (cached)'} in {time.perf_counter() - t0:.2f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  [{name}] {line.strip()}")

    device = "cuda"
    from mcp_tpu_torch.bench import lane_change as lc

    mcp = lc.generate_test_problem(horizon=10, device=device).parametric_game.mcp
    log("phase 2: K1 (thomas) kernel vs plain")
    real_bands, k1_err = phase_k1(mcp, device)
    log("phase 3: K2 (linesearch) kernel vs plain")
    k2_err = phase_k2(device)
    log("phase 4: main path")
    mcp, options, stack, res, launches = phase_main_path(device)
    log("phase 5: reference check")
    phase_reference(options, stack, res)
    log("phase 6: kernel timing")
    kernels = phase_timing(real_bands, k1_err, k2_err, launches, device)
    log("phase 7: profile of one main-path batch")
    phase_profile(mcp, options, stack[0])
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseFailed as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
