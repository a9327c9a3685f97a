#!/usr/bin/env python3
"""Smoke run of the PyTorch port (mcp_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written kernels from the sources in this checkout, holds
each against its plain PyTorch version on the card, drives these paths
through the user entry points, each with every launch count set to 0 just
before it and read just after:

  * the lane-change main path (T=10, 2048 instances in batches of 256,
    float32, tol 1e-4, the headline options);
  * the random-QP path (n=100, m=100, 2048 instances in batches of 256,
    float32, tol 1e-4, Mehrotra on tier "schur_pallas_gj", the QP suite's
    defaults), and one batch on each of the tiers "schur_pallas" and
    "schur_pallas_gjr";
  * the masked N-player flagship games on tier "tridiag_auto" (horizon 30,
    batch 8, float32, tol 1e-4): N=4 (b=40, hybrid with refinement 0, four
    batches after a warm one; K3 with pivoted Gauss–Jordan) and N=10
    (b=100, "ip", one batch cut to 10 outer iterations; K3 with refined
    pivoted Gauss–Jordan);
  * the solver-in-the-loop training step on tier "tridiag_pallas" (N=4,
    horizon 30, batch 8, float32: MLP → masked-game solve → loss → IFT
    gradient → SGD; the two-way sweep K7a in the forward and the backward,
    K2), one warm and three timed steps;
  * the fact tiers, every other banded tier of the JAX package (its
    Gauss–Jordan in-block factorizations in the one-way sweep K1′, the
    two-way sweep K7a and cyclic reduction K3): the lane-change headline
    (2048 instances) on "tridiag_pallas_gjpr", one lane-change batch of 256
    on each of ten tiers, one N=4 flagship batch on each of four;
  * the horizon-sharded SPIKE solve (its local slab solve the
    multi-right-hand-side sweep K6) as ranks spawned on the one card over
    gloo: the lane-change headline batch of 256 on a dp=1 x horizon=2 mesh
    (2 ranks), the T=64 lane change in float64 on 4 ranks, the gradient
    through SPIKE at T=16 and the batch-sharded solve on 2 ranks;
  * the one-instance entry points on tier "schur_pallas" (``solve_game``
    on the lane change, ``solve`` on the QP, float32; the single-system QR
    K8a), and the compact-WY QR K8b beside K4b on the QP Schur systems;
  * the solver options on the QP suite (B=256, n=m=100, float32): tier
    "gmres" under "ip" with the fused K2 linesearch and under "mehrotra"
    (its factored solver), beside "schur_pallas_gj" (K4a) on the same θ,
    and "schur_pallas_gj" at each ``matmul_precision`` ("highest", "high",
    "default"), the precision flags restored after the phase;
  * in the 2-rank spawn of the horizon paths, the tensor-parallel Newton
    backend (``solve_single_tp``: one lane-change instance, the condensed
    450-wide system padded to 512 in panels of 64, K2) against the one-card
    "condensed" solve, and ``solve_routed`` of two buckets, one rank each
    (the lane-change headline batch on "tridiag_pallas", K1 and K2; the QP
    batch on "schur_pallas_gj", K4a) against ``solve_batch``;
  * the benchmark entry point ``bench_cuda.py`` (``bench.main.main``) at
    batch 256: the streamed lane change and QP (4 batches x 2 spans; K1
    and K2, K4a), the warm sweep (10 steps; K1, K2) and the double-word QP
    row (2 repeats; K4b/K4c), each held to its certification, success
    floor and timing cross-check; the receding-horizon lane-change demo on
    "schur_pallas" (K8a) against its CPU float64 run, and beside it
    ``python3 bench_cuda.py --quick`` as a child process;
  * the player-selection pipeline on tier "tridiag_pallas" (N=4, horizon
    30, float32; K7a and K2): 32 scenarios from the native sampler, the
    ground truth of 24 in one chunk (certified by true KKT), ``train()``
    (16 examples, 8 to validate, batch 8, 2 epochs; K7a in the forward and
    the backward), the checkpoint reloaded and the NN mode's evaluation
    sweep over 8 held-out scenarios (12 steps, past its 10-step bootstrap),
    ``solve_subgames``; and in child processes beside them, started with
    the phase, the CPU's float64 solve of two ground-truth scenarios, the
    three heuristic modes' sweep (2 steps) with one serial rollout held
    against its batched one, the real-data rollout of
    tests/fixtures/ped/scenario1.csv and the three CLIs
    (``python -m mcp_tpu_torch.scripts.datagen|train_selection|
    evaluate_selection``); every sweep file goes through the metrics;

certifies each result with the true KKT residual, checks a few lanes
against a float64 CPU reference, checks the training gradient against
finite differences (float64) and against the CPU's float64 gradient (a
child process beside the finite differences), times
each kernel (and each fact) beside its bound, its plain version and a
library call, times K1 (and its facts), K4a and K5 on their plan's route
(registers: one warp per system, or a 256-thread tile), K4b/K4c (a lane
pair per column of [A | b]) and K6 (a thread per column of the step's
working matrix), float32 and float64, against the old block route in
turns, and K7a (each fact, float32 and float64) on its
plan's route (one 128-thread group per sweep direction, a column of the
working matrix per thread in registers) against its block route in turns,
holds K2 on its plan's route (a thread group per lane at B=256, a thread
block cluster per lane at B=8) and on its block route to its plain version
bit for bit, asserts the route of every K2 launch on the paths, reads the
device time per launch of K2 (each route against the block route, at the
three shapes the paths give it), K8b (its pair route against its block
route and K4b) and K7a from the profiles, times
K3 and K8a (thread-block-cluster kernels) with their launch plans and
against other cluster sizes in turns, compares K3's
refined facts gjpr, gjbpr and gjbprl in turns on the N=10 bands, profiles
one batch of each path (the first Newton steps of the N=10 batch) and one
train step, and
prints as its last line

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

It exits non-zero, printing no result, when no CUDA device is available or
any phase fails. It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

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

QP_OPTIONS = dict(  # the QP suite's defaults (bench.py --suite qp)
    tol=1e-4,
    linear_solver="schur_pallas_gj",
    algorithm="mehrotra",
    refinement_steps=0,
    max_outer_iters=25,
    retry=0,
    retry_max_outer_iters=8,
    retry_linear_solver="schur_pallas",
    polish=True,
)
QP_N = 100  # primals = inequalities
QP_MIN_SUCCESS = 0.98  # about 1 draw in 256 is infeasible by construction
# K4a and K5 round every product and difference as their plain version does:
# any difference is a fault (measured 0 in both dtypes). The bound is on
# max|kernel − plain| relative to max|plain| (x, and A⁻¹ for K5).
GJ_TOL = 1e-6
# K4b/K4c reduce in another order than the plain version, so the two differ
# by up to cond(A)·ε·|x| (two backward-stable solves); the bound is on
# max_i |x_kernel − x_plain|_i / (|x_plain|_i · κ₂(A_i)), i.e. about 100 ε.
QR_TOL = {"float32": 1e-5, "float64": 2e-14}
# That bound grows with κ and so holds little on the ill-conditioned saddle
# and late-iterate systems. Householder QR is backward stable whatever κ:
# each system's backward error ‖Ax−b‖∞/(‖A‖∞‖x‖∞ + ‖b‖∞) must stay within
# 100 ε of its dtype (the plain version measures at most 5 ε on these cases).
QR_BWD_TOL = {"float32": 100 * 2.0**-23, "float64": 100 * 2.0**-52}
# Card (float32, kernels) against CPU (float64, plain versions) on 8 QP
# lanes, relative to max|x|: at tol 1e-4 a solution is fixed only to about
# cond·tol (measured up to 2.8e-3 between f32 and f64 over 32 CPU lanes).
QP_REF_REL_TOL = 1e-2

# The masked N-player flagships (the reference's timing workload): circle
# crossing, all-ones masks, horizon 30, batch 8, tier "tridiag_auto".
FLAG_B, FLAG_T, N4_BATCHES = 8, 30, 4
N4_OPTIONS = dict(tol=1e-4, linear_solver="tridiag_auto", algorithm="hybrid",
                  refinement_steps=0, polish=True)
# The N=10 batch is cut in depth to 10 outer iterations (the solver's default
# is 50): its two FAILED lanes set its time (245 s on an H100 with 50, 123 s
# with 20, 70 s with 10), and its six SOLVED lanes take 6-9 (the same lanes
# solve at 50, 20 and 10; PERF.md §6).
N10_OPTIONS = dict(tol=1e-4, linear_solver="tridiag_auto", algorithm="ip", polish=True,
                   max_outer_iters=10)
N4_MIN_SUCCESS, N10_MIN_SUCCESS = 0.9, 0.75
# The N=10 batch runs for minutes (its failing lanes iterate to
# max_outer_iters); its profile covers the first N10_PROFILE_INNER Newton
# steps of the first outer iteration and as many polish steps (the whole
# first outer iteration took about 100 s of the script's time limit).
N10_PROFILE_OUTER, N10_PROFILE_INNER = 1, 5
# K3 against its plain version: max|kernel − plain| / max|plain|. The
# Gauss–Jordan elimination rounds as the plain version; the head
# contraction, refinement and level products sum in another order, which
# shows at a few ε·cond. Each system is also held to a backward error of the
# whole block-tridiagonal system ‖Ax − r‖∞/(‖A‖∞‖x‖∞ + ‖r‖∞) ≤ 100 ε, or,
# where the algorithm itself exceeds that (cyclic reduction with
# Gauss–Jordan blocks is not backward stable: the plain version measured
# 216 ε on the N=4 first-Newton bands in float32), to twice the plain
# version's backward error on the same system.
K3_TOL = {"float32": 1e-3, "float64": 1e-10}
K3_BWD_TOL = {"float32": 100 * 2.0**-23, "float64": 100 * 2.0**-52}
# K7a (the two-way sweep) is held to K3's rule above.

# The fact tiers: every linear_solver of the JAX package's banded tier table
# whose route runs a Gauss–Jordan fact of K1′ (the packed one-way sweep), K7a
# or K3. Path A: the lane-change headline (2048 instances) on
# "tridiag_pallas_gjpr" with the fused K2 linesearch (bench.py --tier
# tridiag_pallas_gjpr --fused-linesearch on: the headline's iteration with
# only the block factorization changed). Path B: one lane-change batch of B
# on each tier below, with the kernel and fact its route runs at (256, 10,
# 20). The success floors are where the JAX package's tests solve on the tier
# (tests/test_tridiag.py:199-218, 352-404, 4 lanes each), 0.99 of a batch of
# 256, except gjp: unrefined Gauss–Jordan is not backward stable, and the JAX
# package records it dropping ~3% of near-boundary lanes at large batch
# (thomas_pallas.py:399-401; 6 of 256 on the card, PERF.md §6 PR 5), hence
# 0.95. The pivot-free tiers have none (the JAX package records them losing
# lanes or returning inf on game blocks), but every lane a tier marks SOLVED
# must be certified. Every tier runs before a failure is reported.
PATH_B = (
    ("tridiag_pallas_gj", "thomas", "gj", None),
    ("tridiag_pallas_gjp", "thomas", "gjp", 0.95),
    ("tridiag_pallas_lanes", "thomas", "qr", 0.99),
    ("tridiag_pallas_crgj", "cr", "gj", None),
    ("tridiag_pallas_crgjb", "cr", "gjb", None),
    ("tridiag_pallas_crgjbr", "cr", "gjbr", None),
    ("tridiag_pallas_crgjbr2", "cr", "gjbr2", None),
    ("tridiag_pallas_crgjbpr", "cr", "gjbpr", 0.99),
    ("tridiag_pallas_crgjbpr2", "cr", "gjbpr2", 0.99),
    ("tridiag_pallas_crgjbprl", "cr", "gjbprl", 0.99),
)
# Path C: one N=4 flagship batch (phase 14's options and θ draw) per tier;
# the two-way sweep K7a at (8, 30, 40) for the sweep tiers.
PATH_C = (
    ("tridiag_pallas_gj", "babe", "gj", None),
    ("tridiag_pallas_gjp", "babe", "gjp", 0.9),
    ("tridiag_pallas_gjpr", "babe", "gjpr", 0.9),
    ("tridiag_pallas_crgjbpr", "cr", "gjbpr", 0.9),
)
# The facts' kernels against their plain versions: K3's rule, with float64
# held to 1e-12 of max|x| (the eliminations round as the plain versions; the
# products sum in another order).
FACT_TOL = {"float32": K3_TOL["float32"], "float64": 1e-12}
FACT_SOURCE = {"thomas": ("thomas_solve", "thomas.cu", "mcp_tpu/kernels/thomas_pallas.py:516"),
               "babe": ("babe_thomas_solve", "thomas_babe.cu",
                        "mcp_tpu/kernels/thomas_pallas.py:737"),
               "cr": ("cr_thomas_solve", "cyclic_reduction.cu",
                      "mcp_tpu/kernels/thomas_pallas.py:1154")}

# The solver-in-the-loop training step (the JAX package's
# scripts/bench_train_step.py at its flagship shape, N=4, horizon 30, batch
# 8, float32) on tier "tridiag_pallas", whose route there is K7a in the
# forward Newton steps and in the IFT's transposed solve: one warm step, then
# TRAIN_STEPS timed steps, each followed by its SGD update (the warm step's
# too, so no timed step repeats its masks). The step metric is the timed
# window over TRAIN_STEPS, the median step beside it. The ground-truth
# (all-ones mask) solve must succeed on TRAIN_MIN_SUCCESS of the lanes. The
# steps' partial-mask solves are harder: at the fresh MLP's masks 2 of the 8
# lanes of the seed-0 draw FAIL (lane 1 also in float64 on the CPU, in the
# port and in the JAX package alike), none after one SGD update (PERF.md
# §6); TRAIN_STEP_MIN_SUCCESS only catches a broken path.
TRAIN_B, TRAIN_STEPS, TRAIN_MIN_SUCCESS, TRAIN_STEP_MIN_SUCCESS = 8, 3, 0.9, 0.5
# Gradient checks at batch GRAD_B of the same game, θ noise from seed
# GRAD_SEED (a draw whose lanes solve at the first step). (1) float64 on
# the card at solve tolerance GRAD_SOLVE_TOL: the IFT directional derivative
# of the loss against finite differences, |fd − ift| / ‖g‖ ≤ FD_TOL, along
# the unit gradient (central differences at FD_STEP and FD_STEP/2, Richardson
# extrapolated: the loss curves strongly along the gradient, so a single
# central difference at 1e-3 is off by ~2e-3 of ‖g‖) and along a random
# unit direction (one central difference at FD_STEP). (2) The card's float32
# gradient against the CPU's float64 gradient of the same step (the card's
# inputs and weights, solve tolerance 1e-4): max|g32 − g64| / max|g64| ≤
# F32_GRAD_TOL. Each tolerance is ten to twenty times the floor measured on
# the card (PERF.md §6).
GRAD_B, GRAD_SEED, GRAD_SOLVE_TOL, FD_STEP = 2, 1, 1e-9, 2e-4
# The kernels whose device time per launch the profiles read (their names as
# the profiler records them): K2 (every route), and K7a's group route.
K2_KERNEL = r"\bls_(group_)?kernel<"
# K2 by route, and the shapes it runs at on the paths: the lane change
# (phase 4, path A, the horizon ranks) and the N=4 and N=10 flagships and
# the training step (B=8; phase 13 holds these to the games' dimensions).
K2_ROUTE_KERNELS = {"block": r"\bls_kernel<", "cluster": r"\bls_group_kernel<"}
K2_SHAPES = ((256, 200, 250), (8, 1200, 1470), (8, 3000, 3630))
K2_KINDS = ("feasible", "partly_feasible", "infeasible", "nan_direction", "edges")
K7A_GROUP_KERNEL = r"\bbabe_group_kernel<"
FD_TOL, F32_GRAD_TOL = 3e-8, 1e-4
GRAD_CPU_THREADS = 4  # the CPU float64 step's threads, beside the card's checks


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


def banded_wrappers():
    """The kernel wrappers the banded paths can reach, by short name."""
    from mcp_tpu_torch.kernels.cyclic_reduction import cr_thomas_solve
    from mcp_tpu_torch.kernels.linesearch import linesearch_update
    from mcp_tpu_torch.kernels.thomas import thomas_solve
    from mcp_tpu_torch.kernels.thomas_babe import babe_thomas_solve

    return {"thomas": thomas_solve, "babe": babe_thomas_solve, "cr": cr_thomas_solve,
            "linesearch": linesearch_update}


def reset_counts():
    """Set every banded wrapper's launch count to 0 (each fact's, for the
    wrappers that count per fact, and each route's, for K1)."""
    for w in banded_wrappers().values():
        w.launches = dict.fromkeys(w.launches, 0) if isinstance(w.launches, dict) else 0
        if hasattr(w, "route_launches"):
            w.route_launches = dict.fromkeys(w.route_launches, 0)


def read_counts():
    """A copy of every banded wrapper's launch count."""
    return {k: dict(w.launches) if isinstance(w.launches, dict) else w.launches
            for k, w in banded_wrappers().items()}


def read_routes():
    """A copy of the launch count per route of the wrappers that have two
    (K1: "warp"/"block"; K7a: "group"/"block")."""
    return {k: dict(w.route_launches) for k, w in banded_wrappers().items()
            if hasattr(w, "route_launches")}


def total(count):
    return sum(count.values()) if isinstance(count, dict) else count


def ab_ms(new, old, reps):
    """(new, old) mean milliseconds per call, timed in turns new, old, old,
    new (``cuda_ms`` each), so that drift of the card's clock falls on both."""
    t = [cuda_ms(fn, reps) for fn in (new, old, old, new)]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2


def plan_fields(plan):
    """A K1, K7a or K4a/K5 plan as the kernels line prints it."""
    return {k: (list(v) if isinstance(v, tuple) else v)
            for k, v in dataclasses.asdict(plan).items()}


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


def first_newton_bands(mcp, thetas, x=None):
    """The (diag, lower, upper, rhs) the solver hands its block-tridiagonal
    solve in the first inner step of a batch cold-started at x (default 0),
    y = s = 1."""
    import torch

    from mcp_tpu_torch.kernels.block_tridiag import (
        banded_newton_step_compressed,
        gh_banded_fast,
    )

    Bn, dtype, dev = thetas.shape[0], thetas.dtype, thetas.device
    n, m = mcp.unconstrained_dimension, mcp.constrained_dimension
    x = torch.zeros((Bn, n), dtype=dtype, device=dev) if x is None else x.to(dtype)
    y = torch.ones((Bn, m), dtype=dtype, device=dev)
    s = torch.ones((Bn, m), dtype=dtype, device=dev)
    st = mcp.time_structure
    ab = None if mcp.affine_bands is None else mcp.affine_bands.to(dtype=dtype)
    g, h, *bands = gh_banded_fast(mcp, st, x, y, thetas, affine_bands=ab)
    captured = []

    def capture(diag, lower, upper, rhs):
        captured.append((diag, lower, upper, rhs))
        return torch.zeros_like(rhs)

    banded_newton_step_compressed(*bands, y, s, g, h - s, s * y - 1.0, HEADLINE["tol"],
                                  st, algorithm=capture)
    return captured[0]


def lane_change_bands(dtype, device):
    """The lane-change first-Newton bands (B, 10, 20) of θ drawn from seed 11,
    in ``dtype``."""
    import torch

    from mcp_tpu_torch.bench import lane_change as lc

    bench = lc.generate_test_problem(horizon=10, device=device)
    th = lc.generate_parameter_batch(torch.Generator().manual_seed(11), B, bench,
                                     dtype=torch.float32, device=device)
    return first_newton_bands(bench.parametric_game.mcp, th.to(dtype))


def k1_check(name, args, tol, relative=False, route=None):
    """K1 qr against its plain version; with ``route``, the launch must
    have taken that route of ``thomas_plan``."""
    import torch

    from mcp_tpu_torch.kernels.thomas import thomas_solve, thomas_solve_plain

    before = dict(thomas_solve.route_launches)
    xk = thomas_solve(*args)
    torch.cuda.synchronize()
    if route is not None:
        took = [r for r, n in thomas_solve.route_launches.items() if n != before[r]]
        check(took == [route], f"K1 {name}: launched on route {took}, not {route!r}")
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


def phase_k1(device):
    import torch

    from mcp_tpu_torch.kernels.thomas import thomas_solve, thomas_solve_plain

    f32, f64 = torch.float32, torch.float64
    k1_check("random (256,10,20) f32", random_bands((256, 10, 20), f32, device, 1), K1_TOL)
    k1_check("random (64,10,20) f32", random_bands((64, 10, 20), f32, device, 2), K1_TOL)
    k1_check("random (3,7,5) f32", random_bands((3, 7, 5), f32, device, 3), K1_TOL)
    k1_check("random (256,10,20) f64", random_bands((256, 10, 20), f64, device, 4), K1_F64_TOL)
    k1_check("random (2,1,64) f64", random_bands((2, 1, 64), f64, device, 5), K1_F64_TOL)
    # The route boundaries: b <= 32 on the warp route (one warp per system,
    # registers), b = 33 on the block route; T = 1 and 10; both dtypes.
    from mcp_tpu_torch.kernels.thomas import thomas_plan

    for dtype, tol in ((f32, K1_TOL), (f64, K1_F64_TOL)):
        for b in (1, 20, 32, 33):
            for T in (1, 10):
                route = thomas_plan(b, "qr", dtype).route
                k1_check(f"random (16,{T},{b}) {str(dtype)[6:]} [{route}]",
                         random_bands((16, T, b), dtype, device, 70 + b + T), tol, route=route)
    real = lane_change_bands(f32, device)
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


def ls_case(kind, dtype, device, n=200, m=250, seed=0, batch=B):
    import torch

    rng = np.random.default_rng(seed)
    x, dx, rg = (rng.standard_normal((batch, n)) for _ in range(3))
    s, y = rng.uniform(0.01, 2.0, (batch, m)), rng.uniform(0.01, 2.0, (batch, m))
    ds, dy = 0.1 * rng.standard_normal((batch, m)), 0.1 * rng.standard_normal((batch, m))
    rh, rc = rng.standard_normal((batch, m)), rng.standard_normal((batch, m))
    if kind == "partly_feasible":
        ds[::2] = -7.3 * s[::2]
        dy[::2] = -2.9 * y[::2]
    elif kind == "infeasible":
        ds[1::2] = -s[1::2] / (1e-4 * 0.5 * 0.5)
    elif kind == "nan_direction":
        dx[0, 0] = np.nan
        ds[5, 1] = np.inf
        dy[10 % batch, 2] = np.nan
    elif kind == "edges":
        # The cases of K2's candidate scan (csrc/linesearch.cu, scan_of) on
        # finite directions, one lane each: s < 0 with ds > 0 (only the
        # largest candidates), ds = +0 and -0, ds = 0 with s < 0 (none, lane
        # 2), subnormal steps, a NaN slack (none, lane 4), a huge step (none,
        # lane 5), a subnormal s < 0 with ds > 0, y < 0 with dy > 0.
        tiny = 1e-40 if dtype == torch.float32 else 1e-310
        ds[[0, 6]], dy[7] = np.abs(ds[[0, 6]]), np.abs(dy[7])
        s[0, :5], ds[0, :5] = -0.5, 1.0
        ds[1, :3], ds[1, 3:6], dy[1, :4] = 0.0, -0.0, -0.0
        s[2, 0], ds[2, 0] = -1.0, 0.0
        ds[3] = tiny * np.sign(ds[3])
        s[4, 0] = np.nan
        ds[5, :4] = -1e30
        s[6, :3], ds[6, :3] = -tiny, tiny
        y[7, :2], dy[7, :2] = -0.3, 2.0
    return tuple(
        torch.tensor(a, dtype=dtype, device=device)
        for a in (x, dx, s, ds, y, dy, rg, rh, rc)
    )


def ls_bits(t):
    """A float tensor's bit patterns (equal bits: the same value, sign of
    zero and NaN payload)."""
    import torch

    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


def host_ms(fn, reps):
    """Mean host milliseconds per call of ``fn`` over ``reps`` calls back to
    back, not waiting on the device (which K2 keeps ahead of)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e3


def ls_route_check(name, routes, launches, Bn, n, m, dtype):
    """Every K2 launch of a path on the route its plan names at (Bn, n, m)."""
    from mcp_tpu_torch.kernels.linesearch import ls_plan

    route = ls_plan(Bn, n, m, dtype).route
    check(launches > 0 and routes[route] == launches,
          f"{name}: K2 launched off its plan's route {route!r}: {routes} of {launches}")
    return route


def phase_k2(device, shapes=((B, 200, 250),)):
    """K2 against its plain version on four kinds of step and the candidate
    scan's edge cases, in float32 and float64, at each (batch, n, m) of
    ``shapes``, on the plan's route (asserted) and on the block route forced
    by the plan where the plan takes another: the failure flags, kkt and
    x', s', y' bit for bit (and the iterates within K2_TOL). Then a grid
    that is not non-increasing, which the plan sends to the block route
    (asserted), bit for bit. Returns the max absolute float32 difference."""
    import torch

    from mcp_tpu_torch.kernels.linesearch import (
        linesearch_update,
        linesearch_update_plain,
        ls_plan,
    )
    from mcp_tpu_torch.solver import SolverOptions, linesearch_candidates

    o = SolverOptions()
    cands = linesearch_candidates(o.decay, o.min_stepsize)
    worst = 0.0

    def run(args, tag, plan, route, grid):
        before = dict(linesearch_update.route_launches)
        got = linesearch_update(*args, tau=o.tau, candidates=grid, plan=plan)
        torch.cuda.synchronize()
        took = [r for r, k in linesearch_update.route_launches.items() if k != before[r]]
        want = linesearch_update_plain(*args, tau=o.tau, candidates=grid)
        errs = [float(((g - w).abs() / w.abs().clamp(min=1.0)).max())
                for g, w in zip(got[:3], want[:3])]
        same = [bool(torch.equal(ls_bits(g), ls_bits(w))) for g, w in zip(got[:4], want[:4])]
        same_flags = bool(torch.equal(got[4], want[4]))
        nfail = int(got[4].sum())
        log(f"  K2 {tag}: failed lanes {nfail}/{args[0].shape[0]}, flags equal {same_flags}, "
            f"bits equal x/s/y/kkt {same}, max rel err x/s/y {max(errs):.3e} "
            f"(tol {K2_TOL:g})")
        check(took == [route], f"K2 {tag}: launched on route {took}")
        check(same_flags and same[3], f"K2 {tag}: flags or kkt differ")
        check(max(errs) <= K2_TOL, f"K2 {tag}: iterates differ")
        check(all(same), f"K2 {tag}: iterates not bit-equal to plain")
        return got, want, nfail

    for batch, n, m in shapes:
        for dtype in (torch.float32, torch.float64):
            plan = ls_plan(batch, n, m, dtype)
            plans = [None] + ([ls_plan(batch, n, m, dtype, route="block")]
                              if plan.route != "block" else [])
            for forced in plans:
                route = (forced or plan).route
                for kind in K2_KINDS:
                    args = ls_case(kind, dtype, device, n=n, m=m, batch=batch)
                    tag = f"{kind} ({batch},{n},{m}) {str(dtype)[6:]} [{route}]"
                    got, want, nfail = run(args, tag, forced, route, cands)
                    expect = {"feasible": nfail == 0, "partly_feasible": True,
                              "infeasible": 0 < nfail < batch, "nan_direction": nfail == 3,
                              "edges": nfail == 3}
                    check(expect[kind], f"K2 {tag}: unexpected failure count {nfail}")
                    if dtype == torch.float32:
                        worst = max(worst, max(float((g - w).abs().max()) for g, w in
                                               zip(got[:3], want[:3])))
        # The grid in increasing order: the cluster route's scan does not
        # take it, so the wrapper's plan is the block route.
        args = ls_case("partly_feasible", torch.float32, device, n=n, m=m, batch=batch)
        run(args, f"increasing grid ({batch},{n},{m}) float32 [block]", None, "block",
            tuple(reversed(cands)))
    return worst


# -- main path -------------------------------------------------------------


def phase_main_path(device, batch=B, k_batches=K_BATCHES, seed=2026, tier="tridiag_pallas",
                    fact="qr", name="main path", **overrides):
    """Drive the user entry points with the headline options on ``tier``
    (plus ``overrides``); K1 with ``fact`` must launch, and no other banded
    kernel. Returns (mcp, options, stack, result, launch counts)."""
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
    from mcp_tpu_torch.kernels.thomas import thomas_plan, thomas_solve

    t0 = time.perf_counter()
    bench = lc.generate_test_problem(horizon=10, device=device)
    mcp = bench.parametric_game.mcp
    log(f"  game built in {time.perf_counter() - t0:.2f} s: n={mcp.unconstrained_dimension} "
        f"m={mcp.constrained_dimension} p={mcp.parameter_dimension} "
        f"T={mcp.time_structure.num_blocks} b={mcp.time_structure.block_size}")
    options = SolverOptions(**{**HEADLINE, "linear_solver": tier, **overrides},
                            tightening_rate=auto_tightening_rate(mcp))
    gen = torch.Generator().manual_seed(seed)
    warm = lc.generate_parameter_batch(gen, batch, bench, dtype=torch.float32, device=device)
    stack = torch.stack([
        lc.generate_parameter_batch(gen, batch, bench, dtype=torch.float32, device=device)
        for _ in range(k_batches)
    ])
    solve_batch(mcp, warm, options=options)  # warm batch, untimed
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()

    reset_counts()
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
    launches = read_counts()
    routes = dict(thomas_solve.route_launches)
    ls_routes = read_routes()["linesearch"]
    device_s = start.elapsed_time(end) / 1e3 if device == "cuda" else float("nan")

    tk = true_kkt_errors(mcp, res, stack)
    stats = batch_statistics(res)
    solved = res.status == SOLVED
    n_inst = batch * k_batches
    certified = int((solved & (tk <= options.tol)).sum())
    stats.update(
        instances=n_inst,
        certified=certified,
        frac_true_kkt_at_tol=float((tk <= options.tol).double().mean()),
        true_kkt_max_solved=float(tk[solved].max()) if bool(solved.any()) else float("nan"),
        certified_solves_per_s=certified / device_s,
        window_s_events=device_s,
        window_s_host=wall_s,
        launches=launches,
        thomas_routes=routes,
        linesearch_routes=ls_routes,
    )
    log(f"  {name} ({tier}): " + json.dumps(stats))
    check(tuple(res.x.shape) == (k_batches, batch, mcp.unconstrained_dimension),
          f"{name}: result shape")
    check(bool(torch.isfinite(res.x[solved]).all()), f"{name}: non-finite solved x")
    check(stats["success_rate"] >= 0.99, f"{name}: success {stats['success_rate']} < 0.99")
    check(not bool((solved & (tk > options.tol)).any()),
          f"{name}: a SOLVED lane has true KKT above tol")
    others = {k: v for k, v in launches["thomas"].items() if k != fact}
    check(launches["thomas"][fact] > 0 and launches["linesearch"] > 0,
          f"{name}: a kernel never launched {launches}")
    check(not any(others.values()) and not total(launches["babe"]) and not total(launches["cr"]),
          f"{name}: another banded kernel launched {launches}")
    route = thomas_plan(mcp.time_structure.block_size, fact, torch.float32).route
    check(routes[route] == launches["thomas"][fact],
          f"{name}: K1 launched off its plan's route {route!r}: {routes}")
    ls_route_check(name, ls_routes, launches["linesearch"], batch,
                   mcp.unconstrained_dimension, mcp.constrained_dimension, torch.float32)
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


# -- K4a, K4b/K4c, K5 ------------------------------------------------------


def spd_systems(Bn, n, dtype, device, seed):
    """P·Pᵀ + n·I and a standard normal right side."""
    import torch

    rng = np.random.default_rng(seed)
    P = rng.standard_normal((Bn, n, n))
    arrs = (P @ P.transpose(0, 2, 1) + n * np.eye(n), rng.standard_normal((Bn, n)))
    return tuple(torch.tensor(a, dtype=dtype, device=device) for a in arrs)


def random_systems(Bn, n, dtype, device, seed):
    """Standard normal plus n·I (the JAX kernel tests' construction)."""
    import torch

    rng = np.random.default_rng(seed)
    arrs = (rng.standard_normal((Bn, n, n)) + n * np.eye(n), rng.standard_normal((Bn, n)))
    return tuple(torch.tensor(a, dtype=dtype, device=device) for a in arrs)


def saddle_systems(Bn, n, dtype, device, seed):
    """[[M, C], [Cᵀ, 1e-4·I]] with M SPD: interior-point saddle systems with
    ~tol diagonal rows, which break pivot-free elimination but not QR."""
    import torch

    rng = np.random.default_rng(seed)
    h = n // 2
    P = rng.standard_normal((Bn, h, h))
    M = P @ P.transpose(0, 2, 1) + np.eye(h)
    C = rng.standard_normal((Bn, h, h))
    low = np.broadcast_to(1e-4 * np.eye(h), (Bn, h, h))
    A = np.concatenate([np.concatenate([M, C], 2),
                        np.concatenate([C.transpose(0, 2, 1), low], 2)], 1)
    arrs = (A, rng.standard_normal((Bn, n)))
    return tuple(torch.tensor(a, dtype=dtype, device=device) for a in arrs)


def qp_schur_system(mcp, thetas, x, y, s, tol):
    """The n×n Schur system (A, b) that the QP path hands the dense solve at
    the iterate (x, y, s): the Mehrotra predictor's right side, reg = tol."""
    from mcp_tpu_torch.linalg import _schur_system
    from mcp_tpu_torch.solver import _make_linearizer

    g, h, Gx, Gy, Hx, _ = _make_linearizer(mcp, thetas, thetas.dtype)(x, y)
    A, b, *_ = _schur_system(Gx, Gy, Hx, y, s, g, h - s, s * y, tol)
    return A, b


def backward_error(A, b, x):
    """Max over systems of ‖Ax−b‖∞/(‖A‖∞‖x‖∞ + ‖b‖∞), in float64."""
    A, b, x = A.double(), b.double(), x.double()
    r = ((A @ x[..., None])[..., 0] - b).abs().amax(dim=1)
    return float((r / (A.abs().sum(dim=2).amax(dim=1) * x.abs().amax(dim=1)
                       + b.abs().amax(dim=1))).max())


def dense_check(name, fn, plain, A, b, plan=None):
    """Kernel against plain on (A, b), with GJ_TOL for the Gauss–Jordan
    kernels (K4a/K5 on ``plan``, default ``gj_plan``'s); the QR kernels
    (K4b/K4c on ``plan``, default ``qr_plan``'s, K8a, K8b) are held to
    QR_TOL (condition-scaled) and to QR_BWD_TOL (backward error,
    condition-free). Returns the max absolute difference."""
    import torch

    from mcp_tpu_torch.kernels.linear_solve import (
        gauss_solve,
        gj_plan,
        pallas_gauss_solve,
        qr_plan,
        wy_plan,
        wy_solve,
    )

    routes = dict(getattr(fn, "route_launches", {}))
    got = fn(A, b) if plan is None else fn(A, b, plan=plan)
    torch.cuda.synchronize()
    if routes:
        # K4a/K5, K4b/K4c, K8b: the launch took the route of its plan.
        n = A.shape[-1]
        want_route = (plan or (qr_plan(n, A.dtype) if fn is gauss_solve
                               else wy_plan(n, 8, A.dtype) if fn is wy_solve
                               else gj_plan(n, isinstance(got, tuple), A.dtype))).route
        took = [r for r, k in fn.route_launches.items() if k != routes[r]]
        check(took == [want_route], f"{name}: launched on route {took}, not {want_route!r}")
    want = plain(A, b)
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    rel = max(float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
              for g, w in zip(got, want))
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    bwd_k, bwd_p = backward_error(A, b, got[0]), backward_error(A, b, want[0])
    tag = str(A.dtype)[6:]
    qr = fn in (gauss_solve, pallas_gauss_solve, wy_solve)
    if qr:
        kappa = torch.linalg.cond(A.double())
        per = (got[0] - want[0]).abs().amax(dim=1) / want[0].abs().amax(dim=1).clamp(min=1e-30)
        measure, tol = float((per.double() / kappa).max()), QR_TOL[tag]
        what = f"max_i |kernel-plain|_i/(|plain|_i·κ_i)={measure:.3e} (max κ {float(kappa.max()):.2e})"
    else:
        measure, tol = rel, GJ_TOL
        what = f"max|kernel-plain|/max|plain|={rel:.3e}"
    log(f"  {name}: {what} (tol {tol:g}); unscaled {rel:.3e}; backward error kernel "
        f"{bwd_k:.3e} plain {bwd_p:.3e}"
        + (f" (tol {QR_BWD_TOL[tag]:.3e})" if qr else ""))
    check(all(bool(torch.isfinite(g).all()) for g in got), f"{name}: non-finite kernel output")
    check(measure <= tol, f"{name}: kernel and plain differ by {measure:.3e} > {tol:g}")
    if qr:
        check(bwd_k <= QR_BWD_TOL[tag],
              f"{name}: kernel backward error {bwd_k:.3e} > {QR_BWD_TOL[tag]:.3e}")
    return err


def phase_dense_kernels(device):
    """K4a, K4b/K4c and K5 against their plain versions on the card, in
    float32 and float64: random SPD, random and saddle-point systems, the
    real QP Schur systems at the cold start and at the returned (late)
    Mehrotra iterate, and a zero pivot; each launch asserted on its plan's
    route, and each kernel also on its block route forced and beyond its
    register route's range. Returns (cold-start f32 Schur system, {kernel:
    max abs error on the real f32 systems})."""
    import torch

    from mcp_tpu_torch import SolverOptions, solve_batch
    from mcp_tpu_torch.bench import qp
    from mcp_tpu_torch.kernels import linear_solve as L

    f32, f64 = torch.float32, torch.float64
    gj = ("gj_solve", L.gj_solve, L.gj_solve_plain)
    gji = ("gji_solve", L.gji_solve, L.gji_solve_plain)
    qr = ("gauss_solve", L.gauss_solve, L.qr_solve_plain)
    for dtype in (f32, f64):
        tag = str(dtype)[6:]
        spd = spd_systems(B, QP_N, dtype, device, 21)
        for name, fn, plain in (gj, gji, qr):
            dense_check(f"{name} SPD (256,100) {tag}", fn, plain, *spd)
        for what, systems in (
            ("random (256,100)", random_systems(B, QP_N, dtype, device, 22)),
            ("saddle (256,12)", saddle_systems(B, 12, dtype, device, 23)),
            ("saddle (256,100)", saddle_systems(B, QP_N, dtype, device, 26)),
            ("random (5,10)", random_systems(5, 10, dtype, device, 24)),
        ):
            dense_check(f"gauss_solve {what} {tag}", L.gauss_solve, L.qr_solve_plain, *systems)
        # K4b/K4c: every check above ran on the plan's route (the pair route
        # in both dtypes). The block route: (256,100) forced by the plan, the
        # other half of phase 10's A/B, and the first order over the pair
        # route (n = 128 in float32, 105 in float64).
        check(L.qr_plan(QP_N, dtype).route == "pair", f"gauss_solve: n={QP_N} in {tag} "
              "is not on the pair route")
        dense_check(f"gauss_solve SPD (256,100) {tag} [block, forced]", L.gauss_solve,
                    L.qr_solve_plain, *spd, plan=L.qr_plan(QP_N, dtype, route="block"))
        beyond = next(n for n in range(1, 129) if L.qr_plan(n, dtype).route == "block")
        dense_check(f"gauss_solve random (256,{beyond}) {tag} [block]", L.gauss_solve,
                    L.qr_solve_plain, *random_systems(B, beyond, dtype, device, 32))
        # K4a/K5 over the tile route's range: n = 12 and 128 (its edge) and
        # a batch of 5 at n = 10.
        for what, systems in (
            ("SPD (256,12)", spd_systems(B, 12, dtype, device, 27)),
            ("SPD (256,128)", spd_systems(B, 128, dtype, device, 28)),
            ("random (5,10)", random_systems(5, 10, dtype, device, 29)),
        ):
            for name, fn, plain in (gj, gji):
                dense_check(f"{name} {what} {tag}", fn, plain, *systems)
        # The block route: n = 129, the first order over the tile route
        # (gji in float64 is refused there: [A | b | I] is over a block's
        # shared memory), and (256,100) on the block route forced by the
        # plan, the other half of phase 10's A/B.
        at129 = spd_systems(B, 129, dtype, device, 30)
        for name, fn, plain in ((gj, gji) if dtype == f32 else (gj,)):
            inverse = fn is L.gji_solve
            check(L.gj_plan(129, inverse, dtype).route == "block",
                  f"{name}: n=129 in {tag} is not on the block route")
            dense_check(f"{name} SPD (256,129) {tag} [block]", fn, plain, *at129)
            dense_check(f"{name} SPD (256,100) {tag} [block, forced]", fn, plain, *spd,
                        plan=L.gj_plan(QP_N, inverse, dtype, route="block"))

    problem = qp.generate_test_problem(num_primals=QP_N, num_inequalities=QP_N, device=device)
    mcp = problem.mcp
    gen = torch.Generator().manual_seed(31)
    th = qp.generate_parameter_batch(gen, B, num_primals=QP_N, num_inequalities=QP_N,
                                     dtype=f32, device=device)
    late = solve_batch(mcp, th, options=SolverOptions(**QP_OPTIONS))
    errs = {}
    cold = None
    for dtype in (f32, f64):
        tag = str(dtype)[6:]
        t = th.to(dtype)
        zeros = torch.zeros((B, QP_N), dtype=dtype, device=device)
        ones = torch.ones((B, QP_N), dtype=dtype, device=device)
        systems = (
            ("cold start", qp_schur_system(mcp, t, zeros, ones, ones, QP_OPTIONS["tol"])),
            ("late Mehrotra iterate", qp_schur_system(
                mcp, t, late.x.to(dtype), late.y.to(dtype), late.s.to(dtype),
                QP_OPTIONS["tol"])),
        )
        if dtype == f32:
            cold = systems[0][1]
        for where, (A, b) in systems:
            for name, fn, plain in (gj, gji, qr):
                err = dense_check(f"{name} QP Schur, {where} (256,100) {tag}", fn, plain, A, b)
                if dtype == f32:
                    errs[name] = max(errs.get(name, 0.0), err)

    # A zero pivot: system 2 has a zero first row and column. GJ gives huge
    # finite values there (the 1e-30 pivot guard), QR inf/NaN; the other
    # systems are untouched and agree with the plain version.
    A, b = spd_systems(4, QP_N, f32, device, 25)
    A[2, 0, :] = 0.0
    A[2, :, 0] = 0.0
    # K4a/K5 and K4b/K4c on their plan's route, then on the block route
    # forced.
    cases = [(name, fn, plain, None) for name, fn, plain in (gj, gji, qr)]
    cases += [(f"{name} [block, forced]", fn, plain,
               L.gj_plan(QP_N, fn is L.gji_solve, f32, route="block"))
              for name, fn, plain in (gj, gji)]
    cases.append(("gauss_solve [block, forced]", L.gauss_solve, L.qr_solve_plain,
                  L.qr_plan(QP_N, f32, route="block")))
    for name, fn, plain, plan in cases:
        routes = dict(fn.route_launches)
        got = fn(A, b) if plan is None else fn(A, b, plan=plan)
        want = plain(A, b)
        torch.cuda.synchronize()
        x, xp = (got[0], want[0]) if isinstance(got, tuple) else (got, want)
        want_route = (plan or (L.qr_plan(QP_N, f32) if fn is L.gauss_solve
                               else L.gj_plan(QP_N, fn is L.gji_solve, f32))).route
        took = [r for r, k in fn.route_launches.items() if k != routes[r]]
        check(took == [want_route], f"{name} zero pivot: launched on route {took}, "
              f"not {want_route!r}")
        bad = (~torch.isfinite(x).all(dim=1)).tolist()
        bad_p = (~torch.isfinite(xp).all(dim=1)).tolist()
        big = float(x[2].abs().max())
        others = float((x[[0, 1, 3]] - xp[[0, 1, 3]]).abs().max())
        log(f"  {name} zero pivot: non-finite systems kernel={bad} plain={bad_p}, "
            f"max|x| of system 2 {big:.3e}, other systems max|kernel-plain| {others:.3e}")
        if fn is L.gauss_solve:
            check(bad == [False, False, True, False] and bad_p == bad,
                  f"{name} zero pivot: expected inf/NaN in system 2 only")
        else:
            check(not any(bad) and not any(bad_p) and big > 1e20,
                  f"{name} zero pivot: expected huge finite values in system 2")
        check(others <= 1e-3 * float(xp[[0, 1, 3]].abs().max()),
              f"{name} zero pivot: the other systems changed")
    return cold, errs


# -- QP path ---------------------------------------------------------------


def certify64(mcp, res, thetas):
    """‖(g, h−s, s∘y)‖∞ per lane, recomputed in float64 at the returned
    iterate (the solver's own residual is float32)."""
    from mcp_tpu_torch.bench.harness import true_kkt_errors

    res64 = res._replace(x=res.x.double(), y=res.y.double(), s=res.s.double())
    return true_kkt_errors(mcp, res64, thetas.double())


def phase_qp_path(device, batch=B, k_batches=K_BATCHES, seed=2027):
    """The QP suite through the user entry points: one untimed warm batch,
    then 8 fresh batches through solve_batches_streamed, CUDA-event timed,
    with K4a's launch count set to 0 just before and read just after."""
    import torch

    from mcp_tpu_torch import (
        SOLVED,
        SolverOptions,
        auto_tightening_rate,
        batch_statistics,
        solve_batch,
        solve_batches_streamed,
    )
    from mcp_tpu_torch.bench import qp
    from mcp_tpu_torch.kernels import linear_solve as L

    problem = qp.generate_test_problem(num_primals=QP_N, num_inequalities=QP_N, device=device)
    mcp = problem.mcp
    options = SolverOptions(**QP_OPTIONS, tightening_rate=auto_tightening_rate(mcp))
    gen = torch.Generator().manual_seed(seed)
    draw = lambda: qp.generate_parameter_batch(
        gen, batch, num_primals=QP_N, num_inequalities=QP_N, device=problem.device)
    warm = draw()
    stack = torch.stack([draw() for _ in range(k_batches)])
    solve_batch(mcp, warm, options=options)  # warm batch, untimed
    torch.cuda.synchronize()

    L.gj_solve.launches = 0
    L.gj_solve.route_launches = dict.fromkeys(L.gj_solve.route_launches, 0)
    t1 = time.perf_counter()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    res = solve_batches_streamed(mcp, stack, options=options)
    end.record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t1
    launches = L.gj_solve.launches
    routes = dict(L.gj_solve.route_launches)
    device_s = start.elapsed_time(end) / 1e3

    tk = certify64(mcp, res, stack)
    stats = batch_statistics(res)
    solved = res.status == SOLVED
    n_inst = batch * k_batches
    certified = int((solved & (tk <= options.tol)).sum())
    stats.update(
        instances=n_inst,
        certified=certified,
        certified_solves_per_s=certified / device_s,
        batch_latency_s=device_s / k_batches,
        frac_true_kkt64_at_tol=float((tk <= options.tol).double().mean()),
        true_kkt64_max_solved=float(tk[solved].max()) if bool(solved.any()) else float("nan"),
        window_s_events=device_s,
        window_s_host=wall_s,
        gj_launches=launches,
        gj_routes=routes,
        tightening_rate=options.tightening_rate,
    )
    log("  QP path: " + json.dumps(stats))
    check(tuple(res.x.shape) == (k_batches, batch, QP_N), "QP path: result shape")
    check(bool(torch.isfinite(res.x[solved]).all()), "QP path: non-finite solved x")
    check(stats["success_rate"] >= QP_MIN_SUCCESS,
          f"QP path: success {stats['success_rate']} < {QP_MIN_SUCCESS}")
    check(not bool((solved & (tk > options.tol)).any()),
          "QP path: a SOLVED lane has float64 true KKT above tol")
    check(launches > 0, "QP path: K4a (gj_solve) never launched")
    route = L.gj_plan(QP_N, False, torch.float32).route
    check(routes[route] == launches,
          f"QP path: K4a launched off its plan's route {route!r}: {routes}")
    return mcp, options, stack, res, launches


def phase_qp_tiers(mcp, options, device, seed=2028):
    """One batch of 256 fresh θ on tier "schur_pallas" (Mehrotra, K4b/K4c)
    and one on "schur_pallas_gjr" with algorithm "ip" (K5), each with its
    kernel's launch counts set to 0 just before and read just after: every
    launch on its plan's route."""
    import dataclasses

    import torch

    from mcp_tpu_torch import SOLVED, solve_batch
    from mcp_tpu_torch.bench import qp
    from mcp_tpu_torch.kernels import linear_solve as L

    gen = torch.Generator().manual_seed(seed)
    launches = {}
    for tier, algorithm, wrapper in (("schur_pallas", "mehrotra", L.gauss_solve),
                                     ("schur_pallas_gjr", "ip", L.gji_solve)):
        th = qp.generate_parameter_batch(gen, B, num_primals=QP_N, num_inequalities=QP_N,
                                         device=device)
        opts = dataclasses.replace(options, linear_solver=tier, algorithm=algorithm)
        wrapper.launches = 0
        wrapper.route_launches = dict.fromkeys(wrapper.route_launches, 0)
        res = solve_batch(mcp, th, options=opts)
        torch.cuda.synchronize()
        launches[wrapper.__name__] = wrapper.launches
        # Every launch of the tier batch on the plan's route (K5: gj_plan's,
        # K4b/K4c: qr_plan's).
        route = (L.gj_plan(QP_N, True, torch.float32) if wrapper is L.gji_solve
                 else L.qr_plan(QP_N, torch.float32)).route
        check(wrapper.route_launches[route] == wrapper.launches,
              f"tier {tier}: {wrapper.__name__} launched off its plan's route {route!r}: "
              f"{wrapper.route_launches}")
        tk = certify64(mcp, res, th)
        solved = res.status == SOLVED
        log(f"  tier {tier} ({algorithm}): success {float(solved.double().mean())}, "
            f"median iterations {float(res.outer_iters.double().median())}, "
            f"{wrapper.__name__} launches {wrapper.launches} (by route "
            f"{wrapper.route_launches}), max float64 true KKT of "
            f"a SOLVED lane {float(tk[solved].max()) if bool(solved.any()) else float('nan'):.3e}")
        check(wrapper.launches > 0, f"tier {tier}: {wrapper.__name__} never launched")
        check(not bool((solved & (tk > options.tol)).any()),
              f"tier {tier}: a SOLVED lane has float64 true KKT above tol")
    return launches


def phase_qp_reference(options, stack, res):
    """Eight QP lanes solved on the CPU in float64 with the plain versions
    must agree with the card's float32 kernels: same status, x within
    QP_REF_REL_TOL of max|x|."""
    import torch

    from mcp_tpu_torch import solve_batch
    from mcp_tpu_torch.bench import qp

    cpu = qp.generate_test_problem(num_primals=QP_N, num_inequalities=QP_N, device="cpu")
    th = stack[0, :8].double().cpu()
    ref = solve_batch(cpu.mcp, th, options=options)
    status, x = res.status[0, :8].cpu(), res.x[0, :8].double().cpu()
    rel = float((ref.x - x).abs().max() / ref.x.abs().max())
    log(f"  QP reference (CPU f64 plain) vs card (f32 kernels), 8 lanes: status "
        f"{ref.status.tolist()} vs {status.tolist()}, iterations "
        f"{ref.outer_iters.tolist()} vs {res.outer_iters[0, :8].tolist()}, "
        f"max|dx|/max|x|={rel:.3e} (tol {QP_REF_REL_TOL:g})")
    check(torch.equal(ref.status, status), "QP reference: status differs")
    check(rel <= QP_REF_REL_TOL, f"QP reference: x differs by {rel:.3e}")


# -- profile ---------------------------------------------------------------


def profile_call(fn, span_names, on_card=True):
    """``fn()`` once under torch.profiler: host time per span, the device's
    busy and idle share, the kernels that ran, the host syncs, and the host
    time of the IFT's backward node (``_IFTSolveBackward``, the autograd
    engine's evaluation of it). (The profiler itself slows the host;
    shares, not times, are the point.)"""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    if on_card:
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        if on_card:
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # The raw Kineto events: building prof.events()' Python tree of a
    # residual-heavy step (over a million CPU ops) takes minutes.
    events = prof.profiler.kineto_results.events()
    host = {name: {"ms": 0.0, "count": 0} for name in span_names}
    by_kernel, intervals, ift_backward_ns, syncs = {}, [], 0, 0
    for e in events:
        name, on_cpu = e.name(), e.device_type() == DeviceType.CPU
        if name in span_names:  # a span: its CPU range (and a GPU mirror)
            if on_cpu:
                host[name]["ms"] += e.duration_ns() / 1e6
                host[name]["count"] += 1
        elif e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            intervals.append((e.start_ns() / 1e3, e.end_ns() / 1e3))
            t = by_kernel.setdefault(name, [0.0, 0])
            t[0] += e.duration_ns() / 1e3
            t[1] += 1
        elif name == "cudaStreamSynchronize":
            syncs += 1
        elif name.startswith("autograd::engine::evaluate_function: _IFTSolveBackward"):
            ift_backward_ns += e.duration_ns()
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
        "host_syncs": syncs,
        "host_spans": host,
        "ift_backward_host_ms": ift_backward_ns / 1e6,
        "top_kernels": {k[:70]: [round(v[0] / 1e3, 3), v[1]] for k, v in top},
        "kernels_by_name": by_kernel,
    }
    check(not on_card or len(intervals) > 0, "profile: no device activity recorded")
    return out


def phase_profile(mcp, options, thetas, x0=None):
    """One batch of ``solve_batch`` under torch.profiler (``profile_call``)."""
    from mcp_tpu_torch import solve_batch
    from mcp_tpu_torch import solver as S

    out = profile_call(lambda: solve_batch(mcp, thetas, x0=x0, options=options),
                       (S.SPAN_RESIDUAL, S.SPAN_NEWTON, S.SPAN_LINESEARCH, S.SPAN_LOOP_TEST),
                       thetas.device.type == "cuda")
    del out["ift_backward_host_ms"]
    log("  profile (one batch): " + json.dumps(shown(out)))
    return out


def shown(profile):
    """A ``profile_call`` result without its per-kernel table, for the log."""
    return {k: v for k, v in profile.items() if k != "kernels_by_name"}


def device_ms_per_launch(profile, pattern):
    """(mean device milliseconds per launch, launches) of the kernels whose
    name matches ``pattern`` in a ``profile_call`` result: the card's own
    time for each launch, without the host's cost of issuing it."""
    us = n = 0
    for name, (t, count) in profile["kernels_by_name"].items():
        if re.search(pattern, name):
            us += t
            n += count
    return (us / n / 1e3 if n else None), n


# -- timing ----------------------------------------------------------------


def aug_flops(b, nrhs, fact):
    """Operations of one in-block solve of b×(b + nrhs) by ``fact``, counted
    from the loops of ``csrc/solve_aug.cuh``: QR's column norms, uᵀM and
    rank-1 updates and the back substitution; Gauss–Jordan's multipliers,
    pivot-row scaling and row updates over the columns each step touches
    (every column for gjp, those right of the pivot for gj), gjp's pivot
    scores (3 per row and step) and head contraction; the blocked facts'
    panel steps (u, the slab right of the step's column, W) and trailing
    products; with refinement the identity columns and per step A·X, the
    residual, A⁻¹·E and the update."""
    from mcp_tpu_torch.kernels.solve_aug import FACT_CODES, GJB_PANEL

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


def thomas_counts(Bn, T, b, shared_bands, itemsize=4, fact="qr"):
    """(bytes, flops) the sweep needs: inputs read once, x written once;
    flops of the forward elimination, the in-block solve of each step
    (``aug_flops``) and both substitutions."""
    band = (T - 1) * b * b * itemsize * (1 if shared_bands else Bn)
    nbytes = Bn * T * b * b * itemsize + 2 * band + 2 * Bn * T * b * itemsize
    elim = 2 * b * b * (b + 1)  # L·[C | d], steps t ≥ 1
    bwd = 2 * b * b
    flops = Bn * (T * (aug_flops(b, b + 1, fact) + bwd) + (T - 1) * elim)
    return nbytes, flops


def dense_counts(kind, Bn, n, itemsize=4):
    """(bytes, flops) of one batched dense solve: A and b read once, x (and
    A⁻¹) written once; the operations the algorithm does on these inputs.
    GJ: per step the n multipliers, row k scaled and n−1 rows updated over
    the live columns: the n−k right of the pivot for [A | b], n+1 with the
    inverse (A right of the pivot, b, identity columns 0..k; row k is 0 on
    the later identity columns, so they take no work). QR: per reflection the column norm, uᵀM and the rank-1 update
    over the (n−k)×(n+1−k) trailing block, then the back substitution."""
    if kind == "qr":
        per = sum(2 * j + 4 * j * (j + 1) for j in range(1, n + 1)) + n * (n + 1)
        out = n
    else:
        live = [n + 1 if kind == "gji" else n - k for k in range(n)]
        per = sum(n + 1 + (2 * n - 1) * c for c in live)
        out = n + (n * n if kind == "gji" else 0)
    return Bn * (n * n + n + out) * itemsize, Bn * per


def bound(nbytes, flops):
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def ls_counts(Bn, n, m, K, itemsize=4):
    """(bytes, flops) of one K2 call: x, dx, rg, s, ds, y, dy, rh, rc read
    once, x', s', y', kkt and the flag written once; per m entry K products
    and compares for each of the two masks, per entry the update's multiply
    and add and the norm's compare."""
    nbytes = Bn * ((3 * n + 6 * m) + (n + 2 * m) + 1) * itemsize + Bn
    return nbytes, Bn * (2 * K * 2 * m + 2 * (n + 2 * m) + (n + 2 * m))


def k2_timing(device):
    """K2 at the paths' shapes (K2_SHAPES): the plan's route against the
    block route forced by the plan where the plan takes another, the card's
    own time per launch from one profile of 20 calls each, beside
    back-to-back wrapper calls in turns (CUDA events; they measure the host
    issuing the calls). Returns (the readings by shape, the main path's
    shape's entry of the kernels line)."""
    import torch

    from mcp_tpu_torch.kernels.linesearch import (
        linesearch_update,
        linesearch_update_plain,
        ls_plan,
    )
    from mcp_tpu_torch.solver import SolverOptions, linesearch_candidates

    o = SolverOptions()
    cands = linesearch_candidates(o.decay, o.min_stepsize)
    k2_shapes = {}
    for Bk, nk, mk in K2_SHAPES:
        args = ls_case("partly_feasible", torch.float32, device, n=nk, m=mk, batch=Bk)
        plan = ls_plan(Bk, nk, mk, torch.float32)
        plans = [plan] + ([ls_plan(Bk, nk, mk, torch.float32, route="block")]
                          if plan.route != "block" else [])
        calls = [(lambda p=p: linesearch_update(*args, tau=o.tau, candidates=cands, plan=p))
                 for p in plans]
        dev = route_device_ms(calls, [K2_ROUTE_KERNELS[p.route] for p in plans])
        wrap = ab_ms(*calls, 200) if len(calls) == 2 else (cuda_ms(calls[0], 200),)
        k2_b, k2_by = bound(*ls_counts(Bk, nk, mk, len(cands)))
        entry = {"plan": plan_fields(plan), "device_ms": dev[0], "wrapper_ms": wrap[0],
                 "bound_ms": k2_b, "bound_by": k2_by}
        if len(plans) == 2:
            entry.update(block_device_ms=dev[1], block_wrapper_ms=wrap[1])
        k2_shapes[f"({Bk},{nk},{mk})"] = entry
        log(f"  K2 ({Bk},{nk},{mk}) float32: device time per launch {dev[0]:.5f} ms on route "
            f"{plan.route} (group {plan.group}, slots {plan.slots}, cluster {plan.cluster})"
            + (f", block route {dev[1]:.5f} ms" if len(plans) == 2 else "")
            + f" (profiled); wrapper calls back to back {' / '.join(f'{w:.5f}' for w in wrap)}"
            f" ms{', in turns' if len(plans) == 2 else ''}; bound {k2_b:.5f} ms by {k2_by}")
        if (Bk, nk, mk) == K2_SHAPES[0]:
            k2_plain = cuda_ms(lambda: linesearch_update_plain(*args, tau=o.tau,
                                                               candidates=cands), 20)
            k2_main = dict(plan=plan_fields(plan), ms=dev[0], wrapper_ms=wrap[0],
                           host_ms=host_ms(calls[0], 500), plain_ms=k2_plain, bound_ms=k2_b,
                           bound_by=k2_by)
            log(f"  K2 wrapper, host time per call: {k2_main['host_ms']:.5f} ms")
    return k2_shapes, k2_main


def k8b_device_ms(schur):
    """K8b's device time per launch at the cold-start QP Schur systems
    (padded to 104), in float32 and float64: the plan's route, the block
    route forced by the plan where the plan takes another, and K4b's pair
    route, in one profile each (taken before any rank is spawned: phase 35
    reports them)."""
    import torch

    from mcp_tpu_torch.kernels import linear_solve as L

    A, b = schur
    Bn, n, _ = A.shape
    k8b_device = {}
    for dt in (torch.float32, torch.float64):
        Ad, bd, tname = A.to(dt), b.to(dt), "float" if dt == torch.float32 else "double"
        # The plan's route (pair in float32, block in float64), the block
        # route forced by the plan where the plan takes another, K4b's pair.
        plan, k4b = L.wy_plan(n, 8, dt), L.qr_plan(n, dt)
        routes = {plan.route: plan, "block": L.wy_plan(n, 8, dt, route="block")}
        names = {"pair": rf"\bwy_pair_kernel<{tname}", "block": rf"\bwy_kernel<{tname}"}
        calls = [(lambda p=p: L.wy_solve(Ad, bd, plan=p)) for p in routes.values()]
        k8b_device[str(dt)[6:]] = dict(zip((*routes, "k4b_pair"), route_device_ms(
            (*calls, lambda: L.gauss_solve(Ad, bd, plan=k4b)),
            (*(names[r] for r in routes), rf"\bqr_pair_kernel<{tname}"))))
        log(f"  K8b ({Bn},{n} -> 104) {str(dt)[6:]}: device time per launch "
            f"{k8b_device[str(dt)[6:]]} ms (profiled; the plan takes {plan.route})")
    return k8b_device


def phase_timing(real_bands, k1_err, k2_err, launches, device, schur, dense_errs,
                 dense_launches):
    import torch

    from mcp_tpu_torch.kernels.thomas import thomas_plan, thomas_solve, thomas_solve_plain

    diag, lower, upper, rhs = real_bands
    Bn, T, b, _ = diag.shape
    shared = lower.stride(0) == 0
    # The plan's route against the block route forced by the plan, in turns.
    k1_plan = thomas_plan(b, "qr", diag.dtype)
    k1_old_plan = thomas_plan(b, "qr", diag.dtype, route="block")
    k1_ms, k1_old = ab_ms(lambda: thomas_solve(diag, lower, upper, rhs, plan=k1_plan),
                          lambda: thomas_solve(diag, lower, upper, rhs, plan=k1_old_plan), 50)
    k1_plain = cuda_ms(lambda: thomas_solve_plain(diag, lower, upper, rhs), 3)
    # float64: the warp route against the block route, both forced, in
    # turns, for every fact the warp route takes in float64: qr, gj and gjp
    # on these bands, gjpr (over the register budget at b = 20) on random
    # bands at b = 16.
    f64 = torch.float64
    bands64 = tuple(a[:1].double().expand(a.shape) if a.stride(0) == 0 else a.double()
                    for a in real_bands)
    k1_f64 = {}
    for fact, args in (("qr", bands64), ("gj", bands64), ("gjp", bands64),
                       ("gjpr", random_bands((Bn, T, 16), f64, device, 95))):
        b64 = args[0].shape[-1]
        warp, block = (thomas_plan(b64, fact, f64, route=r) for r in ("warp", "block"))
        warp_ms, block_ms = ab_ms(lambda: thomas_solve(*args, fact=fact, plan=warp),
                                  lambda: thomas_solve(*args, fact=fact, plan=block), 20)
        k1_f64[f"{fact} b={b64}"] = {"plan_route": thomas_plan(b64, fact, f64).route,
                                     "warp_ms": warp_ms, "block_ms": block_ms}
        log(f"  K1 {fact} ({Bn},{T},{b64}) float64: warp route {warp_ms:.4f} ms, block route "
            f"{block_ms:.4f} ms; the plan takes {k1_f64[f'{fact} b={b64}']['plan_route']}")
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

    k2_shapes, k2_main = k2_timing(device)
    kernels = [
        {"name": "thomas_solve", "route": "cuda",
         "source": "mcp_tpu_torch/kernels/csrc/thomas.cu",
         "replaces": "mcp_tpu/kernels/thomas_pallas.py:852",
         "launches": launches["thomas"]["qr"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": k1_lib,
         "plan": plan_fields(k1_plan), "old_route_ms": k1_old, "float64_routes": k1_f64},
        {"name": "linesearch_update", "route": "cuda",
         "source": "mcp_tpu_torch/kernels/csrc/linesearch.cu",
         "replaces": "mcp_tpu/kernels/linesearch_pallas.py:70",
         "launches": launches["linesearch"], "max_abs_err": k2_err, **k2_main,
         "library_ms": None, "shapes": k2_shapes},
    ]
    # K4a, K4b/K4c, K5 on the cold-start QP Schur system (B=256, n=100,
    # float32); library yardstick: one batched torch.linalg.solve (LU with
    # partial pivoting) of the same function, which the port never calls.
    from mcp_tpu_torch.kernels import linear_solve as L

    A, b = schur
    Bn, n, _ = A.shape
    eye_rhs = torch.cat([b[..., None], torch.eye(n, dtype=A.dtype, device=device).expand(Bn, n, n)], 2)
    for name, kind, fn, plain, lib, line in (
        ("gj_solve", "gj", L.gj_solve, L.gj_solve_plain,
         lambda: torch.linalg.solve(A, b[..., None]), "gauss_jordan.cu"),
        ("gji_solve", "gji", L.gji_solve, L.gji_solve_plain,
         lambda: torch.linalg.solve(A, eye_rhs), "gauss_jordan.cu"),
        ("gauss_solve", "qr", L.gauss_solve, L.qr_solve_plain,
         lambda: torch.linalg.solve(A, b[..., None]), "qr_dense.cu"),
    ):
        nbytes, flops = dense_counts(kind, Bn, n)
        b_ms, b_by = bound(nbytes, flops)
        entry = {
            "name": name, "route": "cuda",
            "source": f"mcp_tpu_torch/kernels/csrc/{line}",
            "replaces": {"gj": "mcp_tpu/kernels/linear_solve.py:577",
                         "gji": "mcp_tpu/kernels/linear_solve.py:674",
                         "qr": "mcp_tpu/kernels/linear_solve.py:494"}[kind],
            "launches": dense_launches[name], "max_abs_err": dense_errs[name],
            "ms": None, "plain_ms": cuda_ms(lambda: plain(A, b), 3),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": cuda_ms(lib, 20),
        }
        if kind == "qr":
            # K4b/K4c: the plan's route against the block route, in turns,
            # in float32 and in float64 (the same systems in float64).
            plan, old = L.qr_plan(n, A.dtype), L.qr_plan(n, A.dtype, route="block")
            entry["ms"], entry["old_route_ms"] = ab_ms(
                lambda: fn(A, b, plan=plan), lambda: fn(A, b, plan=old), 50)
            entry["device_ms"], entry["old_route_device_ms"] = route_device_ms(
                (lambda: fn(A, b, plan=plan), lambda: fn(A, b, plan=old)),
                (r"\bqr_pair_kernel<", r"\bqr_kernel<"))
            log(f"  K4b/K4c (gauss_solve) ({Bn},{n}) float32: device time per launch "
                f"{entry['device_ms']:.4f} ms on route {plan.route}, block route "
                f"{entry['old_route_device_ms']:.4f} ms (profiled)")
            entry["plan"] = plan_fields(plan)
            A64, b64 = A.double(), b.double()
            pair64, block64 = (L.qr_plan(n, torch.float64, route=r) for r in ("pair", "block"))
            new64, old64 = ab_ms(lambda: fn(A64, b64, plan=pair64),
                                 lambda: fn(A64, b64, plan=block64), 20)
            entry["float64_routes"] = {"plan_route": L.qr_plan(n, torch.float64).route,
                                       "pair_ms": new64, "block_ms": old64}
            log(f"  K4b/K4c (gauss_solve) ({Bn},{n}) float64: pair route {new64:.4f} ms, "
                f"block route {old64:.4f} ms, in turns; the plan takes "
                f"{entry['float64_routes']['plan_route']}")
        else:
            # K4a/K5: the plan's route against the block route, in turns.
            plan = L.gj_plan(n, kind == "gji", A.dtype)
            old = L.gj_plan(n, kind == "gji", A.dtype, route="block")
            entry["ms"], entry["old_route_ms"] = ab_ms(
                lambda fn=fn, plan=plan: fn(A, b, plan=plan),
                lambda fn=fn, old=old: fn(A, b, plan=old), 50)
            entry["plan"] = plan_fields(plan)
        kernels.append(entry)
    for k in kernels:
        log(f"  {k['name']}: {k['ms']:.4f} ms (plain {k['plain_ms']:.3f} ms, bound "
            f"{k['bound_ms']:.5f} ms by {k['bound_by']}, library {k['library_ms']})"
            + (f"; route {k['plan']['route']}" if "plan" in k else "")
            + (f", block route {k['old_route_ms']:.4f} ms" if "old_route_ms" in k else ""))
    # K6's device time per launch on both routes, at the lane-change SPIKE
    # operands of phase 30 (slab 0 of 2), profiled here: a profile of the
    # same calls in phase 30 or 35 recorded no device activity, where one in
    # a fresh process records every launch.
    from mcp_tpu_torch.kernels.thomas_multi import multi_plan, thomas_solve_multi

    k6_args = spike_slab(real_bands, 0, 2)
    _, _, b6, k6 = k6_args[3].shape
    group, block = (multi_plan(b6, k6, k6_args[0].dtype, route=r) for r in ("group", "block"))
    k6_device = route_device_ms((lambda: thomas_solve_multi(*k6_args, plan=group),
                                 lambda: thomas_solve_multi(*k6_args, plan=block)),
                                (r"\bmulti_group_kernel<", r"\bmulti_kernel<"))
    log(f"  K6 {tuple(k6_args[3].shape)} float32: device time per launch {k6_device[0]:.4f} ms "
        f"on the group route, block route {k6_device[1]:.4f} ms (profiled)")
    k8b_device = k8b_device_ms(schur)
    return kernels, k6_device, k8b_device


# -- K3 and the masked N-player flagships ----------------------------------


def flagship(players, batch=FLAG_B, device="cuda"):
    """The masked-game flagship at horizon 30, θ noise from seed 0 (the game
    is built once per N and device)."""
    from mcp_tpu_torch.bench import flagships

    t0 = time.perf_counter()
    s = flagships.masked_game_setup(batch, players, FLAG_T, device=device)
    st = s.mcp.time_structure
    log(f"  N={players} flagship ready in {time.perf_counter() - t0:.2f} s: "
        f"n={s.mcp.unconstrained_dimension} m={s.mcp.constrained_dimension} "
        f"T={st.num_blocks} b={st.block_size} m_t={st.rows_per_block} "
        f"affine bands {s.mcp.affine_bands is not None}")
    return s


def block_backward_error(diag, lower, upper, rhs, x):
    """Per system ‖Ax − r‖∞/(‖A‖∞‖x‖∞ + ‖r‖∞) of the whole block-tridiagonal
    system, in float64."""
    d, lo, up, r, x = (a.double() for a in (diag, lower, upper, rhs, x))
    Ax = (d @ x[..., None])[..., 0]
    Ax[:, 1:] += (lo @ x[:, :-1, :, None])[..., 0]
    Ax[:, :-1] += (up @ x[:, 1:, :, None])[..., 0]
    rows = d.abs().sum(dim=3)
    rows[:, 1:] += lo.abs().sum(dim=3)
    rows[:, :-1] += up.abs().sum(dim=3)
    amax = lambda a: a.abs().flatten(1).amax(dim=1)
    return amax(Ax - r) / (rows.flatten(1).amax(dim=1) * amax(x) + amax(r))


def block_check(label, kernel, plain, args, tol=K3_TOL):
    """A block-tridiagonal kernel against its plain version on ``args`` by
    K3's rule (max|kernel − plain|/max|plain| within ``tol``; each system's
    backward error ≤ 100 ε or ≤ 2x the plain version's): returns the max
    absolute difference. A system the plain version leaves non-finite (the
    pivot-free Gauss–Jordan facts on game blocks in float32) must be
    non-finite in the kernel's output too and is left out of the
    comparison; every other system must be finite."""
    import torch

    xk = kernel(*args)
    torch.cuda.synchronize()
    xp = plain(*args)
    tag = str(args[0].dtype)[6:]
    bad_k = ~torch.isfinite(xk).flatten(1).all(dim=1)
    bad_p = ~torch.isfinite(xp).flatten(1).all(dim=1)
    ok = ~bad_p
    err = float((xk[ok] - xp[ok]).abs().max()) if bool(ok.any()) else 0.0
    rel = err / max(float(xp[ok].abs().max()), 1e-30) if bool(ok.any()) else 0.0
    sub = tuple(a[ok] if a.stride(0) else a[:1].expand(int(ok.sum()), *a.shape[1:])
                for a in args)
    bk, bp = block_backward_error(*sub, xk[ok]), block_backward_error(*sub, xp[ok])
    over = int((bk > torch.clamp(2 * bp, min=K3_BWD_TOL[tag])).sum())
    bk_max, bp_max = (float(e.max()) if len(e) else 0.0 for e in (bk, bp))
    log(f"  {label} {tag}: max|kernel-plain|/max|plain|={rel:.3e} (tol "
        f"{tol[tag]:g}); backward error kernel {bk_max:.3e} plain {bp_max:.3e} (tol "
        f"{K3_BWD_TOL[tag]:.3e} or 2x plain; systems over: {over})"
        + (f"; non-finite systems kernel {int(bad_k.sum())} plain {int(bad_p.sum())} of "
           f"{len(bad_p)}" if bool(bad_p.any() or bad_k.any()) else ""))
    check(torch.equal(bad_k, bad_p), f"{label}: non-finite kernel output where the plain "
          f"version's is finite, or the reverse")
    check(rel <= tol[tag], f"{label}: kernel and plain differ by {rel:.3e}")
    check(over == 0, f"{label}: kernel backward error {bk_max:.3e}")
    return err


def fact_solver(kernel, fact, plain=False):
    """The wrapper (or its plain version) of ``kernel`` with ``fact``."""
    from mcp_tpu_torch.kernels import cyclic_reduction as C
    from mcp_tpu_torch.kernels import thomas as K1
    from mcp_tpu_torch.kernels import thomas_babe as K7

    if plain:
        fn = {"thomas": K1.thomas_solve_plain, "babe": K7.babe_solve_plain,
              "cr": C.cr_solve_plain}[kernel]
        return lambda *a: fn(*a, fact)
    fn = {"thomas": K1.thomas_solve, "babe": K7.babe_thomas_solve,
          "cr": C.cr_thomas_solve}[kernel]
    return lambda *a: fn(*a, fact=fact)


def fact_check(kernel, fact, what, args, tol=K3_TOL):
    """``kernel`` ("thomas": K1, "babe": K7a, "cr": K3) with ``fact`` against
    its plain version by ``block_check``: returns the max absolute
    difference."""
    name = {"thomas": "K1'", "babe": "K7a", "cr": "K3"}[kernel]
    return block_check(f"{name} {fact} {what}", fact_solver(kernel, fact),
                       fact_solver(kernel, fact, plain=True), args, tol)


def phase_k3(real_lane_bands, n4, n10, device):
    """K3 against its plain version on the card: the first Newton step's
    bands of each flagship (gjp at N=4, gjpr at N=10, each in float32 and
    float64; b=100 in float64 runs on clusters of column slabs),
    diagonally dominant random bands, qr on the lane-change bands (tier
    "tridiag_pallas_cr") and at T=64, and a singular block. Returns
    ({fact: N=4/N=10 float32 bands}, {fact: max abs error on them})."""
    import torch

    from mcp_tpu_torch.kernels.cyclic_reduction import cr_solve_plain, cr_thomas_solve

    f32, f64 = torch.float32, torch.float64
    bands, errs = {}, {}
    for s, fact in ((n4, "gjp"), (n10, "gjpr")):
        for dtype in (f32, f64):
            real = first_newton_bands(s.mcp, s.thetas.to(dtype), s.x0.to(dtype))
            shape = "x".join(map(str, real[0].shape[:3]))
            err = fact_check("cr", fact, f"first Newton step ({shape})", real)
            if dtype == f32:
                bands[fact], errs[fact] = real, err
        fact_check("cr", fact, "random (8x30x{})".format(bands[fact][0].shape[-1]),
                   random_bands((FLAG_B, FLAG_T, bands[fact][0].shape[-1]), f32, device, 41))
    fact_check("cr", "qr", "lane-change first Newton step (256x10x20)", real_lane_bands)
    fact_check("cr", "qr", "random (16x64x20)", random_bands((16, 64, 20), f32, device, 42))
    fact_check("cr", "gjpr", "random (3x13x6)", random_bands((3, 13, 6), f64, device, 43))
    # A singular odd block in system 1: QR divides by its zero pivot (inf/NaN
    # there only); Gauss–Jordan clamps the pivot and contracts with a zero
    # head column (finite values, as the plain version).
    diag, lower, upper, rhs = random_bands((4, 6, 40), f32, device, 44)
    diag[1, 1, :, 3] = 0.0
    diag[1, 1, 3, :] = 0.0
    for fact in ("qr", "gjp", "gjpr"):
        xk = cr_thomas_solve(diag, lower, upper, rhs, fact=fact)
        torch.cuda.synchronize()
        xp = cr_solve_plain(diag, lower, upper, rhs, fact)
        bad_k = (~torch.isfinite(xk).flatten(1).all(dim=1)).tolist()
        bad_p = (~torch.isfinite(xp).flatten(1).all(dim=1)).tolist()
        ok = [0, 2, 3] if fact == "qr" else [0, 1, 2, 3]
        diff = float((xk[ok] - xp[ok]).abs().max() / xp[ok].abs().max())
        log(f"  K3 {fact} singular block: non-finite systems kernel={bad_k} plain={bad_p}, "
            f"max|kernel-plain|/max|plain| over the others {diff:.3e}")
        want = [False, True, False, False] if fact == "qr" else [False] * 4
        check(bad_k == want and bad_p == want, f"K3 {fact} singular block: finiteness")
        check(diff <= K3_TOL["float32"], f"K3 {fact} singular block: systems differ")
    return bands, errs


def run_flagship(name, s, options, stack, x0, fact, kernel="cr"):
    """Solve ``stack`` (K, B, p) through solve_batches_streamed, CUDA-event
    timed, with every launch count set to 0 just before and read just
    after; certify each lane's true KKT in float32. The banded kernel
    ``kernel`` ("cr", "babe" or "thomas") must launch with ``fact`` and no
    other banded kernel or fact; K2 must launch where the options fuse the
    linesearch."""
    import torch

    from mcp_tpu_torch import SOLVED, batch_statistics, solve_batches_streamed
    from mcp_tpu_torch.bench.harness import true_kkt_errors

    K, Bn = stack.shape[:2]
    reset_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    res = solve_batches_streamed(s.mcp, stack, x0=x0, options=options)
    end.record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t1
    device_s = start.elapsed_time(end) / 1e3
    launches = read_counts()
    routes = read_routes()
    tk = true_kkt_errors(s.mcp, res, stack)
    tk64 = certify64(s.mcp, res, stack)
    stats = batch_statistics(res)
    solved = res.status == SOLVED
    certified = int((solved & (tk <= options.tol)).sum())
    stats.update(
        instances=K * Bn, certified=certified,
        certified_solves_per_s=certified / device_s, batch_latency_s=device_s / K,
        true_kkt_max_solved=float(tk[solved].max()) if bool(solved.any()) else float("nan"),
        true_kkt64_max_solved=(float(tk64[solved].max()) if bool(solved.any())
                               else float("nan")),
        window_s_events=device_s, window_s_host=wall_s, launches=launches, routes=routes,
        tightening_rate=options.tightening_rate,
    )
    log(f"  {name} path: " + json.dumps(stats))
    check(tuple(res.x.shape) == (K, Bn, s.mcp.unconstrained_dimension), f"{name}: shape")
    check(bool(torch.isfinite(res.x[solved]).all()), f"{name}: non-finite solved x")
    check(not bool((solved & (tk > options.tol)).any()),
          f"{name}: a SOLVED lane has true KKT above tol")
    check(launches[kernel][fact] > 0, f"{name}: {kernel} {fact} never launched")
    others = sum(total(c) for k, c in launches.items() if k not in (kernel, "linesearch"))
    check(others == 0 and total(launches[kernel]) == launches[kernel][fact],
          f"{name}: another banded kernel or fact launched {launches}")
    if kernel == "babe":
        from mcp_tpu_torch.kernels.thomas_babe import babe_plan

        st = s.mcp.time_structure
        route = babe_plan(st.block_size, fact, stack.dtype).route
        check(routes["babe"][route] == launches["babe"][fact],
              f"{name}: K7a launched off its plan's route {route!r}: {routes['babe']}")
    fused = options.fused_linesearch
    if fused or (fused is None and options.linear_solver in ("tridiag_pallas", "tridiag_auto")):
        check(launches["linesearch"] > 0, f"{name}: K2 never launched")
        ls_route_check(name, routes["linesearch"], launches["linesearch"], Bn,
                       s.mcp.unconstrained_dimension, s.mcp.constrained_dimension, stack.dtype)
    return res, stats


def phase_n4_path(n4, seed=2029):
    """The N=4 flagship: K batches of B=8, each the base θ plus a 1e-4·N(0,1)
    perturbation from a torch.Generator, cold-started from the zero-input
    rollout, after one untimed warm batch."""
    import torch

    from mcp_tpu_torch import SolverOptions, auto_tightening_rate, solve_batch

    options = SolverOptions(**N4_OPTIONS, tightening_rate=auto_tightening_rate(n4.mcp))
    gen = torch.Generator().manual_seed(seed)
    noise = lambda: 1e-4 * torch.randn(n4.thetas.shape, generator=gen, dtype=torch.float64)
    dev, dt = n4.thetas.device, n4.thetas.dtype
    warm = n4.thetas + noise().to(device=dev, dtype=dt)
    stack = torch.stack([n4.thetas + noise().to(device=dev, dtype=dt)
                         for _ in range(N4_BATCHES)])
    solve_batch(n4.mcp, warm, x0=n4.x0, options=options)  # warm batch, untimed
    res, stats = run_flagship("N=4", n4, options, stack, n4.x0, "gjp")
    check(stats["success_rate"] >= N4_MIN_SUCCESS,
          f"N=4: success {stats['success_rate']} < {N4_MIN_SUCCESS}")
    return options, stack, res, stats


def phase_n10_path(n10):
    """The N=10 flagship: one batch of B=8 from the zero-input cold start."""
    from mcp_tpu_torch import SolverOptions, auto_tightening_rate

    options = SolverOptions(**N10_OPTIONS, tightening_rate=auto_tightening_rate(n10.mcp))
    res, stats = run_flagship("N=10", n10, options, n10.thetas[None], n10.x0, "gjpr")
    check(stats["success_rate"] >= N10_MIN_SUCCESS,
          f"N=10: success {stats['success_rate']} < {N10_MIN_SUCCESS}")
    return options, res, stats


def phase_n4_reference(n4, options, stack, res):
    """Two lanes of the last N=4 batch solved on the CPU in float64 with the
    plain versions: the same status, x within a relative 1e-2."""
    import torch

    from mcp_tpu_torch import solve_batch

    t0 = time.perf_counter()
    cpu = flagship(4, batch=2, device="cpu")
    th = stack[-1, :2].double().cpu()
    ref = solve_batch(cpu.mcp, th, x0=n4.x0[:2].double().cpu(), options=options)
    status, x = res.status[-1, :2].cpu(), res.x[-1, :2].double().cpu()
    rel = float((ref.x - x).abs().max() / ref.x.abs().max())
    log(f"  N=4 reference (CPU f64 plain) vs card (f32 kernels), 2 lanes: status "
        f"{ref.status.tolist()} vs {status.tolist()}, iterations {ref.outer_iters.tolist()} "
        f"vs {res.outer_iters[-1, :2].tolist()}, max|dx|/max|x|={rel:.3e} (tol "
        f"{QP_REF_REL_TOL:g}), {time.perf_counter() - t0:.1f} s")
    check(torch.equal(ref.status, status), "N=4 reference: status differs")
    check(rel <= QP_REF_REL_TOL, f"N=4 reference: x differs by {rel:.3e}")


def cr_counts(Bn, T, b, fact):
    """(bytes, flops) of one float32 K3 solve with per-lane bands, counted
    from the kernel's loops: inputs read once and x written once; per level
    and odd block the augmented solve (``aug_flops``), the even-row products
    and the back substitution; the T=1 base per lane."""
    nbytes = 4 * Bn * (T * b * b + 2 * (T - 1) * b * b + 2 * T * b)
    solve = lambda nrhs: aug_flops(b, nrhs, fact)
    flops, t = 0, T
    nrhs = 2 * b + 1
    while t > 1:
        H = (t + (t & 1)) // 2
        per_pair = solve(nrhs) + 2 * b * b * nrhs + b * (b + 1)  # U_e products
        flops += H * per_pair + (H - 1) * 2 * b * b * nrhs  # L_e products
        flops += H * (4 * b * b + 2 * b)  # back substitution
        t = H
    flops += solve(1)
    return nbytes, Bn * flops


def dense_block_system(diag, lower, upper, rhs):
    """The block-tridiagonal system assembled dense, (B, Tb, Tb) and (B, Tb, 1)."""
    import torch

    Bn, T, b, _ = diag.shape
    A = torch.zeros((Bn, T * b, T * b), dtype=diag.dtype, device=diag.device)
    for t in range(T):
        A[:, t * b:(t + 1) * b, t * b:(t + 1) * b] = diag[:, t]
        if t > 0:
            A[:, t * b:(t + 1) * b, (t - 1) * b:t * b] = lower[:, t - 1]
            A[:, (t - 1) * b:t * b, t * b:(t + 1) * b] = upper[:, t - 1]
    return A, rhs.reshape(Bn, T * b, 1).contiguous()


# The times of K3 and K8a as one thread block per system, before their
# cluster redesign (NVIDIA H100 80GB HBM3, 700 W, float32; PERF.md §6): K3
# gjp at (8, 30, 40), K3 gjpr at (8, 30, 100), K8a at (1, 200) and
# torch.linalg.solve there.
SINGLE_BLOCK_MS = {"cr_thomas_solve[gjp]": 0.7373, "cr_thomas_solve[gjpr]": 6.1358,
          "pallas_gauss_solve": 1.6902, "pallas_gauss_solve library": 0.5024}


def cr_plan_fields(args, fact):
    """K3's launch plan for ``args`` as ``kernels`` fields: the cluster
    size, threads and shared memory per CTA of each level's launch and of
    the base's."""
    from mcp_tpu_torch.kernels.cyclic_reduction import cr_plan

    Bn, T, b, _ = args[0].shape
    plan = cr_plan(Bn, T, b, fact, args[0].dtype)
    return {"cluster": [lp.cluster for lp in plan.launches], "threads": plan.base.threads,
            "smem_per_cta": [lp.smem_per_cta for lp in plan.launches]}


@contextlib.contextmanager
def uniform_cr_plan(cluster):
    """While active, K3 launches every level and the base on clusters of
    ``cluster`` CTAs (the plan's slab rule at that size), for an A/B of the
    plan; raises ValueError where a slab does not fit."""
    import torch

    from mcp_tpu_torch.kernels import cyclic_reduction as K3
    from mcp_tpu_torch.kernels.solve_aug import FACT_CODES, SMEM_LIMIT

    def plan(Bn, T, b, fact, dtype):
        family, refine = FACT_CODES[fact]
        itemsize = torch.empty((), dtype=dtype).element_size()
        shapes = K3._level_shapes(T)
        widths = [3 * b + 1 + (b if refine else 0)] * len(shapes) + [b + 1 + (b if refine else 0)]
        launches = []
        for ld, nsys in zip(widths, [H * Bn for H in shapes] + [Bn]):
            bounds = K3.slab_bounds(ld, cluster, b, family >= 3)
            if bounds is None:
                raise ValueError(f"no slabs of {ld} columns over {cluster} CTAs")
            wsmax = max(hi - lo for lo, hi in zip(bounds, bounds[1:]))
            smem = K3.slab_smem_bytes(b, wsmax, family, refine, itemsize)
            if smem > SMEM_LIMIT:
                raise ValueError(f"a slab of {wsmax} columns needs {smem} bytes")
            launches.append(K3.SlabPlan(cluster, K3.THREADS, bounds, smem, nsys))
        return K3.CRPlan(tuple(launches[:-1]), launches[-1])

    orig, K3.cr_plan = K3.cr_plan, plan
    try:
        yield
    finally:
        K3.cr_plan = orig


def phase_k3_timing(bands, errs, n4_launches, n10_launches):
    """K3 at both flagship shapes beside its bound, its plain version and a
    dense torch.linalg.solve of the same system, with its launch plan; then
    the plan against uniform cluster sizes at each shape, in turns."""
    import torch

    from mcp_tpu_torch.kernels.cyclic_reduction import cr_solve_plain, cr_thomas_solve

    kernels = []
    for fact, shape, replaces, lau, solves in (
        ("gjp", "N=4", "mcp_tpu/kernels/thomas_pallas.py:1154", n4_launches,
         N4_BATCHES * FLAG_B),
        ("gjpr", "N=10", "mcp_tpu/kernels/thomas_pallas.py:1167", n10_launches, FLAG_B),
    ):
        args = bands[fact]
        Bn, T, b, _ = args[0].shape
        nbytes, flops = cr_counts(Bn, T, b, fact)
        b_ms, b_by = bound(nbytes, flops)
        A, r = dense_block_system(*args)
        entry = {
            "name": f"cr_thomas_solve[{fact}]", "route": "cuda",
            "source": "mcp_tpu_torch/kernels/csrc/cyclic_reduction.cu",
            "replaces": replaces, "launches": lau, "max_abs_err": errs[fact],
            "ms": cuda_ms(lambda: cr_thomas_solve(*args, fact=fact), 30),
            "plain_ms": cuda_ms(lambda: cr_solve_plain(*args, fact), 3),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": cuda_ms(lambda: torch.linalg.solve(A, r), 5),
            **cr_plan_fields(args, fact),
        }
        kernels.append(entry)
        log(f"  K3 {fact} {shape} ({Bn},{T},{b}): {entry['ms']:.4f} ms (one block per system: "
            f"{SINGLE_BLOCK_MS[entry['name']]} ms; plain {entry['plain_ms']:.3f} ms, bound {b_ms:.5f} ms "
            f"by {b_by} [{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB], dense solve "
            f"{entry['library_ms']:.3f} ms); clusters per launch {entry['cluster']}, shared "
            f"memory per CTA {entry['smem_per_cta']}; launches {lau} in the path window: "
            f"{lau / max(solves // FLAG_B, 1):.2f} per batch, {lau / solves:.3f} per solve")
        # The plan against one cluster size for every launch, in turns.
        ab = {"plan": []}
        for c in (None, 1, 2, 8, 8, 2, 1, None):
            key = "plan" if c is None else c
            try:
                with (contextlib.nullcontext() if c is None else uniform_cr_plan(c)):
                    ab.setdefault(key, []).append(
                        cuda_ms(lambda: cr_thomas_solve(*args, fact=fact), 10))
            except ValueError as exc:
                ab[key] = f"does not fit: {exc}"
        entry["uniform_cluster_ms"] = {str(k): v for k, v in ab.items() if k != "plan"}
        log(f"  K3 {fact} {shape} plan A/B in turns (ms): " + "; ".join(
            f"{k}: {v}" for k, v in ab.items()))
    return kernels


# -- K7a and the training step ---------------------------------------------


@contextlib.contextmanager
def ift_watch():
    """While active, the banded IFT's block-tridiagonal solve
    (``diff._band_solve``) goes through a recorder that keeps the operands
    of its first call (``rec["args"]``) and adds up the K7a launches made
    inside it (``rec["launches"]``, read from the wrapper's count; those on
    the group route ``rec["group_launches"]``); the solve itself is
    unchanged."""
    from mcp_tpu_torch import diff
    from mcp_tpu_torch.kernels.thomas_babe import babe_thomas_solve

    real = diff._band_solve
    rec = {"args": None, "launches": 0, "group_launches": 0}

    def solve(tier, *args, **kw):
        if rec["args"] is None:
            rec["args"] = args
        before = total(babe_thomas_solve.launches)
        group = babe_thomas_solve.route_launches["group"]
        out = real(tier, *args, **kw)
        rec["launches"] += total(babe_thomas_solve.launches) - before
        rec["group_launches"] += babe_thomas_solve.route_launches["group"] - group
        return out

    diff._band_solve = solve
    try:
        yield rec
    finally:
        diff._band_solve = real


def route_check(kernel, fact, what, args, tol=K3_TOL, route=None):
    """K1 ("thomas") or K7a ("babe") with ``fact`` against its plain version
    (``block_check``) on the route its plan gives these bands (``route``:
    forced by the plan); returns the max absolute difference."""
    from mcp_tpu_torch.kernels import thomas as K1
    from mcp_tpu_torch.kernels import thomas_babe as K7

    solve, plain, plan_of, name = {
        "thomas": (K1.thomas_solve, K1.thomas_solve_plain, K1.thomas_plan, "K1'"),
        "babe": (K7.babe_thomas_solve, K7.babe_solve_plain, K7.babe_plan, "K7a"),
    }[kernel]
    B_, T, b, _ = args[0].shape
    plan = plan_of(b, fact, args[0].dtype, route=route)
    before = dict(solve.route_launches)
    err = block_check(f"{name} {fact} {what} [{plan.route}]",
                      lambda *a: solve(*a, fact=fact, plan=plan),
                      lambda *a: plain(*a, fact), args, tol)
    took = [r for r, n in solve.route_launches.items() if n != before[r]]
    check(took == [plan.route], f"{name} {fact} ({B_},{T},{b}): launched on route {took}, "
          f"not {plan.route!r}")
    return err


def babe_zero_blocks(fact, dtype, device, tol):
    """K7a with ``fact`` on its plan's route, with a zero block at the start
    of the left chain (system 1) and of the right chain (system 2): the same
    systems non-finite as in the plain version (under qr those two; a
    Gauss–Jordan pivot is clamped, so they stay finite), the other systems
    within ``tol``."""
    import torch

    from mcp_tpu_torch.kernels.thomas_babe import babe_plan, babe_solve_plain, babe_thomas_solve

    diag, lower, upper, rhs = random_bands((4, 7, 40), dtype, device, 57)
    diag[1, 0] = 0.0
    diag[2, 6] = 0.0
    route = babe_plan(40, fact, dtype).route
    before = babe_thomas_solve.route_launches[route]
    xk = babe_thomas_solve(diag, lower, upper, rhs, fact=fact)
    torch.cuda.synchronize()
    check(babe_thomas_solve.route_launches[route] == before + 1,
          f"K7a {fact} zero blocks: not on the route {route!r}")
    xp = babe_solve_plain(diag, lower, upper, rhs, fact)
    bad_k = (~torch.isfinite(xk).flatten(1).all(dim=1)).tolist()
    bad_p = (~torch.isfinite(xp).flatten(1).all(dim=1)).tolist()
    diff = float((xk[[0, 3]] - xp[[0, 3]]).abs().max() / xp[[0, 3]].abs().max())
    tag = str(dtype)[6:]
    log(f"  K7a {fact} zero blocks [{route}] {tag}: non-finite systems kernel={bad_k} "
        f"plain={bad_p}, max|kernel-plain|/max|plain| over the others {diff:.3e}")
    check(bad_k == bad_p and (fact != "qr" or bad_p == [False, True, True, False]),
          f"K7a {fact} zero blocks: finiteness")
    check(diff <= tol[tag], f"K7a {fact} zero blocks: the other systems differ")


def phase_k7a(n4, device):
    """K7a against its plain version on the card in float32 and float64, on
    its plan's route (the group route at every shape here): the N=4
    flagship's first-Newton bands (8, 30, 40), random bands at T = 2, 3, 21,
    31, the lane-change bands at horizon 20 (T=20, b=20, bands shared over
    the batch) and zero blocks at each chain's start; the block route forced
    by the plan on the N=4 bands; then K1 on the route "padded" (B=8, T=10,
    b=50 and 60; the unpacked one-way sweep K7b of the JAX package) against
    its plain version. Returns the N=4 float32 bands, K7a's max absolute
    difference on them and the lane-change bands at horizon 20 by dtype."""
    import torch

    from mcp_tpu_torch.bench import lane_change as lc
    from mcp_tpu_torch.kernels import thomas_dispatch as TD
    from mcp_tpu_torch.kernels.thomas import thomas_solve
    from mcp_tpu_torch.kernels.thomas_babe import babe_solve_plain, babe_thomas_solve

    f32, f64 = torch.float32, torch.float64
    lane = lc.generate_test_problem(horizon=20, device=device)
    lane_th = lc.generate_parameter_batch(torch.Generator().manual_seed(12), 64, lane,
                                          dtype=f64, device=device)
    check(TD.kernel_mode(FLAG_B, FLAG_T, 40, 4) == "babe" and TD.kernel_mode(64, 20, 20, 4)
          == "babe", "K7a: tier tridiag_pallas does not route the checked shapes to K7a")
    bands = err = None
    lane20 = {}
    for dtype in (f32, f64):
        real = first_newton_bands(n4.mcp, n4.thetas.to(dtype), n4.x0.to(dtype))
        what = "N=4 first Newton step ({})".format("x".join(map(str, real[0].shape[:3])))
        e = route_check("babe", "qr", what, real)
        route_check("babe", "qr", what, real, route="block")
        if dtype == f32:
            bands, err = real, e
        for T, b in ((2, 40), (3, 40), (21, 20), (31, 40)):
            route_check("babe", "qr", f"random ({FLAG_B}x{T}x{b})",
                        random_bands((FLAG_B, T, b), dtype, device, 50 + T))
        lane20[dtype] = first_newton_bands(lane.parametric_game.mcp, lane_th.to(dtype))
        route_check("babe", "qr", "lane-change first Newton step (64x20x20, shared bands)",
                    lane20[dtype])
    babe_zero_blocks("qr", f32, device, K3_TOL)
    for b in (50, 60):
        check(TD.kernel_mode(FLAG_B, 10, b, 4) == "padded"
              and TD.route_solver(FLAG_B, 10, b, 4) is thomas_solve,
              f"K1: (8, 10, {b}) is not on the padded route to K1")
        for dtype, tol in ((f32, K1_TOL), (f64, K1_F64_TOL)):
            k1_check(f"padded route ({FLAG_B},10,{b}) {str(dtype)[6:]}",
                     random_bands((FLAG_B, 10, b), dtype, device, b), tol)
    return bands, err, lane20


def phase_train_path(device, batch=TRAIN_B, steps=TRAIN_STEPS):
    """The training step through the user entry points: ``train_step_setup``
    on tier "tridiag_pallas" (its ground-truth solve certified), one warm
    step, then ``steps`` timed steps, each (the warm one too) a train_step
    and its sgd_update, with every launch count set to 0 just before the
    timed steps and read just after; K7a's
    launches inside the IFT are the backward's, the rest the forward's.
    Returns (setup, the IFT's operands from the warm step, launches, stats)."""
    import torch

    from mcp_tpu_torch import SOLVED
    from mcp_tpu_torch.bench.flagships import train_step_setup
    from mcp_tpu_torch.bench.harness import true_kkt_errors

    t0 = time.perf_counter()
    s = train_step_setup(batch, 4, FLAG_T, tier="tridiag_pallas", device=device)
    setup_s = time.perf_counter() - t0
    N, gt = s.config.num_players, s.gt.result
    ones = torch.ones((batch, N, N), dtype=s.init.dtype, device=s.init.device)
    tk = true_kkt_errors(s.runner.parametric_game.mcp, gt,
                         s.runner.pack_thetas(s.init, s.goals, ones))
    solved = gt.status == SOLVED
    tol = s.runner.options.tol
    log(f"  setup {setup_s:.1f} s (game build, MLP, ground-truth solve): tightening rate "
        f"{s.rate}, ground-truth success {s.gt_success} (iterations "
        f"{gt.outer_iters.tolist()}), max true KKT of a SOLVED lane "
        f"{float(tk[solved].max()) if bool(solved.any()) else float('nan'):.3e}")
    check(s.gt_success >= TRAIN_MIN_SUCCESS,
          f"training: ground-truth success {s.gt_success} < {TRAIN_MIN_SUCCESS}")
    check(not bool((solved & (tk > tol)).any()),
          "training: a SOLVED ground-truth lane has true KKT above tol")
    with ift_watch() as warm:
        _, _, grads = s.train_step(s.model, s.trajectories, s.init, s.goals)
        s.sgd_update(s.model, grads, s.config.learning_rate)
    torch.cuda.synchronize()

    reset_counts()
    rows = []
    t_window = time.perf_counter()
    with ift_watch() as w:
        for i in range(steps):
            t1 = time.perf_counter()
            loss, (per_example, status), grads = s.train_step(
                s.model, s.trajectories, s.init, s.goals)
            s.sgd_update(s.model, grads, s.config.learning_rate)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t1
            rows.append({
                "step": i, "loss": float(loss),
                "forward_success": float((status == SOLVED).double().mean()),
                "failed_lanes": (status != SOLVED).nonzero().flatten().tolist(),
                "grads_finite": all(bool(torch.isfinite(g).all()) for g in grads),
                "seconds": dt, "examples_per_s": batch / dt,
            })
            log(f"  train step {i}: " + json.dumps(rows[-1]))
    window = time.perf_counter() - t_window
    counts = read_counts()
    ls_routes = read_routes()["linesearch"]
    routes = read_routes()["babe"]
    launches = {
        "babe_forward": counts["babe"]["qr"] - w["launches"],
        "babe_backward": w["launches"],
        "babe_routes": routes,
        "babe_backward_group": w["group_launches"],
        "babe_other_facts": total(counts["babe"]) - counts["babe"]["qr"],
        "linesearch": counts["linesearch"],
        "linesearch_routes": ls_routes,
        "thomas": total(counts["thomas"]),
        "cr_thomas_solve": counts["cr"],
    }
    secs = sorted(r["seconds"] for r in rows)
    stats = {"steps": steps, "batch": batch, "window_s": window,
             "seconds_per_step": window / steps, "examples_per_s": batch * steps / window,
             "seconds_per_step_median": secs[len(secs) // 2],
             "forward_success_min": min(r["forward_success"] for r in rows),
             "launches": launches}
    log("  training path: " + json.dumps(stats))
    check(all(r["grads_finite"] for r in rows), "training: non-finite gradient")
    check(all(math.isfinite(r["loss"]) for r in rows), "training: non-finite loss")
    check(stats["forward_success_min"] >= TRAIN_STEP_MIN_SUCCESS,
          f"training: step success {stats['forward_success_min']} < {TRAIN_STEP_MIN_SUCCESS}")
    check(launches["babe_forward"] > 0 and launches["babe_backward"] > 0,
          f"training: K7a not launched in both passes {launches}")
    check(routes["block"] == 0 and routes["group"] == total(counts["babe"])
          and launches["babe_backward_group"] == launches["babe_backward"],
          f"training: K7a launched off the group route {launches}")
    check(launches["linesearch"] > 0, "training: K2 never launched")
    ls_route_check("training", ls_routes, launches["linesearch"], batch,
                   *K2_SHAPES[1][1:], torch.float32)  # the N=4 game's (n, m)
    check(launches["thomas"] == 0 and not any(launches["cr_thomas_solve"].values())
          and launches["babe_other_facts"] == 0,
          f"training: K1, K3 or another K7a fact launched on the K7a qr route {launches}")
    return s, warm["args"], launches, stats


def grad_cpu_step(path):
    """The CPU's float64 training step of ``phase_train_gradients``, run in a
    child process (``python3 -c``) beside the card's checks: its operands
    from ``path`` (``torch.save``: the float32 weights and inputs, the
    options and config), its status, gradient and seconds to ``path.out``."""
    import torch

    from mcp_tpu_torch.bench.flagships import masked_game_setup
    from mcp_tpu_torch.convert import mlp_params_from_numpy
    from mcp_tpu_torch.selection import make_train_step

    torch.set_num_threads(GRAD_CPU_THREADS)
    a = torch.load(path, weights_only=False)
    f64 = torch.float64
    t0 = time.perf_counter()
    cpu = masked_game_setup(GRAD_B, 4, FLAG_T, device="cpu", dtype=f64)
    cpu_step, _, _ = make_train_step(dataclasses.replace(cpu.runner, options=a["options"]),
                                     a["config"])
    model64 = mlp_params_from_numpy(a["weights"], a["biases"], device="cpu", dtype=f64)
    _, (_, st64), g64 = cpu_step(model64, *(x.to(f64) for x in a["inputs32"]))
    torch.save({"status": st64, "grads": [g.detach() for g in g64],
                "seconds": time.perf_counter() - t0}, f"{path}.out")


def phase_train_gradients(device):
    """The gradient checks of GRAD_B lanes of the training game (see
    FD_TOL, F32_GRAD_TOL); the CPU's float64 step runs in a child process
    (``grad_cpu_step``) while the card's checks run. Returns the float64
    IFT operands of the first check and the measured errors."""
    import torch

    from mcp_tpu_torch.bench.flagships import train_step_setup
    from mcp_tpu_torch.convert import mlp_params_from_numpy

    f64, f32 = torch.float64, torch.float32
    s = train_step_setup(GRAD_B, 4, FLAG_T, tier="tridiag_pallas", seed=GRAD_SEED,
                         device=device, dtype=f64)
    # The card's float32 step (the training options) against the CPU's
    # float64 step, both on the float64 setup's inputs and weights rounded to
    # float32.
    weights = [layer.weight.detach().cpu().numpy().astype(np.float32) for layer in s.model.layers]
    biases = [layer.bias.detach().cpu().numpy().astype(np.float32) for layer in s.model.layers]
    inputs32 = [a.to(f32) for a in (s.trajectories, s.init, s.goals)]
    work = Path(rank_dir("gradcheck"))
    operands = str(work / "operands.pt")
    torch.save({"weights": weights, "biases": biases, "options": s.runner.options,
                "config": s.config, "inputs32": [a.cpu() for a in inputs32]}, operands)
    with open(work / "stderr.txt", "w") as err:
        child = subprocess.Popen(
            [sys.executable, "-c", "import sys, chip_smoke; chip_smoke.grad_cpu_step(sys.argv[1])",
             operands], cwd=Path(__file__).resolve().parent, stdout=subprocess.DEVNULL,
            stderr=err)
    try:
        ift_args, errs = _train_gradient_checks(s, device)
        _, (_, st32), g32 = s.train_step(mlp_params_from_numpy(weights, biases, device=device,
                                                               dtype=f32), *inputs32)
        try:
            child.wait(timeout=600)
        except subprocess.TimeoutExpired:
            child.kill()
            child.wait()
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    check(child.returncode == 0, "gradient check: the CPU float64 step failed: "
          + (work / "stderr.txt").read_text()[-2000:])
    out = torch.load(f"{operands}.out", weights_only=False)
    st64, g64 = out["status"], out["grads"]
    up = lambda a: a.detach().to(device="cpu", dtype=f64)
    scale = max(float(g.abs().max()) for g in g64)
    errs["f32_vs_cpu_f64"] = max(float((up(a) - b).abs().max()) for a, b in zip(g32, g64)) / scale
    log(f"  card float32 vs CPU float64 gradient of one step ({GRAD_B} lanes): status "
        f"{st32.tolist()} vs {st64.tolist()}, max|g32-g64|/max|g64| = "
        f"{errs['f32_vs_cpu_f64']:.3e} (tol {F32_GRAD_TOL:g}), CPU {out['seconds']:.1f} s "
        "(child process)")
    check(torch.equal(st32.cpu(), st64), "gradient check: float32 and float64 status differ")
    check(errs["f32_vs_cpu_f64"] <= F32_GRAD_TOL,
          f"gradient check: float32 gradient off by {errs['f32_vs_cpu_f64']:.3e}")
    return ift_args, errs


def _train_gradient_checks(s, device):
    """The float64 IFT against finite differences on the card (see FD_TOL).
    Returns the IFT operands of the first solve and the errors."""
    import torch

    from mcp_tpu_torch import SOLVED
    from mcp_tpu_torch.selection import make_train_step

    f64 = torch.float64
    runner = dataclasses.replace(
        s.runner, options=dataclasses.replace(s.runner.options, tol=GRAD_SOLVE_TOL))
    train_step, eval_step, _ = make_train_step(runner, s.config)
    with ift_watch() as w:
        _, (_, status), grads = train_step(s.model, s.trajectories, s.init, s.goals)
    check(bool((status == SOLVED).all()), f"gradient check: status {status.tolist()}")
    check(w["launches"] > 0 and w["group_launches"] == w["launches"],
          f"gradient check: the float64 IFT's K7a launches {w['launches']}, on the group "
          f"route {w['group_launches']}")
    gnorm = math.sqrt(sum(float((g * g).sum()) for g in grads))
    gen = torch.Generator().manual_seed(5)
    rnd = [torch.randn(g.shape, generator=gen, dtype=f64).to(device) for g in grads]
    rnorm = math.sqrt(sum(float((r * r).sum()) for r in rnd))
    errs = {}
    for name, v, steps in (("gradient", [g / gnorm for g in grads], (FD_STEP, FD_STEP / 2)),
                           ("random", [r / rnorm for r in rnd], (FD_STEP,))):
        ift = sum(float((g * d).sum()) for g, d in zip(grads, v))

        def central(h):
            values = []
            for sign in (1, -1):
                m = copy.deepcopy(s.model)
                with torch.no_grad():
                    for p, d in zip(m.parameters(), v):
                        p.add_(sign * h * d)
                value, (_, st) = eval_step(m, s.trajectories, s.init, s.goals)
                check(bool((st == SOLVED).all()),
                      f"gradient check: status {st.tolist()} at {sign * h}")
                values.append(float(value))
            return (values[0] - values[1]) / (2 * h)

        fds = [central(h) for h in steps]
        fd = fds[0] if len(fds) == 1 else (4 * fds[1] - fds[0]) / 3
        errs[name] = abs(fd - ift) / gnorm
        log(f"  float64 IFT vs finite differences along the {name} direction: ift {ift:.9e}, "
            f"central differences {', '.join(f'{f:.9e}' for f in fds)} at steps {steps}"
            f"{', extrapolated' if len(fds) > 1 else ''} {fd:.9e}: |fd-ift|/|g| = "
            f"{errs[name]:.3e} (tol {FD_TOL:g}; |g| {gnorm:.4e}, solve tol {GRAD_SOLVE_TOL:g})")
        check(errs[name] <= FD_TOL, f"gradient check ({name}): {errs[name]:.3e} > {FD_TOL:g}")
    return w["args"], errs


def babe_counts(Bn, T, b, shared_bands, itemsize=4, fact="qr"):
    """(bytes, flops) of the two-way sweep: inputs read once and x written
    once (as ``thomas_counts``); T sweep steps, each an in-block solve
    (``aug_flops``) against [U | r], T−2 of them after an L·[C | d] product;
    the junction (C·[E | e], a solve with one right side, x_ml); T−2
    back-substitution products."""
    nbytes, _ = thomas_counts(Bn, T, b, shared_bands, itemsize)
    step = aug_flops(b, b + 1, fact)
    elim = 2 * b * b * (b + 1)
    junction = 2 * b * b * (b + 1) + aug_flops(b, 1, fact) + 2 * b * b
    flops = T * step + (T - 2) * elim + junction + (T - 2) * 2 * b * b
    return nbytes, Bn * flops


def babe_ab(args, fact, reps=20):
    """(plan's route, block route) mean ms of K7a with ``fact`` on ``args``,
    the block route forced by the plan, in turns (``ab_ms``)."""
    from mcp_tpu_torch.kernels.thomas_babe import babe_plan, babe_thomas_solve

    b, dtype = args[0].shape[-1], args[0].dtype
    plan, old = babe_plan(b, fact, dtype), babe_plan(b, fact, dtype, route="block")
    return ab_ms(lambda: babe_thomas_solve(*args, fact=fact, plan=plan),
                 lambda: babe_thomas_solve(*args, fact=fact, plan=old), reps)


def babe_f64_ab(args, fact):
    """``babe_ab`` in float64, logged and returned as a dict."""
    from mcp_tpu_torch.kernels.thomas_babe import babe_plan

    Bn, T, b, _ = args[0].shape
    route = babe_plan(b, fact, args[0].dtype).route
    ms, old_ms = babe_ab(args, fact)
    log(f"  K7a {fact} ({Bn},{T},{b}) float64: {route} route {ms:.4f} ms, block route "
        f"{old_ms:.4f} ms, in turns")
    return {"plan_route": route, "ms": ms, "block_ms": old_ms}


def phase_k7a_timing(bands, err, launches):
    """K7a at the N=4 first-Newton bands beside its bound, its plain version
    and a dense torch.linalg.solve of the same system, on its plan's route
    against the block route in turns (float32 and float64); then K7a, K1
    and K3 gjp on those bands at B=8 and B=128 (the mid-block threshold
    data)."""
    import torch

    from mcp_tpu_torch.kernels.cyclic_reduction import cr_thomas_solve
    from mcp_tpu_torch.kernels.thomas import thomas_solve
    from mcp_tpu_torch.kernels.thomas_babe import babe_plan, babe_solve_plain, babe_thomas_solve

    Bn, T, b, _ = bands[0].shape
    nbytes, flops = babe_counts(Bn, T, b, bands[1].stride(0) == 0)
    b_ms, b_by = bound(nbytes, flops)
    A, r = dense_block_system(*bands)
    # The plan's route against the block route forced by the plan, in turns;
    # then the same in float64.
    plan = babe_plan(b, "qr", bands[0].dtype)
    ms, old_ms = babe_ab(bands, "qr")
    entry = {
        "name": "babe_thomas_solve", "route": "cuda",
        "source": "mcp_tpu_torch/kernels/csrc/thomas_babe.cu",
        "replaces": "mcp_tpu/kernels/thomas_pallas.py:737",
        "launches": launches["babe_forward"] + launches["babe_backward"],
        "max_abs_err": err, "ms": ms,
        "plain_ms": cuda_ms(lambda: babe_solve_plain(*bands), 3),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms(lambda: torch.linalg.solve(A, r), 5),
        "plan": plan_fields(plan), "old_route_ms": old_ms,
        "float64_routes": {"qr": babe_f64_ab(tuple(a.double() for a in bands), "qr")},
    }
    log(f"  K7a N=4 ({Bn},{T},{b}): {entry['ms']:.4f} ms on route {plan.route} (block route "
        f"{old_ms:.4f} ms; plain {entry['plain_ms']:.3f} ms, "
        f"bound {b_ms:.5f} ms by {b_by} [{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB], "
        f"dense solve {entry['library_ms']:.3f} ms); launches {entry['launches']} in the "
        f"training window ({launches['babe_forward']} forward, {launches['babe_backward']} "
        "backward)")
    for rep in (1, 16):
        args = tuple(a.repeat(rep, *([1] * (a.dim() - 1))).contiguous() for a in bands)
        k7 = cuda_ms(lambda: babe_thomas_solve(*args), 10)
        k1 = cuda_ms(lambda: thomas_solve(*args), 10)
        k3 = cuda_ms(lambda: cr_thomas_solve(*args, fact="gjp"), 10)
        log(f"  mid-block threshold data, N=4 bands at B={args[0].shape[0]}: K7a (two-way "
            f"sweep) {k7:.4f} ms, K1 (one-way sweep) {k1:.4f} ms, K3 gjp {k3:.4f} ms")
    return entry


def device_time(name, kernels, profile, pattern):
    """Add the device milliseconds per launch of kernel ``pattern`` in
    ``profile`` to the entry ``name`` of the kernels line (``device_ms``,
    beside the CUDA-event time of back-to-back wrapper calls: ``ms``, or
    ``wrapper_ms`` where ``ms`` is a device time)."""
    ms, n = device_ms_per_launch(profile, pattern)
    check(n > 0, f"profile: {name}'s kernel ({pattern}) not in the profile")
    entry = next(k for k in kernels if k["name"] == name)
    entry["device_ms"], entry["device_launches"] = ms, n
    log(f"  {name}: device time {ms:.5f} ms per launch over {n} launches in the profile "
        f"(wrapper calls back to back, CUDA events: {entry.get('wrapper_ms', entry['ms']):.5f} "
        "ms)")


def route_device_ms(calls, patterns, reps=20):
    """Device milliseconds per launch of each of ``calls`` (a kernel's plan
    route and its block route, or other kernels of the same function;
    ``patterns``: their kernel names), each called ``reps`` times back to
    back under one profile: the card's own time, without the host's cost of
    issuing the calls, which back-to-back wrapper calls of a kernel this
    short can approach."""

    import torch

    def run():
        # A kernel of no interest on each side of the calls: a profile of
        # K2's block route alone once recorded 19 of its 20 launches.
        marker = torch.zeros(1, device="cuda")
        for fn in calls:
            for _ in range(reps):
                fn()
        marker.add_(1)

    profile = profile_call(run, ())
    out = []
    for pattern in patterns:
        ms, n = device_ms_per_launch(profile, pattern)
        check(n == reps, f"profile: {n} launches of {pattern}, not {reps}")
        out.append(ms)
    return out


def phase_train_profile(s):
    """One train step under torch.profiler (``profile_call``): the solver's
    and the IFT's spans, and the IFT backward's share of the step (the rest
    of the backward, through the loss and the MLP, is a few small ops)."""
    from mcp_tpu_torch import diff
    from mcp_tpu_torch import solver as S

    out = profile_call(lambda: s.train_step(s.model, s.trajectories, s.init, s.goals),
                       (S.SPAN_RESIDUAL, S.SPAN_NEWTON, S.SPAN_LINESEARCH, S.SPAN_LOOP_TEST,
                        diff.SPAN_IFT_BANDS, diff.SPAN_IFT_SOLVE),
                       s.init.device.type == "cuda")
    out["ift_backward_share"] = out["ift_backward_host_ms"] / out["wall_ms_profiled"]
    log("  profile (one train step): " + json.dumps(shown(out)))
    return out

# -- the Gauss–Jordan facts of K1′, K7a and K3 (the fact tiers) ------------


def phase_fact_kernels(n4, n10, device):
    """Every Gauss–Jordan fact of K1′, K7a and K3 against its plain version
    on the card, in float32 and float64: the lane-change first-Newton bands
    (K1′ and K3), the N=4 first-Newton bands (K7a and K3), the N=10 bands
    (K3; gjbpr also in float64), random bands (K1′ at
    (256, 10, 20) and (3, 7, 5); K7a at T = 21 and 29, where the right chain
    of the JAX package starts on its identity pad), K7a on its plan's route.
    Returns ({shape: float32 bands, and the N=4 bands in float64},
    {(kernel, fact): max abs error on the float32 bands of the fact's
    path})."""
    import torch

    from mcp_tpu_torch.kernels.solve_aug import FACTS

    f32, f64 = torch.float32, torch.float64
    check_fact = lambda *a: fact_check(*a, tol=FACT_TOL)
    shape = lambda a: "x".join(map(str, a[0].shape[:3]))
    bands, errs = {}, {}
    for dtype in (f32, f64):
        lane = lane_change_bands(dtype, device)
        n4b = first_newton_bands(n4.mcp, n4.thetas.to(dtype), n4.x0.to(dtype))
        if dtype == f32:
            bands["lane"], bands["N=4"] = lane, n4b
        else:
            bands["N=4 float64"] = n4b
        for fact in ("gj", "gjp", "gjpr"):
            e = check_fact("thomas", fact, f"lane-change first Newton step ({shape(lane)})", lane)
            if dtype == f32:
                errs["thomas", fact] = e
            for sh, seed in (((B, 10, 20), 61), ((3, 7, 5), 62)):
                check_fact("thomas", fact, f"random ({'x'.join(map(str, sh))})",
                           random_bands(sh, dtype, device, seed))
            # The route boundaries of K1's plan: b <= 32 on the warp route
            # where the register budget holds, b = 33 on the block route.
            for b in (1, 20, 32, 33):
                for T in (1, 10):
                    route_check("thomas", fact, f"random (8x{T}x{b})",
                                random_bands((8, T, b), dtype, device, 90 + b + T), FACT_TOL)
            e = route_check("babe", fact, f"N=4 first Newton step ({shape(n4b)})", n4b,
                            FACT_TOL)
            if dtype == f32:
                errs["babe", fact] = e
            for T in (21, 29):
                route_check("babe", fact, f"random ({FLAG_B}x{T}x40)",
                            random_bands((FLAG_B, T, 40), dtype, device, 60 + T), FACT_TOL)
        for fact in FACTS:
            if fact in ("qr", "gjp", "gjpr"):
                continue  # phase 13
            e = check_fact("cr", fact, f"lane-change first Newton step ({shape(lane)})", lane)
            if dtype == f32:
                errs["cr", fact] = e
            e = check_fact("cr", fact, f"N=4 first Newton step ({shape(n4b)})", n4b)
            if dtype == f32 and fact == "gjbpr":
                errs["cr", "gjbpr", "N=4"] = e
    n10b = bands["N=10"] = first_newton_bands(n10.mcp, n10.thetas, n10.x0)
    for fact in FACTS:
        if fact not in ("qr", "gjp", "gjpr"):
            check_fact("cr", fact, f"N=10 first Newton step ({shape(n10b)})", n10b)
    # b=100 in float64 (clusters of column slabs), held by K3's rule as
    # phase 13 holds gjpr there.
    fact_check("cr", "gjbpr", f"N=10 first Newton step ({shape(n10b)})",
               tuple(a.double() for a in n10b))
    return bands, errs


def phase_k7a_facts(lane20, ift_bands, ift64_bands, fact_bands, device):
    """K7a's Gauss–Jordan facts on the rest of the shapes phase 20 holds qr
    to, on the plan's route (``FACT_TOL``): the lane-change bands at
    horizon 20 (64, 20, 20, shared bands) and zero blocks in both dtypes,
    the IFT's transposed bands of the training step (8, 30, 40) and of the
    float64 gradient check (2, 30, 40); and the block route forced by the
    plan on the N=4 bands beside the group route's difference there."""
    import torch

    for fact in ("gj", "gjp", "gjpr"):
        for dtype in (torch.float32, torch.float64):
            route_check("babe", fact, "lane-change first Newton step (64x20x20, shared bands)",
                        lane20[dtype], FACT_TOL)
            babe_zero_blocks(fact, dtype, device, FACT_TOL)
        route_check("babe", fact, "IFT transposed bands at a training-step solution (8x30x40)",
                    ift_bands, FACT_TOL)
        route_check("babe", fact, "IFT transposed bands at a float64 training-step solution "
                    "(2x30x40)", ift64_bands, FACT_TOL)
        for key in ("N=4", "N=4 float64"):
            route_check("babe", fact, "N=4 first Newton step (8x30x40)", fact_bands[key],
                        FACT_TOL, route="block")


def phase_path_b(device, seed=2030):
    """Path B: one lane-change batch of B fresh θ on each tier of PATH_B
    (the headline options with that tier), every launch count set to 0 just
    before each batch and read just after. Returns {(kernel, fact):
    launches}."""
    import torch

    from mcp_tpu_torch import SOLVED, SolverOptions, auto_tightening_rate, solve_batch
    from mcp_tpu_torch.bench import lane_change as lc
    from mcp_tpu_torch.bench.harness import true_kkt_errors

    bench = lc.generate_test_problem(horizon=10, device=device)
    mcp = bench.parametric_game.mcp
    gen = torch.Generator().manual_seed(seed)
    launches, failures = {}, []
    for tier, kernel, fact, floor in PATH_B:
        th = lc.generate_parameter_batch(gen, B, bench, dtype=torch.float32, device=device)
        opts = SolverOptions(**{**HEADLINE, "linear_solver": tier},
                             tightening_rate=auto_tightening_rate(mcp))
        reset_counts()
        t0 = time.perf_counter()
        res = solve_batch(mcp, th, options=opts)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = read_counts()
        tk = true_kkt_errors(mcp, res, th)
        solved = res.status == SOLVED
        success = float(solved.double().mean())
        certified = int((solved & (tk <= opts.tol)).sum())
        launches[kernel, fact] = counts[kernel][fact]
        log(f"  path B {tier}: success {success}, certified {certified}/{B}, median "
            f"iterations {float(res.outer_iters.double().median())}, {dt:.2f} s, "
            f"launches {json.dumps(counts)}")
        others = sum(total(c) for k, c in counts.items() if k not in (kernel, "linesearch"))
        for ok, what in (
            (counts[kernel][fact] > 0, f"{kernel} {fact} never launched"),
            (others == 0 and total(counts[kernel]) == counts[kernel][fact],
             f"another banded kernel or fact launched {counts}"),
            (not bool((solved & ~(tk <= opts.tol)).any()), "a SOLVED lane is not certified"),
            (floor is None or success >= floor, f"success {success} < {floor}"),
        ):
            if not ok:
                failures.append(f"path B {tier}: {what}")
    check(not failures, "; ".join(failures))
    return launches


def phase_path_c(n4, seed=2031):
    """Path C: one N=4 flagship batch (phase 14's options and θ noise) on
    each tier of PATH_C through ``run_flagship``. Returns {(kernel, fact,
    "N=4"): launches}."""
    import torch

    from mcp_tpu_torch import SolverOptions, auto_tightening_rate

    gen = torch.Generator().manual_seed(seed)
    dev, dt = n4.thetas.device, n4.thetas.dtype
    launches, failures = {}, []
    for tier, kernel, fact, floor in PATH_C:
        options = SolverOptions(**{**N4_OPTIONS, "linear_solver": tier},
                                tightening_rate=auto_tightening_rate(n4.mcp))
        noise = 1e-4 * torch.randn(n4.thetas.shape, generator=gen, dtype=torch.float64)
        stack = (n4.thetas + noise.to(device=dev, dtype=dt))[None]
        try:
            _, stats = run_flagship(f"path C {tier}", n4, options, stack, n4.x0, fact, kernel)
        except PhaseFailed as exc:
            failures.append(str(exc))
            continue
        launches[kernel, fact, "N=4"] = stats["launches"][kernel][fact]
        if floor is not None and stats["success_rate"] < floor:
            failures.append(f"path C {tier}: success {stats['success_rate']} < {floor}")
    check(not failures, "; ".join(failures))
    return launches


def phase_fact_timing(bands, errs, launches, device):
    """Each (kernel, fact) of paths A–C at its path's shape beside its bound,
    its plain version and a dense torch.linalg.solve of the same system (one
    per shape: the same function whatever the fact); then the N=10 A/B of K3
    gjpr, gjbpr and gjbprl on the N=10 bands, in turns."""
    import torch

    library = {}
    for key in ("lane", "N=4"):
        A, r = dense_block_system(*bands[key])
        library[key] = cuda_ms(lambda: torch.linalg.solve(A, r), 5)
    rows = [("thomas", f, "lane", (f,)) for f in ("gj", "gjp", "gjpr")]
    rows += [("babe", f, "N=4", (f,)) for f in ("gj", "gjp", "gjpr")]
    rows += [("cr", f, "lane", (f,)) for f in ("gj", "gjb", "gjbr", "gjbr2", "gjbpr", "gjbpr2",
                                                 "gjbprl")]
    rows += [("cr", "gjbpr", "N=4", ("gjbpr", "N=4"))]
    from mcp_tpu_torch.kernels.thomas import thomas_plan, thomas_solve
    from mcp_tpu_torch.kernels.thomas_babe import babe_plan

    kernels = []
    for kernel, fact, key, ekey in rows:
        args = bands[key]
        Bn, T, b, _ = args[0].shape
        shared = args[1].stride(0) == 0
        if kernel == "thomas":
            nbytes, flops = thomas_counts(Bn, T, b, shared, fact=fact)
        elif kernel == "babe":
            nbytes, flops = babe_counts(Bn, T, b, shared, fact=fact)
        else:
            nbytes, flops = cr_counts(Bn, T, b, fact)
        b_ms, b_by = bound(nbytes, flops)
        name, src, replaces = FACT_SOURCE[kernel]
        lau = launches[(kernel, fact, key) if (kernel, fact, key) in launches else (kernel, fact)]
        extra = {}
        if kernel == "thomas":
            # K1′: the plan's route against the block route, in turns.
            plan = thomas_plan(b, fact, args[0].dtype)
            old = thomas_plan(b, fact, args[0].dtype, route="block")
            ms, old_ms = ab_ms(lambda: thomas_solve(*args, fact=fact, plan=plan),
                               lambda: thomas_solve(*args, fact=fact, plan=old), 20)
            extra = {"plan": plan_fields(plan), "old_route_ms": old_ms}
        elif kernel == "babe":
            # K7a: the same, and in float64 on the N=4 bands.
            ms, old_ms = babe_ab(args, fact)
            extra = {"plan": plan_fields(babe_plan(b, fact, args[0].dtype)),
                     "old_route_ms": old_ms,
                     "float64_routes": {fact: babe_f64_ab(bands["N=4 float64"], fact)}}
        else:
            ms = cuda_ms(lambda: fact_solver(kernel, fact)(*args), 20)
        entry = {
            "name": f"{name}[{fact}]" + (" N=4" if kernel == "cr" and key == "N=4" else ""),
            "route": "cuda", "source": f"mcp_tpu_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": lau, "max_abs_err": errs[(kernel, *ekey)],
            "ms": ms,
            "plain_ms": cuda_ms(lambda: fact_solver(kernel, fact, plain=True)(*args), 2),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library[key],
            **(cr_plan_fields(args, fact) if kernel == "cr" else {}), **extra,
        }
        kernels.append(entry)
        log(f"  {entry['name']} ({Bn},{T},{b}): {entry['ms']:.4f} ms (plain "
            f"{entry['plain_ms']:.3f} ms, bound {b_ms:.5f} ms by {b_by} [{flops / 1e9:.3f} "
            f"GFLOP, {nbytes / 1e6:.2f} MB], dense solve {entry['library_ms']:.3f} ms); "
            f"launches {lau} in its path's window"
            + (f"; route {extra['plan']['route']}, block route {extra['old_route_ms']:.4f} ms"
               if extra else ""))
    args = bands["N=10"]
    Bn, T, b, _ = args[0].shape
    ab = {f: [] for f in ("gjpr", "gjbpr", "gjbprl")}
    for fact in ("gjpr", "gjbpr", "gjbprl", "gjbprl", "gjbpr", "gjpr"):
        ab[fact].append(cuda_ms(lambda: fact_solver("cr", fact)(*args), 10))
    for fact, ms in ab.items():
        nbytes, flops = cr_counts(Bn, T, b, fact)
        b_ms, b_by = bound(nbytes, flops)
        log(f"  N=10 A/B ({Bn},{T},{b}) K3 {fact}: {ms[0]:.4f} / {ms[1]:.4f} ms (mean "
            f"{sum(ms) / 2:.4f}; bound {b_ms:.5f} ms by {b_by}, {flops / 1e9:.3f} GFLOP)")
    return kernels


# -- K6 and the horizon-sharded paths; K8a and K8b --------------------------

# K6 (the SPIKE local slab solve) against its plain version at the paths'
# shapes: the lane change at D=2 (256, 5, 20, 41), the T=64 lane change at
# D=4 (1, 16, 20, 41) and the N=4 flagship at D=2 (8, 15, 40, 81; 3b+k = 201,
# beyond the TPU kernel's 128 lanes), each from its first Newton step's
# bands. K1's rule: max|kernel − plain| relative to max|x|, and each system
# column's backward error ≤ 100 ε or ≤ 2x the plain version's (K3's rule).
K6_TOL = {"float32": K1_REAL_TOL, "float64": K1_F64_TOL}
# The horizon-sharded paths run as spawned ranks sharing the one card, over
# gloo (NCCL takes one rank per card); a rank that leaves a collective early
# fails the phase at this timeout instead of hanging it.
RANK_TIMEOUT_S = 300
HZ_B, HZ_WARM = 256, 8  # the horizon batch (dp=1 x horizon=2) and its warm batch
# The JAX package's test θ draws (tests/test_horizon.py: PRNGKey(2) at T=64
# on the 300 m road, PRNGKey(2) and PRNGKey(0) at T=16), so that the card
# solves the instances the reference's own tests solve.
T64_THETA = [1.6699366253484025, 148.45578766222522, 1.275062898755385, 1.4661674954323232,
             1.0, 1.0077820186700563, 90.65005739850648, 1.1835583513139207,
             1.001878194856054, 3.0]
T16_THETAS = [
    [1.6699366253484025, 24.75126781136514, 1.275062898755385, 1.4661674954323232, 1.0,
     1.0077820186700563, 15.440277701772855, 1.1835583513139207, 1.001878194856054, 3.0],
    [3.4098439939696665, 2.934984799943585, 1.303844511163124, 1.7590903835528438, 1.0,
     1.4455455796509067, 23.174772053473937, 0.42640361952699735, 0.9598141891229717, 3.0],
]
# The T=64 solve on 4 ranks is held to the same SPIKE algebra run in one
# process on the card (the same kernels, no exchange): the same outer
# iterations, x to T64_X_REL of max|x| (float64 rounding of the gathers'
# order of assembly only). It is also held to an independent solver, the
# single-card cyclic-reduction tier (K3, qr): the same outer iterations and
# x to T64_CR_REL of max|x|. At T=64 and tol 1e-4 rounding fixes x only to
# ~3e-4 of max|x| (~161): a 1-ulp perturbation of θ moves the 4-slab SPIKE
# solution by 0.017–0.048 on the CPU in float64, and the tiers of either
# package differ from one another by up to 0.056.
T64_X_REL = 1e-9
T64_CR_REL = 5e-4
GRAD_RTOL = 1e-6  # float64 IFT gradients through SPIKE vs one card
SINGLE_N = 4  # one-instance solves per problem (K8a)


def spike_slab(bands, d, D):
    """The K6 operands (diag, lower, upper, R) of slab d of D of the batched
    bands (diag, lower, upper, rhs), as the SPIKE stage builds them."""
    from mcp_tpu_torch.parallel import horizon as H

    diag, lower, upper, rhs = bands
    B = diag.shape[0]
    lower, upper = (a.expand(B, *a.shape[1:]) for a in (lower, upper))
    return H.spike_local_operands(*H._slab(diag, lower, upper, rhs, d, D))


def fold_columns(args, X):
    """A multi-right-hand-side system and solution as k single-column
    systems per lane (K1's layout), for ``block_backward_error``."""
    diag, lower, upper, R = args
    B, T, b, k = R.shape
    rep = lambda a: a[:, None].expand(B, k, *a.shape[1:]).reshape(B * k, *a.shape[1:])
    cols = lambda a: a.permute(0, 3, 1, 2).reshape(B * k, T, b)
    return (rep(diag), rep(lower), rep(upper), cols(R)), cols(X)


def multi_check(label, args, plan=None):
    """K6 on ``plan`` (default ``multi_plan``'s; the launch asserted on its
    route) against its plain version (``K6_TOL`` relative to max|x|, and the
    backward error of each lane and column: ≤ 100 ε or ≤ 2x the plain
    version's). Returns the max absolute difference."""
    import torch

    from mcp_tpu_torch.kernels.thomas_multi import (
        multi_plan,
        thomas_solve_multi,
        thomas_solve_multi_plain,
    )

    _, _, b, k = args[3].shape
    want_route = (plan or multi_plan(b, k, args[0].dtype)).route
    routes = dict(thomas_solve_multi.route_launches)
    xk = thomas_solve_multi(*args, plan=plan)
    torch.cuda.synchronize()
    took = [r for r, n in thomas_solve_multi.route_launches.items() if n != routes[r]]
    check(took == [want_route], f"K6 {label}: launched on route {took}, not {want_route!r}")
    label = f"{label} [{want_route}{', forced' if plan else ''}]"
    xp = thomas_solve_multi_plain(*args)
    tag = str(args[0].dtype)[6:]
    err = float((xk - xp).abs().max())
    rel = err / max(float(xp.abs().max()), 1e-30)
    fa, fk = fold_columns(args, xk)
    _, fp = fold_columns(args, xp)
    # Columns whose right side is 0 (W_L of the first slab, W_R of the last)
    # must give x = 0; the backward error is taken over the others.
    live = fa[3].flatten(1).abs().amax(dim=1) > 0
    check(not bool(fk[~live].any()), f"K6 {label}: nonzero x for a zero right side")
    fa = tuple(a[live] for a in fa)
    bk, bp = block_backward_error(*fa, fk[live]), block_backward_error(*fa, fp[live])
    over = int((bk > torch.clamp(2 * bp, min=K3_BWD_TOL[tag])).sum())
    log(f"  K6 {label} {tag} {tuple(args[3].shape)}: max|kernel-plain|/max|x|={rel:.3e} "
        f"(tol {K6_TOL[tag]:g}); backward error kernel {float(bk.max()):.3e} plain "
        f"{float(bp.max()):.3e} (tol {K3_BWD_TOL[tag]:.3e} or 2x plain; over: {over})")
    check(bool(torch.isfinite(xk).all()), f"K6 {label}: non-finite kernel output")
    check(rel <= K6_TOL[tag], f"K6 {label}: kernel and plain differ by {rel:.3e}")
    check(over == 0, f"K6 {label}: kernel backward error {float(bk.max()):.3e}")
    return err


def t64_problem(device, dtype):
    """The T=64 lane change on the 300 m road, its θ and its zero-input
    cold start (the JAX package's tests/test_horizon.py:71-113)."""
    import torch

    from mcp_tpu_torch.bench import lane_change as lc
    from mcp_tpu_torch.trajectories.strategies import cold_start_primal

    bench = lc.generate_test_problem(horizon=64, height=300.0, device=device)
    theta = torch.tensor(T64_THETA, dtype=dtype, device=device)
    x0 = cold_start_primal(bench.game, bench.parametric_game, 64,
                           torch.cat([theta[0:4], theta[5:9]]))
    return bench.parametric_game.mcp, theta, x0


def phase_k6(real_bands, n4, device):
    """K6 on its plan's route against its plain version at the three SPIKE
    shapes in float32 and float64, on the block route forced at the lane
    change's shape, and a zero pivot on both routes. Returns (the
    lane-change f32 operands, the max abs error there)."""
    import torch

    from mcp_tpu_torch.kernels.thomas_multi import (
        multi_plan,
        thomas_solve_multi,
        thomas_solve_multi_plain,
    )

    f32, f64 = torch.float32, torch.float64
    mcp64, th64, x64 = t64_problem(device, f64)
    shapes = {
        "lane change D=2": lambda dt: spike_slab(
            tuple(a.to(dt) for a in real_bands), 0, 2),
        "T=64 lane change D=4": lambda dt: spike_slab(
            first_newton_bands(mcp64, th64[None].to(dt), x64[None]), 1, 4),
        "N=4 flagship D=2": lambda dt: spike_slab(
            first_newton_bands(n4.mcp, n4.thetas.to(dt), n4.x0), 1, 2),
    }
    lane_args, err = None, None
    for name, make in shapes.items():
        for dt in (f32, f64):
            args = make(dt)
            e = multi_check(name, args)
            if name == "lane change D=2":
                # The block route forced by the plan: the other half of
                # phase 35's A/B.
                _, _, b, k = args[3].shape
                check(multi_plan(b, k, dt).route == "group",
                      f"K6 {name}: not on the group route in {dt}")
                multi_check(name, args, plan=multi_plan(b, k, dt, route="block"))
                if dt == f32:
                    lane_args, err = args, e
    # A zero pivot gives non-finite x in both versions, on that system only,
    # on the plan's route (group) and on the block route forced.
    diag, lower, upper, rhs = random_bands((4, 5, 20), f32, device, 7)
    R = torch.randn((4, 5, 20, 41), generator=torch.Generator().manual_seed(8)).to(device)
    diag[2, 0] = 0.0
    xp = thomas_solve_multi_plain(diag, lower, upper, R)
    bad_p = (~torch.isfinite(xp).flatten(1).all(dim=1)).tolist()
    for plan in (multi_plan(20, 41, f32), multi_plan(20, 41, f32, route="block")):
        xk = thomas_solve_multi(diag, lower, upper, R, plan=plan)
        torch.cuda.synchronize()
        bad_k = (~torch.isfinite(xk).flatten(1).all(dim=1)).tolist()
        others = float((xk[[0, 1, 3]] - xp[[0, 1, 3]]).abs().max())
        log(f"  K6 zero pivot [{plan.route}]: non-finite systems kernel={bad_k} plain={bad_p}, "
            f"other systems max|kernel-plain| {others:.3e}")
        check(bad_k == bad_p == [False, False, True, False], f"K6 zero pivot [{plan.route}]")
        check(others <= K6_TOL["float32"] * float(xp[[0, 1, 3]].abs().max()),
              f"K6 zero pivot [{plan.route}]: the other systems changed")
    return lane_args, err


def rank_dir(name):
    """A fresh directory for one spawn's rendezvous and results, under the
    checkout's build/ (which git ignores)."""
    root = Path(__file__).resolve().parent / "build" / "chip_smoke_ranks"
    root.mkdir(parents=True, exist_ok=True)
    return tempfile.mkdtemp(prefix=f"{name}-", dir=root)


def phase_horizon_paths(device, out_dir, k6_route):
    """Two ranks sharing the card, spawned once: the lane-change headline
    (T=10, B=256, float32) through solve_batch_horizon_sharded on a dp=1 x
    horizon=2 mesh, every K6 launch of a rank on ``k6_route`` (its plan's);
    the gradient of Σx² through horizon_sharded_solve_fn at T=16 (two lanes,
    float64); solve_batch_sharded of 16 lane-change lanes; solve_single_tp of
    one lane-change instance and solve_routed of two buckets (``tp_routed``).
    Each is held against the same solve on one card in this process.
    Returns (K6's launches, the tp and routed launches)."""
    import torch

    from mcp_tpu_torch import SOLVED, SolverOptions, auto_tightening_rate, solve_batch
    from mcp_tpu_torch.bench import horizon as worker
    from mcp_tpu_torch.bench import lane_change as lc
    from mcp_tpu_torch.bench.harness import true_kkt_errors

    bench = lc.generate_test_problem(horizon=10, device=device)
    mcp = bench.parametric_game.mcp
    options = dict(HEADLINE, tightening_rate=auto_tightening_rate(mcp))
    gen = torch.Generator().manual_seed(2032)
    thetas = lc.generate_parameter_batch(gen, HZ_B, bench, dtype=torch.float32, device=device)
    grad_opts = dict(linear_solver="tridiag", sensitivity_solver="tridiag", tol=1e-6)
    t16 = np.asarray(T16_THETAS)
    tp_routed = tp_routed_tasks(thetas, options, device)
    tasks = [
        dict(kind="batch", name="batch", thetas=thetas.cpu().numpy(), options=options,
             horizon=10, dp=1, hz=2, warm=HZ_WARM),
        dict(kind="grad", name="grad", thetas=t16, options=grad_opts, horizon=16),
        dict(kind="batch_sharded", name="batch_sharded", thetas=thetas[:16].cpu().numpy(),
             options=options, horizon=10),
        *tp_routed,
    ]
    t0 = time.perf_counter()
    ranks = worker.spawn(2, tasks, out_dir, device=device, threads=2,
                         timeout_s=RANK_TIMEOUT_S)
    log(f"  2 ranks ran in {time.perf_counter() - t0:.1f} s")
    for name in ("batch", "grad", "batch_sharded", "tp"):
        for k, v in ranks[0][name].items():
            if isinstance(v, np.ndarray):
                check(np.array_equal(ranks[1][name][k], v, equal_nan=True),
                      f"horizon {name}: ranks differ in {k}")
    for r0, r1 in zip(ranks[0]["routed"]["results"], ranks[1]["routed"]["results"]):
        for k, v in r0.items():
            check(np.array_equal(r1[k], v, equal_nan=True), f"routed: ranks differ in {k}")

    # The horizon batch.
    got = ranks[0]["batch"]
    status = torch.from_numpy(got["status"]).to(device)
    solved = status == SOLVED
    res = SimpleNamespace(**{k: torch.from_numpy(got[k]).to(device) for k in ("x", "y", "s")})
    tk = true_kkt_errors(mcp, res, thetas)
    certified = int((solved & (tk <= options["tol"])).sum())
    one = solve_batch(mcp, thetas, options=SolverOptions(**options))
    torch.cuda.synchronize()
    differ = (one.status != status).nonzero().flatten().tolist()
    launches = [r["batch"]["launches"] for r in ranks]
    success = float(solved.double().mean())
    stats = dict(success_rate=success, certified=certified,
                 certified_solves_per_s=certified / got["seconds"], window_s=got["seconds"],
                 median_outer_iters=float(np.median(got["outer_iters"])),
                 single_card_success=float((one.status == SOLVED).double().mean()),
                 lanes_whose_status_differs_from_one_card=differ,
                 launches_per_rank=launches,
                 linesearch_routes_per_rank=[r["batch"]["linesearch_routes"] for r in ranks])
    log("  horizon batch (dp=1 x horizon=2, tridiag_pallas): " + json.dumps(stats))
    check(all(l["multi"] > 0 for l in launches), "horizon batch: K6 not launched in a rank")
    check(all(l["multi_routes"][k6_route] == l["multi"] for l in launches),
          f"horizon batch: a K6 launch off its plan's route {k6_route!r}: "
          f"{[l['multi_routes'] for l in launches]}")
    check(all(l["linesearch"] > 0 for l in launches), "horizon batch: K2 not launched")
    for r in ranks:
        ls_route_check("horizon batch (a rank)", r["batch"]["linesearch_routes"],
                       r["batch"]["launches"]["linesearch"], HZ_B, mcp.unconstrained_dimension,
                       mcp.constrained_dimension, torch.float32)
    check(all(l["thomas"] == l["babe"] == l["cr"] == 0 for l in launches),
          "horizon batch: K1, K7a or K3 launched")
    check(success >= 0.99, f"horizon batch: success {success} < 0.99")
    check(not bool((solved & (tk > options["tol"])).any()),
          "horizon batch: a SOLVED lane has true KKT above tol")

    # The gradient through SPIKE against one card.
    g = ranks[0]["grad"]
    th = torch.tensor(t16, dtype=torch.float64, device=device).requires_grad_()
    mcp16 = lc.generate_test_problem(horizon=16, device=device).parametric_game.mcp
    ref = solve_batch(mcp16, th, options=SolverOptions(**grad_opts))
    (g_one,) = torch.autograd.grad((ref.x ** 2).sum(), th)
    g_one = g_one.cpu().numpy()
    rel = float(np.abs(g["grad"] - g_one).max() / np.abs(g_one).max())
    log(f"  SPIKE gradient (2 ranks, T=16, 2 lanes, float64): status {g['status'].tolist()} "
        f"(one card {ref.status.tolist()}), max|g - g_one|/max|g_one|={rel:.3e} (rtol "
        f"{GRAD_RTOL:g}); K6 launches forward {g['launches']['multi']}, backward "
        f"{g['backward_launches']['multi']}")
    check((g["status"] == SOLVED).all(), "SPIKE gradient: a lane did not solve")
    check(np.allclose(g["grad"], g_one, rtol=GRAD_RTOL, atol=1e-8 * np.abs(g_one).max()),
          f"SPIKE gradient differs from one card by {rel:.3e}")
    check(g["backward_launches"]["multi"] > 0, "SPIKE gradient: K6 not launched in backward")

    # Batch sharding.
    bs = ranks[0]["batch_sharded"]
    st_one = one.status[:16].cpu().numpy()
    log(f"  solve_batch_sharded (2 ranks, 16 lanes): status {bs['status'].tolist()} vs one "
        f"card {st_one.tolist()}, num_solved {bs['num_solved']}")
    check(np.array_equal(bs["status"], st_one), "solve_batch_sharded: status differs")
    check(bs["num_solved"] == int((bs["status"] == SOLVED).sum()),
          "solve_batch_sharded: wrong solved count")
    return launches[0]["multi"], check_tp_routed(ranks, mcp, thetas, tp_routed, device)


def solver_option_launches(name, option_launches, rank_launches):
    """{run: launches} of the kernels line's entry ``name`` (K1, K2 or K4a)
    in phase 30c's runs and in the tp and routed ranks (rank 0 solves the
    lane-change bucket, rank 1 the QP bucket)."""
    key = {"thomas_solve": "thomas", "linesearch_update": "linesearch", "gj_solve": "gj"}.get(name)
    if key is None:
        return {}
    runs = {label: c[f"{key}_launches"] for label, c in option_launches.items()
            if c.get(f"{key}_launches")}
    for r, c in enumerate(rank_launches["tp"]):
        if c[key]:
            runs[f"solve_single_tp rank {r}"] = c[key]
    for r, c in enumerate(rank_launches["routed"]):
        if c[key]:
            runs[f"solve_routed rank {r}"] = c[key]
    return runs


TP_PANEL = 64  # the condensed lane-change system: 450 wide, 512 on 2 ranks
ROUTED_X_REL = 1e-5  # routed buckets against solve_batch, relative to max|x|


def tp_routed_tasks(thetas, options, device, seed=2034):
    """The rank tasks of the tensor-parallel and routed solves: one
    lane-change instance (lane 0 of ``thetas``) on "condensed" with the
    fused K2 linesearch, and the buckets (the lane-change headline batch on
    "tridiag_pallas"; a QP batch of B on "schur_pallas_gj" with the suite's
    options)."""
    import torch

    from mcp_tpu_torch import auto_tightening_rate
    from mcp_tpu_torch.bench import qp

    qp_mcp = qp.generate_test_problem(num_primals=QP_N, num_inequalities=QP_N,
                                      device=device).mcp
    qp_th = qp.generate_parameter_batch(torch.Generator().manual_seed(seed), B,
                                        num_primals=QP_N, num_inequalities=QP_N, device=device)
    qp_opts = dict(QP_OPTIONS, tightening_rate=auto_tightening_rate(qp_mcp))
    return [
        dict(kind="tp", name="tp", problem=dict(kind="lane_change", horizon=10),
             theta=thetas[0].cpu().numpy(), panel=TP_PANEL,
             options=dict(options, linear_solver="condensed", fused_linesearch=True)),
        dict(kind="routed", name="routed", buckets=[
            dict(problem=dict(kind="lane_change", horizon=10), thetas=thetas.cpu().numpy(),
                 options=options),
            dict(problem=dict(kind="qp", num_primals=QP_N, num_inequalities=QP_N),
                 thetas=qp_th.cpu().numpy(), options=qp_opts),
        ]),
    ]


def check_tp_routed(ranks, mcp, thetas, tp_routed, device):
    """Hold the ranks' tp and routed results against one card in this
    process: the tp instance against ``solve`` on "condensed" (status equal,
    both certified by the true KKT, max|Δx| printed: float32 parity is by
    status and certified KKT); each routed bucket against ``solve_batch`` of
    its θ (status and outer iterations equal, x within ROUTED_X_REL of
    max|x|, every SOLVED lane certified). K2 must launch in the tp ranks,
    K1 and K2 in the lane-change bucket's rank, K4a in the QP bucket's."""
    import torch

    from mcp_tpu_torch import SOLVED, SolverOptions, solve, solve_batch
    from mcp_tpu_torch.bench import horizon as worker
    from mcp_tpu_torch.bench.harness import true_kkt_errors

    tasks = {t["name"]: t for t in tp_routed}
    tp = ranks[0]["tp"]
    tp_opts = SolverOptions(**tasks["tp"]["options"])
    th0 = thetas[0]
    one = solve(mcp, th0, options=tp_opts)
    torch.cuda.synchronize()
    iterate = lambda got: SimpleNamespace(
        **{k: torch.as_tensor(got[k], device=device) for k in ("x", "y", "s")})
    tk_tp = float(true_kkt_errors(mcp, iterate(tp), th0))
    tk_one = float(true_kkt_errors(mcp, one, th0))
    dx = float(np.abs(tp["x"] - one.x.cpu().numpy()).max())
    tp_stats = dict(status=int(tp["status"]), one_card_status=int(one.status),
                    outer_iters=int(tp["outer_iters"]), one_card_outer_iters=int(one.outer_iters),
                    true_kkt=tk_tp, one_card_true_kkt=tk_one, max_abs_dx=dx,
                    max_abs_x=float(np.abs(tp["x"]).max()), seconds=tp["seconds"],
                    launches_per_rank=[r["tp"]["launches"] for r in ranks])
    log("  solve_single_tp (2 ranks, lane change, condensed 450 -> 512, panel 64): "
        + json.dumps(tp_stats))
    check(tp_stats["status"] == tp_stats["one_card_status"] == SOLVED,
          "solve_single_tp: status differs from one card or not SOLVED")
    check(tk_tp <= tp_opts.tol and tk_one <= tp_opts.tol,
          "solve_single_tp: a solution is not certified by the true KKT")
    check(all(r["tp"]["launches"]["linesearch"] > 0 for r in ranks),
          "solve_single_tp: K2 not launched in a rank")

    routed = ranks[0]["routed"]
    counts = [r["routed"]["launches"] for r in ranks]
    names = ("lane change (tridiag_pallas)", "QP (schur_pallas_gj)")
    for name, got, bucket in zip(names, routed["results"], tasks["routed"]["buckets"]):
        b = worker._build(bucket["problem"], device)
        th = torch.as_tensor(bucket["thetas"], device=device)
        ref = solve_batch(b, th, options=SolverOptions(**bucket["options"]))
        torch.cuda.synchronize()
        tk = true_kkt_errors(b, iterate(got), th)
        solved = torch.as_tensor(got["status"], device=device) == SOLVED
        tol = bucket["options"]["tol"]
        rel = float(np.abs(got["x"] - ref.x.cpu().numpy()).max() / np.abs(got["x"]).max())
        stats = dict(success_rate=float(solved.double().mean()),
                     certified=int((solved & (tk <= tol)).sum()),
                     median_outer_iters=float(np.median(got["outer_iters"])),
                     status_equal=bool(np.array_equal(got["status"], ref.status.cpu().numpy())),
                     outer_iters_equal=bool(np.array_equal(got["outer_iters"],
                                                           ref.outer_iters.cpu().numpy())),
                     x_rel=rel)
        log(f"  solve_routed bucket {name}: " + json.dumps(stats))
        check(stats["status_equal"] and stats["outer_iters_equal"],
              f"routed {name}: status or outer iterations differ from solve_batch")
        check(rel <= ROUTED_X_REL, f"routed {name}: x differs from solve_batch by {rel:.3e}")
        check(stats["certified"] == int(solved.sum()),
              f"routed {name}: a SOLVED lane is not certified")
    log(f"  solve_routed: {routed['seconds']:.2f} s; launches per rank {counts}")
    check(counts[0]["thomas"] > 0 and counts[0]["linesearch"] > 0,
          "routed: K1 or K2 not launched in the lane-change bucket's rank")
    check(counts[1]["gj"] > 0, "routed: K4a not launched in the QP bucket's rank")
    return {"tp": [r["tp"]["launches"] for r in ranks], "routed": counts}


def phase_long_horizon(device, out_dir):
    """The T=64 lane change, one instance in float64, solve_horizon_sharded
    on 4 ranks sharing the card with the JAX test's options (tier "tridiag",
    tol 1e-4, no polish, so the true KKT is reported, not held): SOLVED,
    the same outer iterations and x as the SPIKE algebra in one process on
    the card (T64_X_REL), and as the independent tier tridiag_pallas_cr (K3)
    on one card (T64_CR_REL)."""
    import functools

    import torch

    from mcp_tpu_torch import SOLVED, SolverOptions, solve
    from mcp_tpu_torch.bench import horizon as worker
    from mcp_tpu_torch.bench.harness import true_kkt_errors
    from mcp_tpu_torch.diff import _solve_ts
    from mcp_tpu_torch.parallel import horizon as H
    from mcp_tpu_torch.solver import default_initialization

    mcp, theta, x0 = t64_problem(device, torch.float64)
    opts = dict(linear_solver="tridiag", tol=1e-4)
    t0 = time.perf_counter()
    # The references run in this process while the ranks run (nothing here
    # is timed).
    job = worker.start(4, [dict(kind="solve", name="t64", theta=theta.cpu().numpy(),
                                x0=x0.cpu().numpy(), options=opts, horizon=64, height=300.0)],
                       out_dir, device=device, threads=2, timeout_s=RANK_TIMEOUT_S)
    one = _solve_ts(mcp, SolverOptions(**opts), functools.partial(H.spike_solve, num_slabs=4),
                    None, theta[None], *default_initialization(mcp, theta[None], x0[None]))
    cr = solve(mcp, theta, x0=x0, linear_solver="tridiag_pallas_cr", tol=1e-4)
    torch.cuda.synchronize()
    ranks = job()
    got = ranks[0]["t64"]
    x = torch.from_numpy(got["x"]).to(device)
    tk = float(true_kkt_errors(mcp, SimpleNamespace(
        **{k: torch.from_numpy(got[k]).to(device)[None] for k in ("x", "y", "s")}),
        theta[None])[0])
    rel = float((x - one.x[0]).abs().max() / one.x[0].abs().max())
    dx_cr = float((x - cr.x).abs().max())
    rel_cr = dx_cr / float(cr.x.abs().max())
    log(f"  T=64 on 4 ranks ({time.perf_counter() - t0:.1f} s): status {int(got['status'])} "
        f"in {int(got['outer_iters'])} outer iterations, true KKT {tk:.3e}; SPIKE in one "
        f"process: {int(one.status[0])} in {int(one.outer_iters[0])}, max|dx|/max|x|="
        f"{rel:.3e} (tol {T64_X_REL:g}); tridiag_pallas_cr (K3 qr) on one card: "
        f"{int(cr.status)} in {int(cr.outer_iters)}, max|dx|={dx_cr:.3e} of max|x| "
        f"{float(cr.x.abs().max()):.1f} (tol {T64_CR_REL:g} of max|x|); K6 launches per rank "
        f"{[r['t64']['launches']['multi'] for r in ranks]}, by route "
        f"{[r['t64']['launches']['multi_routes'] for r in ranks]}")
    for r in ranks[1:]:
        check(np.array_equal(r["t64"]["x"], got["x"]), "T=64: ranks differ")
    check(int(got["status"]) == SOLVED, "T=64: not SOLVED")
    check(int(got["outer_iters"]) == int(one.outer_iters[0]), "T=64: outer iterations differ")
    check(rel <= T64_X_REL, f"T=64: x differs by {rel:.3e}")
    check(int(cr.status) == SOLVED, "T=64: tridiag_pallas_cr did not solve")
    check(int(cr.outer_iters) == int(got["outer_iters"]),
          "T=64: outer iterations differ from tridiag_pallas_cr")
    check(rel_cr <= T64_CR_REL, f"T=64: x differs from tridiag_pallas_cr by {rel_cr:.3e}")
    check(all(r["t64"]["launches"]["multi"] > 0 for r in ranks), "T=64: K6 not launched")


# -- the benchmark entry point and the receding-horizon demo ---------------

# bench_cuda.py's suites driven in-process at full width (batch 256), each
# with every kernel count set to 0 just before and read just after: (label,
# arguments, the kernels that must launch, the success floor of PERF.md §2;
# the --dw row's floor is on frac_true_kkt_at_tol, the share of instances
# certified at 1e-6, in place of success_rate and certified). Depth is cut (4 batches x 2 spans streamed, 2 --dw
# repeats); the warm suite runs its full sweep of 10 steps.
BENCH_RUNS = (
    ("lane change", ["--suite", "lane_change", "--stream", "4", "--spans", "2"],
     ("thomas_solve", "linesearch_update"), 0.99),
    ("QP", ["--suite", "qp", "--stream", "4", "--spans", "2"], ("gj_solve",), QP_MIN_SUCCESS),
    ("warm", ["--suite", "warm"], ("thomas_solve", "linesearch_update"), 0.99),
    ("QP dw", ["--suite", "qp", "--dw", "--repeats", "2"], ("gauss_solve",), QP_MIN_SUCCESS),
)
# The receding-horizon demo: re-plans every 2 of 10 steps, one instance each.
DEMO_STEPS = 10
DEMO_STATE_TOL = 1e-2  # card float32 against CPU float64 (PERF.md §2)


def entry_counts():
    """Launch counts of the kernels the bench suites and the demo reach."""
    from mcp_tpu_torch.kernels import linear_solve as L

    counts = {name: total(c) for name, c in read_counts().items()}
    return {"thomas_solve": counts["thomas"], "linesearch_update": counts["linesearch"],
            "gj_solve": L.gj_solve.launches, "gauss_solve": L.gauss_solve.launches,
            "pallas_gauss_solve": L.pallas_gauss_solve.launches,
            "babe_thomas_solve": counts["babe"], "cr_thomas_solve": counts["cr"]}


def reset_entry_counts():
    from mcp_tpu_torch.kernels import linear_solve as L

    reset_counts()
    for w in (L.gj_solve, L.gauss_solve):
        w.launches = 0
        w.route_launches = dict.fromkeys(w.route_launches, 0)
    L.pallas_gauss_solve.launches = 0


# -- the solver options and the tensor-parallel and routed backends ---------

# The gmres tier on the QP suite: its knobs are the SolverOptions defaults
# (tol 1e-8, restart 50, at most 5 restarts, no preconditioner).
GMRES_RUNS = (("gmres ip (fused K2)", dict(linear_solver="gmres", algorithm="ip",
                                             fused_linesearch=True)),
              ("gmres mehrotra", dict(linear_solver="gmres")),
              ("schur_pallas_gj", {}))
PRECISIONS = ("highest", "high", "default")


def precision_flags():
    """The three settings a solve's matmul_precision sets and restores."""
    import torch

    return (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def qp_run(mcp, th, options, label):
    """One QP batch through ``solve_batch`` with K2's and K4a's counts set to
    0 just before and read just after: its figures, every SOLVED lane held to
    the float64 true KKT."""
    import torch

    from mcp_tpu_torch import SOLVED, solve_batch
    from mcp_tpu_torch.kernels import linear_solve as L
    from mcp_tpu_torch.kernels.linesearch import linesearch_update

    reset_counts()
    L.gj_solve.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solve_batch(mcp, th, options=options)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tk = certify64(mcp, res, th)
    solved = res.status == SOLVED
    stats = dict(success_rate=float(solved.double().mean()),
                 certified=int((solved & (tk <= options.tol)).sum()),
                 median_outer_iters=float(res.outer_iters.double().median()),
                 linesearch_launches=total(linesearch_update.launches),
                 gj_launches=L.gj_solve.launches, wall_s=wall)
    log(f"  {label}: " + json.dumps(stats))
    check(stats["certified"] == int(solved.sum()),
          f"{label}: a SOLVED lane has float64 true KKT above tol")
    return res, stats


def phase_solver_options(device, seed=2033):
    """The QP suite's batch (B=256, n=m=100, float32, the suite's options) on
    tier "gmres" under "ip" with the fused linesearch (K2) and under
    "mehrotra", and on "schur_pallas_gj" (K4a), the same θ; then
    "schur_pallas_gj" at each of PRECISIONS, the precision flags equal
    before and after. Returns {label: K2 and K4a launches}."""
    import torch

    from mcp_tpu_torch import SolverOptions, auto_tightening_rate
    from mcp_tpu_torch.bench import qp

    problem = qp.generate_test_problem(num_primals=QP_N, num_inequalities=QP_N, device=device)
    mcp = problem.mcp
    base = SolverOptions(**QP_OPTIONS, tightening_rate=auto_tightening_rate(mcp))
    th = qp.generate_parameter_batch(torch.Generator().manual_seed(seed), B,
                                     num_primals=QP_N, num_inequalities=QP_N, device=device)
    launches = {}
    runs = {}
    for label, over in GMRES_RUNS:
        _, runs[label] = qp_run(mcp, th, dataclasses.replace(base, **over), label)
        launches[label] = {k: runs[label][k] for k in ("linesearch_launches", "gj_launches")}
    check(runs["gmres ip (fused K2)"]["linesearch_launches"] > 0, "gmres ip: K2 never launched")
    check(runs["schur_pallas_gj"]["gj_launches"] > 0, "schur_pallas_gj: K4a never launched")
    for label in ("gmres ip (fused K2)", "gmres mehrotra"):
        check(runs[label]["gj_launches"] == 0, f"{label}: K4a launched")
    before = precision_flags()
    for name in PRECISIONS:
        label = f"schur_pallas_gj at matmul_precision={name!r}"
        _, st = qp_run(mcp, th, dataclasses.replace(base, matmul_precision=name), label)
        launches[label] = {"gj_launches": st["gj_launches"]}
        check(st["gj_launches"] > 0, f"{label}: K4a never launched")
    after = precision_flags()
    log(f"  precision flags before {before}, after {after}; card {card_line()}")
    check(after == before, f"matmul_precision: flags {before} became {after}")
    return launches


def phase_bench(device):
    """bench_cuda.py as a user runs it: each suite of BENCH_RUNS through
    ``mcp_tpu_torch.bench.main.main`` in this process, its last line parsed
    and held to the checks (certified, the success floor, timing_consistent,
    each expected kernel launched). Returns {label: counts}."""
    import io

    import torch

    from mcp_tpu_torch.bench.main import main as bench_main

    launches = {}
    for label, args, expect, floor in BENCH_RUNS:
        out = io.StringIO()
        reset_entry_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = bench_main(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = entry_counts()
        launches[label] = counts
        line = out.getvalue().strip().splitlines()[-1]
        log(f"  bench_cuda.py {' '.join(args)} ({wall:.1f} s): {line}")
        log(f"    launches: {counts}")
        res = json.loads(line)
        check(rc == 0, f"bench {label}: main returned {rc}")
        if "--dw" in args:
            # The double-word row is held by the share of instances it
            # certifies at 1e-6: its 8 refinement steps leave a few
            # ill-conditioned SOLVED lanes above 1e-6 (so does the JAX
            # package's refinement on the same iterates: python
            # tests/survey_rounding.py dw-lanes), so its `certified` is
            # reported, not required.
            share = res["frac_true_kkt_at_tol"]
        else:
            check(res["certified"] is True, f"bench {label}: not certified")
            share = res["success_rate"]
        check(share >= floor, f"bench {label}: {share} below the floor {floor}")
        check(res["timing_consistent"] is True, f"bench {label}: timing inconsistent")
        check(res["device"] != "cpu", f"bench {label}: ran on the CPU")
        for name in expect:
            check(counts[name] > 0, f"bench {label}: {name} never launched {counts}")

    return launches


def start_quick_bench():
    """``python3 bench_cuda.py --quick --stream 2 --spans 1`` as a child
    process (run beside the demo); ``finish_quick_bench`` holds its line."""
    work = Path(rank_dir("quick"))
    out, err = open(work / "stdout.txt", "w"), open(work / "stderr.txt", "w")
    with out, err:
        proc = subprocess.Popen(
            [sys.executable, "bench_cuda.py", "--quick", "--stream", "2", "--spans", "1"],
            cwd=Path(__file__).resolve().parent, stdout=out, stderr=err)
    return proc, work, time.perf_counter()


def finish_quick_bench(quick):
    """Wait for ``start_quick_bench``'s child and hold its last line:
    certified, batch 16."""
    proc, work, t0 = quick
    try:
        proc.wait(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    log(f"  python3 bench_cuda.py --quick --stream 2 --spans 1 (child process, beside the "
        f"demo): rc {proc.returncode} in {time.perf_counter() - t0:.1f} s")
    tail = (work / "stdout.txt").read_text().strip().splitlines()
    check(proc.returncode == 0 and tail,
          f"bench_cuda.py --quick failed: {(work / 'stderr.txt').read_text()[-2000:]}")
    log(f"    {tail[-1]}")
    quick = json.loads(tail[-1])
    check(quick["certified"] is True and quick["batch_size"] == 16,
          "bench_cuda.py --quick: not certified")


def phase_demo(device):
    """The receding-horizon lane-change demo (``run_lane_change_example``,
    DEMO_STEPS steps, tier "schur_pallas": each re-plan one instance, K8a)
    on the card in float32, with the counts set to 0 just before and read
    just after, against the same demo on the CPU in float64: each re-plan's
    status equal, the states within DEMO_STATE_TOL. Returns the counts."""
    import torch

    from mcp_tpu_torch import SOLVED, SolverOptions
    from mcp_tpu_torch.examples.lane_change import run_lane_change_example

    options = SolverOptions(linear_solver="schur_pallas")
    reset_entry_counts()
    t0 = time.perf_counter()
    sim, strat = run_lane_change_example(num_sim_steps=DEMO_STEPS, options=options,
                                         device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = entry_counts()
    ref, _ = run_lane_change_example(num_sim_steps=DEMO_STEPS, options=options, device="cpu",
                                     dtype=torch.float64)
    dx = float((sim.xs.double().cpu() - ref.xs).abs().max())
    log(f"  receding-horizon demo ({DEMO_STEPS} steps, schur_pallas, float32 card) in "
        f"{wall:.2f} s: statuses {sim.infos} (CPU float64 {ref.infos}), last re-plan at "
        f"t={strat.time_last_updated}, max|dx| {dx:.3e}, launches {counts}")
    check(sim.infos == ref.infos, "demo: a re-plan's status differs from the CPU's")
    check(all(s == SOLVED for s in sim.infos), "demo: a re-plan failed")
    check(dx <= DEMO_STATE_TOL, f"demo: states differ from the CPU's by {dx:.3e}")
    check(counts["pallas_gauss_solve"] > 0, f"demo: K8a never launched {counts}")
    return counts


def phase_single(device, schur):
    """The one-instance entry points on tier "schur_pallas": SINGLE_N
    lane-change θ through solve_game and SINGLE_N QP θ through solve, one at
    a time, float32, with K8a's and K4b's counts set to 0 just before and
    read just after; statuses against the CPU's float64 plain run on the
    same θ; then K8a against its plain version at both problems' Schur
    systems in float32 and float64. Returns (K8a launches, the lane-change
    f32 Schur system, the max abs error there)."""
    import torch

    from mcp_tpu_torch import auto_tightening_rate, solve, solve_game
    from mcp_tpu_torch.bench import lane_change as lc
    from mcp_tpu_torch.bench import qp
    from mcp_tpu_torch.kernels import linear_solve as L
    from mcp_tpu_torch.linalg import _schur_system
    from mcp_tpu_torch.solver import _make_linearizer

    games = {d: lc.generate_test_problem(horizon=10, device=d) for d in (device, "cpu")}
    qps = {d: qp.generate_test_problem(num_primals=QP_N, num_inequalities=QP_N, device=d)
           for d in (device, "cpu")}
    lane_opts = dict(HEADLINE, linear_solver="schur_pallas",
                     tightening_rate=auto_tightening_rate(games["cpu"].parametric_game.mcp))
    qp_opts = dict(QP_OPTIONS, linear_solver="schur_pallas")
    gen = torch.Generator().manual_seed(2033)
    lane_th = lc.generate_parameter_batch(gen, SINGLE_N, games["cpu"], dtype=torch.float64,
                                          device="cpu")
    qp_th = qp.generate_parameter_batch(gen, SINGLE_N, num_primals=QP_N,
                                        num_inequalities=QP_N, dtype=torch.float64,
                                        device="cpu")
    L.pallas_gauss_solve.launches = L.gauss_solve.launches = 0
    t0 = time.perf_counter()  # the one-instance window
    card = {"lane": [], "qp": []}
    for th in lane_th:
        card["lane"].append(solve_game(games[device].parametric_game,
                                       th.to(device=device, dtype=torch.float32), **lane_opts))
    for th in qp_th:
        card["qp"].append(solve(qps[device].mcp, th.to(device=device, dtype=torch.float32),
                                **qp_opts))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, k4b = L.pallas_gauss_solve.launches, L.gauss_solve.launches
    ref = {"lane": [solve_game(games["cpu"].parametric_game, th, **lane_opts) for th in lane_th],
           "qp": [solve(qps["cpu"].mcp, th, **qp_opts) for th in qp_th]}
    for key in ("lane", "qp"):
        st_card = [int(r.status) for r in card[key]]
        st_ref = [int(r.status) for r in ref[key]]
        it_card = [int(r.outer_iters) for r in card[key]]
        log(f"  one-instance {key} (schur_pallas, f32 card vs f64 CPU): status {st_card} vs "
            f"{st_ref}, outer iterations {it_card}")
        check(st_card == st_ref, f"one-instance {key}: status differs from the CPU's")
    log(f"  {2 * SINGLE_N} one-instance solves in {wall:.2f} s: K8a launches {launches}, "
        f"K4b {k4b}")
    check(launches > 0 and k4b == 0, "one-instance path: K8a not launched, or K4b launched")

    # K8a against its plain version at both Schur systems (cold start).
    mcp = games[device].parametric_game.mcp
    th = lane_th[:1].to(device=device, dtype=torch.float32)
    n, m = mcp.unconstrained_dimension, mcp.constrained_dimension
    zeros = torch.zeros((1, n), dtype=torch.float32, device=device)
    ones = torch.ones((1, m), dtype=torch.float32, device=device)
    g, h, Gx, Gy, Hx, _ = _make_linearizer(mcp, th, torch.float32)(zeros, ones)
    lane_A, lane_b, *_ = _schur_system(Gx, Gy, Hx, ones, ones, g, h - ones, ones - 1.0,
                                       HEADLINE["tol"])
    k8a = ("pallas_gauss_solve", L.pallas_gauss_solve, L.qr_solve_sep_plain)
    err = dense_check(f"{k8a[0]} lane-change Schur system (1,200) float32", *k8a[1:],
                      lane_A, lane_b)
    # The same system in float64 (a cluster of 8 CTAs holds A in slabs).
    f64 = torch.float64
    zeros64, ones64 = zeros.to(f64), ones.to(f64)
    g, h, Gx, Gy, Hx, _ = _make_linearizer(mcp, th.to(f64), f64)(zeros64, ones64)
    lane_A64, lane_b64, *_ = _schur_system(Gx, Gy, Hx, ones64, ones64, g, h - ones64,
                                           ones64 - 1.0, HEADLINE["tol"])
    dense_check(f"{k8a[0]} lane-change Schur system (1,200) float64", *k8a[1:],
                lane_A64.contiguous(), lane_b64.contiguous())
    for dt in (torch.float32, torch.float64):
        dense_check(f"{k8a[0]} QP Schur system (1,100) {str(dt)[6:]}", *k8a[1:],
                    schur[0][:1].to(dt).contiguous(), schur[1][:1].to(dt).contiguous())
    return launches, (lane_A, lane_b), err


def phase_wy(schur):
    """K8b's path (the JAX package's scripts/profile_qp_phases.py question):
    the cold-start QP Schur systems (B=256, n=100, padded to 104) solved by
    K8b beside K4b, with K8b's count set to 0 just before and read just
    after; then K8b against its plain version and K4b in float32 and
    float64 on the plan's route (asserted: the pair route in float32, the
    block route in float64), in float32 on the block route forced by the
    plan and at the first order beyond the pair route (n = 121, on the
    block route), and a zero pivot on each route. Returns (K8b launches,
    max abs error against the plain version)."""
    import torch

    from mcp_tpu_torch.kernels import linear_solve as L

    A, b = schur
    L.wy_solve.launches = 0
    x_wy = L.wy_solve(A, b)
    torch.cuda.synchronize()
    launches = L.wy_solve.launches
    err = 0.0
    for dt in (torch.float32, torch.float64):
        tag = str(dt)[6:]
        Ad, bd = A.to(dt), b.to(dt)
        x_wy = L.wy_solve(Ad, bd)
        x_qr = L.gauss_solve(Ad, bd)
        torch.cuda.synchronize()
        bwd_wy, bwd_qr = backward_error(Ad, bd, x_wy), backward_error(Ad, bd, x_qr)
        rel = float((x_wy - x_qr).abs().max() / x_qr.abs().max())
        log(f"  K8b vs K4b on the QP Schur systems {tuple(A.shape)} {tag}: backward error "
            f"K8b {bwd_wy:.3e}, K4b {bwd_qr:.3e}; max|x_K8b - x_K4b|/max|x|={rel:.3e}")
        check(bwd_wy <= QR_BWD_TOL[tag], f"K8b {tag}: backward error {bwd_wy:.3e}")
        want = "pair" if dt == torch.float32 else "block"
        check(L.wy_plan(QP_N, 8, dt).route == want, f"wy_solve: n={QP_N} in {tag} is not "
              f"on the {want} route")
        e = dense_check(f"wy_solve QP Schur (256,100) {tag}", L.wy_solve, L.wy_solve_plain,
                        Ad, bd)
        if dt == torch.float32:
            err = e
            dense_check(f"wy_solve QP Schur (256,100) {tag} [block, forced]", L.wy_solve,
                        L.wy_solve_plain, Ad, bd, plan=L.wy_plan(QP_N, 8, dt, route="block"))
            beyond = next(n for n in range(1, 129) if L.wy_plan(n, 8, dt).route == "block")
            dense_check(f"wy_solve random (256,{beyond}) {tag} [block]", L.wy_solve,
                        L.wy_solve_plain, *random_systems(B, beyond, dt, "cuda", 33))
        # A zero pivot: system 2 has a zero first row and column; QR gives
        # inf/NaN there, and the other systems agree with the plain version.
        Z, zb = spd_systems(4, QP_N, dt, "cuda", 25)
        Z[2, 0, :] = 0.0
        Z[2, :, 0] = 0.0
        plans = (L.wy_plan(QP_N, 8, dt), L.wy_plan(QP_N, 8, dt, route="block"))
        for plan in dict.fromkeys(plans):
            routes = dict(L.wy_solve.route_launches)
            x, xp = L.wy_solve(Z, zb, plan=plan), L.wy_solve_plain(Z, zb)
            torch.cuda.synchronize()
            took = [r for r, k in L.wy_solve.route_launches.items() if k != routes[r]]
            bad = (~torch.isfinite(x).all(dim=1)).tolist()
            bad_p = (~torch.isfinite(xp).all(dim=1)).tolist()
            others = float((x[[0, 1, 3]] - xp[[0, 1, 3]]).abs().max())
            log(f"  wy_solve zero pivot {tag} [{plan.route}]: non-finite systems kernel={bad} "
                f"plain={bad_p}, other systems max|kernel-plain| {others:.3e}")
            check(took == [plan.route], f"wy_solve zero pivot: launched on route {took}")
            check(bad == [False, False, True, False] and bad_p == bad,
                  f"wy_solve zero pivot {tag} [{plan.route}]: expected inf/NaN in system 2 only")
            check(others <= 1e-3 * float(xp[[0, 1, 3]].abs().max()),
                  f"wy_solve zero pivot {tag} [{plan.route}]: the other systems changed")
    return launches, err


def multi_counts(Bn, T, b, k, shared_bands, itemsize=4):
    """(bytes, flops) of one K6 solve: diag, the bands and R read once, x
    written once; per step the QR of b × (2b+k) (``aug_flops``), L·[C | d]
    (steps t ≥ 1) and the back substitution on k columns."""
    band = (T - 1) * b * b * itemsize * (1 if shared_bands else Bn)
    nbytes = Bn * T * b * b * itemsize + 2 * band + 2 * Bn * T * b * k * itemsize
    flops = Bn * (T * (aug_flops(b, b + k, "qr") + 2 * b * b * k)
                  + (T - 1) * 2 * b * b * (b + k))
    return nbytes, flops


def sep_counts(Bn, n, itemsize=4):
    """(bytes, flops) of one K8a solve: A and b read once, x written once;
    per reflection over the j = n − k trailing rows the norm, u·u, uᵀA and
    u·b, the rank-1 updates of A and b (4j² + 8j), then the back
    substitution."""
    per = sum(4 * j * j + 8 * j for j in range(1, n + 1)) + n * (n + 1)
    return Bn * (n * n + 2 * n) * itemsize, Bn * per


def wy_counts(Bn, n, nb=8, itemsize=4):
    """(bytes, flops) of one K8b solve at the padded n: A and b read once, x
    written once; per panel the nb reflections confined to the panel (norm,
    u·u, uᵀP, Uᵀu, the panel update, larft's column of T), the products
    Uᵀ[A | b], Tᵀ(·) and the update U(·) over the trailing rows and the
    columns right of the panel (b included; the panel's own columns are R
    once its reflections are done), then the back substitution."""
    flops = 0
    for j0 in range(0, n, nb):
        for k in range(nb):
            r = n - j0 - k
            flops += 4 * r + 4 * r * (nb - k) + 2 * r * k + 2 * k * k
        cols, rows = n + 1 - j0 - nb, n - j0
        flops += 2 * nb * rows * cols + 2 * nb * nb * cols + 2 * nb * rows * cols
    flops += n * (n + 1)
    return Bn * (n * n + 2 * n) * itemsize, Bn * flops


def sep_plan_of(n, dtype, cluster):
    """K8a's plan for order n on clusters of ``cluster`` CTAs (the plan's
    even spread of whole panels), for the cluster-size sweep."""
    import torch

    from mcp_tpu_torch.kernels import linear_solve as L

    per, extra = divmod(-(-n // L.QR_SEP_PANEL), cluster)
    bounds = [0]
    for r in range(cluster):
        bounds.append(min(n, bounds[-1] + L.QR_SEP_PANEL * (per + (r < extra))))
    wsmax = max(hi - lo for lo, hi in zip(bounds, bounds[1:]))
    smem = L._qr_sep_smem_bytes(n, wsmax, torch.empty((), dtype=dtype).element_size())
    if smem > 232448 or per == 0:
        raise ValueError(f"n={n} on {cluster} CTAs needs {smem} bytes per CTA")
    return L.SepPlan(cluster, 256, tuple(bounds), smem)


def phase_new_timing(k6, k8a, k8b):
    """K6, K8a and K8b at their paths' shapes beside their bounds, their
    plain versions and one batched torch.linalg.solve of the same function
    (never called by the port); K6 on its plan's route against its block
    route in turns, in float32 and float64, beside phase 10's device times
    per launch."""
    import torch

    from mcp_tpu_torch.kernels import linear_solve as L
    from mcp_tpu_torch.kernels.thomas_multi import (
        multi_plan,
        thomas_solve_multi,
        thomas_solve_multi_plain,
    )

    kernels = []
    args, err, launches, (k6_dev, k6_old_dev) = k6
    Bn, T, b, k = args[3].shape
    A, _ = dense_block_system(*args[:3], args[3][..., 0])
    R = args[3].reshape(Bn, T * b, k).contiguous()
    nbytes, flops = multi_counts(Bn, T, b, k, args[1].stride(0) == 0)
    b_ms, b_by = bound(nbytes, flops)
    # The plan's route against the block route forced by the plan, in
    # turns, in float32 and on the same bands in float64.
    plan, old = multi_plan(b, k, args[0].dtype), multi_plan(b, k, args[0].dtype, route="block")
    k6_ms, k6_old = ab_ms(lambda: thomas_solve_multi(*args, plan=plan),
                          lambda: thomas_solve_multi(*args, plan=old), 50)
    args64 = tuple(a.double() for a in args)
    group64, block64 = (multi_plan(b, k, torch.float64, route=r) for r in ("group", "block"))
    new64, old64 = ab_ms(lambda: thomas_solve_multi(*args64, plan=group64),
                         lambda: thomas_solve_multi(*args64, plan=block64), 20)
    f64_routes = {"plan_route": multi_plan(b, k, torch.float64).route, "group_ms": new64,
                  "block_ms": old64}
    log(f"  K6 ({Bn},{T},{b},{k}): float32 route {plan.route} {k6_ms:.4f} ms, block route "
        f"{k6_old:.4f} ms; float64 group route {new64:.4f} ms, block route {old64:.4f} ms "
        f"(the plan takes {f64_routes['plan_route']}); in turns")
    kernels.append({
        "name": "thomas_solve_multi", "route": "cuda",
        "source": "mcp_tpu_torch/kernels/csrc/thomas_multi.cu",
        "replaces": "mcp_tpu/kernels/thomas_pallas.py:572", "launches": launches,
        "max_abs_err": err, "ms": k6_ms,
        "plain_ms": cuda_ms(lambda: thomas_solve_multi_plain(*args), 3),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms(lambda: torch.linalg.solve(A, R), 10),
        "plan": plan_fields(plan), "old_route_ms": k6_old, "float64_routes": f64_routes,
        "device_ms": k6_dev, "old_route_device_ms": k6_old_dev})
    (A, b), err, launches = k8a
    nbytes, flops = sep_counts(A.shape[0], A.shape[1])
    b_ms, b_by = bound(nbytes, flops)
    plan = L.qr_sep_plan(A.shape[1], A.dtype)
    k8a_ms = cuda_ms(lambda: L.pallas_gauss_solve(A, b), 50)
    lib_ms = cuda_ms(lambda: torch.linalg.solve(A, b[..., None]), 20)
    # The plan's cluster against the others, in turns.
    sweep = {}
    orig = L.qr_sep_plan
    for c in (1, 2, 4, 8, 8, 4, 2, 1):
        L.qr_sep_plan = lambda n, dtype, c=c: sep_plan_of(n, dtype, c)
        try:
            sweep.setdefault(str(c), []).append(cuda_ms(lambda: L.pallas_gauss_solve(A, b), 20))
        except ValueError as exc:
            sweep[str(c)] = f"does not fit: {exc}"
        finally:
            L.qr_sep_plan = orig
    kernels.append({
        "name": "pallas_gauss_solve", "route": "cuda",
        "source": "mcp_tpu_torch/kernels/csrc/qr_sep.cu",
        "replaces": "mcp_tpu/kernels/linear_solve.py:38", "launches": launches,
        "max_abs_err": err, "ms": k8a_ms,
        "plain_ms": cuda_ms(lambda: L.qr_solve_sep_plain(A, b), 3),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
        "cluster": plan.cluster, "threads": plan.threads, "smem_per_cta": plan.smem_per_cta,
        "cluster_ms": sweep})
    log(f"  K8a (1,{A.shape[1]}) float32: {k8a_ms:.4f} ms against torch.linalg.solve "
        f"{lib_ms:.4f} ms in this run (one block per system: {SINGLE_BLOCK_MS['pallas_gauss_solve']} ms "
        f"against {SINGLE_BLOCK_MS['pallas_gauss_solve library']} ms); cluster {plan.cluster}, slabs "
        f"{plan.bounds}, shared memory per CTA {plan.smem_per_cta}; by cluster size in turns "
        f"(ms): {sweep}")
    (A, b), err, launches, k8b_device = k8b
    nbytes, flops = wy_counts(A.shape[0], -(-A.shape[1] // 8) * 8)
    b_ms, b_by = bound(nbytes, flops)
    # The plan's route (pair) against the block route forced by the plan,
    # and K4b's pair route, wrapper calls in turns; the device times per
    # launch of phase 10's profile beside them.
    n = A.shape[1]
    plan, old = L.wy_plan(n, 8, A.dtype), L.wy_plan(n, 8, A.dtype, route="block")
    wy_ms, wy_old = ab_ms(lambda: L.wy_solve(A, b, plan=plan),
                          lambda: L.wy_solve(A, b, plan=old), 50)
    k4b, _ = ab_ms(lambda: L.gauss_solve(A, b), lambda: L.wy_solve(A, b, plan=plan), 50)
    A64, b64 = A.double(), b.double()
    plan64 = L.wy_plan(n, 8, torch.float64)
    k4b64, wy64 = ab_ms(lambda: L.gauss_solve(A64, b64),
                        lambda: L.wy_solve(A64, b64, plan=plan64), 20)
    kernels.append({
        "name": "wy_solve", "route": "cuda", "source": "mcp_tpu_torch/kernels/csrc/wy_qr.cu",
        "replaces": "mcp_tpu/kernels/linear_solve.py:103", "launches": launches,
        "max_abs_err": err, "ms": wy_ms,
        "plain_ms": cuda_ms(lambda: L.wy_solve_plain(A, b), 3),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms(lambda: torch.linalg.solve(A, b[..., None]), 20),
        "plan": plan_fields(plan), "old_route_ms": wy_old,
        "device_ms": k8b_device["float32"]["pair"],
        "old_route_device_ms": k8b_device["float32"]["block"],
        "k4b_pair_device_ms": k8b_device["float32"]["k4b_pair"], "k4b_ms": k4b,
        "float64_routes": {"plan_route": plan64.route, "ms": wy64, "k4b_ms": k4b64,
                           "device_ms": k8b_device["float64"]}})
    for e in kernels:
        log(f"  {e['name']}: {e['ms']:.4f} ms (plain {e['plain_ms']:.3f} ms, bound "
            f"{e['bound_ms']:.5f} ms by {e['bound_by']}, library {e['library_ms']:.4f} ms); "
            f"launches {e['launches']} in its path's window")
    log(f"  K8b ({A.shape[0]},{n} -> 104) float32: pair route {wy_ms:.4f} ms, block route "
        f"{wy_old:.4f} ms, K4b (gauss_solve, pair route) {k4b:.4f} ms, wrapper calls in turns; "
        f"device time per launch {k8b_device['float32']} ms (phase 10); float64 on route "
        f"{plan64.route} {wy64:.4f} ms, K4b {k4b64:.4f} ms in turns, device "
        f"{k8b_device['float64']} ms")
    return kernels


# -- the player-selection pipeline ------------------------------------------

# The pipeline of the JAX package's scripts/datagen.py, train_selection.py and
# evaluate_selection.py at their defaults' width: N=4, horizon 30, the masked
# road game (b=40, n=1200), float32, the runner on tier "tridiag_pallas" with
# the banded IFT and the training step's options (tightening max(auto, 0.05)
# = 0.05 at b=40, the terminal polish). SEL_SCENARIOS scenarios from the
# native sampler (seed 0): the first SEL_GT go to the ground truth (one
# chunk), whose first SEL_TRAIN SOLVED examples train and the rest validate;
# the last SEL_EVAL are held out for the evaluation sweep. The sweep is cut in
# depth to fit the script's time limit (a batched sim step takes 4.5-6.3 s of
# host time with an H100): the NN mode runs SEL_SIM_STEPS steps (it leaves its
# 10-step bootstrap at step 11), the heuristic modes SEL_HEURISTIC_STEPS (the
# second step warm-starts from the first).
# The stages that need nothing of another run in child processes beside the
# in-process chain (ground truth, train(), the NN mode's sweep, the subgames),
# all started with the phase: the CPU float64 reference solve of two scenarios
# (SEL_REF_THREADS threads), the heuristic modes' sweep with the serial
# rollout it is held against, the real-data rollout
# (tests/fixtures/ped/scenario1.csv, its recorded 30 steps), and the three
# CLIs one after another. A child redraws the scenarios from the same seed.
SEL_N, SEL_T = 4, 30
SEL_OPTIONS = dict(linear_solver="tridiag_pallas", sensitivity_solver="tridiag",
                   tightening_rate=0.05, polish=True)
SEL_SCENARIOS, SEL_GT, SEL_TRAIN, SEL_EVAL = 32, 24, 16, 8
SEL_TRAIN_CONFIG = dict(batch_size=8, epochs=2, patience=1)
SEL_NN_MODE = ("Neural Network Partial Rank", 2)
SEL_HEURISTIC_MODES = {"All": [1], "Nearest Neighbor": [2], "Distance Threshold": [2]}
SEL_SIM_STEPS, SEL_HEURISTIC_STEPS = 12, 2
# Floors, from the first run on the card: 24 of 24 ground-truth scenarios
# SOLVED, every evaluation step SOLVED, 28 of 30 real-data steps SOLVED.
SEL_MIN_GT = 22
SEL_MIN_EVAL_SUCCESS = 0.95
SEL_MIN_REAL_SUCCESS = 0.85
# The ground truth of two scenarios on the card (float32, kernels) against
# the port's CPU float64 solve (plain versions): the same status, and
# max|Δ trajectory| / max|trajectory| ≤ SEL_REF_TOL (measured 2.2e-07 on the
# card). The batched "All" rollout of held-out scenario 0 against
# evaluate_scenario's serial one, both on the card: the same statuses and
# masks, states within SEL_SERIAL_TOL (measured bit-equal on the card, 2.4e-7
# on the CPU).
SEL_REF_TOL, SEL_SERIAL_TOL = 3e-6, 1e-5
SEL_REF_THREADS = 2
SEL_CLI = (("datagen", "--out", "{d}/data", "--players", "2", "--horizon", "4", "--train", "4",
            "--val", "2", "--test", "2", "--tier", "tridiag_pallas"),
           ("train_selection", "--data", "{d}/data", "--players", "2", "--horizon", "4",
            "--input-horizon", "2", "--epochs", "1", "--batch-size", "2", "--tier",
            "tridiag_pallas", "--log-dir", "{d}/run"),
           ("evaluate_selection", "--data", "{d}/data", "--players", "2", "--horizon", "4",
            "--input-horizon", "2", "--steps", "2", "--scenarios", "2", "--model",
            "{d}/run/best_model.pkl", "--modes", "All", "Neural Network Partial Rank",
            "--tier", "tridiag_pallas", "--out", "{d}/eval"))


@contextlib.contextmanager
def record_solves(runner):
    """While active, ``runner.solve`` keeps each call's (θ, BatchSolution)."""
    real = runner.solve
    calls = []

    def solve(init, goals, masks, *, mask_rows=None, **kw):
        bs = real(init, goals, masks, mask_rows=mask_rows, **kw)
        rows = masks[:, None, :].expand(masks.shape[0], runner.N, runner.N) \
            if mask_rows is None else mask_rows
        calls.append((runner.pack_thetas(init, goals, rows), bs))
        return bs

    object.__setattr__(runner, "solve", solve)
    try:
        yield calls
    finally:
        object.__delattr__(runner, "solve")


def stage_launches(name, counts, routes, Bn, n, m, ift=None):
    """A stage's launches as the phase line prints them, held to: K7a on the
    group route only (in the backward too, where ``ift`` is given), K2 on
    its plan's route at (Bn, n, m), no K1, no K3."""
    import torch

    out = {"babe": counts["babe"]["qr"], "babe_routes": routes["babe"],
           "linesearch": counts["linesearch"], "linesearch_routes": routes["linesearch"],
           "thomas": total(counts["thomas"]), "cr": total(counts["cr"])}
    if ift is not None:
        out["babe_forward"] = out["babe"] - ift["launches"]
        out["babe_backward"] = ift["launches"]
        check(out["babe_forward"] > 0 and out["babe_backward"] > 0
              and ift["group_launches"] == ift["launches"],
              f"{name}: K7a not on the group route in both passes {out}")
    check(out["babe"] > 0 and routes["babe"]["group"] == total(counts["babe"]),
          f"{name}: K7a not launched, or launched off the group route {out}")
    ls_route_check(name, routes["linesearch"], out["linesearch"], Bn, n, m, torch.float32)
    check(out["thomas"] == 0 and out["cr"] == 0, f"{name}: K1 or K3 launched {out}")
    return out


def selection_runner(device):
    """The phase's game and its runner on ``device`` (see SEL_N)."""
    from mcp_tpu_torch import SolverOptions
    from mcp_tpu_torch.selection import (
        MaskedGameRunner, setup_road_environment, setup_trajectory_game)

    game = setup_trajectory_game(environment=setup_road_environment(length=10.0), N=SEL_N)
    return game, MaskedGameRunner.create(game, N=SEL_N, horizon=SEL_T, device=device,
                                         options=SolverOptions(**SEL_OPTIONS))


def selection_scenarios():
    """The phase's scenarios, from the native sampler at seed 0."""
    from mcp_tpu_torch.selection import generate_scenarios

    return generate_scenarios(num_scenarios=SEL_SCENARIOS, num_players=SEL_N, seed=0,
                              backend="native")


def selection_child(kind, out_dir, device="cuda"):
    """One stage of ``phase_selection`` in a child process (``python3 -c``),
    its seconds, counts and results written under ``out_dir``:

    * "reference": the all-ones-mask solve of the first two scenarios on
      the CPU in float64 (the plain versions), to ``reference.npz``;
    * "heuristics": the launch counts set to 0, ``evaluate_modes`` of the
      held-out scenarios in SEL_HEURISTIC_MODES for SEL_HEURISTIC_STEPS, the
      counts read; then ``evaluate_scenario`` (serial) of the first held-out
      scenario in mode "All", to ``serial.json``;
    * "real": the counts set to 0, ``evaluate_real_scenarios`` on
      tests/fixtures/ped/scenario1.csv for its recorded steps, mode "All",
      the counts read.

    The counts and seconds go to ``out_dir/stage.json``."""
    import torch

    out = Path(out_dir)
    info = {}
    if kind == "reference":
        torch.set_num_threads(SEL_REF_THREADS)
        t0 = time.perf_counter()
        _, cpu = selection_runner("cpu")
        two = selection_scenarios()[:2]
        ref = cpu.solve(*(torch.as_tensor(np.stack([getattr(s, k) for s in two]),
                                          dtype=torch.float64)
                          for k in ("initial_states", "goals")),
                        torch.ones((2, SEL_N), dtype=torch.float64))
        np.savez(out / "reference.npz", trajectories=ref.trajectories.numpy(),
                 status=ref.result.status.numpy())
        info["seconds"] = time.perf_counter() - t0
    elif kind == "heuristics":
        from mcp_tpu_torch.selection import evaluate_modes, evaluate_scenario

        _, runner = selection_runner(device)
        held_out = selection_scenarios()[SEL_SCENARIOS - SEL_EVAL:]
        reset_counts()
        t0 = time.perf_counter()
        evaluate_modes(runner, held_out, SEL_HEURISTIC_MODES, str(out),
                       num_sim_steps=SEL_HEURISTIC_STEPS, verbose=False)
        torch.cuda.synchronize()
        info.update(seconds=time.perf_counter() - t0, counts=read_counts(),
                    routes=read_routes())
        reset_counts()
        t0 = time.perf_counter()
        serial = evaluate_scenario(runner, held_out[0], "All", 1,
                                   num_sim_steps=SEL_HEURISTIC_STEPS)
        torch.cuda.synchronize()
        info["serial_seconds"] = time.perf_counter() - t0
        (out / "serial.json").write_text(json.dumps(serial))
    elif kind == "real":
        from mcp_tpu_torch import SolverOptions
        from mcp_tpu_torch.selection import real_data

        root = Path(__file__).resolve().parent
        ped = real_data.load_scenario_csv(
            str(root / "tests" / "fixtures" / "ped" / "scenario1.csv"))
        opts = SolverOptions(**SEL_OPTIONS)
        real_data.make_real_runner(N=SEL_N, horizon=SEL_T, device=device, options=opts)
        reset_counts()
        t0 = time.perf_counter()
        real_data.evaluate_real_scenarios([ped], {"All": [1]}, str(out), N=SEL_N,
                                          horizon=SEL_T, verbose=False, device=device,
                                          options=opts)
        torch.cuda.synchronize()
        info.update(seconds=time.perf_counter() - t0, sim_steps=ped.sim_steps,
                    counts=read_counts(), routes=read_routes())
    else:
        raise ValueError(f"unknown selection stage {kind!r}")
    (out / "stage.json").write_text(json.dumps(info))


def run_selection_clis(work, procs, out, stop):
    """The three CLIs one after another as child processes (each added to
    ``procs`` under ``stop``'s lock), until one fails or ``stop`` is set;
    their return codes, seconds and last lines go to ``out``."""
    root = Path(__file__).resolve().parent
    for name, *args in SEL_CLI:
        t0 = time.perf_counter()
        with stop.lock:
            if stop.is_set():
                return
            p = subprocess.Popen([sys.executable, "-m", f"mcp_tpu_torch.scripts.{name}",
                                  *(a.format(d=work) for a in args)], cwd=root,
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            procs.append(p)
        try:
            stdout, stderr = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            p.kill()
            stdout, stderr = p.communicate()
        out[name] = {"rc": p.returncode, "seconds": time.perf_counter() - t0,
                     "last": (stdout.strip().splitlines() or [""])[-1], "stderr": stderr[-2000:]}
        if p.returncode != 0:
            return


def stage_start(secs, name):
    """Set every launch count to 0 and start the clock of stage ``name``."""
    reset_counts()
    secs[name] = time.perf_counter()


def stage_end(secs, name):
    """Stop stage ``name``'s clock after a synchronize; its launch counts
    and routes."""
    import torch

    torch.cuda.synchronize()
    secs[name] = time.perf_counter() - secs[name]
    return read_counts(), read_routes()


def selection_eval_results(out_dir, modes, steps, results):
    """Read the sweep's files of ``modes`` (run for ``steps``) in ``out_dir``
    into ``results[(mode, param, sid)]``, each checked for its shape; the
    mean ``analyze_result`` of each (mode, param)."""
    from mcp_tpu_torch.analysis import analyze_result

    metrics = {}
    for mode, params in modes.items():
        for p in params:
            rows = []
            for sid in range(SEL_EVAL):
                path = Path(out_dir) / f"receding_horizon_trajectories_[{sid}]_[{mode}]_[{p}].json"
                check(path.exists(), f"selection: no {path.name}")
                r = results[(mode, p, sid)] = json.loads(path.read_text())
                check(len(r["Player 1 Mask"]) == steps
                      and len(r["Player 1 Trajectory"]) == steps + 1
                      and np.isfinite(np.asarray(r["Player 1 Trajectory"])).all(),
                      f"selection: malformed evaluation result {path.name}")
                rows.append(analyze_result(r, num_players=SEL_N))
            metrics[f"{mode} [{p}]"] = {k: float(np.mean([r[k] for r in rows])) for k in rows[0]}
    return metrics


def phase_selection(device):
    """The player-selection pipeline through its entry points (see SEL_N).
    In this process: ``generate_scenarios`` (native),
    ``generate_ground_truth`` (certified by true KKT), ``train``,
    ``load_checkpoint`` and ``evaluate_modes`` of the NN mode,
    ``solve_subgames``. Beside them, in child processes started with the
    phase: the CPU's float64 solve of two scenarios (held against the ground
    truth), ``evaluate_modes`` of the heuristic modes and the serial
    ``evaluate_scenario`` (held against its batched rollout),
    ``evaluate_real_scenarios``, and the three CLIs. Every stage runs with
    the launch counts set to 0 just before it and read just after; every
    evaluation file goes through ``analyze_result``. Returns the phase's
    stats (printed as one JSON line)."""
    import threading

    from mcp_tpu_torch import SOLVED, auto_tightening_rate
    from mcp_tpu_torch.analysis import analyze_result

    root = Path(__file__).resolve().parent
    work = Path(rank_dir("selection"))
    secs, launches, stats = {}, {}, {}
    children, cli_procs, cli = {}, [], {}
    stop = threading.Event()
    stop.lock = threading.Lock()
    cli_thread = threading.Thread(target=run_selection_clis,
                                  args=(work / "cli", cli_procs, cli, stop))
    try:
        with stop.lock:
            for kind in ("reference", "heuristics", "real"):
                (work / kind).mkdir()
                with open(work / kind / "stderr.txt", "w") as err:
                    children[kind] = subprocess.Popen(
                        [sys.executable, "-c",
                         "import sys, chip_smoke; chip_smoke.selection_child(*sys.argv[1:])",
                         kind, str(work / kind), str(device)],
                        cwd=root, stdout=subprocess.DEVNULL, stderr=err)
        cli_thread.start()

        t0 = time.perf_counter()
        _, runner = selection_runner(device)
        mcp = runner.parametric_game.mcp
        n, m = mcp.unconstrained_dimension, mcp.constrained_dimension
        secs["game_build"] = time.perf_counter() - t0
        check((n, m) == K2_SHAPES[1][1:] and mcp.time_structure.block_size == 40
              and max(auto_tightening_rate(mcp), 0.05) == SEL_OPTIONS["tightening_rate"],
              f"selection: the game's shape is {(n, m)}")
        gt, results, metrics = _selection_stages(runner, work, device, secs, launches, stats)

        done = {}
        for kind, proc in children.items():
            try:
                proc.wait(timeout=900)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            err = (work / kind / "stderr.txt").read_text()
            check(proc.returncode == 0, f"selection: the {kind} child failed: {err[-2000:]}")
            done[kind] = json.loads((work / kind / "stage.json").read_text())
        cli_thread.join()
    except BaseException:
        with stop.lock:
            stop.set()
            for proc in [*children.values(), *cli_procs]:
                proc.kill()
        if cli_thread.is_alive():
            cli_thread.join()
        raise

    ref = np.load(work / "reference" / "reference.npz")
    secs["reference (child)"] = done["reference"]["seconds"]
    rel = float(np.abs(ref["trajectories"] - gt.trajectories[:2].double().cpu().numpy()).max()
                / np.abs(ref["trajectories"]).max())
    log(f"  ground truth vs the CPU float64 solve, 2 scenarios (child process): status "
        f"{ref['status'].tolist()} vs {gt.result.status[:2].tolist()}, max|Δ|/max|traj| "
        f"{rel:.3e} (tol {SEL_REF_TOL:g}), {secs['reference (child)']:.1f} s")
    stats["ground_truth"]["cpu_float64_rel"] = rel
    check(ref["status"].tolist() == gt.result.status[:2].tolist(),
          "selection: ground-truth status differs from the CPU float64 solve")
    check(rel <= SEL_REF_TOL, f"selection: ground truth differs from the CPU by {rel:.3e}")

    h = done["heuristics"]
    secs["evaluate_heuristics (child)"] = h["seconds"]
    secs["serial (child)"] = h["serial_seconds"]
    launches["evaluate_heuristics"] = stage_launches("evaluate (heuristic modes)", h["counts"],
                                                     h["routes"], SEL_EVAL, n, m)
    metrics.update(selection_eval_results(work / "heuristics", SEL_HEURISTIC_MODES,
                                          SEL_HEURISTIC_STEPS, results))
    statuses = [st for r in results.values() for st in r["Statuses"]]
    eval_success = statuses.count(SOLVED) / len(statuses)
    heuristic_steps = SEL_HEURISTIC_STEPS * sum(map(len, SEL_HEURISTIC_MODES.values()))
    stats["evaluate"].update(success=eval_success, metrics=metrics,
                             heuristic_sim_steps=heuristic_steps,
                             heuristic_seconds_per_sim_step=h["seconds"] / heuristic_steps)
    log(f"  evaluate_modes, heuristic modes (child process): {heuristic_steps} batched sim "
        f"steps of {SEL_EVAL}, {h['seconds']:.1f} s; all {len(results)} files: success "
        f"{eval_success:.4f}, metrics {json.dumps(metrics)}")
    check(eval_success >= SEL_MIN_EVAL_SUCCESS,
          f"selection: evaluation success {eval_success} < {SEL_MIN_EVAL_SUCCESS}")

    serial = json.loads((work / "heuristics" / "serial.json").read_text())
    batched = results[("All", 1, 0)]
    dev = float(max(np.abs(np.asarray(serial[f"Player {i + 1} {k}"])
                           - np.asarray(batched[f"Player {i + 1} {k}"])).max()
                    for i in range(SEL_N) for k in ("Trajectory", "Control")))
    stats["serial_vs_batched_max_abs"] = dev
    log(f"  serial vs batched rollout of held-out scenario 0 (All, child process): statuses "
        f"{serial['Statuses']} vs {batched['Statuses']}, max|Δ| {dev:.3e} (tol "
        f"{SEL_SERIAL_TOL:g}), {h['serial_seconds']:.1f} s")
    check(serial["Statuses"] == batched["Statuses"]
          and serial["Player 1 Mask"] == batched["Player 1 Mask"],
          "selection: serial and batched rollouts differ in status or mask")
    check(dev <= SEL_SERIAL_TOL, f"selection: serial and batched states differ by {dev:.3e}")

    rs = done["real"]
    secs["real_data (child)"] = rs["seconds"]
    launches["real_data"] = stage_launches("real data", rs["counts"], rs["routes"], 1, n, m)
    res = json.loads((work / "real" / "trajectories_[0]_[All]_[1].json").read_text())
    real_success = res["Statuses"].count(SOLVED) / len(res["Statuses"])
    stats["real_data"] = {"sim_steps": rs["sim_steps"], "success": real_success,
                          "metrics": analyze_result(res, num_players=SEL_N)}
    log(f"  real data (scenario1.csv, {rs['sim_steps']} steps, child process): success "
        f"{real_success:.4f}, {rs['seconds']:.1f} s")
    check(len(res["Player 1 Trajectory"]) == rs["sim_steps"] + 1
          and real_success >= SEL_MIN_REAL_SUCCESS, "selection: real-data rollout")

    secs["cli (child)"] = {}
    for name, *_ in SEL_CLI:
        r = cli.get(name)
        check(r is not None, f"selection: the CLI {name} did not run")
        secs["cli (child)"][name] = r["seconds"]
        log(f"  python -m mcp_tpu_torch.scripts.{name}: rc {r['rc']} in {r['seconds']:.1f} s; "
            f"{r['last']}")
        check(r["rc"] == 0, f"selection: {name} failed: {r['stderr']}")
    d = work / "cli"
    check(any((d / "data" / "train").iterdir()) and (d / "run" / "losses.json").exists()
          and (d / "run" / "best_model.pkl").exists()
          and json.loads((d / "eval" / "metrics.json").read_text()),
          "selection: the CLIs wrote no data, checkpoint, losses or metrics")

    stats.update(seconds=secs, launches=launches)
    return stats


def _selection_stages(runner, work, device, secs, launches, stats):
    """The in-process stages of ``phase_selection``, filling ``secs``,
    ``launches`` and ``stats``. Returns the ground truth's BatchSolution,
    the NN mode's evaluation results by (mode, param, sid) and their
    metrics."""
    from mcp_tpu_torch import SOLVED
    from mcp_tpu_torch.bench.harness import true_kkt_errors
    from mcp_tpu_torch.selection import (
        TrainConfig, evaluate_modes, generate_ground_truth, load_checkpoint, mask_computation,
        solve_subgames, train)
    from mcp_tpu_torch.selection.evaluate import model_callable

    mcp = runner.parametric_game.mcp
    n, m = mcp.unconstrained_dimension, mcp.constrained_dimension

    t0 = time.perf_counter()
    scenarios = selection_scenarios()
    secs["scenarios"] = time.perf_counter() - t0
    pos = np.stack([s.initial_states[:, :2] for s in scenarios])
    gls = np.stack([s.goals for s in scenarios])
    sep = min(float((np.linalg.norm(p[:, :, None] - p[:, None], axis=-1)
                     + 1e9 * np.eye(SEL_N)).min()) for p in (pos, gls))
    log(f"  scenarios: {len(scenarios)} of {SEL_N} players, least separation {sep:.4f}")
    check(len(scenarios) == SEL_SCENARIOS and pos.shape == (SEL_SCENARIOS, SEL_N, 2)
          and all(s.initial_states.shape == (SEL_N, 4) for s in scenarios) and sep >= 1.0
          and float(np.abs(pos).max()) <= 4.0, "selection: scenarios malformed")

    stage_start(secs, "ground_truth")
    with record_solves(runner) as calls:
        examples = generate_ground_truth(runner, scenarios[:SEL_GT], str(work / "gt"),
                                         batch_size=SEL_GT)
    counts, routes = stage_end(secs, "ground_truth")
    launches["ground_truth"] = stage_launches("ground truth", counts, routes, SEL_GT, n, m)
    check(len(calls) == 1, f"selection: ground truth took {len(calls)} solves, not one chunk")
    theta, gt = calls[0]
    tk = true_kkt_errors(mcp, gt.result, theta)
    solved = gt.result.status == SOLVED
    tk_max = float(tk[solved].max()) if bool(solved.any()) else float("nan")
    lanes = np.flatnonzero(solved.cpu().numpy())
    stats["ground_truth"] = {"solved": len(examples), "of": SEL_GT,
                             "outer_iters": gt.result.outer_iters.tolist(),
                             "true_kkt_max_solved": tk_max}
    log(f"  ground truth: {len(examples)} of {SEL_GT} SOLVED, iterations "
        f"{gt.result.outer_iters.tolist()}, max true KKT of a SOLVED lane {tk_max:.3e} "
        f"({secs['ground_truth']:.1f} s)")
    check(len(examples) >= SEL_MIN_GT, f"selection: {len(examples)} SOLVED < {SEL_MIN_GT}")
    check(not bool((solved & (tk > runner.options.tol)).any()),
          "selection: a SOLVED ground-truth lane has true KKT above tol")
    check(sorted(p.name for p in (work / "gt").iterdir())
          == sorted(f"simulation_results_{i}.json" for i in lanes),
          "selection: the ground-truth files are not the SOLVED lanes")
    trajs = gt.trajectories.cpu().numpy()
    check(all(np.array_equal(ex.trajectories, trajs[i]) for ex, i in zip(examples, lanes)),
          "selection: a written example is not its lane's plan")

    config = TrainConfig(num_players=SEL_N, horizon=SEL_T, **SEL_TRAIN_CONFIG)
    train_ex, val_ex = examples[:SEL_TRAIN], examples[SEL_TRAIN:]
    stage_start(secs, "train")
    with ift_watch() as ift:
        _, history = train(runner, train_ex, val_ex, config=config,
                           log_dir=str(work / "run"), verbose=False)
    counts, routes = stage_end(secs, "train")
    launches["train"] = stage_launches("train", counts, routes, config.batch_size, n, m, ift)
    steps = len(history["train_loss"]) * -(-len(train_ex) // config.batch_size)
    stats["train"] = {"history": history, "steps": steps,
                      "seconds_per_step": secs["train"] / steps}
    log(f"  train(): {len(train_ex)} examples, {len(val_ex)} validation, history {history}, "
        f"{secs['train']:.1f} s ({steps} steps and {len(history['val_loss'])} validations)")
    check(all(math.isfinite(v) for vs in history.values() for v in vs)
          and len(history["train_loss"]) >= 1, "selection: non-finite training history")
    for name in ("best_model.pkl", "trained_model.pkl", "losses.json"):
        check((work / "run" / name).exists(), f"selection: train() wrote no {name}")

    held_out = scenarios[SEL_SCENARIOS - SEL_EVAL:]
    best, payload = load_checkpoint(str(work / "run" / "best_model.pkl"), device=device)
    check(payload["config"]["num_players"] == SEL_N, "selection: checkpoint config")
    nn_modes = {SEL_NN_MODE[0]: [SEL_NN_MODE[1]]}
    stage_start(secs, "evaluate_nn")
    evaluate_modes(runner, held_out, nn_modes, str(work / "eval"),
                   num_sim_steps=SEL_SIM_STEPS, model=best, verbose=False)
    counts, routes = stage_end(secs, "evaluate_nn")
    launches["evaluate_nn"] = stage_launches("evaluate (NN mode)", counts, routes, SEL_EVAL,
                                             n, m)
    results = {}
    metrics = selection_eval_results(work / "eval", nn_modes, SEL_SIM_STEPS, results)
    stats["evaluate"] = {"nn_sim_steps": SEL_SIM_STEPS,
                         "nn_seconds_per_sim_step": secs["evaluate_nn"] / SEL_SIM_STEPS}
    log(f"  evaluate_modes, NN mode: {SEL_SIM_STEPS} batched sim steps of {SEL_EVAL}, "
        f"{secs['evaluate_nn']:.1f} s")

    # The NN mode after its bootstrap: each mask is the model's own top pick
    # on the recorded history, and some differ from the bootstrap heuristic's.
    scorer = model_callable(best)
    differ = 0
    for sid in range(SEL_EVAL):
        r = results[(*SEL_NN_MODE, sid)]
        hist = np.asarray([r[f"Player {i + 1} Trajectory"] for i in range(SEL_N)])
        for step in range(11, SEL_SIM_STEPS + 1):
            window = hist[:, step - config.input_horizon : step]
            traj = [window[i].reshape(-1) for i in range(SEL_N)]
            inp = np.concatenate([window[i, :, :2].reshape(-1) for i in range(SEL_N)])
            mine = mask_computation(inp, traj, [], SEL_NN_MODE[0], step, SEL_NN_MODE[1],
                                    model=scorer)
            boot = mask_computation(None, traj, [], "Nearest Neighbor", step, SEL_NN_MODE[1])
            check(r["Player 1 Mask"][step - 1] == [1.0, *mine.tolist()],
                  f"selection: NN mask of scenario {sid} at step {step} is not the model's")
            differ += int(not np.array_equal(mine, boot))
    stats["evaluate"]["nn_masks_off_bootstrap"] = differ
    log(f"  NN mode: {differ} of {SEL_EVAL * (SEL_SIM_STEPS - 10)} masks after step 10 "
        "differ from the bootstrap heuristic's")
    check(differ > 0, "selection: the NN mode never left its bootstrap heuristic")

    s0 = held_out[0]
    scale = np.array([0.75, 0.75, 1.0, 1.0])  # inside the default 7 m arena
    stage_start(secs, "subgame")
    sub = solve_subgames(s0.initial_states * scale, s0.goals * 0.75, np.array([1, 1, 0, 0]),
                         device=device, options=runner.options)
    counts, _ = stage_end(secs, "subgame")
    launches["subgame"] = {k: total(v) for k, v in counts.items()}
    log(f"  solve_subgames (horizon 3, 10 steps, mask [1, 1, 0, 0]): {secs['subgame']:.1f} s, "
        f"launches {launches['subgame']}")
    check(launches["subgame"]["thomas"] > 0 and launches["subgame"]["linesearch"] > 0,
          "selection: the subgames launched no K1 or no K2")
    for i in range(SEL_N):
        tr = np.asarray(sub[f"Player {i + 1} Trajectory"])
        check(tr.shape == (11, 4) and np.isfinite(tr).all()
              and np.asarray(sub[f"Player {i + 1} Control"]).shape == (10, 2)
              and np.allclose(tr[0], s0.initial_states[i] * scale, atol=1e-5),
              f"selection: subgame player {i + 1}")
    check(sub["Mask"] == [1, 1, 0, 0], "selection: subgame mask")
    return gt, results, metrics


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

    def phase(title):
        log(f"phase {title} [{time.perf_counter() - t_start:.0f} s]")

    log(f"card: {card}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    from mcp_tpu_torch.kernels import _build

    phase("1: build kernels")
    t0 = time.perf_counter()
    logs = _build.build()
    log(f"  built {sorted(logs) or 'nothing (cached)'} in {time.perf_counter() - t0:.2f} s")
    for name, text in logs.items():
        entry = ""
        for line in text.splitlines():
            if "Compiling entry function" in line:
                # The kernel and its template arguments, from the mangled name.
                m = re.search(r"\d([a-z_]+_kernel)I(\w+?)EEv", line)
                entry = f"{m.group(1)}<{m.group(2)}> " if m else ""
            elif "registers" in line or "spill" in line or "smem" in line:
                log(f"  [{name}] {entry}{line.strip()}")

    device = "cuda"
    phase("2: K1 (thomas) kernel vs plain")
    real_bands, k1_err = phase_k1(device)
    phase("3: K2 (linesearch) kernel vs plain")
    k2_err = phase_k2(device)
    phase("4: main path")
    mcp, options, stack, res, launches = phase_main_path(device)
    phase("5: reference check")
    phase_reference(options, stack, res)
    phase("6: K4a (gj), K5 (gji), K4b/K4c (gauss, QR) kernels vs plain")
    schur, dense_errs = phase_dense_kernels(device)
    phase("7: QP path")
    qp_mcp, qp_options, qp_stack, qp_res, gj_launches = phase_qp_path(device)
    phase("8: QP tiers schur_pallas (K4b/K4c) and schur_pallas_gjr (K5)")
    tier_launches = phase_qp_tiers(qp_mcp, qp_options, device)
    phase("9: QP reference check")
    phase_qp_reference(qp_options, qp_stack, qp_res)
    phase("10: kernel timing")
    kernels, k6_device, k8b_device = phase_timing(
        real_bands, k1_err, k2_err, launches, device, schur, dense_errs,
        {"gj_solve": gj_launches, **tier_launches})
    phase("11: profile of one main-path batch")
    main_profile = phase_profile(mcp, options, stack[0])
    device_time("linesearch_update", kernels, main_profile, K2_KERNEL)
    phase("12: profile of one QP batch")
    phase_profile(qp_mcp, qp_options, qp_stack[0])
    phase("13: K3 (cyclic reduction), and K2 at the flagship shapes, vs plain")
    n4, n10 = flagship(4), flagship(10)
    k3_bands, k3_errs = phase_k3(real_bands, n4, n10, device)
    flag_shapes = [(FLAG_B, s.mcp.unconstrained_dimension, s.mcp.constrained_dimension)
                   for s in (n4, n10)]
    check(tuple(flag_shapes) == K2_SHAPES[1:], f"K2: the flagships' shapes are {flag_shapes}")
    phase_k2(device, flag_shapes)
    phase("14: N=4 flagship path")
    n4_options, n4_stack, n4_res, n4_stats = phase_n4_path(n4)
    phase("15: N=10 flagship path")
    n10_options, _, n10_stats = phase_n10_path(n10)
    phase("16: N=4 reference check")
    phase_n4_reference(n4, n4_options, n4_stack, n4_res)
    phase("17: K3 timing")
    kernels += phase_k3_timing(k3_bands, k3_errs, n4_stats["launches"]["cr"]["gjp"],
                               n10_stats["launches"]["cr"]["gjpr"])
    phase("18: profile of one N=4 flagship batch")
    phase_profile(n4.mcp, n4_options, n4_stack[0], x0=n4.x0)
    phase(f"19: profile of the N=10 flagship batch's first {N10_PROFILE_INNER} Newton steps")
    phase_profile(n10.mcp, dataclasses.replace(n10_options, max_outer_iters=N10_PROFILE_OUTER,
                                               max_inner_iters=N10_PROFILE_INNER),
                  n10.thetas, x0=n10.x0)
    phase("20: K7a (two-way sweep), and K1 on the padded route, vs plain")
    k7a_bands, k7a_err, lane20 = phase_k7a(n4, device)
    phase(f"21: training path (N=4, horizon 30, batch {TRAIN_B}, tridiag_pallas)")
    train, ift_bands, train_launches, _ = phase_train_path(device)
    route_check("babe", "qr", "IFT transposed bands at a training-step solution (8x30x40)",
                ift_bands)
    phase(f"22: gradient checks ({GRAD_B} lanes)")
    ift64_bands, _ = phase_train_gradients(device)
    route_check("babe", "qr", "IFT transposed bands at a float64 training-step solution "
                "(2x30x40)", ift64_bands)
    phase("23: K7a timing (the plan's route against the block route)")
    kernels.append(phase_k7a_timing(k7a_bands, k7a_err, train_launches))
    phase("24: profile of one train step")
    device_time("babe_thomas_solve", kernels, phase_train_profile(train), K7A_GROUP_KERNEL)
    phase("25: the Gauss–Jordan facts of K1', K7a and K3 vs plain")
    fact_bands, fact_errs = phase_fact_kernels(n4, n10, device)
    phase_k7a_facts(lane20, ift_bands, ift64_bands, fact_bands, device)
    phase(f"26: path A, lane-change headline on tridiag_pallas_gjpr ({B * K_BATCHES} instances)")
    _, _, _, _, a_launches = phase_main_path(device, tier="tridiag_pallas_gjpr", fact="gjpr",
                                             name="path A", fused_linesearch=True)
    phase(f"27: path B, one lane-change batch of {B} on each fact tier")
    fact_launches = {("thomas", "gjpr"): a_launches["thomas"]["gjpr"], **phase_path_b(device)}
    phase(f"28: path C, one N=4 flagship batch of {FLAG_B} on each fact tier")
    fact_launches.update(phase_path_c(n4))
    phase("29: fact timing and the N=10 A/B")
    kernels += phase_fact_timing(fact_bands, fact_errs, fact_launches, device)
    phase("30: K6 (multi-right-hand-side sweep) vs plain")
    k6_args, k6_err = phase_k6(real_bands, n4, device)
    phase("30b: bench_cuda.py suites and the receding-horizon demo")
    bench_launches = phase_bench(device)
    quick = start_quick_bench()
    try:
        bench_launches["receding-horizon demo"] = phase_demo(device)
    except BaseException:
        quick[0].kill()
        quick[0].wait()
        raise
    finish_quick_bench(quick)
    phase(f"30c: the QP suite (B={B}) on tier gmres (ip with K2, mehrotra) beside "
          "schur_pallas_gj, and at each matmul_precision")
    option_launches = phase_solver_options(device)
    phase(f"31: horizon-sharded lane change on 2 ranks (dp=1 x horizon=2, B={HZ_B}), the "
          "SPIKE gradient, batch sharding, the tensor-parallel Newton backend and routing")
    from mcp_tpu_torch.kernels.thomas_multi import multi_plan

    _, _, k6_b, k6_k = k6_args[3].shape
    k6_launches, rank_launches = phase_horizon_paths(
        device, rank_dir("horizon2"), multi_plan(k6_b, k6_k, torch.float32).route)
    phase("32: T=64 lane change, one instance, on 4 ranks (float64)")
    phase_long_horizon(device, rank_dir("horizon4"))
    phase("33: one-instance solves on schur_pallas (K8a)")
    k8a_launches, k8a_system, k8a_err = phase_single(device, schur)
    phase("34: K8b (compact WY) beside K4b on the QP Schur systems")
    k8b_launches, k8b_err = phase_wy(schur)
    phase("35: K6, K8a, K8b timing")
    kernels += phase_new_timing((k6_args, k6_err, k6_launches, k6_device),
                                (k8a_system, k8a_err, k8a_launches),
                                (schur, k8b_err, k8b_launches, k8b_device))
    phase(f"36: the player-selection pipeline (N={SEL_N}, horizon {SEL_T}, tridiag_pallas)")
    selection = phase_selection(device)
    log("  selection pipeline: " + json.dumps(selection))
    for entry in kernels:
        # What each stage of the selection pipeline launched of K7a and K2.
        key = {"babe_thomas_solve": "babe", "linesearch_update": "linesearch"}.get(entry["name"])
        if key:
            entry["selection_launches"] = {st: c[key] for st, c in selection["launches"].items()
                                           if key in c}
    for entry in kernels:
        # What the solver-option runs (phase 30c) and the tp and routed
        # ranks (phase 31) launched of K1, K2 and K4a.
        runs = solver_option_launches(entry["name"], option_launches, rank_launches)
        if runs:
            entry["solver_option_launches"] = runs
    for entry in kernels:
        # What the bench suites and the demo (phase 30b) launched of it.
        runs = {label: c[entry["name"]] for label, c in bench_launches.items()
                if c.get(entry["name"])}
        if runs:
            entry["bench_launches"] = runs
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
