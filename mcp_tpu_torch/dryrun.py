"""Compile-check entry points of the port (the JAX package's
``__graft_entry__.py``).

* ``entry(device)`` returns (fn, args): the batched interior-point solve of
  the lane-change game (horizon 10, batch 8, float32) on tier
  "tridiag_auto"; ``fn(*args)`` is one ``SolveResult``.
* ``dryrun_multichip(n_devices, device=...)`` runs every parallel axis of
  the port at tiny shapes on ``n_devices`` ranks spawned over
  ``torch.distributed`` (``bench/horizon.py``'s worker; gloo, whether the
  ranks share one card or run on the CPU), each held against the same work
  on one rank:

  1. dp: one solver-in-the-loop training step (``selection/dp.py``: MLP →
     masked-game solves → the IFT gradient → SGD) with the batch sharded,
     one instance per rank, the gradients averaged by an all-reduce;
  2. sp: one interior-point solve with every Newton factorization
     horizon-sharded (SPIKE) over the ranks;
  3. dp×sp: a batch of games on a 2-D (dp, horizon) mesh (even n ≥ 4);
  4. tp: one solve whose condensed Newton factorization is
     block-column-sharded (``parallel/tensor.py``);
  5. ep: two shape buckets routed to disjoint groups of ranks
     (``parallel/routing.py``).

    python -m mcp_tpu_torch.dryrun --ranks 2 [--cpu]
"""

from __future__ import annotations

import argparse
import functools
import tempfile

import numpy as np
import torch

from ._device import resolve_device
from .bench.qp import DRYRUN_QP_N, dryrun_qp
from .solver import SolverOptions

# The dp step (``selection/dp.py``) against one rank: the loss and every new
# weight within DP_TOL.
DP_TOL = 1e-4
# sp, dp×sp, tp and ep: two outer and two inner iterations; parity 1e-4.
SHORT = dict(max_outer_iters=2, max_inner_iters=2)
SP_OPTIONS = dict(SHORT, linear_solver="tridiag")
PARITY_TOL = 1e-4
# The tp and ep QP is ``bench.qp.dryrun_qp`` (+ 0.1 x for the second
# bucket); tp factors it in panels of TP_PANEL columns.
TP_PANEL = 4


def entry(device="cuda"):
    """(fn, args): ``fn(thetas, x0, y0, s0)`` solves the lane-change batch
    (horizon 10, θ of 8 instances from seed 0, float32, cold start x = 0,
    y = s = 1) on tier "tridiag_auto", differentiable in θ."""
    from .bench import lane_change as lc
    from .diff import _solve

    device = resolve_device(device)
    bench = lc.generate_test_problem(horizon=10, device=device)
    mcp = bench.parametric_game.mcp
    batch = 8
    thetas = lc.generate_parameter_batch(torch.Generator().manual_seed(0), batch, bench,
                                         dtype=torch.float32, device=device)
    n, m = mcp.unconstrained_dimension, mcp.constrained_dimension
    x0 = torch.zeros((batch, n), dtype=torch.float32, device=device)
    y0 = torch.ones((batch, m), dtype=torch.float32, device=device)
    s0 = torch.ones((batch, m), dtype=torch.float32, device=device)
    return functools.partial(_solve, mcp, SolverOptions(linear_solver="tridiag_auto")), (
        thetas, x0, y0, s0)


# -- dp (the training step is ``selection/dp.py``) ------------------------------


def check_dp(result: dict, n_devices: int) -> str:
    """The dp step against one rank: a finite loss, and max|Δ| of the loss
    and of every new parameter within DP_TOL."""
    if not np.isfinite(result["loss"]):
        raise AssertionError(f"non-finite training loss: {result['loss']}")
    diff = max([abs(result["loss"] - result["ref_loss"])]
               + [float(np.abs(a - b).max()) for a, b in zip(result["params"],
                                                             result["ref_params"])])
    if not diff <= DP_TOL:
        raise AssertionError(f"dp parity vs one rank: max|Δ|={diff}")
    return (f"dryrun_multichip({n_devices}): dp training step loss={result['loss']:.4f} "
            f"on {n_devices} ranks, parity max|Δ|={diff:.2e} — OK")


# -- sp, dp×sp, tp, ep ---------------------------------------------------------


def _lane(horizon: int, device):
    from .bench import lane_change as lc

    return lc.generate_test_problem(horizon=horizon, device=device)


def _lane_thetas(horizon: int, batch: int, seed: int, device) -> torch.Tensor:
    from .bench import lane_change as lc

    return lc.generate_parameter_batch(torch.Generator().manual_seed(seed), batch,
                                       _lane(horizon, device), dtype=torch.float32,
                                       device=device)


def _has_dp_sp(n_devices: int) -> bool:
    return n_devices >= 4 and n_devices % 2 == 0


def dryrun_tasks(n_devices: int, device="cuda") -> list[dict]:
    """The rank tasks of every axis (``bench/horizon.py``'s kinds), named
    "dryrun_<axis>"."""
    from .selection.dp import dp_inputs

    device = resolve_device(device)
    sp_T = 2 * n_devices  # two blocks per rank, the least SPIKE slab
    tasks = [
        dict(kind="dp_train", name="dryrun_dp", **dp_inputs(n_devices)),
        dict(kind="solve", name="dryrun_sp", horizon=sp_T, options=SP_OPTIONS,
             theta=_lane_thetas(sp_T, 1, 2, device)[0].cpu().numpy()),
    ]
    if _has_dp_sp(n_devices):
        tasks.append(dict(kind="batch", name="dryrun_dpxsp", horizon=4, options=SP_OPTIONS,
                          dp=n_devices // 2, hz=2,
                          thetas=_lane_thetas(4, n_devices // 2, 3, device).cpu().numpy()))
    tasks += [
        dict(kind="tp", name="dryrun_tp", problem=dict(kind="dryrun_qp"),
             theta=np.zeros(DRYRUN_QP_N, np.float32), options=SHORT, panel=TP_PANEL),
        dict(kind="routed", name="dryrun_ep", buckets=[
            dict(problem=dict(kind="dryrun_qp"), thetas=np.zeros((3, DRYRUN_QP_N), np.float32),
                 options=SHORT),  # an odd batch: padded
            dict(problem=dict(kind="dryrun_qp", shift=0.1),
                 thetas=np.zeros((n_devices, DRYRUN_QP_N), np.float32), options=SHORT)]),
    ]
    return tasks


def _max_dx(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - b.detach().cpu().numpy())))


def check_axis(axis: str, result: dict, task: dict, n_devices: int, device="cuda") -> str:
    """Hold one axis's rank result (``task`` its task) against the same work
    on one rank in this process, as the JAX package's dry run does; raises
    AssertionError on a failure, returns the line to print."""
    from . import solve, solve_batch

    device = resolve_device(device)
    head = f"dryrun_multichip({n_devices}): "
    if axis == "dp":
        return check_dp(result, n_devices)
    if axis == "sp":
        mcp = _lane(task["horizon"], device).parametric_game.mcp
        theta = torch.as_tensor(task["theta"], device=device)
        if not np.isfinite(result["x"]).all():
            raise AssertionError("sp solve produced non-finite x")
        ref = solve(mcp, theta, options=SolverOptions(**SP_OPTIONS))
        # A truncated float32 IP orbit amplifies any reassociation of the
        # linear solve: the floor is the gap between two unsharded tiers
        # that differ only in elimination order (thomas against CR).
        alt = solve(mcp, theta, options=SolverOptions(**dict(SP_OPTIONS,
                                                           linear_solver="tridiag_cr")))
        diff, floor = _max_dx(result["x"], ref.x), float((alt.x - ref.x).abs().max())
        if not diff <= max(PARITY_TOL, 2.0 * floor):
            raise AssertionError(f"sp parity vs one rank: max|Δx|={diff} exceeds both "
                                 f"{PARITY_TOL} and 2x the unsharded floor {floor:.2e}")
        return (head + f"horizon-sharded (sp) IP solve T={task['horizon']} on {n_devices} "
                f"ranks, parity max|Δx|={diff:.2e} (unsharded thomas-vs-cr floor "
                f"{floor:.2e}) — OK")
    if axis == "dpxsp":
        mcp = _lane(task["horizon"], device).parametric_game.mcp
        ref = solve_batch(mcp, torch.as_tensor(task["thetas"], device=device),
                          options=SolverOptions(**SP_OPTIONS))
        diff = _max_dx(result["x"], ref.x)
        if not (np.isfinite(result["x"]).all() and diff <= PARITY_TOL):
            raise AssertionError(f"dp×sp parity: max|Δx|={diff}")
        return (head + f"dp×horizon solve batch={task['dp']} T={task['horizon']} on mesh "
                f"({task['dp']}, {task['hz']}), parity max|Δx|={diff:.2e} — OK")
    if axis == "tp":
        ref = solve(dryrun_qp(), torch.as_tensor(task["theta"], device=device),
                    options=SolverOptions(**SHORT, linear_solver="condensed"))
        diff = _max_dx(result["x"], ref.x)
        if not (np.isfinite(result["x"]).all() and diff <= PARITY_TOL):
            raise AssertionError(f"tp parity vs one rank: max|Δx|={diff}")
        return (head + f"tensor-parallel (tp) condensed factorization on {n_devices} ranks, "
                f"parity max|Δx|={diff:.2e} — OK")
    if axis == "ep":
        diffs = []
        for got, bucket in zip(result["results"], task["buckets"]):
            ref = solve_batch(dryrun_qp(bucket["problem"].get("shift", 0.0)),
                              torch.as_tensor(bucket["thetas"], device=device),
                              options=SolverOptions(**bucket["options"]))
            if got["x"].shape[0] != bucket["thetas"].shape[0] or not np.isfinite(got["x"]).all():
                raise AssertionError("ep: a bucket's batch is not its own or not finite")
            diffs.append(_max_dx(got["x"], ref.x))
        if not max(diffs) <= PARITY_TOL:
            raise AssertionError(f"ep parity vs the unsharded batch: max|Δx|={max(diffs)}")
        return (head + f"heterogeneous routing (ep) over 2 groups of ranks, parity "
                f"max|Δx|={max(diffs):.2e} — OK")
    raise ValueError(f"unknown axis {axis!r}")


def dryrun_multichip(n_devices: int, *, device="cuda") -> list[str]:
    """Spawn ``n_devices`` ranks (gloo; on one card they share it), run every
    axis's task on them and hold each against one rank (``check_axis``).
    The tiers of the tasks ("schur", "tridiag", "condensed") launch no
    hand-written kernel, so no rank builds one.
    Prints and returns one line per axis; raises AssertionError on a
    failure. A script that calls it needs an ``if __name__ == "__main__":``
    guard (the ranks re-import the main module)."""
    from .bench import horizon as worker

    device = resolve_device(device)
    tasks = dryrun_tasks(n_devices, device)
    if not _has_dp_sp(n_devices):
        print(f"dryrun_multichip({n_devices}): dp×horizon needs even n_devices ≥ 4 — skipped")
    lines = []
    with tempfile.TemporaryDirectory() as out_dir:
        ranks = worker.spawn(n_devices, tasks, out_dir, device=str(device))
    for task in tasks:
        axis = task["name"].removeprefix("dryrun_")
        lines.append(check_axis(axis, ranks[0][task["name"]], task, n_devices, device))
        print(lines[-1])
    return lines


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ranks", type=int, default=2)
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    fn, fn_args = entry(device)
    res = fn(*fn_args)
    print(f"entry(): lane-change batch of {res.status.shape[0]} on tridiag_auto, status "
          f"{res.status.tolist()}, outer iterations {res.outer_iters.tolist()}")
    dryrun_multichip(args.ranks, device=device)


if __name__ == "__main__":
    main()
