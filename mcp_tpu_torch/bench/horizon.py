"""Rank worker of the horizon-sharded, batch-sharded, tensor-parallel and
routed solves.

``spawn(world, tasks, out_dir)`` (or ``start``, which returns before the
ranks end) starts ``world`` ranks with
``torch.multiprocessing.spawn`` (the start method a card needs), joins them
in one process group over a file rendezvous in ``out_dir`` and runs the same
list of tasks on every rank; each rank saves its results, numpy arrays and
the kernel launch counts of each task's window (K6's also per route), and
``spawn`` returns them in rank order. A task is a dict: ``kind`` (a key of ``TASKS``), ``name`` and
the keyword arguments of that kind. The lane-change problem is built in each
rank (``bench/lane_change.py``); the tensor-parallel and routed tasks take a
problem spec (``_build``: the lane change or the QP suite's MCP at given
sizes); θ and warm starts come as numpy arrays.

Ranks that share one card all compute on it and exchange over gloo. Kernel
libraries are looked up by content hash (``kernels/_build.py``): build them
in the parent first, so that no rank compiles.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import time
from pathlib import Path

import numpy as np
import torch

from .. import SolverOptions
from ..kernels.cyclic_reduction import cr_thomas_solve
from ..kernels.linear_solve import gj_solve
from ..kernels.linesearch import linesearch_update
from ..kernels.thomas import thomas_solve
from ..kernels.thomas_babe import babe_thomas_solve
from ..kernels.thomas_multi import thomas_solve_multi

#: The kernel wrappers whose launches a task reports, by short name.
WRAPPERS = {"multi": thomas_solve_multi, "thomas": thomas_solve, "babe": babe_thomas_solve,
            "cr": cr_thomas_solve, "linesearch": linesearch_update, "gj": gj_solve}


def _reset():
    for w in WRAPPERS.values():
        w.launches = dict.fromkeys(w.launches, 0) if isinstance(w.launches, dict) else 0
        if hasattr(w, "route_launches"):
            w.route_launches = dict.fromkeys(w.route_launches, 0)


def _counts() -> dict:
    """Each wrapper's launches, and K6's per route under ``multi_routes``."""
    counts = {k: sum(w.launches.values()) if isinstance(w.launches, dict) else w.launches
              for k, w in WRAPPERS.items()}
    return {**counts, "multi_routes": dict(thomas_solve_multi.route_launches)}


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _problem(horizon: int, height: float, device):
    from . import lane_change as lc

    return lc.generate_test_problem(horizon=horizon, height=height, device=device)


def _build(problem: dict, device):
    """The MCP of a problem spec: ``{"kind": "lane_change", "horizon": T[,
    "height": h]}`` or ``{"kind": "qp", "num_primals": n,
    "num_inequalities": m}``; ``"assume_hy_zero": True`` marks H free of y
    (the condensed IFT's elimination)."""
    spec = dict(problem)
    kind, hy_zero = spec.pop("kind"), spec.pop("assume_hy_zero", False)
    if kind == "lane_change":
        mcp = _problem(spec["horizon"], spec.get("height", 50.0), device).parametric_game.mcp
    else:
        from . import qp

        mcp = qp.generate_test_problem(device=device, **spec).mcp
    return dataclasses.replace(mcp, assume_hy_zero=True) if hy_zero else mcp


def _numpy(res) -> dict:
    return {f: getattr(res, f).detach().cpu().numpy() for f in res._fields}


def _tensor(a, device, dtype):
    return None if a is None else torch.as_tensor(np.asarray(a), device=device, dtype=dtype)


def task_tridiag(*, diag, lower, upper, rhs, device):
    """``horizon_sharded_tridiag_solve`` of the given system over every rank."""
    from ..parallel.horizon import horizon_sharded_tridiag_solve, make_horizon_mesh

    mesh = make_horizon_mesh(device=device)
    args = [torch.as_tensor(np.asarray(a), device=mesh.device) for a in (diag, lower, upper, rhs)]
    return {"x": horizon_sharded_tridiag_solve(*args, mesh=mesh).cpu().numpy()}


def task_solve(*, theta, options, horizon, height=50.0, x0=None, device):
    """``solve_horizon_sharded`` of the lane change (θ (p,) or (B, p))."""
    from ..parallel.horizon import make_horizon_mesh, solve_horizon_sharded

    mesh = make_horizon_mesh(device=device)
    mcp = _problem(horizon, height, mesh.device).parametric_game.mcp
    theta = np.asarray(theta)
    th = _tensor(theta, mesh.device, torch.from_numpy(theta).dtype)
    _sync(device)
    _reset()
    t0 = time.perf_counter()
    res = solve_horizon_sharded(mcp, th, mesh=mesh, x0=_tensor(x0, mesh.device, th.dtype),
                                options=SolverOptions(**options))
    _sync(device)
    return {**_numpy(res), "seconds": time.perf_counter() - t0, "launches": _counts()}


def task_batch(*, thetas, options, horizon, dp, hz, height=50.0, warm=0, device):
    """``solve_batch_horizon_sharded`` of the lane change on a (dp, hz) mesh,
    after ``warm`` lanes solved once untimed; the window is the timed batch.
    Beside the launch counts, K2's per route (``linesearch_routes``)."""
    from ..parallel.horizon import make_dp_horizon_mesh, solve_batch_horizon_sharded

    mesh = make_dp_horizon_mesh(dp, hz, device=device)
    mcp = _problem(horizon, height, mesh.device).parametric_game.mcp
    thetas = np.asarray(thetas)
    th = _tensor(thetas, mesh.device, torch.from_numpy(thetas).dtype)
    opts = SolverOptions(**options)
    if warm:
        solve_batch_horizon_sharded(mcp, th[:warm], mesh=mesh, options=opts)
    _sync(device)
    _reset()
    t0 = time.perf_counter()
    res = solve_batch_horizon_sharded(mcp, th, mesh=mesh, options=opts)
    _sync(device)
    return {**_numpy(res), "seconds": time.perf_counter() - t0, "launches": _counts(),
            "linesearch_routes": dict(linesearch_update.route_launches)}


def task_grad(*, thetas, options, horizon, height=50.0, device):
    """The gradient of Σx² of ``horizon_sharded_solve_fn`` at θ (B, p), and
    the kernel launches of the backward pass alone."""
    from ..parallel.horizon import horizon_sharded_solve_fn, make_horizon_mesh
    from ..solver import default_initialization

    mesh = make_horizon_mesh(device=device)
    mcp = _problem(horizon, height, mesh.device).parametric_game.mcp
    thetas = np.asarray(thetas)
    th = _tensor(thetas, mesh.device, torch.from_numpy(thetas).dtype).requires_grad_()
    fn = horizon_sharded_solve_fn(mcp, mesh=mesh, options=SolverOptions(**options))
    _reset()
    res = fn(th, *default_initialization(mcp, th.detach()))
    forward = _counts()
    _reset()
    (g,) = torch.autograd.grad((res.x ** 2).sum(), th)
    _sync(device)
    return {**_numpy(res), "grad": g.cpu().numpy(), "launches": forward,
            "backward_launches": _counts()}


def task_batch_sharded(*, thetas, options, horizon, height=50.0, device):
    """``solve_batch_sharded`` of the lane change over every rank."""
    from ..parallel.mesh import make_batch_mesh, solve_batch_sharded

    mesh = make_batch_mesh(device=device)
    mcp = _problem(horizon, height, mesh.device).parametric_game.mcp
    thetas = np.asarray(thetas)
    th = _tensor(thetas, mesh.device, torch.from_numpy(thetas).dtype)
    res, n = solve_batch_sharded(mcp, th, mesh=mesh, options=SolverOptions(**options))
    return {**_numpy(res), "num_solved": int(n)}


def task_lu_tp(*, systems, panel, device):
    """``lu_solve_tp`` over every rank of each (A, b) of ``systems``."""
    from ..parallel.tensor import lu_solve_tp, make_tp_mesh

    mesh = make_tp_mesh(device=device)
    return {"x": [lu_solve_tp(torch.as_tensor(np.asarray(A)), torch.as_tensor(np.asarray(b)),
                              mesh=mesh, panel=panel).cpu().numpy() for A, b in systems]}


def task_tp(*, problem, theta, options, panel=64, grad=False, device):
    """``solve_single_tp`` of θ (p,) over every rank; with ``grad``, also
    the gradient of Σx² in θ (its IFT core solves on the ranks too). The
    window of the launch counts and ``seconds`` is the solve."""
    from ..parallel.tensor import make_tp_mesh, solve_single_tp

    mesh = make_tp_mesh(device=device)
    mcp = _build(problem, mesh.device)
    theta = np.asarray(theta)
    th = _tensor(theta, mesh.device, torch.from_numpy(theta).dtype).requires_grad_(grad)
    _sync(device)
    _reset()
    t0 = time.perf_counter()
    res = solve_single_tp(mcp, th, mesh=mesh, panel=panel, options=SolverOptions(**options))
    _sync(device)
    out = {**_numpy(res), "seconds": time.perf_counter() - t0, "launches": _counts()}
    if grad:
        (g,) = torch.autograd.grad((res.x ** 2).sum(), th)
        out["grad"] = g.cpu().numpy()
    return out


def task_routed(*, buckets, device):
    """``solve_routed`` of the buckets over every rank: each a dict of
    ``problem``, ``thetas``, ``options`` and optionally ``weight``. The
    window of the launch counts and ``seconds`` is the routed solve."""
    from ..parallel.routing import ShapeBucket, solve_routed

    shaped = []
    for b in buckets:
        thetas = np.asarray(b["thetas"])
        shaped.append(ShapeBucket(
            _build(b["problem"], device),
            _tensor(thetas, device, torch.from_numpy(thetas).dtype),
            options=SolverOptions(**b["options"]), weight=b.get("weight")))
    _sync(device)
    _reset()
    t0 = time.perf_counter()
    res = solve_routed(shaped, device=device)
    _sync(device)
    return {"results": [_numpy(r) for r in res], "seconds": time.perf_counter() - t0,
            "launches": _counts()}


TASKS = {"tridiag": task_tridiag, "solve": task_solve, "batch": task_batch,
         "grad": task_grad, "batch_sharded": task_batch_sharded, "lu_tp": task_lu_tp,
         "tp": task_tp, "routed": task_routed}


def run_rank(rank: int, world: int, out_dir: str, tasks: list, device: str, backend: str,
             threads: int, timeout_s: float):
    """One rank: join the group, run every task, save the results to
    ``out_dir/rank<rank>.pkl``. A rank that leaves a collective early makes
    the others fail at ``timeout_s`` instead of hanging."""
    import torch.distributed as dist

    from ..parallel.mesh import initialize_distributed

    torch.set_num_threads(threads)
    initialize_distributed(backend=backend, init_method=f"file://{out_dir}/rendezvous",
                           world_size=world, rank=rank,
                           timeout=datetime.timedelta(seconds=timeout_s))
    try:
        results = {}
        for task in tasks:
            kw = {k: v for k, v in task.items() if k not in ("kind", "name")}
            results[task["name"]] = TASKS[task["kind"]](**kw, device=device)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


def start(world: int, tasks: list, out_dir, *, device="cuda", backend="gloo", threads=1,
          timeout_s: float = 600.0):
    """Start ``tasks`` on ``world`` spawned ranks (see the module docstring)
    and return at once a callable that waits for them and returns each
    rank's {task name: results}, so the caller can work meanwhile.
    ``out_dir`` must be a fresh directory (it holds the rendezvous file)."""
    import torch.multiprocessing as mp

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    if (out_dir / "rendezvous").exists():
        raise ValueError(f"{out_dir} holds a rendezvous file of an earlier run")
    ctx = mp.start_processes(run_rank, args=(world, str(out_dir), tasks, str(device), backend,
                                             threads, timeout_s),
                             nprocs=world, join=False, start_method="spawn")

    def results() -> list[dict]:
        while not ctx.join():
            pass
        out = []
        for r in range(world):
            with open(out_dir / f"rank{r}.pkl", "rb") as f:
                out.append(pickle.load(f))
        return out

    return results


def spawn(world: int, tasks: list, out_dir, **kwargs) -> list[dict]:
    """Run ``tasks`` on ``world`` spawned ranks and wait for them: ``start``'s
    keywords; returns each rank's {task name: results}."""
    return start(world, tasks, out_dir, **kwargs)()
