"""Rounding surveys behind two of the port's cross-package tolerances, on
the CPU (not collected by pytest; run from the repository root).

  python tests/survey_rounding.py cr-lanes TIER FIRST LAST
      Per-lane float32 status and outer iterations of the lane change
      (T=10, batch 8, the θ draws PRNGKey(FIRST..LAST-1)) on a pivot-free
      blocked CR tier ("tridiag_pallas_crgjb", "tridiag_pallas_crgjbr") in
      both packages. Prefix XLA_FLAGS=--xla_cpu_max_isa=SSE4_2 to compile
      the JAX package without fused multiply-adds.

  python tests/survey_rounding.py t64
      The T=64 lane change (height 300, θ PRNGKey(2), the zero-input
      rollout warm start) in float64 at tol 1e-4: the port's 4-slab SPIKE
      under three 1-ulp perturbations of θ, then the max|Δx| between the
      JAX package's SPIKE on 2, 4 and 8 virtual devices, its "tridiag_cr",
      the port's SPIKE on 2, 4, 8 slabs (one process) and its
      "tridiag_cr", and the JAX package's true residual at its solutions.
"""

import functools
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_enable_x64", True)

from mcp_tpu.bench import lane_change as jlc  # noqa: E402
from mcp_tpu_torch import SolverOptions, solve_batch  # noqa: E402
from mcp_tpu_torch.bench import lane_change as tlc  # noqa: E402

HEADLINE = dict(tol=1e-4, algorithm="ip", polish=True, retry=0, refinement_steps=1,
                tightening_rate=0.02)


def cr_lanes(tier, first, last):
    from mcp_tpu.parallel.batch import solve_batch as jax_solve_batch
    from mcp_tpu.solver import SolverOptions as JaxOptions

    jb = jlc.generate_test_problem(horizon=10)
    tm = tlc.generate_test_problem(horizon=10, device="cpu").parametric_game.mcp
    solved = [0, 0]
    for seed in range(first, last):
        th = np.array(jlc.generate_parameter_batch(jax.random.PRNGKey(seed), 8, jb,
                                                   dtype=jnp.float32))
        want = jax_solve_batch(jb.parametric_game.mcp, jnp.asarray(th),
                               options=JaxOptions(linear_solver=tier, **HEADLINE))
        got = solve_batch(tm, torch.from_numpy(th),
                          options=SolverOptions(linear_solver=tier, **HEADLINE))
        ws, gs = np.asarray(want.status), got.status.numpy()
        solved[0] += int((ws == 0).sum())
        solved[1] += int((gs == 0).sum())
        print(f"PRNGKey({seed}) jax {ws.tolist()} {np.asarray(want.outer_iters).tolist()} "
              f"port {gs.tolist()} {got.outer_iters.tolist()} equal lanes "
              f"{int((ws == gs).sum())}/8", flush=True)
    print(f"SOLVED lanes: jax {solved[0]}, port {solved[1]} of {8 * (last - first)}")


def t64():
    from types import SimpleNamespace

    from mcp_tpu import solve as jax_solve
    from mcp_tpu.bench.harness import true_kkt_errors
    from mcp_tpu.parallel.horizon import make_horizon_mesh, solve_horizon_sharded
    from mcp_tpu.solver import SolverOptions as JaxOptions
    from mcp_tpu.trajectories.strategies import cold_start_primal
    from mcp_tpu_torch import solve
    from mcp_tpu_torch.diff import _solve_ts
    from mcp_tpu_torch.parallel import horizon as H
    from mcp_tpu_torch.solver import default_initialization

    jb = jlc.generate_test_problem(horizon=64, height=300.0)
    jm = jb.parametric_game.mcp
    tm = tlc.generate_test_problem(horizon=64, height=300.0, device="cpu").parametric_game.mcp
    th = jlc.generate_random_parameter(jax.random.PRNGKey(2), jb, height=300.0,
                                       dtype=jnp.float64)
    x0 = cold_start_primal(jb.game, jb.parametric_game, 64,
                           jnp.concatenate([th[0:4], th[5:9]]))
    opts = dict(linear_solver="tridiag", tol=1e-4)
    tth, tx0 = torch.from_numpy(np.array(th)), torch.from_numpy(np.array(x0))

    def spike(theta, D):
        r = _solve_ts(tm, SolverOptions(**opts), functools.partial(H.spike_solve, num_slabs=D),
                      None, theta[None], *default_initialization(tm, theta[None], tx0[None]))
        return SimpleNamespace(x=r.x[0], status=r.status[0], outer_iters=r.outer_iters[0])

    base = spike(tth, 4)
    rng = np.random.default_rng(0)
    for _ in range(3):
        sign = torch.from_numpy(rng.choice([-1.0, 1.0], size=tth.shape))
        p = spike(tth * (1 + 2.0 ** -52 * sign), 4)
        print(f"1-ulp θ: status {int(p.status)} in {int(p.outer_iters)}, max|Δx| "
              f"{float((p.x - base.x).abs().max()):.4f}")
    res = {}
    for D in (2, 4, 8):
        res[f"jax SPIKE D={D}"] = solve_horizon_sharded(
            jm, th, x0=x0, mesh=make_horizon_mesh(jax.devices()[:D]),
            options=JaxOptions(**opts))
    res["jax tridiag_cr"] = jax_solve(jm, th, x0=x0,
                                      options=JaxOptions(**dict(opts, linear_solver="tridiag_cr")))
    for D in (2, 4, 8):
        res[f"port SPIKE D={D}"] = spike(tth, D)
    res["port tridiag_cr"] = solve(tm, tth, x0=tx0, **dict(opts, linear_solver="tridiag_cr"))
    xs = {k: np.asarray(v.x) for k, v in res.items()}
    for k, v in res.items():
        line = f"{k:16s} status {int(v.status)} in {int(v.outer_iters)}; max|x| {np.abs(xs[k]).max():.1f}"
        if k.startswith("jax"):
            it = SimpleNamespace(x=v.x[None], y=v.y[None], s=v.s[None])
            line += f"; true KKT {float(true_kkt_errors(jm, it, th[None])[0]):.2e}"
        print(line)
    names = list(xs)
    print("max|Δx|: " + ", ".join(f"{i}={k}" for i, k in enumerate(names)))
    for i, k in enumerate(names):
        print(f"{i}: " + " ".join(f"{np.abs(xs[k] - xs[m]).max():.4f}" for m in names))


if __name__ == "__main__":
    torch.set_num_threads(4)
    if sys.argv[1] == "cr-lanes":
        cr_lanes(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
    elif sys.argv[1] == "t64":
        t64()
    else:
        raise SystemExit(__doc__)
