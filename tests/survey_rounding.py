"""Rounding surveys behind two of the port's cross-package tolerances,
behind the double-word QP row's uncertified lanes, and behind the dry run's
data-parallel check (not collected by pytest; run from the repository
root). All but dp-lanes run both packages on the CPU; dp-lanes runs the
port alone, without JAX, on the CPU or on the card.

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

  python tests/survey_rounding.py dw-lanes SEED...
      For each seed, a QP batch of 256 (the port's sampler, CPU generator)
      solved by the port in float32 with the --dw row's first stage
      (Mehrotra on "schur_pallas_gj", tol 1e-5, polish), then refined by
      both packages' polish_batch_dw (8 steps, tol 1e-6) from the same
      iterates: the SOLVED lanes each leaves above 1e-6, and the share of
      all lanes at 1e-6.

  python tests/survey_rounding.py gmres-qp SEED B
      The QP suite (n=m=100, sparsity 0.9; the JAX sampler, PRNGKey(SEED),
      B draws) on the gmres tier with the suite's options (Mehrotra,
      refinement 0, tol 1e-4, caps 25, polish) in float32 and float64, in
      both packages: per-lane status and outer iterations, and in float64
      the max|Δx| between them.

  python tests/survey_rounding.py dp-lanes B DTYPE [DEVICE]
      The dry run's data-parallel training step (``selection/dp.py``) on
      its batch of B lanes (``dp_inputs``) in DTYPE ("float32",
      "float64") on DEVICE ("cpu", the default, or "cuda"):
      ``dp_training_step`` on each lane alone, as each of B ranks does with
      its shard of one, and on the whole batch, as one rank does. Per lane:
      status and outer iterations alone and in the batch, max|Δx| between
      the two solutions and, below float64, max|Δx| of the lane in the
      batch against the same batch in float64 (its rounding floor). Then
      what the dp check compares: the mean over the B shards of the loss
      and of the new weights (the all-reduce averages the gradients before
      the update: the same up to one rounding) against the whole batch's,
      in DTYPE and, below float64, in float64.
"""

import functools
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mcp_tpu_torch import SolverOptions, solve_batch  # noqa: E402
from mcp_tpu_torch.bench import lane_change as tlc  # noqa: E402

HEADLINE = dict(tol=1e-4, algorithm="ip", polish=True, retry=0, refinement_steps=1,
                tightening_rate=0.02)


def _jax():
    """jax (float64 on), jax.numpy and the JAX package's lane-change bench,
    imported by the surveys that run the JAX package only."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_enable_x64", True)
    from mcp_tpu.bench import lane_change as jlc

    return jax, jnp, jlc


def cr_lanes(tier, first, last):
    jax, jnp, jlc = _jax()
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

    jax, jnp, jlc = _jax()

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


def dw_lanes(seeds):
    _, jnp, _ = _jax()
    from mcp_tpu.bench import qp_dw as jdw
    from mcp_tpu_torch.bench import qp, qp_dw

    problem = qp.generate_test_problem(device="cpu")
    opts = SolverOptions(tol=1e-5, linear_solver="schur_pallas_gj", algorithm="mehrotra",
                         polish=True, refinement_steps=0, max_outer_iters=25,
                         retry_max_outer_iters=8, retry_linear_solver="schur_pallas",
                         tightening_rate=0.1)
    for seed in seeds:
        th = qp.generate_parameter_batch(torch.Generator().manual_seed(seed), 256,
                                         device="cpu")
        res = solve_batch(problem.mcp, th, options=opts)
        solved = res.status.numpy() == 0
        _, tk = qp_dw.polish_batch_dw(th, res.x, res.y, res.s, n=100, m=100)
        _, jtk = jdw.polish_batch_dw(*(jnp.asarray(v.numpy()) for v in (th, res.x, res.y,
                                                                        res.s)), n=100, m=100)
        for name, k in (("port", tk.numpy()), ("jax", np.asarray(jtk))):
            print(f"seed {seed} {name}: {int(solved.sum())} SOLVED, above 1e-6 "
                  f"{np.flatnonzero(solved & (k > 1e-6)).tolist()}, at 1e-6 "
                  f"{float(np.mean(k <= 1e-6)):.4f}", flush=True)


def gmres_qp(seed, B):
    jax, jnp, _ = _jax()
    from mcp_tpu.bench import qp as jqp
    from mcp_tpu.parallel.batch import solve_batch as jax_solve_batch
    from mcp_tpu.solver import SolverOptions as JaxOptions
    from mcp_tpu_torch.bench import qp

    opts = dict(tol=1e-4, linear_solver="gmres", algorithm="mehrotra", refinement_steps=0,
                max_outer_iters=25, polish=True)
    jm = jqp.generate_test_problem().mcp
    tm = qp.generate_test_problem(device="cpu").mcp
    th64 = np.array(jqp.generate_parameter_batch(jax.random.PRNGKey(seed), B,
                                                 dtype=jnp.float64))
    for dtype in (np.float32, np.float64):
        th = th64.astype(dtype)
        want = jax_solve_batch(jm, jnp.asarray(th), options=JaxOptions(**opts))
        got = solve_batch(tm, torch.from_numpy(th), options=SolverOptions(**opts))
        print(f"{dtype.__name__}: jax status {np.asarray(want.status).tolist()} outer "
              f"{np.asarray(want.outer_iters).tolist()}; port status "
              f"{got.status.tolist()} outer {got.outer_iters.tolist()}", flush=True)
        if dtype is np.float64:
            print(f"  max|dx| {float(np.abs(got.x.numpy() - np.asarray(want.x)).max()):.3e}")


def dp_lanes(B, dtype, device):
    from mcp_tpu_torch.convert import mlp_params_from_numpy
    from mcp_tpu_torch.selection import dp

    inputs = dp.dp_inputs(B)
    runner = dp.dp_runner(device)

    class Recording:
        """The dp runner, keeping each solve's result."""

        def __init__(self):
            self.results = []

        def __getattr__(self, name):
            return getattr(runner, name)

        def solve(self, *args, **kw):
            bs = runner.solve(*args, **kw)
            self.results.append(bs.result)
            return bs

    def step(dt, rows):
        model = mlp_params_from_numpy(inputs["weights"], inputs["biases"], device=device,
                                      dtype=dt)
        data = [torch.as_tensor(inputs[k][rows]).to(device=device, dtype=dt)
                for k in ("histories", "initial_states", "goals")]
        rec = Recording()
        loss, params, _ = dp.dp_training_step(rec, model, *data)
        return float(loss), [p.double().cpu() for p in params], rec.results[0]

    def run(dt):
        lanes = [step(dt, slice(i, i + 1)) for i in range(B)]
        whole = step(dt, slice(None))
        mean_w = [sum(ws) / B for ws in zip(*(lane[1] for lane in lanes))]
        print(f"{dt}: dp (mean of {B} shards) against one rank: |Δloss| "
              f"{abs(sum(lane[0] for lane in lanes) / B - whole[0]):.3e}, max|Δw| "
              f"{max(float((a - b).abs().max()) for a, b in zip(mean_w, whole[1])):.3e}",
              flush=True)
        return lanes, whole

    x = lambda res: res.x.detach().double().cpu()
    dt = getattr(torch, dtype)
    lanes, whole = run(dt)
    wide = None if dt == torch.float64 else x(run(torch.float64)[1][2])
    r = whole[2]
    for i, (_, _, alone) in enumerate(lanes):
        line = (f"lane {i}: status {int(alone.status[0])} / {int(r.status[i])}, outer "
                f"{int(alone.outer_iters[0])} / {int(r.outer_iters[i])} (alone / in the "
                f"batch), max|Δx| {float((x(alone)[0] - x(r)[i]).abs().max()):.3e}")
        if wide is not None:
            line += f", against float64 in the batch {float((x(r)[i] - wide[i]).abs().max()):.3e}"
        print(line, flush=True)


if __name__ == "__main__":
    torch.set_num_threads(4)
    if sys.argv[1] == "cr-lanes":
        cr_lanes(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
    elif sys.argv[1] == "t64":
        t64()
    elif sys.argv[1] == "dw-lanes":
        dw_lanes([int(a) for a in sys.argv[2:]])
    elif sys.argv[1] == "gmres-qp":
        gmres_qp(int(sys.argv[2]), int(sys.argv[3]))
    elif sys.argv[1] == "dp-lanes":
        dp_lanes(int(sys.argv[2]), sys.argv[3], sys.argv[4] if len(sys.argv) > 4 else "cpu")
    else:
        raise SystemExit(__doc__)
