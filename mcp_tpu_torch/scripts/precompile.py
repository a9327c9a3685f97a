"""Prepare a fresh machine for the benchmarks (the JAX package's
``scripts/precompile.py``). The JAX script fills XLA's compile cache; the
port compiles nothing ahead of a call, and what a first call pays instead
is the nvcc build of the kernel libraries its path launches and, for the
training step, the game build's probes and the ground-truth solve. Each
suite builds its path's libraries into ``persistent_cache_dir()``
(``kernels/_build.build``) and runs one batch, so that they load:

* ``headline``: the lane-change batch of ``--batch`` (horizon 10, float32,
  tol 1e-4, "ip", polish, tier "tridiag_pallas": K1, K2) and its true-KKT
  check, as ``bench_cuda.py`` runs it;
* ``n4``, ``n10``: one masked flagship batch of 8 at horizon 30 on
  "tridiag_auto" (K3, K2), with the JAX script's options;
* ``train``: stages the N=4 training step on ``bench_train_step``'s
  default tier (``bench.flagships.stage_train_step(8, 4, 30,
  tier="tridiag_pallas")``, K7a, K2), then runs one step, so that
  ``python -m mcp_tpu_torch.scripts.bench_train_step`` starts from the
  staged step.

Progress lines ``[precompile +s] ...`` go to stderr.

    python -m mcp_tpu_torch.scripts.precompile [--suites headline train n4 n10] [--cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

#: The kernel libraries each suite's path launches (``kernels/_build.SOURCES``).
SUITE_KERNELS = {
    "headline": ("thomas", "linesearch"),
    "n4": ("cyclic_reduction", "linesearch"),
    "n10": ("cyclic_reduction", "linesearch"),
    "train": ("thomas_babe", "linesearch"),
}


def main(argv=None) -> None:
    t0 = time.monotonic()

    def phase(msg: str) -> None:
        print(f"[precompile +{time.monotonic() - t0:7.1f}s] {msg}", file=sys.stderr, flush=True)

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--suites", nargs="*", default=["headline"], choices=list(SUITE_KERNELS))
    args = p.parse_args(argv)

    import torch

    from .._device import resolve_device
    from ..solver import SolverOptions, auto_tightening_rate

    device = resolve_device("cpu" if args.cpu else "cuda")
    phase(f"torch ready, device {device}")
    if device.type == "cuda":
        from ..kernels import _build

        names = sorted({k for suite in args.suites for k in SUITE_KERNELS[suite]})
        built = _build.build(names)
        phase(f"kernel libraries {names} ready (built now: {sorted(built) or 'none'})")

    if "headline" in args.suites:
        from .. import solve_batch
        from ..bench import harness
        from ..bench import lane_change as lc

        bench = lc.generate_test_problem(horizon=10, device=device)
        mcp = bench.parametric_game.mcp
        thetas = lc.generate_parameter_batch(torch.Generator(device).manual_seed(1),
                                             args.batch, bench, device=device)
        options = SolverOptions(tol=1e-4, linear_solver="tridiag_pallas", polish=True,
                                tightening_rate=auto_tightening_rate(mcp))
        res = solve_batch(mcp, thetas, options=options)
        float(harness.true_kkt_errors(mcp, res, thetas).max())
        phase(f"headline: lane-change batch of {args.batch} solved and checked")

    if "n4" in args.suites or "n10" in args.suites:
        from .. import solve_batch
        from ..bench.flagships import masked_game_setup

        for players, algo, refine in (("n4" in args.suites) * [(4, "hybrid", 0)]
                                      + ("n10" in args.suites) * [(10, "ip", 1)]):
            s = masked_game_setup(8, players, 30, device=device)
            opts = SolverOptions(linear_solver="tridiag_auto", polish=True,
                                 tightening_rate=auto_tightening_rate(s.mcp), algorithm=algo,
                                 refinement_steps=refine, hybrid_switch_tol=3e-2)
            float(solve_batch(s.mcp, s.thetas, x0=s.x0, options=opts).x.sum())
            phase(f"N={players} flagship batch solved")

    if "train" in args.suites:
        from ..bench.flagships import stage_train_step

        s = stage_train_step(8, 4, 30, tier="tridiag_pallas", device=device)
        phase("train: N=4 h30 b8 step staged (tridiag_pallas); setup seconds "
              + ", ".join(f"{k} {v:.3f}" for k, v in s.seconds.items()))
        loss, _, _ = s.train_step(s.model, s.trajectories, s.init, s.goals)
        float(loss)
        phase("train: one training step run")

    phase("done")


if __name__ == "__main__":
    main()
