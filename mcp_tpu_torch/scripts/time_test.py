"""Solver time against the player count N (the reference's
examples/time_test.jl and scripts/time_plot.py): prints the seconds per
solve of each N as one JSON line (and writes it to ``--json-out``), then
plots them beside an O(N³) fit. The reference's own CPU numbers for this
experiment are in BASELINE.md.

    python -m mcp_tpu_torch.scripts.time_test --players 2 3 4 --horizon 30 \
        --batch 8 --out time_plot.png [--tier tridiag_pallas] [--cpu]
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--players", type=int, nargs="+", default=[2, 3, 4])
    p.add_argument("--horizon", type=int, default=30)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--out", default="time_plot.png")
    p.add_argument("--json-out", default=None)
    p.add_argument("--tier", default="tridiag")
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)

    from ..analysis import n_scaling_experiment, time_scaling_plot
    from ..solver import SolverOptions
    from . import figure

    results = n_scaling_experiment(
        tuple(args.players), horizon=args.horizon, batch=args.batch, repeats=args.repeats,
        options=SolverOptions(linear_solver=args.tier), device="cpu" if args.cpu else "cuda",
    )
    per_n = {str(k): v for k, v in results.items()}
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(per_n, f, indent=2)
    print(json.dumps(per_n))
    ns = sorted(results)
    if figure(args.out, lambda: time_scaling_plot(ns, [results[n] for n in ns], args.out)):
        print(f"time plot written to {args.out}")


if __name__ == "__main__":
    main()
