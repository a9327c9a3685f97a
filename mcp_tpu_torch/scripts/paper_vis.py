"""Publication figures from a directory of closed-loop evaluation JSONs (the
reference's scripts/paper_vis.py and radar_plot_{10,4,ped}.py): one
anchored radar chart per option group of the dataset's preset and,
optionally, the trajectory-snapshot grid over methods and time steps. Only
draws: it runs on the CPU.

    python -m mcp_tpu_torch.scripts.paper_vis --result-dir demo/eval --preset n4 \
        --out-dir demo/eval/figures \
        --grid "receding_horizon_trajectories_[0]_[All]_[1].json" \
               "receding_horizon_trajectories_[0]_[Neural Network Rank]_[2].json"
"""

from __future__ import annotations

import argparse
import json
import os
import re


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--result-dir", required=True)
    p.add_argument("--out-dir", default=None, help="default: <result-dir>/figures")
    p.add_argument("--preset", default="n10", choices=["n10", "n4", "ped"])
    p.add_argument("--grid", nargs="*", default=None,
                   help="evaluation JSON filenames (relative to --result-dir) to stack as "
                   "the trajectory-grid rows; omit to skip the grid figure")
    p.add_argument("--steps", nargs="*", type=int, default=[30, 50, 70, 90],
                   help="snapshot time steps for the grid columns (paper_vis.py:157)")
    p.add_argument("--step-dt", type=float, default=0.1)
    args = p.parse_args(argv)

    from ..analysis import paper_trajectory_grid, radar_report
    from . import figure

    out_dir = args.out_dir or os.path.join(args.result_dir, "figures")
    os.makedirs(out_dir, exist_ok=True)

    written = {}
    if figure(f"the {args.preset} radar charts in {out_dir}", lambda: written.update(
            radar_report(args.result_dir, out_dir, preset=args.preset))):
        for option, path in written.items():
            print(f"radar[{option}] -> {path}")

    if args.grid:
        results, labels = [], []
        for fname in args.grid:
            with open(os.path.join(args.result_dir, fname)) as f:
                results.append(json.load(f))
            # "..._[sid]_[Mode]_[param].json" -> "Mode" (paper_vis.py:141-150)
            m = re.findall(r"\[([^\]]+)\]", fname)
            labels.append(m[1] if len(m) >= 2 else os.path.splitext(fname)[0])
        grid_path = os.path.join(out_dir, "trajectories_grid.pdf")
        if figure(grid_path, lambda: paper_trajectory_grid(
                results, labels, grid_path, step_indices=args.steps, step_dt=args.step_dt)):
            print(f"trajectory grid -> {grid_path}")


if __name__ == "__main__":
    main()
