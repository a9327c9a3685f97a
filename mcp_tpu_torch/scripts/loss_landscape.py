"""The mask loss landscape of one training example (the reference's
examples/gradient_test.jl:7-55 and examples/loss_visualize.py): sweep two
mask entries over [0, 1]² against a ground-truth example, as one batched
solve of grid² lanes, print the loss range and the count of SOLVED lanes,
then plot the composite loss as a heatmap.

    python -m mcp_tpu_torch.scripts.loss_landscape --data data --players 4 \
        --horizon 30 --out landscape.png [--tier tridiag_pallas] [--cpu]
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data", required=True, help="dir containing train/ examples")
    p.add_argument("--players", type=int, default=4)
    p.add_argument("--horizon", type=int, default=30)
    p.add_argument("--input-horizon", type=int, default=10)
    p.add_argument("--grid", type=int, default=11)
    p.add_argument("--mask-indices", type=int, nargs=2, default=[1, 2])
    p.add_argument("--example", type=int, default=0)
    p.add_argument("--out", default="landscape.png")
    p.add_argument("--tier", default="tridiag")
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)

    from ..analysis import loss_landscape_plot, mask_loss_landscape
    from ..selection import load_all_json_data
    from . import figure, road_runner

    ex = load_all_json_data(os.path.join(args.data, "train"))[args.example]
    runner = road_runner(args.players, args.horizon, length=10.0, tier=args.tier,
                         device="cpu" if args.cpu else "cuda")
    out = mask_loss_landscape(
        runner, ex.initial_states, ex.goals, ex.trajectories[ex.ego_index],
        mask_indices=tuple(args.mask_indices), grid_points=args.grid,
        input_horizon=args.input_horizon,
    )
    print(f"loss range [{out['losses'].min():.4f}, {out['losses'].max():.4f}], "
          f"solved {int((out['statuses'] == 0).sum())}/{out['statuses'].size}")
    if figure(args.out, lambda: loss_landscape_plot(out["grid_x"], out["grid_y"],
                                                    out["losses"], args.out)):
        print(f"landscape written to {args.out}")


if __name__ == "__main__":
    main()
