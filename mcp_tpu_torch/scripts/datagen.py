"""Generate random scenarios and their ground-truth solved trajectories:
sample N-player scenarios with a minimum separation, replay them through
the all-ones-mask game in batched solves, and write one JSON per converged
scenario into train/, val/ and test/.

    python -m mcp_tpu_torch.scripts.datagen --out data --players 4 --horizon 30 \
        --train 64 --val 16 --test 16 [--tier tridiag_pallas] [--cpu]
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--players", type=int, default=4)
    p.add_argument("--horizon", type=int, default=30)
    p.add_argument("--train", type=int, default=64)
    p.add_argument("--val", type=int, default=16)
    p.add_argument("--test", type=int, default=16)
    p.add_argument("--arena", type=float, default=4.0)
    p.add_argument("--min-separation", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tier", default="tridiag")
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)

    from ..selection import generate_ground_truth, generate_scenarios
    from . import road_runner

    runner = road_runner(args.players, args.horizon, length=2 * args.arena + 2,
                         tier=args.tier, device="cpu" if args.cpu else "cuda")
    seed = args.seed
    for name, count in (("train", args.train), ("val", args.val), ("test", args.test)):
        if count == 0:
            continue
        scenarios = generate_scenarios(num_scenarios=count, num_players=args.players,
                                       arena_half_width=args.arena,
                                       min_separation=args.min_separation, seed=seed)
        seed += 1
        out_dir = os.path.join(args.out, name)
        examples = generate_ground_truth(runner, scenarios, out_dir)
        print(f"{name}: {len(examples)}/{count} scenarios converged -> {out_dir}")


if __name__ == "__main__":
    main()
