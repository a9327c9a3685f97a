"""Animate closed-loop evaluation results (the reference's
examples/visualize.py and scripts/paper_vis.py): one GIF (or MP4, where
ffmpeg is present) per ``receding_horizon_*.json`` that
``evaluate_selection`` wrote. Only draws: it runs on the CPU.

    python -m mcp_tpu_torch.scripts.animate_results --results eval_out --players 4 \
        --out anim_out [--fmt mp4] [--limit 4]
"""

from __future__ import annotations

import argparse
import glob
import json
import os


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--results", required=True, help="dir of evaluation JSONs")
    p.add_argument("--players", type=int, required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--fmt", default="gif", choices=["gif", "mp4"])
    p.add_argument("--fps", type=int, default=10)
    p.add_argument("--limit", type=int, default=None)
    args = p.parse_args(argv)

    from ..analysis import animate_result
    from . import figure

    os.makedirs(args.out, exist_ok=True)
    files = sorted(glob.glob(os.path.join(args.results, "receding_horizon_*.json")))
    if args.limit:
        files = files[: args.limit]
    for path in files:
        with open(path) as f:
            result = json.load(f)
        name = os.path.splitext(os.path.basename(path))[0]
        out_path = os.path.join(args.out, f"{name}.{args.fmt}")
        if not figure(out_path, lambda: animate_result(result, out_path,
                                                       num_players=args.players,
                                                       fps=args.fps, title=name)):
            return
        print(out_path)


if __name__ == "__main__":
    main()
