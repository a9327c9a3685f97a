"""Closed-loop evaluation sweep over selection modes on the test/
scenarios that ``datagen`` wrote, then the metrics of every mode, averaged
over the scenarios, in ``metrics.json``, and their radar chart in
``radar.png``.

    python -m mcp_tpu_torch.scripts.evaluate_selection --data data --players 4 \
        --horizon 30 --model logs/<run>/best_model.pkl --steps 50 --out eval_out \
        [--tier tridiag_pallas] [--cpu]

Without ``--model`` the neural-network modes are left out.
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data", required=True, help="dir containing test/ scenarios")
    p.add_argument("--players", type=int, default=4)
    p.add_argument("--horizon", type=int, default=30)
    p.add_argument("--input-horizon", type=int, default=10)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--model", default=None, help="checkpoint for NN modes")
    p.add_argument("--modes", nargs="*", default=None)
    p.add_argument("--scenarios", type=int, default=8)
    p.add_argument("--out", required=True)
    p.add_argument("--tier", default="tridiag")
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)

    import numpy as np

    from ..analysis import analyze_result, radar_plot
    from ..selection import (
        MODE_PARAMETERS_N4,
        MODE_PARAMETERS_N10,
        Scenario,
        evaluate_modes,
        load_all_json_data,
        load_checkpoint,
    )
    from . import figure, road_runner

    device = "cpu" if args.cpu else "cuda"
    examples = load_all_json_data(os.path.join(args.data, "test"))[: args.scenarios]
    scenarios = [Scenario(initial_states=e.initial_states, goals=e.goals) for e in examples]
    print(f"{len(scenarios)} test scenarios")

    runner = road_runner(args.players, args.horizon, length=10.0, tier=args.tier,
                         device=device)
    model = load_checkpoint(args.model, device=device)[0] if args.model else None

    tables = MODE_PARAMETERS_N10 if args.players == 10 else MODE_PARAMETERS_N4
    if args.modes:
        tables = {m: tables[m] for m in args.modes}
    elif model is None:
        tables = {m: v for m, v in tables.items() if not m.startswith("Neural Network")}

    evaluate_modes(runner, scenarios, tables, args.out, num_sim_steps=args.steps,
                   model=model, input_horizon=args.input_horizon)

    metrics_by_mode = {}
    for mode, mode_params in tables.items():
        for mp in mode_params:
            rows = []
            for sid in range(len(scenarios)):
                path = os.path.join(
                    args.out, f"receding_horizon_trajectories_[{sid}]_[{mode}]_[{mp}].json")
                if not os.path.exists(path):
                    continue
                with open(path) as f:
                    rows.append(analyze_result(json.load(f), num_players=args.players))
            if rows:
                metrics_by_mode[f"{mode} [{mp}]"] = {
                    k: float(np.mean([r[k] for r in rows])) for k in rows[0]}
    with open(os.path.join(args.out, "metrics.json"), "w") as f:
        json.dump(metrics_by_mode, f, indent=2)
    print(f"metrics in {os.path.join(args.out, 'metrics.json')}")
    radar = os.path.join(args.out, "radar.png")
    if metrics_by_mode and figure(radar, lambda: radar_plot(metrics_by_mode, radar)):
        print(f"radar chart in {radar}")


if __name__ == "__main__":
    main()
