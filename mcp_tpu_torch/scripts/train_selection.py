"""Train the player-selection MLP with the solver in the loop on the data
that ``datagen`` wrote (train/ and, if present, val/); checkpoints
(``best_model.pkl``, ``trained_model.pkl``), ``losses.json``,
``metrics.jsonl`` and ``loss_curves.png`` go to the log directory.

    python -m mcp_tpu_torch.scripts.train_selection --data data --players 4 \
        --horizon 30 --epochs 20 --batch-size 8 --lr 0.005 [--tier tridiag_pallas] [--cpu]
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data", required=True, help="dir containing train/ and val/")
    p.add_argument("--players", type=int, default=4)
    p.add_argument("--horizon", type=int, default=30)
    p.add_argument("--input-horizon", type=int, default=10)
    p.add_argument("--input-state-dim", type=int, default=2)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument("--lr", type=float, default=0.005)
    p.add_argument("--patience", type=int, default=100)
    p.add_argument("--seed", type=int, default=3)
    p.add_argument("--log-dir", default=None)
    p.add_argument("--tier", default="tridiag")
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)

    from ..analysis import loss_curves_plot
    from ..selection import TrainConfig, load_all_json_data, train
    from . import figure, road_runner

    train_data = load_all_json_data(os.path.join(args.data, "train"))
    val_dir = os.path.join(args.data, "val")
    val_data = load_all_json_data(val_dir) if os.path.isdir(val_dir) else None
    print(f"train: {len(train_data)} examples, val: {len(val_data or [])}")

    runner = road_runner(args.players, args.horizon, length=10.0, tier=args.tier,
                         device="cpu" if args.cpu else "cuda")
    config = TrainConfig(
        num_players=args.players,
        horizon=args.horizon,
        input_horizon=args.input_horizon,
        input_state_dim=args.input_state_dim,
        batch_size=args.batch_size,
        epochs=args.epochs,
        learning_rate=args.lr,
        patience=args.patience,
        seed=args.seed,
    )
    log_dir = args.log_dir or os.path.join("logs", config.record_name)
    _, history = train(runner, train_data, val_data, config=config, log_dir=log_dir)
    print(f"done; checkpoints and losses.json in {log_dir}")
    curves = os.path.join(log_dir, "loss_curves.png")
    if figure(curves, lambda: loss_curves_plot(history, curves)):
        print(f"loss curves in {curves}")


if __name__ == "__main__":
    main()
