"""The training loop of the PyTorch port (``selection/train.py``: ``train``,
``MetricsLogger``, the checkpoints and the random-gradient fallback) against
the JAX package on the CPU at N=2 and horizon 4 (input horizon 2), and the
three command-line entry points of ``mcp_tpu_torch/scripts/`` at a tiny size.

Both packages train in float32 from the same carried weights on the same
ground truth along the same batches, so the losses differ by rounding only:
LOSS_TOL and WEIGHT_TOL are ten times the largest differences measured
(6.0e-8 of a loss, 1.5e-8 of a weight). The learning rate is negative: the
steps climb the loss, so the validation loss rises after the first epoch and
early stopping (patience 1) ends both runs at epoch 1 of 3."""

import dataclasses
import functools
import importlib
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from mcp_tpu.selection import runner as jax_runner_mod
from mcp_tpu.selection.games import setup_road_environment as jax_road
from mcp_tpu.selection.games import setup_trajectory_game as jax_game
from mcp_tpu.selection.model import apply_mlp, init_mlp, input_size
from mcp_tpu_torch.convert import mlp_params_from_numpy
from mcp_tpu_torch.selection import (
    MaskedGameRunner,
    MetricsLogger,
    TrainConfig,
    generate_ground_truth,
    generate_scenarios,
    load_checkpoint,
    save_checkpoint,
    setup_road_environment,
    setup_trajectory_game,
    train,
)

jax_train = importlib.import_module("mcp_tpu.selection.train")
train_mod = importlib.import_module("mcp_tpu_torch.selection.train")
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
N, H, IH = 2, 4, 2
LOSS_TOL, WEIGHT_TOL = 6e-7, 1.5e-7
CONFIG = dict(num_players=N, horizon=H, input_horizon=IH, input_state_dim=2, batch_size=2,
              epochs=3, learning_rate=-0.05, patience=1, seed=3)


@functools.lru_cache(maxsize=None)
def _port_runner():
    game = setup_trajectory_game(environment=setup_road_environment(length=10.0), N=N)
    return MaskedGameRunner.create(game, N=N, horizon=H, device="cpu")


@functools.lru_cache(maxsize=None)
def _weights():
    params = init_mlp(jax.random.PRNGKey(7), input_size(N, IH, 2), N)
    return params, [np.asarray(w) for w in params.weights], [np.asarray(b) for b in params.biases]


@pytest.fixture(scope="module")
def examples(tmp_path_factory):
    scenarios = generate_scenarios(num_scenarios=8, num_players=N, arena_half_width=3.0,
                                   seed=1, backend="python")
    out = generate_ground_truth(_port_runner(), scenarios, str(tmp_path_factory.mktemp("gt")))
    assert len(out) >= 6
    return out


@pytest.fixture(scope="module")
def trained(examples, tmp_path_factory):
    """Both packages' train() from the same weights: (port (model, history,
    dir), JAX (params, history, dir))."""
    params, ws, bs = _weights()
    jax_runner = jax_runner_mod.MaskedGameRunner.create(
        jax_game(environment=jax_road(length=10.0), N=N), N=N, horizon=H)
    d_jax, d_port = tmp_path_factory.mktemp("run_jax"), tmp_path_factory.mktemp("run_port")
    want = jax_train.train(jax_runner, examples[:4], examples[4:6],
                           config=jax_train.TrainConfig(**CONFIG), log_dir=str(d_jax),
                           params=params, verbose=False)
    got = train(_port_runner(), examples[:4], examples[4:6], config=TrainConfig(**CONFIG),
                log_dir=str(d_port), model=mlp_params_from_numpy(ws, bs, device="cpu"),
                verbose=False)
    return (*got, d_port), (*want, d_jax)


def test_train_losses_match_jax(trained):
    (_, got, _), (_, want, _) = trained
    assert len(got["train_loss"]) == len(want["train_loss"]) == 2
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=LOSS_TOL)
        assert np.isfinite(got[key]).all()


def test_train_stops_at_the_jax_epoch_and_writes_the_same_files(trained):
    (_, got, d_port), (_, want, d_jax) = trained
    assert sorted(os.listdir(d_port)) == sorted(os.listdir(d_jax))
    for name in ("best_model.pkl", "trained_model.pkl", "losses.json", "metrics.jsonl"):
        assert (d_port / name).exists()
    assert json.loads((d_port / "losses.json").read_text()) == got
    with open(d_port / "best_model.pkl", "rb") as f:
        mine = pickle.load(f)
    with open(d_jax / "best_model.pkl", "rb") as f:
        theirs = pickle.load(f)
    assert mine["extra"]["epoch"] == theirs["extra"]["epoch"] == 0
    assert mine["config"] == theirs["config"]
    assert got["val_loss"][1] > got["val_loss"][0]
    lines = (d_port / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(line)["step"] for line in lines] == list(range(len(got["train_loss"])))


def test_train_returns_the_best_model_as_jax_does(trained):
    (model, _, d_port), (params, _, _) = trained
    assert next(model.parameters()).dtype == torch.float32
    best, _ = load_checkpoint(str(d_port / "best_model.pkl"), device="cpu")
    last, _ = load_checkpoint(str(d_port / "trained_model.pkl"), device="cpu")
    for p, b, t in zip(model.parameters(), best.parameters(), last.parameters()):
        assert torch.equal(p, b)
    assert not all(torch.equal(p, t) for p, t in zip(model.parameters(), last.parameters()))
    for layer, w, b in zip(model.layers, params.weights, params.biases):
        np.testing.assert_allclose(layer.weight.detach().numpy(), np.asarray(w), rtol=0,
                                   atol=WEIGHT_TOL)
        np.testing.assert_allclose(layer.bias.detach().numpy(), np.asarray(b), rtol=0,
                                   atol=WEIGHT_TOL)


def test_checkpoints_interchange(tmp_path):
    params, ws, bs = _weights()
    config = TrainConfig(**CONFIG)
    model = mlp_params_from_numpy(ws, bs, device="cpu")
    save_checkpoint(str(tmp_path / "port.pkl"), model, config, extra={"epoch": 2})
    jax_train.save_checkpoint(str(tmp_path / "jax.pkl"), params,
                              jax_train.TrainConfig(**CONFIG), extra={"epoch": 2})
    loaded, payload = jax_train.load_checkpoint(str(tmp_path / "port.pkl"))
    mine, mine_payload = load_checkpoint(str(tmp_path / "jax.pkl"), device="cpu")
    assert payload["config"] == dataclasses.asdict(config) == mine_payload["config"]
    assert payload["extra"] == mine_payload["extra"] == {"epoch": 2}
    for w, b, lw, lb, layer in zip(ws, bs, loaded.weights, loaded.biases, mine.layers):
        np.testing.assert_array_equal(np.asarray(lw), w)
        np.testing.assert_array_equal(np.asarray(lb), b)
        np.testing.assert_array_equal(layer.weight.detach().numpy(), w)
        np.testing.assert_array_equal(layer.bias.detach().numpy(), b)
    x = np.random.default_rng(0).standard_normal(input_size(N, IH, 2)).astype(np.float32)
    np.testing.assert_allclose(mine(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(apply_mlp(loaded, x)), rtol=0, atol=1e-6)
    with pytest.raises(NotImplementedError, match="orbax"):
        save_checkpoint(str(tmp_path / "o.pkl"), model, config, backend="orbax")


def test_non_finite_gradients_fall_back_to_a_seeded_random_step(examples, tmp_path,
                                                                monkeypatch):
    """With the step's gradients forced non-finite, every update is −lr ·
    1e-3 · N(0, 1) drawn from the generator seeded with config.seed, and
    training continues to the end."""
    real = train_mod.make_train_step

    def nan_steps(runner, config):
        train_step, eval_step, sgd_update = real(runner, config)

        def step(*args):
            loss, aux, grads = train_step(*args)
            return loss, aux, [torch.full_like(g, float("nan")) for g in grads]

        return step, eval_step, sgd_update

    monkeypatch.setattr(train_mod, "make_train_step", nan_steps)
    _, ws, bs = _weights()
    model = mlp_params_from_numpy(ws, bs, device="cpu")
    start = [p.detach().clone() for p in model.parameters()]
    config = TrainConfig(**dict(CONFIG, epochs=2, patience=5))
    got, history = train(_port_runner(), examples[:4], None, config=config,
                         log_dir=str(tmp_path), model=model, verbose=False)
    assert got is model and history["val_loss"] == [] and len(history["train_loss"]) == 2
    assert np.isfinite(history["train_loss"]).all()
    gen = torch.Generator().manual_seed(config.seed)
    for _ in range(4):  # 2 epochs of 2 batches
        start = [p - config.learning_rate * 1e-3 * torch.randn(
            p.shape, generator=gen, dtype=torch.float64).float() for p in start]
    for p, want in zip(model.parameters(), start):
        assert bool(torch.isfinite(p).all())
        torch.testing.assert_close(p.detach(), want, rtol=0, atol=1e-7)
    assert not (tmp_path / "best_model.pkl").exists()


def test_metrics_logger_appends_jsonl(tmp_path):
    logger = MetricsLogger(str(tmp_path / "log"))
    logger.log(0, train_loss=1.5, val_loss=float("nan"))
    logger.log(1, train_loss=1.25, note="x")
    logger.close()
    rows = [json.loads(line) for line in (tmp_path / "log" / "metrics.jsonl").read_text()
            .splitlines()]
    assert rows[0]["step"] == 0 and rows[1] == {"step": 1, "train_loss": 1.25, "note": "x"}


def test_the_three_clis_run_on_the_cpu(tmp_path):
    """datagen and train_selection through their main(argv) in this
    process, evaluate_selection as ``python -m`` in a child process."""
    from mcp_tpu_torch.scripts import datagen, train_selection

    data, run, ev = tmp_path / "data", tmp_path / "run", tmp_path / "eval"
    datagen.main(["--out", str(data), "--players", "2", "--horizon", "4", "--train", "4",
                  "--val", "2", "--test", "2", "--arena", "3.0", "--cpu"])
    assert len(os.listdir(data / "train")) >= 2 and len(os.listdir(data / "test")) == 2
    train_selection.main(["--data", str(data), "--players", "2", "--horizon", "4",
                          "--input-horizon", "2", "--epochs", "1", "--batch-size", "2",
                          "--log-dir", str(run), "--tier", "tridiag_pallas", "--cpu"])
    assert json.loads((run / "losses.json").read_text())["train_loss"]
    assert (run / "best_model.pkl").exists()
    assert [p.name for p in run.glob("*.png")] == ["loss_curves.png"]
    proc = subprocess.run(
        [sys.executable, "-m", "mcp_tpu_torch.scripts.evaluate_selection", "--data", str(data),
         "--players", "2", "--horizon", "4", "--input-horizon", "2", "--steps", "2",
         "--scenarios", "2", "--model", str(run / "best_model.pkl"), "--modes", "All",
         "Neural Network Partial Rank", "--out", str(ev), "--cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    metrics = json.loads((ev / "metrics.json").read_text())
    assert set(metrics) == {"All [1]", "Neural Network Partial Rank [2]",
                            "Neural Network Partial Rank [3]"}
    assert metrics["All [1]"]["Mask Sum"] == 2.0
    assert (ev / "receding_horizon_trajectories_[1]_[All]_[1].json").exists()
    assert os.path.getsize(ev / "radar.png") > 1000
