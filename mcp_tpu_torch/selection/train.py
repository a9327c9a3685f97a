"""Solver-in-the-loop training of the mask-predictor MLP (the JAX package's
``selection/train.py``): MLP forward → masked-game solve → composite loss →
gradient, with the ±10 solver-gradient clamp at the MLP output, then plain
SGD; per-epoch train and validation losses, early stopping on patience,
best-on-validation and final checkpoints.

The gradient of the solve comes from the implicit function theorem
(``diff.py``), so one ``torch.autograd.grad`` differentiates the whole step.
A step whose gradient is not finite falls back to a random gradient of scale
1e-3 (the reference's failed-gradient fallback), drawn from a CPU
``torch.Generator`` seeded from ``config.seed``: it matches the JAX
package's draw in distribution only.

Checkpoints are pickles in the JAX package's layout (``weights`` (out, in)
and ``biases`` as numpy arrays, ``config`` as a dict, ``extra``), so a
checkpoint written by either package loads in the other. The JAX package's
"orbax" backend writes an Orbax directory beside the pickle; its
counterpart here, backend "dcp", writes a ``torch.distributed.checkpoint``
directory at ``path + ".dcp"`` with the tensors ``weights.{i}`` and
``biases.{i}``, which ``load_dcp_weights`` restores.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
import time
from typing import Optional

import numpy as np
import torch

from ..convert import mlp_params_from_numpy
from .data import DataLoader, Example, batch_arrays
from .loss import DEFAULT_WEIGHTS, clamp_cotangent, composite_loss
from .model import MaskMLP, input_size, prepare_input
from .runner import MaskedGameRunner


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The training configuration (the reference's include-time globals)."""

    num_players: int = 4
    horizon: int = 30
    input_horizon: int = 10
    input_state_dim: int = 2
    batch_size: int = 2
    epochs: int = 100
    learning_rate: float = 0.005
    loss_weights: tuple = DEFAULT_WEIGHTS
    patience: int = 100
    seed: int = 3
    ego_index: int = 0

    @property
    def record_name(self) -> str:
        """Run-identity string."""
        return (
            f"bs_{self.batch_size}_ep_{self.epochs}_lr_{self.learning_rate}"
            f"_sd_{self.seed}_pat_{self.patience}_N_{self.num_players}"
            f"_h_{self.horizon}_ih{self.input_horizon}_isd_{self.input_state_dim}"
            f"_w_{list(self.loss_weights)}"
        )


def make_train_step(runner: MaskedGameRunner, config: TrainConfig):
    """(train_step, eval_step, sgd_update) for ``runner``'s game:

    * ``train_step(model, trajectories, initial_states, goals)`` →
      (loss, (per_example, status), grads), grads one tensor per
      ``model.parameters()`` entry;
    * ``eval_step(model, …)`` → (loss, (per_example, status)), no graph;
    * ``sgd_update(model, grads, lr)`` updates the parameters in place and
      returns the model.

    trajectories (B, N, T, 4) are the ground-truth plans (MLP input and
    loss target), initial_states (B, N, 4), goals (B, N, 2)."""
    ego = config.ego_index

    def loss_fn(model, trajectories, initial_states, goals):
        inputs = prepare_input(trajectories, config.input_horizon, config.input_state_dim)
        masks_pred = clamp_cotangent(model(inputs))  # (B, N-1), ±10 solver-grad clamp
        # Full mask vector: the ego's own entry is 1.
        full_masks = torch.cat([torch.ones_like(masks_pred[:, :1]), masks_pred], dim=1)
        mask_rows = runner.ego_masked_mask_rows(full_masks, ego_index=ego)
        bs = runner.solve(initial_states, goals, full_masks, mask_rows=mask_rows)
        per_example = composite_loss(
            bs.trajectories[:, ego], trajectories[:, ego], masks_pred,
            horizon=config.horizon, input_horizon=config.input_horizon,
            weights=config.loss_weights,
        )
        return per_example.mean(), (per_example, bs.result.status)

    def train_step(model: MaskMLP, trajectories, initial_states, goals):
        loss, (per_example, status) = loss_fn(model, trajectories, initial_states, goals)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        return loss.detach(), (per_example.detach(), status), grads

    def eval_step(model: MaskMLP, trajectories, initial_states, goals):
        with torch.no_grad():
            return loss_fn(model, trajectories, initial_states, goals)

    def sgd_update(model: MaskMLP, grads, lr: float) -> MaskMLP:
        with torch.no_grad():
            for p, g in zip(model.parameters(), grads):
                p.sub_(lr * g)
        return model

    return train_step, eval_step, sgd_update


class MetricsLogger:
    """JSONL metrics log (``metrics.jsonl`` in ``log_dir``), plus TensorBoard
    under ``log_dir/tb`` when ``torch.utils.tensorboard`` imports."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._f = open(self.path, "a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return
        self._tb = SummaryWriter(log_dir=os.path.join(log_dir, "tb"))

    def log(self, step: int, **metrics):
        self._f.write(json.dumps({"step": step, **metrics}) + "\n")
        self._f.flush()
        if self._tb is not None:
            for k, v in metrics.items():
                if isinstance(v, (int, float)):
                    self._tb.add_scalar(k, v, step)

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()


def _dcp_state(model: MaskMLP) -> dict:
    state = {}
    for i, layer in enumerate(model.layers):
        state[f"weights.{i}"] = layer.weight.detach().cpu()
        state[f"biases.{i}"] = layer.bias.detach().cpu()
    return state


def save_checkpoint(path: str, model: MaskMLP, config: TrainConfig, extra=None,
                    backend: str = "pickle"):
    """Pickle the model's weights (out, in) and biases as numpy arrays with
    the config and ``extra``; backend "dcp" also writes them as a
    ``torch.distributed.checkpoint`` directory at ``path + ".dcp"``
    (``weights.{i}``, ``biases.{i}``), the counterpart of the JAX package's
    "orbax" backend, which is a JAX library and raises NotImplementedError
    here."""
    if backend not in ("pickle", "dcp"):
        raise NotImplementedError(
            f"checkpoint backend {backend!r}: 'pickle' or 'dcp' (orbax is a JAX library; "
            "backend 'dcp' writes its counterpart, a torch.distributed.checkpoint directory)")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(
            {
                "weights": [layer.weight.detach().cpu().numpy() for layer in model.layers],
                "biases": [layer.bias.detach().cpu().numpy() for layer in model.layers],
                "config": dataclasses.asdict(config),
                "extra": extra,
            },
            f,
        )
    if backend == "dcp":
        import torch.distributed.checkpoint as dcp

        dcp.save(_dcp_state(model), checkpoint_id=os.path.abspath(path) + ".dcp")


def load_dcp_weights(directory: str) -> tuple[list, list]:
    """(weights, biases) as CPU tensors from a ``save_checkpoint(...,
    backend="dcp")`` directory, each restored into a tensor of the shape and
    dtype its metadata records."""
    import torch.distributed.checkpoint as dcp

    meta = dcp.FileSystemReader(directory).read_metadata().state_dict_metadata
    state = {k: torch.empty(tuple(m.size), dtype=m.properties.dtype) for k, m in meta.items()}
    dcp.load(state, checkpoint_id=directory)
    layers = len(state) // 2
    return ([state[f"weights.{i}"] for i in range(layers)],
            [state[f"biases.{i}"] for i in range(layers)])


def load_checkpoint(path: str, device="cuda", dtype=torch.float32) -> tuple[MaskMLP, dict]:
    """(model on ``device``, the checkpoint's payload dict). Unpickles the
    file: load only checkpoints this project wrote."""
    with open(path, "rb") as f:
        payload = pickle.load(f)
    return mlp_params_from_numpy(payload["weights"], payload["biases"], device=device,
                                 dtype=dtype), payload


def _grads_finite(grads) -> bool:
    return all(bool(torch.isfinite(g).all()) for g in grads)


def _random_like(grads, generator: torch.Generator, scale: float = 1.0):
    return [
        scale * torch.randn(g.shape, generator=generator, dtype=torch.float64).to(
            device=g.device, dtype=g.dtype)
        for g in grads
    ]


def train(
    runner: MaskedGameRunner,
    train_dataset: list[Example],
    val_dataset: Optional[list[Example]] = None,
    *,
    config: TrainConfig = TrainConfig(),
    log_dir: Optional[str] = None,
    model: Optional[MaskMLP] = None,
    verbose: bool = True,
) -> tuple[MaskMLP, dict]:
    """The training loop: per epoch, a train_step and an SGD update per
    batch of a fresh shuffle, then the mean validation loss; the model with
    the best validation loss goes to ``best_model.pkl``, training stops
    after ``config.patience`` epochs without improvement, and the last model
    goes to ``trained_model.pkl`` with the history in ``losses.json``.
    ``model=None`` builds the MLP from a generator seeded with
    ``config.seed``; data and model live on the runner's device.

    Returns (the best model, reloaded from ``best_model.pkl`` when there is
    one, else the last; history {"train_loss": [...], "val_loss": [...]})."""
    log_dir = log_dir or os.path.join("logs", config.record_name)
    logger = MetricsLogger(log_dir)
    device = runner.device
    generator = torch.Generator().manual_seed(config.seed)
    if model is None:
        model = MaskMLP(
            input_size(config.num_players, config.input_horizon, config.input_state_dim),
            config.num_players, generator=torch.Generator().manual_seed(config.seed),
            device=device,
        )

    train_step, eval_step, sgd_update = make_train_step(runner, config)
    loader = DataLoader(train_dataset, config.batch_size, seed=config.seed)
    val_loader = (DataLoader(val_dataset, config.batch_size, seed=config.seed)
                  if val_dataset else None)

    best_val = float("inf")
    patience_counter = 0
    history = {"train_loss": [], "val_loss": []}
    best_path = os.path.join(log_dir, "best_model.pkl")

    for epoch in range(config.epochs):
        epoch_losses = []
        t0 = time.time()
        for batch in loader:
            loss, _, grads = train_step(model, *batch_arrays(batch, device=device))
            if not _grads_finite(grads):
                grads = _random_like(grads, generator, scale=1e-3)
            sgd_update(model, grads, config.learning_rate)
            epoch_losses.append(float(loss))
        train_loss = float(np.mean(epoch_losses)) if epoch_losses else float("nan")
        history["train_loss"].append(train_loss)

        val_loss = float("nan")
        if val_loader is not None:
            val_losses = [float(eval_step(model, *batch_arrays(batch, device=device))[0])
                          for batch in val_loader]
            val_loss = float(np.mean(val_losses)) if val_losses else float("nan")
            history["val_loss"].append(val_loss)

        logger.log(epoch, train_loss=train_loss, val_loss=val_loss,
                   epoch_time_s=time.time() - t0)
        if verbose:
            print(f"epoch {epoch}: train {train_loss:.4f} val {val_loss:.4f} "
                  f"({time.time() - t0:.1f}s)")

        if val_loader is not None and val_loss < best_val:
            best_val = val_loss
            patience_counter = 0
            save_checkpoint(best_path, model, config, extra={"epoch": epoch, "val_loss": val_loss})
        elif val_loader is not None:
            patience_counter += 1
            if patience_counter >= config.patience:
                if verbose:
                    print(f"early stop at epoch {epoch}")
                break

    save_checkpoint(os.path.join(log_dir, "trained_model.pkl"), model, config,
                    extra={"history": history})
    with open(os.path.join(log_dir, "losses.json"), "w") as f:
        json.dump(history, f)
    logger.close()

    if os.path.exists(best_path):
        model, _ = load_checkpoint(best_path, device=device,
                                   dtype=next(model.parameters()).dtype)
    return model, history
