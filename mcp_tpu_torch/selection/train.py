"""Solver-in-the-loop training step of the mask-predictor MLP (the JAX
package's ``selection/train.py:43-192``): MLP forward → masked-game solve →
composite loss → gradient, with the ±10 solver-gradient clamp at the MLP
output. The gradient of the solve comes from the implicit function theorem
(``diff.py``), so one ``torch.autograd.grad`` differentiates the whole step.

The data layer, the ``train()`` loop, the metrics logger, checkpoints and the
random-gradient fallback are not ported yet (ROADMAP Queue 1 item 4).
"""

from __future__ import annotations

import dataclasses

import torch

from .loss import DEFAULT_WEIGHTS, clamp_cotangent, composite_loss
from .model import MaskMLP, prepare_input
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
