"""Composite player-selection training loss and the solver-gradient clamp
(the JAX package's ``selection/loss.py``; the reference's solver-in-the-loop
loss):

    loss = w₁·similarity + w₂·mask-sum + w₃·binariness,  weights (11, 1.5, 1)

The similarity term compares the ego player's solved tail positions (the
last ``input_horizon`` steps of the horizon-T plan) with the ground-truth
plan; the mask-sum term rewards sparsity; the binariness term pushes masks
toward {0, 1}. Each term takes one example or a leading batch axis and
returns one value per example.

The reference clips the solver gradient dL/dmask to ±10 before the network's
pullback; ``clamp_cotangent`` is that clip as an identity placed at the MLP
output whose backward clips the incoming gradient.
"""

from __future__ import annotations

import torch

DEFAULT_WEIGHTS = (11.0, 1.5, 1.0)
GRAD_CLAMP = 10.0


class _ClampCotangent(torch.autograd.Function):
    @staticmethod
    def forward(x):
        return x.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return g.clamp(-GRAD_CLAMP, GRAD_CLAMP)


def clamp_cotangent(x: torch.Tensor) -> torch.Tensor:
    """Identity whose backward gradient is clipped to ±GRAD_CLAMP."""
    return _ClampCotangent.apply(x)


def similarity_loss(ego_states: torch.Tensor, target_states: torch.Tensor, *,
                    horizon: int, input_horizon: int) -> torch.Tensor:
    """Mean 2-norm position error over the tail steps horizon−input_horizon
    .. horizon−1; states (…, T, state_dim ≥ 2)."""
    diff = (ego_states[..., horizon - input_horizon : horizon, :2]
            - target_states[..., horizon - input_horizon : horizon, :2])
    return torch.sqrt((diff**2).sum(dim=-1) + 1e-12).mean(dim=-1)


def mask_sparsity_loss(mask: torch.Tensor) -> torch.Tensor:
    """Σ mask / (N−1)."""
    return mask.mean(dim=-1)


def mask_binariness_loss(mask: torch.Tensor) -> torch.Tensor:
    """Σ (0.5 − |0.5 − mask|) / (N−1)."""
    return (0.5 - (0.5 - mask).abs()).mean(dim=-1)


def composite_loss(ego_states: torch.Tensor, target_states: torch.Tensor,
                   mask: torch.Tensor, *, horizon: int, input_horizon: int,
                   weights=DEFAULT_WEIGHTS) -> torch.Tensor:
    return (
        weights[0] * similarity_loss(ego_states, target_states, horizon=horizon,
                                     input_horizon=input_horizon)
        + weights[1] * mask_sparsity_loss(mask)
        + weights[2] * mask_binariness_loss(mask)
    )
