"""Player-selection mask predictor MLP (the JAX package's
``selection/model.py``; the reference's Flux model): the flattened ego
history (N · input_horizon · input_state_dim) → Dense(256, relu) →
Dense(64, relu) → Dense(16, relu) → Dense(N−1, sigmoid).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .._device import resolve_device

HIDDEN_SIZES = (256, 64, 16)


def input_size(num_players: int, input_horizon: int = 10, input_state_dim: int = 2) -> int:
    """N · input_horizon · input_state_dim."""
    return num_players * input_horizon * input_state_dim


class MaskMLP(nn.Module):
    """The mask predictor: (…, in_size) → (…, N−1) masks in (0, 1).

    Weights are Glorot-uniform (Flux's Dense default), drawn in float64 from
    ``generator`` (a CPU ``torch.Generator``; default seed 3) and cast to
    ``dtype``; biases start at 0. ``device`` defaults to ``"cuda"`` and
    raises without a GPU."""

    def __init__(self, in_size: int, num_players: int, *,
                 generator: Optional[torch.Generator] = None, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        device = resolve_device(device)
        generator = torch.Generator().manual_seed(3) if generator is None else generator
        sizes = (in_size,) + HIDDEN_SIZES + (num_players - 1,)
        self.layers = nn.ModuleList()
        for a, b in zip(sizes[:-1], sizes[1:]):
            layer = nn.Linear(a, b, dtype=dtype, device=device)
            limit = (6.0 / (a + b)) ** 0.5
            w = (2.0 * torch.rand((b, a), generator=generator, dtype=torch.float64) - 1.0) * limit
            with torch.no_grad():
                layer.weight.copy_(w)
                layer.bias.zero_()
            self.layers.append(layer)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        return torch.sigmoid(x)


def prepare_input(trajectories: torch.Tensor, input_horizon: int,
                  input_state_dim: int) -> torch.Tensor:
    """The first ``input_horizon`` steps and ``input_state_dim`` dims of every
    player's trajectory, flattened: (…, N, T, state_dim) → (…, N·ih·isd)."""
    return trajectories[..., :input_horizon, :input_state_dim].flatten(-3)
