"""Carry a game's build-time state across from plain host data.

The system has no weights: its "parameters" are the constants the game
builder attaches to the MCP, the ``TimeStructure`` and the ``AffineBands``.
These functions take a dict of plain ints, tuples or numpy arrays (``None``
stays ``None``), e.g. produced from the JAX package's MCP, and return the
port's objects, so both packages can run on the same bands.

The random-QP MCP (``bench/qp.py``) closes over nothing but θ, so nothing of
it carries across: the same θ, as a numpy array, goes into both packages.
The mask-predictor MLP does have weights: ``mlp_params_from_numpy`` carries
them into the port's ``MaskMLP``. The staged training step's inputs
(``train_inputs_to_numpy`` / ``train_inputs_from_numpy``) use the keys and
layout of the JAX package's staged ``.npz``, so either package reads the
other's.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from ._device import resolve_device
from .kernels.block_tridiag import AffineBands, TimeStructure


def time_structure_from_numpy(d: dict) -> TimeStructure:
    """``TimeStructure`` from keys permutation, num_blocks, block_size,
    row_permutation (or None) and rows_per_block."""
    rperm = d.get("row_permutation")
    return TimeStructure(
        permutation=tuple(int(i) for i in np.asarray(d["permutation"]).reshape(-1)),
        num_blocks=int(d["num_blocks"]),
        block_size=int(d["block_size"]),
        row_permutation=(
            None if rperm is None
            else tuple(int(i) for i in np.asarray(rperm).reshape(-1))
        ),
        rows_per_block=int(d.get("rows_per_block", 0)),
    )


def affine_bands_from_numpy(d: dict, device="cuda", dtype=torch.float64) -> AffineBands:
    """``AffineBands`` from its 11 leaves (``AffineBands._fields``) as host
    arrays or None, placed on ``device`` in ``dtype``."""
    device = resolve_device(device)
    return AffineBands(
        *(
            None if d[k] is None
            else torch.tensor(np.array(d[k]), dtype=dtype, device=device)
            for k in AffineBands._fields
        )
    )


def mlp_params_from_numpy(weights, biases, device="cuda", dtype=torch.float32):
    """A ``selection.model.MaskMLP`` holding the given layers: weights[i]
    (out, in) and biases[i] (out,) as host arrays, the layout of the JAX
    package's ``MLPParams``, on ``device`` in ``dtype``."""
    from .selection.model import MaskMLP

    weights = [np.asarray(w) for w in weights]
    num_players = weights[-1].shape[0] + 1
    model = MaskMLP(weights[0].shape[1], num_players, dtype=dtype, device=device)
    if len(model.layers) != len(weights):
        raise ValueError(f"expected {len(model.layers)} layers, got {len(weights)}")
    with torch.no_grad():
        for layer, w, b in zip(model.layers, weights, biases):
            if tuple(layer.weight.shape) != w.shape:
                raise ValueError(f"layer shape {tuple(layer.weight.shape)} != {w.shape}")
            layer.weight.copy_(torch.tensor(w))
            layer.bias.copy_(torch.tensor(np.asarray(b)))
    return model


def mlp_leaves(model) -> list:
    """A ``MaskMLP``'s parameters as numpy arrays in the order of
    ``jax.tree_util.tree_flatten`` of the JAX package's ``MLPParams``: every
    weight (out, in), then every bias."""
    return ([layer.weight.detach().cpu().numpy() for layer in model.layers]
            + [layer.bias.detach().cpu().numpy() for layer in model.layers])


def train_inputs_to_numpy(model, trajectories, init, goals, rate: float,
                          gt_success: float) -> dict:
    """The staged training step's inputs under the JAX package's ``.npz``
    keys: ``trajectories``, ``init``, ``goals``, ``rate`` and ``gt_success``
    (float32 scalars, as there) and ``param_{i}`` (``mlp_leaves``)."""
    return dict(
        trajectories=trajectories.detach().cpu().numpy(),
        init=init.detach().cpu().numpy(),
        goals=goals.detach().cpu().numpy(),
        rate=np.float32(rate),
        gt_success=np.float32(gt_success),
        **{f"param_{i}": a for i, a in enumerate(mlp_leaves(model))},
    )


def train_inputs_from_numpy(data, device="cuda", dtype=torch.float32) -> SimpleNamespace:
    """The inverse of ``train_inputs_to_numpy`` (a dict or an ``np.load``
    of either package's staged ``.npz``): model, trajectories, init, goals
    on ``device`` in ``dtype``, and rate, gt_success as floats."""
    device = resolve_device(device)
    leaves = [np.asarray(data[f"param_{i}"])
              for i in range(sum(k.startswith("param_") for k in data))]
    half = len(leaves) // 2
    tensor = lambda k: torch.as_tensor(np.asarray(data[k])).to(device=device, dtype=dtype)
    return SimpleNamespace(
        model=mlp_params_from_numpy(leaves[:half], leaves[half:], device=device, dtype=dtype),
        trajectories=tensor("trajectories"),
        init=tensor("init"),
        goals=tensor("goals"),
        rate=float(data["rate"]),
        gt_success=float(data["gt_success"]),
    )
