"""The data-parallel training step of the dry run (the JAX package's
``__graft_entry__.py:120-213``): MLP → masks → batched masked-game solve →
loss → IFT gradient → SGD, with the batch sharded over the ranks of a 1-D
batch mesh and the gradients averaged by an all-reduce.

The masked game at N=2, horizon 2; the MLP reads 2 steps of 2 state
dimensions of each player; 3 outer x 3 inner iterations on "schur"; SGD at
lr 0.005. ``dp_task`` is one rank's part (``bench/horizon.py``'s
"dp_train" task); ``dryrun.check_dp`` holds it against one rank.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..solver import SolverOptions

DP_N, DP_HORIZON, DP_INPUT_HORIZON, DP_STATE_DIM = 2, 2, 2, 2
DP_OPTIONS = dict(max_outer_iters=3, max_inner_iters=3, linear_solver="schur")
DP_LR = 0.005


@functools.lru_cache(maxsize=None)
def dp_runner(device: str):
    """The dp step's masked-game runner on ``device`` (built once)."""
    from .games import setup_road_environment, setup_trajectory_game
    from .runner import MaskedGameRunner

    game = setup_trajectory_game(environment=setup_road_environment(length=10.0), N=DP_N)
    return MaskedGameRunner.create(game, N=DP_N, horizon=DP_HORIZON, device=device,
                                   options=SolverOptions(**DP_OPTIONS))


def dp_inputs(batch: int) -> dict:
    """The dp step's host inputs (float64 numpy): the MLP's Glorot weights
    (``MaskMLP``'s draw from a generator seeded 0) and biases, and per
    instance uniform histories in [-1, 1], initial states in [-1, 1] and
    goals in [-2, 2] from numpy's generator seeded 1."""
    from .model import MaskMLP, input_size

    model = MaskMLP(input_size(DP_N, DP_INPUT_HORIZON, DP_STATE_DIM), DP_N,
                    generator=torch.Generator().manual_seed(0), dtype=torch.float64,
                    device="cpu")
    rng = np.random.default_rng(1)
    return dict(
        weights=[layer.weight.detach().numpy() for layer in model.layers],
        biases=[layer.bias.detach().numpy() for layer in model.layers],
        histories=rng.uniform(-1.0, 1.0, (batch, model.layers[0].in_features)),
        initial_states=rng.uniform(-1.0, 1.0, (batch, DP_N, 4)),
        goals=rng.uniform(-2.0, 2.0, (batch, DP_N, 2)),
    )


def dp_training_step(runner, model, histories, initial_states, goals, *, group=None):
    """MLP → masks → batched masked-game solve → loss → gradient → SGD.

    The loss has the composite loss's shape on stand-in targets:
    11·mean(x[:, :N·T·4]²) + 1.5·mean(masks) + mean(0.5 − |0.5 − masks|).
    With ``group`` the batch is this rank's shard: the loss and the
    gradients are averaged over the group's ranks (equal shards) by an
    all-reduce before the update. Returns (loss, new parameters, status)."""
    from ..parallel.mesh import all_reduce_sum

    masks = model(histories)  # (B, N−1)
    full = torch.cat([torch.ones_like(masks[:, :1]), masks], dim=1)
    bs = runner.solve(initial_states, goals, full,
                      mask_rows=runner.ego_masked_mask_rows(full))
    similarity = (bs.result.x[:, : DP_N * DP_HORIZON * 4] ** 2).mean()
    loss = 11.0 * similarity + 1.5 * masks.mean() + (0.5 - (0.5 - masks).abs()).mean()
    params = list(model.parameters())
    grads = torch.autograd.grad(loss, params)
    loss = loss.detach()
    if group is not None:
        size = torch.distributed.get_world_size(group)
        loss = all_reduce_sum(loss, group) / size
        grads = [all_reduce_sum(g, group) / size for g in grads]
    return loss, [p.detach() - DP_LR * g for p, g in zip(params, grads)], bs.result.status


def dp_task(*, weights, biases, histories, initial_states, goals, dtype="float32",
            device="cuda") -> dict:
    """One rank's part of the dp check: the step on this rank's rows of the
    batch (a 1-D batch mesh over every rank, contiguous shards) and then the
    same step on this rank alone over the whole batch. numpy results:
    ``loss``, ``params``, ``status`` (the shard's) and ``ref_loss``,
    ``ref_params``."""
    from ..convert import mlp_params_from_numpy
    from ..parallel.mesh import _shard_rows, make_batch_mesh

    dtype = getattr(torch, dtype)
    mesh = make_batch_mesh(device=device)
    runner = dp_runner(str(mesh.device))
    data = [torch.as_tensor(np.asarray(a)).to(device=mesh.device, dtype=dtype)
            for a in (histories, initial_states, goals)]
    out = {}
    for tag, group, rows in (("", mesh.groups[0], lambda a: _shard_rows(a, mesh.size,
                                                                        mesh.coords[0])),
                             ("ref_", None, lambda a: a)):
        model = mlp_params_from_numpy(weights, biases, device=mesh.device, dtype=dtype)
        loss, params, status = dp_training_step(runner, model, *(rows(a) for a in data),
                                                group=group)
        out[f"{tag}loss"] = float(loss)
        out[f"{tag}params"] = [p.cpu().numpy() for p in params]
        out[f"{tag}status"] = status.cpu().numpy()
    return out
