"""The solver-in-the-loop training step of the PyTorch port
(``selection/{model,loss,train}.py``, ``bench/flagships.train_step_setup``)
against the JAX package's ``make_train_step``, in float64 on the CPU: the
same MLP weights (``convert.mlp_params_from_numpy``) and the same numpy
scenarios give the same loss and the same gradient of every weight and bias
(N=2, horizon 6, B=2, input horizon 2, tier "tridiag", banded IFT).

The two packages solve along the same iterates at tol 1e-4, so the loss and
gradients differ by rounding only: 1e-9 of the largest entry."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcp_tpu.bench.flagships import masked_game_setup as jax_setup
from mcp_tpu.selection.loss import composite_loss as jax_composite_loss
from mcp_tpu.selection.model import apply_mlp, init_mlp
from mcp_tpu.selection.model import input_size as jax_input_size
from mcp_tpu.selection.train import TrainConfig as JaxTrainConfig
from mcp_tpu.selection.train import make_train_step as jax_make_train_step
from mcp_tpu.solver import SolverOptions as JaxOptions
from mcp_tpu_torch import SolverOptions
from mcp_tpu_torch.bench.flagships import masked_game_setup, train_step_setup
from mcp_tpu_torch.convert import mlp_params_from_numpy
from mcp_tpu_torch.selection import (
    MaskMLP,
    TrainConfig,
    clamp_cotangent,
    composite_loss,
    input_size,
    make_train_step,
    prepare_input,
)

torch.set_num_threads(1)

B, N, H, IH = 2, 2, 6, 2
OPTS = dict(linear_solver="tridiag", sensitivity_solver="tridiag", tightening_rate=0.05,
            polish=True)
REL = 1e-9


def _scenarios():
    """Circle-crossing starts with noise, antipodal goals, and target plans
    that drift part of the way there (numpy, seed 0)."""
    rng = np.random.default_rng(0)
    ang = np.arange(N) * 2 * np.pi / N
    base = np.stack([3 * np.cos(ang), 3 * np.sin(ang)], 1)
    init = (np.concatenate([base, np.zeros((N, 2))], 1)[None].repeat(B, 0)
            + 0.05 * rng.standard_normal((B, N, 4)))
    goals = (-base)[None].repeat(B, 0)
    frac = np.linspace(0.0, 0.3, H)[None, None, :, None]
    trajs = np.zeros((B, N, H, 4))
    trajs[..., :2] = init[:, :, None, :2] * (1 - frac) + goals[:, :, None, :] * frac
    return trajs + 0.02 * rng.standard_normal(trajs.shape), init, goals


@functools.lru_cache(maxsize=None)
def _steps():
    trajs, init, goals = _scenarios()
    js = jax_setup(B, N, H)
    runner = dataclasses.replace(js.runner, options=JaxOptions(**OPTS))
    config = JaxTrainConfig(num_players=N, horizon=H, input_horizon=IH, batch_size=B)
    train_step, _, _ = jax_make_train_step(runner, config)
    params = init_mlp(jax.random.PRNGKey(3), jax_input_size(N, IH, 2), N, dtype=jnp.float64)
    loss, (per_example, status), grads = train_step(
        params, jnp.asarray(trajs), jnp.asarray(init), jnp.asarray(goals))
    want_grads = [np.asarray(a) for w, b in zip(grads.weights, grads.biases) for a in (w, b)]

    ts = masked_game_setup(B, N, H, device="cpu", dtype=torch.float64)
    port_runner = dataclasses.replace(ts.runner, options=SolverOptions(**OPTS))
    p_step, p_eval, p_sgd = make_train_step(
        port_runner, TrainConfig(num_players=N, horizon=H, input_horizon=IH, batch_size=B))
    model = mlp_params_from_numpy([np.asarray(w) for w in params.weights],
                                  [np.asarray(b) for b in params.biases],
                                  device="cpu", dtype=torch.float64)
    args = tuple(torch.from_numpy(a) for a in (trajs, init, goals))
    got = p_step(model, *args)
    return dict(jax=(float(loss), np.asarray(per_example), np.asarray(status), want_grads),
                port=got, model=model, args=args, eval=p_eval, sgd=p_sgd, params=params)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=REL * max(np.abs(want).max(), 1.0))


def test_train_step_loss_matches_jax():
    s = _steps()
    loss, per_example, status, _ = s["jax"]
    p_loss, (p_per, p_status), _ = s["port"]
    np.testing.assert_array_equal(p_status.numpy(), status)
    assert bool((p_status == 0).all())
    _close(p_per.numpy(), per_example)
    _close(float(p_loss), loss)
    # eval_step: the same loss, no graph.
    e_loss, _ = s["eval"](s["model"], *s["args"])
    assert not e_loss.requires_grad
    _close(float(e_loss), loss)


@pytest.mark.parametrize("leaf", range(8))
def test_train_step_gradient_matches_jax(leaf):
    """Each of the four layers' weight (out, in) and bias gradients."""
    s = _steps()
    want = s["jax"][3][leaf]
    got = s["port"][2][leaf].numpy()
    assert got.shape == want.shape
    assert np.abs(want).max() > 0
    _close(got, want)


def test_mlp_and_loss_match_jax():
    """The MLP forward, the input flattening and the composite loss on their
    own, at random inputs."""
    s = _steps()
    rng = np.random.default_rng(1)
    h = rng.standard_normal((3, jax_input_size(N, IH, 2)))
    want = np.asarray(jax.vmap(lambda v: apply_mlp(s["params"], v))(jnp.asarray(h)))
    _close(s["model"](torch.from_numpy(h)).detach().numpy(), want)
    trajs = rng.standard_normal((3, N, H, 4))
    assert prepare_input(torch.from_numpy(trajs), IH, 2).shape == (3, N * IH * 2)
    np.testing.assert_array_equal(prepare_input(torch.from_numpy(trajs[0]), IH, 2).numpy(),
                                  trajs[0][:, :IH, :2].reshape(-1))
    ego, target, mask = (rng.standard_normal((3, H, 4)), rng.standard_normal((3, H, 4)),
                         rng.random((3, N - 1)))
    want = np.asarray(jax.vmap(lambda e, t, m: jax_composite_loss(
        e, t, m, horizon=H, input_horizon=IH))(jnp.asarray(ego), jnp.asarray(target),
                                               jnp.asarray(mask)))
    got = composite_loss(torch.from_numpy(ego), torch.from_numpy(target),
                         torch.from_numpy(mask), horizon=H, input_horizon=IH)
    _close(got.numpy(), want)


def test_sgd_update_steps_every_parameter():
    s = _steps()
    model = mlp_params_from_numpy([np.asarray(w) for w in s["params"].weights],
                                  [np.asarray(b) for b in s["params"].biases],
                                  device="cpu", dtype=torch.float64)
    before = [p.detach().clone() for p in model.parameters()]
    grads = s["port"][2]
    s["sgd"](model, grads, 0.5)
    for p, p0, g in zip(model.parameters(), before, grads):
        torch.testing.assert_close(p.detach(), p0 - 0.5 * g, rtol=0, atol=1e-15)


def test_clamp_cotangent_clips_the_gradient_only():
    x = torch.tensor([0.2, 0.5, 0.9], dtype=torch.float64, requires_grad=True)
    y = clamp_cotangent(x)
    torch.testing.assert_close(y.detach(), x.detach(), rtol=0, atol=0)
    (g,) = torch.autograd.grad((y * torch.tensor([25.0, -3.0, -40.0], dtype=torch.float64)).sum(), x)
    assert g.tolist() == [10.0, -3.0, -10.0]


def test_mlp_init_is_glorot_uniform_from_the_generator():
    m1 = MaskMLP(input_size(4), 4, generator=torch.Generator().manual_seed(5), device="cpu")
    m2 = MaskMLP(input_size(4), 4, generator=torch.Generator().manual_seed(5), device="cpu")
    sizes = [(256, 80), (64, 256), (16, 64), (3, 16)]
    for layer, layer2, (o, i) in zip(m1.layers, m2.layers, sizes):
        assert tuple(layer.weight.shape) == (o, i)
        assert torch.equal(layer.weight, layer2.weight) and not bool(layer.bias.any())
        assert float(layer.weight.detach().abs().max()) <= (6.0 / (o + i)) ** 0.5


def test_pallas_tier_train_step_matches_tridiag():
    """The port's train step on tier "tridiag_pallas" (N=2, horizon 20:
    its route is the two-way sweep K7a, in the solve and in the IFT) equals
    its own step on "tridiag" (the plain LU block-Thomas) within 1e-8."""
    out = {}
    for tier in ("tridiag", "tridiag_pallas"):
        s = train_step_setup(2, 2, 20, tier=tier, device="cpu", dtype=torch.float64)
        assert s.gt_success == 1.0 and s.rate == 0.05
        out[tier] = s.train_step(s.model, s.trajectories, s.init, s.goals)
    (l1, (_, st1), g1), (l2, (_, st2), g2) = out["tridiag"], out["tridiag_pallas"]
    assert torch.equal(st1, st2)
    assert abs(float(l1) - float(l2)) <= 1e-8
    for a, b in zip(g1, g2):
        assert bool(torch.isfinite(b).all())
        torch.testing.assert_close(b, a, rtol=0, atol=1e-8)
