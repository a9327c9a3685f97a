"""The masked-game flagship shapes: N players on the circle-crossing road
scenario, all-ones masks, horizon 30, the reference's own timing workload
(N=4 gives blocks of b=40, N=10 of b=100; the JAX package's
``bench/flagships.py:10-14, 28``), the solver-in-the-loop training step
on it (``train_step_setup``, the JAX package's ``:62-118``), and that step
staged for a later process (``stage_train_step`` and
``load_staged_train_step``, the JAX package's ``:121-266``).

The initial-state noise is drawn from a ``torch.Generator``: it matches the
JAX package's draw in distribution, not in values.

Staging. The JAX package stages the traced program (``jax.export``) and the
exact inputs, so that a later process skips the game build, the
ground-truth solve and the trace. The port traces nothing; what a cold
setup pays before its first step is the game build's numeric probes (on the
CPU) and the ground-truth solve. So it stages, under
``utils.devices.persistent_cache_dir()/staged/``, the inputs as an ``.npz``
in the JAX package's keys and layout (``convert.train_inputs_to_numpy``)
and, with ``torch.save``, the probes' results (``trajectories.GameProbes``)
with the ``SolverOptions``, the ``TrainConfig`` and a fingerprint of the
build (``_build_fingerprint``). The loader rebuilds the game with those
probes injected and runs neither the probes nor the ground-truth solve; it
returns None, as when nothing is staged, when the fingerprint or the game's
dimensions no longer match, so that staged probes never meet a game that
today's code builds differently. The names start with ``torch_`` and end in
the seed and the dtype, so they never meet the JAX package's
``train_*.jaxexport``/``.npz`` in a shared ``MCPTPU_CACHE_DIR``.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import math
import os
import time
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from .._device import resolve_device


def _game(players: int):
    """The masked circle-crossing road game of ``players`` players."""
    from ..selection.games import setup_road_environment, setup_trajectory_game

    return setup_trajectory_game(environment=setup_road_environment(length=10.0), N=players)


def _new_runner(players: int, horizon: int, device, probes=None, options=None):
    from ..selection.runner import MaskedGameRunner

    return MaskedGameRunner.create(_game(players), N=players, horizon=horizon, device=device,
                                   probes=probes, options=options)


@functools.lru_cache(maxsize=None)
def _runner(players: int, horizon: int, device: str):
    return _new_runner(players, horizon, device)


def masked_game_setup(
    batch: int, players: int, horizon: int, *,
    generator: Optional[torch.Generator] = None, device="cuda", dtype=torch.float32,
):
    """The circle-crossing masked-game flagship: players start on a circle of
    radius 3 (plus 0.05·N(0,1) noise from ``generator``, a CPU generator;
    default seed 0) with goals at the antipodes. The game is built once per
    (players, horizon, device). Returns a namespace with runner, mcp, thetas
    (B, p), x0 (B, n), init (B, N, 4), goals (B, N, 2), masks (B, N)."""
    device = resolve_device(device)
    runner = _runner(players, horizon, str(device))
    generator = torch.Generator().manual_seed(0) if generator is None else generator
    ang = torch.arange(players, dtype=torch.float64) * (2 * math.pi / players)
    base = torch.stack([3.0 * torch.cos(ang), 3.0 * torch.sin(ang)], dim=1)
    init = torch.cat([base, torch.zeros(players, 2, dtype=torch.float64)], dim=1)
    init = init.expand(batch, players, 4) + 0.05 * torch.randn(
        batch, players, 4, generator=generator, dtype=torch.float64
    )
    init = init.to(device=device, dtype=dtype)
    goals = (-base).expand(batch, players, 2).to(device=device, dtype=dtype)
    masks = torch.ones((batch, players), dtype=dtype, device=device)
    thetas = runner.pack_thetas(init, goals, masks[:, None, :].expand(batch, players, players))
    return SimpleNamespace(
        runner=runner,
        mcp=runner.parametric_game.mcp,
        thetas=thetas,
        x0=runner.cold_starts(init),
        init=init,
        goals=goals,
        masks=masks,
    )


def train_step_setup(
    batch: int = 8,
    players: int = 4,
    horizon: int = 30,
    *,
    tier: str = "tridiag",
    polish: bool = True,
    seed: int = 0,
    device="cuda",
    dtype=torch.float32,
):
    """The solver-in-the-loop training-step flagship (N=4, horizon 30, batch
    8 by default): the masked game of ``masked_game_setup`` (θ noise from
    ``seed``) on Newton tier ``tier`` with the banded IFT
    (``sensitivity_solver="tridiag"``), tightening rate max(auto, 0.05)
    (partial-mask games need the faster anneal), the terminal polish, the
    all-ones-mask solve as ground truth and the MLP initialized from a
    generator seeded 3. Returns a namespace
    with train_step, eval_step, sgd_update, config, runner, model,
    trajectories, init, goals, gt (the ground-truth BatchSolution),
    gt_success, rate and seconds (host clock: "game", the game's setup, and
    "ground_truth", its solve, ending in a synchronize)."""
    from ..selection.model import MaskMLP, input_size
    from ..selection.train import TrainConfig, make_train_step
    from ..solver import SolverOptions, auto_tightening_rate

    t0 = time.perf_counter()
    device = resolve_device(device)
    s = masked_game_setup(batch, players, horizon, device=device, dtype=dtype,
                          generator=torch.Generator().manual_seed(seed))
    rate = max(auto_tightening_rate(s.mcp), 0.05)
    runner = dataclasses.replace(
        s.runner,
        options=SolverOptions(linear_solver=tier, sensitivity_solver="tridiag",
                              tightening_rate=rate, polish=polish),
    )
    config = TrainConfig(num_players=players, horizon=horizon, batch_size=batch)
    train_step, eval_step, sgd_update = make_train_step(runner, config)
    t1 = time.perf_counter()
    gt = runner.solve(s.init, s.goals, torch.ones_like(s.masks))
    gt_success = float((gt.result.status == 0).double().mean())
    t2 = time.perf_counter()
    model = MaskMLP(input_size(players, config.input_horizon, config.input_state_dim),
                    players, generator=torch.Generator().manual_seed(3), dtype=dtype,
                    device=s.thetas.device)
    return SimpleNamespace(
        train_step=train_step,
        eval_step=eval_step,
        sgd_update=sgd_update,
        config=config,
        runner=runner,
        model=model,
        trajectories=gt.trajectories,
        init=s.init,
        goals=s.goals,
        gt=gt,
        gt_success=gt_success,
        rate=rate,
        seconds={"game": t1 - t0, "ground_truth": t2 - t1},
    )


def train_artifact_paths(batch: int, players: int, horizon: int, tier: str, polish: bool,
                         dtype=torch.float32, seed: int = 0) -> tuple[str, str]:
    """(the ``torch.save`` file of the probes and options, the inputs'
    ``.npz``) under ``persistent_cache_dir()/staged/``."""
    from ..utils.devices import persistent_cache_dir

    tag = (f"torch_train_N{players}_T{horizon}_B{batch}_{tier}_p{int(polish)}_s{seed}_"
           f"{str(dtype).removeprefix('torch.')}")
    d = os.path.join(persistent_cache_dir(), "staged")
    return os.path.join(d, tag + ".pt"), os.path.join(d, tag + ".npz")


# The modules whose code makes what is staged: the game's definition and
# build (its dimensions, the time structure, the affine bands) and the
# masked runner.
_BUILD_SOURCES = ("games.py", "trajectories", "selection/games.py", "selection/runner.py",
                  "kernels/block_tridiag.py")


def _build_fingerprint() -> str:
    """The sha256 of ``_BUILD_SOURCES`` (a directory: its ``.py`` files)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    h = hashlib.sha256()
    for rel in _BUILD_SOURCES:
        path = os.path.join(root, rel)
        files = ([os.path.join(path, f) for f in sorted(os.listdir(path)) if f.endswith(".py")]
                 if os.path.isdir(path) else [path])
        for f in files:
            h.update(os.path.relpath(f, root).encode())
            with open(f, "rb") as fh:
                h.update(fh.read())
    return h.hexdigest()


def stage_train_step(
    batch: int = 8,
    players: int = 4,
    horizon: int = 30,
    *,
    tier: str = "tridiag",
    polish: bool = True,
    seed: int = 0,
    device="cuda",
    dtype=torch.float32,
):
    """Build the training-step flagship (``train_step_setup``) and stage it
    for ``load_staged_train_step`` (``train_artifact_paths``): the inputs
    before any step, the built game's probe results, the options, the
    config and the build's fingerprint with the game's dimensions. Returns
    the setup, its ``seconds`` with "write" added (host clock), and
    ``paths``."""
    from ..convert import train_inputs_to_numpy

    s = train_step_setup(batch, players, horizon, tier=tier, polish=polish, seed=seed,
                         device=device, dtype=dtype)
    t0 = time.perf_counter()
    pg = s.runner.parametric_game
    structure, ab = pg.mcp.time_structure, pg.mcp.affine_bands
    pt_path, npz_path = train_artifact_paths(batch, players, horizon, tier, polish, dtype, seed)
    os.makedirs(os.path.dirname(pt_path), exist_ok=True)
    torch.save({
        "fingerprint": _build_fingerprint(),
        "dims": repr(pg.dims),
        "structure": None if structure is None else structure._asdict(),
        "affine_bands": None if ab is None else {
            k: None if v is None else v.cpu() for k, v in ab._asdict().items()},
        "options": dataclasses.asdict(s.runner.options),
        "config": dataclasses.asdict(s.config),
    }, pt_path)
    np.savez(npz_path, **train_inputs_to_numpy(s.model, s.trajectories, s.init, s.goals,
                                               s.rate, s.gt_success))
    s.seconds["write"] = time.perf_counter() - t0
    s.paths = (pt_path, npz_path)
    return s


def load_staged_train_step(
    batch: int = 8,
    players: int = 4,
    horizon: int = 30,
    *,
    tier: str = "tridiag",
    polish: bool = True,
    seed: int = 0,
    device="cuda",
    dtype=torch.float32,
):
    """The staged training step (``stage_train_step``) without the game
    build's probes and without the ground-truth solve: the game rebuilt
    with the staged probes, the staged options and config, the inputs and
    the MLP as they were before the first step. Returns a namespace with
    train_step, eval_step, sgd_update, config, runner, model, trajectories,
    init, goals, gt_success, rate and seconds ({"load": host seconds}), or
    None when nothing is staged for these arguments, or when what is staged
    came from other code (``_build_fingerprint``) or another game (its
    dimensions, the time structure's length)."""
    from ..convert import (affine_bands_from_numpy, time_structure_from_numpy,
                           train_inputs_from_numpy)
    from ..selection.train import TrainConfig, make_train_step
    from ..solver import SolverOptions
    from ..trajectories import GameProbes

    pt_path, npz_path = train_artifact_paths(batch, players, horizon, tier, polish, dtype, seed)
    if not (os.path.exists(pt_path) and os.path.exists(npz_path)):
        return None
    t0 = time.perf_counter()
    device = resolve_device(device)
    meta = torch.load(pt_path, weights_only=True)
    if meta.get("fingerprint") != _build_fingerprint():
        return None
    probes = GameProbes(
        None if meta["structure"] is None else time_structure_from_numpy(meta["structure"]),
        None if meta["affine_bands"] is None else affine_bands_from_numpy(
            meta["affine_bands"], device="cpu"),
    )
    options = SolverOptions(**meta["options"])
    config = TrainConfig(**meta["config"])
    runner = _new_runner(players, horizon, device, probes, options)
    mcp = runner.parametric_game.mcp
    if repr(runner.parametric_game.dims) != meta["dims"] or (
            probes.structure is not None
            and len(probes.structure.permutation) != mcp.unconstrained_dimension):
        return None
    with np.load(npz_path) as data:
        inputs = train_inputs_from_numpy(data, device=device, dtype=dtype)
    train_step, eval_step, sgd_update = make_train_step(runner, config)
    return SimpleNamespace(
        train_step=train_step,
        eval_step=eval_step,
        sgd_update=sgd_update,
        config=config,
        runner=runner,
        model=inputs.model,
        trajectories=inputs.trajectories,
        init=inputs.init,
        goals=inputs.goals,
        gt_success=inputs.gt_success,
        rate=options.tightening_rate,
        seconds={"load": time.perf_counter() - t0},
    )
