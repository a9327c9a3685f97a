"""The staged training step of the PyTorch port (``bench/flagships.py``:
``stage_train_step``, ``load_staged_train_step``; ``convert.py``'s staged
inputs) and the ``"dcp"`` checkpoint backend (``selection/train.py``), on
the CPU at N=2, horizon 10, batch 2, float64.

The staged inputs use the JAX package's ``.npz`` keys and layout
(``mcp_tpu/bench/flagships.py:194-204``), so they are held against an
``.npz`` written the JAX package's way; the JAX package's own staging is not
run here (its export of the traced step takes about a minute on the CPU).
The DCP directory is held against the pickle and against the JAX package's
Orbax directory of the same weights. Everything compares bit for bit, except
the MLP's outputs against the JAX package's (another summation order):
within 1e-12."""

import os
import shutil
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcp_tpu.bench.flagships import _train_artifact_paths as jax_artifact_paths
from mcp_tpu.selection.model import apply_mlp, init_mlp, input_size
from mcp_tpu_torch.bench import flagships
from mcp_tpu_torch.convert import mlp_leaves, mlp_params_from_numpy, train_inputs_from_numpy
from mcp_tpu_torch.selection import TrainConfig, load_checkpoint, save_checkpoint
from mcp_tpu_torch.selection import runner as runner_mod
from mcp_tpu_torch.selection.train import load_dcp_weights
from mcp_tpu_torch.trajectories import game_builder

torch.set_num_threads(2)

B, N, H, TIER = 2, 2, 10, "tridiag_pallas"
F64 = torch.float64
JAX_KEYS = {"trajectories", "init", "goals", "rate", "gt_success"}


@pytest.fixture(scope="module")
def staged(tmp_path_factory):
    """Stage the step in a fresh cache directory, then set up the same step
    afresh (``train_step_setup``, probes and ground truth run again) and
    take its first step."""
    mp = pytest.MonkeyPatch()
    mp.setenv("MCPTPU_CACHE_DIR", str(tmp_path_factory.mktemp("cache")))
    try:
        stage = flagships.stage_train_step(B, N, H, tier=TIER, device="cpu", dtype=F64)
        fresh = flagships.train_step_setup(B, N, H, tier=TIER, device="cpu", dtype=F64)
        step = fresh.train_step(fresh.model, fresh.trajectories, fresh.init, fresh.goals)
        yield SimpleNamespace(stage=stage, fresh=fresh, step=step)
    finally:
        mp.undo()


def _load():
    return flagships.load_staged_train_step(B, N, H, tier=TIER, device="cpu", dtype=F64)


def test_staged_round_trip_steps_bit_equal_to_a_fresh_setup(staged):
    """The loaded step's loss, per-example losses, status and gradients
    equal the fresh setup's first step bit for bit, from the same inputs,
    weights, options and time structure."""
    s, fresh = _load(), staged.fresh
    assert s.config == fresh.config and s.runner.options == fresh.runner.options
    assert s.rate == fresh.rate and s.gt_success == fresh.gt_success == 1.0
    assert (s.runner.parametric_game.mcp.time_structure
            == fresh.runner.parametric_game.mcp.time_structure)
    for a, b in ((s.trajectories, fresh.trajectories), (s.init, fresh.init),
                 (s.goals, fresh.goals), *zip(s.model.parameters(), fresh.model.parameters())):
        assert a.dtype == b.dtype == F64 and torch.equal(a, b)
    loss, (per_example, status), grads = s.train_step(s.model, s.trajectories, s.init, s.goals)
    f_loss, (f_per_example, f_status), f_grads = staged.step
    assert torch.equal(loss, f_loss) and torch.equal(per_example, f_per_example)
    assert torch.equal(status, f_status) and status.tolist() == [0] * B
    assert len(grads) == len(f_grads) == 8
    assert all(torch.equal(g, f) for g, f in zip(grads, f_grads))
    assert all(bool(torch.isfinite(g).all()) and bool(g.abs().max() > 0) for g in grads)


def test_loader_runs_neither_the_probes_nor_the_ground_truth_solve(staged, monkeypatch):
    """With every probe and every solve counted, loading builds the game
    without a probe and solves nothing; the same counters see a cold build's
    probes."""
    calls = {"probes": 0, "solve": 0}

    def counted(fn, key):
        def wrapper(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return wrapper

    for name in ("probe_game", "validate_time_structure", "build_row_time_structure"):
        monkeypatch.setattr(game_builder, name, counted(getattr(game_builder, name), "probes"))
    monkeypatch.setattr(runner_mod, "solve_batch", counted(runner_mod.solve_batch, "solve"))
    monkeypatch.setattr(runner_mod.MaskedGameRunner, "solve",
                        counted(runner_mod.MaskedGameRunner.solve, "solve"))
    s = _load()
    assert calls == {"probes": 0, "solve": 0}
    assert s.runner.parametric_game.mcp.time_structure.row_permutation is not None
    flagships._new_runner(N, H, "cpu")
    assert calls["probes"] == 3 and calls["solve"] == 0


def test_nothing_staged_gives_none(staged, monkeypatch, tmp_path):
    """None for arguments nothing was staged for (another tier, dtype or
    seed), and in an empty cache."""
    assert flagships.load_staged_train_step(B, N, H, tier="tridiag", device="cpu",
                                            dtype=F64) is None
    assert flagships.load_staged_train_step(B, N, H, tier=TIER, device="cpu") is None
    assert flagships.load_staged_train_step(B, N, H, tier=TIER, seed=1, device="cpu",
                                            dtype=F64) is None
    monkeypatch.setenv("MCPTPU_CACHE_DIR", str(tmp_path))
    assert _load() is None


@pytest.mark.parametrize("change", ["sources", "fingerprint", "dims", "permutation"])
def test_staged_files_of_other_code_or_another_game_give_none(staged, monkeypatch, tmp_path,
                                                              change):
    """A staged step made by other code (the sources that build the game,
    or the fingerprint stored with it) or for another game (its dimensions,
    the time structure's length) loads as None, as when nothing is staged,
    so the caller sets the step up afresh; the unchanged copy loads."""
    monkeypatch.setenv("MCPTPU_CACHE_DIR", str(tmp_path))
    pt, npz = flagships.train_artifact_paths(B, N, H, TIER, True, F64)
    os.makedirs(os.path.dirname(pt))
    for src, dst in zip(staged.stage.paths, (pt, npz)):
        shutil.copy(src, dst)
    assert _load() is not None
    meta = torch.load(pt, weights_only=True)
    if change == "sources":
        monkeypatch.setattr(flagships, "_BUILD_SOURCES", flagships._BUILD_SOURCES[:-1])
    elif change == "fingerprint":
        meta["fingerprint"] = "0" * 64
    elif change == "dims":
        meta["dims"] = meta["dims"].replace("shared_mu=", "shared_mu=1")
    else:
        meta["structure"]["permutation"] = meta["structure"]["permutation"][:-1]
    torch.save(meta, pt)
    assert _load() is None


def test_artifact_names_never_meet_the_jax_packages(staged, monkeypatch, tmp_path):
    """Under one MCPTPU_CACHE_DIR both packages stage into the same
    ``staged/`` directory under names that never meet, for every tier,
    polish flag and dtype; the JAX package's files beside the port's leave
    the port's loader as it was."""
    monkeypatch.setenv("MCPTPU_CACHE_DIR", str(tmp_path))
    mine, theirs = set(), set()
    for tier in ("tridiag", "tridiag_pallas", "tridiag_auto"):
        for polish in (True, False):
            theirs.update(jax_artifact_paths(B, N, H, tier, polish))
            for dtype in (torch.float32, F64):
                mine.update(flagships.train_artifact_paths(B, N, H, tier, polish, dtype))
    assert {os.path.dirname(p) for p in mine | theirs} == {str(tmp_path / "staged")}
    assert len(mine) == 24 and len(theirs) == 12 and not mine & theirs
    monkeypatch.undo()
    for path in jax_artifact_paths(B, N, H, TIER, True):
        with open(path, "wb") as f:
            f.write(b"not the port's")
    s = _load()
    assert all(torch.equal(a, b) for a, b in zip(s.model.parameters(),
                                                 staged.fresh.model.parameters()))


def test_the_port_reads_a_jax_layout_npz_and_writes_one(staged, tmp_path):
    """An ``.npz`` written as the JAX package stages one (``init_mlp``,
    ``jax.tree_util.tree_flatten``, its keys) loads into the port with the
    JAX weights exactly and the same MLP outputs within 1e-12; the port's
    own staged ``.npz`` has the same keys and leaves a JAX loader unflattens
    into the port's weights."""
    in_size = input_size(N, 10, 2)
    params = init_mlp(jax.random.PRNGKey(3), in_size, N, dtype=jnp.float64)
    flat, treedef = jax.tree_util.tree_flatten(params)
    fresh = staged.fresh
    path = tmp_path / "train.npz"
    np.savez(path, trajectories=fresh.trajectories.numpy(), init=fresh.init.numpy(),
             goals=fresh.goals.numpy(), rate=np.float32(fresh.rate),
             gt_success=np.float32(fresh.gt_success),
             **{f"param_{i}": np.asarray(p) for i, p in enumerate(flat)})
    with np.load(path) as data:
        got = train_inputs_from_numpy(data, device="cpu", dtype=F64)
    assert [np.array_equal(a, np.asarray(b)) for a, b in zip(mlp_leaves(got.model), flat)] \
        == [True] * len(flat)
    assert torch.equal(got.init, fresh.init) and torch.equal(got.goals, fresh.goals)
    assert got.rate == np.float32(fresh.rate) and got.gt_success == fresh.gt_success
    x = np.random.default_rng(0).standard_normal((3, in_size))
    ours = got.model(torch.from_numpy(x)).detach().numpy()
    theirs = np.asarray(jax.jit(jax.vmap(apply_mlp, (None, 0)))(params, x))
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-12)

    with np.load(staged.stage.paths[1]) as data:
        assert set(data.files) == JAX_KEYS | {f"param_{i}" for i in range(len(flat))}
        assert data["rate"].dtype == data["gt_success"].dtype == np.float32
        back = jax.tree_util.tree_unflatten(
            treedef, [jnp.asarray(data[f"param_{i}"]) for i in range(len(flat))])
    for w, b, layer in zip(back.weights, back.biases, staged.fresh.model.layers):
        assert np.array_equal(np.asarray(w), layer.weight.detach().numpy())
        assert np.array_equal(np.asarray(b), layer.bias.detach().numpy())


def test_dcp_checkpoint_equals_the_pickle_and_the_jax_orbax_directory(tmp_path):
    """The same float32 weights through the JAX package's
    ``save_checkpoint(..., backend="orbax")`` (restored with Orbax's
    ``StandardCheckpointer``) and the port's ``backend="dcp"`` (the DCP
    directory and the pickle beside it): all bit-equal. "orbax" still
    raises here, naming "dcp"."""
    import orbax.checkpoint as ocp

    from mcp_tpu.selection.train import TrainConfig as JaxTrainConfig
    from mcp_tpu.selection.train import save_checkpoint as jax_save

    params = init_mlp(jax.random.PRNGKey(5), input_size(N, 10, 2), N)
    jax_path = str(tmp_path / "jax" / "model.pkl")
    jax_save(jax_path, params, JaxTrainConfig(num_players=N), backend="orbax")
    restored = ocp.StandardCheckpointer().restore(os.path.abspath(jax_path) + ".orbax")

    model = mlp_params_from_numpy([np.asarray(w) for w in params.weights],
                                  [np.asarray(b) for b in params.biases], device="cpu")
    path = str(tmp_path / "port" / "model.pkl")
    save_checkpoint(path, model, TrainConfig(num_players=N), extra={"epoch": 1}, backend="dcp")
    weights, biases = load_dcp_weights(path + ".dcp")
    pickled, payload = load_checkpoint(path, device="cpu")
    from_dcp = mlp_params_from_numpy(weights, biases, device="cpu")
    assert payload["extra"] == {"epoch": 1}
    for i, layer in enumerate(model.layers):
        expect = (np.asarray(params.weights[i]), np.asarray(params.biases[i]))
        for got in ((weights[i].numpy(), biases[i].numpy()),
                    (np.asarray(restored["weights"][i]), np.asarray(restored["biases"][i])),
                    (payload["weights"][i], payload["biases"][i]),
                    (pickled.layers[i].weight.detach().numpy(),
                     pickled.layers[i].bias.detach().numpy()),
                    (from_dcp.layers[i].weight.detach().numpy(),
                     from_dcp.layers[i].bias.detach().numpy())):
            assert got[0].dtype == got[1].dtype == np.float32
            assert np.array_equal(got[0], expect[0]) and np.array_equal(got[1], expect[1])
    with pytest.raises(NotImplementedError, match="orbax.*dcp"):
        save_checkpoint(str(tmp_path / "o.pkl"), model, TrainConfig(), backend="orbax")
