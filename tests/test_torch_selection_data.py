"""The player-selection data layer of the PyTorch port (``selection/data.py``,
``native/``, ``runner.generate_ground_truth``, ``selection/baselines.py``,
``analysis/metrics.py``) against the JAX package on the CPU, at N=2 and
horizon 4 (the sizes of ``tests/test_selection.py``).

Scenarios (either backend), data-loader batches, example files, baseline
masks and metrics match exactly. The ground truth solves in float32 in both
packages along the same iterates, so it keeps the same converged set and
its trajectories differ by rounding only: GT_TOL is ten times the largest
difference measured (2.4e-7 over four draws of 8 scenarios)."""

import functools
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcp_tpu.analysis import metrics as jax_metrics
import mcp_tpu.native as jax_native_mod
from mcp_tpu.native import generate_scenarios_native as jax_native
from mcp_tpu.selection import baselines as jax_baselines
from mcp_tpu.selection import data as jax_data
from mcp_tpu.selection import runner as jax_runner_mod
from mcp_tpu.selection.games import setup_road_environment as jax_road
from mcp_tpu.selection.games import setup_trajectory_game as jax_game
from mcp_tpu.selection.model import apply_mlp, init_mlp
from mcp_tpu_torch import native
from mcp_tpu_torch.analysis import metrics
from mcp_tpu_torch.convert import mlp_params_from_numpy
from mcp_tpu_torch.selection import (
    MODE_PARAMETERS_N4,
    DataLoader,
    Example,
    MaskedGameRunner,
    batch_arrays,
    generate_ground_truth,
    generate_scenarios,
    load_all_json_data,
    load_example,
    mask_computation,
    save_example,
    setup_road_environment,
    setup_trajectory_game,
)
from mcp_tpu_torch.selection.baselines import masks_from_ground_truth_dump
from mcp_tpu_torch.selection.evaluate import model_callable

torch.set_num_threads(1)

N, H = 2, 4
GT_TOL = 3e-6


# -- scenarios -------------------------------------------------------------


@pytest.mark.parametrize("players,seed,max_speed", [(2, 0, 0.0), (4, 3, 0.5), (6, 11, 1.0)])
def test_python_scenarios_equal_jax(players, seed, max_speed):
    kw = dict(num_scenarios=7, num_players=players, arena_half_width=3.0, max_speed=max_speed,
              seed=seed, backend="python")
    got, want = generate_scenarios(**kw), jax_data.generate_scenarios(**kw)
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.initial_states, w.initial_states)
        np.testing.assert_array_equal(g.goals, w.goals)
        assert g.sim_steps is None


def _jax_native_available():
    """The JAX package's loader, asked again if it cached a failure: it
    builds beside its source without a temporary file, so a test process
    that loads while another is still writing the library sees a failure."""
    if not jax_native_mod.native_available():
        jax_native_mod._BUILD_FAILED = False
    return jax_native_mod.native_available()


@pytest.mark.parametrize("players,seed,max_speed", [(2, 0, 0.0), (4, 7, 0.5), (10, 2, 0.0)])
def test_native_scenarios_equal_jax(players, seed, max_speed):
    assert _jax_native_available() and native.native_available()
    kw = dict(num_scenarios=40, num_players=players, arena_half_width=4.0,
              min_separation=1.0, max_speed=max_speed, seed=seed)
    got, want = native.generate_scenarios_native(**kw), jax_native(**kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    ported = generate_scenarios(num_scenarios=40, num_players=players, max_speed=max_speed,
                                seed=seed, backend="native")
    np.testing.assert_array_equal(np.stack([s.initial_states for s in ported]), want[0])
    np.testing.assert_array_equal(np.stack([s.goals for s in ported]), want[1])
    # "auto" takes the native sampler where it builds, as in the JAX package.
    auto = jax_data.generate_scenarios(num_scenarios=5, num_players=players, seed=seed)
    mine = generate_scenarios(num_scenarios=5, num_players=players, seed=seed)
    for g, w in zip(mine, auto):
        np.testing.assert_array_equal(g.initial_states, w.initial_states)
    d = np.linalg.norm(want[0][:, :, None, :2] - want[0][:, None, :, :2], axis=-1)
    assert (d + 1e9 * np.eye(players)).min() >= 1.0


def test_native_builds_under_build_dir_not_beside_the_source():
    native.load()
    path = native.library_path()
    assert path.parent == native.BUILD_DIR and path.parts[-3:-1] == ("build", "mcp_tpu_torch")
    assert path.exists() and not list(native.SOURCE.parent.glob("*.so"))


def test_native_backend_raises_when_the_build_fails(tmp_path, monkeypatch):
    bad = tmp_path / "scenario_gen.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        generate_scenarios(num_scenarios=2, num_players=2, backend="native")
    assert not native.native_available()
    # "auto" falls back to the python sampler.
    got = generate_scenarios(num_scenarios=2, num_players=3, seed=4)
    want = jax_data.generate_scenarios(num_scenarios=2, num_players=3, seed=4, backend="python")
    np.testing.assert_array_equal(got[1].goals, want[1].goals)
    with pytest.raises(ValueError, match="backend"):
        generate_scenarios(num_scenarios=1, num_players=2, backend="cpp")


def test_native_rejects_more_players_than_its_bound():
    with pytest.raises(ValueError, match="64"):
        generate_scenarios(num_scenarios=1, num_players=65, backend="native")
    assert len(generate_scenarios(num_scenarios=1, num_players=65, arena_half_width=40.0,
                                  min_separation=0.1)) == 1


# -- example files and batches --------------------------------------------


def _examples(k=5, seed=0):
    rng = np.random.default_rng(seed)
    return [Example(trajectories=rng.standard_normal((N, H, 4)).astype(np.float32),
                    ego_index=i % 2, initial_states=rng.standard_normal((N, 4)),
                    goals=rng.standard_normal((N, 2)), mask=np.ones(N)) for i in range(k)]


def _same_example(a, b):
    for k in ("trajectories", "initial_states", "goals", "mask"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    assert a.ego_index == b.ego_index


def test_example_files_interchange(tmp_path):
    exs = _examples()
    for i, ex in enumerate(exs):
        (save_example if i % 2 else jax_data.save_example)(
            str(tmp_path / f"simulation_results_{i}.json"), ex)
    for i, ex in enumerate(exs):
        path = str(tmp_path / f"simulation_results_{i}.json")
        _same_example(load_example(path), jax_data.load_example(path))
        _same_example(load_example(path), ex)
    mine, theirs = load_all_json_data(str(tmp_path)), jax_data.load_all_json_data(str(tmp_path))
    assert len(mine) == len(theirs) == len(exs)
    for a, b in zip(mine, theirs):
        _same_example(a, b)
        assert a.trajectories.dtype == np.float64


@pytest.mark.parametrize("size,batch,drop_last", [(10, 3, False), (10, 3, True), (7, 8, False)])
def test_dataloader_batches_equal_jax(size, batch, drop_last):
    data = list(range(size))
    mine = DataLoader(data, batch, seed=5, drop_last=drop_last)
    theirs = jax_data.DataLoader(data, batch, seed=5, drop_last=drop_last)
    for _ in range(3):
        assert list(mine) == list(theirs)
    assert len(mine) == len(theirs) and mine.seed == theirs.seed == 8


def test_batch_arrays_equal_jax_in_float32():
    exs = _examples(3, seed=1)
    got = batch_arrays(exs, device="cpu")
    want = jax_data.batch_arrays(exs)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# -- ground truth ------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _runners():
    jax_r = jax_runner_mod.MaskedGameRunner.create(
        jax_game(environment=jax_road(length=10.0), N=N), N=N, horizon=H)
    port = MaskedGameRunner.create(setup_trajectory_game(environment=setup_road_environment(
        length=10.0), N=N), N=N, horizon=H, device="cpu")
    return jax_r, port


@pytest.fixture(scope="module")
def ground_truth(tmp_path_factory):
    scenarios = generate_scenarios(num_scenarios=6, num_players=N, arena_half_width=3.0,
                                   seed=0, backend="python")
    # One unsolvable scenario: the two players start on top of each other.
    bad = scenarios[2]._replace(initial_states=np.tile(scenarios[2].initial_states[:1], (N, 1)))
    scenarios[2] = bad
    jax_r, port = _runners()
    d_jax, d_port = tmp_path_factory.mktemp("gt_jax"), tmp_path_factory.mktemp("gt_port")
    want = jax_runner_mod.generate_ground_truth(jax_r, scenarios, str(d_jax), batch_size=4)
    got = generate_ground_truth(port, scenarios, str(d_port), batch_size=4)
    return scenarios, want, got, d_jax, d_port


def test_ground_truth_keeps_the_jax_converged_set(ground_truth):
    _, want, got, d_jax, d_port = ground_truth
    assert sorted(os.listdir(d_port)) == sorted(os.listdir(d_jax))
    assert 3 <= len(got) == len(want) < 6
    assert "simulation_results_2.json" not in os.listdir(d_port)


def test_ground_truth_trajectories_match_jax(ground_truth):
    _, want, got, d_jax, d_port = ground_truth
    worst = 0.0
    for name in sorted(os.listdir(d_port)):
        a, b = load_example(str(d_port / name)), load_example(str(d_jax / name))
        np.testing.assert_array_equal(a.initial_states, b.initial_states)
        np.testing.assert_array_equal(a.mask, np.ones(N))
        assert a.trajectories.shape == (N, H, 4) and a.ego_index == 0
        worst = max(worst, float(np.abs(a.trajectories - b.trajectories).max()))
    assert worst <= GT_TOL
    for g in got:
        assert g.trajectories.dtype == np.float32


# -- baselines ---------------------------------------------------------------

NB, IH = 4, 10
CASES = [(mode, p) for mode, params in MODE_PARAMETERS_N4.items() for p in params]


@functools.lru_cache(maxsize=None)
def _scorers(isd):
    """The same random MLP weights as the JAX package's scorer (float32)
    and the port's (``model_callable`` of a carried ``MaskMLP``)."""
    import jax

    params = init_mlp(jax.random.PRNGKey(isd), NB * IH * isd, NB)
    ws = [np.asarray(w) for w in params.weights]
    bs = [np.asarray(b) for b in params.biases]
    mine = model_callable(mlp_params_from_numpy(ws, bs, device="cpu"))
    return mine, lambda x: np.asarray(apply_mlp(params, jnp.asarray(x, jnp.float32)))


def _histories(seed):
    """IH states of NB players, the last 2..IH of them as the flat histories
    (the evaluator's growing window), and each player's latest control."""
    rng = np.random.default_rng(seed)
    states = rng.uniform(-3, 3, (IH, NB, 4))
    steps = 2 + seed % (IH - 1)
    trajectory = [states[-steps:, i].reshape(-1) for i in range(NB)]
    controls = [rng.uniform(-1, 1, 2) for _ in range(NB)]
    return states, trajectory, controls


@pytest.mark.parametrize("mode,param", CASES, ids=[f"{m}-{p}" for m, p in CASES])
def test_mask_computation_equals_jax(mode, param):
    isd = 2 if "Partial" in mode else 4
    mine, theirs = _scorers(isd)
    for seed in range(12):
        states, trajectory, controls = _histories(seed)
        inp = np.concatenate([states[:, i, :isd].reshape(-1) for i in range(NB)])
        for sim_step in (1, 2, 11):
            got = mask_computation(inp, trajectory, controls, mode, sim_step, param, model=mine)
            want = jax_baselines.mask_computation(inp, trajectory, controls, mode, sim_step,
                                                  param, model=theirs)
            np.testing.assert_array_equal(got, want)
            assert got.shape == (NB - 1,) and set(np.unique(got)) <= {0.0, 1.0}


def test_baselines_tables_and_quirks_equal_jax():
    assert jax_baselines.MODES == tuple(__import__(
        "mcp_tpu_torch.selection.baselines", fromlist=["MODES"]).MODES)
    assert MODE_PARAMETERS_N4 == jax_baselines.MODE_PARAMETERS_N4
    _, trajectory, controls = _histories(3)
    with pytest.raises(ValueError, match="Invalid mode"):
        mask_computation(None, trajectory, controls, "Oracle", 1, 1)
    # A model of the wrong input size fails with the mode-family hint.
    with pytest.raises(ValueError, match="Partial"):
        mask_computation(np.zeros(3), trajectory, controls, "Neural Network Rank", 11, 2,
                         model=_scorers(4)[0])


def test_masks_from_ground_truth_dump_equals_jax(tmp_path):
    rng = np.random.default_rng(4)
    for k in range(4):
        p = tmp_path / f"simulation_results_{k}.json"
        p.write_text(json.dumps({"trajectories": rng.uniform(-6, 6, (5, 3, 4)).tolist(),
                                 "ego_index": k % 3}))
        for kw in ({}, {"threshold": 2.5, "num_neighbors": 2}, {"ego_index": 4}):
            got = masks_from_ground_truth_dump(str(p), **kw)
            want = jax_baselines.masks_from_ground_truth_dump(str(p), **kw)
            assert got.keys() == want.keys()
            for key in got:
                np.testing.assert_array_equal(got[key], want[key])


# -- metrics -----------------------------------------------------------------


def _result(rng, players, steps):
    out = {f"Player {i + 1} Trajectory": np.cumsum(rng.standard_normal((steps + 1, 4)),
                                                   axis=0).tolist() for i in range(players)}
    out["Player 1 Mask"] = rng.integers(0, 2, (steps, players)).astype(float).tolist()
    for m in out["Player 1 Mask"]:
        m[0] = 1.0
    return out


def test_analyze_result_equals_jax():
    rng = np.random.default_rng(9)
    for players, steps in ((2, 3), (4, 12), (3, 30)):
        res, ref = _result(rng, players, steps), _result(rng, players, steps)
        # num_players above the result's count: absent players are skipped.
        for kw in (dict(num_players=players), dict(num_players=players + 2, ref_result=ref)):
            assert metrics.analyze_result(res, **kw) == jax_metrics.analyze_result(res, **kw)
    a = rng.standard_normal(17)
    assert metrics.quantiles(a) == jax_metrics.quantiles(a)
    masks = [np.asarray(m) for m in res["Player 1 Mask"]]
    assert metrics.rate(masks) == jax_metrics.rate(masks)
    assert metrics.mask_sum(masks) == jax_metrics.mask_sum(masks)
