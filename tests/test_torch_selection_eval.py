"""The closed-loop evaluation of the PyTorch port (``selection/evaluate.py``,
``subgame.py``, ``real_data.py``, ``analysis/metrics.analyze_result``) against
the JAX package on the CPU, at N=2 and horizon 4 (the real-data and subgame
games at horizon 3).

Both packages roll out in float32 along the same iterates, so masks,
statuses and file names match exactly and the states and controls differ by
rounding: STATE_TOL is ten times the largest difference measured (1.2e-7
over the rollouts below). The port's batched rollout equals its serial one
to the same bound."""

import functools
import json
import os

import jax
import numpy as np
import pytest
import torch

from mcp_tpu.selection import evaluate as jax_eval
from mcp_tpu.selection import real_data as jax_real
from mcp_tpu.selection import runner as jax_runner_mod
from mcp_tpu.selection import subgame as jax_subgame
from mcp_tpu.selection.games import setup_road_environment as jax_road
from mcp_tpu.selection.games import setup_trajectory_game as jax_game
from mcp_tpu.selection.model import init_mlp, input_size
from mcp_tpu_torch.analysis import analyze_result
from mcp_tpu_torch.convert import mlp_params_from_numpy
from mcp_tpu_torch.selection import (
    MaskedGameRunner,
    evaluate_modes,
    evaluate_scenario,
    evaluate_scenarios_batched,
    generate_scenarios,
    real_data,
    setup_road_environment,
    setup_trajectory_game,
    solve_subgames,
)

torch.set_num_threads(1)

N, H, IH = 2, 4, 2
STATE_TOL = 1.2e-6
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "ped")


@functools.lru_cache(maxsize=None)
def _runners():
    jax_r = jax_runner_mod.MaskedGameRunner.create(
        jax_game(environment=jax_road(length=10.0), N=N), N=N, horizon=H)
    port = MaskedGameRunner.create(setup_trajectory_game(environment=setup_road_environment(
        length=10.0), N=N), N=N, horizon=H, device="cpu")
    return jax_r, port


@functools.lru_cache(maxsize=None)
def _models():
    """The same random MLP (positions-only histories) in both packages."""
    params = init_mlp(jax.random.PRNGKey(5), input_size(N, IH, 2), N)
    model = mlp_params_from_numpy([np.asarray(w) for w in params.weights],
                                  [np.asarray(b) for b in params.biases], device="cpu")
    return params, model


def _same_result(got, want, players=N):
    assert got.keys() == want.keys()
    assert got["Player 1 Mask"] == want["Player 1 Mask"]
    assert got["Statuses"] == want["Statuses"]
    for i in range(1, players + 1):
        for key in ("Initial State", "Goal"):
            assert got[f"Player {i} {key}"] == want[f"Player {i} {key}"]
        for key in ("Trajectory", "Control"):
            g, w = np.asarray(got[f"Player {i} {key}"]), np.asarray(want[f"Player {i} {key}"])
            assert g.shape == w.shape and np.isfinite(g).all()
            np.testing.assert_allclose(g, w, rtol=0, atol=STATE_TOL)


def _scenarios(k, seed):
    return generate_scenarios(num_scenarios=k, num_players=N, arena_half_width=3.0, seed=seed,
                              backend="python")


def test_evaluate_scenario_matches_jax():
    jax_r, port = _runners()
    (scenario,) = _scenarios(1, 1)
    kw = dict(num_sim_steps=3, input_horizon=IH)
    got = evaluate_scenario(port, scenario, "Distance Threshold", 2.0, **kw)
    want = jax_eval.evaluate_scenario(jax_r, scenario, "Distance Threshold", 2.0, **kw)
    _same_result(got, want)
    assert len(got["Player 1 Trajectory"]) == 4 and got["Statuses"] == [0, 0, 0]


@pytest.fixture(scope="module")
def batched():
    """Three scenarios, the second recorded for 2 steps, rolled out batched
    in both packages and one by one in the port."""
    jax_r, port = _runners()
    s = _scenarios(3, 2)
    scenarios = [s[0], s[1]._replace(sim_steps=2), s[2]]
    kw = dict(num_sim_steps=4, input_horizon=IH)
    got = evaluate_scenarios_batched(port, scenarios, "Distance Threshold", 2.0, **kw)
    want = jax_eval.evaluate_scenarios_batched(jax_r, scenarios, "Distance Threshold", 2.0,
                                               **kw)
    serial = [evaluate_scenario(port, sc, "Distance Threshold", 2.0,
                                num_sim_steps=sc.sim_steps or 4, input_horizon=IH)
              for sc in scenarios]
    return scenarios, got, want, serial


@pytest.mark.parametrize("k", range(3))
def test_batched_rollout_matches_jax(batched, k):
    scenarios, got, want, _ = batched
    _same_result(got[k], want[k])
    steps = scenarios[k].sim_steps or 4
    assert len(got[k]["Player 1 Trajectory"]) == steps + 1
    assert len(got[k]["Player 1 Mask"]) == steps


@pytest.mark.parametrize("k", range(3))
def test_batched_rollout_equals_serial(batched, k):
    _, got, _, serial = batched
    _same_result(got[k], serial[k])


def test_batched_rollout_keeps_cold_rows_cold():
    """A row whose first solve fails restarts cold (the zero-input rollout,
    y0 = 1) while a SOLVED row warm-starts: the batched rollout equals the
    serial one. Two players on top of each other fail within the runner's
    8 outer iterations; the other scenario solves in 6-7."""
    import dataclasses

    _, port = _runners()
    port = dataclasses.replace(port, options=dataclasses.replace(port.options,
                                                                 max_outer_iters=8))
    good, bad = _scenarios(2, 4)
    bad = bad._replace(initial_states=np.tile(bad.initial_states[:1], (N, 1)))
    got = evaluate_scenarios_batched(port, [good, bad], "All", 1, num_sim_steps=2,
                                     input_horizon=IH)
    serial = [evaluate_scenario(port, sc, "All", 1, num_sim_steps=2, input_horizon=IH)
              for sc in (good, bad)]
    assert got[0]["Statuses"] == [0, 0] and got[1]["Statuses"][0] != 0
    for g, s in zip(got, serial):
        _same_result(g, s)


MODES = {"Distance Threshold": [2.0], "Neural Network Partial Rank": [2]}


@pytest.fixture(scope="module")
def swept(tmp_path_factory):
    """evaluate_modes over MODES (12 steps: the NN mode leaves its 10-step
    bootstrap) on two scenarios in both packages."""
    jax_r, port = _runners()
    params, model = _models()
    scenarios = _scenarios(2, 3)
    dirs = {k: tmp_path_factory.mktemp(k) for k in ("port", "jax")}
    kw = dict(num_sim_steps=12, input_horizon=IH, scenario_offset=5, verbose=False)
    evaluate_modes(port, scenarios, MODES, str(dirs["port"]), model=model, **kw)
    jax_eval.evaluate_modes(jax_r, scenarios, MODES, str(dirs["jax"]), model_params=params, **kw)
    return dirs


def test_evaluate_modes_writes_the_jax_files(swept):
    names = sorted(os.listdir(swept["port"]))
    assert names == sorted(os.listdir(swept["jax"]))
    assert names == sorted(f"receding_horizon_trajectories_[{sid}]_[{mode}]_[{p}].json"
                           for sid in (5, 6) for mode, ps in MODES.items() for p in ps)


@pytest.mark.parametrize("mode", list(MODES))
def test_evaluate_modes_matches_jax(swept, mode):
    for sid in (5, 6):
        name = f"receding_horizon_trajectories_[{sid}]_[{mode}]_[{MODES[mode][0]}].json"
        got, want = (json.loads((swept[k] / name).read_text()) for k in ("port", "jax"))
        _same_result(got, want)
        assert len(got["Player 1 Mask"]) == 12 and set(got["Statuses"]) == {0}
        m, w = analyze_result(got, num_players=N), analyze_result(want, num_players=N)
        assert m.keys() == w.keys()
        for k in m:
            assert abs(m[k] - w[k]) <= 1e-3 + STATE_TOL


def test_nn_mode_uses_the_model_after_its_bootstrap(swept):
    """Steps 1-10 of the NN mode take the nearest-neighbor bootstrap, steps
    11-12 the model's top pick, each on the recorded history."""
    from mcp_tpu_torch.selection import mask_computation
    from mcp_tpu_torch.selection.evaluate import model_callable

    scorer = model_callable(_models()[1])
    for sid in (5, 6):
        nn = json.loads((swept["port"] / f"receding_horizon_trajectories_[{sid}]_"
                                         "[Neural Network Partial Rank]_[2].json").read_text())
        hist = np.asarray([nn[f"Player {i + 1} Trajectory"] for i in range(N)])  # (N, 13, 4)
        for step in range(1, 13):
            window = hist[:, max(0, step - IH) : step]
            traj = [window[i].reshape(-1) for i in range(N)]
            inp = np.concatenate([window[i, :, :2].reshape(-1) for i in range(N)])
            want = (mask_computation(None, traj, [], "Nearest Neighbor", step, 2) if step <= 10
                    else mask_computation(inp, traj, [], "Neural Network Partial Rank", step, 2,
                                          model=scorer))
            assert nn["Player 1 Mask"][step - 1] == [1.0, *want.tolist()]


def test_model_callable_casts_to_the_model():
    from mcp_tpu_torch.selection.evaluate import model_callable

    params, _ = _models()
    model = mlp_params_from_numpy([np.asarray(w) for w in params.weights],
                                  [np.asarray(b) for b in params.biases], device="cpu",
                                  dtype=torch.float64)
    x = np.random.default_rng(0).standard_normal(input_size(N, IH, 2))
    out = model_callable(model)(x.astype(np.float32))
    assert isinstance(out, np.ndarray) and out.dtype == np.float64 and out.shape == (N - 1,)
    assert model_callable(None) is None


# -- subgames ----------------------------------------------------------------


def test_solve_subgames_matches_jax():
    """Players 1 and 3 in a joint two-player game, player 2 alone."""
    init = np.array([[-2.0, -1.0, 0.0, 0.0], [0.0, 2.0, 0.0, 0.0], [2.0, 1.0, 0.0, 0.0]],
                    np.float32)
    goals = np.array([[2.0, 1.5], [-2.0, -2.0], [-2.0, 0.5]], np.float32)
    mask = np.array([1, 0, 1])
    kw = dict(horizon=3, num_sim_steps=2, arena_length=7.0)
    got = solve_subgames(init, goals, mask, device="cpu", **kw)
    want = jax_subgame.solve_subgames(init, goals, mask, **kw)
    assert got.keys() == want.keys() and got["Mask"] == want["Mask"] == [1, 0, 1]
    for i in range(1, 4):
        for key in ("Initial State", "Goal"):
            assert got[f"Player {i} {key}"] == want[f"Player {i} {key}"]
        for key in ("Trajectory", "Control"):
            g, w = np.asarray(got[f"Player {i} {key}"]), np.asarray(want[f"Player {i} {key}"])
            assert g.shape == w.shape == ((3, 4) if key == "Trajectory" else (2, 2))
            np.testing.assert_allclose(g, w, rtol=0, atol=STATE_TOL)
    # An unselected player's solo plan does not depend on the others.
    moved = init.copy()
    moved[0, :2] = [-1.0, -2.0]
    other = solve_subgames(moved, goals, mask, device="cpu", **kw)
    assert other["Player 2 Trajectory"] == got["Player 2 Trajectory"]
    assert other["Player 1 Trajectory"] != got["Player 1 Trajectory"]


# -- real data ---------------------------------------------------------------


def test_ped_fixtures_and_converters_equal_jax(tmp_path):
    for players in (None, 2):
        got = real_data.load_scenario_dir(FIXTURES, num_players=players)
        want = jax_real.load_scenario_dir(FIXTURES, num_players=players)
        assert [s.sim_steps for s in got] == [s.sim_steps for s in want] == [30, 22, 18]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.initial_states, w.initial_states)
            np.testing.assert_array_equal(g.goals, w.goals)
    raw = os.path.join(FIXTURES, "raw", "scenario1.csv")
    got = real_data.convert_raw_csv(raw, str(tmp_path / "port.csv"), dt=0.1)
    want = jax_real.convert_raw_csv(raw, str(tmp_path / "jax.csv"), dt=0.1)
    np.testing.assert_array_equal(got.initial_states, want.initial_states)
    assert got.sim_steps == want.sim_steps
    assert (tmp_path / "port.csv").read_text() == (tmp_path / "jax.csv").read_text()
    walk = np.cumsum(np.random.default_rng(2).standard_normal((6, 3, 2)), axis=0) + 20.0
    g, w = real_data.convert_recording(walk, dt=0.2), jax_real.convert_recording(walk, dt=0.2)
    np.testing.assert_array_equal(g.initial_states, w.initial_states)
    np.testing.assert_array_equal(g.goals, w.goals)
    with pytest.raises(ValueError):
        real_data.convert_recording(np.zeros((1, 2, 2)))
    assert real_data.REAL_BOUNDS == jax_real.REAL_BOUNDS


def test_real_data_sweep_matches_jax(tmp_path):
    """Two fixtures (their first two players), recorded for 3 and 2 steps:
    each rollout trimmed to its own length, the files and results of the
    JAX package's sweep."""
    s = real_data.load_scenario_dir(FIXTURES, num_players=N)
    scenarios = [s[0]._replace(sim_steps=3), s[2]._replace(sim_steps=2)]
    kw = dict(N=N, horizon=3, num_sim_steps=99, input_horizon=IH, scenario_offset=1,
              verbose=False)
    real_data.evaluate_real_scenarios(scenarios, {"Distance Threshold": [2.0]},
                                      str(tmp_path / "port"), device="cpu", **kw)
    jax_real.evaluate_real_scenarios(scenarios, {"Distance Threshold": [2.0]},
                                     str(tmp_path / "jax"), **kw)
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) == [
        f"trajectories_[{sid}]_[Distance Threshold]_[2.0].json" for sid in (1, 2)]
    for name, steps in zip(names, (3, 2)):
        got, want = (json.loads((tmp_path / k / name).read_text()) for k in ("port", "jax"))
        _same_result(got, want)
        assert len(got["Player 1 Trajectory"]) == steps + 1
    runner = real_data.make_real_runner(N=N, horizon=3, device="cpu")
    assert runner is real_data.make_real_runner(N=N, horizon=3, device="cpu")
    assert runner.N == N and runner.device.type == "cpu"
