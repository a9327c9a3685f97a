"""The analysis suite of the PyTorch port against the JAX package's, on the
CPU: the plots' presets, radius map, legend names and metric aggregation
(and every figure written), the mask loss landscape (JAX's test shape, N=3,
horizon 3, grid 3, float32), the N-scaling harness, the band-only Newton
assembly (``block_tridiag.banded_newton_step``, float64), the device
helpers, and the four analysis CLIs in-process on a tiny data directory.
The figures need matplotlib, which this machine has; the CLIs' path without
it is held in tests/test_torch_imports.py."""

import dataclasses
import functools
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcp_tpu.analysis import mask_loss_landscape as jax_landscape
from mcp_tpu.analysis import plots as JP
from mcp_tpu.kernels.block_tridiag import banded_newton_step as jax_banded_step
from mcp_tpu.selection import MaskedGameRunner as JaxRunner
from mcp_tpu.selection import setup_road_environment as jax_road
from mcp_tpu.selection import setup_trajectory_game as jax_game
from mcp_tpu_torch import analysis as A
from mcp_tpu_torch import linalg
from mcp_tpu_torch.analysis import plots as TP
from mcp_tpu_torch.bench.flagships import masked_game_setup
from mcp_tpu_torch.kernels import _build
from mcp_tpu_torch.kernels.block_tridiag import banded_newton_step
from mcp_tpu_torch.selection import (
    Example,
    MaskedGameRunner,
    save_example,
    setup_road_environment,
    setup_trajectory_game,
)
from mcp_tpu_torch.utils import devices

torch.set_num_threads(1)


def _make_eval_result(num_players=4, steps=12, shift=0.0, mask_on=True):
    """A synthetic evaluation JSON in the reference's schema (the JAX
    package's tests/test_analysis.py:86-101)."""
    t = np.arange(steps, dtype=float)
    result = {}
    for pid in range(1, num_players + 1):
        traj = np.stack(
            [t * 0.1 + shift, np.full(steps, float(pid))] + [np.zeros(steps)] * 2, axis=1)
        result[f"Player {pid} Trajectory"] = traj.tolist()
        result[f"Player {pid} Control"] = np.zeros((steps, 2)).tolist()
        result[f"Player {pid} Initial State"] = traj[0].tolist()
        result[f"Player {pid} Goal"] = [1.0, float(pid)]
    mask = [1.0] + [1.0 if mask_on else 0.0] * (num_players - 1)
    result["Player 1 Mask"] = [mask] * steps
    return result


MODES = {"All": (1,), "Nearest Neighbor": (2,), "Neural Network Rank": (2,)}


@pytest.fixture(scope="module")
def eval_dir(tmp_path_factory):
    """Two scenarios of three (mode, parameter) runs each."""
    d = tmp_path_factory.mktemp("eval")
    for sid in (0, 1):
        for (mode, (param,)), on in zip(MODES.items(), (True, False, False)):
            path = d / f"receding_horizon_trajectories_[{sid}]_[{mode}]_[{param}].json"
            path.write_text(json.dumps(_make_eval_result(shift=0.1 * sid, mask_on=on)))
    return d


# -- plots ------------------------------------------------------------------------


def test_exports_equal_jax_and_entry_points_default_to_the_card():
    import mcp_tpu.analysis as JA

    from mcp_tpu_torch import dryrun

    assert sorted(A.__all__) == sorted(JA.__all__)
    assert all(hasattr(A, name) for name in JA.__all__)
    if not torch.cuda.is_available():
        for call in (dryrun.entry, lambda: dryrun.dryrun_multichip(2)):
            with pytest.raises(RuntimeError, match="cuda"):
                call()


def test_presets_radius_and_legend_names_equal_jax():
    assert {k: dataclasses.asdict(v) for k, v in TP.RADAR_PRESETS.items()} == {
        k: dataclasses.asdict(v) for k, v in JP.RADAR_PRESETS.items()}
    assert (TP.RADAR_INVERT_METRICS, TP.RADAR_MEAN_RADIUS) == (
        JP.RADAR_INVERT_METRICS, JP.RADAR_MEAN_RADIUS)
    ticks = {"min": 0.0, "mean": 2.0, "max": 10.0}
    for value in (-1.0, 0.0, 1.0, 2.0, 5.0, 10.0, 12.0):
        for invert in (False, True):
            assert TP._radius(value, ticks, invert) == JP._radius(value, ticks, invert)
    methods = [f"{m} [{p}]" for preset in JP.RADAR_PRESETS.values()
               for m, ps in preset.modes_with_params.items() for p in ps]
    for method in methods + ["Unknown Mode", "All"]:
        for keep in (False, True):
            assert TP._legend_name(method, keep_parameter=keep) == JP._legend_name(
                method, keep_parameter=keep)


def test_collect_mode_metrics_and_anchored_ticks_equal_jax(eval_dir, tmp_path):
    kw = dict(num_players=4, modes_with_params=MODES)
    got = A.collect_mode_metrics(str(eval_dir), **kw)
    assert got == JP.collect_mode_metrics(str(eval_dir), **kw)
    assert set(got) == {"All [1]", "Nearest Neighbor [2]", "Neural Network Rank [2]"}
    assert got["Nearest Neighbor [2]"]["Mask Sum"] == 1.0
    assert A.collect_mode_metrics(str(eval_dir), scenario_ids=[1, 5], **kw) == \
        JP.collect_mode_metrics(str(eval_dir), scenario_ids=[1, 5], **kw)
    for overrides in (None, {"Mask Sum": (1, 4), "Rate": (0, 1)}):
        ticks = A.radar_plot_anchored(got, str(tmp_path / "t.pdf"), tick_overrides=overrides)
        assert ticks == JP.radar_plot_anchored(got, str(tmp_path / "j.pdf"),
                                               tick_overrides=overrides)


def test_every_figure_and_the_gif_are_written(eval_dir, tmp_path):
    metrics = {"All [1]": {"Smoothness": 0.1, "Length": 5.0, "Safety": 2.0},
               "NN [2]": {"Smoothness": 0.2, "Length": 4.0, "Safety": 1.5}}
    A.radar_plot(metrics, str(tmp_path / "radar.png"))
    A.time_scaling_plot([2, 3, 4], [0.1, 0.4, 1.0], str(tmp_path / "time.png"))
    A.loss_curves_plot({"train_loss": [1.0, 0.5], "val_loss": []}, str(tmp_path / "loss.png"))
    g = np.linspace(0, 1, 3)
    A.loss_landscape_plot(g[None, :].repeat(3, 0), g[:, None].repeat(3, 1), np.ones((3, 3)),
                          str(tmp_path / "landscape.png"))
    A.paper_trajectory_grid([_make_eval_result(), _make_eval_result(mask_on=False)],
                            ["All", "NN Rank"], str(tmp_path / "grid.pdf"),
                            step_indices=(3, 6, 9), step_dt=0.1)
    preset = A.RadarPreset(num_players=4, file_prefix="receding_horizon_trajectories",
                           modes_with_params=MODES,
                           option_groups={"ranking2": frozenset({"All [1]",
                                                                 "Nearest Neighbor [2]"})},
                           tick_overrides={"Rate": (0, 1)})
    written = A.radar_report(str(eval_dir), str(tmp_path / "figs"), preset=preset)
    A.animate_result(_make_eval_result(steps=5), str(tmp_path / "anim.gif"), num_players=4)
    paths = [tmp_path / n for n in ("radar.png", "time.png", "loss.png", "landscape.png",
                                    "grid.pdf", "anim.gif")] + list(written.values())
    for path in paths:
        assert os.path.getsize(path) > 1000, path
    with pytest.raises(FileNotFoundError):
        A.radar_report(str(tmp_path), str(tmp_path / "none"), preset="n4")


# -- experiments -------------------------------------------------------------------

LANDSCAPE_INIT = [[-1.0, 0, 0, 0], [1.0, 0, 0, 0], [0.0, 1.5, 0, 0]]
LANDSCAPE_GOALS = [[1.0, 0], [-1.0, 0], [0.0, -1.5]]


@functools.lru_cache(maxsize=None)
def _landscapes():
    """Both packages' landscape at the JAX test's shape (N=3, horizon 3,
    grid 3, input horizon 2, target plan 0, float32 inputs)."""
    N, T = 3, 3
    init = np.asarray(LANDSCAPE_INIT, np.float32)
    goals = np.asarray(LANDSCAPE_GOALS, np.float32)
    target = np.zeros((T, 4), np.float32)
    jr = JaxRunner.create(jax_game(environment=jax_road(length=10.0), N=N), N=N, horizon=T)
    want = jax_landscape(jr, jnp.asarray(init), jnp.asarray(goals), jnp.asarray(target),
                         grid_points=3, input_horizon=2)
    tr = MaskedGameRunner.create(setup_trajectory_game(
        environment=setup_road_environment(length=10.0), N=N), N=N, horizon=T, device="cpu")
    got = A.mask_loss_landscape(tr, init, goals, torch.from_numpy(target), grid_points=3,
                                input_horizon=2)
    return got, want


def test_mask_loss_landscape_matches_jax():
    got, want = _landscapes()
    for k in ("grid_x", "grid_y"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
        assert got[k].dtype == np.float32
    np.testing.assert_array_equal(got["statuses"], want["statuses"])
    assert got["losses"].shape == (3, 3) and np.isfinite(got["losses"]).all()
    # Both solve the same nine float32 games on the same tier: measured
    # max|Δ loss| = 0 (bit-equal) on losses of 11-12.5; held to 10 float32
    # ulps of the largest loss, room for another CPU's rounding.
    atol = 10 * np.spacing(np.float32(np.abs(want["losses"]).max()))
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=0, atol=atol)


def test_n_scaling_experiment_on_the_cpu(capsys):
    results = A.n_scaling_experiment((2,), horizon=3, repeats=1, device="cpu")
    assert list(results) == [2] and results[2] > 0
    assert capsys.readouterr().out.startswith("N=2: ")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            A.n_scaling_experiment((2,), horizon=3)


# -- the band-only Newton assembly ------------------------------------------------


@functools.lru_cache(maxsize=None)
def _masked_jacobians():
    """The port's masked N=2 game (horizon 3), its Jacobians at a seeded
    iterate and a seeded residual (float64). The JAX package's step reads
    the same time structure (the two packages' structures are equal,
    tests/test_torch_masked.py), so no JAX game is built here."""
    ts = masked_game_setup(1, 2, 3, device="cpu", dtype=torch.float64)
    mcp = ts.mcp
    n, m = mcp.unconstrained_dimension, mcp.constrained_dimension
    rng = np.random.default_rng(7)
    x = 0.3 * rng.standard_normal(n)
    y, s = rng.uniform(0.5, 2.0, m), rng.uniform(0.5, 2.0, m)
    r = (rng.standard_normal(n), rng.standard_normal(m), rng.standard_normal(m))
    jac = tuple(a.numpy() for a in mcp.gh_jacobians(torch.from_numpy(x), torch.from_numpy(y),
                                                     ts.thetas[0]))
    return mcp.time_structure, jac, (y, s, *r)


@pytest.mark.parametrize("algorithm", ["thomas", "cr"])
def test_banded_newton_step_matches_jax_and_the_dense_path(algorithm):
    st_t, (Gx, Gy, Hx, Hy), (y, s, rG, rH, rC) = _masked_jacobians()
    assert st_t.row_permutation is not None and Gx.shape == (60, 60)
    reg = 1e-4
    want = jax_banded_step(*(jnp.asarray(a) for a in (Gx, Gy, Hx, y, s, rG, rH, rC)), reg,
                           st_t, algorithm=algorithm)
    t = lambda a: torch.from_numpy(np.array(a))[None]
    got = banded_newton_step(*(t(a) for a in (Gx, Gy, Hx, y, s, rG, rH, rC)), reg, st_t,
                             algorithm=algorithm)
    # The dense Schur system permuted to bands: the same step, assembled
    # with one (n, m)·(m, n) product.
    dense = linalg.newton_step_tridiag(
        *(t(a) for a in (Gx, Gy, Hx, Hy, y, s, rG, rH, rC)), reg,
        structure=st_t._replace(row_permutation=None, rows_per_block=0), algorithm=algorithm)
    routed = linalg.newton_step_tridiag(*(t(a) for a in (Gx, Gy, Hx, Hy, y, s, rG, rH, rC)),
                                        reg, structure=st_t, algorithm=algorithm)
    for g, w, d, r in zip(got, want, dense, routed):
        w = np.asarray(w)
        scale = np.abs(w).max()
        # Float64, the same algebra summed in another order: 1e-10 relative.
        np.testing.assert_allclose(g[0].numpy(), w, rtol=0, atol=1e-10 * scale)
        np.testing.assert_allclose(d[0].numpy(), w, rtol=0, atol=1e-10 * scale)
        torch.testing.assert_close(r, g, rtol=0, atol=0)


# -- the device helpers -------------------------------------------------------------


def test_persistent_cache_dir_and_the_build_directory(monkeypatch, tmp_path):
    monkeypatch.delenv("MCPTPU_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    default = os.path.join(root, "build", "mcp_tpu_torch")
    assert devices.persistent_cache_dir() == default
    assert str(_build.library_path("thomas").parent) == default
    monkeypatch.setenv("MCPTPU_CACHE_DIR", str(tmp_path / "cache"))
    assert devices.persistent_cache_dir() == str(tmp_path / "cache")
    assert _build.library_path("thomas").parent == tmp_path / "cache"
    assert devices.cpu_probe_device() == torch.device("cpu")
    with devices.probes_on_cpu():
        assert torch.zeros(2).device == torch.device("cpu")


# -- the CLIs -------------------------------------------------------------------------


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """One training example of the N=2, horizon-3 game (its plan the zero
    trajectory: the landscape needs a target, not a solution)."""
    d = tmp_path_factory.mktemp("data")
    (d / "train").mkdir()
    ex = Example(trajectories=np.zeros((2, 3, 4)), ego_index=0,
                 initial_states=np.asarray(LANDSCAPE_INIT[:2]),
                 goals=np.asarray(LANDSCAPE_GOALS[:2]), mask=np.ones(2))
    save_example(str(d / "train" / "simulation_results_0.json"), ex)
    return d


def test_analysis_clis_in_process(data_dir, eval_dir, tmp_path, capsys):
    from mcp_tpu_torch.scripts import animate_results, loss_landscape, paper_vis, time_test

    loss_landscape.main(["--data", str(data_dir), "--players", "2", "--horizon", "3",
                         "--input-horizon", "2", "--grid", "2", "--mask-indices", "0", "1",
                         "--out", str(tmp_path / "landscape.png"), "--cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[-2].startswith("loss range [") and lines[-2].endswith("solved 4/4")
    assert lines[-1] == f"landscape written to {tmp_path / 'landscape.png'}"

    time_test.main(["--players", "2", "--horizon", "3", "--repeats", "1", "--out",
                    str(tmp_path / "time.png"), "--json-out", str(tmp_path / "time.json"),
                    "--cpu"])
    lines = capsys.readouterr().out.splitlines()
    per_n = json.loads((tmp_path / "time.json").read_text())
    assert json.loads(lines[-2]) == per_n and list(per_n) == ["2"] and per_n["2"] > 0

    paper_vis.main(["--result-dir", str(eval_dir), "--out-dir", str(tmp_path / "figs"),
                    "--preset", "n4", "--grid",
                    "receding_horizon_trajectories_[0]_[All]_[1].json",
                    "receding_horizon_trajectories_[1]_[Nearest Neighbor]_[2].json",
                    "--steps", "3", "6"])
    out = capsys.readouterr().out
    assert "radar[ranking2] -> " in out and "trajectory grid -> " in out

    animate_results.main(["--results", str(eval_dir), "--players", "4", "--out",
                          str(tmp_path / "anim"), "--limit", "2"])
    gifs = capsys.readouterr().out.splitlines()
    assert len(gifs) == 2 and all(g.endswith(".gif") and os.path.getsize(g) > 1000
                                  for g in gifs)
    for name in ("landscape.png", "time.png", "figs/radar_ranking2.pdf",
                 "figs/trajectories_grid.pdf"):
        assert os.path.getsize(tmp_path / name) > 1000
