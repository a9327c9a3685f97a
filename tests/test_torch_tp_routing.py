"""The tensor-parallel Newton backend (``parallel/tensor.py``) and shape-bucket
routing (``parallel/routing.py``) of the PyTorch port against the JAX
package's on 2 of its 8 virtual CPU devices, float64, on the same
numpy-seeded inputs.

The multi-rank cases run in one module-scoped spawn of 2 gloo ranks on the
CPU (``bench/horizon.py``'s worker, one thread each, the ranks importing
the port only): ``lu_solve_tp`` at (n, panel) ∈ {(64, 8), (100, 8), (256,
32), (300, 16)} and on a system that needs pivoting; ``solve_single_tp`` of
a QP of the suite's MCP (n=30, m=20: the 50-wide condensed system padded to
64 in panels of 8) with its θ-gradient (the condensed IFT's core solves on
the ranks too) and with the polish riding the override; ``solve_routed`` of
two shapes (one rank each), of one bucket padded over both ranks, and of two
weighted buckets; and the dry run's tasks (``dryrun.dryrun_tasks(2)``: the
data-parallel training step, sp, tp and ep, each held against one rank by
``dryrun.check_axis``), with the training step also in float64 against the
JAX package's step of ``__graft_entry__.py``. The fixture computes the JAX
package's references (cached) while the ranks run. The partition arithmetic and the refusals run
in this process."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcp_tpu.bench import qp as jqp
from mcp_tpu.parallel.batch import solve_batch as jax_solve_batch
from mcp_tpu.parallel.routing import partition_devices as jax_partition
from mcp_tpu.parallel.tensor import lu_solve_tp as jax_lu_solve_tp
from mcp_tpu.parallel.tensor import make_tp_mesh as jax_tp_mesh
from mcp_tpu.parallel.tensor import solve_single_tp as jax_solve_single_tp
from mcp_tpu.solver import SolverOptions as JaxOptions
from mcp_tpu.solver import ip_solve as jax_ip_solve
from mcp_tpu_torch import SOLVED, SolverOptions, dryrun, ip_solve, solve_batch
from mcp_tpu_torch.bench import horizon as worker
from mcp_tpu_torch.bench import qp
from mcp_tpu_torch.parallel.routing import partition_devices
from mcp_tpu_torch.selection import dp
from mcp_tpu_torch.parallel.tensor import padded_dimension, solve_single_tp

torch.set_num_threads(1)

LU_CASES = [(64, 8), (100, 8), (256, 32), (300, 16)]
TP_N, TP_M, PANEL = 30, 20, 8
TP_PROBLEM = dict(kind="qp", num_primals=TP_N, num_inequalities=TP_M, assume_hy_zero=True)
TP_SOLVE = dict(linear_solver="condensed", sensitivity_solver="condensed")
TP_POLISH = dict(linear_solver="condensed", polish=True, tol=1e-8)
#: (problem, batch size, options) of the routed buckets: two shapes (the
#: first of an odd size); one bucket of 5 padded to 6 over both ranks.
SHAPES = [(dict(kind="qp", num_primals=6, num_inequalities=4), 5, {}),
          (dict(kind="qp", num_primals=10, num_inequalities=3), 12, dict(tol=1e-6))]


def _lu_system(n):
    rng = np.random.RandomState(n)
    return rng.randn(n, n) + 0.1 * n * np.eye(n), rng.randn(n)


def _pivot_system():
    """Zero diagonal everywhere: LU without pivoting breaks down at once."""
    A = np.kron(np.eye(32), np.array([[0.0, 1.0], [1.0, 0.0]]))
    return A, np.random.RandomState(0).randn(64)


def _jmcp(problem):
    return jqp.generate_test_problem(num_primals=problem["num_primals"],
                                     num_inequalities=problem["num_inequalities"]).mcp


def _thetas(problem, B, seed):
    return np.array(jqp.generate_parameter_batch(
        jax.random.PRNGKey(seed), B, num_primals=problem["num_primals"],
        num_inequalities=problem["num_inequalities"], sparsity_rate=0.0, dtype=jnp.float64))


@functools.lru_cache(maxsize=None)
def _tp_theta():
    return _thetas(TP_PROBLEM, 1, seed=3)[0]


def _bucket(problem, thetas, options, **kw):
    return dict(problem=problem, thetas=thetas, options=options, **kw)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    th = _tp_theta()
    shapes = [_bucket(p, _thetas(p, B, seed=i), o) for i, (p, B, o) in enumerate(SHAPES)]
    tasks = [
        *(dict(kind="lu_tp", name=f"lu{n}", systems=[_lu_system(n)], panel=panel)
          for n, panel in LU_CASES),
        dict(kind="lu_tp", name="pivot", systems=[_pivot_system()], panel=8),
        dict(kind="tp", name="tp", problem=TP_PROBLEM, theta=th, options=TP_SOLVE,
             panel=PANEL, grad=True),
        dict(kind="tp", name="polish", problem=TP_PROBLEM, theta=th, options=TP_POLISH,
             panel=PANEL),
        dict(kind="routed", name="shapes", buckets=shapes),
        dict(kind="routed", name="padded", buckets=shapes[:1]),
        dict(kind="routed", name="weights",
             buckets=[_bucket(SHAPES[0][0], _thetas(SHAPES[0][0], 2, seed=9), {}, weight=1.0)] * 2),
        *dryrun.dryrun_tasks(2, device="cpu"),
        dict(kind="dp_train", name="dp64", dtype="float64", **dp.dp_inputs(2)),
    ]
    ranks = worker.start(2, tasks, tmp_path_factory.mktemp("tp_ranks"), device="cpu",
                         timeout_s=300)
    _jax_dp_step()
    for n, panel in LU_CASES:
        _jax_lu(n, panel)
    _jax_lu(0, 8)
    _jax_tp_solve(tuple(TP_SOLVE.items())), _jax_tp_solve(tuple(TP_POLISH.items()))
    _jax_tp_grad()
    _unrouted(0), _unrouted(1)
    return ranks()


def _same_on_both_ranks(ranks, name):
    def same(a, b):
        if isinstance(a, dict):
            for k in a:
                same(a[k], b[k])
        elif isinstance(a, list):
            for u, v in zip(a, b):
                same(u, v)
        elif isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)

    same(ranks[0][name], ranks[1][name])
    return ranks[0][name]


# -- the distributed LU ----------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_lu(n, panel):
    """The JAX package's lu_solve_tp on 2 devices (n = 0: the pivoting
    system)."""
    A, b = _lu_system(n) if n else _pivot_system()
    return np.asarray(jax_lu_solve_tp(jnp.asarray(A), jnp.asarray(b),
                                      mesh=jax_tp_mesh(jax.devices()[:2]), panel=panel))


@pytest.mark.parametrize("n,panel", LU_CASES)
def test_lu_solve_tp_matches_jax(ranks, n, panel):
    A, b = _lu_system(n)
    got = _same_on_both_ranks(ranks, f"lu{n}")["x"][0]
    want = _jax_lu(n, panel)
    # 1e-10 relative: the same blocked LU with the same pivots in float64,
    # its products summed in another order.
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * np.abs(want).max())
    np.testing.assert_allclose(got, np.linalg.solve(A, b), rtol=0, atol=1e-10 * np.abs(want).max())


def test_lu_solve_tp_pivots(ranks):
    A, b = _pivot_system()
    got = _same_on_both_ranks(ranks, "pivot")["x"][0]
    want = _jax_lu(0, 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(A @ got, b, rtol=0, atol=1e-12)


def test_padded_dimension():
    assert padded_dimension(100, 8, 8) == 128
    assert padded_dimension(64, 8, 8) == 64
    assert padded_dimension(65, 8, 8) == 128
    assert padded_dimension(TP_N + TP_M, 2, PANEL) == 64


# -- solve_single_tp -------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_tp(options):
    mcp = dataclasses.replace(_jmcp(TP_PROBLEM), assume_hy_zero=True)
    return mcp, jax_tp_mesh(jax.devices()[:2]), JaxOptions(**dict(options))


@functools.lru_cache(maxsize=None)
def _jax_tp_solve(options):
    mcp, mesh, opts = _jax_tp(options)
    return jax.tree.map(np.asarray, jax_solve_single_tp(mcp, jnp.asarray(_tp_theta()), mesh=mesh,
                                                        panel=PANEL, options=opts))


@functools.lru_cache(maxsize=None)
def _jax_tp_grad():
    """The JAX package's gradient of Σx² through solve_single_tp."""
    mcp, mesh, opts = _jax_tp(tuple(TP_SOLVE.items()))
    return np.asarray(jax.grad(lambda t: jnp.sum(jax_solve_single_tp(
        mcp, t, mesh=mesh, panel=PANEL, options=opts).x ** 2))(jnp.asarray(_tp_theta())))


def test_solve_single_tp_matches_jax(ranks):
    got = _same_on_both_ranks(ranks, "tp")
    want = _jax_tp_solve(tuple(TP_SOLVE.items()))
    assert int(got["status"]) == int(want.status) == SOLVED
    assert int(got["outer_iters"]) == int(want.outer_iters)
    # 1e-8: float64 iterates of the same algorithm, differing by rounding.
    np.testing.assert_allclose(got["x"], np.asarray(want.x), rtol=0, atol=1e-8)
    np.testing.assert_allclose(got["y"], np.asarray(want.y), rtol=0, atol=1e-8)
    # The gradient of Σx², its IFT core solves sharded: rtol 1e-6, two
    # float64 IFT solves at solutions equal to ~1e-12.
    g = _jax_tp_grad()
    np.testing.assert_allclose(got["grad"], g, rtol=1e-6, atol=1e-10 * np.abs(g).max())


def test_polish_rides_the_override(ranks):
    """The certifying polish reuses the injected tensor-parallel step."""
    got = _same_on_both_ranks(ranks, "polish")
    want = _jax_tp_solve(tuple(TP_POLISH.items()))
    assert int(got["status"]) == int(want.status) == SOLVED
    assert int(got["outer_iters"]) == int(want.outer_iters)
    assert float(got["kkt_error"]) <= 1e-8
    np.testing.assert_allclose(got["x"], np.asarray(want.x), rtol=0, atol=1e-8)


def test_tensor_parallel_refusals():
    """As in the JAX package: solve_single_tp shards the condensed system
    only, and the newton_solver override runs under "ip" only."""
    mcp = qp.generate_test_problem(num_primals=TP_N, num_inequalities=TP_M, device="cpu").mcp
    jm = _jmcp(TP_PROBLEM)
    theta = np.zeros(mcp.parameter_dimension)
    for solve_tp, m, th in ((solve_single_tp, mcp, torch.from_numpy(theta)),
                            (jax_solve_single_tp, jm, jnp.asarray(theta))):
        with pytest.raises(ValueError, match="condensed"):
            solve_tp(m, th, options=(SolverOptions if m is mcp else JaxOptions)(
                linear_solver="schur"))
    x, y = np.zeros(TP_N), np.ones(TP_M)
    for algorithm in ("mehrotra", "hybrid"):
        with pytest.raises(NotImplementedError, match="algorithm='ip'"):
            jax_ip_solve(jm, JaxOptions(algorithm=algorithm), jnp.asarray(theta), jnp.asarray(x),
                         jnp.asarray(y), jnp.asarray(y), newton_solver=lambda *a: None)
        with pytest.raises(NotImplementedError, match="algorithm='ip'"):
            ip_solve(mcp, SolverOptions(algorithm=algorithm), torch.from_numpy(theta)[None],
                     torch.from_numpy(x)[None], torch.from_numpy(y)[None],
                     torch.from_numpy(y)[None], newton_solver=lambda *a: None)


def test_entry_points_default_to_the_card():
    """Without a GPU, the new entry points raise before any collective."""
    from mcp_tpu_torch.parallel import make_tp_mesh, solve_routed

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    mcp = qp.generate_test_problem(num_primals=4, num_inequalities=2, device="cpu").mcp
    theta = torch.zeros(mcp.parameter_dimension, dtype=torch.float64)
    for call in (make_tp_mesh, lambda: solve_single_tp(mcp, theta),
                 lambda: solve_routed([])):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


# -- routing ---------------------------------------------------------------------

#: Costs with ties and with one bucket dominating, over 2 to 8 devices.
PARTITIONS = [([3.0, 1.0], 8), ([1e9, 1.0, 1.0], 8), ([1.0, 1.0], 2), ([1.0, 1.0, 1.0], 8),
              ([5.0, 2.0, 2.0, 1.0], 7), ([0.0, 0.0], 3)]


@pytest.mark.parametrize("costs,D", PARTITIONS)
def test_partition_matches_jax(costs, D):
    devices = list(range(D))
    got = partition_devices(costs, devices)
    assert got == jax_partition(costs, devices)
    assert sorted(sum(got, [])) == devices and all(got)


def test_partition_refuses_too_many_buckets():
    for partition in (partition_devices, jax_partition):
        with pytest.raises(ValueError, match="devices"):
            partition([1.0] * 3, [0, 1])


@functools.lru_cache(maxsize=None)
def _unrouted(k):
    """Bucket k of SHAPES solved by the JAX package's unrouted solve_batch."""
    problem, B, options = SHAPES[k]
    return jax.tree.map(np.asarray, jax_solve_batch(
        _jmcp(problem), jnp.asarray(_thetas(problem, B, seed=k)), options=JaxOptions(**options)))


@pytest.mark.parametrize("name", ["shapes", "padded"])
def test_solve_routed_matches_unrouted(ranks, name):
    got = _same_on_both_ranks(ranks, name)["results"]
    assert [r["x"].shape[0] for r in got] == [B for _, B, _ in SHAPES][: len(got)]
    for k, res in enumerate(got):
        want = _unrouted(k)
        np.testing.assert_array_equal(res["status"], want.status)
        assert (want.status == SOLVED).all()
        np.testing.assert_array_equal(res["outer_iters"], want.outer_iters)
        # 1e-8: float64 iterates of the same algorithm, differing by
        # rounding (measured 1.2e-10 at |x| ≈ 350).
        np.testing.assert_allclose(res["x"], want.x, rtol=0, atol=1e-8)


def test_solve_routed_weights(ranks):
    got = _same_on_both_ranks(ranks, "weights")["results"]
    assert len(got) == 2
    np.testing.assert_array_equal(got[0]["x"], got[1]["x"])
    problem, _, _ = SHAPES[0]
    tm = qp.generate_test_problem(num_primals=problem["num_primals"],
                                  num_inequalities=problem["num_inequalities"],
                                  device="cpu").mcp
    ref = solve_batch(tm, torch.from_numpy(_thetas(problem, 2, seed=9)))
    np.testing.assert_array_equal(got[0]["status"], ref.status.numpy())
    np.testing.assert_array_equal(got[0]["x"], ref.x.numpy())


# -- the dry run ---------------------------------------------------------------------


@pytest.mark.parametrize("axis", ["dp", "sp", "tp", "ep"])
def test_dryrun_axis_matches_one_rank(ranks, axis):
    """``dryrun_multichip(2, device="cpu")``'s checks of each axis on the
    ranks' results (the dp step against one rank within 1e-4, as the JAX
    package's contract requires)."""
    name = f"dryrun_{axis}"
    (task,) = [t for t in dryrun.dryrun_tasks(2, device="cpu") if t["name"] == name]
    got = ranks[0][name]
    if axis == "dp":
        assert got["loss"] == ranks[1][name]["loss"]
        for a, b in zip(got["params"], ranks[1][name]["params"]):
            np.testing.assert_array_equal(a, b)
    else:
        _same_on_both_ranks(ranks, name)
    assert "— OK" in dryrun.check_axis(axis, got, task, 2, device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_dp_step():
    """The JAX package's dry-run training step (``__graft_entry__.py:123-181``)
    on one device, in float64, on ``dp.dp_inputs(2)``: (loss, new
    weights and biases as numpy)."""
    from mcp_tpu.selection.games import (build_masked_parametric_game,
                                         setup_road_environment, setup_trajectory_game)
    from mcp_tpu.selection.model import MLPParams, apply_mlp
    from mcp_tpu.trajectories import cold_start_primal

    N, H = dp.DP_N, dp.DP_HORIZON
    inp = dp.dp_inputs(2)
    game = setup_trajectory_game(environment=setup_road_environment(length=10.0), N=N)
    pg = build_masked_parametric_game(game, N=N, horizon=H)
    options = JaxOptions(**dp.DP_OPTIONS)
    params = MLPParams(weights=tuple(map(jnp.asarray, inp["weights"])),
                       biases=tuple(map(jnp.asarray, inp["biases"])))
    histories, init, goals = (jnp.asarray(inp[k]) for k in
                              ("histories", "initial_states", "goals"))

    def pack_theta(x0s, gls, mask):
        ones = jnp.ones((N,), mask.dtype)
        return jnp.concatenate([jnp.concatenate(
            [x0s[i], gls[i], jnp.concatenate([jnp.ones((1,), mask.dtype), mask]) if i == 0
             else ones]) for i in range(N)])

    def loss_fn(params):
        masks = jax.vmap(lambda h: apply_mlp(params, h))(histories)
        thetas = jax.vmap(pack_theta)(init, goals, masks)
        x0 = jax.vmap(lambda x0s: cold_start_primal(game, pg, H, x0s.reshape(-1)))(init)
        sol = jax_solve_batch(pg.mcp, thetas, x0=x0, options=options)
        similarity = jnp.mean(sol.x[:, : N * H * 4] ** 2)
        return 11.0 * similarity + 1.5 * jnp.mean(masks) + jnp.mean(0.5 - jnp.abs(0.5 - masks))

    loss, grads = jax.value_and_grad(loss_fn)(params)
    new = [np.asarray(p - dp.DP_LR * g) for p, g in zip(
        jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(grads))]
    return float(loss), new


def test_dp_step_matches_jax_in_float64(ranks):
    """The port's float64 training step, on one rank and data-parallel over
    two, against the JAX package's on one device."""
    got = ranks[0]["dp64"]
    want_loss, want = _jax_dp_step()
    # The port's parameters in MaskMLP order (weight, bias per layer); the
    # JAX leaves in MLPParams order (every weight, then every bias).
    layers = len(want) // 2
    order = [want[i // 2] if i % 2 == 0 else want[layers + i // 2] for i in range(len(want))]
    for loss, params in ((got["ref_loss"], got["ref_params"]), (got["loss"], got["params"])):
        # Float64, the same algebra (both solves stop FAILED at the 3 x 3
        # iteration caps, as in the JAX package's dry run): measured |Δ| 0
        # in the loss and 1.4e-17 in the new weights; held to 1e-12.
        assert abs(loss - want_loss) <= 1e-12
        for g, w in zip(params, order):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)
