"""The θ samplers repeat for a seed; a pooled traffic gives every seed the
same work in another order; the plain references agree with the program's
residual in float64; the frozen counts equal chip_smoke.py's."""

from types import SimpleNamespace

import pytest
import torch

from perfbench import seeds, spec
from perfbench.roofline import counts
from perfbench.session import Session

CONFIGS = ["lane_change", "qp", "lane_change_f64", "qp_f64"]


def config(name):
    return spec.read_json(spec.HERE / "configs" / f"{name}.json")


def modules(name):
    cell = spec.make_cell(name, name, "bulk.b4096")
    return cell, spec.config_module(cell), spec.reference_module(cell)


@pytest.mark.parametrize("name", CONFIGS)
def test_sampler_repeats_for_a_seed(name):
    cell, mod, _ = modules(name)
    cpu = torch.device("cpu")
    big = 2**33 + 17
    a = mod.sample(cell.config, seeds.generator(cpu, big, seeds.CALLS, 3), 6)
    b = mod.sample(cell.config, seeds.generator(cpu, big, seeds.CALLS, 3), 6)
    c = mod.sample(cell.config, seeds.generator(cpu, big, seeds.CALLS, 4), 6)
    w = mod.sample(cell.config, seeds.generator(cpu, big, seeds.WARM, 3), 6)
    assert a.shape == (6, cell.config["parameter_dimension"]) and a.dtype == torch.float64
    assert torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, w)


def test_seeds_take_any_whole_number():
    assert seeds.derived_seed(2**31 + 5, 0, 0) != seeds.derived_seed(2**31 + 6, 0, 0)
    assert 0 <= seeds.derived_seed(2**70, 1, 9) < 2**63
    with pytest.raises(ValueError):
        seeds.derived_seed(-1, 0, 0)


@pytest.mark.parametrize("name", ["lane_change", "qp"])
def test_reference_matches_the_program_in_float64(name):
    """The test may import both sides; the reference itself imports
    nothing of the program."""
    cell, mod, ref = modules(name)
    cfg = cell.config
    problem = mod.build(cfg, torch.device("cpu"))
    g = torch.Generator().manual_seed(11)
    theta = mod.sample(cfg, g, 4)
    n, m = cfg["num_primals"], cfg["num_inequalities"]
    x = torch.randn(4, n, generator=g, dtype=torch.float64)
    y = torch.rand(4, m, generator=g, dtype=torch.float64)
    G1, H1 = problem.mcp.gh_batched(x, y, theta)
    G2, H2 = ref.gh(cfg, theta, x, y)
    scale = max(float(G1.abs().max()), float(H1.abs().max()), 1.0)
    assert float((G1 - G2).abs().max()) <= 1e-12 * scale
    assert float((H1 - H2).abs().max()) <= 1e-12 * scale


def test_frozen_counts_equal_chip_smoke():
    import chip_smoke as cs

    assert counts.thomas_counts(4096, 10, 20, True) == cs.thomas_counts(4096, 10, 20, True)
    assert counts.thomas_counts(1024, 10, 20, True, itemsize=8) == \
        cs.thomas_counts(1024, 10, 20, True, itemsize=8)
    assert counts.thomas_counts(256, 30, 40, False, fact="gjpr") == \
        cs.thomas_counts(256, 30, 40, False, fact="gjpr")
    for kind in ("gj", "gji", "qr"):
        assert counts.dense_counts(kind, 4096, 100) == cs.dense_counts(kind, 4096, 100)
    assert counts.gj_counts(4096, 100, itemsize=8) == cs.dense_counts("gj", 4096, 100, 8)
    assert counts.ls_counts(1024, 200, 250, 15) == cs.ls_counts(1024, 200, 250, 15)
    for fact in counts.FACT_CODES:
        assert counts.aug_flops(20, 21, fact) == cs.aug_flops(20, 21, fact)
    assert counts.HBM_BYTES_PER_S == cs.HBM_BYTES_PER_S
    assert counts.FLOP_PER_S["float32"] == cs.FP32_FLOP_PER_S


def test_frozen_fact_table_equals_the_program():
    from mcp_tpu_torch.kernels import solve_aug

    assert counts.FACT_CODES == solve_aug.FACT_CODES
    assert counts.GJB_PANEL == solve_aug.GJB_PANEL


@pytest.mark.parametrize("name", CONFIGS)
def test_kernel_shapes_are_the_programs(name):
    """The shapes the roofline counts take are those of the program's
    problem: the banded blocks of the lane-change game, the QP's primals."""
    cell, mod, _ = modules(name)
    cfg = cell.config
    mcp = mod.build(cfg, torch.device("cpu")).mcp
    shapes = cfg["kernel_shapes"]
    if "K1" in shapes:
        st = mcp.time_structure
        assert (shapes["K1"]["T"], shapes["K1"]["b"]) == (st.num_blocks, st.block_size)
        assert (shapes["K2"]["n"], shapes["K2"]["m"]) == (
            mcp.unconstrained_dimension, mcp.constrained_dimension)
        from mcp_tpu_torch.solver import SolverOptions, linesearch_candidates

        o = SolverOptions()
        assert shapes["K2"]["candidates"] == len(linesearch_candidates(o.decay, o.min_stepsize))
    if "K4a" in shapes:
        assert shapes["K4a"]["n"] == mcp.unconstrained_dimension


class _Drawer:
    """The part of a session that draws θ, on the CPU, without the problem."""

    draw = Session.draw

    def __init__(self, cell, seed):
        self.cell, self.seed, self.device = cell, seed, torch.device("cpu")
        self.cfg, self.batch, self.dtype = cell.config, cell.traffic["batch"], torch.float64
        self.config = spec.config_module(cell)


def test_a_pooled_traffic_gives_every_seed_the_same_work_in_another_order():
    cell = spec.make_cell("lane_change_f64.bulk", "lane_change_f64", "bulk.b16384")
    n = cell.traffic["pool_calls"]
    cell = cell._replace(traffic={**cell.traffic, "batch": 8})
    loop = spec.loop_module(cell)
    a, b = _Drawer(cell, 2**33 + 1), _Drawer(cell, 2**33 + 2)

    def rows(theta):
        return sorted(map(tuple, theta.tolist()))

    calls_a = [loop.draw(a, k) for k in range(n + 1)]
    calls_b = [loop.draw(b, k) for k in range(n)]
    assert sorted(map(rows, calls_a[:n])) == sorted(map(rows, calls_b))
    assert any(not torch.equal(x, y) for x, y in zip(calls_a, calls_b))
    assert rows(calls_a[n]) in [rows(t) for t in calls_a[:n]]
    redrawn = loop.redraw(a, SimpleNamespace(index=3))
    assert torch.equal(redrawn, calls_a[3])


def test_an_unpooled_traffic_draws_fresh_lanes_for_each_seed():
    cell = spec.make_cell("qp_f64.bulk", "qp_f64", "bulk.b4096")
    cell = cell._replace(traffic={**cell.traffic, "batch": 4})
    loop = spec.loop_module(cell)
    a, b = _Drawer(cell, 7), _Drawer(cell, 8)
    assert not torch.equal(loop.draw(a, 0), loop.draw(b, 0))
    assert torch.equal(loop.draw(a, 0), a.draw(seeds.CALLS, 0))
