"""The control on the card, at a size a test run holds: each cell's
configuration solved by the program one precision step below what it
states (float32 for float64) comes out not correct, and the program as
stated comes out correct, on the same seeds.

    python -m pytest perfbench/tests/test_perfbench_control.py -m card -n 0

At the cells' own sizes (PERF.md):
``python3 perfbench/control.py --workload <cell> --seeds ... --dtypes float64 float32``."""

import pytest

from perfbench import check, control, spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)


def verdict(name, dtype, seed, device):
    cell = spec.cell(name, spec.benchmark())
    cell = cell._replace(traffic={**cell.traffic, "batch": 256})
    loop = spec.loop_module(cell)
    session = control.control_session(cell, seed, device, dtype)
    loop.warm(session)
    window = loop.drive(session, 1.0)
    return check.judge(session, window, loop, spec.reference_module(cell))


@pytest.mark.card
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name, seed, cuda_device):
    stated = spec.cell(name, spec.benchmark()).config["dtype"]
    below = {"float64": "float32"}[stated]
    assert verdict(name, stated, seed, cuda_device).correct
    v = verdict(name, below, seed, cuda_device)
    assert not v.correct
    assert v.numbers["uncertified_share"][0] > v.numbers["uncertified_share"][1]
