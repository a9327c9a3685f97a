"""The readers of the program's own table (``mcp_tpu_torch.telemetry``):
``live_lane_share``, ``polish_steps_per_batch``, ``polish_ms_per_batch`` and
``setup_ms_per_batch``, each split by cell. On a fixed table, on a program
that keeps no table (they give nothing and do not raise), and in a traced
run of each cell on the CPU at a tiny batch."""

import sys
from types import SimpleNamespace

import pytest
import torch

from perfbench import metrics_telemetry, run, spec

BENCH = spec.benchmark()
NEW = ("live_lane_share", "polish_steps_per_batch", "polish_ms_per_batch", "setup_ms_per_batch")
GROUPS = {"game": "lane_change_f64.bulk", "qp": "qp_f64.bulk"}
NAMES = [f"{m}.{g}" for m in NEW for g in GROUPS]

TABLE = {"spans": {"mcp.setup": {"count": 4, "ns": 6_000_000},
                   "mcp.polish": {"count": 2, "ns": 50_000_000},
                   "mcp.newton_solve": {"count": 88, "ns": 1}},
         "counters": {"mcp.live_lane_steps": 1_000, "mcp.lane_steps": 4_000,
                      "mcp.polish_steps": 40}}
TRACE = SimpleNamespace(calls=2)


def entry(name):
    (m,) = [m for m in BENCH["per_layer"] if m["name"] == name]
    return m


@pytest.mark.parametrize("name", NAMES)
def test_entries(name):
    m, group = entry(name), name.rsplit(".", 1)[1]
    assert m["workloads"] == [GROUPS[group]] and m["moves"] == f"solves_per_s.{group}"
    assert m["source"] == "program_span"
    assert m["layer"] == ("entry" if name.startswith("setup_") else "solver loop")
    assert spec.per_layer_reader(name).read


@pytest.mark.parametrize("group", GROUPS)
def test_readers_on_a_table(group, monkeypatch):
    monkeypatch.setattr(metrics_telemetry, "snapshot", lambda: TABLE)
    got = {m: spec.per_layer_reader(f"{m}.{group}").read(TRACE, None) for m in NEW}
    assert got == pytest.approx({"live_lane_share": 25.0, "polish_steps_per_batch": 20.0,
                                 "polish_ms_per_batch": 25.0, "setup_ms_per_batch": 3.0})


def test_readers_without_a_polish(monkeypatch):
    table = {"spans": {"mcp.setup": TABLE["spans"]["mcp.setup"]},
             "counters": {"mcp.live_lane_steps": 7, "mcp.lane_steps": 8}}
    monkeypatch.setattr(metrics_telemetry, "snapshot", lambda: table)
    got = {m: spec.per_layer_reader(f"{m}.qp").read(TRACE, None) for m in NEW}
    assert got == pytest.approx({"live_lane_share": 87.5, "polish_steps_per_batch": None,
                                 "polish_ms_per_batch": None, "setup_ms_per_batch": 3.0})


@pytest.mark.parametrize("table", [{"spans": {}, "counters": {}}, None], ids=["empty", "none"])
def test_readers_with_nothing_to_read(table, monkeypatch):
    monkeypatch.setattr(metrics_telemetry, "snapshot", lambda: table)
    for name in NAMES:
        assert spec.per_layer_reader(name).read(TRACE, None) is None


def test_a_program_without_telemetry(monkeypatch):
    """The parent's program has no ``telemetry`` module: nothing, no raise."""
    import mcp_tpu_torch

    monkeypatch.delattr(mcp_tpu_torch, "telemetry", raising=False)
    monkeypatch.setitem(sys.modules, "mcp_tpu_torch.telemetry", None)
    assert metrics_telemetry.snapshot() is None
    for name in NAMES:
        assert spec.per_layer_reader(name).read(TRACE, None) is None


@pytest.mark.parametrize("group", GROUPS)
def test_a_tiny_traced_run(group):
    """A traced run prints the new metrics beside every old one, and the
    lane counter counts the steps that the trace's mcp.newton_solve spans
    count."""
    from mcp_tpu_torch import telemetry

    cell = spec.cell(GROUPS[group], BENCH)
    cell = cell._replace(traffic={**cell.traffic, "batch": 4})
    telemetry.reset()
    out = run.run_cell(cell, 2**31 + 29, 0.01, True, torch.device("cpu"), {})
    table = telemetry.snapshot()
    telemetry.reset()
    assert out["correct"]
    metrics = {k: v["value"] for k, v in out["metrics"].items()}
    for m in NEW:
        assert f"{m}.{group}" in metrics
    old = [m["name"] for m in cell.per_layer if m["source"] == "program_span"
           and m["name"].split(".")[0] not in NEW]
    if group == "qp" and not metrics["polish_steps_per_batch.qp"]:
        old.remove("linesearch_ms_per_step.qp")  # the QP's linesearch runs in its polish alone
    assert old and all(name in metrics for name in old)
    steps = metrics[f"newton_steps_per_batch.{group}"] * out["calls"]
    assert table["counters"]["mcp.lane_steps"] == 4 * steps
    assert 0 < metrics[f"live_lane_share.{group}"] <= 100
    assert metrics[f"polish_steps_per_batch.{group}"] <= 20
