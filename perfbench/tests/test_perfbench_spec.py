"""BENCHMARK.json against the contract's shape, and every name it holds
found as files; a new per-layer metric added as a file and an entry, with
no file edited."""

import json
import re
import shutil
import subprocess
import sys

import pytest

from perfbench import spec

ROOT = spec.ROOT
BENCH = spec.benchmark(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    cells = len(BENCH["workloads"])
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert 1 <= cells <= 24


def test_names_units_and_keys():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + CELLS + [c["name"] for c in BENCH["configs"]]
    assert all(NAME.match(n) for n in names), names
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m["workloads"]) <= set(CELLS) if "workloads" in m else True
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    cell = spec.cell(name, BENCH)
    assert cell.chips == 1
    assert cell.config["name"] == cell.config_name
    assert spec.config_module(cell).build and spec.config_module(cell).sample
    assert spec.reference_module(cell).gh
    loop = spec.loop_module(cell)
    assert loop.drive and loop.warm and loop.redraw
    for m in cell.end_to_end:
        assert spec.end_to_end_reader(m["name"]).read
    for m in cell.per_layer:
        assert spec.per_layer_reader(m["name"]).read
    assert len(cell.end_to_end) >= 2 and cell.per_layer


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_entries(entry):
    path = ROOT / entry["file"]
    cfg = json.loads(path.read_text())
    assert entry["file"] == f"perfbench/configs/{entry['name']}.json"
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert entry["reduced"] == cfg["reduced"] == []
    assert 1 <= len(entry["source"]) <= 200 and 1 <= len(entry["why"]) <= 200


def test_a_metric_added_by_files_alone(tmp_path):
    """A copy of the benchmark gains a per-layer metric by one new reader
    file and one new entry; the existing files are not edited."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = dict(BENCH)
    bench["per_layer"] = BENCH["per_layer"] + [
        {"name": "dummy_kernel_ms", "unit": "ms", "better": "lower", "source": "device_trace",
         "layer": "device", "moves": "solves_per_s", "workloads": [CELLS[0]]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "perfbench" / "metrics" / "dummy_kernel_ms.py").write_text(
        "def read(trace, ctx):\n"
        "    return 1e3 * sum(k.end_s - k.start_s for k in trace.kernels\n"
        "                     if 'dummy_kernel' in k.name) or None\n")
    script = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(tmp_path)!r})\n"
        "from perfbench import spec\n"
        "from perfbench.trace import Interval, Trace\n"
        f"cell = spec.cell({CELLS[0]!r}, spec.benchmark(spec.ROOT))\n"
        "assert spec.ROOT.as_posix() == sys.path[0]\n"
        "t = Trace(2, 1.0, [Interval('void dummy_kernel<float>(float*)', 0.1, 0.3)],\n"
        "          {'perfbench.window': [Interval('perfbench.window', 0.0, 1.0)]}, 0)\n"
        "print(json.dumps({m['name']: spec.per_layer_reader(m['name']).read(t, None)\n"
        "                  for m in cell.per_layer if m['name'] == 'dummy_kernel_ms'}))\n")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         cwd=tmp_path, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {"dummy_kernel_ms": pytest.approx(200.0)}
