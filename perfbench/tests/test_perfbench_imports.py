"""What a run imports: no top-level jax, jaxlib, flax or mcp_tpu (compared by
whole top-level names; mcp_tpu_torch is the program), and the references
nothing of the program. Without a card the command prints no result."""

import ast
import json
import shutil
import subprocess
import sys

import pytest

from perfbench import spec

ROOT = spec.ROOT
FORBIDDEN = {"jax", "jaxlib", "flax", "mcp_tpu"}

IMPORT_GRAPH = """
import json, sys
sys.path.insert(0, {root!r})
import torch
from perfbench import run, spec, check, trace, session, window, seeds, control, sweep
bench = spec.benchmark()
for w in bench["workloads"]:
    cell = spec.cell(w["name"], bench)
    spec.config_module(cell).build(cell.config, torch.device("cpu"))
    spec.reference_module(cell), spec.loop_module(cell)
    for m in cell.end_to_end:
        spec.end_to_end_reader(m["name"])
    for m in cell.per_layer:
        spec.per_layer_reader(m["name"])
import torch.profiler
print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
"""


def test_the_import_graph_of_a_run_holds_no_jax():
    out = subprocess.run([sys.executable, "-c", IMPORT_GRAPH.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "mcp_tpu_torch" in top
    assert not top & FORBIDDEN


REFERENCE_ONLY = """
import json, sys
sys.path.insert(0, {root!r})
from perfbench import spec
for p in sorted((spec.HERE / "reference").glob("*.py")):
    spec.load_module(p)
print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
"""


def test_the_references_import_nothing_of_the_program():
    out = subprocess.run([sys.executable, "-c", REFERENCE_ONLY.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not top & (FORBIDDEN | {"mcp_tpu_torch"})
    for path in (spec.HERE / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            assert {n.split(".")[0] for n in names} <= {"__future__", "torch", "numpy", "math"}, \
                (path.name, names)


def run_cli(cwd, *extra):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", spec.benchmark()["workloads"][0]["name"],
         "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0", *extra],
        capture_output=True, text=True, timeout=300, cwd=cwd)


def test_no_result_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = run_cli(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "needs 1 CUDA card" in out.stderr


def test_no_result_from_the_benchmark_alone(tmp_path):
    """A directory with only BENCHMARK.json and perfbench/ has no program."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = run_cli(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "the program cannot be imported" in out.stderr


def test_the_program_must_come_from_the_checkout(tmp_path):
    from perfbench.run import import_program

    with pytest.raises(ImportError):
        import_program(tmp_path)
