"""The port's benchmark entry point (``bench_cuda.py``,
``mcp_tpu_torch/bench/main.py``) on the CPU at a tiny size: each protocol
prints ``make_out``'s JSON as its last line, certified; without a card and
without ``--cpu`` it fails rather than falling back to the CPU. No rate is
checked: a CPU rate says nothing of the card."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from mcp_tpu_torch.bench import main as bench_main

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

MAKE_OUT = {"metric", "value", "unit", "vs_baseline", "batch_size", "success_rate",
            "median_outer_iters", "best_batch_time_s", "max_kkt_error_solved", "true_kkt_max",
            "true_kkt_median", "frac_true_kkt_at_tol", "tol", "certified", "device",
            "median_batch_time_s", "event_batch_time_s", "timing_consistent"}
STREAMED = {"stream_depth", "pipeline_depth", "spans", "instances_timed", "retry"}
DW = {"metric", "value", "unit", "vs_baseline", "batch_size", "f32_stage_success_rate",
      "median_batch_time_s", "best_batch_time_s", "event_batch_time_s", "timing_consistent",
      "tol", "true_kkt_dw_max", "true_kkt_dw_median", "frac_true_kkt_at_tol", "certified",
      "instances_timed", "dw_iters", "device"}

# (arguments, metric, fields, instances timed)
CASES = [
    (["--suite", "lane_change", "--stream", "2", "--spans", "1"],
     "lane_change_mcp_solves_per_sec_streamed", MAKE_OUT | STREAMED, 2 * 16),
    (["--suite", "qp", "--stream", "2", "--spans", "1"],
     "qp_mcp_solves_per_sec_streamed", MAKE_OUT | STREAMED, 2 * 16),
    (["--suite", "warm"], "warm_lane_change_mcp_solves_per_sec", MAKE_OUT, None),
    (["--suite", "qp", "--dw", "--repeats", "1"], "qp_mcp_solves_per_sec_dw", DW, 16),
]


def _run(args, capsys):
    assert bench_main.main(["--cpu", "--quick", *args]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    return json.loads(lines[-1])


@pytest.mark.parametrize("args,metric,fields,instances", CASES,
                         ids=lambda v: " ".join(v) if isinstance(v, list) else None)
def test_last_line_is_make_outs_json(args, metric, fields, instances, capsys):
    out = _run(args, capsys)
    assert set(out) == fields, set(out) ^ fields
    assert out["metric"] == metric and out["unit"] == "solves/s"
    assert out["batch_size"] == 16 and out["device"] == "cpu"
    assert out["certified"] is True and out["timing_consistent"] is True
    # No CUDA events on the CPU: the card's own time is not measured.
    assert out["event_batch_time_s"] is None
    if instances is not None:
        assert out["instances_timed"] == instances
    if "success_rate" in out:
        assert out["success_rate"] == 1.0 and out["frac_true_kkt_at_tol"] == 1.0
        assert out["true_kkt_max"] <= out["tol"]
    else:  # the double-word row certifies at 1e-6
        assert out["tol"] == 1e-6 and out["dw_iters"] == 8


def test_per_dispatch_protocol(capsys):
    """--stream 0: the per-dispatch protocol (harness.benchmark_batched)."""
    out = _run(["--stream", "0", "--repeats", "2"], capsys)
    assert set(out) == MAKE_OUT
    assert out["metric"] == "lane_change_mcp_solves_per_sec" and out["certified"] is True


def test_without_a_card_main_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="cuda"):
        bench_main.main(["--quick"])


def test_root_script_exits_nonzero_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable here")
    proc = subprocess.run([sys.executable, str(ROOT / "bench_cuda.py"), "--quick"],
                          capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert proc.returncode != 0 and not proc.stdout.strip()
    assert "cuda" in proc.stderr


@pytest.mark.parametrize("args", [["--suite", "warm", "--dw"], ["--stream", "2", "--repeats", "0"]])
def test_bad_flag_combinations_exit(args):
    with pytest.raises(SystemExit):
        bench_main.main(["--cpu", *args])


def test_flags_and_defaults_are_bench_pys():
    """Every flag of bench.py with its default (bench.py:41-150)."""
    args = bench_main._parser().parse_args([])
    assert (args.suite, args.algorithm, args.refinement_steps, args.batch, args.repeats,
            args.quick, args.stream, args.retry, args.pipeline, args.spans, args.tol,
            args.x64, args.dw, args.dw_iters, args.tier, args.polish, args.tightening_rate,
            args.fused_linesearch, args.budget_seconds) == (
        "lane_change", None, None, 256, 5, False, None, None, 1, 3, 1e-4, False, False, 8,
        "tridiag_pallas", True, "auto", "default", 420.0)
    assert bench_main._parser().parse_args(["--no-polish"]).polish is False
