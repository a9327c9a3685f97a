"""The control of the comparison, and a witness for lanes it refuses.

The control is the program with its own lower-precision path switched on,
one step below what the configuration states: for a float64 configuration
the program in float32 (``--dtypes float32``), TF32 off (the program's
default ``matmul_precision="highest"``). Each run is a run of the cell at its own
batch: set-up, one warm call, a window of ``--seconds``, the check, whose
limits stay the configuration's.

    python3 perfbench/control.py --workload qp_f64.bulk --seeds 11 12 13 \\
        --dtypes float64 float32 --seconds 40
    python3 perfbench/control.py --config lane_change --traffic bulk.b4096 \\
        --seeds 101 --witness

One JSON line per (dtype, seed): the numbers compared with their limits, the
readings, ``correct``. ``--witness`` adds, for every lane the program reports
SOLVED whose reference error passes the tolerance, the program's own
residual of that lane (``mcp.gh_batched``) in float32, as its polish
evaluates it, and in float64."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from perfbench import check, spec  # noqa: E402
from perfbench.session import Session  # noqa: E402


def control_session(cell, seed: int, device, dtype: str) -> Session:
    """The cell's session with the program run in ``dtype``."""
    return Session(cell._replace(config={**cell.config, "dtype": dtype}), seed, device)


def witness(session, window, loop, reference) -> list:
    """(call, lane, reference error, program float32 error, program float64
    error) of each SOLVED lane whose reference error passes the tolerance."""
    from mcp_tpu_torch.bench.harness import true_kkt_errors  # the program's own reading
    from mcp_tpu_torch.types import SolveResult

    cfg, tol, out = session.cfg, session.cfg["solver"]["tol"], []
    for call in window.calls:
        theta = loop.redraw(session, call)
        a = call.answer
        x, y, s = (t.to(session.device) for t in (a.x, a.y, a.s))
        err = check.true_kkt(reference.gh, cfg, theta, x, y, s)
        bad = torch.nonzero((a.status.to(session.device) == check.SOLVED) & (err > tol))
        for lane in bad.flatten().tolist():
            sl = slice(lane, lane + 1)
            own = []
            for dt in (torch.float32, torch.float64):
                res = SolveResult(x=x[sl].to(dt), y=y[sl].to(dt), s=s[sl].to(dt), kkt_error=None,
                                  epsilon=None, outer_iters=None, status=None)
                own.append(float(true_kkt_errors(session.problem.mcp, res, theta[sl].to(dt))[0]))
            out.append([call.index, lane, float(err[lane]), *own])
    return out


def main(argv=None) -> int:
    from perfbench.run import cache_dirs, import_program

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", help="a cell of BENCHMARK.json")
    p.add_argument("--config", help="or a configuration file's name, with --traffic")
    p.add_argument("--traffic")
    p.add_argument("--seeds", nargs="+", type=int, required=True)
    p.add_argument("--dtypes", nargs="+", default=None, help="default: the configuration's")
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--witness", action="store_true")
    args = p.parse_args(argv)
    import os

    os.environ.update(cache_dirs(ROOT))
    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 2
    import_program(ROOT)
    device = torch.device("cuda", 0)
    if args.workload:
        cell = spec.cell(args.workload, spec.benchmark(ROOT))
    else:
        cell = spec.make_cell(f"{args.config}.{args.traffic}", args.config, args.traffic)
    loop, reference = spec.loop_module(cell), spec.reference_module(cell)
    runs = [(d, s) for d in (args.dtypes or [cell.config["dtype"]]) for s in args.seeds]
    for dtype, seed in runs:
        session = control_session(cell, seed, device, dtype)
        loop.warm(session)
        window = loop.drive(session, args.seconds)
        verdict = check.judge(session, window, loop, reference)
        line = {"workload": cell.name, "dtype": dtype, "seed": seed,
                "batch": session.batch, "calls": len(window.calls),
                "window_s": window.host_s, "correct": verdict.correct,
                "attempted": verdict.attempted, "certified": verdict.certified,
                "numbers": verdict.numbers, "readings": verdict.readings}
        if args.witness:
            line["witness"] = witness(session, window, loop, reference)
        print(json.dumps(line), flush=True)
        del session, window
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
