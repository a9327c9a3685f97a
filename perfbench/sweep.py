"""The sweep that fixes a bulk cell's batch: for each configuration and rung,
one warm call, one timed call (host clock up to a synchronize, its lanes
held to the reference) and one traced call (the device's idle share, Newton
steps, launches), with the peak of allocated memory over the three.

    python3 perfbench/sweep.py --configs lane_change qp --rungs 1024 4096 16384 \\
        [--seed N] [--out sweep.jsonl]

One JSON line per rung on standard output (and in ``--out``). The rule
that picks a rung from them (PERF.md §4) is applied by hand; this only
measures."""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def rung(config: str, batch: int, seed: int, device) -> dict:
    import torch

    from perfbench import check, spec
    from perfbench import trace as tracing
    from perfbench.loops import closed
    from perfbench.run import import_program
    from perfbench.session import Session

    import_program(ROOT)
    cfg = spec.read_json(spec.HERE / "configs" / f"{config}.json")
    cell = spec.Cell(f"{config}.sweep", config, "sweep", 1, cfg,
                     {"loop": "closed", "batch": batch}, (), ())
    session = Session(cell, seed, device)
    if device.type == "cuda":
        from mcp_tpu_torch.kernels import _build

        for name in cfg.get("libraries", ()):
            _build.load(name)
    torch.cuda.reset_peak_memory_stats(device)
    t = time.perf_counter()
    closed.warm(session)
    warm_s = time.perf_counter() - t
    timed = closed.drive(session, 0.0)
    verdict = check.judge(session, timed, closed, spec.reference_module(cell))
    with tracing.profiled(True) as events:
        closed.drive(session, 0.0)
    profile = tracing.reduce(events)
    del events
    steps = profile.span_count("mcp.newton_solve")
    call_s = timed.calls[0].seconds
    return {
        "config": config, "batch": batch, "seed": seed, "warm_s": warm_s, "call_s": call_s,
        "certified": verdict.certified, "attempted": verdict.attempted,
        "solves_per_s": verdict.certified / call_s,
        "idle_share": 1.0 - profile.busy_s() / profile.window_s,
        "traced_window_s": profile.window_s, "newton_steps": steps,
        "launches": len(profile.launches),
        "peak_allocated_bytes": torch.cuda.max_memory_allocated(device),
        "checks": {k: v for k, v in verdict.numbers.items()},
        "readings": verdict.readings,
        "top_ops": tracing.breakdown(profile)["device_ops"][:5],
        "idle_gaps": tracing.breakdown(profile)["idle_gaps"][:5],
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--configs", nargs="+", default=["lane_change", "qp"])
    p.add_argument("--rungs", nargs="+", type=int, default=[1024, 4096, 16384])
    p.add_argument("--seed", type=int, default=9_000_000_001)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import os

    import torch

    from perfbench.run import cache_dirs

    os.environ.update(cache_dirs(ROOT))
    if not torch.cuda.is_available():
        print("the sweep needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    out = open(args.out, "a") if args.out else None
    for config in args.configs:
        for batch in args.rungs:
            line = json.dumps(rung(config, batch, args.seed, device))
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
