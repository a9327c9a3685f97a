"""Host milliseconds per call of K2's wrapper (``linesearch_update``), each
tree's in a process of its own, in the order given:

    python -m mcp_tpu_torch.bench.k2_wrapper --tree OLD --tree . --tree . --tree OLD

A tree is a checkout of this repository (an earlier commit unpacked with
``git archive``, for example); its ``mcp_tpu_torch`` is imported from there
and builds its kernels under its own ``build/``. Each process calls the
wrapper back to back at the lane-change shape (B=256, n=200, m=250,
float32, one feasible step on the card) and prints one JSON line:
``host_ms``, the host's time per call not waiting on the card (the card
finishes each ~5 µs kernel long before the next call is issued), and
``wall_ms``, per call to the end of the last kernel. The first line of the
output is the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

SHAPE = (256, 200, 250)


def measure(reps: int, rounds: int) -> dict:
    """Time this process's ``mcp_tpu_torch`` wrapper: ``rounds`` of
    ``reps`` calls back to back, after a warm-up that builds the kernel."""
    import numpy as np
    import torch

    import mcp_tpu_torch
    from mcp_tpu_torch.kernels.linesearch import linesearch_update
    from mcp_tpu_torch.solver import SolverOptions, linesearch_candidates

    B, n, m = SHAPE
    rng = np.random.default_rng(0)
    arrays = [rng.standard_normal((B, n)) for _ in range(2)]
    arrays += [rng.uniform(0.01, 2.0, (B, m)), 0.1 * rng.standard_normal((B, m)),
               rng.uniform(0.01, 2.0, (B, m)), 0.1 * rng.standard_normal((B, m)),
               rng.standard_normal((B, n)), rng.standard_normal((B, m)),
               rng.standard_normal((B, m))]
    args = [torch.tensor(a, dtype=torch.float32, device="cuda") for a in arrays]
    o = SolverOptions()
    cands = linesearch_candidates(o.decay, o.min_stepsize)

    def call():
        return linesearch_update(*args, tau=o.tau, candidates=cands)

    for _ in range(50):
        call()
    torch.cuda.synchronize()
    host, wall = [], []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(reps):
            call()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        host.append((t1 - t0) / reps * 1e3)
        wall.append((t2 - t0) / reps * 1e3)
    return {"package": str(Path(mcp_tpu_torch.__file__).resolve().parent),
            "launches": linesearch_update.launches, "host_ms": min(host),
            "host_ms_rounds": host, "wall_ms": min(wall), "wall_ms_rounds": wall}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="a checkout whose wrapper to time (repeat for turns)")
    ap.add_argument("--reps", type=int, default=2000)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--measure", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.measure:
        print(json.dumps(measure(a.reps, a.rounds)), flush=True)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(card, flush=True)
    for tree in a.tree or ["."]:
        root = Path(tree).resolve()
        env = {**os.environ, "PYTHONPATH": str(root)}
        out = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--measure",
                              "--reps", str(a.reps), "--rounds", str(a.rounds)],
                             cwd=root, env=env, capture_output=True, text=True)
        if out.returncode != 0:
            sys.stderr.write(out.stderr)
            return out.returncode
        print(json.dumps({"tree": tree, **json.loads(out.stdout.splitlines()[-1])}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
