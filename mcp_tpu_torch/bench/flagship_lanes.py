"""Per-lane readings of one masked flagship batch (horizon 30, batch 8) on
several tiers and dtypes.

    python -m mcp_tpu_torch.bench.flagship_lanes [--players 10] [--init FILE.npy]
        [--runs tridiag_auto:float32,tridiag_cr:float64] [--device cuda]

Each run solves the flagship batch with the N=10 recipe (tol 1e-4, "ip",
polish, the game's auto tightening rate) on one tier in one dtype and prints
one JSON line: seconds, and per lane the status, outer iterations, the
solver's KKT error, the true KKT residual and the least distance between two
players over the returned plan (a near-collision shows where the soft-masked
repulsion 1/‖pᵢ−pⱼ‖² is steep).

The batch is ``flagships.masked_game_setup``'s θ draw, or, with ``--init``,
the initial states (8, N, 4) stored in FILE.npy (goals at the antipodes of
the circle, all-ones masks, as there). The JAX package's own draw, for
example, is ``mcp_tpu/bench/flagships.py:38-45`` without the game build:

    N, B = 10, 8
    ang = jnp.linspace(0.0, 2 * jnp.pi, N, endpoint=False)
    base = jnp.stack([3.0 * jnp.cos(ang), 3.0 * jnp.sin(ang)], axis=1)
    init = (jnp.concatenate([base, jnp.zeros((N, 2))], 1)[None].repeat(B, 0)
            .astype(jnp.float32)
            + 0.05 * jax.random.normal(jax.random.PRNGKey(0), (B, N, 4), jnp.float32))
    np.save(FILE, np.asarray(init))
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import SolverOptions, auto_tightening_rate, solve_batch
from .flagships import masked_game_setup
from .harness import true_kkt_errors

HORIZON, BATCH = 30, 8
OPTIONS = dict(tol=1e-4, algorithm="ip", polish=True)


def min_pair_distance(runner, x: torch.Tensor) -> torch.Tensor:
    """(B, n) primal → (B,) least ‖pᵢ − pⱼ‖ over player pairs and stages."""
    pos = runner.unpack_plans(x)[0][..., :2]  # (B, N, T, 2)
    d = (pos[:, :, None] - pos[:, None, :]).norm(dim=-1)  # (B, N, N, T)
    self_pairs = torch.eye(pos.shape[1], dtype=torch.bool, device=d.device)[None, :, :, None]
    return d.masked_fill(self_pairs, float("inf")).flatten(1).amin(dim=1)


def run(s, thetas, x0, tier: str, dtype: torch.dtype) -> dict:
    options = SolverOptions(**OPTIONS, linear_solver=tier,
                            tightening_rate=auto_tightening_rate(s.mcp))
    th, x0 = thetas.to(dtype), x0.to(dtype)
    sync = torch.cuda.synchronize if th.device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    res = solve_batch(s.mcp, th, x0=x0, options=options)
    sync()
    seconds = time.perf_counter() - t0
    return {
        "tier": tier, "dtype": str(dtype)[6:], "seconds": seconds,
        "status": res.status.tolist(), "outer_iters": res.outer_iters.tolist(),
        "kkt_error": res.kkt_error.tolist(),
        "true_kkt": true_kkt_errors(s.mcp, res, th).tolist(),
        "min_pair_distance": min_pair_distance(s.runner, res.x).tolist(),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--players", type=int, default=10)
    ap.add_argument("--init", help="initial states (8, N, 4) as .npy")
    ap.add_argument("--runs", default="tridiag_auto:float32",
                    help="comma-separated tier:dtype pairs")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    s = masked_game_setup(BATCH, args.players, HORIZON, device=args.device)
    thetas, x0 = s.thetas, s.x0
    if args.init:
        init = torch.from_numpy(np.load(args.init)).to(device=s.thetas.device,
                                                       dtype=s.thetas.dtype)
        ones = torch.ones((BATCH, args.players, args.players), dtype=init.dtype,
                          device=init.device)
        thetas, x0 = s.runner.pack_thetas(init, s.goals, ones), s.runner.cold_starts(init)
    for spec in args.runs.split(","):
        tier, dtype = spec.split(":")
        out = run(s, thetas, x0, tier, getattr(torch, dtype))
        print(json.dumps({"players": args.players, "init": args.init or "flagship", **out}),
              flush=True)


if __name__ == "__main__":
    main()
