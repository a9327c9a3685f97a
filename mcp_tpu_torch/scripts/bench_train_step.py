"""The solver-in-the-loop training-step benchmark (the JAX package's
``scripts/bench_train_step.py``): MLP mask predictor → masked-game solve →
composite loss → gradient through the solve (the IFT) → SGD, at the
flagship shape (N=4, horizon 30, batch 8) with the banded Newton tier, the
banded IFT and the certified (polish) forward solve.

It takes the staged step first (``bench.flagships.load_staged_train_step``,
written by ``python -m mcp_tpu_torch.scripts.precompile --suites train``),
which skips the game build's probes and the ground-truth solve, and falls
back to the full setup (``train_step_setup``) when nothing is staged for
these flags or with ``--no-staged``. The default tier is "tridiag_pallas",
the route through the hand-written kernels (K7a forward and backward, K2);
the JAX script's default "tridiag" is the port's plain banded tier.

Timing as in the JAX script: one first step from the initial MLP, then
``--repeats`` timed steps, the first of them from the initial MLP too, each
on inputs init + 1e-3·N(0, 1) drawn outside the clock (a CPU generator
seeded with the repeat's index), ending in the synchronize of its loss and
a gradient leaf, and followed by its SGD update; the value is their median.
``compile_s`` keeps the JAX script's meaning, the seconds from the start to
the end of the first step (here: the setup, staged or cold, and one step;
nothing is compiled ahead of a call).

Progress goes to stderr. On stdout, a line ``{"launches": {...}}`` with the
kernel launches of every step (K7a in the forward passes and inside the
IFT's band solve, ``diff._band_solve``, which the CLI wraps to count them;
K2), then as the last line one JSON object with the JAX script's keys
(without its ratio to a CPU figure), ``staged`` and the setup's seconds
(on the cold path the game build's probes, ``game_builder.probe_game``,
timed apart from the rest of the game's setup). ``--first-step-out FILE``
saves the first step's loss, status and gradient with ``torch.save``.

    python -m mcp_tpu_torch.scripts.bench_train_step [--cpu] [--batch 8] [--players 4] \\
        [--horizon 30] [--repeats 5] [--tier tridiag_pallas] [--no-polish] [--no-staged]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time


def _launches() -> dict:
    """K7a's and K2's launch counts so far (their wrappers count on the card)."""
    from ..kernels.linesearch import linesearch_update
    from ..kernels.thomas_babe import babe_thomas_solve

    total = lambda c: sum(c.values()) if isinstance(c, dict) else c
    return {"babe": total(babe_thomas_solve.launches),
            "linesearch": total(linesearch_update.launches)}


@contextlib.contextmanager
def _wrapped(module, name: str, before, after):
    """While active, ``module.name`` is called between ``before()`` and
    ``after(before's value)``; the call itself is unchanged."""
    real = getattr(module, name)

    def call(*args, **kw):
        mark = before()
        try:
            return real(*args, **kw)
        finally:
            after(mark)

    setattr(module, name, call)
    try:
        yield
    finally:
        setattr(module, name, real)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--players", type=int, default=4)
    p.add_argument("--horizon", type=int, default=30)
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--tier", default="tridiag_pallas")
    p.add_argument("--no-polish", dest="polish", action="store_false")
    p.add_argument("--no-staged", action="store_true")
    p.add_argument("--first-step-out", default=None)
    args = p.parse_args(argv)

    import torch

    from .. import diff
    from .._device import resolve_device
    from ..bench.flagships import load_staged_train_step, train_step_setup
    from ..trajectories import game_builder
    from ..types import SOLVED

    device = resolve_device("cpu" if args.cpu else "cuda")
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device: {name}", file=sys.stderr)
    t_start = time.monotonic()
    N, T, B = args.players, args.horizon, args.batch
    s = None
    if not args.no_staged:
        s = load_staged_train_step(B, N, T, tier=args.tier, polish=args.polish, device=device)
        if s is not None:
            print("using the staged step (probes, options and inputs)", file=sys.stderr)
    staged = s is not None
    if not staged:
        probes_s = []
        with _wrapped(game_builder, "probe_game", time.perf_counter,
                      lambda t0: probes_s.append(time.perf_counter() - t0)):
            s = train_step_setup(B, N, T, tier=args.tier, polish=args.polish, device=device)
        s.seconds["game"] -= sum(probes_s)
        s.seconds["probes"] = sum(probes_s)
    setup_s = time.monotonic() - t_start
    print(f"N={N} T={T} B={B} tier={args.tier} rate={s.rate} polish={args.polish}; "
          f"setup {setup_s:.2f} s {s.seconds}", file=sys.stderr)
    print(f"ground-truth solve success: {s.gt_success:.3f}", file=sys.stderr)

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    counts = {"babe_forward": 0, "babe_backward": 0, "linesearch": 0}

    def count_backward(before):
        counts["babe_backward"] += _launches()["babe"] - before

    def step(model, init):
        before, backward = _launches(), counts["babe_backward"]
        with _wrapped(diff, "_band_solve", lambda: _launches()["babe"], count_backward):
            loss, aux, grads = s.train_step(model, s.trajectories, init, s.goals)
        float(loss)
        float(grads[0].sum())
        after = _launches()
        counts["babe_forward"] += (after["babe"] - before["babe"]
                                   - (counts["babe_backward"] - backward))
        counts["linesearch"] += after["linesearch"] - before["linesearch"]
        return loss, aux, grads

    loss, aux, grads = step(s.model, s.init)
    compile_s = time.monotonic() - t_start
    print(f"setup + first step: {compile_s:.1f} s", file=sys.stderr)
    if args.first_step_out:
        torch.save({"loss": loss.cpu(), "status": aux[1].cpu(),
                    "grads": [g.cpu() for g in grads]}, args.first_step_out)
    model = s.model

    times = []
    for r in range(args.repeats):
        noise = torch.randn(s.init.shape, generator=torch.Generator().manual_seed(r),
                            dtype=torch.float64)
        init_r = s.init + 1e-3 * noise.to(device=device, dtype=s.init.dtype)
        sync()
        t0 = time.perf_counter()
        loss, aux, grads = step(model, init_r)
        times.append(time.perf_counter() - t0)
        model = s.sgd_update(model, grads, s.config.learning_rate)

    step_t = statistics.median(times) if times else float("nan")
    status = aux[1]
    print(json.dumps({"launches": counts}))
    out = {
        "metric": "train_step_seconds",
        "value": round(step_t, 4),
        "unit": "s/step",
        "batch_size": B,
        "players": N,
        "horizon": T,
        "examples_per_sec": round(B / step_t, 2),
        "forward_success_rate": float((status == SOLVED).double().mean()),
        "loss": float(loss),
        "grads_finite": all(bool(torch.isfinite(g).all()) for g in grads),
        "certified_forward": bool(args.polish),
        "compile_s": round(compile_s, 1),
        "device": name,
        "staged": staged,
        "setup_s": round(setup_s, 3),
        "setup_split_s": {k: round(v, 3) for k, v in s.seconds.items()},
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
