"""The benchmark of mcp_tpu_torch on NVIDIA GPUs: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``. A run builds the
cell's problem, makes one warm call, drives the program for ``--seconds``
(``--trace 1``: the traffic's ``trace_seconds`` at most, under
torch.profiler), then holds every answer of the window to the plain
reference. Progress goes to standard error, ending with each number
compared beside its limit; the last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, ``breakdown`` with ``--trace 1``, and ``checks`` last.

It exits with another code than 0, and prints no result, without a CUDA
card (or with fewer than the cell asks for), when the program cannot be
imported from the checkout, and when JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: Top-level modules that no run may load.
FORBIDDEN = ("jax", "jaxlib", "flax", "mcp_tpu")


def log(msg: str) -> None:
    print(f"[perfbench +{time.perf_counter() - T_START:7.2f}s] {msg}", file=sys.stderr,
          flush=True)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cache_dirs(root: Path) -> dict:
    """Every build and kernel cache of the program, at fixed paths inside the
    checkout (``build/`` is not committed)."""
    build = root / "build"
    return {
        "MCPTPU_CACHE_DIR": str(build / "mcp_tpu_torch"),
        "TORCH_EXTENSIONS_DIR": str(build / "perfbench" / "torch_extensions"),
        "TRITON_CACHE_DIR": str(build / "perfbench" / "triton"),
    }


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def import_program(root: Path):
    """The port, from this checkout and nowhere else."""
    import mcp_tpu_torch

    where = Path(mcp_tpu_torch.__file__).resolve()
    if root not in where.parents:
        raise ImportError(f"mcp_tpu_torch was imported from {where}, outside {root}")
    return mcp_tpu_torch


def run_cell(cell, seed: int, seconds: float, trace: bool, device, splits: dict) -> dict:
    """One run of ``cell`` on ``device``; returns the result's fields."""
    import torch

    from perfbench import check, spec
    from perfbench import trace as tracing
    from perfbench.session import Session

    on_card = device.type == "cuda"
    t = time.perf_counter()
    session = Session(cell, seed, device)
    splits["build_s"] = time.perf_counter() - t
    t = time.perf_counter()
    if on_card:
        from mcp_tpu_torch.kernels import _build

        for name in cell.config.get("libraries", ()):
            _build.load(name)
    splits["libraries_s"] = time.perf_counter() - t
    loop = spec.loop_module(cell)
    splits.update(loop.warm(session))
    setup_s = time.perf_counter() - T_START
    splits["setup_s"] = setup_s
    log(f"set-up {setup_s:.2f} s ({', '.join(f'{k} {v:.2f}' for k, v in splits.items())}); "
        f"window of {seconds:g} s at batch {session.batch}")

    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    profile = None
    if trace:
        window_seconds = min(seconds, float(cell.traffic["trace_seconds"]))
        with tracing.profiled(on_card) as events:
            window = loop.drive(session, window_seconds)
        t = time.perf_counter()
        profile = tracing.reduce(events)
        del events
        log(f"trace of {profile.calls} calls read in {time.perf_counter() - t:.1f} s")
    else:
        window = loop.drive(session, seconds)
    memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    bad = forbidden_modules()
    if bad:
        raise ForbiddenImport(bad)
    log(f"window closed: {len(window.calls)} calls in {window.host_s:.3f} s (events "
        f"{window.event_s}, consistent {window.consistent}); peak {memory_peak} bytes")
    if on_card:
        torch.cuda.empty_cache()

    t = time.perf_counter()
    verdict = check.judge(session, window, loop, spec.reference_module(cell))
    log(f"check of {verdict.attempted} lanes in {time.perf_counter() - t:.1f} s: "
        f"{verdict.certified} certified; {json.dumps(verdict.readings)}")
    ctx = SimpleNamespace(config=cell.config, traffic=cell.traffic, batch=session.batch,
                          setup_s=setup_s)
    metrics, extra = {}, {}
    if trace:
        for m in cell.per_layer:
            value = spec.per_layer_reader(m["name"]).read(profile, ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        extra["traced_solves_per_s"] = verdict.certified / window.host_s
    else:
        for m in cell.end_to_end:
            value = spec.end_to_end_reader(m["name"]).read(window, verdict, ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(memory_peak)}
    out = {"correct": verdict.correct,
           "attempted": verdict.attempted,
           "failed": verdict.attempted - verdict.certified,
           "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = profile.busy_s()
        dev["window_s"] = profile.window_s
        out["breakdown"] = tracing.breakdown(profile)
    out["calls"] = len(window.calls)
    out["window_s"] = window.host_s
    out["timing_consistent"] = window.consistent
    out["setup_split"] = splits
    out.update(extra)
    out["readings"] = verdict.readings
    out["checks"] = {name: {"value": v, "limit": lim} for name, (v, lim) in
                     verdict.numbers.items()}
    return out


class ForbiddenImport(RuntimeError):
    def __init__(self, names):
        super().__init__("loaded in this process: " + ", ".join(names))
        self.names = names


def main(argv=None) -> int:
    args = parse(argv)
    from perfbench import spec

    cell = spec.cell(args.workload, spec.benchmark(ROOT))
    os.environ.update(cache_dirs(ROOT))
    splits = {}
    try:
        import_program(ROOT)
    except ImportError as e:
        log(f"no result: the program cannot be imported from this checkout ({e})")
        return 4
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"no result: {cell.name} needs {cell.chips} CUDA card(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}")
        return 2
    splits["import_s"] = time.perf_counter() - T_START
    device = torch.device("cuda", 0)
    try:
        out = run_cell(cell, args.seed, args.seconds, bool(args.trace), device, splits)
        bad = forbidden_modules()
        if bad:
            raise ForbiddenImport(bad)
    except ForbiddenImport as e:
        log(f"no result: {e}")
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
