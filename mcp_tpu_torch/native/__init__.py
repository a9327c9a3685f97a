"""Native (C++) host components, bound with ctypes: the scenario sampler of
the player-selection data layer (``scenario_gen.cpp``, the JAX package's
``native/``).

The library builds at first use with ``g++ -O3 -shared -fPIC`` into
``build/mcp_tpu_torch/scenario_gen-<hash>.so`` under the repository root,
named after a hash of the source and the flags, so an edit rebuilds;
nothing is written beside the source. It is a host sampler, not a device
path: its draws equal the JAX package's native backend bit for bit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "scenario_gen.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mcp_tpu_torch"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")
MAX_PLAYERS = 64  # the sampler's fixed stack bound

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"scenario_gen-{h.hexdigest()[:16]}.so"


def load() -> ctypes.CDLL:
    """The sampler's library, built on first use; raises RuntimeError when
    the build or the load fails."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        target = library_path()
        try:
            if not target.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
                out = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                                     capture_output=True, text=True)
                if out.returncode != 0:
                    raise RuntimeError(f"g++ failed on {SOURCE.name}:\n{out.stderr}")
                os.replace(tmp, target)
            lib = ctypes.CDLL(str(target))
        except (OSError, subprocess.SubprocessError) as exc:
            raise RuntimeError(f"native scenario sampler unavailable: {exc}") from exc
        lib.mcp_generate_scenarios.restype = ctypes.c_int
        lib.mcp_generate_scenarios.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_uint64, ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ]
        _LIB = lib
        return lib


def native_available() -> bool:
    try:
        load()
    except RuntimeError:
        return False
    return True


def generate_scenarios_native(
    *,
    num_scenarios: int,
    num_players: int,
    arena_half_width: float,
    min_separation: float,
    max_speed: float,
    seed: int,
) -> tuple[np.ndarray, np.ndarray]:
    """(states (S, N, 4), goals (S, N, 2)) float64, S ≤ num_scenarios (a
    scenario whose rejection sampling gives up is dropped). Seed 0 draws as
    seed 1, as in the JAX package. Raises RuntimeError when the library is
    unavailable, ValueError above MAX_PLAYERS players."""
    if num_players > MAX_PLAYERS:
        raise ValueError(f"the native sampler takes at most {MAX_PLAYERS} players")
    lib = load()
    states = np.empty((num_scenarios, num_players, 4), dtype=np.float64)
    goals = np.empty((num_scenarios, num_players, 2), dtype=np.float64)
    n = lib.mcp_generate_scenarios(
        num_scenarios, num_players, arena_half_width, min_separation, max_speed,
        np.uint64(seed or 1),
        states.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        goals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return states[:n], goals[:n]
