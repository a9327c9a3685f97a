"""Where build outputs and the game build's probes go (the JAX package's
``utils/devices.py``).

* ``persistent_cache_dir()``: the directory that keeps what a run builds for
  the next one, the kernel libraries of ``kernels/_build.py``:
  ``MCPTPU_CACHE_DIR`` if set, else ``build/mcp_tpu_torch/`` under the
  repository root.
* ``cpu_probe_device()`` and ``probes_on_cpu()``: the one-shot numeric
  probes of ``trajectories.build_parametric_game`` (bandwidth check, row
  assignment, affine bands) run on the CPU in float64, whatever device the
  game's solves use; the context makes the CPU the default device of the
  tensors created inside it.

The JAX package's ``enable_host_probe_backend`` and ``configure_tpu_cache``
set JAX's platform list and its compile cache; PyTorch has the CPU beside
every card and compiles nothing ahead of a call, so they have no
counterpart here beyond ``persistent_cache_dir``.
"""

from __future__ import annotations

import contextlib
import os
from pathlib import Path

import torch

#: The build directory when ``MCPTPU_CACHE_DIR`` is not set.
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / "build" / "mcp_tpu_torch"


def persistent_cache_dir() -> str:
    """``MCPTPU_CACHE_DIR`` if set, else ``build/mcp_tpu_torch/`` under the
    repository root (which .gitignore lists)."""
    return os.environ.get("MCPTPU_CACHE_DIR") or str(DEFAULT_CACHE_DIR)


def cpu_probe_device() -> torch.device:
    """The device the game build's probes run on."""
    return torch.device("cpu")


@contextlib.contextmanager
def probes_on_cpu():
    """Tensors created inside the block without a device go to
    ``cpu_probe_device()``."""
    with cpu_probe_device():
        yield
