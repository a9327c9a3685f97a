"""Build the CUDA sources under ``csrc/`` with nvcc at first use and load them
with ctypes.

Each ``csrc/<name>.cu`` becomes ``<name>-<hash>.so`` in
``utils.devices.persistent_cache_dir()`` (``build/mcp_tpu_torch/`` under the
repository root, or ``MCPTPU_CACHE_DIR`` where that is set), named after a
hash of the source, of every header
it includes from ``csrc/`` (``#include "..."``, followed through headers) and
of the flags, so an edit of any of them rebuilds. Nothing here runs at import: the first CUDA tensor that
reaches a kernel wrapper builds its library (``build`` compiles several
sources in parallel, one nvcc each). The sources have a plain C interface
and include no PyTorch header, so each compiles in seconds. A source with
many template instances (PARTS) compiles as several translation units at
once, one nvcc each with ``-DMCP_PART=k``, whose objects one more nvcc links
into its library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

from ..utils.devices import persistent_cache_dir

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
SOURCES = ("thomas", "linesearch", "gauss_jordan", "qr_dense", "cyclic_reduction",
           "thomas_babe", "thomas_multi", "qr_sep", "wy_qr")
# Translation units per source where more than one: each part holds a share
# of the instances (see the source's MCP_PART), so that the longest nvcc of
# the build is shorter.
PARTS = {"thomas_babe": 4, "cyclic_reduction": 2}

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH); the CUDA kernels of mcp_tpu_torch need the CUDA toolkit"
        )
    return found


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _sources(path: Path, seen: dict[Path, bytes]) -> dict[Path, bytes]:
    """``path`` and every file it includes with quotes, in include order."""
    if path not in seen:
        seen[path] = text = path.read_bytes()
        for inc in _INCLUDE.findall(text):
            _sources(path.parent / inc.decode(), seen)
    return seen


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for path, text in _sources(CSRC / f"{name}.cu", {}).items():
        h.update(path.name.encode() + b"\0" + text)
    h.update(" ".join(NVCC_FLAGS).encode() + b"\0" + str(PARTS.get(name, 1)).encode())
    return Path(persistent_cache_dir()) / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, str]:
    """Compile every library of ``names`` that is not built yet, all nvcc
    processes at once (a source of PARTS one per part, then one link).
    Returns the compiler output (ptxas register and shared-memory report) of
    each source compiled; raises on a failure."""
    Path(persistent_cache_dir()).mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        src = str(CSRC / f"{name}.cu")
        parts = PARTS.get(name, 1)
        if parts == 1:
            cmds = [[nvcc, *NVCC_FLAGS, "-o", str(tmp), src]]
        else:
            flags = [f for f in NVCC_FLAGS if f != "-shared"]
            objs = [tmp.with_name(f"{tmp.name}.{k}.o") for k in range(parts)]
            cmds = [[nvcc, *flags, f"-DMCP_PART={k}", "-c", "-o", str(o), src]
                    for k, o in enumerate(objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
                 for c in cmds]
        jobs[name] = (procs, tmp, target, parts)
    logs, failed = {}, []
    for name, (procs, tmp, target, parts) in jobs.items():
        outs = [p.communicate()[0].decode(errors="replace") for p in procs]
        ok = all(p.returncode == 0 for p in procs)
        if ok and parts > 1:
            objs = [tmp.with_name(f"{tmp.name}.{k}.o") for k in range(parts)]
            link = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                                   *map(str, objs)], capture_output=True, text=True)
            outs.append(link.stdout + link.stderr)
            ok = link.returncode == 0
            for o in objs:
                o.unlink(missing_ok=True)
        logs[name] = "".join(outs)
        if not ok:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(logs[n] for n in failed)
        )
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return lib
