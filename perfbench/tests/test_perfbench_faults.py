"""The check refuses a broken program: a run on the CPU at a tiny batch,
past the harness's look for a card, with the timed path broken underneath,
comes out not correct, once for each fault a solve cell can have. (The
exchange between chips is not a fault here: every cell runs on one card.)"""

import json

import pytest
import torch

import mcp_tpu_torch.parallel.batch as batch_module
from mcp_tpu_torch.solver import default_initialization
from mcp_tpu_torch.types import SOLVED, SolveResult
from perfbench import run, spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
REAL = batch_module.solve_batch


def unchanged(mcp, thetas, **kw):
    """The state comes back as it went in, reported solved."""
    x, y, s = default_initialization(mcp, thetas, None, None, None)
    B = thetas.shape[0]
    return SolveResult(x, y, s, torch.zeros(B, dtype=x.dtype), torch.zeros(B, dtype=x.dtype),
                       torch.ones(B, dtype=torch.int32), torch.full((B,), SOLVED, dtype=torch.int32))


def half_left_out(mcp, thetas, **kw):
    """Only the first half is solved; the rest gets its answers."""
    h = thetas.shape[0] // 2
    r = REAL(mcp, thetas[:h], **kw)
    return SolveResult(*(torch.cat([f, f]) for f in r))


def altered(mcp, thetas, **kw):
    """One lane's answer altered where it is produced."""
    r = REAL(mcp, thetas, **kw)
    x = r.x.clone()
    x[-1, 0] += 1e-2
    return r._replace(x=x)


def never_solved(mcp, thetas, **kw):
    """No lane converges: every lane reported failed."""
    r = REAL(mcp, thetas, **kw)
    return r._replace(status=torch.ones_like(r.status))


def run_tiny(name, seed=2**31 + 11):
    cell = spec.cell(name, spec.benchmark())
    cell = cell._replace(traffic={**cell.traffic, "batch": 4})
    return run.run_cell(cell, seed, 0.01, False, torch.device("cpu"), {})


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_tiny_run_is_correct(name):
    out = run_tiny(name)
    assert out["correct"], json.dumps(out["checks"])
    assert list(out)[-1] == "checks"
    assert out["attempted"] == 4 * out["calls"]


@pytest.mark.parametrize("fault", [unchanged, half_left_out, altered, never_solved],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("name", CELLS)
def test_a_fault_is_not_correct(name, fault, monkeypatch):
    monkeypatch.setattr(batch_module, "solve_batch", fault)
    out = run_tiny(name)
    assert not out["correct"], json.dumps(out["checks"])
