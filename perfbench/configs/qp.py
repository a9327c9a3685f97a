"""The random-QP configuration: the port's QP-KKT MCP and the benchmark's own
θ sampler.

``sample`` is a frozen copy of the port's ``bench/qp.py`` sampler, itself
the upstream's ``generate_random_parameter``
(benchmark/quadratic_program_benchmark.jl:51-74): P and A standard normal
with each entry kept with probability 1 − sparsity, M = PᵀP, b and ϕ
standard normal, θ = [vec(M); vec(A); b; ϕ] (row-major). About one draw in
256 is infeasible by construction.
"""

from __future__ import annotations

import torch

from perfbench.problem import Problem, solver_options


def build(cfg: dict, device: torch.device) -> Problem:
    """The port's QP-KKT MCP and the configuration's solver options."""
    from mcp_tpu_torch.bench.qp import generate_test_problem

    problem = generate_test_problem(num_primals=cfg["num_primals"],
                                    num_inequalities=cfg["num_inequalities"], device=device)
    if problem.mcp.parameter_dimension != cfg["parameter_dimension"]:
        raise ValueError("the port's QP has another parameter dimension than the "
                         "configuration states")
    return Problem(mcp=problem.mcp, options=solver_options(cfg, problem.mcp))


def sample(cfg: dict, generator: torch.Generator, batch: int) -> torch.Tensor:
    """(batch, p) θ in float64 on the generator's device."""
    n, m = cfg["num_primals"], cfg["num_inequalities"]
    kw = dict(generator=generator, dtype=torch.float64, device=generator.device)
    keep = 1.0 - cfg["sparsity_rate"]

    def sparse_normal(rows, cols):
        values = torch.randn((batch, rows, cols), **kw)
        mask = torch.rand((batch, rows, cols), **kw) < keep
        return values * mask

    P = sparse_normal(n, n)
    M = P.mT @ P
    A = sparse_normal(m, n)
    b = torch.randn((batch, m), **kw)
    phi = torch.randn((batch, n), **kw)
    return torch.cat([M.reshape(batch, -1), A.reshape(batch, -1), b, phi], dim=1)
