"""Random convex-QP benchmark problems (the reference's
benchmark/quadratic_program_benchmark.jl):

    min_x 0.5 xᵀMx − ϕᵀx   s.t.  Ax − b ≥ 0,
    θ = [vec(M); vec(A); b; ϕ],   M = (P∘mask)ᵀ(P∘mask),

with Bernoulli sparsity masks (rate 0.9 by default) and 100 primals and 100
inequalities. About 1 draw in 256 is infeasible by construction (a masked
row of A can leave no x with Ax ≥ b).

The θ samplers draw from a ``torch.Generator`` on its own device; they match
the JAX package's samplers in distribution, not in values.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .._device import resolve_device
from ..mcp import PrimalDualMCP

Tensor = torch.Tensor


class QPProblem(NamedTuple):
    mcp: PrimalDualMCP
    num_primals: int
    num_inequalities: int
    device: torch.device


def unpack_parameters(theta: Tensor, *, num_primals: int, num_inequalities: int):
    """θ (..., p) → (M (..., n, n), A (..., m, n), b (..., m), ϕ (..., n))."""
    n, m = num_primals, num_inequalities
    lead = theta.shape[:-1]
    M = theta[..., : n * n].reshape(*lead, n, n)
    A = theta[..., n * n : n * n + m * n].reshape(*lead, m, n)
    b = theta[..., n * n + m * n : n * n + m * (n + 1)]
    phi = theta[..., n * n + m * (n + 1) :]
    return M, A, b, phi


def parameter_dimension(num_primals: int, num_inequalities: int) -> int:
    return num_primals * num_primals + num_inequalities * (num_primals + 1) + num_primals


def generate_test_problem(
    *, num_primals: int = 100, num_inequalities: int = 100, device="cuda"
) -> QPProblem:
    """The parameterized QP-KKT MCP: G = Mx − ϕ − Aᵀy, H = Ax − b, affine in
    (x, y), so the solver extracts its Jacobian once per solve. The MCP
    closes over nothing but θ; ``device`` (default ``"cuda"``, which raises
    without a GPU) is where its θ batches are drawn and solved."""
    device = resolve_device(device)
    n, m = num_primals, num_inequalities

    def G(x, y, theta):
        M, A, b, phi = unpack_parameters(theta, num_primals=n, num_inequalities=m)
        return M @ x - phi - A.T @ y

    def H(x, y, theta):
        M, A, b, phi = unpack_parameters(theta, num_primals=n, num_inequalities=m)
        return A @ x - b

    mcp = PrimalDualMCP.from_gh(
        G,
        H,
        unconstrained_dimension=n,
        constrained_dimension=m,
        parameter_dimension=parameter_dimension(n, m),
        affine=True,
    )
    return QPProblem(mcp=mcp, num_primals=n, num_inequalities=m, device=device)


def generate_parameter_batch(
    generator: torch.Generator,
    batch: int,
    *,
    num_primals: int = 100,
    num_inequalities: int = 100,
    sparsity_rate: float = 0.9,
    dtype=torch.float32,
    device="cuda",
) -> Tensor:
    """(batch, p) random sparse convex-QP parameters: P and A standard
    normal with each entry kept with probability 1 − sparsity_rate, M = PᵀP,
    b and ϕ standard normal. Drawn in float64 on the generator's device (a
    CPU generator draws on the CPU, a CUDA one on the card) from
    ``generator``, then moved to ``device`` in ``dtype``."""
    device = resolve_device(device)
    n, m = num_primals, num_inequalities
    kw = dict(generator=generator, dtype=torch.float64, device=generator.device)
    keep = 1.0 - sparsity_rate

    def sparse_normal(rows, cols):
        values = torch.randn((batch, rows, cols), **kw)
        mask = torch.rand((batch, rows, cols), **kw) < keep
        return values * mask

    P = sparse_normal(n, n)
    M = P.mT @ P
    A = sparse_normal(m, n)
    b = torch.randn((batch, m), **kw)
    phi = torch.randn((batch, n), **kw)
    theta = torch.cat([M.reshape(batch, -1), A.reshape(batch, -1), b, phi], dim=1)
    return theta.to(device=device, dtype=dtype)


def generate_random_parameter(generator: torch.Generator, **kwargs) -> Tensor:
    """One θ, (p,); see ``generate_parameter_batch``."""
    return generate_parameter_batch(generator, 1, **kwargs)[0]


# The dry run's QP (``dryrun.py``'s tp and ep axes): G = Mx − θ − Aᵀy
# (+ shift·x), H = Ax − b, M = PPᵀ + nI, from numpy's RandomState(0) as the
# JAX package draws it.
DRYRUN_QP_N, DRYRUN_QP_M = 12, 6


def dryrun_qp(shift: float = 0.0) -> PrimalDualMCP:
    """The dry run's QP (see DRYRUN_QP_N): G = Mx − θ − Aᵀy + shift·x,
    H = Ax − b."""
    import numpy as np

    from .._device import const

    n, m = DRYRUN_QP_N, DRYRUN_QP_M
    rng = np.random.RandomState(0)
    P = rng.randn(n, n)
    M = (P @ P.T + n * np.eye(n)).astype(np.float32)
    A = rng.randn(m, n).astype(np.float32)
    b = rng.randn(m).astype(np.float32)
    c = lambda a, x: const(a, x.dtype, x.device)
    return PrimalDualMCP.from_gh(
        lambda x, y, t: c(M, x) @ x - t - c(A, x).T @ y + shift * x,
        lambda x, y, t: c(A, x) @ x - c(b, x),
        unconstrained_dimension=n, constrained_dimension=m, parameter_dimension=n)
