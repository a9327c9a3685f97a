"""The random QP's KKT residual, written from its definition (the upstream's
benchmark/quadratic_program_benchmark.jl:7-48): for
min ½xᵀMx − ϕᵀx s.t. Ax − b ≥ 0 with θ = [vec(M); vec(A); b; ϕ] (row-major),
G = Mx − ϕ − Aᵀy and H = Ax − b. Imports nothing of the program."""

from __future__ import annotations

import torch


def gh(cfg: dict, theta: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """(G (batch, n), H (batch, m)) in the dtype of the inputs."""
    n, m = cfg["num_primals"], cfg["num_inequalities"]
    B = theta.shape[0]
    M = theta[:, :n * n].reshape(B, n, n)
    A = theta[:, n * n:n * n + m * n].reshape(B, m, n)
    b = theta[:, n * n + m * n:n * n + m * n + m]
    phi = theta[:, n * n + m * n + m:]
    G = (M @ x[..., None])[..., 0] - phi - (A.mT @ y[..., None])[..., 0]
    H = (A @ x[..., None])[..., 0] - b
    return G, H
