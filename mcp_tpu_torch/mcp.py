"""Parameterized mixed complementarity problems (MCPs) in primal-dual form.

An MCP is given by callables ``G`` and ``H`` such that

    0  = G(x, y, θ)
    0 <= H(x, y, θ)  ⟂  y >= 0.

With a slack ``s`` and a central-path relaxation ``ϵ > 0`` the primal-dual
residual is

    F(x, y, s; θ, ϵ) = [ G(x, y, θ) ; H(x, y, θ) - s ; s∘y - ϵ ],

driven to 0 by the interior-point solver as ϵ → 0.

``G``/``H`` are plain PyTorch functions of ONE instance (x (n,), y (m,),
θ (p,)). Jacobians come from ``torch.func.jacfwd``; batches come from
``torch.func.vmap`` (see ``gh_batched``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch.func import jacfwd, vmap

from ._device import matmul_precision

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True, eq=False)
class PrimalDualMCP:
    """A parameterized MCP in primal-dual form.

    Attributes:
      G: ``G(x, y, theta) -> (n,)``, the unconstrained residual.
      H: ``H(x, y, theta) -> (m,)``, the constrained residual.
      unconstrained_dimension: n, size of x.
      constrained_dimension: m, size of y (and s).
      parameter_dimension: p, size of θ.
      compute_sensitivities: whether differentiation through a solve is
        permitted (``diff.py`` raises a ValueError otherwise).
      GH: optional fused callable returning ``(G, H)`` in one evaluation.
      time_structure: optional ``kernels.block_tridiag.TimeStructure`` of the
        schur-condensed Newton system (set by the trajectory-game builder).
      assume_hy_zero: H does not depend on y (every KKT-stacked game).
      affine_bands: optional ``kernels.block_tridiag.AffineBands``, the exact
        affine decomposition of the banded Jacobian (quadratic games).
      affine: (G, H) are affine in (x, y) for fixed θ.

    ``eq=False`` gives identity hashing, so an MCP can key caches.
    """

    G: Callable[[Tensor, Tensor, Tensor], Tensor]
    H: Callable[[Tensor, Tensor, Tensor], Tensor]
    unconstrained_dimension: int
    constrained_dimension: int
    parameter_dimension: int
    compute_sensitivities: bool = True
    GH: Optional[Callable[[Tensor, Tensor, Tensor], tuple[Tensor, Tensor]]] = None
    time_structure: Optional[object] = None
    assume_hy_zero: bool = False
    affine_bands: Optional[object] = None
    affine: bool = False

    # -- residual assembly ---------------------------------------------------

    def gh(self, x: Tensor, y: Tensor, theta: Tensor) -> tuple[Tensor, Tensor]:
        """Evaluate (G, H) for one instance, fused when available."""
        if self.GH is not None:
            return self.GH(x, y, theta)
        return self.G(x, y, theta), self.H(x, y, theta)

    def gh_batched(
        self, x: Tensor, y: Tensor, theta: Tensor
    ) -> tuple[Tensor, Tensor]:
        """(G, H) over a leading batch axis: x (B, n), y (B, m), θ (B, p)."""
        return vmap(self.gh)(x, y, theta)

    def F(self, x: Tensor, y: Tensor, s: Tensor, theta: Tensor, epsilon) -> Tensor:
        """Primal-dual residual ``[G; H - s; s∘y - ϵ]``."""
        g, h = self.gh(x, y, theta)
        return torch.cat([g, h - s, s * y - epsilon])

    def F_parts(
        self, x: Tensor, y: Tensor, s: Tensor, theta: Tensor, epsilon
    ) -> tuple[Tensor, Tensor, Tensor]:
        """Residual split into (rG, rH, rC) blocks."""
        g, h = self.gh(x, y, theta)
        return g, h - s, s * y - epsilon

    def _stacked(self, theta: Tensor):
        n = self.unconstrained_dimension

        def stacked(w):
            g, h = self.gh(w[:n], w[n:], theta)
            return torch.cat([g, h])

        return stacked

    def gh_jacobians(self, x: Tensor, y: Tensor, theta: Tensor):
        """Jacobians of (G, H) w.r.t. (x, y) by forward mode, for one
        instance: (Gx, Gy, Hx, Hy) of shapes (n,n), (n,m), (m,n), (m,m)."""
        n = self.unconstrained_dimension
        J = jacfwd(self._stacked(theta))(torch.cat([x, y]))
        return J[:n, :n], J[:n, n:], J[n:, :n], J[n:, n:]

    def gh_linearized(self, x: Tensor, y: Tensor, theta: Tensor):
        """(G, H) values AND their Jacobians w.r.t. (x, y), for one
        instance. Returns (g, h, Gx, Gy, Hx, Hy)."""
        g, h = self.gh(x, y, theta)
        return (g, h) + self.gh_jacobians(x, y, theta)

    def gh_affine_data(self, theta: Tensor, dtype=None):
        """Affine decomposition ``G = g0 + Gx·x + Gy·y``, ``H = h0 + Hx·x +
        Hy·y`` of a batch, valid only when ``affine=True`` (constant
        Jacobians): θ (B, p) → g0 (B, n), h0 (B, m), Gx (B, n, n),
        Gy (B, n, m), Hx (B, m, n), Hy (B, m, m). Evaluated at (x, y) = 0, so
        g0/h0 are the pure-θ offsets; one forward-mode Jacobian per solve
        serves every Newton step."""
        dtype = dtype or theta.dtype
        theta = theta.to(dtype)
        B = theta.shape[0]
        x0 = theta.new_zeros((B, self.unconstrained_dimension))
        y0 = theta.new_zeros((B, self.constrained_dimension))
        g0, h0 = self.gh_batched(x0, y0, theta)
        return (g0, h0) + vmap(self.gh_jacobians)(x0, y0, theta)

    def total_dimension(self) -> int:
        return self.unconstrained_dimension + 2 * self.constrained_dimension

    # -- constructors --------------------------------------------------------

    @staticmethod
    def from_gh(
        G: Callable[[Tensor, Tensor, Tensor], Tensor],
        H: Callable[[Tensor, Tensor, Tensor], Tensor],
        *,
        unconstrained_dimension: int,
        constrained_dimension: int,
        parameter_dimension: int,
        compute_sensitivities: bool = True,
        affine: bool = False,
    ) -> "PrimalDualMCP":
        """Construct from callables G(x, y, θ), H(x, y, θ)."""
        return PrimalDualMCP(
            G=G,
            H=H,
            unconstrained_dimension=unconstrained_dimension,
            constrained_dimension=constrained_dimension,
            parameter_dimension=parameter_dimension,
            compute_sensitivities=compute_sensitivities,
            affine=affine,
        )

    @staticmethod
    def from_k(
        K: Callable[[Tensor, Tensor], Tensor],
        lower_bounds: Sequence[float],
        upper_bounds: Sequence[float],
        *,
        parameter_dimension: int,
        compute_sensitivities: bool = True,
        affine: bool = False,
    ) -> "PrimalDualMCP":
        """Construct from ``K(z, θ) ⟂ lb ≤ z ≤ ub``. All upper bounds must
        be +Inf and lower bounds -Inf or 0: rows with lb = -Inf become G / x,
        rows with lb = 0 become H / y."""
        lb = np.asarray(lower_bounds, dtype=np.float64)
        ub = np.asarray(upper_bounds, dtype=np.float64)
        if not np.all(np.isinf(ub)):
            raise ValueError("All upper bounds must be +Inf.")
        if not np.all(np.isinf(lb) | (lb == 0)):
            raise ValueError("All lower bounds must be -Inf or 0.")

        unc = np.flatnonzero(np.isinf(lb))
        con = np.flatnonzero(~np.isinf(lb))
        n, m = len(unc), len(con)
        perm = np.empty(len(lb), dtype=np.int64)
        perm[unc] = np.arange(n)
        perm[con] = n + np.arange(m)

        from ._device import const

        def gh(x, y, theta):
            dev = x.device
            z = torch.cat([x, y])[const(perm, torch.long, dev)]
            k = K(z, theta)
            return k[const(unc, torch.long, dev)], k[const(con, torch.long, dev)]

        return PrimalDualMCP(
            G=lambda x, y, theta: gh(x, y, theta)[0],
            H=lambda x, y, theta: gh(x, y, theta)[1],
            unconstrained_dimension=n,
            constrained_dimension=m,
            parameter_dimension=parameter_dimension,
            compute_sensitivities=compute_sensitivities,
            GH=gh,
            affine=affine,
        )


def verify_affine(
    mcp: PrimalDualMCP,
    theta: Tensor,
    *,
    generator: Optional[torch.Generator] = None,
    atol: float = 1e-4,
) -> bool:
    """Numerically check that (G, H) are affine in (x, y) at θ ((p,) or a
    batch (B, p)): the affine model of ``gh_affine_data`` must reproduce
    ``gh`` at two random probe points within ``atol``. The probes are
    standard normal draws from ``generator`` (a CPU generator; default seed
    7), moved to θ's device. Call it before constructing an MCP with
    ``affine=True`` whose structure is not known analytically. An accuracy
    metric: float32 matmuls run at full precision, whatever the caller's."""
    generator = torch.Generator().manual_seed(7) if generator is None else generator
    theta = theta[None] if theta.dim() == 1 else theta
    B, n, m = theta.shape[0], mcp.unconstrained_dimension, mcp.constrained_dimension
    with torch.no_grad(), matmul_precision("highest"):
        g0, h0, Gx, Gy, Hx, Hy = mcp.gh_affine_data(theta)

        def off(v, v0, Jx, Jy, x, y):
            e = v - (v0 + (Jx @ x[..., None])[..., 0] + (Jy @ y[..., None])[..., 0])
            return float(e.abs().max()) if e.numel() else 0.0

        for _ in range(2):
            x = torch.randn((B, n), generator=generator, dtype=torch.float64)
            y = torch.randn((B, m), generator=generator, dtype=torch.float64)
            x, y = (v.to(device=theta.device, dtype=g0.dtype) for v in (x, y))
            g, h = mcp.gh_batched(x, y, theta)
            if off(g, g0, Gx, Gy, x, y) > atol or off(h, h0, Hx, Hy, x, y) > atol:
                return False
    return True
