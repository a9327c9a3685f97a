"""Polygon environments as halfspace constraint generators: a convex polygon
from counter-clockwise vertices, exposed as per-position residuals
b - aᵀp ≥ 0."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._device import const


@dataclasses.dataclass(frozen=True, eq=False)
class PolygonEnvironment:
    """Convex polygon from CCW-ordered 2D vertices."""

    vertices: np.ndarray  # (num_vertices, 2)
    A: np.ndarray  # (num_edges, 2) outward normals
    b: np.ndarray  # (num_edges,)

    @staticmethod
    def from_vertices(vertices) -> "PolygonEnvironment":
        V = np.asarray(vertices, dtype=np.float64)
        if V.ndim != 2 or V.shape[1] != 2:
            raise ValueError("vertices must be (num_vertices, 2)")
        # Edge v_i -> v_{i+1}; the outward normal of a CCW polygon is the
        # edge direction rotated -90°: n = (e_y, -e_x); halfspace n·p ≤ n·v_i.
        E = np.roll(V, -1, axis=0) - V
        A = np.stack([E[:, 1], -E[:, 0]], axis=1)
        A = A / np.linalg.norm(A, axis=1, keepdims=True)
        b = np.sum(A * V, axis=1)
        # Ensure normals point outward (centroid strictly inside).
        c = V.mean(axis=0)
        if np.any(A @ c - b > 0):
            A, b = -A, -b
        return PolygonEnvironment(vertices=V, A=A, b=b)

    @property
    def num_constraints(self) -> int:
        return self.A.shape[0]

    def position_constraints(self, p: torch.Tensor) -> torch.Tensor:
        """Residuals b - A p, one per edge (last axis), all ≥ 0 inside;
        p is (..., 2)."""
        A = const(self.A, p.dtype, p.device)
        b = const(self.b, p.dtype, p.device)
        return b - p @ A.T


def box_constraint_fn(lb, ub):
    """Finite-bound box residuals over the last axis: all finite lower-bound
    rows (y - lb) first, then all finite upper-bound rows (ub - y)."""
    lb = np.asarray(lb, dtype=np.float64)
    ub = np.asarray(ub, dtype=np.float64)
    lb_idx = np.flatnonzero(~np.isinf(lb))
    ub_idx = np.flatnonzero(~np.isinf(ub))
    lb_vals, ub_vals = lb[lb_idx], ub[ub_idx]

    def constraints(y: torch.Tensor) -> torch.Tensor:
        dev = y.device
        lo = y[..., const(lb_idx, torch.long, dev)] - const(lb_vals, y.dtype, dev)
        hi = const(ub_vals, y.dtype, dev) - y[..., const(ub_idx, torch.long, dev)]
        return torch.cat([lo, hi], dim=-1)

    constraints.num_constraints = len(lb_idx) + len(ub_idx)
    return constraints
