"""Minimal dynamics types: time-invariant linear per-player dynamics
x⁺ = Ax + Bu with box bounds, and their product (block-diagonal) joint
system. Dynamics act on the last axis, so a (T, state_dim) trajectory maps
in one call."""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from .._device import const
from ..blocks import Blocking


class Bounds(NamedTuple):
    lb: np.ndarray
    ub: np.ndarray


def _bounds(lb, ub) -> Bounds:
    return Bounds(np.asarray(lb, dtype=np.float64), np.asarray(ub, dtype=np.float64))


@dataclasses.dataclass(frozen=True, eq=False)
class LinearDynamics:
    """x⁺ = A x + B u with state/control box bounds."""

    A: np.ndarray
    B: np.ndarray
    state_bounds: Bounds
    control_bounds: Bounds

    @property
    def state_dim(self) -> int:
        return self.A.shape[0]

    @property
    def control_dim(self) -> int:
        return self.B.shape[1]

    def __call__(self, x: torch.Tensor, u: torch.Tensor, t=None) -> torch.Tensor:
        A = const(self.A, x.dtype, x.device)
        B = const(self.B, x.dtype, x.device)
        return x @ A.T + u @ B.T


def planar_double_integrator(
    *,
    dt: float = 0.1,
    m: float = 1.0,
    state_bounds=None,
    control_bounds=None,
) -> LinearDynamics:
    """Planar double integrator, state (px, py, vx, vy), control (ax, ay):
    Euler with a half-step position term, dt = 0.1, unit mass."""
    dt2 = 0.5 * dt * dt
    A = np.array(
        [
            [1.0, 0.0, dt, 0.0],
            [0.0, 1.0, 0.0, dt],
            [0.0, 0.0, 1.0, 0.0],
            [0.0, 0.0, 0.0, 1.0],
        ]
    )
    B = np.array([[dt2, 0.0], [0.0, dt2], [dt, 0.0], [0.0, dt]]) / m
    if state_bounds is None:
        state_bounds = {"lb": [-np.inf] * 4, "ub": [np.inf] * 4}
    if control_bounds is None:
        control_bounds = {"lb": [-np.inf] * 2, "ub": [np.inf] * 2}
    return LinearDynamics(
        A=A,
        B=B,
        state_bounds=_bounds(state_bounds["lb"], state_bounds["ub"]),
        control_bounds=_bounds(control_bounds["lb"], control_bounds["ub"]),
    )


@dataclasses.dataclass(frozen=True, eq=False)
class ProductDynamics:
    """Joint dynamics of N independent per-player subsystems."""

    subsystems: tuple[LinearDynamics, ...]

    def __post_init__(self):
        object.__setattr__(self, "subsystems", tuple(self.subsystems))

    @property
    def num_players(self) -> int:
        return len(self.subsystems)

    def state_dim(self, i: Optional[int] = None) -> int:
        if i is None:
            return sum(s.state_dim for s in self.subsystems)
        return self.subsystems[i].state_dim

    def control_dim(self, i: Optional[int] = None) -> int:
        if i is None:
            return sum(s.control_dim for s in self.subsystems)
        return self.subsystems[i].control_dim

    @property
    def state_blocking(self) -> Blocking:
        return Blocking(tuple(s.state_dim for s in self.subsystems))

    @property
    def control_blocking(self) -> Blocking:
        return Blocking(tuple(s.control_dim for s in self.subsystems))

    @property
    def state_bounds(self) -> Bounds:
        return Bounds(
            np.concatenate([s.state_bounds.lb for s in self.subsystems]),
            np.concatenate([s.state_bounds.ub for s in self.subsystems]),
        )

    @property
    def control_bounds(self) -> Bounds:
        return Bounds(
            np.concatenate([s.control_bounds.lb for s in self.subsystems]),
            np.concatenate([s.control_bounds.ub for s in self.subsystems]),
        )

    def __call__(self, x: torch.Tensor, u: torch.Tensor, t=None) -> torch.Tensor:
        xs = self.state_blocking.split(x)
        us = self.control_blocking.split(u)
        return torch.cat(
            [sub(xi, ui, t) for sub, xi, ui in zip(self.subsystems, xs, us)], dim=-1
        )
