"""Masked-game solving drivers: batched open-loop solves, closed-loop
stepping and ground-truth generation for the masked N-player games (the
JAX package's ``selection/runner.py``). Whole scenario batches solve in one
batched call. ``solve`` is differentiable in the masks (and every other θ
entry) through ``solve_batch``'s implicit-function-theorem rule.
"""

from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch.func import vmap

from ..games import ParametricGame
from ..parallel.batch import solve_batch
from ..solver import SolverOptions
from ..trajectories import TrajectoryGame
from ..trajectories.strategies import cold_start_primal
from .._device import resolve_device
from ..types import SOLVED, SolveResult
from .data import Example, Scenario, save_example
from .games import build_masked_parametric_game


class BatchSolution(NamedTuple):
    result: SolveResult
    trajectories: torch.Tensor  # (B, N, T, 4) solved state plans
    controls: torch.Tensor  # (B, N, T, 2) solved control plans


@dataclasses.dataclass(frozen=True, eq=False)
class MaskedGameRunner:
    """A masked TrajectoryGame with its compiled MCP at fixed (N, horizon);
    every solve is batched."""

    game: TrajectoryGame
    parametric_game: ParametricGame
    N: int
    horizon: int
    # Game MCPs have Hy ≡ 0, so the n×n "schur" Newton tier is exact.
    options: SolverOptions = SolverOptions(linear_solver="schur")
    device: torch.device = torch.device("cuda")  # where the game's constants live

    @staticmethod
    def create(
        game: TrajectoryGame, *, N: int, horizon: int,
        options: Optional[SolverOptions] = None, probes=None, device="cuda",
    ) -> "MaskedGameRunner":
        """Build the game's MCP on ``device`` (default ``"cuda"``, which
        raises without a GPU); ``probes`` (``trajectories.GameProbes`` of an
        earlier build) skips the build's probes. Default options: the banded
        tier "tridiag" when the builder validated the time structure, else
        "schur"."""
        device = resolve_device(device)
        pg = build_masked_parametric_game(game, N=N, horizon=horizon, probes=probes,
                                          device=device)
        if options is None:
            if pg.mcp.time_structure is not None:
                options = SolverOptions(linear_solver="tridiag", sensitivity_solver="tridiag")
            else:
                options = SolverOptions(linear_solver="schur", sensitivity_solver="condensed")
        return MaskedGameRunner(
            game=game, parametric_game=pg, N=N, horizon=horizon, options=options,
            device=device,
        )

    def pack_thetas(
        self, initial_states: torch.Tensor, goals: torch.Tensor, masks: torch.Tensor
    ) -> torch.Tensor:
        """(B,N,4), (B,N,2), (B,N,N) per-player mask rows → (B, N·(N+6)),
        each player's block [x0ᵢ; goalᵢ; mask rowᵢ]."""
        B = initial_states.shape[0]
        return torch.cat([initial_states, goals, masks], dim=2).reshape(B, -1)

    def ego_masked_mask_rows(self, masks: torch.Tensor, *, ego_index: int = 0) -> torch.Tensor:
        """(B, N) learned masks → (B, N, N) per-player mask rows: the ego
        row is the learned mask, the others all-ones (gradients flow to the
        ego row)."""
        ones = torch.ones_like(masks)
        return torch.stack([masks if i == ego_index else ones for i in range(self.N)], dim=1)

    def cold_starts(self, initial_states: torch.Tensor) -> torch.Tensor:
        """(B, N, 4) → (B, n) zero-input-rollout primal seeds."""
        return vmap(
            lambda x0s: cold_start_primal(
                self.game, self.parametric_game, self.horizon, x0s.reshape(-1)
            )
        )(initial_states)

    def solve(
        self,
        initial_states: torch.Tensor,
        goals: torch.Tensor,
        masks: torch.Tensor,
        *,
        mask_rows: Optional[torch.Tensor] = None,
        x0: Optional[torch.Tensor] = None,
        y0: Optional[torch.Tensor] = None,
    ) -> BatchSolution:
        """Solve a batch of masked games open-loop. masks (B, N) serve every
        player unless explicit (B, N, N) ``mask_rows`` are given; the cold
        start is the zero-input rollout unless ``x0`` is given."""
        if mask_rows is None:
            mask_rows = masks[:, None, :].expand(masks.shape[0], self.N, self.N)
        thetas = self.pack_thetas(initial_states, goals, mask_rows)
        if x0 is None:
            x0 = self.cold_starts(initial_states)
        sol = solve_batch(self.parametric_game.mcp, thetas, x0=x0, y0=y0, options=self.options)
        trajs, ctrls = self.unpack_plans(sol.x)
        return BatchSolution(result=sol, trajectories=trajs, controls=ctrls)

    def unpack_plans(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Batched primal (B, n) → ((B,N,T,4) states, (B,N,T,2) controls)."""
        T, B = self.horizon, x.shape[0]
        taus = x[:, : self.N * T * 6].reshape(B, self.N, T * 6)
        return taus[..., : T * 4].reshape(B, self.N, T, 4), taus[..., T * 4 :].reshape(
            B, self.N, T, 2
        )

    def step_closed_loop(
        self,
        initial_states: torch.Tensor,
        goals: torch.Tensor,
        masks: torch.Tensor,
        *,
        mask_rows: Optional[torch.Tensor] = None,
        x0: Optional[torch.Tensor] = None,
        y0: Optional[torch.Tensor] = None,
    ) -> tuple[torch.Tensor, torch.Tensor, BatchSolution]:
        """One MPC step for a batch: solve, take each plan's state at t=1 as
        the next joint state and its control at t=0 as the applied control."""
        bs = self.solve(initial_states, goals, masks, mask_rows=mask_rows, x0=x0, y0=y0)
        return bs.trajectories[:, :, 1, :], bs.controls[:, :, 0, :], bs


def generate_ground_truth(
    runner: MaskedGameRunner,
    scenarios: Sequence[Scenario],
    out_dir: str,
    *,
    ego_index: int = 0,
    batch_size: int = 64,
) -> list[Example]:
    """Replay scenarios through the all-ones-mask game in float32, in chunks
    of ``batch_size`` (one batched solve each, on the runner's device), and
    write each SOLVED scenario's open-loop plan as
    ``simulation_results_{k}.json`` (k its index in ``scenarios``);
    unconverged scenarios are skipped. Returns the examples written."""
    os.makedirs(out_dir, exist_ok=True)
    examples = []
    for start in range(0, len(scenarios), batch_size):
        chunk = scenarios[start : start + batch_size]
        init, goals = (
            torch.as_tensor(np.stack([getattr(s, k) for s in chunk])).to(
                device=runner.device, dtype=torch.float32)
            for k in ("initial_states", "goals")
        )
        masks = torch.ones((len(chunk), runner.N), dtype=torch.float32, device=runner.device)
        bs = runner.solve(init, goals, masks)
        trajs = bs.trajectories.cpu().numpy()
        statuses = bs.result.status.cpu().numpy()
        for i, scen in enumerate(chunk):
            if statuses[i] != SOLVED:
                continue
            ex = Example(
                trajectories=trajs[i],
                ego_index=ego_index,
                initial_states=np.asarray(scen.initial_states),
                goals=np.asarray(scen.goals),
                mask=np.ones(runner.N),
            )
            save_example(os.path.join(out_dir, f"simulation_results_{start + i}.json"), ex)
            examples.append(ex)
    return examples
