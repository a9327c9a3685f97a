"""Scenario generation and dataset loading for player-selection training
(the JAX package's ``selection/data.py``).

* ``generate_scenarios``: random initial states and goals with a pairwise
  minimum separation, by rejection sampling, drawn with numpy (backend
  "python") or by the C++ sampler (``native/``); either backend's scenarios
  equal the JAX package's bit for bit.
* ``save_example``/``load_example``: one training example per JSON file, in
  the JAX package's keys, so files written by either package load in the
  other.
* ``DataLoader``: shuffled mini-batches, a numpy ``default_rng`` permutation
  with the seed bumped every epoch (the JAX package's batches, index for
  index).
* ``batch_arrays``: a list of examples as float32 tensors on a device.

Ground truth (``runner.generate_ground_truth``) replays scenarios through the
all-ones-mask game.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Iterator, NamedTuple, Sequence

import numpy as np
import torch

from .._device import resolve_device


class Scenario(NamedTuple):
    initial_states: np.ndarray  # (N, 4)
    goals: np.ndarray  # (N, 2)
    # Closed-loop length of a recorded scenario (real recordings differ in
    # duration); None uses the evaluation sweep's num_sim_steps.
    sim_steps: int | None = None


class Example(NamedTuple):
    """One training example."""

    trajectories: np.ndarray  # (N, T, 4) ground-truth states
    ego_index: int
    initial_states: np.ndarray  # (N, 4)
    goals: np.ndarray  # (N, 2)
    mask: np.ndarray  # (N,) mask used to generate the ground truth


def generate_scenarios(
    *,
    num_scenarios: int,
    num_players: int,
    arena_half_width: float = 4.0,
    min_separation: float = 1.0,
    max_speed: float = 0.0,
    seed: int = 0,
    backend: str = "auto",
) -> list[Scenario]:
    """Random initial states (positions in [−w, w]², velocities in
    [−max_speed, max_speed]²) and goals, positions and goals each pairwise
    at least ``min_separation`` apart.

    backend: "native" (the C++ sampler; raises when it cannot be built or
    loaded), "python" (numpy ``default_rng(seed)``), or "auto" (native,
    else python)."""
    if backend not in ("auto", "native", "python"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend != "python":
        from ..native import MAX_PLAYERS, generate_scenarios_native, native_available

        if backend == "native" or (num_players <= MAX_PLAYERS and native_available()):
            states, goals = generate_scenarios_native(
                num_scenarios=num_scenarios, num_players=num_players,
                arena_half_width=arena_half_width, min_separation=min_separation,
                max_speed=max_speed, seed=seed,
            )
            return [Scenario(initial_states=states[i], goals=goals[i])
                    for i in range(states.shape[0])]

    rng = np.random.default_rng(seed)

    def sample_separated():
        while True:
            pts = rng.uniform(-arena_half_width, arena_half_width, (num_players, 2))
            d = np.linalg.norm(pts[:, None] - pts[None, :], axis=-1)
            d[np.arange(num_players), np.arange(num_players)] = np.inf
            if d.min() >= min_separation:
                return pts

    scenarios = []
    for _ in range(num_scenarios):
        starts = sample_separated()
        goals = sample_separated()
        vels = rng.uniform(-max_speed, max_speed, (num_players, 2))
        scenarios.append(Scenario(initial_states=np.concatenate([starts, vels], axis=1),
                                  goals=goals))
    return scenarios


def save_example(path: str, example: Example) -> None:
    payload = {
        "trajectories": np.asarray(example.trajectories).tolist(),
        "ego_index": int(example.ego_index),
        "initial_states": np.asarray(example.initial_states).tolist(),
        "goals": np.asarray(example.goals).tolist(),
        "mask": np.asarray(example.mask).tolist(),
    }
    with open(path, "w") as f:
        json.dump(payload, f)


def load_example(path: str) -> Example:
    with open(path) as f:
        payload = json.load(f)
    return Example(
        trajectories=np.asarray(payload["trajectories"], dtype=np.float64),
        ego_index=int(payload.get("ego_index", 0)),
        initial_states=np.asarray(payload["initial_states"], dtype=np.float64),
        goals=np.asarray(payload["goals"], dtype=np.float64),
        mask=np.asarray(payload["mask"], dtype=np.float64),
    )


def load_all_json_data(directory: str) -> list[Example]:
    """Every ``*.json`` example of a directory, in sorted file-name order."""
    return [load_example(os.path.join(directory, name))
            for name in sorted(os.listdir(directory)) if name.endswith(".json")]


@dataclasses.dataclass
class DataLoader:
    """Shuffled mini-batches over examples; every pass over the loader is a
    fresh shuffle (the seed goes up by one)."""

    dataset: Sequence[Example]
    batch_size: int
    seed: int = 0
    drop_last: bool = False

    def __iter__(self) -> Iterator[list[Example]]:
        order = np.random.default_rng(self.seed).permutation(len(self.dataset))
        self.seed += 1
        for start in range(0, len(order), self.batch_size):
            idx = order[start : start + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                return
            yield [self.dataset[i] for i in idx]

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)


def batch_arrays(examples: Sequence[Example], device="cuda"):
    """(trajectories (B, N, T, 4), initial_states (B, N, 4), goals (B, N, 2)),
    float32 tensors on ``device`` (default ``"cuda"``, which raises without a
    GPU)."""
    device = resolve_device(device)
    return tuple(
        torch.as_tensor(np.stack([getattr(e, k) for e in examples])).to(
            device=device, dtype=torch.float32)
        for k in ("trajectories", "initial_states", "goals")
    )
