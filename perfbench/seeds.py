"""Generators from (seed, stream, index): any whole seed, 64 bits or more,
maps through numpy's SeedSequence to one 63-bit generator seed, so the same
triple gives the same inputs on every run."""

from __future__ import annotations

import numpy as np
import torch

#: Streams: the window's calls, the warm call, and for a pooled traffic the
#: order of the pool's calls and of the lanes within each call.
CALLS, WARM, ORDER, LANES = 0, 1, 2, 3
#: The seed a pooled traffic draws its pool from, the same for every run.
POOL_SEED = 0


def derived_seed(seed: int, stream: int, index: int) -> int:
    if seed < 0:
        raise ValueError("--seed must be a whole number >= 0")
    state = np.random.SeedSequence([seed, stream, index]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def generator(device: torch.device, seed: int, stream: int, index: int) -> torch.Generator:
    return torch.Generator(device).manual_seed(derived_seed(seed, stream, index))
