"""Carry a game's build-time state across from plain host data.

The system has no weights: its "parameters" are the constants the game
builder attaches to the MCP, the ``TimeStructure`` and the ``AffineBands``.
These functions take a dict of plain ints, tuples or numpy arrays (``None``
stays ``None``), e.g. produced from the JAX package's MCP, and return the
port's objects, so both packages can run on the same bands.
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .kernels.block_tridiag import AffineBands, TimeStructure


def time_structure_from_numpy(d: dict) -> TimeStructure:
    """``TimeStructure`` from keys permutation, num_blocks, block_size,
    row_permutation (or None) and rows_per_block."""
    rperm = d.get("row_permutation")
    return TimeStructure(
        permutation=tuple(int(i) for i in np.asarray(d["permutation"]).reshape(-1)),
        num_blocks=int(d["num_blocks"]),
        block_size=int(d["block_size"]),
        row_permutation=(
            None if rperm is None
            else tuple(int(i) for i in np.asarray(rperm).reshape(-1))
        ),
        rows_per_block=int(d.get("rows_per_block", 0)),
    )


def affine_bands_from_numpy(d: dict, device="cuda", dtype=torch.float64) -> AffineBands:
    """``AffineBands`` from its 11 leaves (``AffineBands._fields``) as host
    arrays or None, placed on ``device`` in ``dtype``."""
    device = resolve_device(device)
    return AffineBands(
        *(
            None if d[k] is None
            else torch.tensor(np.array(d[k]), dtype=dtype, device=device)
            for k in AffineBands._fields
        )
    )
