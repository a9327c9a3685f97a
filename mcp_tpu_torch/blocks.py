"""Per-player block-vector bookkeeping: static (offset, size) metadata over
flat vectors, with split/concat helpers that lower to slices."""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch


@dataclasses.dataclass(frozen=True)
class Blocking:
    """Static block sizes for a flat vector; split/concat helpers."""

    sizes: tuple[int, ...]

    def __post_init__(self):
        object.__setattr__(self, "sizes", tuple(int(s) for s in self.sizes))

    @property
    def total(self) -> int:
        return sum(self.sizes)

    @property
    def offsets(self) -> tuple[int, ...]:
        out, acc = [], 0
        for s in self.sizes:
            out.append(acc)
            acc += s
        return tuple(out)

    def split(self, v: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """Split along the last axis (leading axes, if any, are kept)."""
        return tuple(
            v[..., off : off + size] for off, size in zip(self.offsets, self.sizes)
        )

    def block(self, v: torch.Tensor, i: int) -> torch.Tensor:
        off = self.offsets[i]
        return v[..., off : off + self.sizes[i]]

    def __len__(self) -> int:
        return len(self.sizes)


def concat_blocks(blocks: Sequence[torch.Tensor], dtype=None) -> torch.Tensor:
    """Concatenate per-player blocks into one flat vector (zero-size blocks
    allowed)."""
    blocks = [torch.as_tensor(b) for b in blocks]
    if not blocks:
        return torch.zeros((0,), dtype=dtype or torch.get_default_dtype())
    if dtype is None:
        dtype = blocks[0].dtype
        for b in blocks[1:]:
            dtype = torch.promote_types(dtype, b.dtype)
    return torch.cat([b.to(dtype).reshape(-1) for b in blocks])
