"""Batched and streamed solving."""

from .batch import batch_statistics, solve_batch, solve_batches_streamed

__all__ = ["solve_batch", "solve_batches_streamed", "batch_statistics"]
