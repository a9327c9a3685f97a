"""Banded Newton step and the hand-written CUDA kernels of the main path."""
