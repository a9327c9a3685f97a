"""Benchmark problems and the certification harness."""

from . import qp

__all__ = ["qp"]
