"""Utility modules: profiling and timing helpers, double-word arithmetic."""

from .profiling import PhaseTimer, time_compiled, trace

__all__ = ["PhaseTimer", "time_compiled", "trace"]
