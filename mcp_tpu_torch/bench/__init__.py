"""Benchmark problems and the certification harness."""
