"""Measurement helpers of the port (bench/profiling.py)."""
