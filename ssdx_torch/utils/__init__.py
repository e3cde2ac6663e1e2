"""Profiling and numerical-debugging helpers of the port."""
