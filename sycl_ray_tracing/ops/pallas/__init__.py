"""Pallas kernels for the GPU (list tracer round loops, Triton route)."""
