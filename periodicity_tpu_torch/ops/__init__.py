"""Numerical kernels: trig sums, the spreading kernel and its loader, peaks."""
