"""Numerical kernels: trig sums, the spreading, fold and recursion kernels and
their loader, peaks, filters, splines and optimizers."""
