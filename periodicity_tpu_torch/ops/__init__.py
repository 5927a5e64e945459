"""Numerical kernels: trig sums, the spreading, fold, recursion and sift
kernels and their loader, peaks, filters, splines, optimizers, and EMD and
LMD sifting."""
