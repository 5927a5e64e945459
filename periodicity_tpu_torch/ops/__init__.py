"""Numerical kernels: trig sums, the spreading, fold, recursion, sift,
AM/FM normalization, celerite and Kalman kernels and their loader, peaks,
filters, splines, optimizers, EMD and LMD sifting, wavelets and the
Hilbert-Huang functions."""
