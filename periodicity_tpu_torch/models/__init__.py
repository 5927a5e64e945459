"""Estimator method families: spectral, phase folding, decomposition and
time-frequency."""
