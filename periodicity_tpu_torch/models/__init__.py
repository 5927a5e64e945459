"""Estimator method families: spectral, phase folding, decomposition,
time-frequency and GP period inference."""
