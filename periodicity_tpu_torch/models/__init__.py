"""Estimator method families: spectral, phase folding and decomposition."""
