"""Estimator method families: spectral (GLS)."""
