"""Alias module mirroring the reference's import path
(``periodicity.spectral`` -> ``periodicity_tpu_torch.spectral``)."""

from .models.spectral import GLS, default_frequency_grid, gls_power

__all__ = ["GLS", "gls_power", "default_frequency_grid"]
