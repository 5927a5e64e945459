"""Alias module mirroring the reference's import path
(``periodicity.spectral`` -> ``periodicity_tpu_torch.spectral``)."""

from .models.spectral import (
    BGLST,
    GLS,
    MultibandGLS,
    bglst_log_ml,
    bglst_log_ml_fast,
    default_frequency_grid,
    fal_baluev,
    fap_baluev,
    gls_power,
    gls_power_batch,
    gls_power_multiband,
    gls_power_multiterm,
)

__all__ = [
    "GLS",
    "BGLST",
    "MultibandGLS",
    "gls_power",
    "gls_power_batch",
    "gls_power_multiterm",
    "gls_power_multiband",
    "bglst_log_ml",
    "bglst_log_ml_fast",
    "default_frequency_grid",
    "fap_baluev",
    "fal_baluev",
]
