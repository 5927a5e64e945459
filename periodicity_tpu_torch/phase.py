"""Alias module mirroring the reference's import path
(``periodicity.phase`` -> ``periodicity_tpu_torch.phase``)."""

from .models.phase import (
    BLS,
    PDM,
    AoV,
    ConditionalEntropy,
    GregoryLoredo,
    StringLength,
    aov_scan,
    bls_batch,
    bls_scan,
    conditional_entropy_scan,
    gregory_loredo_scan,
    pdm_batch,
    pdm_scan,
    string_length_approx_scan,
    string_length_batch,
    string_length_scan,
    string_length_scan_fast,
)

__all__ = [
    "StringLength",
    "BLS",
    "bls_scan",
    "bls_batch",
    "PDM",
    "AoV",
    "ConditionalEntropy",
    "GregoryLoredo",
    "gregory_loredo_scan",
    "string_length_scan",
    "string_length_scan_fast",
    "string_length_approx_scan",
    "pdm_scan",
    "pdm_batch",
    "string_length_batch",
    "aov_scan",
    "conditional_entropy_scan",
]
