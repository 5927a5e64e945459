"""Alias module mirroring the reference's import path."""

from .models.timefrequency import (
    HHT,
    WPS,
    CompositeSpectrum,
    denoise,
    denoise_batch,
    hht_batch,
    reconstruct,
    wps_batch,
)

__all__ = [
    "WPS",
    "HHT",
    "CompositeSpectrum",
    "denoise",
    "denoise_batch",
    "reconstruct",
    "wps_batch",
    "hht_batch",
]
