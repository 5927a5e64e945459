"""Alias module mirroring the reference's import path."""

from .models.decomposition import CEEMDAN, EMD, LMD, VMD

__all__ = ["EMD", "CEEMDAN", "LMD", "VMD"]
