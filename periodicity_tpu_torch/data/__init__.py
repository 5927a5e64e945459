"""Bundled datasets and synthetic signal generators.

The port's copy of ``periodicity_tpu.data``, with its seven names and the
same numpy return values and seeds: three real light-curve/irradiance
datasets, read from the ``.npy`` files that ship in the JAX package's
``periodicity_tpu/data/`` directory (by path, read only; that package is
not imported), and closed-form synthetic generators. Generators accept an
optional seed and draw through numpy Generators.
"""

from pathlib import Path

import numpy as np

__all__ = [
    "SpottedStar",
    "SunSpots",
    "TSI",
    "BPSK",
    "SustainedPlusGappedPureTones",
    "GaussianAtomsPlusFMSinusoid",
    "DuffingWave",
]

# the JAX package's data directory, beside this package
_DATA = Path(__file__).resolve().parents[2] / "periodicity_tpu" / "data"


def _load(name):
    return np.load(_DATA / name)


def SpottedStar():
    """KIC 9655172 Kepler light curve: (t, y, dy), N=2148.

    >>> t, y, dy = SpottedStar()
    >>> y.shape == (2148,)
    True
    """
    return _load("spotted_star.npy")


def SunSpots():
    """Daily total sunspot number (WDC-SILSO), Jan 1818 - Jun 2021,
    N=74326; bad measurements are marked with -1.

    >>> t, y = SunSpots()
    >>> y.shape == (74326,)
    True
    """
    return _load("sunspots.npy")


def TSI():
    """PMOD composite Total Solar Irradiance, Nov 1978 - Mar 2012, N=12187;
    bad measurements are marked with -99.

    >>> t, y = TSI()
    >>> y.shape == (12187,)
    True
    """
    return _load("tsi.npy")


def BPSK(t_bit, n_bits, f_c, n0_db=-np.inf, seed=None):
    """Noisy BPSK signal: rectangular-pulse baseband modulated onto a complex
    carrier at f_c (normalized units), with complex AWGN at n0_db.

    >>> y = BPSK(t_bit=10, n_bits=4000, f_c=0.05)
    >>> y.shape == (40_000,)
    True
    """
    rng = np.random.default_rng(seed)
    n_total = t_bit * n_bits
    bits = rng.choice([-1.0, 1.0], n_bits)
    baseband = np.repeat(bits, t_bit)
    carrier = np.exp(2j * np.pi * f_c * np.arange(n_total))
    signal = baseband * carrier
    noise = rng.standard_normal(n_total) + 1j * rng.standard_normal(n_total)
    n0 = 10 ** (n0_db / 10)
    noise = noise * np.sqrt(n0 / np.var(noise))
    return signal + noise


def SustainedPlusGappedPureTones():
    """Pure tone at f=0.065 over N=1000 samples plus a gapped tone at
    f=0.255 over samples [500, 750).

    >>> y = SustainedPlusGappedPureTones()
    >>> y.shape == (1000,)
    True
    """
    t = np.arange(1000)
    y = np.sin(2 * np.pi * 0.065 * t)
    gap = slice(500, 750)
    y[gap] = y[gap] + np.sin(2 * np.pi * 0.255 * (t[gap] - 500))
    return y


def GaussianAtomsPlusFMSinusoid():
    """Two Gaussian atoms (different timeshifts/amplitudes/frequencies)
    plus an FM sinusoid, N=2000.

    >>> y = GaussianAtomsPlusFMSinusoid()
    >>> y.shape == (2000,)
    True
    """
    n = np.arange(1, 2001)
    fmax = 3 / 32
    fmin = 9 / 128
    phi = -np.arccos((3 * fmin - fmax) / (fmax + fmin))
    atom1 = 3 * np.exp(-(((n - 500) / 100) ** 2)) * np.cos(2 * np.pi * 5 / 16 * (n - 1000))
    fm = np.cos(
        2 * np.pi * (fmax + fmin) / 2 * (n - 1000)
        + (fmax - fmin) / 2 * 1000 * (np.sin(2 * np.pi * n / 1000) + phi - np.sin(phi))
    )
    atom2 = np.exp(-(((n - 1000) / 200) ** 2)) * np.cos(2 * np.pi * 7 / 256 * (n - 1000))
    return atom1 + fm + atom2


def DuffingWave():
    """Damped Duffing wave with chirp frequency, N=1024.

    >>> y = DuffingWave()
    >>> y.shape == (1024,)
    True
    """
    t = np.arange(1024)
    chirp = t**2 / 512 + 32
    return np.exp(-t / 256) * np.cos(
        (np.pi / 64) * chirp + 0.3 * np.sin((np.pi / 32) * chirp)
    )
