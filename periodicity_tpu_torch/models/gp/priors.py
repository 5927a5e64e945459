"""Rotation-period priors and PPF helpers.

Port of ``periodicity_tpu/models/gp/priors.py`` (host numpy over the
container's ``acf_period_quality``, as in JAX), pinned by the reference's
SpottedStar check: argmax bin 671 and 7 peaks.
"""

import numpy as np

from ...core import TSeries

__all__ = ["make_ppf", "make_gaussian_prior"]


def make_ppf(x, pdf):
    """Empirical inverse CDF from tabulated PDF samples (reference
    ``gp.py:45-67``): the normalized running sum of ``pdf`` over ``x``,
    inverted by linear interpolation."""
    cdf = np.cumsum(pdf)
    cdf = cdf / cdf[-1]

    def ppf(q):
        return np.interp(q, cdf, x)

    return ppf


def make_gaussian_prior(
    signal,
    p_min=None,
    periods=None,
    a=1.0,
    b=2.0,
    n=8,
    fundamental_height=0.8,
    fundamental_width=0.1,
):
    """Quality-weighted gaussian-mixture prior on log-period (reference
    ``gp.py:70-153``). For each cutoff period in the ladder
    ``a * b**arange(n)`` (restricted to ``(p_min, baseline/2)``),
    ``acf_period_quality`` yields a candidate period and a quality; the
    prior is a mixture with, per candidate, a fundamental component at
    ``log(p)`` (height ``fundamental_height``) and half/double harmonics
    sharing the remainder, all of width ``fundamental_width``, weighted by
    the non-negative-clipped quality and normalized by the summed raw
    qualities. Returns a numpy function of log-period."""
    if not isinstance(signal, TSeries):
        signal = TSeries(values=signal)
    if periods is None:
        periods = a * b ** np.arange(n)
    if p_min is None:
        p_min = max(np.min(periods) / 10, 3 * float(signal.median_dt))
    cutoffs = np.asarray(
        [p for p in periods if p_min < p < float(signal.baseline) / 2]
    )
    fits = np.asarray(
        [signal.acf_period_quality(p_min, p_max) for p_max in cutoffs]
    )  # rows of (period, height, quality)
    cand_p, cand_q = fits[:, 0], fits[:, 2]

    half_height = (1.0 - fundamental_height) / 2.0
    centers = np.log(
        np.concatenate([cand_p, cand_p / 2.0, cand_p * 2.0])
    )
    weights = np.concatenate(
        [
            fundamental_height * np.maximum(cand_q, 0.0),
            half_height * np.maximum(cand_q, 0.0),
            half_height * np.maximum(cand_q, 0.0),
        ]
    )
    # the normalizer uses the raw quality sum (reference semantics: negative
    # qualities are clipped per component but still enter the total)
    scale = 1.0 / (
        np.sum(cand_q) * np.sqrt(2.0 * np.pi) * fundamental_width
    )

    def gaussian_prior(log_p):
        z = (np.asarray(log_p)[..., None] - centers) / fundamental_width
        return scale * np.sum(weights * np.exp(-0.5 * z * z), axis=-1)

    return gaussian_prior
