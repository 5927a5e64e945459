"""Alias module mirroring the reference's import path (``periodicity.gp``).

Every name of ``periodicity_tpu/gp.py`` that the port has: the modelers,
``GaussianProcess``, the terms, the sequential, parallel, blocked and
chunked likelihoods, ``run_ensemble``, ``run_nuts``, the chain diagnostics
and the priors. Left for a later slice of the port, and not exported here:
``log_likelihood_sharded`` (slice A8).
"""

from .models.gp import (
    BrownianGP,
    BrownianTerm,
    CeleriteModeler,
    GaussianProcess,
    GeorgeModeler,
    HarmonicGP,
    QuasiPeriodicGP,
    RotationTerm,
    SHOTerm,
    Term,
    TermSum,
    autocorr_time,
    ess,
    log_likelihood,
    log_likelihood_blocked,
    log_likelihood_chunked,
    log_likelihood_pscan,
    make_gaussian_prior,
    make_ppf,
    rhat,
    run_ensemble,
    run_nuts,
)

__all__ = [
    "GeorgeModeler",
    "CeleriteModeler",
    "QuasiPeriodicGP",
    "BrownianGP",
    "HarmonicGP",
    "GaussianProcess",
    "Term",
    "TermSum",
    "SHOTerm",
    "RotationTerm",
    "BrownianTerm",
    "log_likelihood",
    "log_likelihood_pscan",
    "log_likelihood_blocked",
    "log_likelihood_chunked",
    "run_ensemble",
    "run_nuts",
    "autocorr_time",
    "ess",
    "rhat",
    "make_gaussian_prior",
    "make_ppf",
]
