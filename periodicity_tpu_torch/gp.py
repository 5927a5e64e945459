"""Alias module mirroring the reference's import path (``periodicity.gp``).

Every name of ``periodicity_tpu/gp.py``: the modelers,
``GaussianProcess``, the terms, the sequential, parallel, blocked, chunked
and sharded likelihoods, ``run_ensemble``, ``run_nuts``, the chain
diagnostics and the priors.
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
    log_likelihood_sharded,
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
    "log_likelihood_sharded",
    "run_ensemble",
    "run_nuts",
    "autocorr_time",
    "ess",
    "rhat",
    "make_gaussian_prior",
    "make_ppf",
]
