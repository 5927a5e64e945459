"""Gaussian-process period inference (the celerite solver and its kernels,
the parallel, blocked and chunked Kalman solvers, the dense QP GP, the
ensemble and NUTS samplers, their sharded forms over a device mesh,
period priors).

Port of ``periodicity_tpu/models/gp``.
"""

from .mcmc import (
    autocorr_time,
    ess,
    rhat,
    run_ensemble,
    run_ensemble_checkpointed,
    run_ensemble_sharded,
)
from .modelers import (
    BrownianGP,
    CeleriteModeler,
    GeorgeModeler,
    HarmonicGP,
    QuasiPeriodicGP,
)
from .nuts import run_nuts
from .priors import make_gaussian_prior, make_ppf
from .pscan import (
    log_likelihood_blocked,
    log_likelihood_chunked,
    log_likelihood_pscan,
    log_likelihood_sharded,
    ssm_matrices,
)
from .solver import GaussianProcess, log_likelihood
from .terms import BrownianTerm, RotationTerm, SHOTerm, Term, TermSum

__all__ = [
    "GeorgeModeler",
    "CeleriteModeler",
    "QuasiPeriodicGP",
    "BrownianGP",
    "HarmonicGP",
    "make_gaussian_prior",
    "make_ppf",
    "GaussianProcess",
    "log_likelihood",
    "log_likelihood_pscan",
    "log_likelihood_blocked",
    "log_likelihood_chunked",
    "log_likelihood_sharded",
    "ssm_matrices",
    "SHOTerm",
    "RotationTerm",
    "BrownianTerm",
    "Term",
    "TermSum",
    "run_ensemble",
    "run_ensemble_checkpointed",
    "run_ensemble_sharded",
    "run_nuts",
    "autocorr_time",
    "ess",
    "rhat",
]
