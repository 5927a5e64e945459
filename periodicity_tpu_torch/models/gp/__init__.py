"""Gaussian-process period inference (the celerite solver and its kernels,
the dense QP GP, the ensemble sampler, period priors).

Port of ``periodicity_tpu/models/gp``. Not ported yet, and not exported:
``run_nuts`` and the modelers' ``nuts`` methods, ``log_likelihood_pscan``,
``log_likelihood_blocked``, ``log_likelihood_chunked`` and
``ssm_matrices`` (slice A7b); ``log_likelihood_sharded`` and
``run_ensemble_sharded`` (slice A8). The modelers raise
``NotImplementedError`` naming the slice for those solvers and samplers.
"""

from .mcmc import autocorr_time, ess, rhat, run_ensemble, run_ensemble_checkpointed
from .modelers import (
    BrownianGP,
    CeleriteModeler,
    GeorgeModeler,
    HarmonicGP,
    QuasiPeriodicGP,
)
from .priors import make_gaussian_prior, make_ppf
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
    "SHOTerm",
    "RotationTerm",
    "BrownianTerm",
    "Term",
    "TermSum",
    "run_ensemble",
    "run_ensemble_checkpointed",
    "autocorr_time",
    "ess",
    "rhat",
]
