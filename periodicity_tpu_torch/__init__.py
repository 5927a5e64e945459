"""periodicity_tpu_torch: the PyTorch / CUDA port of periodicity_tpu.

The same estimator API as ``periodicity_tpu``, on torch tensors, with the
TPU package's Pallas kernels rewritten by hand for NVIDIA Hopper. Ported
so far: the containers (TSeries, FSeries, TFSeries) with the peak, filter,
spline and optimizer ops under them and the bundled data; the spectral
estimators (GLS with its bootstrap, FAP/FAL, refinement, window, model
and harmonic terms; batched GLS; MultibandGLS; BGLST) and the
phase-folding estimators (BLS, AoV, ConditionalEntropy, GregoryLoredo,
PDM, StringLength); the decompositions (EMD, LMD, CEEMDAN, VMD); the
time-frequency estimators (WPS, HHT, CompositeSpectrum, denoising and
their batches); GP period inference (celerite terms and solver, the
dense quasi-periodic GP, the parallel, blocked and chunked Kalman
likelihoods, the ensemble and NUTS samplers, L-BFGS, period priors); and
the parallel package (device meshes, sharded scans, the distributed FFT
and ACF, multi-process start-up) with the sharded GP likelihood and
sampler; profiling.
Non-tensor inputs land on the card unless ``device="cpu"`` is asked for. Module layout mirrors the JAX package::

    periodicity_tpu_torch.core       TSeries / FSeries / TFSeries, from_jax
    periodicity_tpu_torch.spectral   GLS, MultibandGLS, BGLST (+ their scans)
    periodicity_tpu_torch.phase      BLS, AoV, PDM, ... (+ their scans)
    periodicity_tpu_torch.decomposition  EMD, LMD, CEEMDAN, VMD
    periodicity_tpu_torch.timefrequency  WPS, HHT, CompositeSpectrum, denoise
    periodicity_tpu_torch.gp         BrownianGP, HarmonicGP, QuasiPeriodicGP,
                                     celerite terms, run_ensemble,
                                     run_nuts, priors
    periodicity_tpu_torch.ops        trig sums, spreading, fold, recursion,
                                     sift, AM/FM normalization, celerite
                                     and Kalman kernels, peaks, filters, splines, optimizers,
                                     EMD and LMD sifting, wavelets, HHT
    periodicity_tpu_torch.data       bundled datasets and signal generators
    periodicity_tpu_torch.parallel   meshes, sharded scans, distributed FFT/ACF
"""

from . import core, data, decomposition, gp, ops, parallel, phase, spectral
from . import timefrequency
from .core import FSeries, TFSeries, TSeries

__version__ = "0.1.0"
name = "periodicity_tpu_torch"

__all__ = ["TSeries", "FSeries", "TFSeries", "core", "spectral", "phase", "decomposition",
           "timefrequency", "gp", "ops", "data", "parallel"]
