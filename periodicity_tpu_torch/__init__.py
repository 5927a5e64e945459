"""periodicity_tpu_torch: the PyTorch / CUDA port of periodicity_tpu.

The same estimator API as ``periodicity_tpu``, on torch tensors, with the
TPU package's Pallas kernels rewritten by hand for NVIDIA Hopper. Ported
so far: the GLS main path, ``GLS()(TSeries(t, y))``. Module layout mirrors
the JAX package::

    periodicity_tpu_torch.core       TSeries / FSeries, from_jax
    periodicity_tpu_torch.spectral   GLS (+ gls_power)
    periodicity_tpu_torch.ops        trig sums, spreading kernel, peaks
"""

from . import core, ops, spectral
from .core import FSeries, TSeries

__version__ = "0.1.0"
name = "periodicity_tpu_torch"

__all__ = ["TSeries", "FSeries", "core", "spectral", "ops"]
