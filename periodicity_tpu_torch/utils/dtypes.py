"""Working-dtype rules shared by the trig-sum pipelines.

The counterpart of ``jnp.result_type(..., jnp.float32)`` and of the
float -> complex mapping in ``periodicity_tpu/ops/trig_sum.py``: float32
stays float32, float64 stays float64, and nothing computes below float32.
"""

from functools import reduce

import torch

__all__ = ["result_dtype", "complex_dtype"]


def result_dtype(*tensors):
    """Promoted floating dtype of ``tensors``, never lower than float32."""
    return reduce(torch.promote_types, (x.dtype for x in tensors), torch.float32)


def complex_dtype(dtype):
    """complex64 for float32, complex128 for float64."""
    return torch.complex64 if dtype == torch.float32 else torch.complex128
