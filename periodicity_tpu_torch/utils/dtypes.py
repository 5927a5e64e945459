"""Working-dtype rules shared by the trig-sum pipelines, and the float32
precision pin of the matrix products and convolutions.

The counterpart of ``jnp.result_type(..., jnp.float32)`` and of the
float -> complex mapping in ``periodicity_tpu/ops/trig_sum.py``: float32
stays float32, float64 stays float64, and nothing computes below float32.
"""

from contextlib import contextmanager
from functools import reduce

import torch

__all__ = ["result_dtype", "complex_dtype", "full_float32"]


def result_dtype(*tensors):
    """Promoted floating dtype of ``tensors``, never lower than float32."""
    return reduce(torch.promote_types, (x.dtype for x in tensors), torch.float32)


def complex_dtype(dtype):
    """complex64 for float32, complex128 for float64."""
    return torch.complex64 if dtype == torch.float32 else torch.complex128


@contextmanager
def full_float32():
    """Run float32 matrix products (cuBLAS) and convolutions (cuDNN) in full
    float32, whatever the process-wide TF32 switches say, and put the
    switches back afterwards.

    The JAX package computes these products at full float32 precision, and
    TF32 keeps a 10-bit mantissa. cuDNN runs float32 convolutions in TF32
    unless told not to, and ``torch.set_float32_matmul_precision("high")``
    turns TF32 on for matrix products. Only the two legacy switches are read
    and written: reading ``torch.get_float32_matmul_precision()`` raises once
    the legacy and the newer switches have both been set.
    """
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
