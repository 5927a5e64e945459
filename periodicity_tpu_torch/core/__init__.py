"""Core containers, and the converter from the JAX package's state."""

import numpy as np

from .containers import FSeries, Signal, TSeries, as_tensor

__all__ = ["TSeries", "FSeries", "Signal", "as_tensor", "from_jax"]


def from_jax(obj, device=None):
    """The port's counterpart of a JAX-package object, on ``device``.

    A ``periodicity_tpu`` TSeries or FSeries becomes the port's container
    (its ``attrs`` copied as numpy arrays); an array (numpy or JAX) becomes
    a tensor; a tuple or list converts element by element. Dtypes are
    kept: float32 stays float32, float64 stays float64. Duck-typed on the
    containers' coordinates, so JAX is not imported here.
    """
    if isinstance(obj, (tuple, list)):
        return type(obj)(from_jax(x, device) for x in obj)
    if hasattr(obj, "frequency") and hasattr(obj, "values"):
        new = FSeries(as_tensor(obj.frequency, device), as_tensor(obj.values, device),
                      assume_sorted=True)
    elif hasattr(obj, "time") and hasattr(obj, "values"):
        new = TSeries(as_tensor(obj.time, device), as_tensor(obj.values, device),
                      assume_sorted=True)
    else:
        return as_tensor(obj, device)
    new.attrs.update({k: np.asarray(v) for k, v in getattr(obj, "attrs", {}).items()})
    return new
