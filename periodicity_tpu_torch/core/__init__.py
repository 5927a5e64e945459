"""Core containers, and the converter from the JAX package's state."""

import numpy as np

from .containers import (
    FSeries,
    Signal,
    TFSeries,
    TSeries,
    as_tensor,
    full_like,
    implements,
    ones_like,
    wrap_reduce,
    zeros_like,
)

__all__ = [
    "TSeries",
    "FSeries",
    "TFSeries",
    "Signal",
    "full_like",
    "zeros_like",
    "ones_like",
    "implements",
    "wrap_reduce",
    "as_tensor",
    "from_jax",
]


def from_jax(obj, device=None):
    """The port's counterpart of a JAX-package object, on ``device`` (the
    card when None; pass ``device="cpu"`` for the CPU).

    A ``periodicity_tpu`` TSeries, FSeries or TFSeries becomes the port's
    container (its ``attrs`` copied as numpy arrays); an array (numpy or
    JAX) becomes a tensor; a tuple or list converts element by element.
    Dtypes are kept: float32 stays float32, float64 stays float64.
    Duck-typed on the containers' coordinates, so JAX is not imported here.
    """
    if isinstance(obj, (tuple, list)):
        return type(obj)(from_jax(x, device) for x in obj)
    if not hasattr(obj, "values"):
        return as_tensor(obj, device)
    has_f, has_t = hasattr(obj, "frequency"), hasattr(obj, "time")
    if has_f and has_t:
        new = TFSeries(as_tensor(obj.time, device), as_tensor(obj.frequency, device),
                       as_tensor(obj.values, device))
    elif has_f:
        new = FSeries(as_tensor(obj.frequency, device), as_tensor(obj.values, device),
                      assume_sorted=True)
    elif has_t:
        new = TSeries(as_tensor(obj.time, device), as_tensor(obj.values, device),
                      assume_sorted=True)
    else:
        return as_tensor(obj, device)
    new.attrs.update({k: np.asarray(v) for k, v in getattr(obj, "attrs", {}).items()})
    return new
