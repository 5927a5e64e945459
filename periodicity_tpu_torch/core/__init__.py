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
    container (its ``attrs`` copied as numpy arrays); a GP term (SHOTerm,
    RotationTerm, BrownianTerm, TermSum) becomes the port's term with the
    same hyperparameters, as 0-d tensors, so an SHO emits its live slots
    in both packages; an array (numpy or JAX) becomes a tensor; a tuple or
    list converts element by element. Dtypes are kept: float32 stays
    float32, float64 stays float64. Duck-typed on the containers'
    coordinates and the terms' class names, so JAX is not imported here.
    """
    if isinstance(obj, (tuple, list)):
        return type(obj)(from_jax(x, device) for x in obj)
    term = _term_from_jax(obj, device)
    if term is not None:
        return term
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


def _term_from_jax(obj, device):
    """The port's GP term for a JAX-package term, or None for anything
    else. A BrownianTerm keeps no hyperparameters of its own, so it is
    rebuilt from its two SHOs."""
    from ..models.gp import terms

    name = type(obj).__name__
    if not type(obj).__module__.startswith("periodicity_tpu.") or not hasattr(
            terms, name) or not hasattr(obj, "coefficients"):
        return None

    def t(x):
        return as_tensor(np.asarray(x), device)

    if name == "SHOTerm":
        return terms.SHOTerm(S0=t(obj.S0), w0=t(obj.w0), Q=t(obj.Q))
    if name == "RotationTerm":
        return terms.RotationTerm(sigma=t(obj.sigma), period=t(obj.period), Q0=t(obj.Q0),
                                  dQ=t(obj.dQ), f=t(obj.f))
    parts = [from_jax(part, device) for part in obj.terms]
    new = getattr(terms, name).__new__(getattr(terms, name))
    terms.TermSum.__init__(new, *parts)
    return new
