"""Labeled series containers over torch tensors (TSeries / FSeries).

Port of the slice of ``periodicity_tpu/core/containers.py`` that the
spectral estimators use: the constructors (sorting by coordinate), the
shape surface, ``argmax``/``max``/``amax``, the arithmetic operators on
tensors, numbers and other series, the time-grid properties of
``TSeries`` and the peak readout of ``FSeries``. Tensors keep their
device and dtype. Array-likes that are not tensors go through numpy first, so Python floats
become float64 as under JAX's x64 mode, and land on the card
(``torch.device("cuda")``) unless ``device`` says otherwise; a coordinate
given as an array-like follows its values' device. Without a CUDA device
and without ``device="cpu"`` (or CPU tensors) construction raises: it
never falls back to the CPU quietly. The peak kernels are imported when
first used.
"""

import operator
from numbers import Number

import numpy as np
import torch

__all__ = ["Signal", "TSeries", "FSeries", "as_tensor", "nanmax"]


def _default_device(device=None):
    """``device`` as a ``torch.device``; None means the card, and raises
    where there is none."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' or CPU tensors to run on the CPU"
        )
    return torch.device("cuda")


def as_tensor(x, device=None):
    """``x`` as a tensor, keeping its dtype (non-tensors go through numpy).
    A tensor stays on its device unless ``device`` is given; anything else
    goes to ``device``, or to the card when that is None."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    return torch.from_numpy(np.array(x)).to(_default_device(device))


def _place(x, device, follow):
    """A tensor ``x`` keeps its device unless ``device`` is given; an
    array-like goes to ``device``, else to the device of ``follow`` when
    that is a tensor, else to the card."""
    if device is None and not isinstance(x, torch.Tensor) and isinstance(follow, torch.Tensor):
        device = follow.device
    return as_tensor(x, device)


def nanmax(x, dim=None):
    """Largest value of ``x`` (along ``dim``) ignoring NaNs, NaN where all
    are, as ``jnp.nanmax``."""
    nan = torch.isnan(x)
    m = torch.where(nan, float("-inf"), x)
    if dim is None:
        return torch.where(nan.all(), float("nan"), m.max())
    return torch.where(nan.all(dim), float("nan"), m.amax(dim))


def _median(x):
    """Median that averages the two middle values of an even count, as
    ``jnp.median`` does (``torch.median`` returns the lower one)."""
    s = torch.sort(x).values
    n = s.shape[0]
    if n % 2:
        return s[n // 2]
    return (s[n // 2 - 1] + s[n // 2]) * 0.5


class Signal:
    """Base container: a named-coordinate tensor."""

    _HANDLED_TYPES = (Number, np.ndarray, torch.Tensor)

    @property
    def values(self):
        return self._values

    def __len__(self):
        return self._values.shape[0]

    @property
    def size(self):
        return self._values.numel()

    @property
    def shape(self):
        return tuple(self._values.shape)

    @property
    def ndim(self):
        return self._values.dim()

    def argmax(self):
        """Flat index of the largest value, ignoring NaNs (nanargmax)."""
        v = self._values
        if v.is_floating_point():
            v = torch.nan_to_num(v, nan=-float("inf"))
        return torch.argmax(v)

    def max(self):
        """1-element slice at the largest value."""
        idx = np.unravel_index(int(self.argmax()), self.shape)
        return self[tuple(slice(i, i + 1) for i in idx)]

    def amax(self):
        """Largest value ignoring NaNs (0-d tensor; NaN if all are)."""
        return nanmax(self._values)

    # -- arithmetic: a series of the same class on the same coordinate ------
    def _binop(self, other, op, reflexive=False):
        if not isinstance(other, self._HANDLED_TYPES + (Signal, list)):
            return NotImplemented
        if isinstance(other, Signal):
            other = other._values
        elif isinstance(other, (np.ndarray, list)):
            other = as_tensor(other, self._values.device)
        a, b = (other, self._values) if reflexive else (self._values, other)
        return self._replace_data(op(a, b))

    def __add__(self, o):
        return self._binop(o, operator.add)

    def __radd__(self, o):
        return self._binop(o, operator.add, True)

    def __sub__(self, o):
        return self._binop(o, operator.sub)

    def __rsub__(self, o):
        return self._binop(o, operator.sub, True)

    def __mul__(self, o):
        return self._binop(o, operator.mul)

    def __rmul__(self, o):
        return self._binop(o, operator.mul, True)

    def __truediv__(self, o):
        return self._binop(o, operator.truediv)

    def __rtruediv__(self, o):
        return self._binop(o, operator.truediv, True)


class TSeries(Signal):
    """1-D time-indexed series (reference core.py:460-856)."""

    def __init__(self, time=None, values=None, assume_sorted=False, device=None):
        if time is None and values is None:
            raise ValueError("Either time or values must be given.")
        if values is None:
            time = _place(time, device, None)
            values = torch.ones(time.shape[0], dtype=torch.float64, device=time.device)
        values = _place(values, device, time)
        if time is None:
            time = torch.arange(values.shape[0], device=values.device)
        time = _place(time, device, values)
        if time.shape[0] != values.shape[0]:
            raise ValueError("Input arrays have incompatible lengths.")
        if time.device != values.device:
            raise ValueError(f"time is on {time.device}, values on {values.device}")
        if not assume_sorted:
            order = torch.argsort(time, stable=True)
            time = time[order]
            values = values[order]
        self._time = time
        self._values = values
        self.attrs = {}

    @property
    def time(self):
        return self._time

    def _replace_data(self, data):
        return TSeries(self._time, data, assume_sorted=True)

    def __getitem__(self, key):
        if isinstance(key, tuple):
            (key,) = key
        time = self._time[key]
        values = self._values[key]
        if values.dim() < 1:
            return values
        return TSeries(time, values)

    @property
    def baseline(self):
        return self._time[-1] - self._time[0]

    @property
    def median_dt(self):
        return _median(torch.diff(self._time))


class FSeries(Signal):
    """1-D frequency-indexed series with a dual period coordinate
    (reference core.py:859-1027)."""

    def __init__(self, frequency=None, values=None, assume_sorted=False, device=None):
        if frequency is None:
            raise ValueError("frequency must be given.")
        frequency = _place(frequency, device, values)
        if values is None:
            values = torch.ones(frequency.shape[0], dtype=torch.float64,
                                device=frequency.device)
        values = _place(values, device, frequency)
        frequency = frequency.to(values.device)
        if frequency.shape[0] != values.shape[0]:
            raise ValueError("Input arrays have incompatible lengths.")
        if not assume_sorted:
            order = torch.argsort(frequency, stable=True)
            frequency = frequency[order]
            values = values[order]
        self._frequency = frequency
        self._values = values
        self.attrs = {}

    @property
    def frequency(self):
        return self._frequency

    @property
    def period(self):
        return 1.0 / self._frequency

    def _replace_data(self, data):
        return FSeries(self._frequency, data, assume_sorted=True)

    def __getitem__(self, key):
        if isinstance(key, tuple):
            (key,) = key
        freq = self._frequency[key]
        values = self._values[key]
        if values.dim() < 1:
            return values
        return FSeries(freq, values)

    def find_peaks(self, include_edges=False, prominence=0.0, height=None,
                   **peak_kwargs):
        """Local maxima with prominences (no selection criteria yet).

        Returns an FSeries of the peak samples; ``attrs`` carries
        ``prominences``, ``left_bases``, ``right_bases`` and ``indices``
        as tensors on the series' device. ``height``, a nonzero
        ``prominence`` and the other scipy criteria raise
        NotImplementedError (ROADMAP A4)."""
        from ..ops import peaks as _peaks

        if self.ndim != 1:
            raise NotImplementedError("'find_peaks' is only implemented for 1D arrays.")
        idx, k, _ = _peaks.find_peaks_full(
            self._values, height=height, prominence=prominence or None,
            **peak_kwargs,
        )
        maxima = idx[:k]
        proms, lb, rb = _peaks.peak_prominences(self._values, maxima)
        res = {"prominences": proms, "left_bases": lb, "right_bases": rb}
        if include_edges:
            edge = maxima.new_tensor([0])
            maxima = torch.cat([edge, maxima, edge - 1])
            for key, vals in res.items():
                fill = vals.new_tensor([float("nan") if vals.is_floating_point() else -1])
                res[key] = torch.cat([fill, vals, fill])
        res["indices"] = maxima
        peaks = self[maxima]
        peaks.attrs.update(res)
        return peaks

    def pmax(self):
        return self.max().period[0]

    @property
    def period_at_highest_peak(self):
        return self.find_peaks().pmax()
