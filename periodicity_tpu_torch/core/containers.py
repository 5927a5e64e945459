"""Labeled series containers over torch tensors (TSeries / FSeries).

Port of the slice of ``periodicity_tpu/core/containers.py`` that the GLS
path uses: the constructors (sorting by coordinate), the shape surface,
``argmax``/``max``, the time-grid properties of ``TSeries`` and the
peak readout of ``FSeries``. Values and coordinates stay on the device
and in the dtype they were given; array-likes that are not tensors go
through numpy first, so Python floats become float64 as under JAX's x64
mode. The peak kernels are imported when first used.
"""

import numpy as np
import torch

__all__ = ["Signal", "TSeries", "FSeries", "as_tensor"]


def as_tensor(x, device=None):
    """``x`` as a tensor, keeping its dtype (non-tensors go through numpy)."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    return torch.from_numpy(np.array(x)).to(device)


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


class TSeries(Signal):
    """1-D time-indexed series (reference core.py:460-856)."""

    def __init__(self, time=None, values=None, assume_sorted=False):
        if time is None and values is None:
            raise ValueError("Either time or values must be given.")
        if values is None:
            time = as_tensor(time)
            values = torch.ones(time.shape[0], dtype=torch.float64, device=time.device)
        values = as_tensor(values)
        if time is None:
            time = torch.arange(values.shape[0], device=values.device)
        time = as_tensor(time)
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

    def __init__(self, frequency=None, values=None, assume_sorted=False):
        if frequency is None:
            raise ValueError("frequency must be given.")
        frequency = as_tensor(frequency)
        if values is None:
            values = torch.ones(frequency.shape[0], dtype=torch.float64,
                                device=frequency.device)
        values = as_tensor(values)
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
