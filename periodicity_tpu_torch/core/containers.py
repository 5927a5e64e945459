"""Labeled series containers over torch tensors (TSeries / FSeries / TFSeries).

Port of ``periodicity_tpu/core/containers.py``, with its surface: the
constructors (sorting by coordinate), the nan-aware reductions with named
dims, the arithmetic and comparison operators, the numpy protocol, peak
finding, noise estimation and smoothing, the calculus, spectra and
resampling of ``TSeries``, the peak readout of ``FSeries`` and the 2-D
``TFSeries`` with its bin reductions.

Devices. Tensors keep their device and dtype. Array-likes that are not
tensors go through numpy first, so Python floats become float64 as under
JAX's x64 mode, and land on the card (``torch.device("cuda")``) unless
``device`` says otherwise; a coordinate given as an array-like follows its
values' device. Without a CUDA device and without ``device="cpu"`` (or CPU
tensors) construction raises: it never falls back to the CPU quietly.

Where the JAX package computes on the host in numpy, so does the port,
and the result goes back to the series' device: the uniform-grid tests,
``polyfit``, the bin reductions, the Nelder-Mead objective, noise
estimation and the data-dependent ``dropna``/``split``/``join``/``pad``.

The numpy protocol keeps JAX's surface and no more: ``__array__`` is a host
copy, ``__array_ufunc__`` maps a ufunc to the torch function of the same
name on the series' device (else numpy on a host copy), and
``__array_function__`` dispatches through the ``implements`` registry.
"""

import operator
import warnings
from numbers import Number

import numpy as np
import torch

from ..ops import filters as _filters
from ..ops import optimize as _optimize
from ..ops import peaks as _peaks
from ..ops import spline as _spline
from ..utils.dtypes import result_dtype

__all__ = [
    "Signal",
    "TSeries",
    "FSeries",
    "TFSeries",
    "as_tensor",
    "nanmax",
    "implements",
    "wrap_reduce",
    "full_like",
    "zeros_like",
    "ones_like",
]


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
    """``x`` as a tensor, keeping its dtype. A tensor, or a container's
    values, stays on its device unless ``device`` is given; anything else
    goes through numpy to ``device``, or to the card when that is None."""
    if isinstance(x, Signal):
        x = x.values
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


def _host(x):
    """A numpy copy of a tensor, on the host."""
    return x.detach().cpu().numpy()


def _float(x):
    """Integer and boolean tensors as float64 (JAX's x64 promotion);
    floating and complex ones as they are."""
    return x if (x.is_floating_point() or x.is_complex()) else x.to(torch.float64)


def _nan(like):
    """A 0-d float64 NaN on ``like``'s device: it keeps a float32 tensor
    float32 and promotes an integer one to float64 in ``torch.where``."""
    return torch.tensor(float("nan"), dtype=torch.float64, device=like.device)


def _uniform_spacing(coord):
    """Median spacing when the grid is uniform up to dtype rounding, else
    None (host numpy). The tolerance is dtype-aware, capped at a quarter of
    the spacing so that a float32 axis with a large epoch is not taken for
    uniform."""
    c = _host(coord)
    d = np.diff(c)
    md = np.median(d)
    atol = 0.0
    if np.issubdtype(c.dtype, np.floating):
        atol = 8 * np.finfo(c.dtype).eps * float(np.max(np.abs(c)))
        atol = min(atol, 0.25 * float(np.abs(md)))
    if np.allclose(d, md, rtol=1e-5, atol=atol):
        return md
    return None


# -- nan-aware reductions (jnp.nan*) -----------------------------------------


def nanmax(x, dim=None):
    """Largest value of ``x`` (along ``dim``) ignoring NaNs, NaN where all
    are, as ``jnp.nanmax``."""
    if not x.is_floating_point():
        return x.max() if dim is None else x.amax(dim)
    nan = torch.isnan(x)
    m = torch.where(nan, float("-inf"), x)
    if dim is None:
        return torch.where(nan.all(), float("nan"), m.max())
    return torch.where(nan.all(dim), float("nan"), m.amax(dim))


def _nanmin(x, dim=None):
    return -nanmax(-x, dim)


def _nanarg(x, dim, largest):
    """``jnp.nanargmax``/``nanargmin``: NaNs ignored, -1 where all are."""
    if not x.is_floating_point():
        return x.argmax(dim) if largest else x.argmin(dim)
    nan = torch.isnan(x)
    fill = float("-inf") if largest else float("inf")
    v = torch.where(nan, fill, x)
    i = v.argmax(dim) if largest else v.argmin(dim)
    return torch.where(nan.all() if dim is None else nan.all(dim), -1, i)


def _nanmean(x, dim=None):
    x = _float(x)
    return torch.nanmean(x) if dim is None else torch.nanmean(x, dim=dim)


def _nansum(x, dim=None):
    if not (x.is_floating_point() or x.is_complex()):
        return x.sum() if dim is None else x.sum(dim)
    return torch.nansum(x) if dim is None else torch.nansum(x, dim=dim)


def _nanprod(x, dim=None):
    if x.is_floating_point():
        x = torch.where(torch.isnan(x), 1.0, x)
    return x.prod() if dim is None else x.prod(dim)


def _nanmedian(x, dim=None):
    """Median ignoring NaNs, averaging the two middle values of an even
    count as ``jnp.nanmedian`` does (``torch.nanmedian`` returns the lower
    one); NaN where every value is."""
    x = _float(x)
    if dim is None:
        x, dim = x.reshape(-1), 0
    s = torch.sort(x, dim=dim).values  # NaNs sort last
    k = (~torch.isnan(x)).sum(dim, keepdim=True)
    lo = s.gather(dim, torch.clamp((k - 1) // 2, min=0))
    hi = s.gather(dim, torch.clamp(k // 2, min=0))
    return torch.where(k == 0, float("nan"), (lo + hi) * 0.5).squeeze(dim)


def _nanvar(x, dim=None, ddof=0):
    """Variance ignoring NaNs with ``ddof`` (0 as in ``jnp.nanvar``;
    ``torch.var`` defaults to 1 and has no nan-aware form)."""
    x = _float(x)
    nan = torch.isnan(x)
    count = (~nan).sum() if dim is None else (~nan).sum(dim)
    mean = torch.nanmean(x) if dim is None else torch.nanmean(x, dim=dim, keepdim=True)
    d = torch.where(nan, 0.0, x - mean)
    ss = (d * d).sum() if dim is None else (d * d).sum(dim)
    return ss / (count - ddof)


def _nanstd(x, dim=None, ddof=0):
    return torch.sqrt(_nanvar(x, dim, ddof))


def _median(x):
    """Median that averages the two middle values of an even count, as
    ``jnp.median`` does (``torch.median`` returns the lower one)."""
    s = torch.sort(x).values
    n = s.shape[0]
    if n % 2:
        return s[n // 2]
    return (s[n // 2 - 1] + s[n // 2]) * 0.5


def _shape(x):
    return tuple(getattr(x, "shape", ()))


# torch functions whose numpy ufunc name means something else in torch
_UFUNC_ALIASES = {"equal": torch.eq}


class Signal:
    """Base container: a named-coordinate tensor with numpy-like semantics."""

    _HANDLED_TYPES = (Number, np.ndarray, torch.Tensor)
    __array_priority__ = 100

    # -- subclass interface -------------------------------------------------
    @property
    def dims(self):
        raise NotImplementedError

    def _coord_arrays(self):
        raise NotImplementedError

    def _replace_data(self, data):
        raise NotImplementedError

    def _wrap_reduced(self, axis, data):
        raise NotImplementedError

    # -- shared surface ------------------------------------------------------
    @property
    def values(self):
        return self._values

    @values.setter
    def values(self, new):
        new = _place(new, None, self._values)
        if new.shape != self._values.shape:
            raise ValueError("values assignment must preserve shape")
        self._values = new

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

    @property
    def dtype(self):
        return self._values.dtype

    @property
    def device(self):
        return self._values.device

    @property
    def coords(self):
        """dims -> coordinate tensors."""
        return dict(zip(self.dims, self._coord_arrays()))

    @property
    def index(self):
        """The same mapping as :attr:`coords`: every coordinate here is an
        index coordinate."""
        return self.coords

    def get_axis(self, dim):
        """Positional axis of the named dimension."""
        try:
            return self.dims.index(dim)
        except ValueError:
            raise ValueError(f"{dim} not found in {self.dims}.") from None

    def from_xray(self, xray, **kwargs):
        """A container of this type, on this one's device, from an
        xarray.DataArray-like object (duck-typed on ``.dims``, ``.values``
        and ``.coords[d].values``). 0-d input gives a Python scalar; extra
        kwargs (e.g. ``assume_sorted``) go to the constructor."""
        if getattr(xray, "ndim", None) == 0:
            return xray.item()
        src_dims = tuple(xray.dims)
        if set(src_dims) != set(self.dims):
            raise ValueError(f"dims {src_dims} do not match {tuple(self.dims)}")
        coords = {d: np.asarray(xray.coords[d].values) for d in src_dims}
        vals = np.asarray(xray.values)
        if src_dims != tuple(self.dims):
            # align the value axes with this container's dim order
            vals = vals.transpose([src_dims.index(d) for d in self.dims])
        kwargs.setdefault("device", self.device)
        new = type(self)(values=vals, **coords, **kwargs)
        new.attrs.update(dict(getattr(xray, "attrs", {}) or {}))
        return new

    def copy(self):
        new = self._replace_data(self._values)
        new.attrs.update(self.attrs)
        return new

    def __repr__(self):
        return (f"<{type(self).__name__} {dict(zip(self.dims, self.shape))}>\n"
                f"{_host(self._values)!r}")

    def __array__(self, dtype=None, copy=None):
        arr = _host(self._values)
        return arr.astype(dtype) if dtype is not None else arr

    # -- arithmetic ----------------------------------------------------------
    def _binop(self, other, op, reflexive=False):
        if not isinstance(other, self._HANDLED_TYPES + (Signal, list)):
            # let Python fall back (``ts == "foo"`` is identity, False)
            return NotImplemented
        if isinstance(other, Signal):
            other = other._values
        elif isinstance(other, (np.ndarray, list)):
            other = as_tensor(other, self._values.device)
        values = self._values
        if op is operator.truediv or isinstance(other, float):
            # JAX's x64 mode makes these float64 from integers; torch
            # would give float32
            values = _float(values)
            if isinstance(other, torch.Tensor):
                other = _float(other)
        a, b = (other, values) if reflexive else (values, other)
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

    def __floordiv__(self, o):
        return self._binop(o, operator.floordiv)

    def __mod__(self, o):
        return self._binop(o, operator.mod)

    def __pow__(self, o):
        return self._binop(o, operator.pow)

    def __rpow__(self, o):
        return self._binop(o, operator.pow, True)

    def __neg__(self):
        return self._replace_data(-self._values)

    def __pos__(self):
        return self._replace_data(+self._values)

    def __abs__(self):
        return self._replace_data(torch.abs(self._values))

    def __lt__(self, o):
        return self._binop(o, operator.lt)

    def __le__(self, o):
        return self._binop(o, operator.le)

    def __gt__(self, o):
        return self._binop(o, operator.gt)

    def __ge__(self, o):
        return self._binop(o, operator.ge)

    def __eq__(self, o):  # value semantics, as xarray
        return self._binop(o, operator.eq)

    def __ne__(self, o):
        return self._binop(o, operator.ne)

    __hash__ = None

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        if method != "__call__" or kwargs.get("out"):
            return NotImplemented
        ref = next(x for x in inputs if isinstance(x, Signal))
        dev = ref.device
        vals = [x._values if isinstance(x, Signal) else x for x in inputs]
        fn = _UFUNC_ALIASES.get(ufunc.__name__, getattr(torch, ufunc.__name__, None))
        if fn is None:
            res = ufunc(*[_host(v) if isinstance(v, torch.Tensor) else v for v in vals],
                        **kwargs)
            res = torch.from_numpy(np.asarray(res)).to(dev)
        else:
            res = fn(*[v if isinstance(v, torch.Tensor) else torch.as_tensor(
                v, dtype=torch.float64 if isinstance(v, float) else None, device=dev)
                for v in vals], **kwargs)
        if res.dim() == 0:
            return res
        if tuple(res.shape) == ref.shape:
            return ref._replace_data(res)
        return res

    _ARRAY_FUNCS = {}

    def __array_function__(self, func, types, args, kwargs):
        impl = Signal._ARRAY_FUNCS.get(getattr(func, "__name__", None))
        if impl is None:
            return NotImplemented
        return impl(*args, **kwargs)

    # -- reductions (nan-aware) -----------------------------------------------
    def all(self, axis=None):
        return self._values.all() if axis is None else self._values.all(axis)

    def any(self, axis=None):
        return self._values.any() if axis is None else self._values.any(axis)

    def argmax(self, axis=None):
        """Index of the largest value ignoring NaNs (flat when ``axis`` is
        None; -1 where all are NaN)."""
        v = self._values.reshape(-1) if axis is None else self._values
        return _nanarg(v, axis, largest=True)

    def argmin(self, axis=None):
        v = self._values.reshape(-1) if axis is None else self._values
        return _nanarg(v, axis, largest=False)

    def amax(self, axis=None):
        """Largest value ignoring NaNs (0-d tensor; NaN if all are)."""
        return nanmax(self._values, axis)

    def amin(self, axis=None):
        return _nanmin(self._values, axis)

    def mean(self, dim=None, **kw):
        return self._reduce(_nanmean, dim, **kw)

    def median(self, dim=None, **kw):
        return self._reduce(_nanmedian, dim, **kw)

    def sum(self, dim=None, **kw):
        return self._reduce(_nansum, dim, **kw)

    def prod(self, dim=None, **kw):
        return self._reduce(_nanprod, dim, **kw)

    def std(self, dim=None, **kw):
        """Standard deviation ignoring NaNs, with ``ddof=0`` unless given."""
        return self._reduce(_nanstd, dim, **kw)

    def var(self, dim=None, **kw):
        return self._reduce(_nanvar, dim, **kw)

    def _reduce(self, fn, dim=None, **kw):
        axis = kw.pop("axis", None)
        if dim is None and axis is not None:
            # numpy-protocol callers (np.mean(tfs, axis=0)) reduce by axis
            # number; translate it to the named dim so that the result is
            # wrapped with its surviving coordinate
            if isinstance(axis, (tuple, list)) and len(axis) == 1:
                axis = axis[0]
            if isinstance(axis, (int, np.integer)):
                dim = self.dims[int(axis) % self.ndim]
            elif not (isinstance(axis, (tuple, list)) and len(axis) >= self.ndim):
                # a partial tuple reduction would drop the surviving dim's labels
                raise NotImplementedError(
                    f"partial tuple-axis reduction {axis!r} on "
                    f"{type(self).__name__}; reduce one named dim at a time"
                )
        if dim is None:
            return fn(self._values, **kw)
        axis = self.dims.index(dim)
        return self._wrap_reduced(axis, fn(self._values, axis, **kw))

    def max(self):
        """1-element slice at the largest value."""
        idx = np.unravel_index(int(self.argmax()), self.shape)
        return self[tuple(slice(i, i + 1) for i in idx)]

    def min(self):
        idx = np.unravel_index(int(self.argmin()), self.shape)
        return self[tuple(slice(i, i + 1) for i in idx)]

    def roll(self, shift):
        return self._replace_data(torch.roll(self._values, shift))

    def isnull(self):
        v = self._values
        if v.is_floating_point() or v.is_complex():
            return self._replace_data(torch.isnan(v))
        return self._replace_data(torch.zeros_like(v, dtype=torch.bool))

    def count(self, axis=None):
        ok = ~torch.isnan(self._values)
        return ok.sum() if axis is None else ok.sum(axis)

    # -- peak finding ----------------------------------------------------------
    def find_peaks(self, include_edges=False, prominence=0.0, height=None, **peak_kwargs):
        """Local maxima with prominences and any of scipy's criteria.

        Returns a container of the peak samples; ``attrs`` carries
        ``prominences``, ``left_bases``, ``right_bases``, ``indices`` and
        the property tensors of every criterion given, on the series'
        device. The criteria are ``height``, ``threshold``, ``distance``,
        ``prominence``, ``width`` (with ``wlen``/``rel_height``) and
        ``plateau_size``, each a scalar or a (min, max) pair.
        """
        allowed = {"threshold", "distance", "width", "wlen", "rel_height", "plateau_size"}
        unknown = set(peak_kwargs) - allowed
        if unknown:
            raise TypeError(
                f"find_peaks got unknown criteria {sorted(unknown)}; "
                f"supported: height, prominence, {sorted(allowed)}"
            )
        if self.ndim != 1:
            raise NotImplementedError("'find_peaks' is only implemented for 1D arrays.")
        idx, k, props = _peaks.find_peaks_full(
            self._values, height=height,
            prominence=prominence if np.ndim(prominence) or prominence else None,
            **peak_kwargs,
        )
        res = {key: v[:k] for key, v in props.items()}
        if "prominences" not in res:
            proms, lb, rb = _peaks.peak_prominences(self._values, idx[:k])
            res.update(prominences=proms, left_bases=lb, right_bases=rb)
        maxima = idx[:k]
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

    def find_dips(self, include_edges=False, prominence=0.0, **kw):
        if self.ndim != 1:
            raise NotImplementedError("'find_dips' is only implemented for 1D arrays.")
        inner = (-self).find_peaks(include_edges, prominence, **kw)
        dips = -inner
        dips.attrs.update(inner.attrs)
        return dips

    def find_zero_crossings(self, height=None, delta=0.0):
        """Indices (a tensor on the series' device) of the samples before
        each sign change; with ``height``, the peaks of -|x| above -height
        (and of prominence ``delta``)."""
        if self.ndim != 1:
            raise NotImplementedError(
                "'find_zero_crossings' is only implemented for 1D arrays."
            )
        if height is None:
            return torch.nonzero(_peaks.zero_crossings_mask(self._values))[:, 0]
        idx, cnt, _, _, _ = _peaks.find_peaks(
            -torch.abs(self._values), height=-height, prominence=delta if delta else None,
        )
        return idx[:cnt]

    # -- noise and smoothing ----------------------------------------------------
    def estimate_noise(self, sigma=3.0, n_iter=3):
        """Median-filter residue and k-sigma clipping noise estimate, with
        the 1-D/2-D correction factors (host numpy; a numpy float)."""
        x = _host(self._values)
        if self.ndim == 1:
            xp = np.pad(x, 1, mode="symmetric")
            med = np.median(np.stack([xp[:-2], xp[1:-1], xp[2:]]), axis=0)
        elif self.ndim == 2:
            xp = np.pad(x, 1, mode="symmetric")
            stack = [xp[i: i + x.shape[0], j: j + x.shape[1]] for i in range(3)
                     for j in range(3)]
            med = np.median(np.stack(stack), axis=0)
        else:
            raise NotImplementedError(
                "'estimate_noise' is only implemented for 1D or 2D arrays."
            )
        residue = x - med
        sd = np.std(residue)
        index = np.isfinite(residue)
        for _ in range(n_iter):
            mu = np.mean(residue[index])
            sd = np.std(residue[index])
            index = np.abs(residue - mu) < sigma * sd
        return sd / (0.893421 if self.ndim == 1 else 0.969684)

    def smooth(self, width, kernel="gaussian", **kwargs):
        """Low-pass FIR filter: ``gaussian`` (sigma = width, scipy's
        reflect boundary), ``boxcar`` or ``triangle`` (mirror boundary)."""
        v = self._values
        if kernel == "gaussian":
            xf = _filters.gaussian_filter(v, sigma=width, **kwargs)
        elif kernel == "boxcar":
            k1 = _filters.boxcar_kernel1d(width, dtype=v.dtype)
            xf = (_filters.convolve1d(v, k1) if self.ndim == 1
                  else _filters.convolve2d(v, torch.outer(k1, k1)))
        elif kernel == "triangle":
            if self.ndim == 1:
                xf = _filters.convolve1d(v, _filters.triangle_kernel1d(width, dtype=v.dtype))
            else:
                # the reference composes the integer ramp (w_i + w_j - 1)
                # before normalizing; composing the normalized 1-D weights
                # would invert the pyramid
                half = int(width // 2)
                ramp = np.asarray(list(range(1, half + 2)) + list(range(half, 0, -1)), float)
                k2 = ramp[:, None] + ramp[None, :] - 1.0
                xf = _filters.convolve2d(v, torch.from_numpy(k2 / k2.sum()).to(v.dtype))
        else:
            raise ValueError(f"Kernel type '{kernel}' is unknown.")
        return self._replace_data(xf)

    def convolve(self, kernel):
        """ndimage.convolve with the mirror boundary."""
        kernel = as_tensor(kernel, self.device)
        if self.ndim == 1:
            xf = _filters.convolve1d(self._values, kernel, mode="mirror")
        else:
            xf = _filters.convolve2d(self._values, kernel, mode="mirror")
        return self._replace_data(xf)

    # -- plotting and export (host copies) ----------------------------------------
    def plot(self, *args, **kwargs):
        import matplotlib.pyplot as plt

        return plt.plot(_host(self._coord_arrays()[0]), _host(self._values), *args, **kwargs)

    def hist(self, *args, **kwargs):
        import matplotlib.pyplot as plt

        return plt.hist(_host(self._values).ravel(), *args, **kwargs)

    def to_pandas(self):
        import pandas as pd

        coords = self._coord_arrays()
        if self.ndim == 1:
            return pd.Series(_host(self._values), index=_host(coords[0]))
        return pd.DataFrame(_host(self._values), index=_host(coords[0]),
                            columns=_host(coords[1]))


def implements(numpy_function):
    """Register an ``__array_function__`` implementation for containers,
    keyed by the numpy function's name: the extension point that teaches
    numpy-protocol functions about them."""

    def decorator(func):
        Signal._ARRAY_FUNCS[numpy_function.__name__] = func
        return func

    return decorator


def wrap_reduce(func):
    """Lift a raw-array reduction into a container-aware one: a named
    ``dim`` becomes the positional axis, full reductions return scalars,
    shape-preserving results rewrap in the same container, and single-axis
    reductions of 2-D containers wrap with the surviving coordinate."""

    def wrapped_func(signal, dim=None, **kwargs):
        if dim is not None:
            kwargs["axis"] = signal.get_axis(dim)
        axis = kwargs.pop("axis", None)
        keepdims = kwargs.get("keepdims", False)
        if axis is None:
            result = func(signal.values, **kwargs)
            if keepdims and np.prod(_shape(result)) == 1:
                # kept size-1 dims carry no coordinate: a scalar
                result = result.reshape(())
            if len(_shape(result)) == 0:
                return result
            if _shape(result) == signal.shape:
                return signal._replace_data(result)
            return result
        axis = axis % signal.ndim
        result = func(signal.values, axis=axis, **kwargs)
        if keepdims and _shape(result)[axis] == 1:
            result = result.squeeze(axis)
        if _shape(result) == signal.shape:
            return signal._replace_data(result)
        return signal._wrap_reduced(axis, result)

    return wrapped_func


def _register_array_funcs():
    def reduce_entry(np_name, method):
        def impl(sig, *args, **kwargs):
            return getattr(sig, method)(*args, **kwargs)

        Signal._ARRAY_FUNCS[np_name] = impl

    for np_name, method in [
        ("all", "all"), ("any", "any"), ("argmax", "argmax"), ("argmin", "argmin"),
        ("amax", "amax"), ("max", "amax"), ("nanmax", "amax"),
        ("amin", "amin"), ("min", "amin"), ("nanmin", "amin"),
        ("mean", "mean"), ("nanmean", "mean"), ("median", "median"), ("nanmedian", "median"),
        ("sum", "sum"), ("nansum", "sum"), ("prod", "prod"),
        ("std", "std"), ("nanstd", "std"), ("var", "var"), ("nanvar", "var"),
        ("roll", "roll"),
    ]:
        reduce_entry(np_name, method)

    Signal._ARRAY_FUNCS["full_like"] = lambda sig, fill, **kw: sig._replace_data(
        torch.full_like(sig._values, fill, **kw))
    Signal._ARRAY_FUNCS["zeros_like"] = lambda sig, **kw: sig._replace_data(
        torch.zeros_like(sig._values, **kw))
    Signal._ARRAY_FUNCS["ones_like"] = lambda sig, **kw: sig._replace_data(
        torch.ones_like(sig._values, **kw))


_register_array_funcs()


def full_like(signal, fill_value, **kwargs):
    """Same-type container filled with ``fill_value`` (also
    ``np.full_like(signal, v)`` through the numpy function protocol)."""
    return Signal._ARRAY_FUNCS["full_like"](signal, fill_value, **kwargs)


def zeros_like(signal, **kwargs):
    """Same-type container of zeros (also ``np.zeros_like(signal)``)."""
    return Signal._ARRAY_FUNCS["zeros_like"](signal, **kwargs)


def ones_like(signal, **kwargs):
    """Same-type container of ones (also ``np.ones_like(signal)``)."""
    return Signal._ARRAY_FUNCS["ones_like"](signal, **kwargs)


def _bin_mean(which, v, n_bins, func):
    """Reduce ``v`` [N] by bin ``which`` [N] onto ``n_bins`` bins (NaN where
    a bin holds no finite sample): the mean by two bincounts, or ``func``
    per nonempty bin over one split of the samples sorted by bin."""
    good = ~np.isnan(v)
    out = np.full(n_bins, np.nan)
    if func is None or func is np.mean:
        sums = np.bincount(which[good], weights=v[good], minlength=n_bins)
        counts = np.bincount(which[good], minlength=n_bins)
        np.divide(sums, counts, out=out, where=counts > 0)
    else:
        order = np.argsort(which[good], kind="stable")
        ids = which[good][order]
        vals = v[good][order]
        if ids.size:
            starts = np.flatnonzero(np.r_[True, np.diff(ids) > 0])
            out[ids[starts]] = [func(g) for g in np.split(vals, starts[1:])]
    return out


def _bins(x, n_bins):
    """Bin of every coordinate on ``n_bins`` equal bins over its range."""
    lo, hi = x.min(), x.max()
    edges = np.linspace(lo, hi, n_bins + 1)
    edges[0] -= 1e-9 * (hi - lo)
    return np.clip(np.searchsorted(edges, x, "left") - 1, 0, n_bins - 1)


class _TimeGrid:
    """The time-grid properties of a container with a ``_time`` axis."""

    @property
    def median_dt(self):
        return _median(torch.diff(self._time))

    @property
    def dt(self):
        if _uniform_spacing(self._time) is not None:
            return self.median_dt
        raise AttributeError(
            "The sampling period is only strictly defined for "
            "uniformly sampled signals. Use median_dt for a median value."
        )


class _FrequencyGrid:
    """The frequency- and period-grid properties of a container with a
    ``_frequency`` axis."""

    @property
    def period(self):
        return 1.0 / _float(self._frequency)

    @property
    def median_df(self):
        return _median(torch.diff(self._frequency))

    @property
    def df(self):
        if _uniform_spacing(self._frequency) is not None:
            return self.median_df
        raise AttributeError(
            "The sampling period is only strictly defined for "
            "uniform frequency grids. Use median_df for a median value."
        )

    @property
    def median_dp(self):
        return -_median(torch.diff(self.period))

    @property
    def dp(self):
        d = np.diff(_host(self.period))
        if np.allclose(d, np.median(d)):
            return self.median_dp
        raise AttributeError(
            "The sampling period is only strictly defined for "
            "uniform period grids. Use median_dp for a median value."
        )


class _Series1D(Signal):
    """What TSeries and FSeries share over their one coordinate: the
    host-side ``dropna`` and ``polyfit`` and the Levenberg-Marquardt
    ``curvefit``, each back on the series' device."""

    def dropna(self):
        c, v = _host(self._coord_arrays()[0]), _host(self._values)
        good = ~np.isnan(v)
        return self._new(c[good], v[good], assume_sorted=True)

    def _polyfit(self, x, degree):
        x = _host(x)
        coefs = np.polyfit(x, _host(self._values), degree)
        fit = self._replace_data(torch.from_numpy(np.poly1d(coefs)(x)).to(self.device))
        fit.attrs.update(coefficients=coefs)
        return fit

    def _curvefit(self, x, fun, p0, **kwargs):
        """Least-squares fit of ``fun(x, *p)`` (torch operations) by
        Levenberg-Marquardt; ``attrs`` carries ``coefficients`` and
        ``covariance`` as tensors."""

        def residual(p):
            return fun(x, *p) - self._values

        p0 = torch.as_tensor(np.asarray(p0, float), device=self.device)
        popt, pcov = _optimize.levenberg_marquardt(residual, p0, **kwargs)
        fit = self._replace_data(fun(x, *popt))
        fit.attrs.update(coefficients=popt, covariance=pcov)
        return fit


class TSeries(_TimeGrid, _Series1D):
    """1-D time-indexed series."""

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
    def dims(self):
        return ("time",)

    @property
    def time(self):
        return self._time

    def _coord_arrays(self):
        return (self._time,)

    def _replace_data(self, data):
        return TSeries(self._time, data, assume_sorted=True)

    def _wrap_reduced(self, axis, data):
        return data

    def _new(self, time, values, assume_sorted=False):
        """A TSeries on this one's device (host arrays go there)."""
        return TSeries(time, values, assume_sorted=assume_sorted, device=self.device)

    def __getitem__(self, key):
        if isinstance(key, tuple):
            (key,) = key
        time = self._time[key]
        values = self._values[key]
        if values.dim() < 1:
            return values
        return TSeries(time, values)

    # -- time-grid properties -------------------------------------------------
    @property
    def baseline(self):
        return self._time[-1] - self._time[0]

    def tmax(self):
        return self.max().time[0]

    # -- calculus -------------------------------------------------------------
    @property
    def derivative(self):
        """Second-order nonuniform central differences with first-order
        edges (== np.gradient(values, time))."""
        t, v = _float(self._time), _float(self._values)
        dt = torch.diff(t)
        h1, h2 = dt[:-1], dt[1:]
        interior = ((v[2:] * h1**2 - v[:-2] * h2**2 + v[1:-1] * (h2**2 - h1**2))
                    / (h1 * h2 * (h1 + h2)))
        first = (v[1] - v[0]) / dt[0]
        last = (v[-1] - v[-2]) / dt[-1]
        return TSeries(self._time, torch.cat([first[None], interior, last[None]]),
                       assume_sorted=True)

    @property
    def TEO(self):
        """Teager Energy Operator."""
        d = self.derivative
        return d * d - self * d.derivative

    # -- coordinate transforms --------------------------------------------------
    def timeshift(self, t0):
        return TSeries(_float(self._time) + t0, self._values, assume_sorted=True)

    def timescale(self, alpha):
        return TSeries(_float(self._time) * alpha, self._values)

    def fold(self, period, t0=0):
        """Phase-fold onto [0, 1); the result is sorted by phase."""
        return TSeries(((_float(self._time) - t0) / period) % 1, self._values)

    # -- spectra ------------------------------------------------------------
    def fft(self, oversample=1.0, dt=None):
        nfft = int(oversample * self.size)
        if dt is None:
            dt = self.dt
        freqs = torch.fft.rfftfreq(nfft, d=float(dt), dtype=torch.float64, device=self.device)
        coefs = torch.fft.rfft(_float(self._values), n=nfft)
        return FSeries(freqs, coefs, assume_sorted=True)

    def psd(self, *args, **kwargs):
        f = self.fft(*args, **kwargs)
        return FSeries(f.frequency, torch.square(torch.abs(f.values)), assume_sorted=True)

    def acf(self, max_lag=None, unbias=False):
        """FFT autocorrelation: the IFFT of the 2x-oversampled PSD of the
        mean-subtracted signal, normalized to lag 0, optionally divided by
        the ACF of the sampling mask. A float-valued ``max_lag`` is a time
        span."""
        if max_lag is None:
            max_lag = self.size // 2
        lags = self._time - self._time.min()
        if isinstance(max_lag, torch.Tensor):
            is_time = max_lag.is_floating_point()
        else:
            is_time = np.issubdtype(np.asarray(max_lag).dtype, np.floating)
        if is_time:
            max_lag = int(np.searchsorted(_host(lags), float(max_lag)) + 1)
        max_lag = min(int(max_lag), self.size)
        ryy = (self - self.mean()).psd(oversample=2.0, dt=self.median_dt).ifft()
        if unbias:
            correction = (self / self).psd(oversample=2.0, dt=self.median_dt).ifft()
            ryy = ryy / correction
        vals = ryy.values[:max_lag] / ryy.values[0]
        return TSeries(lags[:max_lag], vals, assume_sorted=True)

    # -- combination and resampling ---------------------------------------------
    def cov(self, other):
        return np.cov(_host(self._values), _host(other._values))[0, 1]

    def corr(self, other):
        return np.corrcoef(_host(self._values), _host(other._values))[0, 1]

    def polyfit(self, degree):
        return self._polyfit(self._time, degree)

    def curvefit(self, fun, p0, **kwargs):
        """Least-squares fit of ``fun(time, *p)`` (torch operations) by
        Levenberg-Marquardt; ``attrs`` carries ``coefficients`` and
        ``covariance`` as tensors."""
        return self._curvefit(self._time, fun, p0, **kwargs)

    def join(self, other, **kwargs):
        st, ot = _host(self._time), _host(other._time)
        if len(np.intersect1d(st, ot)) > 0:
            warnings.warn(
                "There are overlapping timestamps. The corresponding "
                "timestamps in the returned TSeries have both samples."
            )
        return self._new(np.concatenate([st, ot]),
                         np.concatenate([_host(self._values), _host(other._values)]))

    def split(self, max_gap=None):
        if max_gap is None:
            max_gap = 1.5 * float(self.median_dt)
        ids = np.where(np.diff(_host(self._time)) > max_gap)[0]
        ids = np.hstack([0, ids + 1, self.size])
        return [self[int(ids[i]): int(ids[i + 1])] for i in range(len(ids) - 1)]

    def downsample(self, dt, func=None):
        """Bin-reduce onto a uniform grid of step ``dt`` (NaN-mean by
        default, or ``func`` per nonempty bin); empty bins are dropped."""
        t = _host(self._time)
        labels = np.arange(t.min(), t.max(), dt)
        out = _bin_mean(_bins(t, labels.size), _host(self._values), labels.size, func)
        return self._new(labels, out).dropna()

    def interp(self, new_time=None, method="linear", **kwargs):
        """Interpolation onto a new grid. ``linear``/``slinear``,
        ``nearest``, ``zero``, ``quadratic`` and ``cubic`` give NaN outside
        the data range; ``spline`` is the not-a-knot cubic of
        splrep/splev, extrapolated like splev; ``s > 0`` (with ``spline``
        or ``cubic``) is the smoothing spline, whose bisection launches the
        pentadiagonal kernel ~62 times on the card."""
        if new_time is None:
            new_time = np.arange(float(self._time.min()), float(self._time.max()),
                                 float(self.median_dt))
        new_time = _place(new_time, None, self._time)
        dtype = result_dtype(_float(self._time), new_time)
        t, x = self._time.to(dtype), new_time.to(dtype)
        v = _float(self._values)
        if method == "quadratic":
            new_values = _spline.quadratic_spline_interp(t, v, x)
        elif method in ("spline", "cubic"):
            s = kwargs.pop("s", 0)
            if s:
                w = kwargs.pop("w", None)
                new_values = _spline.smoothing_spline_interp(
                    t, v, x, s=s, w=None if w is None else as_tensor(w, self.device))
            else:
                new_values = _spline.spline_interp(t, v, x)
        elif method in ("linear", "slinear"):
            new_values = _interp(x, t, v)
        elif method == "nearest":
            idx = torch.clamp(torch.searchsorted(t, x, side="left"), 0, self.size - 1)
            left = torch.clamp(idx - 1, 0, self.size - 1)
            pick = torch.where((x - t[left]).abs() <= (t[idx] - x).abs(), left, idx)
            new_values = self._values[pick]
        elif method == "zero":
            idx = torch.clamp(torch.searchsorted(t, x, side="right") - 1, 0, self.size - 1)
            new_values = self._values[idx]
        else:
            raise NotImplementedError(f"interp method '{method}'")
        if method in ("linear", "slinear", "nearest", "zero", "quadratic", "cubic"):
            # xarray's interp does not extrapolate: points outside the data
            # range are NaN; 'spline' keeps splev's extrapolation
            outside = (x < t[0]) | (x > t[-1])
            new_values = torch.where(outside, _nan(new_values), new_values)
        return TSeries(new_time, new_values, assume_sorted=True)

    def interpolate_na(self, method="linear", **kwargs):
        """Fill NaNs: ``constant`` (``k``), ``bfill``, ``ffill``, ``random``
        (``mu``, ``sd``, ``random_seed``), ``mirror`` or any ``interp``
        method."""
        v = _host(self._values).copy()
        t = _host(self._time)
        bad = np.isnan(v)
        if method == "constant":
            v[bad] = kwargs.pop("k", 0.0)
        elif method == "bfill":
            idx = np.where(~bad, np.arange(v.size), v.size - 1)
            v = v[np.minimum.accumulate(idx[::-1])[::-1]]
        elif method == "ffill":
            idx = np.where(~bad, np.arange(v.size), 0)
            v = v[np.maximum.accumulate(idx)]
        elif method == "random":
            mu = kwargs.pop("mu", float(self.mean()))
            sd = kwargs.pop("sd", None)
            if sd is None:
                sd = float(self.estimate_noise())
            rng = np.random.default_rng(kwargs.pop("random_seed", None))
            v[bad] = rng.normal(mu, sd, bad.sum())
        elif method == "mirror":
            ids = np.where(np.diff(bad))[0] + 1
            for i in range(ids.size // 2):
                start, end = ids[2 * i], ids[2 * i + 1]
                gap = end - start
                left_ids = np.arange(start, start + gap // 2)
                right_ids = np.arange(end - gap // 2, end)
                v[left_ids] = v[2 * start - left_ids - 1]
                v[right_ids] = v[2 * end - right_ids - 1]
                if gap % 2 == 1:
                    center = (start + end - 1) // 2
                    v[center] = 0.5 * (v[center - 1] + v[center + 1])
        else:
            good = ~bad
            filled = self._new(t[good], v[good], assume_sorted=True).interp(
                torch.from_numpy(t[bad]).to(self.device), method=method, **kwargs)
            v[bad] = _host(filled.values)
        return self._new(t, v, assume_sorted=True)

    def fill_gaps(self, dt=None, **kwargs):
        """Insert timestamps where gaps exceed 1.2 dt (steps of dt from each
        gap's left edge), then interpolate."""
        if dt is None:
            dt = float(self.median_dt)
        t = _host(self._time)
        gaps = np.diff(t)
        counts = np.maximum(np.ceil((gaps - 1.2 * dt) / dt), 0).astype(int)
        total = int(counts.sum())
        if total:
            base = np.repeat(t[:-1], counts)
            group_start = np.repeat(np.cumsum(counts) - counts, counts)
            t_new = base + dt * (np.arange(total) - group_start + 1)
        else:
            t_new = np.empty(0, t.dtype)
        t_new = t_new[~np.isin(t_new, t)]
        if t_new.size:
            result = self.join(self._new(t_new, np.full(t_new.size, np.nan)))
        else:
            result = self.copy()
        return result.interpolate_na(**kwargs)

    def drop(self, index=None):
        if index is None:
            index = []
        return self._new(np.delete(_host(self._time), index),
                         np.delete(_host(self._values), index), assume_sorted=True)

    def pad(self, pad_width, **kwargs):
        """np.pad with separate time/value kwargs: list-valued kwargs apply
        [0] to time and [1] to values."""
        time_kwargs, data_kwargs = {}, {}
        for key, arg in kwargs.items():
            arg = np.asarray(arg, dtype=object) if isinstance(arg, (list, tuple)) else arg
            if np.size(arg) == 1:
                val = arg.item() if isinstance(arg, np.ndarray) else arg
                time_kwargs[key] = val
                data_kwargs[key] = val
            else:
                time_kwargs[key] = arg[0]
                data_kwargs[key] = arg[1]
        for kw in (time_kwargs, data_kwargs):
            if kw.get("reflect_type", "x") is None:
                kw["reflect_type"] = "even"
        return self._new(np.pad(_host(self._time), pad_width, **time_kwargs),
                         np.pad(_host(self._values), pad_width, **data_kwargs))

    def get_envelope(self, pad_width=0, **peak_kwargs):
        """Upper and lower cubic-spline envelopes through the padded
        extrema."""
        peaks = self.find_peaks(include_edges=True, **peak_kwargs)
        dips = self.find_dips(include_edges=True, **peak_kwargs)
        if peaks.size < (2 + pad_width) or dips.size < (2 + pad_width):
            raise ValueError("Signal doesn't have enough extrema for padding.")
        peaks = peaks.pad(pad_width, mode="reflect", reflect_type=["odd", None]).drop(
            [pad_width, -pad_width - 1])
        dips = dips.pad(pad_width, mode="reflect", reflect_type=["odd", None]).drop(
            [pad_width, -pad_width - 1])
        if peaks.size < 4 or dips.size < 4:
            raise ValueError("Signal doesn't have enough extrema for envelope interpolation.")
        upper = peaks.interp(new_time=self._time, method="spline")
        lower = dips.interp(new_time=self._time, method="spline")
        return upper, lower

    def butterworth(self, fmin=None, fmax=None, order=5):
        """Zero-phase Butterworth band-, low- or high-pass, filtered in
        float64 on the series' device (the recursion kernel on the card,
        two launches) and cast back to the series' dtype."""
        nyq = 0.5 / float(self.median_dt)
        if fmin is not None and fmax is None:
            wn, btype = fmin / nyq, "highpass"
        elif fmin is None and fmax is not None:
            wn, btype = fmax / nyq, "lowpass"
        elif fmin is not None and fmax is not None:
            wn, btype = [fmin / nyq, fmax / nyq], "bandpass"
        else:
            raise ValueError("At least one of 'fmin' and 'fmax' must be given!")
        sos = _filters.butter_sos(order, wn, btype)
        return self._replace_data(_filters.sosfiltfilt(sos, self._values))

    def acf_period_quality(self, p_min, p_max):
        """Band-pass, ACF, boxcar smoothing and an exponential-cosine fit:
        (best period, its prominence, quality)."""
        t = _host(self._time)
        ml = int(np.searchsorted(t - t[0], 2 * p_max))
        rxx = self.butterworth(1 / p_max, 1 / p_min).acf(max_lag=ml)
        if p_max >= 20:
            rxx = rxx.smooth(int(p_max // 10), kernel="boxcar")
            rxx = rxx / rxx.amax()
        peaks = rxx.find_peaks()
        proms = peaks.attrs["prominences"]
        best_per = float(peaks.time[int(proms.argmax())])
        height = float(proms.max())
        tau_max = 20 * p_max / best_per
        rt = _host(rxx.time)
        rv = _host(rxx.values)

        def rss(params):
            log_aa, log_tt = params
            model = (np.exp(log_aa) * np.exp(-rt / np.exp(log_tt))
                     * np.cos(2 * np.pi * rt / best_per))
            return np.sum(np.square(rv - model))

        (log_amp, log_tau), _ = _optimize.nelder_mead(rss, [0.0, np.log(best_per * 2)])
        tau = min(np.exp(log_tau), tau_max)
        quality = (tau / best_per) * (ml * height / rss([log_amp, np.log(tau)]))
        return best_per, height, quality


def _interp(x, xp, fp):
    """``jnp.interp(x, xp, fp)``: linear, clamped to the end values."""
    i = torch.clamp(torch.searchsorted(xp, x, side="right"), 1, xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(np.spacing(np.finfo(np.float32 if xp.dtype == torch.float32
                                    else np.float64).eps))
    dx0 = dx.abs() <= eps
    f = torch.where(dx0, fp[i - 1], fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


class FSeries(_FrequencyGrid, _Series1D):
    """1-D frequency-indexed series with a dual period coordinate."""

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
    def dims(self):
        return ("frequency",)

    @property
    def frequency(self):
        return self._frequency

    def _coord_arrays(self):
        return (self._frequency,)

    def _replace_data(self, data):
        return FSeries(self._frequency, data, assume_sorted=True)

    def _wrap_reduced(self, axis, data):
        return data

    def _new(self, frequency, values, assume_sorted=False):
        return FSeries(frequency, values, assume_sorted=assume_sorted, device=self.device)

    def __getitem__(self, key):
        if isinstance(key, tuple):
            (key,) = key
        freq = self._frequency[key]
        values = self._values[key]
        if values.dim() < 1:
            return values
        return FSeries(freq, values)

    def fmax(self):
        return self.max().frequency[0]

    def pmax(self):
        return self.max().period[0]

    def psort_by_peak(self):
        peaks = self.find_peaks()
        return peaks.period[torch.flip(torch.argsort(peaks.values, stable=True), (0,))]

    def psort_by_prominence(self):
        peaks = self.find_peaks()
        order = torch.argsort(peaks.attrs["prominences"], stable=True)
        return peaks.period[torch.flip(order, (0,))]

    @property
    def period_at_highest_peak(self):
        return self.find_peaks().pmax()

    @property
    def period_at_highest_prominence(self):
        peaks = self.find_peaks()
        return peaks.period[_nanarg(peaks.attrs["prominences"], None, largest=True)]

    def periods_at_half_max(self, peak_order=1, use_prominence=False):
        """The period interval (lower, upper) around the ``peak_order``-th
        highest peak where the power stays above half its height."""
        peaks = self.find_peaks()
        heights = peaks.attrs["prominences"] if use_prominence else peaks.values
        jmax = torch.argsort(heights, stable=True)[-peak_order]
        idmax = int(peaks.attrs["indices"][jmax])
        half = float(self._values[idmax]) - float(heights[jmax]) / 2
        hi = (self[:idmax] - half).find_zero_crossings()[-1]
        lo = (self[idmax:] - half).find_zero_crossings()[0]
        return self[idmax:].period[lo], self[:idmax].period[hi]

    def ifft(self, nfft=None):
        coefs = torch.fft.irfft(self._values, n=nfft)
        dt = 1.0 / (coefs.shape[0] * float(self.df))
        time = torch.arange(coefs.shape[0], dtype=torch.float64, device=self.device) * dt
        return TSeries(time, coefs, assume_sorted=True)

    def polyfit(self, degree, use_period=False):
        return self._polyfit(self.period if use_period else self._frequency, degree)

    def curvefit(self, fun, p0, use_period=False, **kwargs):
        """Least-squares fit of ``fun(x, *p)`` over the frequencies (or the
        periods) by Levenberg-Marquardt."""
        return self._curvefit(self.period if use_period else self._frequency, fun, p0,
                              **kwargs)

    def downsample(self, df=None, dp=None, func=None):
        if df is None and dp is None:
            raise ValueError("At least one of df or dp must be given.")
        if df is not None and dp is not None:
            raise ValueError("Can't make a uniform grid at both frequency and period!")
        if df is not None:
            x = _host(self._frequency)
            labels = np.arange(x.min(), x.max(), df)
        else:
            x = _host(self.period)
            labels = 1.0 / np.arange(x.min(), x.max(), dp)
        out = _bin_mean(_bins(x, labels.size), _host(self._values), labels.size, func)
        return self._new(labels, out).dropna()


class TFSeries(_TimeGrid, _FrequencyGrid, Signal):
    """2-D (frequency x time) spectrogram container."""

    def __init__(self, time=None, frequency=None, values=None, device=None):
        follow = next((c for c in (time, frequency) if isinstance(c, torch.Tensor)), None)
        values = _place(values, device, follow)
        time = _place(time, device, values)
        frequency = _place(frequency, device, values)
        if time.shape[0] != values.shape[1] or frequency.shape[0] != values.shape[0]:
            raise ValueError("Input arrays have incompatible lengths.")
        if not time.device == frequency.device == values.device:
            raise ValueError(f"time, frequency and values are on {time.device}, "
                             f"{frequency.device} and {values.device}")
        self._time = time
        self._frequency = frequency
        self._values = values
        self.attrs = {}

    @property
    def dims(self):
        return ("frequency", "time")

    @property
    def time(self):
        return self._time

    @property
    def frequency(self):
        return self._frequency

    def _coord_arrays(self):
        return (self._frequency, self._time)

    def _replace_data(self, data):
        return TFSeries(self._time, self._frequency, data)

    def _wrap_reduced(self, axis, data):
        if axis == 0:
            return TSeries(self._time, data, assume_sorted=True)
        return FSeries(self._frequency, data, assume_sorted=True)

    def __len__(self):
        return self._values.shape[0]

    def __getitem__(self, key):
        if not isinstance(key, tuple):
            key = (key,)
        key = key + (slice(None),) * (2 - len(key))
        key = tuple(torch.from_numpy(k) if isinstance(k, np.ndarray) else k for k in key)
        k1, k2 = key
        freq = self._frequency[k1]
        time = self._time[k2]
        values = self._values[key]
        if values.dim() < 1:
            return values
        if values.dim() == 1:
            if time.dim() == 0:
                return FSeries(freq, values)
            return TSeries(time, values)
        return TFSeries(time, freq, values)

    @staticmethod
    def _bin_reduce(x, V, labels, func):
        """Bin the leading axis of V [N, M] by coordinate x [N] onto
        ``labels`` bins shared by all M columns (host numpy), then drop the
        bins where any column is NaN (xarray ``dropna(how="any")``: a
        per-column dropna could drop different bins per column). Returns
        (labels_kept, out [B, M])."""
        n_bins = labels.size
        which = _bins(x, n_bins)
        m = V.shape[1]
        out = np.full((n_bins, m), np.nan)
        good = ~np.isnan(V)
        rows, cols = np.nonzero(good)
        if func is None or func is np.mean:
            sums = np.zeros((n_bins, m))
            counts = np.zeros((n_bins, m))
            np.add.at(sums, (which[rows], cols), V[rows, cols])
            np.add.at(counts, (which[rows], cols), 1.0)
            np.divide(sums, counts, out=out, where=counts > 0)
        else:
            for j in range(m):
                out[:, j] = _bin_mean(which, V[:, j], n_bins, func)
        keep = ~np.isnan(out).any(axis=1)
        return labels[keep], out[keep]

    def downsample(self, dt=None, df=None, dp=None, func=None):
        if df is not None and dp is not None:
            raise ValueError("Can't make a uniform grid at both frequency and period!")
        tf = self
        dev = self.device
        if df is not None:
            x = _host(tf._frequency)
            flabels, vals = self._bin_reduce(x, _host(tf._values),
                                             np.arange(x.min(), x.max(), df), func)
            tf = TFSeries(tf._time, flabels, vals, device=dev)
        if dp is not None:
            x = _host(tf.period)
            flabels, vals = self._bin_reduce(x, _host(tf._values),
                                             1.0 / np.arange(x.min(), x.max(), dp), func)
            tf = TFSeries(tf._time, flabels, vals, device=dev)
        if dt is not None:
            x = _host(tf._time)
            tlabels, vals = self._bin_reduce(x, _host(tf._values).T,
                                             np.arange(x.min(), x.max(), dt), func)
            tf = TFSeries(tlabels, tf._frequency, vals.T, device=dev)
        return tf

    def _plot2d(self, fn_name, *args, **kwargs):
        """2-D plot; ``y`` names the vertical coordinate ('frequency', the
        default, or 'period')."""
        import matplotlib.pyplot as plt

        y_coord = kwargs.pop("y", "frequency")
        if y_coord == "period":
            y_vals = 1.0 / _host(self._frequency)
        elif y_coord == "frequency":
            y_vals = _host(self._frequency)
        else:
            raise ValueError(f"unknown y coordinate {y_coord!r}")
        return getattr(plt, fn_name)(_host(self._time), y_vals, _host(self._values),
                                     *args, **kwargs)

    def pcolormesh(self, *args, **kwargs):
        return self._plot2d("pcolormesh", *args, **kwargs)

    def imshow(self, *args, **kwargs):
        import matplotlib.pyplot as plt

        return plt.imshow(_host(self._values), *args, **kwargs)

    def contour(self, *args, **kwargs):
        return self._plot2d("contour", *args, **kwargs)

    def contourf(self, *args, **kwargs):
        return self._plot2d("contourf", *args, **kwargs)

    def surface(self, *args, **kwargs):
        """3-D surface plot of the spectrogram."""
        import matplotlib.pyplot as plt

        ax = plt.gcf().add_subplot(projection="3d")
        t_mesh, f_mesh = np.meshgrid(_host(self._time), _host(self._frequency))
        return ax.plot_surface(t_mesh, f_mesh, _host(self._values), *args, **kwargs)
