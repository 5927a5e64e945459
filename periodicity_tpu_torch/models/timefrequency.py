"""Time-frequency estimators: WPS, HHT, CompositeSpectrum, DWT denoise.

Port of ``periodicity_tpu/models/timefrequency.py``, with its names,
constructor arguments, attributes and returns:

- ``WPS``: the complex-Morlet CWT (ops/wavelet.py, cuFFT on the card),
  squared magnitude, Liu et al. (2007) scale-unbiasing and the
  cone-of-influence mask; SAV/GWPS band averages are masked reductions.
- ``HHT``: the modes of a pluggable decomposition (``EMD`` by default)
  are stacked into one [n_modes, N] tensor and pushed through the batched
  instantaneous-frequency functions of ops/hht.py (the AM/FM normalization
  through the hand-written kernel N1 on the card) and the scatter
  spectrogram.
- ``hht_batch``: one launch of the sift kernel S1 for the whole batch's
  EMD, one launch of N1 for every (member, mode) row, then the spectrogram.
- ``CompositeSpectrum``: GWPS times the interpolated ACF of the gap-filled
  signal (reference timefrequency.py:305-318).
- ``denoise``/``denoise_batch``: soft-threshold DWT with the generated
  filter banks (reference timefrequency.py:151-159 delegates to PyWavelets).

Tensors stay on the device of the input series; array-likes land on the
card unless ``device="cpu"`` is given.
"""

import numpy as np
import torch

from ..core import FSeries, TFSeries, TSeries, as_tensor
from ..core.containers import _interp, _nanmedian, _place
from ..ops import emd as _emd
from ..ops import hht as _ops_hht
from ..ops import wavelet as _wav
from ..utils.logging import log_event
from .decomposition import EMD

__all__ = [
    "WPS",
    "HHT",
    "CompositeSpectrum",
    "denoise",
    "denoise_batch",
    "reconstruct",
    "wps_batch",
    "hht_batch",
]

_IF_METHODS = ("DQ", "NHT", "TEO", "HT")
_NORM_TYPES = ("hilbert", "spline", "lmd")


class HHT:
    """Hilbert-Huang Transform (capability parity with reference
    timefrequency.py:14-148).

    A pluggable decomposition (``emd``, default :class:`EMD`) extracts
    AM-FM modes; the instantaneous frequencies/amplitudes of all modes are
    computed together, and each mode's scatter spectrogram.

    After ``__call__``: ``modes``, ``instant_fs``, ``instant_as``, ``tfs``
    (per-mode spectrograms) and ``tf`` (their sum) are set.
    """

    def __init__(
        self,
        frequencies,
        emd=None,
        method="DQ",
        norm_type="spline",
        norm_iter=10,
        smooth_width=None,
    ):
        self.frequencies = np.sort(np.asarray(frequencies, float))
        self.emd = emd if emd is not None else EMD()
        if method.upper() not in _IF_METHODS:
            raise ValueError(f"Method {method} is unknown.")
        if norm_type.lower() not in _NORM_TYPES:
            raise ValueError(f"Method {norm_type} is unknown.")
        self.method = method.upper()
        self.norm_type = norm_type.lower()
        self.norm_iter = norm_iter
        self.smooth_width = smooth_width

    def _per_mode_if(self, t, mode_stack):
        """[M, N] mode values -> ([M, N] frequencies, [M, N] amplitudes),
        every mode at once (one N1 launch on the card for the spline
        normalization)."""
        return _ops_hht.instant_frequency(t, mode_stack, method=self.method,
                                          norm_type=self.norm_type, n_iter=self.norm_iter)

    def __call__(self, signal):
        if not isinstance(signal, TSeries):
            signal = TSeries(values=signal)
        self.signal = signal
        t = signal.time
        grid = torch.from_numpy(self.frequencies).to(signal.device)
        log_event("hht", n=signal.size, nf=grid.shape[0],
                  method=self.method, norm_type=self.norm_type)

        modes = self.emd(signal)
        # a mode is live if any of its values is nonzero: one flag a mode,
        # read together
        flags = torch.stack([torch.any(m.values != 0) for m in modes]).tolist() if modes else []
        live = [m for m, f in zip(modes, flags) if f]

        if self.method in ("TEO", "HT") and live:
            # Computed from the raw signal, so identical for every live
            # mode (reference timefrequency.py:123-134 behavior; with no
            # live modes the reference produces empty output, not a
            # raw-signal row).
            freq, amp = _ops_hht.instant_frequency(t, signal.values, method=self.method)
            n_live = len(live)
            freq_stack = freq.expand(n_live, *freq.shape)
            amp_stack = amp.expand(n_live, *amp.shape)
        elif live:
            stack = torch.stack([m.values for m in live])
            freq_stack, amp_stack = self._per_mode_if(t, stack)
        else:
            freq_stack = torch.zeros((0, t.shape[0]), dtype=torch.float64, device=t.device)
            amp_stack = torch.zeros((0, t.shape[0]), dtype=torch.float64, device=t.device)

        instant_fs = [TSeries(t, f, assume_sorted=True) for f in freq_stack]
        instant_as = [TSeries(t, a, assume_sorted=True) for a in amp_stack]
        if self.smooth_width is not None and instant_fs:
            instant_fs = [f.smooth(self.smooth_width) for f in instant_fs]
            instant_as = [a.smooth(self.smooth_width) for a in instant_as]
            freq_stack = torch.stack([f.values for f in instant_fs])
            amp_stack = torch.stack([a.values for a in instant_as])

        if freq_stack.shape[0]:
            power = _ops_hht.spectrogram(grid, freq_stack, amp_stack)
            tfs = [TFSeries(time=t, frequency=grid, values=p) for p in power]
            tf = TFSeries(time=t, frequency=grid, values=torch.sum(power, dim=0))
        else:
            tfs, tf = [], None

        self.modes = modes
        self.instant_fs = instant_fs
        self.instant_as = instant_as
        self.tfs = tfs
        self.tf = tf
        log_event("hht_done", n_modes=len(modes), n_live=len(instant_fs))
        return tf


def _denoise_mad(x, family, detrend):
    """wavedec once, MAD sigma from the finest detail band (per row, the
    averaging median), soft-threshold, reconstruct."""
    coefs = _wav.wavedec(x, family)
    sigma = _nanmedian(torch.abs(coefs[-1]), dim=-1) / 0.6745
    # JAX multiplies by a numpy float64 scalar, which widens a float32 sigma
    threshold = sigma.to(torch.float64) * np.sqrt(2.0 * np.log(x.shape[-1]))
    approx = torch.zeros_like(coefs[0]) if detrend else coefs[0]
    details = [_wav.soft_threshold(c, threshold[..., None]) for c in coefs[1:]]
    return _wav.waverec([approx] + details, family)[..., : x.shape[-1]]


def _as_float(x):
    """Integer, boolean and sub-float32 input as float32, float64 as it is
    (``jnp.result_type(dtype, float32)``)."""
    return x if x.dtype == torch.float64 else x.to(torch.float32)


def denoise(data, family="db4", sigma=None, detrend=False, *, device=None):
    """Soft-threshold DWT denoising with the universal (VisuShrink)
    threshold sigma * sqrt(2 ln N), optionally zeroing the approximation
    band to detrend (capability parity with reference
    timefrequency.py:151-159).

    Deliberate divergence: the reference raises TypeError when ``sigma``
    is omitted (``None * np.sqrt(...)``); here ``sigma=None`` estimates
    the noise level with Donoho's MAD rule on the finest detail band,
    sigma = median(|d1|) / 0.6745 (the decomposition is done once)."""
    x = _as_float(as_tensor(data, device))
    if sigma is None:
        return _denoise_mad(x, family, detrend)
    threshold = float(sigma) * float(np.sqrt(2.0 * np.log(x.shape[-1])))
    return _wav.dwt_denoise(x, threshold, family=family, detrend=detrend)


def denoise_batch(batch, family="db4", sigma=None, detrend=False, *, device=None):
    """:func:`denoise` over a stack of equal-length series [batch, n] (rows =
    light curves). ``sigma`` may be a scalar, a per-row array, or None for
    per-row MAD estimates (integer input is promoted to float first, like
    the single-series path)."""
    x = _as_float(as_tensor(batch, device))
    if x.dim() != 2:
        raise ValueError("denoise_batch expects [batch, n] input")
    if sigma is None:
        return _denoise_mad(x, family, detrend)
    sigma = torch.broadcast_to(_place(sigma, None, x).to(device=x.device, dtype=x.dtype),
                               (x.shape[0],))
    thr = sigma.to(torch.float64) * np.sqrt(2.0 * np.log(x.shape[1]))
    return _wav.dwt_denoise(x, thr[:, None], family=family, detrend=detrend)


def reconstruct(coefs, periods, dt, family, *, device=None):
    """Delta-function inverse CWT: sum over scales of coefs/sqrt(scale),
    normalized by psi(0) of the real Morlet (capability parity with
    reference timefrequency.py:162-167)."""
    coefs = as_tensor(coefs, device)
    scales = torch.from_numpy(
        np.asarray(_wav.scale2frequency(family, 1) * np.asarray(periods) / dt, float)
    ).to(coefs.device)
    summed = torch.sum(coefs / torch.sqrt(scales)[:, None], dim=0)
    return summed / _wav.psi_zero("morl")


def _coi_correction():
    """e-folding half-width of the cmor2.0-1.0 cone: sqrt(2) periods."""
    return float(np.exp2(0.5))


def _in_cone(t, periods):
    """[S, N] True where a period's e-folding reach fits inside the data
    span on both sides."""
    reach = torch.minimum(t - t[0], t[-1] - t)
    return _coi_correction() * periods[:, None] < reach[None, :]


class WPS:
    """Morlet (cmor2.0-1.0) wavelet power spectrum (capability parity with
    reference timefrequency.py:170-302)."""

    FAMILY = "cmor2.0-1.0"

    def __init__(self, periods):
        self.periods = np.asarray(periods, float)
        self.frequency = 1.0 / self.periods

    def __call__(self, signal):
        if not isinstance(signal, TSeries):
            signal = TSeries(values=signal)
        dt = float(signal.median_dt)
        log_event("wps", n=signal.size, n_scales=self.periods.size)
        scales = _wav.scale2frequency(self.FAMILY, 1) * self.periods / dt

        coefs = _wav.cwt_morlet(signal.values - signal.mean(), scales, self.FAMILY, dt=dt)
        dev = coefs.device
        power = torch.square(torch.abs(coefs))
        unbiased = power / torch.from_numpy(scales).to(dev)[:, None]
        in_cone = _in_cone(signal.time, torch.from_numpy(self.periods).to(dev))
        masked = torch.where(in_cone, unbiased, float("nan"))

        self.signal = signal
        self.time = signal.time
        self.scales = scales
        self.coefs = coefs
        self._in_cone = in_cone
        self.power = TFSeries(time=self.time, frequency=self.frequency, values=power)
        self.spectrum = TFSeries(time=self.time, frequency=self.frequency, values=unbiased)
        self.masked_spectrum = TFSeries(time=self.time, frequency=self.frequency, values=masked)
        return self.spectrum

    # -- cone of influence --------------------------------------------------
    @property
    def mask_coi(self):
        """Boolean [n_periods, n_times]: True inside the cone."""
        return self._in_cone.cpu().numpy()

    def coi(self, coi_samples=100):
        """Boundary samples of the cone for plotting: the locus where a
        period's e-folding reach meets the data span, log-spaced in period
        and mirrored about the series midpoint."""
        corr = _coi_correction()
        t = self.time.cpu().numpy()
        span = t.max() - t.min()
        p = np.logspace(
            np.log10(self.periods.min()),
            np.log10(self.periods.max()),
            coi_samples,
        )
        p = p[corr * p < span / 2]
        edges = np.concatenate([t.min() + corr * p, t.max() - corr * p])
        return TSeries(edges, np.concatenate([p, p]), device=self.time.device)

    def plot_coi(self, coi_samples=100, **kwargs):
        import matplotlib.pyplot as plt

        boundary = self.coi(coi_samples)
        plt.fill_between(
            boundary.time.cpu().numpy(),
            boundary.values.cpu().numpy(),
            self.periods.max(),
            **kwargs,
        )

    # -- band averages -------------------------------------------------------
    def _rows(self, pmin, pmax):
        lo = -np.inf if pmin is None else pmin
        hi = np.inf if pmax is None else pmax
        return torch.from_numpy((self.periods >= lo) & (self.periods <= hi)).to(self.time.device)

    def _cols(self, tmin, tmax):
        t = self.time
        lo = -np.inf if tmin is None else tmin
        hi = np.inf if tmax is None else tmax
        return (t >= lo) & (t <= hi)

    def sav(self, pmin=None, pmax=None):
        """Scale-averaged variance: mean unbiased power over a period band
        (reference timefrequency.py:264-270)."""
        sel = self._rows(pmin, pmax)
        vals = self.spectrum.values
        avg = torch.sum(torch.where(sel[:, None], vals, 0.0), dim=0) / torch.sum(sel)
        return TSeries(self.time, avg, assume_sorted=True)

    def masked_sav(self, pmin=None, pmax=None):
        """SAV over in-cone values only (NaN-aware mean)."""
        sel = self._rows(pmin, pmax)
        vals = self.masked_spectrum.values
        avg = torch.nanmean(torch.where(sel[:, None], vals, float("nan")), dim=0)
        return TSeries(self.time, avg, assume_sorted=True)

    def gwps(self, tmin=None, tmax=None):
        """Global wavelet power spectrum: time-mean of the unbiased power
        (reference timefrequency.py:282-288)."""
        sel = self._cols(tmin, tmax)
        vals = self.spectrum.values
        avg = torch.sum(torch.where(sel[None, :], vals, 0.0), dim=1) / torch.sum(sel)
        return FSeries(self.frequency, avg)

    def masked_gwps(self, tmin=None, tmax=None):
        sel = self._cols(tmin, tmax)
        vals = self.masked_spectrum.values
        avg = torch.nanmean(torch.where(sel[None, :], vals, float("nan")), dim=1)
        return FSeries(self.frequency, avg)


def wps_batch(time, values, periods, family=WPS.FAMILY, *, device=None):
    """Unbiased wavelet power spectra for B light curves sharing one time
    grid, in one batched CWT (the batch axis the strictly single-series
    reference lacks).

    time [N] (uniformly sampled), values [B, N], periods [S].
    Returns (spectra [B, S, N], in_cone [S, N] bool).
    """
    values = as_tensor(values, device)
    time = _place(time, device, values).to(values.device)
    periods = np.asarray(periods, float)
    dt = float(np.median(np.diff(time.cpu().numpy())))
    scales = torch.from_numpy(_wav.scale2frequency(family, 1) * periods / dt).to(values.device)
    coefs = _wav.cwt_morlet(values - torch.mean(values, dim=-1, keepdim=True), scales, family,
                            dt=dt)
    unbiased = torch.square(torch.abs(coefs)) / scales[:, None]
    return unbiased, _in_cone(time, torch.from_numpy(periods).to(values.device))


def _normalization_rows(t, modes, n_modes):
    """(rows [B*M, N], live [B, M]): the mode slots as the rows that the
    AM/FM normalization takes. Dead mode slots are all zero (envelope 0 ->
    NaN), so they get a benign oscillation instead, whose results are
    masked to zero afterwards."""
    b, m, n = modes.shape
    live = torch.arange(m, device=modes.device)[None, :] < n_modes[:, None]
    dummy = torch.cos(2 * np.pi * (t - t[0]) / ((t[-1] - t[0]) / 8.0 + 1e-12))
    safe = torch.where(live[..., None], modes, dummy[None, None, :])
    return safe.reshape(b * m, n), live


def _hht_post(t, Y, modes, n_modes, grid, method, norm_type, norm_iter):
    """Spectrogram assembly from decomposed modes: the per-(member, mode)
    instantaneous-frequency stack (one N1 launch on the card) and the
    time-frequency scatter, summed over modes."""
    if method in ("TEO", "HT"):
        # computed from the raw signal, identical for every live mode
        # (reference timefrequency.py:123-134); the mode sum scales power
        # by the LIVE count: a member with zero IMFs has zero power,
        # matching sequential HHT's empty output
        freq, amp = _ops_hht.instant_frequency(t, Y, method=method)
        return _ops_hht.spectrogram(grid, freq, amp) * n_modes[:, None, None]

    b, m, n = modes.shape
    rows, live = _normalization_rows(t, modes, n_modes)
    freq, amp = _ops_hht.instant_frequency(t, rows, method=method, norm_type=norm_type,
                                           n_iter=norm_iter)
    freq = freq.reshape(b, m, n) * live[..., None]
    amp = amp.reshape(b, m, n) * live[..., None]
    power = _ops_hht.spectrogram(grid, freq[:, 0], amp[:, 0])
    for k in range(1, m):
        power = power + _ops_hht.spectrogram(grid, freq[:, k], amp[:, k])
    return power


def hht_batch(time, values, frequencies, max_modes=8, method="DQ",
              norm_type="spline", norm_iter=10, max_iter=2000, pad_width=2,
              theta_1=0.05, theta_2=0.50, alpha=0.05, sifter="auto",
              unroll=4, *, device=None):
    """Hilbert-Huang spectrograms for B light curves sharing one time grid
    (the estimator-level batch analog of ``HHT()(signal)``).

    The EMD of the whole batch is one launch of the sift kernel on the
    card, whichever ``sifter`` is named: the kernel retires each member
    when its decomposition is done, which is what the JAX package's
    ``"pool"`` schedules and ``"lockstep"`` does not, and per-member
    results are identical either way. ``sifter`` (``"auto"``, ``"pool"``,
    ``"lockstep"``) and ``unroll`` are validated and change nothing.

    time [N] (uniformly sampled for ``norm_type="lmd"``), values [B, N],
    frequencies [F] ->
    (power [B, F, N], modes [B, max_modes, N], residue [B, N], n_modes [B]).
    Mode slots past a member's count are zero; each member's spectrogram
    matches the sequential ``HHT(frequencies, method=...)(y_b)`` whenever
    that member decomposes into at most ``max_modes`` IMFs.
    """
    if method.upper() not in _IF_METHODS:
        raise ValueError(f"Method {method} is unknown.")
    if norm_type.lower() not in _NORM_TYPES:
        raise ValueError(f"Method {norm_type} is unknown.")
    if sifter not in ("auto", "pool", "lockstep"):
        raise ValueError(f"Sifter {sifter} is unknown.")
    _emd._schedule_args(min_bucket=8, unroll=unroll)  # emd_pool's default bucket
    t, Y = _emd._series(time, values, device)
    grid = torch.sort(torch.from_numpy(np.asarray(frequencies, float)).to(Y.device)).values
    modes, residue, n_modes = _emd.emd_batch(t, Y, max_modes=int(max_modes),
                                             max_iter=int(max_iter), pad_width=int(pad_width),
                                             theta_1=theta_1, theta_2=theta_2, alpha=alpha)
    power = _hht_post(t, Y, modes, n_modes, grid, method.upper(), norm_type.lower(),
                      int(norm_iter))
    return power, modes, residue, n_modes


class CompositeSpectrum:
    """Product of the max-normalized GWPS with the ACF of the gap-filled
    signal, interpolated onto the GWPS period grid (capability parity with
    reference timefrequency.py:305-318)."""

    def __init__(self, periods):
        self.periods = periods
        self.wps = WPS(periods)

    def __call__(self, signal):
        if not isinstance(signal, TSeries):
            signal = TSeries(values=signal)
        self.wps(signal)
        gwps = self.wps.gwps()
        gwps = gwps / gwps.amax()
        acf = signal.fill_gaps().acf()
        # jnp.interp promotes all three to one inexact dtype
        x, xp, fp = gwps.period, acf.time, acf.values
        dtype = torch.promote_types(torch.promote_types(x.dtype, xp.dtype), fp.dtype)
        dtype = dtype if dtype.is_floating_point else torch.float64
        acf_on_grid = _interp(x.to(dtype), xp.to(dtype), fp.to(dtype))
        return gwps * acf_on_grid
