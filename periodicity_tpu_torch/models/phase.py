"""Phase-folding period search: BLS, AoV, conditional entropy,
Gregory-Loredo, PDM and StringLength.

Port of ``periodicity_tpu/models/phase.py``, with the JAX names, defaults
and period grids. Each scorer folds the light curve at a chunk of trial
periods at a time (the JAX package's ``lax.map``), as [chunk, N] tensors,
and reduces each fold to one statistic per period on the input's device.

The four fold scorers (BLS, AoV, conditional entropy, Gregory-Loredo)
keep the JAX package's two binners:

- ``"scatter"`` bins by ``((t - t[0]) / period) % 1`` in the input dtype,
  with one ``index_add_`` per chunk of periods, on any device;
- ``"kernel"`` (alias ``"pallas"``) bins by the float32 formula of
  ``ops/fold.py``: the hand-written CUDA fold kernel on a CUDA tensor, its
  plain version on a CPU tensor. Samples within about
  ``(elapsed / period) * 2^-24`` cycles of a bin edge may land one bin
  over relative to ``"scatter"``;
- the estimators' ``"auto"`` picks ``"kernel"`` on CUDA and ``"scatter"``
  on the CPU.

``batch_size`` is the number of periods per chunk (at least 32 for the
fold scorers), which bounds memory as in the JAX package. PDM and
StringLength have no kernel.
"""

import math

import numpy as np
import torch

from ..core import FSeries, TSeries, as_tensor
from ..ops.fold import fold_onehot, histogram_rows
from ..utils.logging import log_event

__all__ = [
    "StringLength",
    "BLS",
    "bls_scan",
    "bls_batch",
    "PDM",
    "AoV",
    "ConditionalEntropy",
    "GregoryLoredo",
    "string_length_scan",
    "string_length_scan_fast",
    "string_length_approx_scan",
    "string_length_batch",
    "pdm_scan",
    "pdm_batch",
    "aov_scan",
    "conditional_entropy_scan",
    "gregory_loredo_scan",
]


def _tensors(t, *xs):
    """``t`` as a tensor (the card unless it is one already) and ``xs`` on
    its device."""
    t = as_tensor(t)
    return (t, *(as_tensor(x, t.device) for x in xs))


def _resolve_binner(binner, device):
    """Canonical binner name: ``"auto"`` is ``"kernel"`` on CUDA and
    ``"scatter"`` elsewhere; ``"pallas"`` is ``"kernel"``."""
    if binner == "auto":
        return "kernel" if device.type == "cuda" else "scatter"
    if binner == "pallas":
        return "kernel"
    if binner not in ("scatter", "kernel"):
        raise ValueError(f"binner must be 'scatter', 'kernel' or 'auto', got {binner!r}")
    return binner


def _chunks(p, size):
    return [(s, min(p, s + size)) for s in range(0, p, size)]


def _phase(t, periods):
    """[C, N] folded phases ``(t / period) % 1`` in the promoted dtype of
    ``t`` and ``periods``, as the JAX scatter paths compute them."""
    return torch.remainder(t[None, :] / periods[:, None], 1.0)


def _fold(t, values, periods, n_phi, binner, dtype, stride=1, offsets=None):
    """Fold histograms [C, nv, n_phi * stride] in ``dtype`` of the value
    rows [nv, N] at a chunk of periods [C]; ``t`` is already ``t - t[0]``."""
    if binner == "kernel":
        out = fold_onehot(t, values, 1.0 / periods, n_phi, stride=stride, offsets=offsets)
        return out.to(dtype)
    pb = (_phase(t, periods) * n_phi).to(torch.int32).clamp_(0, n_phi - 1)
    bins = pb.to(torch.int64) * stride
    if offsets is not None:
        bins = bins + offsets.to(torch.int64)
    out = torch.zeros((periods.shape[0], values.shape[0], n_phi * stride), dtype=dtype,
                      device=t.device)
    return histogram_rows(bins, values.to(dtype), n_phi * stride, out)


# -- StringLength --------------------------------------------------------------


def string_length_scan(t, m, periods, batch_size=128):
    """String lengths for each trial period.

    t: [N] times; m: [N] values scaled to [-0.25, 0.25]; periods: [P].
    Returns [P] string lengths.
    """
    t, m, periods = _tensors(t, m, periods)
    out = []
    for s, e in _chunks(periods.shape[0], max(1, batch_size)):
        phi, order = torch.sort(_phase(t, periods[s:e]), dim=-1, stable=True)
        m_s = m[order]
        dtype = torch.promote_types(phi.dtype, m.dtype)
        dm = (torch.roll(m_s, -1, dims=-1) - m_s).to(dtype)
        dphi = (torch.roll(phi, -1, dims=-1) - phi).to(dtype)
        out.append(torch.hypot(dm, dphi).sum(-1))
    return torch.cat(out)


def string_length_approx_scan(t, m, periods, batch_size=512):
    """Quantized packed-key string lengths: one integer sort per period.

    Phase (16 bits, high) and magnitude (16 bits, low) pack into one key,
    read as a signed 32-bit integer as in the JAX package (phases of half
    a cycle or more sort first, as phase - 1: the same cyclic order), and
    both values unpack from the sorted keys. The quantization perturbs
    each string segment by <= ~2e-5.
    """
    t, m, periods = _tensors(t, m, periods)
    # m is scaled to [-0.25, 0.25] by the estimator (reference phase.py:66)
    mq = ((m + 0.25) * (65535.0 / 0.5)).to(torch.int32).clamp_(0, 65535).to(torch.int64)
    inv_phi = 1.0 / 65536.0
    inv_m = 0.5 / 65535.0
    out = []
    for s, e in _chunks(periods.shape[0], max(1, batch_size)):
        pq = (_phase(t, periods[s:e]) * 65536.0).to(torch.int32).clamp_(0, 65535)
        key = (pq.to(torch.int64) << 16) | mq
        key = torch.where(key >= 1 << 31, key - (1 << 32), key)  # int32 wrap
        ks = torch.sort(key, dim=-1).values
        phi_s = (ks >> 16).to(m.dtype) * inv_phi
        m_s = (ks & 0xFFFF).to(m.dtype) * inv_m - 0.25
        dm = torch.roll(m_s, -1, dims=-1) - m_s
        dp = torch.roll(phi_s, -1, dims=-1) - phi_s
        out.append(torch.sqrt(dm * dm + dp * dp).sum(-1))
    return torch.cat(out)


def string_length_scan_fast(t, m, periods, refine_top=None, batch_size=512, subsample=2):
    """String lengths with exact minima at a fraction of the sort cost.

    Every trial period is scored with the packed single-key quantized sort
    over every ``subsample``-th sample; the ``refine_top`` most promising
    periods (smallest lengths; default max(64, P//100) * subsample) are
    rescored with the exact full-N kernel. The result is exact at every
    candidate minimum and ``subsample *`` the subsampled statistic
    elsewhere (see the JAX package for the analysis).
    """
    t, m, periods = _tensors(t, m, periods)
    p = periods.shape[0]
    if refine_top is None:
        refine_top = max(64, p // 100) * subsample
    refine_top = min(refine_top, p)
    approx = string_length_approx_scan(
        t[::subsample], m[::subsample], periods, batch_size=batch_size
    ) * subsample
    idx = torch.topk(-approx, refine_top).indices
    exact = string_length_scan(t, m, periods[idx], batch_size=min(batch_size, refine_top))
    approx[idx] = exact.to(approx.dtype)
    return approx


def string_length_batch(t, ms, periods, batch_size=128):
    """String lengths for B scaled light curves sharing one time grid:
    ms [B, N] -> lengths [B, P]."""
    t, ms, periods = _tensors(t, ms, periods)
    return torch.stack([string_length_scan(t, m, periods, batch_size=batch_size) for m in ms])


# -- PDM -----------------------------------------------------------------------


def pdm_scan(t, x, periods, nb=5, nc=2, batch_size=128):
    """PDM theta statistic for each trial period (reference phase.py:128-149).

    For each of the m0 = nb*nc overlapping covers, bin membership is a
    phase-interval predicate (including wraparound), and the pooled
    variance uses masked sum/sumsq reductions. Bins with fewer than 2
    samples are dropped from the pooled estimate, matching the reference.
    """
    t, x, periods = _tensors(t, x, periods)
    m0 = nb * nc
    n = x.shape[0]
    sigma = torch.nanmean((x - torch.nanmean(x)) ** 2) * n / (n - 1)  # ddof=1
    ks = torch.arange(m0, dtype=t.dtype, device=t.device)[:, None]
    lo = ks / m0
    hi = (ks + nc) / m0
    wrap = (ks - (m0 - nc)) / m0
    out = []
    for s, e in _chunks(periods.shape[0], max(1, batch_size)):
        phi = _phase(t, periods[s:e])[:, None, :]  # [C, 1, N]
        mask = ((phi >= lo) & (phi < hi)) | (phi < wrap)  # [C, m0, N]
        nj = mask.sum(-1)
        sj_sum = torch.where(mask, x, 0.0).sum(-1)
        sj_sq = torch.where(mask, x**2, 0.0).sum(-1)
        good = nj > 1
        njf = torch.where(good, nj, 2)
        ss_within = torch.where(good, sj_sq - sj_sum**2 / njf, 0.0)
        num = ss_within.sum(-1)
        den = torch.where(good, nj, 0).sum(-1) - good.sum(-1)
        out.append((num / den) / sigma)
    return torch.cat(out)


def pdm_batch(t, xs, periods, nb=5, nc=2, batch_size=128):
    """PDM theta for B light curves sharing one time grid: xs [B, N] ->
    theta [B, P]."""
    t, xs, periods = _tensors(t, xs, periods)
    return torch.stack([pdm_scan(t, x, periods, nb=nb, nc=nc, batch_size=batch_size)
                        for x in xs])


# -- AoV, conditional entropy, Gregory-Loredo ----------------------------------


def aov_scan(t, x, periods, nb=9, batch_size=128, binner="scatter"):
    """Analysis-of-Variance periodogram (Schwarzenberg-Czerny 1989).

    AoV statistic = between-bin variance / within-bin variance (one-way
    ANOVA F over nb phase bins) of the [counts, sums, sum-squares] fold.
    Large values indicate a good period. Both binners fold on
    ``t - t[0]``.
    """
    t, x, periods = _tensors(t, x, periods)
    binner = _resolve_binner(binner, t.device)
    t = t - t[0]
    n = x.shape[0]
    xbar = torch.mean(x)
    values = torch.stack([torch.ones_like(x), x, x * x])
    out = []
    for s, e in _chunks(periods.shape[0], max(32, batch_size)):
        h = _fold(t, values, periods[s:e], nb, binner, x.dtype)
        nj, sj, sq = h[:, 0], h[:, 1], h[:, 2]
        good = nj > 0
        mj = sj / torch.where(good, nj, 1.0)
        s1 = torch.where(good, nj * (mj - xbar) ** 2, 0.0).sum(-1)
        s2 = torch.where(good, sq - nj * mj**2, 0.0).sum(-1)
        r = good.sum(-1)
        out.append((s1 / (r - 1)) / (s2 / (n - r)))
    return torch.cat(out)


def conditional_entropy_scan(t, x, periods, n_phi=10, n_mag=5, batch_size=128,
                             binner="scatter"):
    """Conditional entropy H(mag | phase) per trial period (Graham et al.
    2013). The joint (phase, magnitude) histogram is one fold with the
    per-sample magnitude bin as the offset (flat bin = phase_bin * n_mag +
    mag_bin). Minima of H mark candidate periods. Both binners fold on
    ``t - t[0]``.
    """
    t, x, periods = _tensors(t, x, periods)
    binner = _resolve_binner(binner, t.device)
    t = t - t[0]
    n = x.shape[0]
    xmin = torch.min(x)
    xrange = torch.max(x) - xmin + 1e-12
    xb = ((x - xmin) / xrange * n_mag).to(torch.int32).clamp_(0, n_mag - 1)
    ones = torch.ones((1, n), dtype=x.dtype, device=x.device)
    out = []
    for s, e in _chunks(periods.shape[0], max(32, batch_size)):
        counts = _fold(t, ones, periods[s:e], n_phi, binner, x.dtype, stride=n_mag,
                       offsets=xb)[:, 0]
        p = counts.reshape(-1, n_phi, n_mag) / n
        p_phi = p.sum(-1, keepdim=True)
        occupied = p > 0
        ratio = torch.where(occupied, p_phi / torch.where(occupied, p, 1.0), 1.0)
        out.append(torch.where(occupied, p * torch.log(ratio), 0.0).sum((-2, -1)))
    return torch.cat(out)


def gregory_loredo_scan(t, periods, n_bins=12, batch_size=128, binner="scatter"):
    """Gregory-Loredo log odds of a stepwise periodic model per trial period
    (Gregory & Loredo 1992, for event/arrival-time data):

        ln O = N ln m + lgamma(m) - lgamma(N + m) + sum_j lgamma(n_j + 1)

    up to a period-independent constant, for events folded into m bins
    with counts n_j. Maxima mark candidate periods. Both binners fold on
    ``t - t[0]``.
    """
    t, periods = _tensors(t, periods)
    binner = _resolve_binner(binner, t.device)
    t = t - t[0]
    n = t.shape[0]
    const = n * math.log(float(n_bins)) + math.lgamma(float(n_bins)) - math.lgamma(
        float(n + n_bins))
    ones = torch.ones((1, n), dtype=t.dtype, device=t.device)
    out = []
    for s, e in _chunks(periods.shape[0], max(32, batch_size)):
        counts = _fold(t, ones, periods[s:e], n_bins, binner, t.dtype)[:, 0]
        out.append(const + torch.lgamma(counts + 1.0).sum(-1))
    return torch.cat(out)


# -- BLS -----------------------------------------------------------------------


def _window_stats(r_bin, s_bin, widths, nbins):
    """Best box per fold: r_bin, s_bin [..., nbins] -> (power, depth,
    width_idx, bin_start), each [...]. Window sums of static width wd are
    circular prefix-sum differences cs[i + wd] - cs[i] on the doubled bin
    array."""
    eps = torch.tensor(1e-12, dtype=r_bin.dtype, device=r_bin.device)
    zero = r_bin.new_zeros(r_bin.shape[:-1] + (1,))
    cr = torch.cat([zero, r_bin, r_bin], dim=-1).cumsum(-1)
    cs = torch.cat([zero, s_bin, s_bin], dim=-1).cumsum(-1)
    rs = torch.stack([cr[..., wd:wd + nbins] - cr[..., :nbins] for wd in widths], dim=-2)
    ss = torch.stack([cs[..., wd:wd + nbins] - cs[..., :nbins] for wd in widths], dim=-2)
    valid = (rs > eps) & (rs < 1.0 - eps)
    sr2 = torch.where(valid, ss**2 / (rs * (1.0 - rs) + eps), -math.inf).flatten(-2)
    k = torch.argmax(sr2, dim=-1, keepdim=True)
    power, r_k, s_k = (x.gather(-1, k)[..., 0] for x in (sr2, rs.flatten(-2), ss.flatten(-2)))
    depth = -s_k / (r_k * (1.0 - r_k) + eps)
    k = k[..., 0]
    return power, depth, k // nbins, k % nbins


def bls_batch(t, ys, ws, periods, widths, nbins=256, batch_size=64, binner="scatter"):
    """BLS power for B light curves sharing one time grid: ys/ws [B, N] ->
    (power, depth, width_idx, bin_start) each [B, P]. ws rows are
    per-series normalized weights (each summing to 1). The B series share
    ``t``, so one fold per chunk takes all 2B value rows."""
    t, ys, ws, periods = _tensors(t, ys, ws, periods)
    binner = _resolve_binner(binner, t.device)
    t = t - t[0]  # shared phase origin for both binners
    b = ys.shape[0]
    dyc = torch.promote_types(ys.dtype, ws.dtype)
    ys, ws = ys.to(dyc), ws.to(dyc)
    yc = ys - torch.sum(ws * ys, dim=-1, keepdim=True)  # weighted mean out once
    values = torch.cat([ws, ws * yc])  # [2B, N]
    outs = []
    for s, e in _chunks(periods.shape[0], max(32, batch_size)):
        h = _fold(t, values, periods[s:e], nbins, binner, t.dtype)
        outs.append(_window_stats(h[:, :b], h[:, b:], widths, nbins))
    return tuple(torch.cat(parts).T for parts in zip(*outs))


def bls_scan(t, y, w, periods, widths, nbins=256, batch_size=64, binner="scatter"):
    """Box Least Squares power for each trial period (Kovacs, Zucker &
    Mazeh 2002), weighted formulation.

    t: [N] times; y: [N] values; w: [N] weights summing to 1 (precompute
    w = (1/err^2) / sum(1/err^2)); periods: [P]; widths: box widths in
    BINS (duration fractions q map to max(1, round(q * nbins))).

    Per chunk of periods the fold gives the weight and weighted-value
    histograms; every (box start x box width) window sum is a prefix-sum
    difference, and the best box per period is reduced on the device.
    Both binners fold on ``t - t[0]``, so ``bin_start`` references phase
    origin t[0].

    Returns (power[P], depth[P], width_idx[P], bin_start[P]) where
    power = max over boxes of s^2 / (r (1 - r)), the squared KZM02 signal
    residue of the weighted, mean-subtracted fold.
    """
    t, y, w, periods = _tensors(t, y, w, periods)
    out = bls_batch(t, y[None], w[None], periods, widths, nbins=nbins,
                    batch_size=batch_size, binner=binner)
    return tuple(o[0] for o in out)


# -- estimators ----------------------------------------------------------------


def _as_series(signal):
    return signal if isinstance(signal, TSeries) else TSeries(values=signal)


class StringLength:
    """String Length method (Dworetsky 1983; reference phase.py:18-72).

    ``method="fast"`` (default) scores all periods with the quantized
    packed-key sort and rescores the most promising candidates exactly;
    ``"exact"`` evaluates the Dworetsky sum everywhere.
    """

    def __init__(self, dphi=0.1, n_periods=1000, batch_size=128, cores=None,
                 method="fast", refine_top=None):
        del cores  # reference-API compatibility; scans are on the device
        self.dphi = dphi
        self.n_periods = n_periods
        self.batch_size = batch_size
        self.method = method
        self.refine_top = refine_top

    def __call__(self, signal):
        signal = _as_series(signal)
        self.signal = signal
        # scale values to [-0.25, 0.25] (reference phase.py:66)
        v = signal.values
        vmax = v[signal.argmax()]
        vmin = v[torch.argmin(torch.nan_to_num(v, nan=math.inf))]
        m = (v - vmax) / (2 * (vmax - vmin)) + 0.25
        df = self.dphi / float(signal.baseline)
        periods = 1.0 / np.linspace(self.n_periods * df, df, self.n_periods)
        log_event("string_length", n=signal.size, n_periods=self.n_periods,
                  batch_size=self.batch_size, method=self.method)
        if self.method == "fast":
            ell = string_length_scan_fast(signal.time, m, periods, refine_top=self.refine_top,
                                          batch_size=self.batch_size)
        else:
            ell = string_length_scan(signal.time, m, periods, batch_size=self.batch_size)
        self.periodogram = FSeries(1.0 / periods, ell)
        return self.periodogram


class PDM:
    """Phase Dispersion Minimization (Stellingwerf 1978;
    reference phase.py:75-195), with optional subharmonic averaging
    (Stellingwerf 2011)."""

    def __init__(self, nb=5, nc=2, p_min=None, p_max=None, n_periods=1000, oversample=1,
                 do_subharmonic=False, batch_size=128, cores=None):
        del cores  # reference-API compatibility; scans are on the device
        self.nb = nb
        self.nc = nc
        self.p_min = p_min
        self.p_max = p_max
        self.n_periods = n_periods
        self.oversample = oversample
        self.do_subharmonic = do_subharmonic
        self.batch_size = batch_size

    def __call__(self, signal):
        signal = _as_series(signal)
        self.signal = signal
        theta_crit = 1.0 - 11.0 / signal.size**0.8
        t0 = float(signal.baseline)
        p_min = 2 * float(signal.median_dt) if self.p_min is None else self.p_min
        p_max = self.oversample * t0 if self.p_max is None else self.p_max
        if self.n_periods is None:
            n_periods = int((1 / p_min - 1 / p_max) * self.oversample * t0 + 1)
        else:
            n_periods = self.n_periods
        self.periods = np.linspace(p_min, p_max, n_periods)
        dp = self.periods[1] - self.periods[0]
        log_event("pdm", n=signal.size, n_periods=n_periods, nb=self.nb,
                  nc=self.nc, do_subharmonic=self.do_subharmonic)
        thetas = pdm_scan(signal.time, signal.values, self.periods, nb=self.nb, nc=self.nc,
                          batch_size=self.batch_size)
        if self.do_subharmonic:
            # average theta(P) with theta(2P) where significant
            # (reference phase.py:188-193)
            periods = torch.from_numpy(self.periods).to(thetas.device)
            can_average = torch.nonzero((thetas < theta_crit) & (periods <= p_max / 2))[:, 0]
            sub_indices = torch.round(2 * can_average.to(torch.float64) + p_min / dp).to(torch.int64)
            thetas[can_average] = (thetas[can_average] + thetas[sub_indices]) / 2
        self.periodogram = FSeries(1.0 / self.periods, thetas)
        return self.periodogram


class _FoldEstimator:
    """Shared surface of the fold scorers: the period grid on
    [p_min, p_max] and the binner, resolved against the series' device."""

    def _prepare(self, signal):
        self.signal = signal
        p_min = 2 * float(signal.median_dt) if self.p_min is None else self.p_min
        p_max = float(signal.baseline) if self.p_max is None else self.p_max
        self.periods = np.linspace(p_min, p_max, self.n_periods)
        self._binner_resolved = _resolve_binner(self.binner, signal.time.device)
        return torch.from_numpy(self.periods).to(signal.time.device)


class AoV(_FoldEstimator):
    """Analysis-of-Variance period search (Schwarzenberg-Czerny 1989).
    Returns an FSeries of the AoV F-statistic (peaks = candidate periods).
    """

    def __init__(self, nb=9, p_min=None, p_max=None, n_periods=1000, batch_size=128,
                 binner="auto"):
        self.nb = nb
        self.p_min = p_min
        self.p_max = p_max
        self.n_periods = n_periods
        self.batch_size = batch_size
        self.binner = binner

    def __call__(self, signal):
        signal = _as_series(signal)
        periods = self._prepare(signal)
        f = aov_scan(signal.time, signal.values, periods, nb=self.nb,
                     batch_size=self.batch_size, binner=self._binner_resolved)
        self.periodogram = FSeries(1.0 / self.periods, f)
        return self.periodogram


class ConditionalEntropy(_FoldEstimator):
    """Conditional-entropy period search (Graham et al. 2013). Minima of
    the returned FSeries mark candidate periods."""

    def __init__(self, n_phi=10, n_mag=5, p_min=None, p_max=None, n_periods=1000,
                 batch_size=128, binner="auto"):
        self.n_phi = n_phi
        self.n_mag = n_mag
        self.p_min = p_min
        self.p_max = p_max
        self.n_periods = n_periods
        self.batch_size = batch_size
        self.binner = binner

    def __call__(self, signal):
        signal = _as_series(signal)
        periods = self._prepare(signal)
        h = conditional_entropy_scan(signal.time, signal.values, periods, n_phi=self.n_phi,
                                     n_mag=self.n_mag, batch_size=self.batch_size,
                                     binner=self._binner_resolved)
        self.periodogram = FSeries(1.0 / self.periods, h)
        return self.periodogram


class GregoryLoredo(_FoldEstimator):
    """Gregory-Loredo Bayesian period search for event-time data
    (Gregory & Loredo 1992).

    Call on a TSeries (its time stamps are the events; values ignored) or
    a raw array of event times. Returns an FSeries of log odds; maxima
    mark periods.
    """

    def __init__(self, n_bins=12, p_min=None, p_max=None, n_periods=1000, batch_size=128,
                 binner="auto"):
        self.binner = binner
        self.n_bins = n_bins
        self.p_min = p_min
        self.p_max = p_max
        self.n_periods = n_periods
        self.batch_size = batch_size

    def __call__(self, signal):
        if isinstance(signal, TSeries):
            events = signal.time
        else:
            events = torch.sort(as_tensor(signal)).values
            signal = TSeries(events, torch.ones(events.shape[0], dtype=torch.float64,
                                                device=events.device))
        periods = self._prepare(signal)
        lo = gregory_loredo_scan(events, periods, n_bins=self.n_bins,
                                 batch_size=self.batch_size, binner=self._binner_resolved)
        self.periodogram = FSeries(1.0 / self.periods, lo)
        return self.periodogram


class BLS(_FoldEstimator):
    """Box Least Squares transit search (the ecosystem analog is astropy's
    ``timeseries.BoxLeastSquares``).

    ``durations`` are trial transit durations as PHASE fractions q of each
    trial period; ``nbins`` phase bins bound the epoch resolution. After
    calling: ``periodogram`` (FSeries of SR^2 power vs frequency, with
    per-period ``depth``/``duration``/``transit_time`` tensors in
    ``attrs``, in the FSeries' ascending-frequency order) and the scalars
    ``best_period``/``best_depth``/``best_duration``/
    ``best_transit_time``/``best_snr``.
    """

    def __init__(self, durations=(0.01, 0.02, 0.05, 0.1), nbins=256, p_min=None, p_max=None,
                 n_periods=1000, batch_size=64, binner="auto"):
        self.durations = tuple(float(q) for q in durations)
        if not all(0.0 < q < 0.5 for q in self.durations):
            raise ValueError("durations must be phase fractions in (0, 0.5)")
        self.nbins = nbins
        self.p_min = p_min
        self.p_max = p_max
        self.n_periods = n_periods
        self.batch_size = batch_size
        self.binner = binner

    def __call__(self, signal, err=None):
        signal = _as_series(signal)
        dev = signal.values.device
        n = signal.size
        if err is None:
            w = torch.full((n,), 1.0 / n, dtype=torch.float64, device=dev)
            w_total = float(n / torch.var(signal.values, correction=0))
        else:
            inv = 1.0 / as_tensor(err, dev) ** 2
            w_total = float(inv.sum())
            w = inv / w_total
        periods = self._prepare(signal)
        widths = tuple(max(1, int(round(q * self.nbins))) for q in self.durations)
        log_event("bls", n=n, n_periods=self.n_periods, nbins=self.nbins,
                  n_durations=len(widths), binner=self._binner_resolved)
        power, depth, di, bi = bls_scan(
            signal.time, signal.values, w, periods, widths=widths, nbins=self.nbins,
            batch_size=self.batch_size, binner=self._binner_resolved,
        )
        wd = torch.tensor(widths, dtype=torch.float64, device=dev)[di]
        # realized box width round(q * nbins) bins; the fold references
        # phase origin t[0], so mid-transit on the absolute time axis is
        # t[0] + phase_mid * P, reported modulo P to land in [0, P)
        q_best = wd / self.nbins
        phase_mid = torch.remainder((bi + wd / 2.0) / self.nbins, 1.0)
        t_first = float(signal.time[0])
        t0 = torch.remainder(t_first + phase_mid * periods, periods)
        duration = q_best * periods
        # the FSeries sorts by ascending frequency, reversing the
        # ascending-period order: the attrs ride the same permutation
        order = torch.argsort(1.0 / periods, stable=True)
        self.periodogram = FSeries(1.0 / self.periods, power)
        self.periodogram.attrs.update(depth=depth[order], duration=duration[order],
                                      transit_time=t0[order])
        k = int(torch.argmax(power))
        self.best_period = float(self.periods[k])
        self.best_depth = float(depth[k])
        self.best_duration = float(duration[k])
        self.best_transit_time = float(t0[k])
        self.best_snr = math.sqrt(max(float(power[k]), 0.0) * w_total)
        return self.periodogram
