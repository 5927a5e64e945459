"""Spectral period search: the generalized Lomb-Scargle periodogram.

Port of the GLS path of ``periodicity_tpu/models/spectral.py``. The
estimator surface is kept — a configured ``GLS(...)`` called on a
``TSeries`` — and ``gls_power`` is a plain function of tensors:

- the Press-Rybicki fast path runs the extirpolation + IFFT pipelines of
  ops/trig_sum, spreading with the hand-written CUDA kernel on the card;
- ``method="direct"`` evaluates the exact trig sums as matrix products.

Every tensor stays on the device of the input series. Bootstrap, FAP/FAL,
refinement, multiterm, multiband and BGLST wait for ROADMAP A2.
"""

import math

import numpy as np
import torch

from ..core import FSeries, TSeries, as_tensor
from ..ops.trig_sum import grid_size, trig_sum, trig_sum_pair
from ..utils.dtypes import result_dtype
from ..utils.logging import log_event

__all__ = ["GLS", "gls_power", "default_frequency_grid"]


def _nfft_2f(dtype, nf):
    """Grid size for the 2f trig sum: half in float32 (extirpolation error
    there is subdominant to f32 rounding), full in float64."""
    full = grid_size(nf, 5)
    return full // 2 if dtype == torch.float32 else full


def _pair_q(df, fmin, nf=None):
    """2*fmin/df when integral and small (enables the conjugate-symmetry
    trig-sum pairing; the default grid's fmin = df/2 gives q = 1), else
    None. Large q degrades accuracy like ((nf + q)/nfft)^taps, so the
    pairing is enabled only while q is at most a fifth of the band."""
    ratio = 2.0 * float(fmin) / float(df)
    q = int(round(ratio))
    if abs(ratio - q) >= 1e-9 or q < 1:
        return None
    if nf is not None and q > max(1, nf // 5):
        return None
    return q


def default_frequency_grid(signal, fmin=None, fmax=None, n=5):
    """Reference grid spec (spectral.py:88-97): df = 1/(n*baseline),
    fmin = df/2, fmax = pseudo-Nyquist 0.5/median_dt. ``freq`` is a numpy
    float64 array built from Python floats, as in the JAX package."""
    df = 1.0 / float(signal.baseline) / n
    if fmin is None:
        fmin = 0.5 * df
    if fmax is None:
        fmax = 0.5 / float(signal.median_dt)
    freq = np.arange(fmin, fmax + df, df)
    return freq, df, fmin


def _dot(a, b):
    dtype = torch.promote_types(a.dtype, b.dtype)
    return torch.dot(a.to(dtype), b.to(dtype))


def gls_power(t, y, err, df, fmin, nf, fit_mean=True, psd=False, method="fast",
              pair_q=None, gridder="scatter", taps=4, nfft=None):
    """Generalized Lomb-Scargle power on a uniform frequency grid.

    (t [N], y [N], err [N]) tensors on one device -> power [nf]. The
    floating-mean tan(2 omega tau) formulation (Zechmeister & Kurster 2009,
    Press & Rybicki 1989). ``df`` and ``fmin`` are Python scalars.

    ``pair_q``: integer 2*fmin/df when that ratio is integral — the (wy, w)
    sums at (df, fmin) then share one pipeline (ops/trig_sum.trig_sum_pair);
    None keeps separate pipelines.

    ``gridder``: "scatter" (plain ``index_add_``, any grid) or "kernel"
    (alias "pallas"; the hand-written CUDA spreading kernel for float32
    pipelines; CUDA tensors only; needs time-sorted samples and
    2*df*baseline < 1).

    ``taps``: Lagrange extirpolation order. ``nfft``: override of the grid
    size of the (df, fmin) pipelines; the 2f pipeline uses
    min(nfft, its own default).
    """
    w = err ** -2.0
    w = w / torch.sum(w)
    if fit_mean:
        mean = _dot(w, y)
        y = y.to(mean.dtype) - mean

    if method == "fast":
        if fit_mean and pair_q is not None:
            Sh, Ch, S, C = trig_sum_pair(t, w * y, w, df, nf, fmin, q=pair_q,
                                         gridder=gridder, taps=taps, nfft=nfft)
        else:
            Sh, Ch = trig_sum(t, w * y, df, nf, fmin, gridder=gridder,
                              taps=taps, nfft=nfft)
            if fit_mean:
                S, C = trig_sum(t, w, df, nf, fmin, gridder=gridder,
                                taps=taps, nfft=nfft)
        # float32 runs the 2f sum on a half-size grid; the dtype is the one
        # trig_sum computes in, err's (the weights') included
        nfft2 = _nfft_2f(result_dtype(t, y, err), nf)
        if nfft is not None:
            nfft2 = min(nfft, nfft2)
        S2, C2 = trig_sum(t, w, 2 * df, nf, 2 * fmin, nfft=nfft2,
                          gridder=gridder, taps=taps)
    elif method == "direct":
        freqs = fmin + df * torch.arange(nf, dtype=t.dtype, device=t.device)

        def ts(wi, dfi, fmini):
            # exact direct evaluation; frequency grid scaled to (dfi, fmini)
            f = (fmini - fmin) + (dfi / df) * (freqs - fmin) + fmin
            ph = (2 * math.pi) * f[:, None] * t[None, :]
            dtype = torch.promote_types(ph.dtype, wi.dtype)
            return torch.sin(ph).to(dtype) @ wi.to(dtype), torch.cos(ph).to(dtype) @ wi.to(dtype)

        Sh, Ch = ts(w * y, df, fmin)
        S2, C2 = ts(w, 2 * df, 2 * fmin)
        if fit_mean:
            S, C = ts(w, df, fmin)
    else:
        raise ValueError(f"method must be 'fast' or 'direct', got {method!r}")
    if not fit_mean:
        S = C = None
    return _assemble_gls_power(
        Sh, Ch, S2, C2, S, C, _dot(w, y ** 2), torch.sum(err ** -2.0),
        fit_mean, psd,
    )


def _assemble_gls_power(Sh, Ch, S2, C2, S, C, YY, inv_var_sum, fit_mean, psd):
    """Elementwise tan(2 omega tau) power assembly (reference
    spectral.py:113-132)."""
    if fit_mean:
        tan_2omega_tau = (S2 - 2 * S * C) / (C2 - (C * C - S * S))
    else:
        tan_2omega_tau = S2 / C2
    C2w = 1.0 / torch.sqrt(1 + tan_2omega_tau * tan_2omega_tau)
    S2w = tan_2omega_tau * C2w
    Cw = math.sqrt(0.5) * torch.sqrt(1 + C2w)
    Sw = math.sqrt(0.5) * torch.sign(S2w) * torch.sqrt(1 - C2w)
    YC = Ch * Cw + Sh * Sw
    YS = Sh * Cw - Ch * Sw
    CC = 0.5 * (1 + C2 * C2w + S2 * S2w)
    SS = 0.5 * (1 - C2 * C2w - S2 * S2w)
    if fit_mean:
        CC = CC - (C * Cw + S * Sw) ** 2
        SS = SS - (S * Cw - C * Sw) ** 2
    power = YC * YC / CC + YS * YS / SS
    if psd:
        return power * 0.5 * inv_var_sum
    return power / YY


class GLS:
    """Generalized Lomb-Scargle periodogram (reference spectral.py:43-204).

    References: Press & Rybicki (1989); Zechmeister & Kurster (2009).
    """

    def __init__(self, fmin=None, fmax=None, n=5, psd=False, method="fast",
                 gridder="auto", nterms=1):
        if int(nterms) != 1:
            raise NotImplementedError("nterms > 1 is not ported yet (ROADMAP A2)")
        self.fmin = fmin
        self.fmax = fmax
        self.n = n
        self.psd = psd
        self.method = method
        self.gridder = gridder
        self.nterms = int(nterms)

    def __call__(self, signal, err=None, fit_mean=True):
        if not isinstance(signal, TSeries):
            signal = TSeries(values=signal)
        freq, df, fmin = default_frequency_grid(signal, self.fmin, self.fmax, self.n)
        self.frequency = freq
        nf = freq.size
        if err is None:
            err = torch.ones_like(signal.values)
        self.err = as_tensor(err, signal.values.device)
        gridder = self.gridder
        if gridder == "auto":
            # the spreading kernel needs sorted samples (TSeries sorts) and
            # non-wrapping positions on every pipeline; the 2f sum runs at
            # 2*df, so the binding condition is 2*df*baseline < 1 (every
            # default grid has df*baseline = 1/n)
            no_wrap = 2.0 * df * float(signal.baseline) < 1.0
            on_cuda = signal.values.device.type == "cuda"
            gridder = "kernel" if (no_wrap and on_cuda) else "scatter"
        log_event(
            "gls", n=signal.size, nf=nf, nfft=grid_size(nf, self.n),
            fit_mean=fit_mean, psd=self.psd, method=self.method,
            gridder=gridder, nterms=self.nterms,
        )
        power = gls_power(
            signal.time, signal.values, self.err, df, fmin, nf,
            fit_mean=fit_mean, psd=self.psd, method=self.method,
            pair_q=_pair_q(df, fmin, nf), gridder=gridder,
        )
        self._gridder_resolved = gridder
        self.fit_mean = fit_mean
        self.signal = signal
        self.periodogram = FSeries(freq, power, assume_sorted=True)
        return self.periodogram

    def copy(self):
        return GLS(self.fmin, self.fmax, self.n, self.psd, self.method,
                   gridder=self.gridder, nterms=self.nterms)
