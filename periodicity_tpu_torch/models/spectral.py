"""Spectral period search: GLS, its batched, multi-term and multiband
forms, and BGLST.

Port of ``periodicity_tpu/models/spectral.py``. The estimator surface is
kept — a configured ``GLS(...)``, ``MultibandGLS(...)`` or ``BGLST(...)``
called on a ``TSeries`` — and the scans are plain functions of tensors:

- the Press-Rybicki fast path runs the extirpolation + IFFT pipelines of
  ops/trig_sum, spreading with the hand-written CUDA kernel on the card
  (``gridder="kernel"``) or with ``index_add_``;
- ``gls_power_batch`` runs B light curves on one time grid, either as one
  row spreading per chunk of rows or as a loop of ``gls_power``;
- the multi-term, multiband and BGLST scans assemble small normal
  equations per frequency from trig sums at harmonics of the trial
  frequency and solve them with an unrolled Cholesky recurrence;
- ``method="direct"`` evaluates the exact sums or designs as matrix
  products, in chunks of frequencies.

Every tensor stays on the device of the input series. What the JAX
package computes in numpy on the host (peak picking in ``refine``, the
bootstrap quantiles, the Baluev bound) is computed on the host here too.
Bootstrap resample indices come from a ``torch.Generator`` seeded by
``random_seed``, so replicates are not the JAX package's draws.
"""

import math

import numpy as np
import torch

from ..core import FSeries, TSeries, as_tensor
from ..core.containers import nanmax
from ..ops.trig_sum import grid_size, trig_sum, trig_sum_batch, trig_sum_batch_pair, trig_sum_pair
from ..utils.dtypes import full_float32, result_dtype
from ..utils.logging import log_event

__all__ = [
    "GLS",
    "BGLST",
    "MultibandGLS",
    "gls_power",
    "gls_power_batch",
    "gls_power_multiterm",
    "gls_power_multiband",
    "bglst_log_ml",
    "bglst_log_ml_fast",
    "default_frequency_grid",
    "fap_baluev",
    "fal_baluev",
]


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
            with full_float32():
                return (torch.sin(ph).to(dtype) @ wi.to(dtype),
                        torch.cos(ph).to(dtype) @ wi.to(dtype))

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




def _host(x):
    """``x`` as a numpy array on the host (tensors from either device)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _gls_power_rows(t, ys, errs, df, fmin, nf, fit_mean, psd, pair_q=None, taps=4):
    """GLS power for B light curves sharing one time grid: batched row-
    spreading trig sums + broadcast assembly. With ``pair_q`` (half-bin
    grids) the (wy, w) pair at (df, fmin) shares one pipeline."""
    w = errs ** -2.0
    w = w / torch.sum(w, dim=1, keepdim=True)
    if fit_mean:
        ys = ys - torch.sum(w * ys, dim=1, keepdim=True)
    S = C = None
    if fit_mean and pair_q is not None:
        Sh, Ch, S, C = trig_sum_batch_pair(t, w * ys, w, df, nf, fmin, q=pair_q, taps=taps)
    else:
        Sh, Ch = trig_sum_batch(t, w * ys, df, nf, fmin, taps=taps)
        if fit_mean:
            S, C = trig_sum_batch(t, w, df, nf, fmin, taps=taps)
    # dtype-adaptive 2f grid, matching the single-series fast path
    S2, C2 = trig_sum_batch(t, w, 2 * df, nf, 2 * fmin,
                            nfft=_nfft_2f(result_dtype(t, ys, errs), nf), taps=taps)
    YY = torch.sum(w * ys ** 2, dim=1, keepdim=True)
    inv_var_sum = torch.sum(errs ** -2.0, dim=1, keepdim=True)
    return _assemble_gls_power(Sh, Ch, S2, C2, S, C, YY, inv_var_sum, fit_mean, psd)


def gls_power_batch(t, ys, errs, df, fmin, nf, fit_mean=True, psd=False, method="fast",
                    batch_size=None, pair_q=None, gridder="scatter", taps=4):
    """Batched GLS over many light curves sharing one time grid.

    t [N], ys and errs [B, N] tensors on one device. Returns power
    [B, nf]. Two fast-path layouts:

    - ``gridder="scatter"`` (default): chunks of ``batch_size`` rows
      through ``trig_sum_batch``, one ``index_add_`` of (tap x re/im x
      row)-packed rows per pipeline; any sample order, any grid;
    - ``gridder="kernel"`` (alias ``"pallas"``): a loop of
      :func:`gls_power` over the rows, each spreading with the
      hand-written CUDA kernel (CUDA tensors only; time-sorted samples,
      2*df*baseline < 1). ``method="direct"`` loops the same way.

    The default chunk is the JAX package's: 8 rows, fewer where the
    [nfft + taps, 8 * chunk] float32 grid of a chunk would exceed 1.2 GB.
    The result does not depend on the chunk.
    """
    if gridder not in ("scatter", "kernel", "pallas"):
        raise ValueError(f"gridder must be 'scatter' or 'kernel', got {gridder!r}")
    if method != "fast" or gridder != "scatter":
        return torch.stack([
            gls_power(t, y, e, df, fmin, nf, fit_mean=fit_mean, psd=psd, method=method,
                      pair_q=pair_q, gridder=gridder, taps=taps)
            for y, e in zip(ys, errs)
        ])
    if batch_size is None:
        batch_size = min(8, max(1, int(1.2e9 // (grid_size(nf, 5) * 32))))
    chunk = min(batch_size, ys.shape[0])
    return torch.cat([
        _gls_power_rows(t, ys[i:i + chunk], errs[i:i + chunk], df, fmin, nf, fit_mean, psd,
                        pair_q=pair_q, taps=taps)
        for i in range(0, ys.shape[0], chunk)
    ])


def _bootstrap_powers(idx, t, y, err, df, fmin, nf, fit_mean=True, psd=False, method="fast",
                      pair_q=None, gridder="scatter", taps=4, nterms=1):
    """Max power per resampled replicate; ``idx`` [R, N] holds each
    replicate's resample indices (the caller draws them). All replicates
    share the time grid, so they run through :func:`gls_power_batch` in
    the layout ``gridder`` names. With ``nterms > 1`` the replicates run
    the same harmonic statistic as the periodogram, one at a time."""
    if nterms > 1:
        return torch.stack([
            nanmax(gls_power_multiterm(t, y[ix], err[ix], df, fmin, nf, nterms,
                                       fit_mean=fit_mean, psd=psd, method=method, taps=taps))
            for ix in idx
        ])
    powers = gls_power_batch(t, y[idx], err[idx], df, fmin, nf, fit_mean=fit_mean, psd=psd,
                             method=method, pair_q=pair_q, gridder=gridder, taps=taps)
    return nanmax(powers, dim=1)


def _bootstrap_powers_multiband(t, y, err, bands, idx, n_bands, df, fmin, nf, nterms_base=1,
                                nterms_band=1, reg_base=1e-12, reg_band=1e-6, method="fast",
                                taps=12):
    """Max multiband power per within-band resampled replicate. ``idx``
    [R, N] maps each sample to a donor in its own band (built by
    :meth:`MultibandGLS.bootstrap`), so the replicates run the exact
    statistic of record with only the phase coherence destroyed."""
    return torch.stack([
        nanmax(gls_power_multiband(t, y[ix], err[ix], bands, n_bands, df, fmin, nf,
                                   nterms_base=nterms_base, nterms_band=nterms_band,
                                   reg_base=reg_base, reg_band=reg_band, method=method,
                                   taps=taps))
        for ix in idx
    ])


def _normal_equations(X, w, y):
    """Weighted normal equations of the designs ``X`` [c, N, D]:
    G = X^T W X [c, D, D] and b = X^T W y [c, D]."""
    Xw = X * w[None, :, None]
    with full_float32():
        return X.transpose(-1, -2) @ Xw, (Xw.transpose(-1, -2) @ y[:, None])[..., 0]


def gls_power_multiterm(t, y, err, df, fmin, nf, nterms, fit_mean=True, psd=False,
                        method="fast", taps=12):
    """Multi-term (harmonic) Lomb-Scargle power on a uniform grid.

    Model per trial frequency f (VanderPlas & Ivezic 2015):

        y(t) ~ c0 + sum_{m=1..K} a_m cos(2 pi m f t) + b_m sin(2 pi m f t)

    Power = weighted regression ESS / total SS, which reduces to the
    floating-mean GLS power at ``nterms=1``.

    ``method="fast"`` assembles the (2K+1)-square normal equations from
    Press-Rybicki trig sums of w at harmonics q*f (q <= 2K) and of w*y at
    m*f (m <= K), each on a doubled ``index_add_`` grid (harmonic grids
    wrap, so the spreading kernel does not apply), and solves them with
    the unrolled Cholesky of :func:`_solve_spd_small`. ``method="direct"``
    solves the exact design per frequency, 256 frequencies at a time. A
    relative 1e-12 ridge keeps the low-frequency end solvable in both.
    """
    K = int(nterms)
    w = err ** -2.0
    w = w / torch.sum(w)
    if fit_mean:
        mean = _dot(w, y)
        y = y.to(mean.dtype) - mean
    YY = _dot(w, y ** 2)
    ncols = 2 * K + (1 if fit_mean else 0)
    dtype = result_dtype(t, y, err)
    device = t.device
    ridge = 1e-12 * torch.sum(w) * torch.eye(ncols, dtype=dtype, device=device)

    if method == "fast":
        ones = torch.ones(nf, dtype=dtype, device=device)
        zeros = torch.zeros(nf, dtype=dtype, device=device)
        nfft = 2 * grid_size(nf, 5)
        Cq, Sq = [torch.sum(w) * ones], [zeros]
        for q in range(1, 2 * K + 1):
            S_, C_ = trig_sum(t, w, q * df, nf, q * fmin, nfft=nfft, taps=taps)
            Cq.append(C_)
            Sq.append(S_)
        Cy, Sy = [None], [None]
        for m in range(1, K + 1):
            S_, C_ = trig_sum(t, w * y, m * df, nf, m * fmin, nfft=nfft, taps=taps)
            Cy.append(C_)
            Sy.append(S_)
        # column order: [1?, cos(1f), sin(1f), ..., cos(Kf), sin(Kf)]
        spec = _harmonic_cols(K) if fit_mean else _harmonic_cols(K)[1:]
        rows = [[_harmonic_gram_entry(Cq, Sq, a, b) for b in spec] for a in spec]
        bcols = [_dot(w, y) * ones if kind == "1" else (Cy[m] if kind == "cos" else Sy[m])
                 for kind, m in spec]
        G = torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)  # [nf, D, D]
        bvec = torch.stack(bcols, dim=-1)  # [nf, D]
        theta = _solve_spd_small(G + ridge, bvec)
        power = torch.sum(bvec * theta, dim=-1) / YY
    elif method == "direct":
        freqs = fmin + df * torch.arange(nf, dtype=t.dtype, device=device)
        wd, yd = w.to(dtype), y.to(dtype)
        parts = []
        for s in range(0, nf, 256):
            ph = (2 * math.pi) * freqs[s:s + 256, None] * t[None, :]
            cols = ([torch.ones_like(ph)] if fit_mean else []) + [
                fn(m * ph) for m in range(1, K + 1) for fn in (torch.cos, torch.sin)
            ]
            G, bvec = _normal_equations(torch.stack(cols, dim=-1).to(dtype), wd, yd)
            theta = _solve_spd_small(G + ridge, bvec)
            parts.append(torch.sum(bvec * theta, dim=-1) / YY)
        power = torch.cat(parts)
    else:
        raise ValueError(f"method must be 'fast' or 'direct', got {method!r}")
    if psd:
        return power * YY * 0.5 * torch.sum(err ** -2.0)
    return power


def _cholesky_solve_unrolled(G, b, pivot=None):
    """Unrolled Cholesky of ``G`` [..., D, D] and solve for ``b`` [..., D]:
    about D^3/3 elementwise ops over the leading axes. ``pivot(s, i)`` maps
    row i's diagonal pivot s before its square root. Returns (x, diag(L)
    list)."""
    D = G.shape[-1]
    L = [[None] * D for _ in range(D)]
    for i in range(D):
        for j in range(i + 1):
            s = G[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(s if pivot is None else pivot(s, i))
            else:
                L[i][j] = s / L[j][j]
    z = [None] * D
    for i in range(D):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * z[k]
        z[i] = s / L[i][i]
    x = [None] * D
    for i in reversed(range(D)):
        s = z[i]
        for k in range(i + 1, D):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1), [L[i][i] for i in range(D)]


def _solve_spd_small(G, b, unroll_max=16):
    """Batched SPD solve with an unrolled Cholesky: ``G`` [..., D, D]
    (symmetric positive definite; the harmonic Gram matrices carry a
    positive ridge), ``b`` [..., D] -> [..., D]. The same recurrence as the
    JAX package, as elementwise ops over the frequency axis;
    ``torch.linalg.solve`` above ``unroll_max``, as JAX uses
    ``jnp.linalg.solve`` there.

    Where rounding alone drives a pivot to zero or below, to within
    D * eps times its row's diagonal of G (a Gram matrix singular to
    working precision, as in float32 where the ridge is below rounding),
    the pivot is raised to that floor, so the solve stays finite where
    JAX's unfloored recurrence takes the root of a non-positive number and
    returns NaN or inf. A positive pivot is left as it is, however small,
    so every bin where JAX is finite keeps JAX's bits; and a pivot further
    below zero than rounding can explain (a Gram matrix of trig-sum
    approximations that is not positive definite, far above the grid's
    Nyquist frequency) stays NaN, as in JAX, rather than becoming a finite
    power of no meaning (ROADMAP.md C2)."""
    if G.shape[-1] > unroll_max:
        return torch.linalg.solve(G, b[..., None])[..., 0]
    D = G.shape[-1]
    tol = [D * torch.finfo(G.dtype).eps * G[..., i, i] for i in range(D)]

    def pivot(s, i):
        return torch.where((s <= 0) & (s >= -tol[i]), tol[i], s)

    return _cholesky_solve_unrolled(G, b, pivot=pivot)[0]


def _solve_spd_small_logdet(G, b, ridge=1e-12):
    """Like :func:`_solve_spd_small` but also returns log|G| (from the
    Cholesky diagonal) — the BGLST marginal likelihood needs both.

    Jacobi-equilibrated: solves ``(D G D) z = D b`` with
    ``D = diag(G)^-1/2`` plus a relative ``ridge`` on the scaled unit
    diagonal, and floors each pivot at ``D * eps`` before the square root,
    so a nearly (or doubly) collinear design gives a large but finite
    log-ML instead of NaN. ``log|G|`` is recovered via ``-2 sum log D_ii``.
    """
    D = G.shape[-1]
    floor = D * torch.finfo(G.dtype).eps
    diag = torch.stack([G[..., i, i] for i in range(D)], dim=-1)
    d = torch.sqrt(torch.clamp(diag, min=torch.finfo(G.dtype).tiny))
    Gs = G / (d[..., :, None] * d[..., None, :])
    Gs = Gs + ridge * torch.eye(D, dtype=G.dtype, device=G.device)
    z, ldiag = _cholesky_solve_unrolled(Gs, b / d, pivot=lambda s, i: torch.clamp(s, min=floor))
    logdet = sum(2.0 * torch.log(ldiag[i]) for i in range(D)) + sum(
        2.0 * torch.log(d[..., i]) for i in range(D)
    )
    return z / d, logdet


def _harmonic_gram_entry(Cq, Sq, a, b):
    """Weighted Gram-matrix entry <col_a . col_b>_w from trig sums of the
    weights at harmonic multiples of the trial frequency, via the
    product-to-sum identities. ``a``/``b`` are ``(kind, m)`` with kind in
    {"1", "cos", "sin"}; ``Cq[q]``/``Sq[q]`` are the cos/sin trig sums of
    the weights at harmonic q (``Cq[0] = sum w``, ``Sq[0] = 0``)."""
    (ka, ma), (kb, mb) = a, b
    if ka == "1" and kb == "1":
        return Cq[0]
    if ka == "1":
        return Cq[mb] if kb == "cos" else Sq[mb]
    if kb == "1":
        return Cq[ma] if ka == "cos" else Sq[ma]

    def Cd(q):
        return Cq[abs(q)]

    def Sd(q):
        return -Sq[-q] if q < 0 else Sq[q]

    m, mm = ma, mb
    if ka == "cos" and kb == "cos":
        return 0.5 * (Cd(m - mm) + Cq[m + mm])
    if ka == "cos" and kb == "sin":
        return 0.5 * (Sq[m + mm] + Sd(mm - m))
    if ka == "sin" and kb == "cos":
        return 0.5 * (Sq[m + mm] + Sd(m - mm))
    return 0.5 * (Cd(m - mm) - Cq[m + mm])


def _harmonic_cols(kmax):
    """Column spec [("1",0), ("cos",1), ("sin",1), ..., ("sin",kmax)]."""
    return [("1", 0)] + [(k, m) for m in range(1, kmax + 1) for k in ("cos", "sin")]


def _multiband_design(ph, masks, Kb, Ks, dtype):
    """Multiband design [..., N, D] at phases ``ph`` [..., N]: the shared
    offset and base harmonics, then per band its mask and masked
    harmonics."""
    cols = [torch.ones_like(ph)] + [
        fn(m * ph) for m in range(1, Kb + 1) for fn in (torch.cos, torch.sin)
    ]
    for mask in masks:
        cols.append(mask.expand_as(ph))
        for m in range(1, Ks + 1):
            cols.append(mask * torch.cos(m * ph))
            cols.append(mask * torch.sin(m * ph))
    return torch.stack([c.to(dtype) for c in cols], dim=-1)


def gls_power_multiband(t, y, err, bands, n_bands, df, fmin, nf, nterms_base=1, nterms_band=1,
                        reg_base=1e-12, reg_band=1e-6, method="fast", taps=12):
    """Multiband generalized Lomb-Scargle power on a uniform grid.

    Model per trial frequency f (VanderPlas & Ivezic 2015, ApJ 812 18): a
    shared base model of ``nterms_base`` harmonics plus, for each of the
    ``n_bands`` bands, an offset and ``nterms_band`` residual harmonics.
    Power = 1 - chi2(f)/chi2_ref, with chi2_ref the per-band
    weighted-means null model.

    ``bands``: integer tensor [N] of band indices in [0, n_bands).
    ``reg_base``/``reg_band``: relative ridges on the base/band diagonal
    blocks (the global offset is degenerate with the sum of the band
    offsets; ``reg_band`` breaks the tie toward the shared model).

    ``method="fast"`` assembles the D-square normal equations
    (D = 1+2*nterms_base + n_bands*(1+2*nterms_band)) from per-band trig
    sums of the masked weights at harmonics up to
    ``2*max(nterms_base, nterms_band)`` on doubled ``index_add_`` grids;
    ``method="direct"`` solves the exact design, 128 frequencies at a time.
    """
    S = int(n_bands)
    Kb = int(nterms_base)
    Ks = int(nterms_band)
    if max(Kb, Ks) < 1:
        raise ValueError("need nterms_base >= 1 or nterms_band >= 1")
    dtype = result_dtype(t, y, err)
    device = t.device
    w = err ** -2.0
    w = (w / torch.sum(w)).to(dtype)
    masks = [(bands == s).to(dtype) for s in range(S)]
    Ws = [torch.sum(w * m) for m in masks]
    Wys = [_dot(w * m, y) for m in masks]
    YY = _dot(w, y ** 2)
    # null model: per-band weighted means (empty bands contribute 0)
    ess0 = sum(torch.where(W > 0, Wy * Wy / torch.where(W > 0, W, 1.0), 0.0)
               for W, Wy in zip(Ws, Wys))
    chi2_0 = YY - ess0

    cols_base = _harmonic_cols(Kb)
    cols_band = _harmonic_cols(Ks)
    nb, ns = len(cols_base), len(cols_band)
    # sum(w) == 1, so reg_* are already relative ridge strengths
    reg = torch.diag(torch.cat([
        torch.full((nb,), reg_base, dtype=dtype, device=device),
        torch.full((S * ns,), reg_band, dtype=dtype, device=device),
    ]))

    if method == "fast":
        qmax = 2 * max(Kb, Ks)
        kmax = max(Kb, Ks)
        nfft = 2 * grid_size(nf, 5)
        ones = torch.ones(nf, dtype=dtype, device=device)
        zeros = torch.zeros(nf, dtype=dtype, device=device)
        Cq_s, Sq_s, Cy_s, Sy_s = [], [], [], []
        for s in range(S):
            ws = w * masks[s]
            Cq, Sq = [Ws[s] * ones], [zeros]
            for q in range(1, qmax + 1):
                S_, C_ = trig_sum(t, ws, q * df, nf, q * fmin, nfft=nfft, taps=taps)
                Cq.append(C_)
                Sq.append(S_)
            Cy, Sy = [Wys[s] * ones], [zeros]
            for m in range(1, kmax + 1):
                S_, C_ = trig_sum(t, ws * y, m * df, nf, m * fmin, nfft=nfft, taps=taps)
                Cy.append(C_)
                Sy.append(S_)
            Cq_s.append(Cq)
            Sq_s.append(Sq)
            Cy_s.append(Cy)
            Sy_s.append(Sy)
        Cq_tot = [sum(Cq_s[s][q] for s in range(S)) for q in range(qmax + 1)]
        Sq_tot = [sum(Sq_s[s][q] for s in range(S)) for q in range(qmax + 1)]
        Cy_tot = [sum(Cy_s[s][m] for s in range(S)) for m in range(kmax + 1)]
        Sy_tot = [sum(Sy_s[s][m] for s in range(S)) for m in range(kmax + 1)]

        def bvec_entry(Cy, Sy, col):
            k, m = col
            if k == "1":
                return Cy[0]
            return Cy[m] if k == "cos" else Sy[m]

        rows, bcols = [], []
        for a in cols_base:
            row = [_harmonic_gram_entry(Cq_tot, Sq_tot, a, b2) for b2 in cols_base]
            for s in range(S):
                row += [_harmonic_gram_entry(Cq_s[s], Sq_s[s], a, b2) for b2 in cols_band]
            rows.append(row)
            bcols.append(bvec_entry(Cy_tot, Sy_tot, a))
        for s in range(S):
            for a in cols_band:
                row = [_harmonic_gram_entry(Cq_s[s], Sq_s[s], a, b2) for b2 in cols_base]
                for s2 in range(S):
                    if s2 == s:
                        row += [_harmonic_gram_entry(Cq_s[s], Sq_s[s], a, b2)
                                for b2 in cols_band]
                    else:
                        row += [zeros] * ns
                rows.append(row)
                bcols.append(bvec_entry(Cy_s[s], Sy_s[s], a))
        G = torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)
        bvec = torch.stack(bcols, dim=-1)  # [nf, D]
        theta = _solve_spd_small(G + reg, bvec)
        ess = torch.sum(bvec * theta, dim=-1)
    elif method == "direct":
        freqs = fmin + df * torch.arange(nf, dtype=t.dtype, device=device)
        yd = y.to(dtype)
        parts = []
        for s in range(0, nf, 128):
            ph = (2 * math.pi) * freqs[s:s + 128, None] * t[None, :]
            G1, b1 = _normal_equations(_multiband_design(ph, masks, Kb, Ks, dtype), w, yd)
            theta = _solve_spd_small(G1 + reg, b1)
            parts.append(torch.sum(b1 * theta, dim=-1))
        ess = torch.cat(parts)
    else:
        raise ValueError(f"method must be 'fast' or 'direct', got {method!r}")
    return (ess - ess0) / chi2_0


def _local_peak_grids(power, freq, n_peaks, zoom, width):
    """The fine local grids ``refine`` evaluates: for each of the
    ``n_peaks`` highest peaks of ``power`` (numpy, on the host, as in the
    JAX package; the global maximum is always a candidate), a grid of
    ``2*width*zoom + 1`` points spanning +-``width`` cells. Yields
    (f_lo, df_local, n_local) in increasing frequency."""
    df = freq[1] - freq[0]
    interior = (power[1:-1] > power[:-2]) & (power[1:-1] >= power[2:])
    peak_idx = np.flatnonzero(interior) + 1
    peak_idx = np.union1d(peak_idx, [int(np.argmax(power))])
    top = peak_idx[np.argsort(power[peak_idx])[::-1][:n_peaks]]
    n_local = int(2 * width * zoom) + 1
    for i in sorted(int(j) for j in top):
        f_lo = max(freq[i] - width * df, df * 1e-3)
        yield f_lo, 2 * width * df / (n_local - 1), n_local


def _refined_series(segments_f, segments_p):
    """FSeries over the union of the local grids, sorted by frequency, on
    the powers' device; and the frequency of the largest power."""
    f_all = np.concatenate(segments_f)
    p_all = torch.cat(segments_p)
    order = np.argsort(f_all)
    dev = p_all.device
    refined = FSeries(torch.from_numpy(f_all[order]).to(dev),
                      p_all[torch.from_numpy(order).to(dev)], assume_sorted=True)
    return refined, float(f_all[int(_host(p_all).argmax())])


class MultibandGLS:
    """Multiband generalized Lomb-Scargle (VanderPlas & Ivezic 2015): a
    shared-period model with per-band offsets, amplitudes and phases, as
    one Press-Rybicki normal-equation scan (:func:`gls_power_multiband`).

    Call on either a dict ``{band_name: TSeries}`` (optionally with
    ``err`` a matching dict of per-band errors) or a single TSeries/array
    plus an integer ``bands`` array per sample.

    Alignment contract (as for :class:`GLS`): a plain error array must
    align with the TSeries' stored order — TSeries sorts by time at
    construction, so if a band was built from unsorted times, pass its
    errors as a ``TSeries(t, e)`` over the same times (it sorts
    identically) rather than as the raw array, or pre-sort both.
    """

    def __init__(self, fmin=None, fmax=None, n=5, nterms_base=1, nterms_band=1,
                 reg_base=1e-12, reg_band=1e-6, method="fast"):
        self.fmin = fmin
        self.fmax = fmax
        self.n = n
        self.nterms_base = int(nterms_base)
        self.nterms_band = int(nterms_band)
        self.reg_base = reg_base
        self.reg_band = reg_band
        self.method = method

    def __call__(self, signals, err=None, bands=None):
        if isinstance(signals, dict):
            self.band_names = list(signals.keys())
            ts, ys, es, bs = [], [], [], []
            for i, (name, sig) in enumerate(signals.items()):
                if not isinstance(sig, TSeries):
                    sig = TSeries(values=sig)
                dev = sig.values.device
                ts.append(sig.time)
                ys.append(sig.values)
                n_i = sig.time.shape[0]
                if err is not None:
                    # a TSeries error sorts by its time at construction,
                    # exactly like the signal did; a raw array must already
                    # align with sig's stored order
                    e_i = err[name]
                    e_i = e_i.values if isinstance(e_i, TSeries) else as_tensor(e_i, dev)
                    if tuple(e_i.shape) != (n_i,):
                        raise ValueError(
                            f"err[{name!r}] has shape {tuple(e_i.shape)}, expected ({n_i},)"
                        )
                    es.append(e_i.to(dev))
                else:
                    es.append(torch.ones(n_i, dtype=torch.float64, device=dev))
                bs.append(torch.full((n_i,), i, dtype=torch.int32, device=dev))
            dev = ts[0].device
            t, y, e, b = (torch.cat([x.to(dev) for x in xs]) for xs in (ts, ys, es, bs))
        else:
            if bands is None:
                raise ValueError("non-dict input needs a bands= array")
            if isinstance(signals, TSeries):
                # sorted by construction; bands/err align with its order
                t, y = signals.time, signals.values
            else:
                y = as_tensor(signals)
                t = torch.arange(y.shape[0], dtype=torch.float64, device=y.device)
            e = torch.ones_like(y) if err is None else as_tensor(err, y.device)
            b = as_tensor(bands, y.device)
            self.band_names = list(range(int(b.max()) + 1))
        order = torch.argsort(t, stable=True)
        t, y, e, b = t[order], y[order], e[order], b[order]
        n_bands = len(self.band_names)
        combined = TSeries(t, y, assume_sorted=True)
        freq, df, fmin = default_frequency_grid(combined, self.fmin, self.fmax, self.n)
        nf = freq.size
        log_event(
            "multiband_gls", n=t.shape[0], nf=nf, n_bands=n_bands,
            nterms_base=self.nterms_base, nterms_band=self.nterms_band, method=self.method,
        )
        power = gls_power_multiband(
            t, y, e, b, n_bands, df, fmin, nf, nterms_base=self.nterms_base,
            nterms_band=self.nterms_band, reg_base=self.reg_base, reg_band=self.reg_band,
            method=self.method,
        )
        self.signal = combined
        self.err = e
        self.bands = b
        self.n_bands = n_bands
        self.frequency = freq
        self.periodogram = FSeries(freq, power, assume_sorted=True)
        return self.periodogram

    def copy(self):
        return MultibandGLS(self.fmin, self.fmax, self.n, self.nterms_base, self.nterms_band,
                            self.reg_base, self.reg_band, self.method)

    def _band_index(self, band):
        if band in self.band_names:
            return self.band_names.index(band)
        s = int(band)
        if not 0 <= s < self.n_bands:
            raise ValueError(f"unknown band {band!r}")
        return s

    def bootstrap(self, n_bootstraps, random_seed=0):
        """Max-power null distribution over within-band resampled
        replicates: (value, error) pairs are resampled with replacement
        WITHIN their band, keeping every band's cadence and weights while
        destroying the shared-period phase coherence. Indices come from a
        ``torch.Generator`` seeded by ``random_seed`` on the signal's
        device. Returns the replicates as a numpy array, as JAX does."""
        t = self.signal.time
        dev = t.device
        freq = self.frequency
        n = t.shape[0]
        r = int(n_bootstraps)
        gen = torch.Generator(device=dev).manual_seed(int(random_seed))
        idx = torch.arange(n, device=dev).expand(r, n).clone()
        for s in range(self.n_bands):
            pos = torch.nonzero(self.bands == s).flatten()
            if pos.numel() == 0:
                continue
            draw = torch.randint(0, pos.numel(), (r, pos.numel()), generator=gen, device=dev)
            idx[:, pos] = pos[draw]
        reps = _bootstrap_powers_multiband(
            t, self.signal.values, self.err, self.bands, idx, self.n_bands,
            float(freq[1] - freq[0]), float(freq[0]), freq.size,
            nterms_base=self.nterms_base, nterms_band=self.nterms_band,
            reg_base=self.reg_base, reg_band=self.reg_band, method=self.method,
        )
        self.bs_replicates = _host(reps)
        return self.bs_replicates

    def fap(self, power):
        """Bootstrap false-alarm probability of a given (max) power level
        (run :meth:`bootstrap` first); the Baluev bound does not cover the
        multiband statistic."""
        return np.mean(_host(power) < self.bs_replicates)

    def fal(self, fap):
        """False-alarm level: the power whose bootstrap FAP is ``fap``."""
        return np.quantile(self.bs_replicates, 1 - fap)

    def model(self, tf, f0, band):
        """The fitted multiband model for one band at times ``tf``: shared
        base harmonics plus that band's offset and residual harmonics at
        frequency ``f0``, from one exact weighted normal-equation solve
        (``torch.linalg.solve``) of the full design with the periodogram's
        ridge. ``band`` is a band name (dict input) or index."""
        s = self._band_index(band)
        t = self.signal.time
        y = self.signal.values
        dtype = result_dtype(t, y, self.err)
        w = self.err ** -2.0
        w = (w / torch.sum(w)).to(dtype)
        Kb, Ks, S = self.nterms_base, self.nterms_band, self.n_bands
        f0 = float(f0)

        def design(ts, band_of):
            masks = [(band_of == s2).to(ts.dtype) for s2 in range(S)]
            return _multiband_design((2 * math.pi * f0) * ts, masks, Kb, Ks,
                                     torch.promote_types(ts.dtype, dtype))

        reg = torch.diag(torch.cat([
            torch.full((1 + 2 * Kb,), self.reg_base, dtype=dtype, device=t.device),
            torch.full((S * (1 + 2 * Ks),), self.reg_band, dtype=dtype, device=t.device),
        ]))
        G, b = _normal_equations(design(t, self.bands)[None], w, y.to(dtype))
        theta = torch.linalg.solve(G[0] + reg, b[0])
        tf = as_tensor(tf, t.device)
        Xf = design(tf, torch.full(tf.shape, s, dtype=torch.int32, device=t.device))
        with full_float32():
            return TSeries(tf, Xf @ theta.to(Xf.dtype))

    def refine(self, n_peaks=1, zoom=32, width=2.0):
        """Exact local refinement of the top multiband peaks: the fast
        scan locates candidates, then the exact direct design is solved on
        fine local grids of ``2*width*zoom`` points spanning ±``width``
        cells around each. Returns an FSeries over the union of local
        grids and stores ``self.refined_fbest``. The local phases are
        formed in float64, as the JAX package forms them from its numpy
        float64 grid scalars."""
        t64 = self.signal.time.to(torch.float64)
        segments_f, segments_p = [], []
        for f_lo, df_local, n_local in _local_peak_grids(
                _host(self.periodogram.values), np.asarray(self.frequency), n_peaks, zoom,
                width):
            segments_p.append(gls_power_multiband(
                t64, self.signal.values, self.err, self.bands, self.n_bands, float(df_local),
                float(f_lo), n_local, nterms_base=self.nterms_base,
                nterms_band=self.nterms_band, reg_base=self.reg_base, reg_band=self.reg_band,
                method="direct",
            ))
            segments_f.append(f_lo + df_local * np.arange(n_local))
        refined, self.refined_fbest = _refined_series(segments_f, segments_p)
        return refined


class GLS:
    """Generalized Lomb-Scargle periodogram (reference spectral.py:43-204).

    References: Press & Rybicki (1989); Zechmeister & Kurster (2009).
    ``nterms > 1`` fits K harmonics of each trial frequency
    (:func:`gls_power_multiterm`).
    """

    def __init__(self, fmin=None, fmax=None, n=5, psd=False, method="fast",
                 gridder="auto", nterms=1):
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
        if self.nterms > 1:
            power = gls_power_multiterm(
                signal.time, signal.values, self.err, df, fmin, nf, self.nterms,
                fit_mean=fit_mean, psd=self.psd, method=self.method,
            )
        else:
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

    def bootstrap(self, n_bootstraps, random_seed=0, fit_mean=True):
        """Max-power null distribution over replicates resampled with
        replacement (reference spectral.py:140-152), all on the signal's
        device, in the layout the periodogram's gridder picks (the loop of
        spreading-kernel periodograms on the card). Indices come from a
        ``torch.Generator`` seeded by ``random_seed``. Returns the
        replicates as a numpy array, as JAX does."""
        freq = self.frequency
        df = freq[1] - freq[0]
        values = self.signal.values
        n = values.shape[0]
        gen = torch.Generator(device=values.device).manual_seed(int(random_seed))
        idx = torch.randint(0, n, (int(n_bootstraps), n), generator=gen, device=values.device)
        reps = _bootstrap_powers(
            idx, self.signal.time, values, self.err, float(df), float(freq[0]), freq.size,
            fit_mean=fit_mean, psd=self.psd, method=self.method,
            pair_q=_pair_q(df, freq[0], freq.size),
            gridder=getattr(self, "_gridder_resolved", "scatter"), nterms=self.nterms,
        )
        self.bs_replicates = _host(reps)
        return self.bs_replicates

    def _baluev(self, method):
        if method != "baluev":
            raise ValueError(f"unknown FAP method {method!r}")
        if self.nterms > 1:
            raise NotImplementedError(
                "the analytic Baluev (2008) bound covers the single-term "
                "statistic only; with nterms > 1 use method='bootstrap' "
                "(it resamples the harmonic statistic itself)"
            )
        return dict(fmax=float(self.frequency[-1]), psd=self.psd, fit_mean=self.fit_mean)

    def fap(self, power, method="bootstrap"):
        """False-alarm probability of a given (max) power level.

        ``method="bootstrap"`` uses the max-power replicates from
        :meth:`bootstrap` (run it first); ``method="baluev"`` is the
        analytic Baluev (2008) upper bound."""
        if method == "bootstrap":
            return np.mean(_host(power) < self.bs_replicates)
        return fap_baluev(self.signal.time, self.err, power, **self._baluev(method))

    def fal(self, fap, method="bootstrap"):
        """False-alarm level: the power whose FAP equals ``fap``."""
        if method == "bootstrap":
            return np.quantile(self.bs_replicates, 1 - fap)
        return fal_baluev(self.signal.time, self.err, fap, **self._baluev(method))

    def refine(self, n_peaks=1, zoom=32, width=2.0, fit_mean=None):
        """Exact local refinement of the top fast-periodogram peaks: the
        exact direct sums on fine local grids of ``2*width*zoom`` points
        spanning ±``width`` grid cells around each of the ``n_peaks``
        highest peaks (peaks picked on the host, the sums on the signal's
        device; local phases in float64, as the JAX package forms them
        from its numpy float64 grid scalars).

        Returns an :class:`~periodicity_tpu_torch.core.FSeries` over the
        union of the local grids (sorted by frequency), and stores the
        refined best frequency as ``self.refined_fbest``.
        """
        if fit_mean is None:
            fit_mean = self.fit_mean  # the model the coarse scan used
        t64 = self.signal.time.to(torch.float64)
        segments_f, segments_p = [], []
        for f_lo, df_local, n_local in _local_peak_grids(
                _host(self.periodogram.values), np.asarray(self.frequency), n_peaks, zoom,
                width):
            if self.nterms > 1:
                p_local = gls_power_multiterm(
                    t64, self.signal.values, self.err, float(df_local), float(f_lo), n_local,
                    self.nterms, fit_mean=fit_mean, psd=self.psd, method="direct",
                )
            else:
                p_local = gls_power(
                    t64, self.signal.values, self.err, float(df_local), float(f_lo), n_local,
                    fit_mean=fit_mean, psd=self.psd, method="direct",
                )
            segments_f.append(f_lo + df_local * np.arange(n_local))
            segments_p.append(p_local)
        refined, self.refined_fbest = _refined_series(segments_f, segments_p)
        return refined

    def window(self):
        """Spectral window function: periodogram of a constant signal
        (reference spectral.py:165-167)."""
        gls = self.copy()
        return gls(0.0 * self.signal + 1.0, fit_mean=False)

    def model(self, tf, f0):
        """Weighted least-squares sinusoid fit at frequency f0, evaluated
        at times tf (reference spectral.py:169-204), solved with
        ``torch.linalg.solve``. With ``nterms > 1`` the fit includes the K
        harmonics of f0."""
        t = self.signal.time
        y = self.signal.values
        w = self.err ** -2.0
        y_mean = _dot(y, w) / torch.sum(w)
        y = y - y_mean
        tf = as_tensor(tf, t.device)
        f0 = float(f0)

        def design(ts):
            cols = [torch.ones_like(ts)]
            for m in range(1, self.nterms + 1):
                cols.append(torch.sin(2 * math.pi * m * f0 * ts))
                cols.append(torch.cos(2 * math.pi * m * f0 * ts))
            return torch.stack(cols)

        X = design(t) / self.err
        Xf = design(tf)
        with full_float32():
            theta = torch.linalg.solve(X @ X.T, X @ (y / self.err))
            dtype = torch.promote_types(Xf.dtype, theta.dtype)
            return TSeries(tf, y_mean + Xf.T.to(dtype) @ theta.to(dtype))


def fap_baluev(t, err, z, fmax, psd=False, fit_mean=True):
    """Analytic false-alarm probability of the maximum periodogram power.

    Baluev (2008, MNRAS 385, 1279) aliasing-free upper bound for the
    Lomb-Scargle periodogram scanned up to ``fmax``:
    ``FAP(z) <= 1 - (1 - FAP_single(z)) * exp(-tau(z))`` with the Davies
    bound ``tau = W * (1-z)^((Nk-1)/2) * sqrt(Nh z / 2)`` (standard
    normalization) or ``tau = W exp(-z) sqrt(z)`` (psd),
    ``W = fmax * sqrt(4 pi var_w(t))``. ``fit_mean=True`` gives
    Nh = N - 1, Nk = N - 3; ``fit_mean=False`` gives Nh = N, Nk = N - 2.
    Host numpy, as in the JAX package; ``t``, ``err`` and ``z`` may be
    tensors on any device or array-likes. Requires Nk > 1.
    """
    t = np.asarray(_host(t), float)
    w = np.asarray(_host(err), float) ** -2.0
    w = w / w.sum()
    n = t.size
    nh = n - 1 if fit_mean else n
    nk = n - 3 if fit_mean else n - 2
    if nk <= 1:
        raise ValueError(f"Baluev FAP needs more samples (Nk = {nk})")
    tbar = np.dot(w, t)
    teff = np.sqrt(4.0 * np.pi * np.dot(w, (t - tbar) ** 2))
    big_w = fmax * teff
    z = np.asarray(_host(z), float)
    if psd:
        zc = np.maximum(z, 0.0)
        fap1 = np.exp(-zc)
        tau = big_w * np.exp(-zc) * np.sqrt(zc)
    else:
        zc = np.clip(z, 0.0, 1.0)
        fap1 = (1.0 - zc) ** (0.5 * nk)
        tau = big_w * (1.0 - zc) ** (0.5 * (nk - 1)) * np.sqrt(0.5 * nh * zc)
    # 1 - (1 - fap1) exp(-tau), rearranged so small-FAP tails (fap1 and
    # tau both << 1) do not cancel to 0.0
    return fap1 * np.exp(-tau) - np.expm1(-tau)


def fal_baluev(t, err, fap, fmax, psd=False, fit_mean=True, tol=1e-12, max_iter=200):
    """Power level whose Baluev FAP equals ``fap`` (inverse of
    :func:`fap_baluev` by bisection; the FAP decreases with z)."""
    target = float(fap)
    if not 0.0 < target < 1.0:
        raise ValueError("fap must be in (0, 1)")
    t, err = _host(t), _host(err)
    lo, hi = 0.0, 1.0
    if psd:
        while fap_baluev(t, err, hi, fmax, psd=True, fit_mean=fit_mean) > target:
            hi *= 2.0
            if hi > 1e12:
                break
    for _ in range(max_iter):
        mid = 0.5 * (lo + hi)
        if fap_baluev(t, err, mid, fmax, psd=psd, fit_mean=fit_mean) > target:
            lo = mid
        else:
            hi = mid
        if hi - lo < tol * max(1.0, hi):
            break
    return 0.5 * (lo + hi)


def bglst_log_ml(t, y, w, df, fmin, nf):
    """Bayesian GLS with linear trend: log marginal likelihood per
    frequency, exact (Mortier et al. 2015 with a trend term, after
    Olspert et al. 2018). Model per trial frequency f:
    y_i = a cos(2 pi f t_i) + b sin(2 pi f t_i) + alpha t_i + beta + noise,
    noise ~ N(0, 1/w_i), flat priors; closed form from the weighted normal
    equations, 256 frequencies at a time."""
    freqs = fmin + df * torch.arange(nf, dtype=t.dtype, device=t.device)
    dtype = result_dtype(t, y, w)
    wd, yd = w.to(dtype), y.to(dtype)
    yy = _dot(w, y ** 2)
    parts = []
    for s in range(0, nf, 256):
        ph = (2 * math.pi) * freqs[s:s + 256, None] * t[None, :]
        tt = t.expand_as(ph)
        X = torch.stack([torch.cos(ph), torch.sin(ph), tt, torch.ones_like(tt)], dim=-1)
        G, bvec = _normal_equations(X.to(dtype), wd, yd)
        # the equilibrated solve carries its own relative ridge
        theta, logdet = _solve_spd_small_logdet(G, bvec)
        chi2 = yy - torch.sum(bvec * theta, dim=-1)
        parts.append(-0.5 * chi2 - 0.5 * logdet)
    return torch.cat(parts)


def bglst_log_ml_fast(t, y, w, df, fmin, nf, taps=12):
    """BGLST log marginal likelihood via Press-Rybicki trig sums.

    Every frequency-dependent entry of the 4x4 weighted normal equations
    for the design [cos, sin, t, 1] is a trig sum (of w*y, w and w*t at f,
    and of w at 2f), so the scan is four extirpolation + IFFT pipelines on
    doubled ``index_add_`` grids at ``taps`` = 12 plus the unrolled 4x4
    solves. The trend column is centred at the weighted mean time, which
    leaves log|G| and chi2 unchanged and conditions G.
    """
    W = torch.sum(w)
    c = _dot(w, t) / W
    tc = t - c
    nfft = 2 * grid_size(nf, 5)
    Sy, Cy = trig_sum(t, w * y, df, nf, fmin, nfft=nfft, taps=taps)
    Sw, Cw = trig_sum(t, w, df, nf, fmin, nfft=nfft, taps=taps)
    St, Ct = trig_sum(t, w * tc, df, nf, fmin, nfft=nfft, taps=taps)
    S2, C2 = trig_sum(t, w, 2 * df, nf, 2 * fmin, nfft=nfft, taps=taps)
    swtt = _dot(w, tc * tc)
    swy = _dot(w, y)
    swty = _dot(w, tc * y)
    swyy = _dot(w, y * y)
    ones = torch.ones(nf, dtype=t.dtype, device=t.device)
    zeros = torch.zeros(nf, dtype=t.dtype, device=t.device)
    G = torch.stack(
        [
            torch.stack([(W + C2) / 2, S2 / 2, Ct, Cw], dim=-1),
            torch.stack([S2 / 2, (W - C2) / 2, St, Sw], dim=-1),
            torch.stack([Ct, St, swtt * ones, zeros], dim=-1),
            torch.stack([Cw, Sw, zeros, W * ones], dim=-1),
        ],
        dim=-2,
    )  # [nf, 4, 4]
    bvec = torch.stack([Cy, Sy, swty * ones, swy * ones], dim=-1)  # [nf, 4]
    theta, logdet = _solve_spd_small_logdet(G, bvec)  # equilibrated and ridged
    chi2 = swyy - torch.sum(bvec * theta, dim=-1)
    return -0.5 * chi2 - 0.5 * logdet


class BGLST:
    """Bayesian Generalized Lomb-Scargle with trend (Olspert et al. 2018).

    Closed-form log marginal likelihood of a sinusoid + linear trend under
    flat parameter priors, on the GLS default grid. ``method="fast"``
    (default) assembles the normal equations from four Press-Rybicki
    pipelines (:func:`bglst_log_ml_fast`); ``method="direct"`` keeps the
    exact O(nf * N) evaluation.

    Returns an FSeries of log marginal likelihood (up to a constant); its
    maximum marks the most probable period, robust against secular trends
    that bias plain GLS.
    """

    def __init__(self, fmin=None, fmax=None, n=5, method="fast", taps=12):
        self.fmin = fmin
        self.fmax = fmax
        self.n = n
        self.method = method
        self.taps = taps

    def __call__(self, signal, err=None):
        if not isinstance(signal, TSeries):
            signal = TSeries(values=signal)
        freq, df, fmin = default_frequency_grid(signal, self.fmin, self.fmax, self.n)
        if err is None:
            err = torch.ones_like(signal.values)
        w = as_tensor(err, signal.values.device) ** -2.0
        log_event("bglst", n=signal.size, nf=freq.size, method=self.method)
        if self.method == "fast":
            logml = bglst_log_ml_fast(signal.time, signal.values, w, df, fmin, freq.size,
                                      taps=self.taps)
        else:
            logml = bglst_log_ml(signal.time, signal.values, w, df, fmin, freq.size)
        self.signal = signal
        self.frequency = freq
        self.periodogram = FSeries(freq, logml, assume_sorted=True)
        return self.periodogram
