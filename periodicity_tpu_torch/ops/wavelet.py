"""Wavelet and analytic-signal functions: the Morlet CWT, the Hilbert
transform, the generated DWT filter families and periodized filter banks,
and soft-threshold denoising.

Port of ``periodicity_tpu/ops/wavelet.py``, with its names. The filter
families (Daubechies by roots, symlets, coiflets by multi-start
Levenberg-Marquardt and branch continuation, CDF biorthogonal, discrete
Meyer) are host numpy, copied as they are, so both packages build the same
filters bit for bit. The rest is plain PyTorch on the input's device, over
leading batch axes ``[..., N]`` where the JAX package vmaps:

- ``cwt_morlet``: the complex Morlet ``cmorB-C`` transform as one FFT of
  the zero-padded signal, the Gaussian ``psi_hat`` over ``[S, nfft]`` and
  one batched inverse FFT over the scale axis (cuFFT on the card);
- ``hilbert``: one-sided spectrum doubling over the last axis;
- the periodized DWT: a circular gather and two matrix-vector products
  per analysis level, and a stack of rolled, upsampled coefficient arrays
  contracted with the synthesis filters per level, in full float32.

Array-likes land on the card unless ``device`` is given; tensors keep
their device.
"""

import numpy as np
import torch

from ..core.containers import _place, as_tensor
from ..utils.dtypes import full_float32

__all__ = [
    "central_frequency",
    "psi_zero",
    "cwt_morlet",
    "hilbert",
    "scaling_filter",
    "filter_bank",
    "dwt_per",
    "idwt_per",
    "wavedec",
    "waverec",
    "max_dwt_level",
    "soft_threshold",
]


def _parse_cmor(family):
    """cmorB-C -> (B, C)."""
    if family.startswith("cmor"):
        b, c = family[4:].split("-")
        return float(b), float(c)
    raise ValueError(f"Unknown continuous wavelet family {family}")


def central_frequency(family):
    """Center frequency in cycles/sample at scale 1 (pywt parity)."""
    if family.startswith("cmor"):
        return _parse_cmor(family)[1]
    if family == "morl":
        return 5.0 / (2 * np.pi)
    raise ValueError(f"Unknown wavelet family {family}")


def scale2frequency(family, scale):
    return central_frequency(family) / np.asarray(scale)


def psi_zero(family):
    """psi(0) for inverse-CWT reconstruction (reference
    timefrequency.py:162-167 uses the 'morl' value)."""
    if family == "morl":
        return 1.0
    if family.startswith("cmor"):
        b, _ = _parse_cmor(family)
        return (np.pi * b) ** -0.5
    raise ValueError(f"Unknown wavelet family {family}")


def cwt_morlet(x, scales, family="cmor2.0-1.0", dt=1.0, *, device=None):
    """CWT coefficients [..., n_scales, N] of x [..., N]; scales in samples
    (pywt convention: scale s responds to frequency C/(s*dt)).

    One FFT of x zero-padded to ``nfft = 2**bit_length(2N - 1)``, the
    continuous FT of psi, exp(-pi^2 B (s f - C)^2), at every (scale,
    frequency), and one inverse FFT over the last axis of the [..., S,
    nfft] product."""
    x = as_tensor(x, device)
    n = x.shape[-1]
    b_param, c_param = _parse_cmor(family)
    nfft = 1 << int(2 * n - 1).bit_length()
    scales = _place(scales, None, x).to(device=x.device, dtype=x.dtype) * dt  # to time units
    xf = torch.fft.fft(x, n=nfft)
    freqs = torch.from_numpy(np.fft.fftfreq(nfft, d=dt)).to(device=x.device, dtype=x.dtype)
    af = scales[:, None] * freqs[None, :]
    psi_hat = torch.exp(-(np.pi**2) * b_param * (af - c_param) ** 2)
    w = torch.fft.ifft(xf[..., None, :] * torch.sqrt(scales[:, None]) * psi_hat, dim=-1)
    return w[..., :n]


def hilbert(x, *, device=None):
    """Analytic signal via one-sided spectrum doubling over the last axis
    (scipy.signal.hilbert parity)."""
    x = as_tensor(x, device)
    n = x.shape[-1]
    xf = torch.fft.fft(x, dim=-1)
    h = torch.zeros(n, dtype=x.dtype, device=x.device)
    h[0] = 1
    if n % 2 == 0:
        h[n // 2] = 1
        h[1 : n // 2] = 2
    else:
        h[1 : (n + 1) // 2] = 2
    return torch.fft.ifft(xf * h, dim=-1)


# ---------------------------------------------------------------------------
# Discrete wavelet transform: generated orthogonal filter families (host
# numpy, as in the JAX package) + periodized filter banks on tensors.
# Replaces the reference's PyWavelets DWT (reference
# timefrequency.py:151-159 wavedec/waverec mode="per").
# ---------------------------------------------------------------------------


def _binomial_poly_roots(n_moments):
    """Roots (in y) of P(y) = sum_{k<N} C(N-1+k, k) y^k, the half-band
    remainder in Daubechies' construction (Daubechies 1992, ch. 6)."""
    from math import comb

    coefs = [comb(n_moments - 1 + k, k) for k in range(n_moments)]
    if n_moments == 1:
        return np.array([])
    roots = np.roots(coefs[::-1]).astype(complex)
    # Newton-polish: np.roots loses ~5 digits for the high-order families
    # (db16-db20); a few iterations restore them.
    poly = np.array(coefs[::-1], float)
    deriv = np.polyder(poly)
    for _ in range(3):
        roots = roots - np.polyval(poly, roots) / np.polyval(deriv, roots)
    return roots


def _z_roots_of(y):
    """The z-plane root pair of y = (2 - z - 1/z)/4, ordered
    (inside unit circle, outside)."""
    b = 2 - 4 * y
    disc = np.sqrt(b * b - 4 + 0j)
    z1, z2 = (b + disc) / 2, (b - disc) / 2
    return (z1, z2) if abs(z1) < abs(z2) else (z2, z1)


def _filter_from_roots(z_roots, n_moments):
    """Scaling filter sqrt(2)-normalized from its z-plane zeros plus an
    n_moments-fold zero at z = -1."""
    poly = np.array([1.0 + 0j])
    for z in z_roots:
        poly = np.convolve(poly, [1.0, -z])
    for _ in range(n_moments):
        poly = np.convolve(poly, [1.0, 1.0])
    h = np.real(poly)
    return h * (np.sqrt(2.0) / h.sum())


def _daubechies(n_moments):
    """Extremal-phase (db) scaling filter: all spectral-factor zeros inside
    the unit circle. Increasing-index convention; matches the published
    db1-db4 tables to ~1e-12."""
    zs = [_z_roots_of(y)[0] for y in _binomial_poly_roots(n_moments)]
    return _filter_from_roots(zs, n_moments)


def _root_groups(ys):
    """Group the y-roots into units that must flip together to keep the
    filter real: singleton real roots, complex-conjugate pairs."""
    used = np.zeros(len(ys), bool)
    groups = []
    for i, y in enumerate(ys):
        if used[i]:
            continue
        used[i] = True
        if abs(y.imag) < 1e-10:
            groups.append([y.real + 0j])
        else:
            j = int(np.argmin(np.abs(ys - np.conj(y)) + used * 1e9))
            used[j] = True
            groups.append([y, ys[j]])
    return groups


def _symlet(n_moments):
    """Least-asymmetric (sym) scaling filter: among all real spectral
    factorizations (each root group taken inside or outside the unit
    circle), pick the one whose frequency-response phase deviates least
    from linear. Reproduces the published sym4 table to ~1e-12."""
    from itertools import product as _product

    groups = _root_groups(_binomial_poly_roots(n_moments))
    omega = np.linspace(0.01, np.pi - 0.01, 256)
    best, best_score = None, np.inf
    for flags in _product((0, 1), repeat=len(groups)):
        zs = []
        for flag, grp in zip(flags, groups):
            for y in grp:
                inside, outside = _z_roots_of(y)
                zs.append(outside if flag else inside)
        h = _filter_from_roots(zs, n_moments)
        resp = np.exp(-1j * np.outer(omega, np.arange(len(h)))) @ h
        phase = np.unwrap(np.angle(resp))
        slope = np.dot(phase, omega) / np.dot(omega, omega)
        score = np.sum((phase - slope * omega) ** 2)
        if score < best_score:
            best_score, best = score, h
    # A filter and its time-reversal tie on the asymmetry measure (they are
    # the same wavelet mirrored), so the argmin alone is numerically
    # unstable. Canonicalize: orient so the energy centroid sits at or left
    # of the midpoint, then sym2 reproduces db2 and sym4 matches the
    # published table up to this documented convention.
    idx = np.arange(len(best), dtype=float)
    if np.dot(best**2, idx) > (len(best) - 1) / 2:
        best = best[::-1].copy()
    return best


def _coif_moment_system(k_order, dtype=float):
    """Linear coiflet constraints as (A, b): sum h = sqrt(2), 2K vanishing
    wavelet moments and 2K-1 vanishing scaling moments about c = 4K-1,
    rows scaled to unit max coefficient."""
    L = 6 * k_order
    c = dtype(4 * k_order - 1)
    m = np.arange(L, dtype=dtype)
    sgn = (-np.ones(1, dtype)[0]) ** np.arange(L)
    rows, rhs = [np.ones(L, dtype)], [np.sqrt(dtype(2.0))]
    for p in range(2 * k_order):
        sc = max(np.max(np.abs((m - c) ** p)), dtype(1.0))
        rows.append(sgn * (m - c) ** p / sc)
        rhs.append(dtype(0.0))
    for p in range(1, 2 * k_order):
        sc = max(np.max(np.abs((m - c) ** p)), dtype(1.0))
        rows.append((m - c) ** p / sc)
        rhs.append(dtype(0.0))
    return np.stack(rows), np.asarray(rhs, dtype)


def _coif_orth_residual(h, k_order):
    """The 3K double-shift orthonormality conditions over the raw
    filter (shared by the null-space multistart and the branch
    continuation)."""
    L = 6 * k_order
    return np.asarray(
        [
            np.dot(h[: L - 2 * k], h[2 * k:]) - (1.0 if k == 0 else 0.0)
            for k in range(3 * k_order)
        ],
        h.dtype,
    )


def _coif_orth_jacobian(h, k_order):
    L = 6 * k_order
    rows = []
    for k in range(3 * k_order):
        row = np.zeros(L, h.dtype)
        row[: L - 2 * k] += h[2 * k:]
        row[2 * k:] += h[: L - 2 * k]
        rows.append(row)
    return np.stack(rows)


def _coif_full_residual(h, k_order, A, b):
    """Moment rows stacked with the orthonormality conditions — the
    complete coiflet system over the raw filter."""
    return np.concatenate([A @ h - b, _coif_orth_residual(h, k_order)])


def _coif_full_jacobian(h, k_order, A):
    return np.vstack([A, _coif_orth_jacobian(h, k_order)])


def _coif_continue(h_prev, k_order):
    """One branch-continuation step coif(K-1) -> coifK.

    Zero-padding coif(K-1) by (4, 2) keeps it exactly orthonormal, centers
    it at the new moment center 4K-1, and violates only the four new
    top-order moment rows — so full-space Levenberg-Marquardt on the
    combined (moment + orthonormality) system converges from there in a
    handful of steps, where the null-space multistart used for K <= 8
    stops finding roots around K ~ 9. A longdouble Gauss-Newton polish
    removes the double-precision normal-equation floor (residuals reach
    ~1e-16 for every K <= 17). The measured continuation steps shrink
    monotonically (max|h - h0|: 0.021 at K=9 down to <1e-3 by K=11), i.e.
    this tracks the single smooth branch the published family lies on."""
    K = k_order
    A, b = _coif_moment_system(K)
    h = np.concatenate([np.zeros(4), h_prev, np.zeros(2)])
    r = _coif_full_residual(h, K, A, b)
    cost = r @ r
    lam = 1e-8
    for _ in range(600):
        if np.max(np.abs(r)) < 1e-13:
            break
        J = _coif_full_jacobian(h, K, A)
        JtJ = J.T @ J
        g = J.T @ r
        for _ in range(60):
            try:
                step = np.linalg.solve(JtJ + lam * np.eye(len(h)), g)
            except np.linalg.LinAlgError:
                lam *= 10
                continue
            hn = h - step
            rn = _coif_full_residual(hn, K, A, b)
            cn = rn @ rn
            if cn < cost:
                h, r, cost = hn, rn, cn
                lam = max(lam * 0.3, 1e-16)
                break
            lam *= 10
        else:
            break
    Aq, bq = _coif_moment_system(K, np.longdouble)
    hq = h.astype(np.longdouble)
    for _ in range(60):
        r = _coif_full_residual(hq, K, Aq, bq)
        if np.max(np.abs(r)) < np.longdouble(1e-18):
            break
        J = _coif_full_jacobian(hq, K, Aq).astype(float)
        step, *_ = np.linalg.lstsq(J, r.astype(float), rcond=None)
        hq = hq - step.astype(np.longdouble)
    res = float(np.max(np.abs(_coif_full_residual(hq, K, Aq, bq))))
    if res > 1e-13:
        raise ValueError(f"coif{K} continuation did not converge ({res:.1e})")
    return hq.astype(float)


def _coiflet(k_order):
    """Coiflet (coifK) scaling filter, length 6K, K = 1..8.

    Construction (Daubechies 1992, ch. 8, done as exact linear algebra
    plus a tiny nonlinear solve): BOTH moment families are linear in h —
    sum h = sqrt(2), the 2K vanishing wavelet moments, and the 2K-1
    vanishing scaling-function moments about the center c = 4K-1 (the
    published filters' orientation; its mirror c = 2K is the time-reversed
    solution, and the "centroid" center 3K admits NO exact solution for
    K >= 3 — verified numerically, every solver bottoms out at a ~5e-8
    least-squares floor there). Parametrizing that affine subspace by its
    2K-dimensional null space leaves only the 3K orthonormality conditions:
    a small overdetermined-but-consistent quadratic system solved by
    multi-start Levenberg-Marquardt + Gauss-Newton polish to ~1e-14.
    Among the discrete solution set, the least phase-nonlinear root is
    selected (the same criterion as the symlet construction), which
    reproduces the published coif1 table exactly."""
    L = 6 * k_order
    A, b = _coif_moment_system(k_order)
    h_part, *_ = np.linalg.lstsq(A, b, rcond=None)
    if np.max(np.abs(A @ h_part - b)) > 1e-12:
        raise ValueError(f"coif{k_order}: moment system inconsistent")
    _, S, Vt = np.linalg.svd(A)
    B = Vt[np.sum(S > 1e-10):].T  # [L, 2K] null-space basis

    def orth_res(theta):
        return _coif_orth_residual(h_part + B @ theta, k_order)

    def orth_jac(theta):
        return _coif_orth_jacobian(h_part + B @ theta, k_order) @ B

    def lm(theta):
        lam = 1e-3
        r = orth_res(theta)
        cost = np.sum(r * r)
        for _ in range(300):
            if np.max(np.abs(r)) < 1e-14:
                break
            J = orth_jac(theta)
            JtJ = J.T @ J
            g = J.T @ r
            ok = False
            for _ in range(50):
                try:
                    step = np.linalg.solve(
                        JtJ + lam * np.diag(np.diag(JtJ) + 1e-14), g
                    )
                except np.linalg.LinAlgError:
                    lam *= 10
                    continue
                tn = theta - step
                rn = orth_res(tn)
                cn = np.sum(rn * rn)
                if cn < cost:
                    theta, r, cost = tn, rn, cn
                    lam = max(lam * 0.3, 1e-14)
                    ok = True
                    break
                lam *= 10
            if not ok:
                break
        # Gauss-Newton polish (quadratic near an exact root)
        for _ in range(20):
            r = orth_res(theta)
            if np.max(np.abs(r)) < 1e-14:
                break
            theta = theta - np.linalg.lstsq(orth_jac(theta), r, rcond=None)[0]
        return theta, np.max(np.abs(orth_res(theta)))

    def phase_score(h):
        omega = np.linspace(0.01, np.pi - 0.01, 256)
        resp = np.exp(-1j * np.outer(omega, np.arange(L))) @ h
        phase = np.unwrap(np.angle(resp))
        slope = np.dot(phase, omega) / np.dot(omega, omega)
        return np.sum((phase - slope * omega) ** 2)

    rng = np.random.default_rng(12345)
    roots = []
    for trial in range(3000):
        theta0 = rng.standard_normal(B.shape[1]) * (0.1 + 2.0 * trial / 3000)
        theta, res = lm(theta0)
        if res < 1e-12:
            h = h_part + B @ theta
            if not any(np.max(np.abs(h - r0)) < 1e-8 for r0 in roots):
                roots.append(h)
        if len(roots) >= 4 and trial > 200:
            break
        if roots and trial > 1200:
            break
    if not roots:
        raise ValueError(f"coif{k_order} construction did not converge")
    return min(roots, key=phase_score)


def _binom_filter(n):
    """Binomial (B-spline) coefficients C(n, k), k=0..n."""
    from math import comb

    return np.asarray([comb(n, k) for k in range(n + 1)], float)


def _bior_pair(nr, nd):
    """CDF spline biorthogonal lowpass pair (dec_lo, rec_lo) for
    ``biorNr.Nd`` (Cohen, Daubechies & Feauveau 1992).

    rec_lo is the order-``nr`` binomial spline filter; dec_lo is the dual
    filter sqrt(2) 2^-Nd (1+z)^Nd Q(y) with y = (2-z-z^-1)/4 and
    Q(y) = sum_{k<p} C(p-1+k, k) y^k, p = (Nr+Nd)/2 — the same maxflat
    half-band remainder as the Daubechies construction, split between the
    two sides instead of spectrally factored. Exact integer/binomial
    arithmetic; both filters are symmetric."""
    from math import comb

    if (nr + nd) % 2:
        raise ValueError("bior orders must share parity")
    p = (nr + nd) // 2
    rec = _binom_filter(nr) * (np.sqrt(2.0) / 2.0**nr)
    # Q(y) expanded in z: y = (2 - z - z^-1)/4 -> coefficient array of
    # [-1, 2, -1]/4 convolved k times (centered Laurent poly)
    q = np.zeros(1)
    q[0] = comb(p - 1, 0)
    y_poly = np.asarray([-1.0, 2.0, -1.0]) / 4.0
    y_pow = np.asarray([1.0])
    for k in range(1, p):
        y_pow = np.convolve(y_pow, y_poly)
        term = comb(p - 1 + k, k) * y_pow
        q_new = np.zeros(len(term))
        q_new[(len(term) - len(q)) // 2 : (len(term) - len(q)) // 2 + len(q)] = q
        q = q_new + term
    dec = np.convolve(_binom_filter(nd), q) * (np.sqrt(2.0) / 2.0**nd)
    return dec, rec


_BIOR_ORDERS = [
    (1, 1), (1, 3), (1, 5),
    (2, 2), (2, 4), (2, 6), (2, 8),
    (3, 1), (3, 3), (3, 5), (3, 7), (3, 9),
    (4, 4), (5, 5), (6, 8),
]

def _discrete_meyer(half=30, grid=1 << 16):
    """62-tap FIR approximation of the Meyer conjugate mirror filter.

    On [-pi, pi] the Meyer CMF is H(w) = sqrt(2) * phihat(2w) with the
    degree-7 auxiliary polynomial nu(x) = x^4 (35 - 84x + 70x^2 - 20x^3)
    (phihat(2(w + 2 pi k)) vanishes there for every k != 0, since
    phihat(2w) is supported on |w| <= 2pi/3). Sample H on a dense FFT
    grid, inverse-transform to the exactly symmetric integer-centered
    impulse response, keep the central ``2*half + 1`` taps, and prepend
    one zero so the length is even (the classical MATLAB/pywt ``dmey``
    construction — reference analog: pywt's precomputed dmey table used
    implicitly via `pywt.Wavelet` in scripts built on the reference).

    The truncation is the L2-optimal symmetric FIR and is numerically
    stationary for the orthonormality residual within the symmetric
    subspace, so no polish step can improve it without breaking the
    Meyer symmetry: double-shift orthogonality holds to ~8e-6 and one
    analysis/synthesis level reconstructs to ~4e-5 — the same order of
    approximation error the MATLAB/pywt dmey filter carries. Exact-PR
    workflows should prefer an orthogonal family (db/sym/coif)."""
    w = 2.0 * np.pi * np.fft.fftfreq(grid)
    aw = np.abs(2.0 * w)
    x = np.clip(3.0 * aw / (2.0 * np.pi) - 1.0, 0.0, 1.0)
    nu = x**4 * (35 - 84 * x + 70 * x**2 - 20 * x**3)
    H = np.sqrt(2.0) * np.where(
        aw <= 2 * np.pi / 3,
        1.0,
        np.where(aw <= 4 * np.pi / 3, np.cos(np.pi / 2 * nu), 0.0),
    )
    hf = np.fft.ifft(H).real  # symmetric about n = 0
    return np.concatenate([[0.0], hf[-half:], hf[: half + 1]])


_FILTER_CACHE = {}
_BANK_CACHE = {}


def scaling_filter(family):
    """Orthonormal scaling (low-pass) filter for ``dbN`` (N=1..20),
    ``symN`` (N=2..20), ``coifN`` (N=1..17, the full pywt range:
    null-space multistart up to K=8, branch continuation beyond) and
    ``dmey`` (62-tap discrete Meyer, near-orthonormal — see
    :func:`_discrete_meyer`), increasing-index convention,
    sum = sqrt(2). Biorthogonal families have two lowpass filters — use
    :func:`filter_bank` for those."""
    if family not in _FILTER_CACHE:
        if family == "dmey":
            _FILTER_CACHE[family] = _discrete_meyer()
            return _FILTER_CACHE[family]
        kind = family.rstrip("0123456789")
        num = family[len(kind):]
        if not num:
            raise ValueError(f"Unknown wavelet family {family}")
        n_moments = int(num)
        if kind == "db" and 1 <= n_moments <= 20:
            _FILTER_CACHE[family] = _daubechies(n_moments)
        elif kind == "sym" and 2 <= n_moments <= 20:
            _FILTER_CACHE[family] = _symlet(n_moments)
        elif kind == "coif" and 1 <= n_moments <= 8:
            _FILTER_CACHE[family] = _coiflet(n_moments)
        elif kind == "coif" and 9 <= n_moments <= 17:
            h = scaling_filter("coif8")
            for k in range(9, n_moments + 1):
                key = f"coif{k}"
                if key not in _FILTER_CACHE:
                    _FILTER_CACHE[key] = _coif_continue(h, k)
                h = _FILTER_CACHE[key]
        else:
            raise ValueError(f"Unknown wavelet family {family}")
    return _FILTER_CACHE[family]


def _parse_bior(family):
    kind = "rbio" if family.startswith("rbio") else "bior"
    try:
        nr, nd = family[len(kind):].split(".")
        nr, nd = int(nr), int(nd)
    except ValueError:
        raise ValueError(f"Unknown wavelet family {family}") from None
    if (nr, nd) not in _BIOR_ORDERS:
        raise ValueError(f"Unknown wavelet family {family}")
    return kind, nr, nd


def filter_bank(family):
    """(dec_lo, dec_hi, rec_lo, rec_hi) for any supported family.

    Orthogonal families (db/sym/coif) derive both banks from the scaling
    filter by quadrature mirror. Biorthogonal ``biorNr.Nd`` (and the
    reversed ``rbioNr.Nd``) use the CDF spline pair with the alignment
    rule derived from the exhaustive perfect-reconstruction search over
    (placement, sign, shift, reversal) conventions: center-align the two
    symmetric lowpass filters (the biorthogonality delta then sits on the
    even lattice), and build both highpass filters by alternating signs at
    a common extra shift whose parity equals the filter-length parity.
    Every bank is still PR-verified once at construction — a wrong
    convention cannot reconstruct. Tap shifts are linear within a padded
    buffer, never circular (a wrapped tap would land n-L samples away in
    signal space)."""
    if family in _BANK_CACHE:
        return _BANK_CACHE[family]
    if family.startswith(("bior", "rbio")):
        kind, nr, nd = _parse_bior(family)
        dec, rec = _bior_pair(nr, nd)
        if kind == "rbio":
            dec, rec = rec, dec
        o_d = 4 + max(0, -((len(dec) - len(rec)) // 2))
        o_rel = o_d + (len(dec) - len(rec)) // 2  # center alignment
        Lp = max(o_d + len(dec), o_rel + len(rec)) + 4
        Lp = Lp + (Lp % 2)

        def embed(f, off):
            out = np.zeros(Lp)
            out[off : off + len(f)] = f
            return out

        alt = np.where(np.arange(Lp) % 2 == 0, 1.0, -1.0)
        delta0 = -1 if len(dec) % 2 else -2

        # pure-numpy PR probe on the host, whatever device the bank serves
        def np_pr_err(bank, x):
            dlo, dhi, rlo, rhi = bank
            n = x.shape[0]
            taps = dlo.shape[0]
            g = (
                2 * np.arange(n // 2)[:, None] + np.arange(taps)[None, :]
            ) % n
            win = x[g]
            a, d = win @ dlo, win @ dhi
            up_a = np.zeros(n)
            up_a[::2] = a
            up_d = np.zeros(n)
            up_d[::2] = d
            xr = np.zeros(n)
            for m in range(taps):
                xr += rlo[m] * np.roll(up_a, m) + rhi[m] * np.roll(up_d, m)
            return np.max(np.abs(xr - x))

        rng = np.random.default_rng(0)
        x = rng.standard_normal(64)
        bank = None
        for j in range(4):
            delta = delta0 + 2 * j
            o1, o2 = o_rel + delta, o_d + delta
            if o1 < 0 or o2 < 0 or o1 + len(rec) > Lp or o2 + len(dec) > Lp:
                continue
            cand = (
                embed(dec, o_d),
                alt * embed(rec, o1),
                embed(rec, o_rel),
                alt * embed(dec, o2),
            )
            if np_pr_err(cand, x) < 1e-8:
                bank = cand
                break
        if bank is None:
            raise ValueError(
                f"{family}: perfect-reconstruction verification failed"
            )
        # trim the common zero padding (by an EVEN offset, preserving the
        # even/odd lattice alignment): dead taps would both inflate
        # max_dwt_level (shallower decompositions than pywt's
        # dwt_max_level) and waste a convolution multiply per zero tap
        nz = np.flatnonzero(np.any([np.abs(f) > 0 for f in bank], axis=0))
        lo_cut = (nz[0] // 2) * 2
        hi_cut = nz[-1] + 1 + ((nz[-1] + 1 - lo_cut) % 2)
        trimmed = tuple(f[lo_cut:hi_cut] for f in bank)
        if np_pr_err(trimmed, x) < 1e-8:
            bank = trimmed
        _BANK_CACHE[family] = bank
        return bank
    lo = np.asarray(scaling_filter(family))
    hi = lo[::-1] * np.where(np.arange(len(lo)) % 2 == 0, 1.0, -1.0)
    bank = (lo, hi, lo, hi)
    _BANK_CACHE[family] = bank
    return bank




def _filters_as(x, *filters):
    return [torch.as_tensor(np.asarray(f), dtype=x.dtype, device=x.device) for f in filters]


def _dwt_per_bank(x, bank):
    """One periodized analysis level with an explicit (dec_lo, dec_hi)
    pair -> (approx, detail), over the last axis of x [..., n]."""
    x = as_tensor(x)
    dec_lo, dec_hi = _filters_as(x, bank[0], bank[1])
    n = x.shape[-1]
    if n % 2 == 1:
        x = torch.cat([x, x[..., -1:]], -1)
        n += 1
    taps = dec_lo.shape[0]
    idx = torch.arange(n // 2, device=x.device)
    gather = (2 * idx[:, None] + torch.arange(taps, device=x.device)[None, :]) % n
    windows = x[..., gather]  # [..., n/2, taps]
    with full_float32():
        return windows @ dec_lo, windows @ dec_hi


def _idwt_per_bank(ca, cd, bank):
    """Periodized synthesis with an explicit (rec_lo, rec_hi) pair, over the
    last axis of ca, cd [..., n/2]."""
    ca = as_tensor(ca)
    cd = _place(cd, None, ca).to(device=ca.device, dtype=ca.dtype)
    rec_lo, rec_hi = _filters_as(ca, bank[2], bank[3])
    n = 2 * ca.shape[-1]
    up_a = torch.zeros((*ca.shape[:-1], n), dtype=ca.dtype, device=ca.device)
    up_d = torch.zeros_like(up_a)
    up_a[..., ::2] = ca
    up_d[..., ::2] = cd
    taps = rec_lo.shape[0]
    # rolled[..., i, m] = up[..., (i - m) mod n], as jnp.roll(up, m); the
    # taps last, so each output is one dot product whatever the batch
    src = (torch.arange(n, device=ca.device)[:, None]
           - torch.arange(taps, device=ca.device)[None, :]) % n
    with full_float32():
        return up_a[..., src] @ rec_lo + up_d[..., src] @ rec_hi


def _quadrature_mirror(lo):
    """High-pass filter g[m] = (-1)^m lo[L-1-m] from the low-pass."""
    lo = np.asarray(lo)
    return lo[::-1] * np.where(np.arange(lo.shape[0]) % 2 == 0, 1.0, -1.0)


def dwt_per(x, lo, *, device=None):
    """One periodized orthogonal analysis level -> (approx, detail).

    a[k] = sum_m lo[m] x[(2k+m) mod n], expressed as a circular gather +
    two small matvecs over the last axis. Odd lengths are extended by
    repeating the last sample (periodization). The phase convention may
    differ from pywt "per" by a circular shift, which idwt_per inverts
    exactly and thresholding is insensitive to.
    """
    lo = _host_filter(lo)
    return _dwt_per_bank(as_tensor(x, device), (lo, _quadrature_mirror(lo), lo, None))


def idwt_per(ca, cd, lo, *, device=None):
    """Periodized orthogonal synthesis (exact inverse of dwt_per):
    x = circconv(upsample(ca), lo) + circconv(upsample(cd), hi)."""
    lo = _host_filter(lo)
    return _idwt_per_bank(as_tensor(ca, device), cd, (lo, None, lo, _quadrature_mirror(lo)))


def _host_filter(f):
    """A filter given as a tensor or an array-like, as a numpy array."""
    if isinstance(f, torch.Tensor):
        return f.detach().cpu().numpy()
    return np.asarray(f)


def max_dwt_level(n, taps):
    """pywt.dwt_max_level parity: floor(log2(n / (taps - 1)))."""
    if taps <= 2:
        return max(int(np.log2(max(n, 1))), 1)
    return max(int(np.log2(max(n // (taps - 1), 1))), 1)


def wavedec(x, family="db4", level=None, *, device=None):
    """Multi-level periodized DWT over the last axis -> [cA_n, cD_n, ...,
    cD_1].

    Supports orthogonal (db1-20, sym2-20, coif1-17, dmey) and biorthogonal
    (biorNr.Nd / rbioNr.Nd) families.
    """
    bank = filter_bank(family)
    x = as_tensor(x, device)
    n = x.shape[-1]
    if level is None:
        level = max_dwt_level(n, len(bank[0]))
    coefs = []
    approx = x
    for _ in range(level):
        if approx.shape[-1] < 2:
            break
        approx, detail = _dwt_per_bank(approx, bank)
        coefs.append(detail)
    coefs.append(approx)
    return coefs[::-1]


def waverec(coefs, family="db4", *, device=None):
    """Inverse of wavedec."""
    bank = filter_bank(family)
    approx = as_tensor(coefs[0], device)
    for detail in coefs[1:]:
        detail = _place(detail, None, approx)
        approx = _idwt_per_bank(approx[..., : detail.shape[-1]], detail, bank)
    return approx


def soft_threshold(x, value, *, device=None):
    """sign(x) * max(|x| - value, 0). A tensor ``value`` of a wider dtype
    widens the result, as a float64 array does in JAX (torch would keep a
    0-d value's dtype out of the promotion); a Python number keeps x's."""
    x = as_tensor(x, device)
    if isinstance(value, torch.Tensor):
        x = x.to(torch.promote_types(x.dtype, value.dtype))
        value = value.to(x.device)
    return torch.sign(x) * torch.clamp(torch.abs(x) - value, min=0.0)


def dwt_denoise(x, threshold, family="db4", level=None, detrend=False, *, device=None):
    """Soft-threshold DWT denoising over the last axis (reference
    timefrequency.py:151-159). Zeroing the approximation band (detrend)
    removes the trend component. ``threshold`` is a number, or a tensor
    that broadcasts against each band (one value a row: shape [..., 1])."""
    x = as_tensor(x, device)
    coefs = wavedec(x, family, level)
    approx = torch.zeros_like(coefs[0]) if detrend else coefs[0]
    details = [soft_threshold(c, threshold) for c in coefs[1:]]
    return waverec([approx] + details, family)[..., : x.shape[-1]]
