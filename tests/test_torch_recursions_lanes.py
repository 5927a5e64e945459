"""The designs of the two recursion kernels (``csrc/recursions.cu``),
replayed in numpy and Python on the CPU.

R1, the cascaded biquad filter, runs as a systolic cascade: lane s of a
row's group takes step t - lag s at tick t, its input lane s - 1's output
of that step. The replay follows the kernel's tick schedule (the shuffle
of the tick before, the lanes' delay lines, the ramps at both ends where a
lane leaves its state alone) and must give ``sosfilt_plain``'s bits.

R2, the pentadiagonal solve, accepts a refined quotient q of a / d only
where its residual proves q correctly rounded (``rn::Checked`` in
``csrc/rn.cuh``). The replay computes that rule with exact rationals and
the working type's rounding: it accepts the correctly rounded quotient,
and never a quotient one unit off on either side.
"""

import math
from fractions import Fraction

import numpy as np
import pytest
import torch

from periodicity_tpu_torch.ops import filters

# -- R1 -----------------------------------------------------------------------


def _width(ns):
    return 1 << (ns - 1).bit_length()


def _systolic(coef, x, zi, lag):
    """The kernel's schedule: W lanes a row, lane s holding section s;
    at tick t every lane receives the output its left neighbour made at
    tick t - 1 and uses what it received lag - 1 ticks before."""
    rows, n = x.shape
    ns = coef.shape[0]
    w = _width(ns)
    zero = x.dtype.type(0)
    sec = [tuple(coef[s]) if s < ns else (zero,) * 5 for s in range(w)]
    y = np.zeros_like(x)
    zf = np.empty_like(zi)
    shift = (ns - 1) * lag
    for r in range(rows):
        state = [tuple(zi[r, s]) if s < ns else (zero, zero) for s in range(w)]
        last = [zero] * w
        held = [[zero] * lag for _ in range(w)]
        for t in range(n + shift if n else 0):
            got = [last[s - 1] if s else last[0] for s in range(w)]
            for s in range(w):
                held[s] = held[s][1:] + [got[s]]
            for s in range(w):
                b0, b1, b2, a1, a2 = sec[s]
                z0, z1 = state[s]
                v = (x[r, t] if t < n else zero) if s == 0 else held[s][0]
                out = b0 * v + z0
                if 0 <= t - s * lag < n:
                    state[s] = (b1 * v - a1 * out + z1, b2 * v - a2 * out)
                last[s] = out
                if s == ns - 1 and 0 <= t - shift < n:
                    y[r, t - shift] = out
        zf[r] = state[:ns]
    return y, zf


def _sections(ns, rng):
    if ns == 5:  # the GP prior's band (order 5, bandpass)
        return filters.butter_sos(5, [0.02, 0.4], "bandpass")
    out = []
    for _ in range(ns):
        radius, theta = rng.uniform(0.3, 0.95), rng.uniform(0.1, 3.0)
        out.append([*rng.standard_normal(3), 1.0, -2 * radius * np.cos(theta), radius ** 2])
    return np.array(out)


@pytest.mark.parametrize("lag", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ns", [1, 5, 16])
def test_systolic_schedule_is_sosfilt_plain(ns, dtype, lag):
    rng = np.random.default_rng(ns)
    sos = _sections(ns, rng)
    coef = filters._coefficients(sos, dtype)
    np_t = np.float64 if dtype == torch.float64 else np.float32
    for n, rows in sorted({(0, 1), (1, 2), (3, 1), (max(ns - 1, 1), 1), (ns + 1, 2), (37, 2)}):
        x = rng.standard_normal((rows, n)).astype(np_t)
        zi = rng.standard_normal((rows, ns, 2)).astype(np_t)
        y, zf = _systolic(coef, x, zi, lag)
        yp, zp = filters.sosfilt_plain(sos, torch.from_numpy(x), torch.from_numpy(zi))
        assert np.array_equal(y, yp.numpy()) and np.array_equal(zf, zp.numpy()), (n, rows)


# -- R2's quotient ------------------------------------------------------------

# fraction bits, exponent bias, and the window of rn::Checked: d with its
# exponent in [-kD, kD], q in [-kQ, kQ]
_TYPES = {np.float32: (23, 127, 33, 67, np.uint32), np.float64: (52, 1023, 300, 601, np.uint64)}


def _bits(v, t):
    return int(np.array(v, t).view(_TYPES[t][4]))


def _of(u, t):
    return t(np.array(u, _TYPES[t][4]).view(t))


def _rn(x, t):
    """The rational x rounded to nearest-even in t (normal range)."""
    p = _TYPES[t][0]
    if x == 0:
        return t(0)
    e = math.floor(math.log2(abs(x)))
    while abs(x) >= Fraction(2) ** (e + 1):
        e += 1
    while abs(x) < Fraction(2) ** e:
        e -= 1
    return t(math.ldexp(round(x / Fraction(2) ** (e - p)), e - p))


def _exponent(v, t):
    p, bias = _TYPES[t][:2]
    return ((_bits(v, t) >> p) & ((1 << (_TYPES[t][4]().nbytes * 8 - 1 - p)) - 1)) - bias


def _accepts(a, d, q, t):
    """rn::Checked<t>: d and q inside the window, and the residual
    fma(-q, d, a), rounded once in t, strictly under |d| times half an ulp
    of q (2^(e - p - 1), from q's exponent e), that product rounded in t."""
    p, _, kd, kq, _ = _TYPES[t]
    if not (abs(_exponent(d, t)) <= kd and abs(_exponent(q, t)) <= kq):
        return False
    rem = _rn(Fraction(float(a)) - Fraction(float(q)) * Fraction(float(d)), t)
    half = t(2.0 ** (_exponent(q, t) - p - 1))
    return bool(abs(rem) < t(abs(d) * half))


def _neighbours(q, t):
    return np.nextafter(q, t(np.inf)), np.nextafter(q, t(-np.inf))


def _windowed(rng, t, size, span):
    p, bias = _TYPES[t][:2]
    frac = rng.integers(0, 1 << p, size, dtype=np.uint64)
    exp = rng.integers(bias - span, bias + span + 1, size).astype(np.uint64)
    sign = rng.integers(0, 2, size).astype(np.uint64) << np.uint64(_TYPES[t][4]().nbytes * 8 - 1)
    return [_of(int(s | e << np.uint64(p) | f), t) for s, e, f in zip(sign, exp, frac)]


@pytest.mark.parametrize("t", [np.float32, np.float64])
def test_quotient_rule_accepts_only_the_rounded_quotient(t):
    rng = np.random.default_rng(17)
    span = _TYPES[t][2]
    accepted = 0
    for a, d in zip(_windowed(rng, t, 300, span), _windowed(rng, t, 300, span)):
        q = _rn(Fraction(float(a)) / Fraction(float(d)), t)
        accepted += _accepts(a, d, q, t)
        assert not any(_accepts(a, d, v, t) for v in _neighbours(q, t)), (a, d)
    assert accepted >= 295


@pytest.mark.parametrize("t", [np.float32, np.float64])
def test_quotient_rule_at_binade_edges(t):
    """Divisors 2^k, 2^k (1 + 2^-p), 2^k (1 + 2^(1-p)) and, below the edge,
    2^k (1 - 2^-(p+1)), 2^k (1 - 2^-p), 2^k (1 - 2^(3-p)) under a = +-1, a
    = +-2^j (quotients at powers of two) and random numerators: the rounded
    quotient passes under a = +-1, its neighbours never. Quotients next to a
    power of two are where the binade below is twice as fine."""
    rng = np.random.default_rng(3)
    numerators = [t(1), t(-1), t(2.0 ** 7), t(-(2.0 ** -9)), *_windowed(rng, t, 4, 20)]
    for k in (-30, -4, 0, 4, 29):
        edge = _bits(t(2.0 ** k), t)
        for ulps in (0, 1, 2, -1, -2, -16):
            d = _of(edge + ulps, t)
            for a in numerators:
                q = _rn(Fraction(float(a)) / Fraction(float(d)), t)
                assert not any(_accepts(a, d, v, t) for v in _neighbours(q, t)), (a, d)
                if ulps in (0, 1, -1) and abs(a) == 1:
                    assert _accepts(a, d, q, t), (a, d, q)


def test_quotient_rule_on_one_over_sixteen_minus_two_to_minus_49():
    """1 / (16 - 2^-49) rounds up to 2^-4 (1 + 2^-52), a hair under half an
    ulp from it; a refinement on the card once gave 2^-4, one unit off."""
    d = 16.0 - 2.0 ** -49
    q = _rn(Fraction(1) / Fraction(d), np.float64)
    assert q == 2.0 ** -4 * (1 + 2.0 ** -52)
    assert _accepts(1.0, d, q, np.float64)
    assert not _accepts(1.0, d, 2.0 ** -4, np.float64)
    assert not _accepts(1.0, d, np.nextafter(q, np.inf), np.float64)


@pytest.mark.parametrize("t", [np.float32, np.float64])
def test_quotient_rule_stays_in_its_window(t):
    """Outside the window (a divisor past 2^kD, a subnormal or zero
    quotient) the rule accepts nothing, even the exact quotient: the kernel
    divides. At the window's edges it still accepts."""
    kd = _TYPES[t][2]
    tiny = _of(1, t)  # the smallest subnormal
    assert not _accepts(tiny, t(1), tiny, t)
    assert not _accepts(t(0), t(3), t(0), t)
    big = t(2.0 ** (kd + 1))
    assert not _accepts(big * t(3), big, t(3), t)
    edge = t(2.0 ** kd)
    assert _accepts(edge * t(3), edge, t(3), t)
    assert _accepts(t(2.0 ** kd), t(1.5), _rn(Fraction(2 ** kd) / Fraction(3, 2), t), t)
