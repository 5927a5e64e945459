"""The normalization kernel's envelope, rehearsed on the CPU.

N1 (``csrc/amfm.cu``) builds each pass's envelope of |F| its own way:
- the maxima from one sweep (a sample above both neighbours) wherever no
  two neighbours tie or are unordered, else S1's plateau pass;
- S1's knots (the interior maxima, odd-reflected by ``pad_width`` about
  t[0] and t[N-1]);
- a system of more than 64 valid rows solved block-wide: parallel cyclic
  reduction over the ``cnt`` valid rows only, a row a thread (two past 512
  rows), each level reading the other buffer's rows (a neighbour out of
  range an identity row), and one barrier a level, whose vote (float32,
  from the fifth level on) ends the levels once every valid row has a = c
  = 0 with b finite and nonzero and d finite, where ``pad_width >= 1`` and
  t rises strictly;
- the knots' derivatives d / b packed with the knots into records (time,
  value, derivative), and the Hermite evaluation at every sample from them.

Numpy replays each, one operation at a time in the kernel's order (numpy
rounds every operation on its own, as ``__*_rn`` do; the kernel's
quotients are the correctly rounded ones, held against ``__fdiv_rn`` and
``__ddiv_rn`` on the card), and the replayed envelope must equal the plain
version's (``ops/emd.py::upper_envelope``, whose solve runs every level
over the whole capacity) to the bit pattern (integer views: signed zeros
count), at 33, 65, 263 and 708 valid knots in both dtypes, with half the
maxima at exactly 1 (as after a pass: zero slopes, zero right-hand sides),
and on |F| of config 9's rows after a plain pass. The levels that the
early end drops leave the derivatives' bits but for the sign of a zero,
which is checked too. The levels that ``chip_smoke.py``'s bound counts
for N1 (read off the plain solve's rows) are held to the replay's. No
line of CUDA runs here: the kernel is held
against the plain version on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py`` phase 24).
"""

import numpy as np
import pytest
import torch

from chip_smoke import c9_series, envelope_counts, pcr_levels
from periodicity_tpu_torch.ops import emd, peaks
from test_torch_sift_lanes import _identity, _level, _same_bits, _spline_rows

DTYPES = [np.float32, np.float64]
N = 2048
PAD = 2


def _untied_maxima(x):
    """amfm.cu::maxima_untied: the samples 1 <= i <= n-2 above both
    neighbours, and whether two neighbours tie or are unordered."""
    tie = not bool(np.all((x[:-1] < x[1:]) | (x[:-1] > x[1:])))
    mask = np.zeros(x.shape[0], bool)
    mask[1:-1] = (x[1:-1] > x[:-2]) & (x[1:-1] > x[2:])
    return mask, tie


def _knots(t, x, mask, pad):
    """envelope.cuh::place_knots: interior maximum j at slot pad + j, the
    first pad reflected about t[0], the last pad about t[N-1]."""
    dt = x.dtype.type
    idx = np.nonzero(mask)[0]
    n_int = idx.shape[0]
    cnt = n_int + 2 * pad
    pt, pv = np.zeros(cnt, x.dtype), np.zeros(cnt, x.dtype)
    pt[pad:pad + n_int], pv[pad:pad + n_int] = t[idx], x[idx]
    for jx in range(n_int):
        if jx < pad:
            pt[pad - 1 - jx], pv[pad - 1 - jx] = dt(2) * t[0] - t[idx[jx]], x[idx[jx]]
        if jx >= n_int - pad:
            s = 2 * n_int + pad - 1 - jx
            pt[s], pv[s] = dt(2) * t[-1] - t[idx[jx]], x[idx[jx]]
    return pt, pv, cnt


def _solve_block(rows, cnt, may_end):
    """amfm.cu::solve_block: the levels over the valid rows, each from the
    other buffer's rows, the vote after each (float32, from the fifth level
    on) ending them where no row is live. Returns the derivatives d / b and
    the levels run."""
    r = tuple(v[:cnt].copy() for v in rows)
    dtype = r[0].dtype
    i = np.arange(cnt)
    idn = _identity(dtype, cnt)
    s, levels = 1, 0
    while s < cnt:
        u = tuple(np.where(i >= s, v[np.maximum(i - s, 0)], f) for v, f in zip(r, idn))
        n = tuple(np.where(i + s < cnt, v[np.minimum(i + s, cnt - 1)], f) for v, f in zip(r, idn))
        r = _level(r, u, n)
        levels += 1
        s *= 2
        # the vote: float32 from the fifth level on, float64 never
        if dtype == np.float32 and s > 16:
            a, b, c, d = r
            live = (a != 0) | (c != 0) | ~(np.isfinite(b) & (b != 0) & np.isfinite(d))
            if may_end and not live.any():
                break
    return r[3] / r[1], levels


def _hermite(t, pt, pv, deriv, mask, pad, cnt):
    """amfm.cu::divide's envelope: each sample's interval from the running
    count, its knot records, envelope.cuh's Hermite form."""
    dt = t.dtype.type
    hi = pad + np.cumsum(mask)
    j = np.clip(hi - 1, 0, cnt - 2)
    x0, x1, y0, y1, s0, s1 = pt[j], pt[j + 1], pv[j], pv[j + 1], deriv[j], deriv[j + 1]
    h = x1 - x0
    u = (t - x0) / h
    omu = dt(1) - u
    omu2 = omu * omu
    h00 = (dt(1) + dt(2) * u) * omu2
    h10 = u * omu2
    uu = u * u
    h01 = uu * (dt(3) - dt(2) * u)
    h11 = uu * (u - dt(1))
    return ((h00 * y0 + (h10 * h) * s0) + h01 * y1) + (h11 * h) * s1


def _replay(t, x, pad=PAD):
    """N1's envelope of x = |F| on t, where its block solve takes it:
    (envelope, levels run, valid knots, derivatives, derivatives after
    every level)."""
    mask, tie = _untied_maxima(x)
    assert not tie
    pt, pv, cnt = _knots(t, x, mask, pad)
    rows = _spline_rows(pt, pv, cnt, cnt)
    may_end = pad >= 1 and bool(np.all(t[1:] > t[:-1]))
    deriv, levels = _solve_block(rows, cnt, may_end)
    full, _ = _solve_block(rows, cnt, False)
    return _hermite(t, pt, pv, deriv, mask, pad, cnt), levels, cnt, deriv, full


def _peaks_series(m, dtype, seed):
    """|F|-like samples on config 9's grid with exactly m interior maxima
    (samples 1, 3, .., 2m - 1), the first half of them exactly 1 (zero slopes
    between them), and no ties."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 20.0, N).astype(dtype)
    x = np.empty(N)
    x[:2 * m + 1:2] = rng.uniform(0.05, 0.45, m + 1)
    peaks_ = rng.uniform(0.55, 0.99, m)
    peaks_[: m // 2] = 1.0
    x[1:2 * m:2] = peaks_
    # a falling tail, below every trough, so that no maximum follows
    x[2 * m + 1:] = np.linspace(0.04, 0.001, N - 2 * m - 1)
    return t, x.astype(dtype)


def _plain(t, x, pad=PAD):
    return emd.upper_envelope(torch.from_numpy(t), torch.from_numpy(x), pad_width=pad).numpy()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("knots", [33, 65, 263, 708])
def test_block_solve_envelope_is_the_plain_envelope(knots, dtype):
    t, x = _peaks_series(knots - 2 * PAD, dtype, seed=knots)
    env, levels, cnt, deriv, full = _replay(t, x)
    assert cnt == knots
    assert _same_bits(env, _plain(t, x))
    # the levels the vote drops change no derivative but a zero's sign
    same = deriv.view(np.int64 if dtype == np.float64 else np.int32) == \
        full.view(np.int64 if dtype == np.float64 else np.int32)
    assert np.all(same | ((deriv == 0) & (full == 0)))
    if dtype == np.float32 and knots >= 263:
        # the couplings underflow before the last level, so the vote ends them
        assert levels < pcr_levels(cnt)


@pytest.mark.parametrize("dtype", DTYPES)
def test_real_rows_after_a_pass(dtype):
    """|F| of config 9's B = 8 series (as rows) after one plain pass: most
    maxima are exactly 1 there; the replay equals the plain envelope on
    every row the block solve takes."""
    t9, c9 = c9_series()
    t = t9.astype(dtype)
    X = torch.from_numpy(c9[8][:4].astype(dtype))
    # F after the first pass, unclipped (the kernel's working F)
    F = X / emd.upper_envelope(torch.from_numpy(t), X.abs(), pad_width=PAD)
    taken = 0
    for row in np.abs(F.numpy()):
        mask, tie = _untied_maxima(row)
        if tie or mask.sum() + 2 * PAD <= 64:
            continue
        env, _, _, _, _ = _replay(t, row)
        assert _same_bits(env, _plain(t, row))
        taken += 1
    assert taken >= 2


@pytest.mark.parametrize("dtype", DTYPES)
def test_untied_sweep_is_the_plateau_rule(dtype):
    """Where no neighbours tie the one-sweep maxima are scipy's plateau
    rule's (ops/peaks.py::local_maxima_mask); plateaus and NaNs are seen as
    ties, where the kernel runs the plateau pass instead."""
    rng = np.random.default_rng(7)
    for _ in range(20):
        x = rng.standard_normal(257).astype(dtype)
        mask, tie = _untied_maxima(x)
        assert not tie
        assert np.array_equal(mask, peaks.local_maxima_mask(torch.from_numpy(x)).numpy())
    x = rng.standard_normal(64).astype(dtype)
    x[10] = x[11]
    assert _untied_maxima(x)[1]
    x = rng.standard_normal(64).astype(dtype)
    x[20] = np.nan
    assert _untied_maxima(x)[1]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("knots", [33, 65, 263, 708])
def test_bound_counts_the_levels_the_kernel_runs(knots, dtype):
    """chip_smoke.py's N1 bound counts the PCR levels the block solve runs
    (envelope_counts(levels=True), from the plain solve's rows): the
    replay's, fewer than ceil(log2 cnt) where float32 couplings underflow."""
    t, x = _peaks_series(knots - 2 * PAD, dtype, seed=knots)
    _, levels, cnt, _, _ = _replay(t, x)
    with envelope_counts(levels=True) as calls:
        emd.upper_envelope(torch.from_numpy(t), torch.from_numpy(x)[None], pad_width=PAD)
    assert [c.tolist() for c in calls] == [[[cnt, levels]]]


def test_bound_levels_on_real_rows():
    """The same, row by row, for |F| of config 9's B = 8 series after one
    plain float32 pass, recorded in one batched call."""
    t9, c9 = c9_series()
    t = torch.from_numpy(t9)
    X = torch.from_numpy(c9[8][:4])
    absF = (X / emd.upper_envelope(t, X.abs(), pad_width=PAD)).abs()
    with envelope_counts(levels=True) as calls:
        emd.upper_envelope(t, absF, pad_width=PAD)
    (got,) = calls
    for row, (cnt, levels) in zip(absF.numpy(), got.tolist()):
        mask, tie = _untied_maxima(row)
        assert not tie and cnt == mask.sum() + 2 * PAD
        assert levels == _replay(t9, row)[1]
