"""The sift kernel's envelope solve, rehearsed on the CPU.

S1 (``csrc/sift.cu``) and N1 (``csrc/amfm.cu``) solve each envelope's
masked not-a-knot system (``csrc/envelope.cuh``) over its ``cnt`` valid
knots only, where the plain version (``ops/spline.py::spline_derivatives``
with ``count``) runs parallel cyclic reduction over the whole capacity K:
ceil(log2 cnt) levels over rows 0 .. cnt - 1, a neighbour past cnt read as
an identity row, as one out of range. Where every envelope has at most 64
valid knots one warp solves it in registers: lane l holds rows l + 32 h (one
row a lane up to 32, two up to 64), builds them itself, and takes row
i -+ s from lane (l -+ s) mod 32 by shuffles. Larger systems run on a group
of warps an envelope, a row a thread, through shared memory: each row's
level in the same operand order, which the count-bounded replay is. Numpy
replays both, one operation at a time in the kernel's order (numpy rounds
every operation on its own, as ``__*_rn`` do; the kernel's float32 fast
division is the correctly rounded quotient too, held against ``__fdiv_rn``
on the card), on the rows the plain version builds, and each replay must
equal the plain full-capacity solve to the bit pattern (integer views:
signed zeros count): valid counts 4 .. K in both dtypes, flat and half-flat
values (zero derivatives), zero values, and the systems of real sifts at
config 9's shape cut to N = 256 with pad widths 1 to 3. The kernel's row
builder is replayed too. These tests check the design's operation order,
not the kernels: no line of CUDA runs here. The kernels are held against
the plain versions to the bit pattern on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py`` phases 21 and 24).
"""

import numpy as np
import pytest
import torch

from chip_smoke import pcr_levels, sift_chain_ops
from periodicity_tpu_torch.ops import emd, spline

DTYPES = [np.float32, np.float64]
WARP_ROWS = 64  # envelope.cuh's kWarpRows
N = 2048
PAD = 2
K = N // 2 + 4 + 2 * PAD  # the sift's capacity at config 9's length
COUNTS = [4, 5, 31, 32, 33, 63, 64, 65, 200, K - 4, K - 1, K]
KINDS = ["random", "flat", "half flat", "zero"]


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    view = np.int64 if a.dtype == np.float64 else np.int32
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a.view(view),
                                                                        b.view(view))


def _capture(fn):
    """Run fn with spline._solve_tridiag recording every system it solves:
    returns [(lower, diag, upper, rhs, plain derivatives)], [..., K] each."""
    systems = []
    solve = spline._solve_tridiag

    def recording(lower, diag, upper, rhs):
        out = solve(lower, diag, upper, rhs)
        systems.append(tuple(v.numpy() for v in (lower, diag, upper, rhs, out)))
        return out

    spline._solve_tridiag = recording
    try:
        fn()
    finally:
        spline._solve_tridiag = solve
    return systems


def _rows(systems):
    """Each system as (a, b, c, d, count, plain derivatives) [K]: a[0] and
    c[K-1] zero as PCR reads them, the count from the last row that is not
    an identity row (row count - 1 has lower = x[c-1] - x[c-3] > 0)."""
    out = []
    for lower, diag, upper, rhs, s in systems:
        k = diag.shape[-1]
        for lo, di, up, rh, sd in zip(*(v.reshape(-1, k) for v in (lower, diag, upper, rhs, s))):
            a = lo.copy()
            a[0] = 0
            c = up.copy()
            c[-1] = 0
            cnt = int(np.nonzero(lo)[0].max()) + 1
            out.append((a, di, c, rh, cnt, sd))
    return out


def _draw(dtype, kind, counts, seed):
    """Knots [S, K] with counts[j] valid ones (strictly increasing times
    past the count too, as the capacity buffers hold), and the plain
    solve's systems."""
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.uniform(0.2, 1.5, (len(counts), K)), -1).astype(dtype)
    y = rng.standard_normal((len(counts), K)).astype(dtype)
    if kind == "flat":
        y[:] = dtype(0.75)
    elif kind == "half flat":
        y[:, : K // 2] = dtype(-0.5)
        y[1::2, :] = dtype(-0.5)  # every other system wholly flat
    elif kind == "zero":
        y[:] = 0
    cnt = torch.tensor(counts)
    return _rows(_capture(lambda: spline.spline_derivatives(torch.from_numpy(x),
                                                            torch.from_numpy(y), count=cnt))), x, y


def _level(r, u, n):
    """envelope.cuh::pcr_level on numpy arrays: (a, b, c, d) of the rows and
    of their neighbours i - s (u) and i + s (n)."""
    a, b, c, d = r
    alpha = -a / u[1]
    beta = -c / n[1]
    return (alpha * u[0], (b + alpha * u[2]) + beta * n[0], beta * n[2],
            (d + alpha * u[3]) + beta * n[3])


def _identity(dtype, m):
    return (np.zeros(m, dtype), np.ones(m, dtype), np.zeros(m, dtype), np.zeros(m, dtype))


def _bounded(a, b, c, d, cnt):
    """PCR over rows 0 .. cnt - 1 only, as envelope.cuh::solve_groups runs
    it (each level's rows from the other buffer's)."""
    r = tuple(v[:cnt].copy() for v in (a, b, c, d))
    levels = 0
    s = 1
    while s < cnt:
        i = np.arange(cnt)
        idn = _identity(a.dtype, cnt)
        up, dn = i >= s, i + s < cnt
        u = tuple(np.where(up, v[np.maximum(i - s, 0)], f) for v, f in zip(r, idn))
        n = tuple(np.where(dn, v[np.minimum(i + s, cnt - 1)], f) for v, f in zip(r, idn))
        r = _level(r, u, n)
        s *= 2
        levels += 1
    assert levels == pcr_levels(cnt)
    return r[3] / r[1]


def _warp(a, b, c, d, cnt):
    """envelope.cuh::solve_warp lane by lane: one row a lane up to 32 rows,
    two up to 64; reg[h][l] holds row l + 32 h (rows past cnt identity
    rows, never updated), a shuffle from lane j reads reg[h][j]."""
    assert 4 <= cnt <= WARP_ROWS
    rl = 1 if cnt <= 32 else 2
    lane = np.arange(32)
    idn = _identity(a.dtype, 32)
    reg = []
    for h in range(rl):
        row = lane + 32 * h
        valid = row < cnt
        reg.append(tuple(np.where(valid, v[np.minimum(row, cnt - 1)], f)
                         for v, f in zip((a, b, c, d), idn)))
    st = 1
    while st < cnt:
        if st < 32:
            lu, ln = (lane - st) & 31, (lane + st) & 31
            p = [tuple(v[lu] for v in r) for r in reg]
            q = [tuple(v[ln] for v in r) for r in reg]
            lo, hi = lane >= st, lane + st < 32
            u = [tuple(np.where(lo, x, y) for x, y in zip(p[h], p[h - 1] if h > 0 else idn))
                 for h in range(rl)]
            n = [tuple(np.where(hi, x, y) for x, y in zip(q[h], q[h + 1] if h + 1 < rl else idn))
                 for h in range(rl)]
        else:
            u = [reg[h - 1] if h > 0 else idn for h in range(rl)]
            n = [reg[h + 1] if h + 1 < rl else idn for h in range(rl)]
        new = [_level(reg[h], u[h], n[h]) for h in range(rl)]
        reg = [tuple(np.where(lane + 32 * h < cnt, v, w) for v, w in zip(new[h], reg[h]))
               for h in range(rl)]
        st *= 2
    s = np.concatenate([r[3] / r[1] for r in reg])
    return s[:cnt]


def _spline_rows(x, y, cnt, k):
    """envelope.cuh's rows (first_row, last_row, interior_row) for the valid
    rows 0 .. cnt - 1, as numpy scalars of the knots' dtype."""
    dt = x.dtype.type
    a, b, c, d = (np.zeros(cnt, x.dtype) for _ in range(4))
    for i in range(cnt):
        if i == cnt - 1:
            dx_l, dx_m = x[i] - x[i - 1], x[i - 1] - x[i - 2]
            sl_l, sl_m = (y[i] - y[i - 1]) / dx_l, (y[i - 1] - y[i - 2]) / dx_m
            dn = x[i] - x[i - 2]
            rhs = ((dx_l * dx_l) * sl_m + (((dt(2) * dn) + dx_l) * dx_m) * sl_l) / dn
            row = (dn, dx_m, dt(0), rhs)
        elif i == 0:
            dx0, dx1 = x[1] - x[0], x[2] - x[1]
            s0, s1 = (y[1] - y[0]) / dx0, (y[2] - y[1]) / dx1
            d0 = x[2] - x[0]
            rhs = (((dx0 + dt(2) * d0) * dx1) * s0 + (dx0 * dx0) * s1) / d0
            row = (dt(0), dx1, d0, rhs)
        else:
            dxa, dxb = x[i] - x[i - 1], x[i + 1] - x[i]
            sa, sb = (y[i] - y[i - 1]) / dxa, (y[i + 1] - y[i]) / dxb
            row = (dxb, dt(2) * (dxa + dxb), dxa, dt(3) * (dxb * sa + dxa * sb))
        a[i], b[i], c[i], d[i] = row
        if i == 0:
            a[i] = 0
        if i == k - 1:
            c[i] = 0
    return a, b, c, d


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", KINDS)
def test_count_bounded_pcr_is_the_full_capacity_solve(kind, dtype):
    systems, _, _ = _draw(dtype, kind, COUNTS, seed=3)
    zeros = 0
    for (a, b, c, d, cnt, plain), want in zip(systems, COUNTS):
        assert cnt == want
        got = _bounded(a, b, c, d, cnt)
        assert _same_bits(got, plain[:cnt]), (kind, cnt)
        zeros += int(np.count_nonzero(got == 0))
    if kind != "random":
        assert zeros > 0  # the signed zeros are exercised


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", KINDS)
def test_warp_layout_is_the_full_capacity_solve(kind, dtype):
    counts = [c for c in COUNTS if c <= WARP_ROWS]
    systems, _, _ = _draw(dtype, kind, counts, seed=5)
    for a, b, c, d, cnt, plain in systems:
        assert _same_bits(_warp(a, b, c, d, cnt), plain[:cnt]), (kind, cnt)


@pytest.mark.parametrize("dtype", DTYPES)
def test_row_builder_is_the_plain_rows(dtype):
    systems, x, y = _draw(dtype, "random", [4, 33, 64, K - 1, K], seed=7)
    for (a, b, c, d, cnt, _), xs, ys in zip(systems, x, y):
        for got, want in zip(_spline_rows(xs, ys, cnt, K), (a, b, c, d)):
            assert _same_bits(got, want[:cnt]), cnt


@pytest.mark.parametrize("rl", [1, 2])
def test_warp_neighbours_are_rows_i_minus_and_plus_s(rl):
    """With rl rows a lane, every lane's shuffle source and register give
    row i -+ s, or an identity row where that row is out of range, at every
    level."""
    lane = np.arange(32)
    rows = [lane + 32 * h for h in range(rl)]
    none = np.full(32, -1)
    st = 1
    while st < 32 * rl:
        if st < 32:
            lu, ln = (lane - st) & 31, (lane + st) & 31
            lo, hi = lane >= st, lane + st < 32
            u = [np.where(lo, rows[h][lu], rows[h - 1][lu] if h > 0 else none) for h in range(rl)]
            n = [np.where(hi, rows[h][ln], rows[h + 1][ln] if h + 1 < rl else none)
                 for h in range(rl)]
        else:
            u = [rows[h - 1] if h > 0 else none for h in range(rl)]
            n = [rows[h + 1] if h + 1 < rl else none for h in range(rl)]
        for h in range(rl):
            i = rows[h]
            assert np.array_equal(u[h], np.where(i - st >= 0, i - st, -1))
            assert np.array_equal(n[h], np.where(i + st < 32 * rl, i + st, -1))
        st *= 2


def _sift_systems(pad_width, dtype):
    """The systems the plain sift machine solves on config 9's series
    (smoke's c9_series draw) cut to N = 256 samples at its spacing."""
    n = 256
    t = (np.arange(n) * (20.0 / 2047)).astype(dtype)
    rng = np.random.default_rng(0)
    Y = np.stack([np.sin(2 * np.pi * t * f) + 0.4 * np.sin(2 * np.pi * t * f / 6.0)
                  + 0.05 * rng.standard_normal(n) for f in (2.0, 3.0, 4.0)]).astype(dtype)
    return _rows(_capture(lambda: emd.sift_machine_plain(
        torch.from_numpy(t), torch.from_numpy(Y), 4, max_iter=40, pad_width=pad_width)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pad_width", [1, 2, 3])
def test_real_sift_systems(pad_width, dtype):
    systems = _sift_systems(pad_width, dtype)
    counts = {cnt for *_, cnt, _ in systems}
    assert len(systems) > 100 and min(counts) <= WARP_ROWS < max(counts)
    for a, b, c, d, cnt, plain in systems:
        assert _same_bits(_bounded(a, b, c, d, cnt), plain[:cnt]), cnt
        if cnt <= WARP_ROWS:
            assert _same_bits(_warp(a, b, c, d, cnt), plain[:cnt]), cnt


def test_chain_counts_levels_of_the_larger_envelope():
    """The smoke's chain bound counts ceil(log2 cnt) levels of a sift's
    larger envelope, no solve where the sift has too few extrema, and the
    capacity's Thomas recursion below 32."""
    assert [pcr_levels(c) for c in (4, 5, 32, 33, 64, 65, K)] == [2, 3, 5, 6, 6, 7, 11]
    full = sift_chain_ops(N, PAD, K)
    assert sift_chain_ops(N, PAD, 40) < sift_chain_ops(N, PAD, 700) < full
    assert sift_chain_ops(N, PAD, 0) < sift_chain_ops(N, PAD, 4)
    assert sift_chain_ops(40, PAD, 10) == sift_chain_ops(40, PAD, 20)  # K < 32: Thomas
