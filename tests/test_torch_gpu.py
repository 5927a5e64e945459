"""The CUDA kernels (the spreading kernel through both of its entry points,
the phase fold, the two recursions, the sift, the AM/FM normalization and
the three celerite recursions) against their plain versions, and the GLS,
batched GLS, bootstrap, rest-of-spectral, BLS, container, decomposition,
time-frequency and GP paths, on the card; float32 results independent of
the TF32 switches.

Marked ``gpu``: each test asks the ``cuda`` fixture for the device and
skips where there is none. Run on a GPU machine without the repo's
conftest (it imports JAX, which the port does not need):

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from chip_smoke import gram_cond
from periodicity_tpu_torch import TFSeries, TSeries
from periodicity_tpu_torch.data import SpottedStar
from periodicity_tpu_torch.models.spectral import _bootstrap_powers, _pair_q
from periodicity_tpu_torch.ops import _kernels, filters, spline
from periodicity_tpu_torch.ops.fold import fold_onehot, fold_onehot_plain
from periodicity_tpu_torch.ops.grid import extirpolate_grid, extirpolate_grid_plain
from periodicity_tpu_torch.ops.grid2 import (
    extirpolate_grid_factored,
    extirpolate_grid_factored_plain,
)
from periodicity_tpu_torch.phase import BLS
from periodicity_tpu_torch.spectral import (
    BGLST,
    GLS,
    MultibandGLS,
    default_frequency_grid,
    gls_power,
    gls_power_batch,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _draw(n, nfft, seed, taps=4, cluster=None):
    rng = np.random.default_rng(seed)
    ilo = rng.integers(0, nfft - taps, n)
    if cluster is not None:
        ilo[: n // 2] = cluster + rng.integers(0, 64, n // 2)
    ilo = np.sort(ilo).astype(np.int32)
    return (ilo, rng.standard_normal(n).astype(np.float32),
            rng.standard_normal(n).astype(np.float32),
            rng.standard_normal((n, taps)).astype(np.float32))


def _on(device, arrays):
    return [torch.from_numpy(a).to(device) for a in arrays]


def _check_factored(ilo, ure, uim, lag, nfft):
    """The kernel's complex grid and planes against the f64 plain version
    (1e-6 of scale), bit-equal to each other and to a second call; returns
    the complex grid."""
    before = extirpolate_grid_factored.launches
    got = extirpolate_grid_factored(ilo, ure, uim, lag, nfft, as_complex=True)
    kre, kim = extirpolate_grid_factored(ilo, ure, uim, lag, nfft)
    assert extirpolate_grid_factored.launches == before + 2
    dre, dim = extirpolate_grid_factored_plain(ilo, ure.double(), uim.double(), lag.double(), nfft)
    torch.cuda.synchronize()
    scale = max(1.0, float(dre.abs().max()), float(dim.abs().max()))
    assert got.dtype == torch.complex64 and got.shape == (nfft,)
    assert kre.dtype == torch.float32 and kre.shape == (nfft,)
    assert float((kre.double() - dre).abs().max()) <= 1e-6 * scale
    assert float((kim.double() - dim).abs().max()) <= 1e-6 * scale
    # both layouts hold the same sums, and the same inputs give the same bits
    assert torch.equal(got.real, kre) and torch.equal(got.imag, kim)
    assert torch.equal(got, extirpolate_grid_factored(ilo, ure, uim, lag, nfft, as_complex=True))
    return got


@pytest.mark.parametrize(
    "n,nfft,taps,cluster",
    [
        (200, 1 << 13, 4, None),
        (3000, 1 << 16, 4, None),
        (3000, 1 << 9, 4, None),  # grid smaller than one block's tile
        (100_000, 1 << 22, 4, None),
        (20_000, 1 << 16, 4, 4000),  # many rings of samples in one tile
        (5000, 1 << 14, 8, None),
        (0, 1 << 12, 4, None),
    ],
)
def test_kernel_matches_plain(cuda, n, nfft, taps, cluster):
    _check_factored(*_on(cuda, _draw(n, nfft, seed=n + nfft, taps=taps, cluster=cluster)), nfft)


@pytest.mark.parametrize(
    "n,nfft,taps,lo,hi",
    [
        (0, 1 << 23, 4, 0, 1),  # every tile empty
        (5000, 1 << 20, 4, (1 << 20) - 2048, (1 << 20) - 4),  # all samples in the last tile
        (4000, 1 << 16, 4, 2040, 2056),  # a dense tile across a tile edge
        (5000, 1 << 16, 4, 1000, 1200),  # a dense tile of ~10 rings of samples
        (50_000, 1 << 23, 16, 0, (1 << 22) - 16),  # 16 taps, half the tiles empty
        (1000, 1 << 16, 16, 1000, 1100),  # 16 taps, a dense tile (ring of 128)
        (3000, 1 << 14, 1, 0, (1 << 14) - 1),  # one tap
        (3000, 1 << 14, 3, 5000, 5300),  # three taps, a dense tile
    ],
)
def test_kernel_edges_match_plain(cuda, n, nfft, taps, lo, hi):
    rng = np.random.default_rng(n + nfft + taps)
    ilo = np.sort(rng.integers(lo, hi, n)).astype(np.int32)
    _check_factored(*_on(cuda, (ilo, rng.standard_normal(n).astype(np.float32),
                                rng.standard_normal(n).astype(np.float32),
                                rng.standard_normal((n, taps)).astype(np.float32))), nfft)


@pytest.mark.parametrize("lo,hi", [(0, (1 << 16) - 4), (1000, 1200)])
def test_factored_kernel_is_the_unfactored_one_on_the_products(cuda, lo, hi):
    """One kernel serves both entry points: at 4 taps the factored grid is
    bit for bit the unfactored grid of the rounded products u * lag, in
    sparse and dense tiles alike."""
    rng = np.random.default_rng(3)
    n, nfft = 5000, 1 << 16
    ilo, ure, uim, lag = _on(cuda, (np.sort(rng.integers(lo, hi, n)).astype(np.int32),
                                    rng.standard_normal(n).astype(np.float32),
                                    rng.standard_normal(n).astype(np.float32),
                                    rng.standard_normal((n, 4)).astype(np.float32)))
    vals = torch.complex(ure[:, None] * lag, uim[:, None] * lag)
    got = extirpolate_grid_factored(ilo, ure, uim, lag, nfft, as_complex=True)
    assert torch.equal(got, extirpolate_grid(ilo, vals, nfft))


@pytest.mark.parametrize("taps", [4, 16])
def test_kernel_takes_unaligned_lag(cuda, taps):
    """A lag that starts off a 16-byte (and 8-byte) boundary gives the same
    grid."""
    rng = np.random.default_rng(8)
    n, nfft = 2000, 1 << 14
    ilo, ure, uim = _on(cuda, (np.sort(rng.integers(0, nfft - taps, n)).astype(np.int32),
                               rng.standard_normal(n).astype(np.float32),
                               rng.standard_normal(n).astype(np.float32)))
    flat = torch.from_numpy(rng.standard_normal(n * taps + 1).astype(np.float32)).to(cuda)
    lag = flat[1:].view(n, taps)
    assert lag.data_ptr() % 8
    got = _check_factored(ilo, ure, uim, lag, nfft)
    assert torch.equal(got, extirpolate_grid_factored(ilo, ure, uim, lag.clone(), nfft,
                                                      as_complex=True))


def test_kernel_rejects_what_it_does_not_take(cuda):
    ilo, ure, uim, lag = _on(cuda, _draw(100, 1 << 12, seed=0))
    with pytest.raises(TypeError):
        extirpolate_grid_factored(ilo.long(), ure, uim, lag, 1 << 12)
    with pytest.raises(TypeError):
        extirpolate_grid_factored(ilo, ure.double(), uim, lag, 1 << 12)
    with pytest.raises(ValueError):
        extirpolate_grid_factored(ilo, ure, uim, lag.t(), 1 << 12)
    with pytest.raises(ValueError):
        extirpolate_grid_factored(ilo, ure, uim, lag, 3000)
    with pytest.raises(ValueError):
        extirpolate_grid_factored(ilo, ure.cpu(), uim, lag, 1 << 12)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_gls_on_card_matches_cpu(cuda, dtype):
    """The slice on the card agrees with the port's CPU run, and float32
    spreads through the kernel (two launches per periodogram)."""
    rng = np.random.default_rng(0)
    t = np.sort(rng.uniform(0, 100, 2000)).astype(dtype)
    y = (np.sin(2 * np.pi * t / 7.7) + 0.3 * rng.standard_normal(2000)).astype(dtype)
    ref = GLS()(TSeries(t, y, device="cpu"))
    g = GLS()
    before = extirpolate_grid_factored.launches
    got = g(TSeries(torch.from_numpy(t).to(cuda), torch.from_numpy(y).to(cuda)))
    best = float(got.period_at_highest_peak)
    assert g._gridder_resolved == "kernel"
    assert extirpolate_grid_factored.launches - before == (2 if dtype == np.float32 else 0)
    tol = 5e-5 if dtype == np.float32 else 1e-9
    np.testing.assert_allclose(got.values.cpu().numpy(), ref.values.numpy(), rtol=0,
                               atol=tol * float(ref.values.max()))
    assert best == pytest.approx(float(ref.period_at_highest_peak), rel=1e-6)


def test_gls_direct_on_card_matches_cpu_and_oracle(cuda):
    """The exact direct method on the card agrees with the CPU run, and
    with the fast path at 12 taps on a doubled grid."""
    rng = np.random.default_rng(1)
    t = np.sort(rng.uniform(0, 100, 1000))
    y = np.sin(2 * np.pi * t / 7.7) + 0.3 * rng.standard_normal(1000)
    ts = TSeries(torch.from_numpy(t).to(cuda), torch.from_numpy(y).to(cuda))
    _, df, fmin = default_frequency_grid(ts)
    err = torch.ones_like(ts.values)
    direct = gls_power(ts.time, ts.values, err, df, fmin, 2000, method="direct")
    cpu = gls_power(ts.time.cpu(), ts.values.cpu(), err.cpu(), df, fmin, 2000, method="direct")
    oracle = gls_power(ts.time, ts.values, err, df, fmin, 2000, pair_q=1, taps=12,
                       nfft=1 << 15)
    peak = float(cpu.max())
    assert float((direct.cpu() - cpu).abs().max()) <= 1e-9 * peak
    assert float((oracle - direct).abs().max()) <= 1e-8 * peak


@pytest.mark.parametrize(
    "n,nfft,lo,hi",
    [
        (50, 2048, 0, 2044),
        (5000, 1 << 16, 1000, 1200),  # many samples in one tile
        (3000, 1 << 14, (1 << 14) - 300, (1 << 14) - 4),  # clustered at the end
        (100_000, 1 << 23, 0, (1 << 22) - 4),  # half the tiles empty
        (0, 1 << 12, 0, 1),
        (0, 1 << 23, 0, 1),  # every tile empty
        (5000, 1 << 20, (1 << 20) - 2048, (1 << 20) - 4),  # all samples in the last tile
        (4000, 1 << 16, 2040, 2056),  # more than a ring of samples across a tile edge
    ],
)
def test_unfactored_kernel_matches_plain(cuda, n, nfft, lo, hi):
    rng = np.random.default_rng(n + nfft)
    ilo = torch.from_numpy(np.sort(rng.integers(lo, hi, n)).astype(np.int32)).to(cuda)
    vals = torch.from_numpy(rng.standard_normal((n, 4)) + 1j * rng.standard_normal((n, 4))
                            ).to(torch.complex64).to(cuda)
    before = extirpolate_grid.launches
    got = extirpolate_grid(ilo, vals, nfft)
    assert extirpolate_grid.launches == before + 1
    ref = extirpolate_grid_plain(ilo, vals.to(torch.complex128), nfft)
    torch.cuda.synchronize()
    assert got.dtype == torch.complex64 and got.shape == (nfft,)
    scale = max(1.0, float(ref.abs().max()))
    assert float((got.to(torch.complex128) - ref).abs().max()) <= 1e-6 * scale
    re, im = extirpolate_grid(ilo, vals, nfft, as_complex=False)
    assert torch.equal(re, got.real) and torch.equal(im, got.imag)  # deterministic


def test_unfactored_kernel_takes_unaligned_values(cuda):
    """Values that start off a 16-byte boundary give the same grid."""
    rng = np.random.default_rng(7)
    n, nfft = 1000, 1 << 14
    ilo = torch.from_numpy(np.sort(rng.integers(0, nfft - 4, n)).astype(np.int32)).to(cuda)
    flat = torch.from_numpy(rng.standard_normal(4 * n + 1) + 1j * rng.standard_normal(4 * n + 1)
                            ).to(torch.complex64).to(cuda)
    vals = flat[1:].view(n, 4)
    assert vals.data_ptr() % 16
    got = extirpolate_grid(ilo, vals, nfft)
    assert torch.equal(got, extirpolate_grid(ilo, vals.clone(), nfft))
    ref = extirpolate_grid_plain(ilo, vals.to(torch.complex128), nfft)
    torch.cuda.synchronize()
    assert float((got.to(torch.complex128) - ref).abs().max()) <= 1e-6 * float(ref.abs().max())


def _fold_draw(n, nv, epoch, seed):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 200.0, n)) + epoch
    x = rng.standard_normal(n)
    values = np.stack([np.ones(n), x, x * x, np.abs(x)][:nv]).astype(np.float32)
    return t, x, values


@pytest.mark.parametrize(
    "n,p,nv,n_phi,stride,epoch",
    [
        (2000, 1000, 2, 256, 1, 0.0),  # the BLS shape
        (2000, 300, 3, 9, 1, 0.0),  # AoV: counts, sums, squares
        (2000, 300, 1, 10, 5, 0.0),  # conditional entropy: offsets
        (1999, 333, 2, 64, 1, 2.45e6),  # ragged N and P, float64 times at a BJD epoch
        (30_000, 100, 2, 256, 1, 0.0),  # above 2048 samples: read for every frequency
        (700, 50, 1, 7000, 1, 0.0),  # histograms above 48 KB of shared memory
        (2000, 512, 2, 256, 1, 0.0),  # one chunk of the BLS scan
        (2000, 1, 2, 256, 1, 0.0),  # fewer frequencies than SMs
        (2000, 7, 3, 9, 1, 0.0),
        (1, 50, 2, 16, 1, 0.0),  # one sample
        (31, 50, 2, 16, 1, 0.0),
        (2000, 64, 4, 256, 1, 0.0),  # more rows than kept in registers: read for every frequency
        (700, 20, 1, 29056, 1, 0.0),  # the largest histogram the wrapper takes
    ],
)
def test_fold_kernel_matches_plain(cuda, n, p, nv, n_phi, stride, epoch):
    t, x, values = _fold_draw(n, nv, epoch, seed=n + p)
    tt = torch.from_numpy(t if epoch else t.astype(np.float32)).to(cuda)
    vt = torch.from_numpy(values).to(cuda)
    freqs = torch.from_numpy(1.0 / np.linspace(0.5, 100.0, p)).to(cuda)
    offsets = None
    if stride > 1:
        offsets = torch.from_numpy(np.clip(((x - x.min()) / np.ptp(x) * stride).astype(np.int32),
                                           0, stride - 1)).to(cuda)
    before = fold_onehot.launches
    got = fold_onehot(tt, vt, freqs, n_phi, stride=stride, offsets=offsets)
    assert fold_onehot.launches == before + 1
    # every row, weighted ones too, is the CPU plain version's: each cell
    # summed from +0 in ascending sample order
    ref = fold_onehot_plain(tt.cpu(), vt.cpu(), freqs.cpu(), n_phi, stride=stride,
                            offsets=None if offsets is None else offsets.cpu())
    assert got.shape == (p, nv, n_phi * stride) and got.dtype == torch.float32
    assert _same_bits(got, ref)
    assert torch.equal(got[:, 0].sum(-1), torch.full((p,), float(n), device=cuda))
    # two launches give the same bits
    assert _same_bits(fold_onehot(tt, vt, freqs, n_phi, stride=stride, offsets=offsets), got)


def test_fold_kernel_rejects_what_it_does_not_take(cuda):
    t, _, values = _fold_draw(100, 2, 0.0, seed=0)
    tt, vt = torch.from_numpy(t).to(cuda), torch.from_numpy(values).to(cuda)
    freqs = torch.linspace(0.1, 1.0, 10, device=cuda)
    with pytest.raises(ValueError, match="cells"):
        fold_onehot(tt, vt, freqs, 15000)  # 2 rows x 15000 bins > 29056 cells
    with pytest.raises(ValueError):
        fold_onehot(tt, vt.cpu(), freqs, 16)
    with pytest.raises(ValueError):
        fold_onehot(tt, vt[:, :50], freqs, 16)
    with pytest.raises(TypeError):
        fold_onehot(tt, vt, freqs, 16, stride=2, offsets=torch.zeros(100, device=cuda))


def test_phase_scores_on_card_are_deterministic(cuda):
    """bls_scan, AoV and conditional entropy through the fold kernel: two
    calls on the card give the same scores bit for bit (the fold sums in a
    fixed order), and they agree with the CPU port's scores on the same
    draw within 1e-5 of the largest value, with the same best period. Not
    bit for bit: the folds are the CPU's bits, but the eager sums after
    them (the window cumsums, the bins' sums, the mean of x) reduce in
    another order on the card than on the CPU."""
    from periodicity_tpu_torch.models.phase import aov_scan, bls_scan, conditional_entropy_scan

    rng = np.random.default_rng(16)
    n = 2000
    t = np.sort(rng.uniform(0, 200.0, n)).astype(np.float32)
    y = (np.sin(2 * np.pi * t / 7.7) + 0.3 * rng.standard_normal(n)).astype(np.float32)
    w = np.full(n, 1.0 / n, np.float32)
    periods = np.linspace(2.0, 20.0, 700)
    host = [torch.from_numpy(a) for a in (t, y, w, periods)]
    card = [a.to(cuda) for a in host]
    for fn, idx, kw in ((bls_scan, (0, 1, 2, 3), dict(widths=(3, 13, 26), batch_size=256)),
                        (aov_scan, (0, 1, 3), {}), (conditional_entropy_scan, (0, 1, 3), {})):
        got = fn(*(card[i] for i in idx), binner="kernel", **kw)
        again = fn(*(card[i] for i in idx), binner="kernel", **kw)
        want = fn(*(host[i] for i in idx), binner="kernel", **kw)
        got, again, want = (x if isinstance(x, tuple) else (x,) for x in (got, again, want))
        assert all(_same_bits(a, b) if a.is_floating_point() else torch.equal(a, b)
                   for a, b in zip(got, again)), fn.__name__
        a, b = got[0].cpu().double(), want[0].double()
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max()), fn.__name__
        best = torch.argmin if fn is conditional_entropy_scan else torch.argmax
        assert int(best(a)) == int(best(b)), fn.__name__


def test_bls_on_card_through_the_kernel(cuda):
    """BLS on the card resolves to the kernel binner, launches once per
    chunk of periods, and finds the period the CPU scatter scan finds."""
    rng = np.random.default_rng(0)
    n = 2000
    t = np.sort(rng.uniform(0, 200.0, n)).astype(np.float32)
    y = (np.where((t / 7.7) % 1.0 < 0.05, -0.02, 0.0)
         + 0.005 * rng.standard_normal(n)).astype(np.float32)
    kw = dict(p_min=0.5, p_max=100.0, n_periods=5000, batch_size=512,
              durations=(3 / 256, 6 / 256, 13 / 256, 26 / 256))
    est = BLS(**kw)
    before = fold_onehot.launches
    got = est(TSeries(torch.from_numpy(t).to(cuda), torch.from_numpy(y).to(cuda)))
    assert est._binner_resolved == "kernel"
    assert fold_onehot.launches - before == -(-5000 // 512)
    assert got.values.device.type == "cuda" and got.attrs["depth"].device.type == "cuda"
    ref_est = BLS(**kw)
    ref = ref_est(TSeries(t.astype(np.float64), y.astype(np.float64), device="cpu"))
    assert est.best_period == ref_est.best_period
    assert abs(est.best_period - 7.7) <= 0.001 * 7.7
    peak = float(ref.values.max())
    close = (got.values.cpu().double() - ref.values).abs() <= 1e-4 * peak
    assert float(close.double().mean()) >= 0.95


def _batch_curves(b=3, n=3000, seed=2):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 100, n)).astype(np.float32)
    ys = np.stack([np.sin(2 * np.pi * t / p) + 0.3 * rng.standard_normal(n)
                   for p in (3.3, 7.7, 12.1, 5.5)[:b]]).astype(np.float32)
    return t, ys, np.full((b, n), 0.3, np.float32)


@pytest.mark.parametrize("pair_q,per_row", [(1, 2), (None, 3)])
def test_gls_power_batch_kernel_layout(cuda, pair_q, per_row):
    """float32 on the card: the kernel layout launches the spreading kernel
    once per pipeline of every row, and agrees with the row spreading and
    with a loop of scatter gls_power within 5e-5 of the peak."""
    t, ys, errs = _batch_curves()
    tc, yc, ec = _on(cuda, (t, ys, errs))
    df, nf = float(np.float32(1 / 500)), 2000
    fmin = float(np.float32(df / 2))
    before = extirpolate_grid_factored.launches
    got = gls_power_batch(tc, yc, ec, df, fmin, nf, pair_q=pair_q, gridder="kernel")
    assert extirpolate_grid_factored.launches - before == per_row * len(ys)
    rows = gls_power_batch(tc, yc, ec, df, fmin, nf, pair_q=pair_q)
    loop = torch.stack([gls_power(tc, yc[i], ec[i], df, fmin, nf, pair_q=pair_q)
                        for i in range(len(ys))])
    peak = float(loop.max())
    assert got.shape == rows.shape == (len(ys), nf) and got.dtype == torch.float32
    assert float((got - loop).abs().max()) <= 5e-5 * peak
    assert float((rows - loop).abs().max()) <= 5e-5 * peak


def test_bootstrap_launches_the_kernel_twice_per_replicate(cuda):
    """GLS.bootstrap on the card runs its replicates through the kernel
    (two launches each); on the same indices they match the row-spreading
    layout within 1e-4 of the largest replicate."""
    rng = np.random.default_rng(4)
    t = np.sort(rng.uniform(0, 100, 1000)).astype(np.float32)
    y = (np.sin(2 * np.pi * t / 7.7) + 0.3 * rng.standard_normal(1000)).astype(np.float32)
    gls = GLS()
    ts = TSeries(*_on(cuda, (t, y)))
    gls(ts)
    before = extirpolate_grid_factored.launches
    reps = gls.bootstrap(6, random_seed=3)
    assert extirpolate_grid_factored.launches - before == 12
    gen = torch.Generator(device=cuda).manual_seed(3)
    idx = torch.randint(0, 1000, (6, 1000), generator=gen, device=cuda)
    f = gls.frequency
    rows = _bootstrap_powers(idx, ts.time, ts.values, gls.err, float(f[1] - f[0]), float(f[0]),
                             f.size, pair_q=_pair_q(f[1] - f[0], f[0], f.size))
    assert float(np.abs(rows.cpu().numpy() - reps).max()) <= 1e-4 * reps.max()


@pytest.mark.parametrize("n,nfft", [(200_000, 1 << 16), (400_000, 1 << 18)])
def test_kernel_on_all_dense_tiles(cuda, n, nfft):
    """Reduced config-14 draws: sorted bases over a fifth of the grid, so
    every occupied 2048-cell tile holds tens of thousands of samples (the
    ring holds 512) and takes the split-over-the-block path; both layouts."""
    rng = np.random.default_rng(n)
    ilo = np.sort(rng.integers(0, nfft // 5, n)).astype(np.int32)
    _check_factored(*_on(cuda, (ilo, rng.standard_normal(n).astype(np.float32),
                                rng.standard_normal(n).astype(np.float32),
                                rng.standard_normal((n, 4)).astype(np.float32))), nfft)


def test_kernel_layout_raises_on_cpu_and_never_falls_back(cuda, monkeypatch):
    """``gridder="kernel"`` on CPU tensors raises; on the card a failed
    launch raises instead of returning the row-spreading result."""
    t, ys, errs = _batch_curves(b=2)
    with pytest.raises(ValueError, match="CUDA"):
        gls_power_batch(*(torch.from_numpy(a) for a in (t, ys, errs)), 0.002, 0.001, 2000,
                        gridder="kernel")

    class Failing:
        @staticmethod
        def extirpolate_grid_factored_f32(*args):
            return 700  # cudaErrorIllegalAddress

    monkeypatch.setattr(_kernels, "load", lambda: Failing())
    with pytest.raises(RuntimeError, match="launch failed"):
        gls_power_batch(*_on(cuda, (t, ys, errs)), 0.002, 0.001, 2000, gridder="kernel")


def _multiband(device):
    rng = np.random.default_rng(7)
    signals = {}
    for s in range(3):
        t = np.sort(rng.uniform(0, 40, 180))
        y = ((0.0, 5.0, -4.0)[s] + (1.0, 0.7, 1.3)[s] * np.sin(2 * np.pi * t / 2.3 + 2 * s)
             + 0.05 * rng.standard_normal(180))
        signals[s] = TSeries(t, y, device=device)
    mb = MultibandGLS(fmax=2.0)
    p = mb(signals, err={s: np.full(180, 0.05) for s in range(3)})
    return [p.values, mb.refine().values, mb.model(np.linspace(0, 40, 50), 1 / 2.3, 1).values]


def _gls_surface(device, nterms):
    rng = np.random.default_rng(9)
    t = np.sort(rng.uniform(0, 60, 800))
    y = np.sin(2 * np.pi * t / 6.2) + 0.3 * rng.standard_normal(800)
    g = GLS(nterms=nterms)
    p = g(TSeries(t, y, device=device), err=np.full(800, 0.3))
    return [p.values, g.refine().values, g.window().values,
            g.model(np.linspace(0, 60, 50), 1 / 6.2).values]


def _bglst(device):
    rng = np.random.default_rng(5)
    t = np.sort(rng.uniform(0, 60, 400))
    y = np.sin(2 * np.pi * t / 6.1) + 0.05 * t + 0.2 * rng.standard_normal(400)
    return [BGLST(method=m)(TSeries(t, y, device=device), err=np.full(400, 0.2)).values
            for m in ("fast", "direct")]


@pytest.mark.parametrize("case", ["gls", "multiterm", "bglst", "multiband"])
def test_rest_of_spectral_on_card_matches_cpu(cuda, case):
    """float64 on the card against the port's CPU run: periodograms,
    refinements, windows and models within 1e-9 of their largest value;
    the multi-term periodogram also eps * cond(G) of its peak per bin
    (its lowest bins are nearly singular, where cuFFT's rounding and the
    CPU FFT's move the power apart)."""
    make = {"gls": lambda d: _gls_surface(d, 1), "multiterm": lambda d: _gls_surface(d, 3),
            "bglst": _bglst, "multiband": _multiband}[case]
    for i, (got, ref) in enumerate(zip(make(cuda), make("cpu"))):
        assert got.device.type == "cuda" and got.dtype == ref.dtype == torch.float64
        scale = float(ref.abs().max())
        tol = torch.full_like(ref, 1e-9 * scale)
        if case == "multiterm" and i == 0:
            rng = np.random.default_rng(9)
            t = torch.from_numpy(np.sort(rng.uniform(0, 60, 800)))
            freqs = torch.from_numpy(default_frequency_grid(TSeries(t, t))[0])
            tol += torch.finfo(torch.float64).eps * gram_cond(t, torch.ones(800), freqs, 3) * scale
        assert bool(((got.cpu() - ref).abs() <= tol).all())


# -- the container slice: recursion kernels, C1, the surface, TF32 ------------


def _filter_case(n, rows, dtype, seed=0, ns=5):
    """Order-5 bandpass sections (the GP prior's shape) for ns = 5, else the
    first ns sections of an order-16 bandpass cascade."""
    rng = np.random.default_rng(seed)
    sos = (filters.butter_sos(5, [0.02, 0.4], "bandpass") if ns == 5
           else filters.butter_sos(16, [0.02, 0.4], "bandpass")[:ns])
    x = torch.from_numpy(rng.standard_normal((rows, n))).to(dtype)
    zi = torch.from_numpy(rng.standard_normal((rows, sos.shape[0], 2))).to(dtype)
    return sos, x, zi


def _sosfilt_held(sos, x, zi, cuda):
    before = filters.sosfilt.launches
    y, zf = filters.sosfilt(sos, x.to(cuda), zi.to(cuda))
    yp, zp = filters.sosfilt_plain(sos, x, zi)
    torch.cuda.synchronize()
    assert filters.sosfilt.launches == before + 1
    assert y.device.type == "cuda" and y.dtype == x.dtype
    assert torch.equal(y.cpu(), yp) and torch.equal(zf.cpu(), zp)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ns", [1, 2, 5, 8, 16])
@pytest.mark.parametrize("n,rows", [(2214, 1), (17, 3), (1, 1), (0, 2), (9, 40), (300, 7),
                                    (300, 64)])
def test_sosfilt_kernel_matches_plain_bit_for_bit(cuda, dtype, n, rows, ns):
    """A group of lanes a row, a lane a section (ns = 1..16: 1 to 16 lanes),
    rows that fill a warp or not, every chunk steady or on a ramp."""
    _sosfilt_held(*_filter_case(n, rows, dtype, ns=ns), cuda)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ns", [1, 2, 5, 8, 16])
def test_sosfilt_kernel_ramp_longer_than_the_row(cuda, dtype, ns):
    """n = 1..ns + 1: the systolic ramp ((ns - 1) * lag ticks) is as long as
    the row or longer, so no chunk is steady and the last section starts
    after the first has finished."""
    for n in range(1, ns + 2):
        _sosfilt_held(*_filter_case(n, 7, dtype, seed=n, ns=ns), cuda)


def _spd_bands(m, dtype):
    rng = np.random.default_rng(m)
    return [torch.from_numpy(v).to(dtype) for v in (
        4.0 + rng.uniform(0, 1, m), rng.uniform(-1, 1, m - 1) if m > 1 else np.zeros(0),
        rng.uniform(-0.5, 0.5, m - 2) if m > 2 else np.zeros(0), rng.standard_normal(m))]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("m", [2146, 1, 2, 3, 17, 128, 129, 5000, 9000, (1, -1), (1, 0), (1, 1),
                               (3, 5), 100_000])
def test_pentadiagonal_kernel_matches_plain_bit_for_bit(cuda, dtype, m):
    """Systems held in shared memory (up to the capacity the card reports)
    and past it (the tiles stream through the global scratch), up to 1e5;
    (k, j) is k times the capacity plus j."""
    if isinstance(m, tuple):
        m = m[0] * spline.pentadiagonal_capacity(dtype) + m[1]
    bands = _spd_bands(m, dtype)
    before = spline._pentadiagonal_solve.launches
    got = spline._pentadiagonal_solve(*(b.to(cuda) for b in bands))
    torch.cuda.synchronize()
    assert spline._pentadiagonal_solve.launches == before + 1
    assert torch.equal(got.cpu(), spline.pentadiagonal_solve_plain(*bands))


def test_pentadiagonal_capacity(cuda):
    """The ring holds 56 tiles of 128 rows in float64 and 112 in float32
    (four arrays in place, up to 227 KB a block on an H100)."""
    caps = [spline.pentadiagonal_capacity(dt) for dt in (torch.float64, torch.float32)]
    assert caps[0] % 128 == 0 and caps[1] % 128 == 0 and caps[1] >= 2 * caps[0] - 128
    if "H100" in torch.cuda.get_device_name(cuda):
        assert caps == [56 * 128, 112 * 128]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_pentadiagonal_kernel_signed_zeros(cuda, dtype):
    """Zero right-hand sides of both signs and negative pivots: the zeros'
    signs through the factor, the quotients and both substitutions."""
    for seed in range(40):
        rng = np.random.default_rng(seed)
        m = int(rng.integers(3, 9))
        bands = [torch.from_numpy(v).to(dtype) for v in (
            np.where(rng.uniform(size=m) < 0.5, -4.0, 4.0),
            rng.choice([0.0, -0.0, 0.5, -0.5], m - 1), rng.choice([0.0, -0.0, 0.25], m - 2),
            rng.choice([0.0, -0.0], m))]
        got = spline._pentadiagonal_solve(*(b.to(cuda) for b in bands)).cpu()
        ref = spline.pentadiagonal_solve_plain(*bands)
        assert torch.equal(got.view(torch.int64 if dtype == torch.float64 else torch.int32),
                           ref.view(torch.int64 if dtype == torch.float64 else torch.int32)), seed


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_pentadiagonal_kernel_zero_pivot_path(cuda, dtype):
    """JAX's guards (D == 0 makes alpha and beta 0 after it, then the
    substitution divides by zero): the same infinities and NaNs."""
    bands = [torch.tensor(v, dtype=dtype) for v in (
        [0.0, 2.0, 3.0, 4.0, 0.0, 5.0], [1.0, 0.5, 0.25, 0.5, 1.0], [0.5, 0.25, 0.5, 0.1],
        [1.0, 2.0, 3.0, 4.0, 5.0, 6.0])]
    got = spline._pentadiagonal_solve(*(b.to(cuda) for b in bands)).cpu()
    ref = spline.pentadiagonal_solve_plain(*bands)
    assert not bool(torch.isfinite(ref).all())
    assert torch.equal(got.nan_to_num(7.0), ref.nan_to_num(7.0))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_recursion_kernels_use_no_local_memory(cuda, dtype):
    """The solve's walker and stagers and the filter at every group width
    keep their state in registers: 0 bytes of local memory."""
    attrs = [spline.kernel_attributes(dtype), *filters.kernel_attributes(dtype).values()]
    assert len(attrs) == 6
    for a in attrs:
        assert a["local_bytes"] == 0 and 0 < a["registers"] <= 255, attrs


def test_recursion_quotient_is_ddiv_rn(cuda):
    """The solve's checked quotient (csrc/rn.cuh, rn::Checked), or the
    division where its residual does not prove it, gives __fdiv_rn's and
    __ddiv_rn's bit pattern: hashed pairs anywhere and inside the window,
    divisors at every binade edge under hashed numerators and under +-1,
    special operands, and the quotients of SpottedStar's smoothing-spline
    system at lam = 1."""
    from chip_smoke import penta_quotient_pairs

    lib = _kernels.load()
    stream = torch.cuda.current_stream(cuda).cuda_stream
    t, y, _ = SpottedStar()
    (main, off1, off2), (q0, q1, q2), _ = spline._reinsch_system(torch.from_numpy(t), 1.0)
    rhs = spline._qt_apply(q0, q1, q2, torch.from_numpy(y))
    for dtype, fn in ((torch.float32, lib.recursions_quot_check_f32),
                      (torch.float64, lib.recursions_quot_check_f64)):
        a, d = (v.to(cuda) for v in penta_quotient_pairs(main, off1, off2, rhs, dtype))
        for mode, n in ((0, 1 << 28), (1, 1 << 28), (2, 6 * 2046 * 64), (3, 6 * 2046 * 4),
                        (4, 1 << 24), (5, a.numel())):
            out = torch.zeros(2, dtype=torch.int64, device=cuda)
            assert fn(n, mode, a.data_ptr(), d.data_ptr(), out.data_ptr(), stream) == 0
            bad, fast = out.tolist()
            assert bad == 0, (dtype, mode, bad, fast)
            assert mode not in (1, 5) or fast > n * 0.9, (dtype, mode, bad, fast)


def test_recursion_wrappers_check_inputs_and_never_fall_back(cuda, monkeypatch):
    """Mixed devices and too many sections raise on the card; a failed
    launch raises instead of returning the plain version's result."""
    sos, x, zi = _filter_case(50, 1, torch.float64)
    with pytest.raises(ValueError, match="sections"):
        filters.sosfilt(np.tile(sos, (4, 1)), x.to(cuda))
    main = torch.ones(5, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="off1"):
        spline._pentadiagonal_solve(main, torch.zeros(4, dtype=torch.float64),
                                    torch.zeros(3, dtype=torch.float64, device=cuda), main)

    class Failing:
        @staticmethod
        def sosfilt_f64(*args):
            return 700  # cudaErrorIllegalAddress

        @staticmethod
        def pentadiagonal_solve_f64(*args):
            return 700

    monkeypatch.setattr(_kernels, "load", lambda: Failing())
    with pytest.raises(RuntimeError, match="launch failed"):
        filters.sosfilt(sos, x.to(cuda), zi.to(cuda))
    with pytest.raises(RuntimeError, match="launch failed"):
        spline._pentadiagonal_solve(main, main[:4] * 0, main[:3] * 0, main)


@pytest.mark.parametrize("estimator", ["GLS", "BGLST", "MultibandGLS", "BLS"])
def test_container_as_err_on_card_matches_cpu(cuda, estimator):
    """C1 on the card: ``err`` (and ``bands``) as a CUDA TSeries unwraps to
    its values, and the result equals the CPU run's within 1e-9 of peak."""
    rng = np.random.default_rng(0)
    t = np.sort(rng.uniform(0, 60, 300))
    y = np.sin(2 * np.pi * t / 7.7) + 0.3 * rng.standard_normal(300)
    e = rng.uniform(0.2, 0.4, 300)
    b = (np.arange(300) % 3).astype(np.int64)

    def run(dev):
        ts = TSeries(t, y, device=dev)
        err = TSeries(t, e, device=dev)
        if estimator == "MultibandGLS":
            return MultibandGLS(fmax=2.0)(ts, err=err, bands=TSeries(t, b, device=dev)).values
        if estimator == "BLS":
            # one binner on both devices: "auto" folds in float32 by the
            # kernel on the card and scatters in float64 on the CPU
            return BLS(n_periods=500, binner="scatter")(ts, err=err).values
        return {"GLS": GLS, "BGLST": BGLST}[estimator]()(ts, err=err).values

    got, ref = run(cuda), run("cpu")
    assert got.device.type == "cuda"
    assert float((got.cpu() - ref).abs().max()) <= 1e-9 * float(ref.abs().max())


def test_sosfiltfilt_float32_on_card_runs_the_kernel_in_float64(cuda):
    """A float32 series is filtered in float64 on the card (two launches)
    and cast back, bit-equal to the CPU's float64 recursion."""
    sos = filters.butter_sos(5, [0.05, 0.3], "bandpass")
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(600).astype(np.float32))
    before = filters.sosfilt.launches
    got = filters.sosfiltfilt(sos, x.to(cuda))
    assert filters.sosfilt.launches == before + 2
    assert got.dtype == torch.float32 and got.device.type == "cuda"
    assert torch.equal(got.cpu(), filters.sosfiltfilt(sos, x))


def test_container_surface_on_card_matches_cpu(cuda):
    """acf_period_quality (float64: the sosfilt kernel, counted), the
    smoothing interpolation (the pentadiagonal kernel, counted), every
    interpolation method, find_peaks with criteria and TFSeries reductions
    on the card against the CPU."""
    t, y, _ = SpottedStar()
    p_min = max(0.1, 3 * float(np.median(np.diff(t))))
    card, cpu = TSeries(t, y, device=cuda), TSeries(t, y, device="cpu")
    before = filters.sosfilt.launches
    got = card.acf_period_quality(p_min, 16.0)
    ref = cpu.acf_period_quality(p_min, 16.0)
    assert filters.sosfilt.launches == before + 2
    assert got[0] == ref[0] and np.allclose(got[1:], ref[1:], rtol=1e-6, atol=0)
    x = np.linspace(t[0] - 1, t[-1] + 1, 1000)
    before = spline._pentadiagonal_solve.launches
    for method, kw in (("linear", {}), ("cubic", {}), ("quadratic", {}), ("spline", {}),
                       ("spline", {"s": 0.1}), ("nearest", {}), ("zero", {})):
        a = card.interp(x, method=method, **kw).values.cpu()
        b = cpu.interp(x, method=method, **kw).values
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        assert float((a - b).nan_to_num().abs().max()) <= 1e-8
    assert spline._pentadiagonal_solve.launches - before >= 60
    crit = {"distance": 5, "width": 2.0, "prominence": 1e-3, "threshold": 1e-4}
    pk, pk_ref = card.find_peaks(**crit), cpu.find_peaks(**crit)
    assert torch.equal(pk.attrs["indices"].cpu(), pk_ref.attrs["indices"])
    assert torch.allclose(pk.attrs["widths"].cpu(), pk_ref.attrs["widths"], rtol=1e-10)
    img = np.random.default_rng(2).standard_normal((16, 64))
    tf = TFSeries(np.arange(64.0), np.linspace(0.1, 1.0, 16), img, device=cuda)
    tf_ref = TFSeries(np.arange(64.0), np.linspace(0.1, 1.0, 16), img, device="cpu")
    assert torch.allclose(tf.downsample(dt=4.0).values.cpu(), tf_ref.downsample(dt=4.0).values)
    assert torch.allclose(tf.median("time").values.cpu(), tf_ref.median("time").values)


def test_float32_results_do_not_depend_on_tf32_switches(cuda):
    """With both process-wide TF32 switches on, the port's float32
    convolutions and matrix products give the same bits as with the switches
    off (TF32's 10-bit mantissa would move them by ~1e-3), while a raw
    float32 product does move."""
    from periodicity_tpu_torch.models.spectral import _normal_equations

    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((8, 2048)).astype(np.float32)).to(cuda)
    img = torch.from_numpy(rng.standard_normal((64, 128)).astype(np.float32)).to(cuda)
    t = np.sort(rng.uniform(0, 50, 600)).astype(np.float32)
    yv = (np.sin(2 * np.pi * t / 5.0) + 0.2 * rng.standard_normal(600)).astype(np.float32)
    X = torch.from_numpy(rng.standard_normal((4, 600, 5)).astype(np.float32)).to(cuda)
    w = torch.from_numpy(rng.uniform(0.5, 2.0, 600).astype(np.float32)).to(cuda)
    A = torch.from_numpy(rng.standard_normal((256, 512)).astype(np.float32)).to(cuda)

    def run():
        return [filters.convolve1d(x, filters.gaussian_kernel1d(3.0, dtype=torch.float32)),
                filters.convolve2d(img, torch.ones(5, 5, device=cuda) / 25),
                GLS(method="direct")(TSeries(t, yv, device=cuda)).values,
                *_normal_equations(X, w, torch.from_numpy(yv).to(cuda)),
                A @ A.T]  # a raw product, unpinned

    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        off = run()
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        on = run()
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = matmul, cudnn
    diffs = [float((a - b).abs().max() / a.abs().max()) for a, b in zip(off, on)]
    assert all(a.dtype == torch.float32 for a in off)
    assert all(torch.equal(a, b) for a, b in zip(off[:-1], on[:-1])), diffs
    assert diffs[-1] > 1e-6, diffs  # the switches do reach an unpinned product


# ---- the EMD sift kernel (csrc/sift.cu) and the decompositions -------------

def _sift_case(case, dtype, device):
    """(t, Y, keyword arguments) of a sift-kernel test draw."""
    rng = np.random.default_rng(17)
    tt = np.arange(200.0)
    wavy = np.sin(tt[None] / np.array([[4.0], [7.0]])) + 0.3 * rng.standard_normal((2, 200))
    t600 = np.arange(600.0)
    tones = {f"tone{m}": (t600, np.stack([np.sin(2 * np.pi * m * t600 / 600 + 0.3),
                                          np.sin(2 * np.pi * m * t600 / 600 + 0.3)
                                          + 0.2 * np.sin(2 * np.pi * (m + 1) * t600 / 600 + 1.1)]),
                          {"max_modes": 2})
             for m in (28, 29, 59, 60, 61, 62)}
    t, Y, kw = {
        # float64 at N = 2048 fits a block's shared memory (215 KB a
        # member); at N = 2400 (266 KB) it runs in global scratch
        "n2048": (np.arange(2048.0), rng.standard_normal((3, 2048)), {"max_modes": 4}),
        "n2400": (np.arange(2400.0), rng.standard_normal((2, 2400)), {"max_modes": 2}),
        # m maxima and minima: envelopes of m + 4 valid knots, at and around
        # the warp-resident solve's 32 rows a register and 64 a warp
        **tones,
        # an alternating series: counts near the capacity
        "alternating": (t600, np.stack([(-1.0) ** t600 * (1 + 0.01 * rng.standard_normal(600)),
                                        (-1.0) ** t600 + 0.3 * np.sin(t600 / 9)]), {}),
        "config10": (np.arange(1024.0), rng.standard_normal((8, 1024)), {"max_modes": 12}),
        "short": (np.arange(3.0), np.ones((2, 3)), {}),
        "ramp": (tt, np.stack([np.linspace(0, 1, 200), np.linspace(0, 1, 200) ** 2]), {}),
        "plateau": (tt, np.stack([np.round(3 * np.sin(tt / 5.0)),
                                  np.round(2 * np.sin(tt / 3.0) + np.cos(tt / 11.0))]), {}),
        "pad1": (tt, wavy, {"pad_width": 1}),
        "pad3": (tt, wavy, {"pad_width": 3}),
        "max_iter": (tt, wavy, {"max_iter": 3}),
        "thomas": (np.arange(20.0), rng.standard_normal((3, 20)), {}),
    }[case]
    kw.setdefault("max_modes", 3)
    return (torch.from_numpy(t).to(device, dtype), torch.from_numpy(Y).to(device, dtype), kw)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", ["n2048", "n2400", "config10", "short", "ramp", "plateau", "pad1",
                                  "pad3", "max_iter", "thomas", "tone28", "tone29", "tone59",
                                  "tone60", "tone61", "tone62", "alternating"])
def test_sift_kernel_matches_plain_bit_for_bit(cuda, dtype, case):
    from periodicity_tpu_torch.ops import emd

    t, Y, kw = _sift_case(case, dtype, cuda)
    if case == "n2400" and dtype == torch.float64:
        assert _kernels.load().emd_sift_scratch_bytes(2400, 2, 8) > 0  # global scratch
    before = emd.sift_machine.launches
    got = emd.sift_machine(t, Y, **kw)
    assert emd.sift_machine.launches == before + 1
    want = emd.sift_machine_plain(t, Y, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert _same_bits(a, b)


def test_one_sift_launch_per_batch_call(cuda):
    from periodicity_tpu_torch.ops import emd

    t, Y, _ = _sift_case("config10", torch.float64, cuda)
    for fn in (lambda: emd.emd_pool(t, Y, max_modes=4), lambda: emd.emd_batch(t, Y),
               lambda: emd.emd_iter_pool(t, Y), lambda: emd.emd_iter(t, Y[0])):
        before = emd.sift_machine.launches
        fn()
        assert emd.sift_machine.launches == before + 1


def test_sift_kernel_raises_and_never_falls_back(cuda, monkeypatch):
    """CPU tensors at the kernel entry, mixed devices, non-contiguous input
    and a wrong dtype raise; a failed launch raises instead of returning
    the plain version's result."""
    from periodicity_tpu_torch.ops import emd

    t, Y, _ = _sift_case("pad1", torch.float64, cuda)
    with pytest.raises(ValueError, match="CUDA"):
        emd._sift_machine_cuda(t.cpu(), Y.cpu(), 2, 10, 2, 0.05, 0.5, 0.05)
    with pytest.raises(ValueError):
        emd._sift_machine_cuda(t.cpu(), Y, 2, 10, 2, 0.05, 0.5, 0.05)
    with pytest.raises(ValueError, match="contiguous"):
        emd._sift_machine_cuda(t[::2].contiguous(), Y[:, ::2], 2, 10, 2, 0.05, 0.5, 0.05)
    with pytest.raises(TypeError):
        emd._sift_machine_cuda(t.half(), Y.half(), 2, 10, 2, 0.05, 0.5, 0.05)

    class Failing:
        @staticmethod
        def emd_sift_scratch_bytes(*args):
            return 0

        @staticmethod
        def emd_sift_f64(*args):
            return 700  # cudaErrorIllegalAddress

    monkeypatch.setattr(_kernels, "load", lambda: Failing())
    with pytest.raises(RuntimeError, match="launch failed"):
        emd.emd_pool(t, Y, max_modes=2)


def test_sift_quotient_is_fdiv_rn(cuda):
    """The envelope stages' float32 division (csrc/envelope.cuh::quot, a
    branch-free fast path inside an exponent window) gives __fdiv_rn's bit
    pattern: hashed pairs anywhere and inside the window, zero numerators,
    and every divisor of the window over the numerators 1 and 1.75."""
    lib = _kernels.load()
    stream = torch.cuda.current_stream(cuda).cuda_stream
    for mode, n in ((0, 1 << 30), (1, 1 << 30), (2, 1 << 28), (3, 121 << 23), (4, 121 << 23)):
        out = torch.zeros(2, dtype=torch.int64, device=cuda)
        assert lib.emd_sift_quot_check_f32(n, mode, out.data_ptr(), stream) == 0
        bad, fast = out.tolist()
        assert bad == 0 and fast > n // 8, (mode, bad, fast)


def test_ceemdan_reference_thresholds_on_card(cuda):
    """The reference's seeded two-tone thresholds
    (tests/test_decomposition.py:35-55) at N = 1000, 50 realizations."""
    from periodicity_tpu_torch.data import SustainedPlusGappedPureTones
    from periodicity_tpu_torch.decomposition import CEEMDAN

    x = TSeries(values=torch.from_numpy(SustainedPlusGappedPureTones()).to(cuda))
    imfs = CEEMDAN(ensemble_size=50, random_seed=42)(x)
    assert len(imfs) == 2
    m0 = imfs[0].values.cpu().numpy()
    assert np.mean(np.square(m0[11:490])) < 1e-4
    assert np.mean(np.square(m0[761:990])) < 1e-4
    s2 = np.sin(2 * np.pi * 0.065 * np.arange(1000))
    s1 = np.zeros_like(s2)
    s1[500:750] += np.sin(2 * np.pi * 0.255 * np.arange(250))
    xv = x.values.cpu().numpy()
    err1 = (m0 - s1)[3:-3]
    err2 = (imfs[1].values.cpu().numpy() - s2)[3:-3]
    err = sum(m.values.cpu().numpy() for m in imfs) - xv
    assert np.linalg.norm(err1) / np.linalg.norm(s1[3:-3]) < 0.10
    assert np.linalg.norm(err2) / np.linalg.norm(s2[3:-3]) < 0.05
    assert np.linalg.norm(err) / np.linalg.norm(xv) < 1e-10


def test_decompositions_on_card_match_cpu(cuda):
    """EMD, LMD (its first product function: past it the smoothing's
    summation order can part the two, ROADMAP.md C4), VMD and CEEMDAN with
    its post-processing, card against CPU within 1e-9 of max|x|."""
    from periodicity_tpu_torch.decomposition import CEEMDAN, EMD, LMD, VMD

    t = np.arange(512.0)
    x = np.sin(2 * np.pi * 0.01 * t) + 0.5 * np.sin(2 * np.pi * 0.1 * t)
    x = x + 0.05 * np.random.default_rng(1).standard_normal(512)
    card, host = TSeries(t, x, device=cuda), TSeries(t, x, device="cpu")

    def same(a, b):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            assert float((u.values.cpu() - v.values).abs().max()) <= 1e-9 * 1.6

    same(EMD()(card), EMD()(host))
    same(VMD(n_modes=3)(card), VMD(n_modes=3)(host))
    pf, pf_cpu = LMD()(card, max_modes=1), LMD()(host, max_modes=1)
    same([pf[0][0] * pf[0][1]], [pf_cpu[0][0] * pf_cpu[0][1]])
    dec, dec_cpu = CEEMDAN(ensemble_size=8, random_seed=3), CEEMDAN(ensemble_size=8, random_seed=3)
    same(dec(card), dec_cpu(host))
    dec.postprocessing()
    dec_cpu.postprocessing()
    same(dec.c_modes + [dec.c_residue], dec_cpu.c_modes + [dec_cpu.c_residue])
    np.testing.assert_allclose(dec.c_orthogonality_matrix, dec_cpu.c_orthogonality_matrix,
                               atol=1e-9)


# ---- the AM/FM normalization kernel (csrc/amfm.cu) and time-frequency -------

def _peaks_rows(counts, n=2048):
    """Positive rows of n samples (so |F| = F in the first pass) with
    exactly counts[r] - 4 interior maxima each (samples 1, 3, ..): at pad
    width 2, counts[r] valid knots; a falling tail after the last peak."""
    rng = np.random.default_rng(len(counts))
    X = np.empty((len(counts), n))
    for r, cnt in enumerate(counts):
        m = cnt - 4
        X[r, :2 * m + 1:2] = rng.uniform(0.05, 0.45, m + 1)
        X[r, 1:2 * m:2] = rng.uniform(0.55, 1.0, m)
        X[r, 2 * m + 1:] = np.linspace(0.04, 0.001, n - 2 * m - 1)
    return X


def _scratch_edge(dtype):
    """The largest N whose normalization rows fit in a block's shared
    memory on this card (past it they run in global scratch)."""
    lib = _kernels.load()
    size = torch.empty((), dtype=dtype).element_size()
    lo, hi = 2, 1 << 20
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if lib.amfm_scratch_bytes(mid, 2, size) == 0 else (lo, mid)
    return lo


def _amfm_case(case, dtype, device):
    """(t, X, keyword arguments) of a normalization-kernel test draw."""
    rng = np.random.default_rng(23)
    t = np.arange(0, 64, 0.25)
    env = 1 + 0.4 * np.sin(2 * np.pi * t / 30)
    tones = np.stack([env * np.sin(2 * np.pi * 0.5 * t),
                      np.sin(2 * np.pi * 0.13 * t) * (1 + 0.5 * np.cos(t / 9)),
                      np.round(3 * np.sin(t / 2.0)) + 0.1 * rng.standard_normal(t.size)])
    t500 = np.arange(500.0)
    t9 = np.linspace(0.0, 20.0, 2048)
    am9 = np.stack([(1 + 0.3 * np.sin(t9 / f)) * np.sin(2 * np.pi * f * t9)
                    for f in (2.0, 3.0, 0.4)])
    # rows across the wave boundary of 132 SMs, one block each
    many = {f"rows{r}": (t, np.sin(2 * np.pi * (0.05 + 0.3 * rng.random((r, 1))) * t)
                         * (1 + 0.3 * rng.random((r, 1)) * np.cos(t / 7)), {})
            for r in (1, 131, 132, 133, 300)}
    if case in ("edge_shared", "edge_global"):
        n = _scratch_edge(dtype) + (1 if case == "edge_global" else 0)
        te = np.linspace(0.0, n / 100.0, n)
        return (torch.from_numpy(te).to(device, dtype),
                torch.from_numpy(np.stack([np.sin(2 * np.pi * 3.0 * te) * (1.2 + np.cos(te)),
                                           rng.standard_normal(n)])).to(device, dtype), {})
    zero_nan = np.stack([np.zeros(t.size), tones[0], tones[1]])
    zero_nan[1, 77] = np.nan
    t, X, kw = {
        # float64 rows at config 9's length fit in shared memory (147 KB);
        # at N = 4096 (290 KB) they run in global scratch
        "n2048": (t9, am9, {}),
        "n4096": (np.linspace(0.0, 40.0, 4096), rng.standard_normal((2, 4096)), {}),
        # too few maxima (the constant envelope), unit amplitude (done after
        # one pass), rows that finish at different passes
        "edges": (t, np.stack([np.cos(2 * np.pi * t / 64 * 0.6),
                               np.sign(np.sin(2 * np.pi * 0.25 * t)), *tones]), {}),
        "pad1": (t, tones, {"pad_width": 1}),
        "pad3": (t, tones, {"pad_width": 3}),
        "pad0": (t, tones, {"pad_width": 0}),
        "n_iter": (t, tones, {"n_iter": 2}),
        "n_iter0": (t, tones, {"n_iter": 0}),
        "n_iter1": (t, tones, {"n_iter": 1}),
        "thomas": (np.arange(40.0), rng.standard_normal((3, 40)), {}),
        "short": (np.arange(2.0), np.ones((2, 2)), {}),
        # a row of zeros (no maxima: the constant envelope 0) and a row
        # holding a NaN
        "zero_nan": (t, zero_nan, {}),
        # |F| of m / 2 periods has m maxima: m + 4 valid knots, at and
        # around the warp-resident solve's 32 and 64 rows
        **{f"tone{m}": (t500, np.stack([np.sin(np.pi * m * t500 / 500) * (1 + 0.3 * np.sin(t500 / 50)),
                                        np.sin(np.pi * m * t500 / 500) * (1.5 + np.cos(t500 / 70))]),
                        {}) for m in (28, 29, 60, 61, 62)},
        # valid knots on each side of 32, 64 and 512 (the block solve's one
        # row a thread up to 512, two past it)
        "knots": (t9, _peaks_rows([31, 32, 33, 63, 64, 65, 511, 512, 513]), {}),
        **many,
    }[case]
    return (torch.from_numpy(t).to(device, dtype),
            torch.from_numpy(np.ascontiguousarray(X)).to(device, dtype), kw)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", ["n2048", "n4096", "edges", "pad1", "pad3", "pad0", "n_iter",
                                  "n_iter0", "n_iter1", "thomas", "short", "zero_nan", "tone28",
                                  "tone29", "tone60", "tone61", "tone62", "knots", "rows1",
                                  "rows131", "rows132", "rows133", "rows300", "edge_shared",
                                  "edge_global"])
def test_amfm_kernel_matches_plain_bit_for_bit(cuda, dtype, case):
    from periodicity_tpu_torch.ops import hht

    t, X, kw = _amfm_case(case, dtype, cuda)
    if case in ("edge_shared", "edge_global"):
        geometry = hht.kernel_geometry(X.shape[1], X.shape[0], dtype)
        assert geometry["in_shared"] == (case == "edge_shared"), geometry
    before = hht.am_fm_normalize.launches
    got = hht._am_fm_cuda(t, X, kw.get("n_iter", 10), kw.get("pad_width", 2), 1e-6)
    assert hht.am_fm_normalize.launches == before + 1
    want = hht.am_fm_normalize_plain(t, X, "spline", **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert _same_bits(a, b)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_amfm_uses_no_local_memory(cuda, dtype):
    """Both of N1's instances (the row's arrays in shared memory, and in
    global scratch) keep their state in registers: 0 bytes of local memory."""
    from periodicity_tpu_torch.ops import hht

    attrs = hht.kernel_attributes(dtype)
    assert set(attrs) == {"shared", "global"}
    for a in attrs.values():
        assert a["local_bytes"] == 0 and 0 < a["registers"] <= 255, attrs


def test_amfm_launch_geometry(cuda):
    """One row a block of 512 threads; at config 9's shape (N = 2048) the
    rows sit in shared memory in both dtypes, one block an SM in float32
    (one row keeps all four schedulers of the SM busy), so B = 8 and
    32 (32 and 128 rows) take one wave and B = 64 (256 rows) two on 132
    SMs; float64 rows of N = 4096 run in global scratch."""
    from periodicity_tpu_torch.ops import hht

    for dtype in (torch.float32, torch.float64):
        for rows in (32, 128, 256):
            g = hht.kernel_geometry(2048, rows, dtype)
            assert g["threads"] == 512 and g["rows_per_block"] == 1, g
            assert g["blocks"] == rows and g["in_shared"] == 1 and g["blocks_per_sm"] >= 1, g
            assert g["waves"] == -(-rows // (g["blocks_per_sm"] * g["sms"])), g
    g = hht.kernel_geometry(2048, 256, torch.float32)
    if g["sms"] == 132:
        assert (g["blocks_per_sm"], g["waves"]) == (1, 2), g
        assert hht.kernel_geometry(2048, 128, torch.float32)["waves"] == 1
    assert hht.kernel_geometry(4096, 2, torch.float64)["in_shared"] == 0
    with pytest.raises(ValueError):
        hht.kernel_geometry(0, 1)


def test_amfm_quotient_is_fdiv_rn(cuda):
    """N1's float32 quotient (csrc/amfm.cu: quot_fast's window tested on
    magnitudes, else the float64-refined quotient for finite nonzero
    operands, else div_rn) gives __fdiv_rn's bit pattern: hashed pairs,
    numerators from the subnormals to 2^-61 over divisors in the window (the
    PCR couplings), and divisors outside the window."""
    lib = _kernels.load()
    stream = torch.cuda.current_stream(cuda).cuda_stream
    for mode in range(4):
        n = 1 << 28
        out = torch.zeros(2, dtype=torch.int64, device=cuda)
        assert lib.amfm_quot_check_f32(n, mode, out.data_ptr(), stream) == 0
        bad, wide = out.tolist()
        assert bad == 0, (mode, bad, wide)
        assert mode == 0 or wide > n // 2, (mode, bad, wide)


def test_one_amfm_launch_per_call(cuda):
    """One N1 launch per normalization, whatever the batch; hht_batch is one
    S1 launch and one N1 launch; HHT one N1 launch for all its modes."""
    from periodicity_tpu_torch.ops import emd, hht
    from periodicity_tpu_torch.timefrequency import HHT, hht_batch

    t, X, _ = _amfm_case("pad1", torch.float64, cuda)
    for fn in (lambda: hht.am_fm_normalize(t, X), lambda: hht.am_fm_normalize(t, X[None]),
               lambda: hht.instant_frequency(t, X, method="NHT")):
        before = hht.am_fm_normalize.launches
        fn()
        assert hht.am_fm_normalize.launches == before + 1
    before = hht.am_fm_normalize.launches, emd.sift_machine.launches
    hht_batch(t, X, np.linspace(0.05, 1.0, 16), max_modes=3)
    assert (hht.am_fm_normalize.launches, emd.sift_machine.launches) == (before[0] + 1,
                                                                         before[1] + 1)
    before = hht.am_fm_normalize.launches
    HHT(np.linspace(0.05, 1.0, 16))(TSeries(t, X[0]))
    assert hht.am_fm_normalize.launches == before + 1


def test_amfm_kernel_raises_and_never_falls_back(cuda, monkeypatch):
    """CPU tensors at the kernel entry, mixed devices, non-contiguous input
    and a wrong dtype raise; a failed launch raises instead of returning
    the plain version's result."""
    from periodicity_tpu_torch.ops import hht

    t, X, _ = _amfm_case("pad1", torch.float64, cuda)
    with pytest.raises(ValueError, match="CUDA"):
        hht._am_fm_cuda(t.cpu(), X.cpu(), 10, 2, 1e-6)
    with pytest.raises(ValueError):
        hht._am_fm_cuda(t.cpu(), X, 10, 2, 1e-6)
    with pytest.raises(ValueError, match="contiguous"):
        hht._am_fm_cuda(t[::2].contiguous(), X[:, ::2], 10, 2, 1e-6)
    with pytest.raises(TypeError):
        hht._am_fm_cuda(t.half(), X.half(), 10, 2, 1e-6)

    class Failing:
        @staticmethod
        def amfm_scratch_bytes(*args):
            return 0

        @staticmethod
        def amfm_normalize_f64(*args):
            return 700  # cudaErrorIllegalAddress

    monkeypatch.setattr(_kernels, "load", lambda: Failing())
    with pytest.raises(RuntimeError, match="launch failed"):
        hht.am_fm_normalize(t, X)


def test_timefrequency_on_card_matches_cpu(cuda):
    """WPS (with its band averages), HHT (DQ on the spline normalization)
    and hht_batch on the card against the CPU port in float64, within 1e-9
    of the largest value."""
    from periodicity_tpu_torch.timefrequency import HHT, WPS, hht_batch

    t = np.linspace(0.0, 10.0, 512)
    rng = np.random.default_rng(5)
    ys = np.stack([np.sin(2 * np.pi * t * 3.0) + 0.5 * np.sin(2 * np.pi * t * 0.4),
                   np.sin(2 * np.pi * t * 5.0) + 0.05 * rng.standard_normal(512)])
    grid = np.linspace(0.1, 8.0, 32)

    def close(a, b):
        scale = max(float(b.abs().max()), 1e-300)
        assert float((a.cpu() - b).abs().max()) <= 1e-9 * scale

    w_card, w_cpu = WPS(np.geomspace(0.1, 3.0, 24)), WPS(np.geomspace(0.1, 3.0, 24))
    close(w_card(TSeries(t, ys[0], device=cuda)).values,
          w_cpu(TSeries(t, ys[0], device="cpu")).values)
    close(w_card.gwps().values, w_cpu.gwps().values)
    close(w_card.sav(0.2, 1.0).values, w_cpu.sav(0.2, 1.0).values)
    h_card, h_cpu = HHT(grid), HHT(grid)
    close(h_card(TSeries(t, ys[0], device=cuda)).values,
          h_cpu(TSeries(t, ys[0], device="cpu")).values)
    assert len(h_card.modes) == len(h_cpu.modes)
    got = hht_batch(torch.from_numpy(t).to(cuda), torch.from_numpy(ys).to(cuda), grid, max_modes=4)
    want = hht_batch(torch.from_numpy(t), torch.from_numpy(ys), grid, max_modes=4)
    assert torch.equal(got[3].cpu(), want[3])
    for a, b in zip(got[:3], want[:3]):
        close(a, b)


def _celerite_draw(b, n, r, dtype, device, seed):
    rng = np.random.default_rng(seed)
    arrays = (rng.uniform(2, 4, (b, n)), 0.3 * rng.standard_normal((b, n, r)),
              0.3 * rng.standard_normal((b, n, r)), rng.uniform(0.5, 1, (b, n - 1, r)),
              rng.standard_normal((b, n)))
    return [torch.from_numpy(a).to(device, dtype).contiguous() for a in arrays]


def _bits(a, b):
    a, b = a.cpu(), b.cpu()
    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
        torch.nan_to_num(a, 0.0), torch.nan_to_num(b, 0.0))


# every batch size that cuts a lane group or a block of walkers, every
# length that cuts a tile of G3's rows (32) or G1's steps (8, 16), and
# config 5's length
CELERITE_DRAWS = [(1, 2148), (3, 1), (4, 2), (5, 31), (33, 32), (64, 33), (65, 2148)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("r", range(1, 17))
@pytest.mark.parametrize("b,n", CELERITE_DRAWS)
def test_celerite_kernels_match_plain_bit_for_bit(cuda, dtype, r, b, n):
    from periodicity_tpu_torch.ops import celerite as C

    A, U, V, P, y = _celerite_draw(b, n, r, dtype, cuda, r * 1000 + n)
    if n > 5:
        A[0, 4] = -1.0  # a row whose D goes non-positive
    # G1 with and without y, the saved state and W
    for yy, save, want_w in ((y, True, True), (None, False, True), (y, False, False),
                             (None, True, False)):
        got = C.celerite_forward(A, U, V, P, yy, save=save, want_w=want_w)
        want = C.celerite_forward_plain(A, U, V, P, yy, save=save)
        for name, a, w in zip(("D", "W", "z", "S_saved", "f_saved"), got, want):
            if name == "W" and not (want_w or save):
                assert a is None
            else:
                assert (a is None) == (w is None) and (a is None or _bits(a, w)), name
    D, W, z, S_saved, f_saved = C.celerite_forward(A, U, V, P, y, save=True)
    rng = np.random.default_rng(n)
    dD, dz = (torch.from_numpy(rng.standard_normal((b, n))).to(cuda, dtype) for _ in range(2))
    for a, w in zip(C.celerite_adjoint(U, P, D, W, z, S_saved, f_saved, dD, dz),
                    C.celerite_adjoint_plain(U, P, D, W, z, S_saved, f_saved, dD, dz)):
        assert _bits(a, w)
    row = b - 1
    for k in (1, 31, 32, 33, 65) + ((2148,) if n == 2148 else ()):
        Y = torch.from_numpy(rng.standard_normal((n, k))).to(cuda, dtype)
        assert _bits(C.celerite_solve(U[row], P[row], D[row], W[row], Y),
                     C.celerite_solve_plain(U[row], P[row], D[row], W[row], Y)), k


def _same_bits(a, b):
    """a and b hold the same bit patterns, signed zeros included; NaN where
    the other is NaN."""
    a, b = a.cpu(), b.cpu()
    nan = torch.isnan(a)
    view = torch.int64 if a.dtype == torch.float64 else torch.int32
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a.view(view)[~nan],
                                                           b.view(view)[~nan])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("r", range(2, 17))
def test_celerite_adjoint_masked_slots_match_plain_bit_for_bit(cuda, dtype, r):
    """A masked term's slots are zero columns of U and V, so their W and
    W-bar stay 0 and G2 divides 0 by D at every step (outside the
    division's slow path): the same bit patterns as the plain version,
    signed zeros included."""
    from periodicity_tpu_torch.ops import celerite as C

    A, U, V, P, y = _celerite_draw(5, 300, r, dtype, cuda, 77 + r)
    masked = [r - 1] + ([1] if r >= 4 else [])
    U[..., masked] = 0
    V[..., masked] = 0
    A[0, 40] = -1.0  # a row whose D goes non-positive
    D, W, z, S_saved, f_saved = C.celerite_forward(A, U, V, P, y, save=True)
    assert bool((W[..., masked] == 0).all())
    rng = np.random.default_rng(r)
    dD, dz = (torch.from_numpy(rng.standard_normal((5, 300))).to(cuda, dtype) for _ in range(2))
    for a, w in zip(C.celerite_adjoint(U, P, D, W, z, S_saved, f_saved, dD, dz),
                    C.celerite_adjoint_plain(U, P, D, W, z, S_saved, f_saved, dD, dz)):
        assert _same_bits(a, w)


def test_celerite_launch_geometry(cuda):
    from periodicity_tpu_torch.ops import celerite as C

    for r in range(1, C.MAX_R + 1):
        for b in (1, 3, 4, 5, 8, 33, 64, 65):
            for adjoint in (False, True):
                g = C.kernel_geometry(b=b, r=r, adjoint=adjoint)
                # G1's and G2's groups: a power of two >= R lanes inside a
                # warp; every walker has a block and no block is empty
                lanes, walkers, blocks = g["lanes"], g["walkers"], g["blocks"]
                assert lanes & (lanes - 1) == 0 and r <= lanes < 2 * r or lanes == r == 1
                assert lanes * walkers == 32 and (blocks - 1) * walkers < b <= blocks * walkers
    for r in range(1, C.MAX_R + 1):
        for k in (1, 3, 31, 32, 33, 64, 65, 2148):
            g = C.kernel_geometry(k=k, r=r)
            assert 32 <= g["columns"] <= 64 and g["row_tile"] == (32 if r <= 8 else 16)
            assert (g["blocks"] - 1) * g["columns"] < k <= g["blocks"] * g["columns"]
    # config 5's 64 walkers (R = 6) cover at least 16 SMs in G1 and G2,
    # loocv's 2148 right-hand sides at least 34; past R = 8 two walkers a warp
    assert C.kernel_geometry(b=64, r=6)["blocks"] >= 16
    assert C.kernel_geometry(b=64, r=6, adjoint=True)["blocks"] >= 16
    assert C.kernel_geometry(b=64, r=12)["walkers"] == 2
    assert C.kernel_geometry(k=2148, r=6)["blocks"] >= 34
    with pytest.raises(ValueError):
        C.kernel_geometry(b=1, r=C.MAX_R + 1)
    with pytest.raises(ValueError):
        C.kernel_geometry(b=1, r=C.MAX_R + 1, adjoint=True)
    with pytest.raises(ValueError):
        C.kernel_geometry(k=1, r=C.MAX_R + 1)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("r", range(1, 9))
def test_celerite_adjoint_uses_no_local_memory(cuda, r, dtype):
    """G2 keeps its rows in registers: every instantiation compiles to 0
    bytes of local memory, and its shared tiles fit a Hopper block."""
    from periodicity_tpu_torch.ops import celerite as C

    a = C.kernel_attributes(r, dtype)["adjoint"]
    assert a["local_bytes"] == 0, a
    assert 0 < a["registers"] <= 255 and 0 < a["shared_bytes"] <= 227 * 1024, a
    # nor do G1's four forms; G3 neither, but in float64 at R = 5, whose 8
    # bytes of stack (4 spilled) ptxas has reported since G3's redesign
    for name, k in C.kernel_attributes(r, dtype).items():
        g3_stack = 8 if name == "solve" and (r, dtype) == (5, torch.float64) else 0
        assert k["local_bytes"] == g3_stack and 0 < k["registers"] <= 255, (name, k)
        assert name == "adjoint" or k["shared_bytes"] <= 48 * 1024, (name, k)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("r", range(9, 17))
def test_wide_celerite_adjoint_fits_a_block(cuda, r, dtype):
    """Past R = 8 G2's rows may spill to local memory (the smoke prints how
    much), but its tiles still fit a Hopper block."""
    from periodicity_tpu_torch.ops import celerite as C

    a = C.kernel_attributes(r, dtype)["adjoint"]
    assert 0 < a["registers"] <= 255 and 0 < a["shared_bytes"] <= 227 * 1024, a


def test_one_celerite_launch_per_call_and_factor_without_rhs(cuda):
    from periodicity_tpu_torch.ops import celerite as C

    A, U, V, P, y = _celerite_draw(4, 100, 6, torch.float64, cuda, 1)
    f0, a0, s0 = C.celerite_forward.launches, C.celerite_adjoint.launches, C.celerite_solve.launches
    D, W, z, S_saved, f_saved = C.celerite_forward(A, U, V, P, y, save=True)
    D2, W2, z2, none1, none2 = C.celerite_forward(A, U, V, P)
    assert z2 is None and none1 is None and none2 is None
    assert torch.equal(D, D2) and torch.equal(W, W2)
    C.celerite_adjoint(U, P, D, W, z, S_saved, f_saved, torch.ones_like(D), torch.ones_like(D))
    C.celerite_solve(U[0], P[0], D[0], W[0], torch.ones(100, 3, dtype=torch.float64, device=cuda))
    C.celerite_solve(U[0], P[0], D[0], W[0], torch.ones(100, dtype=torch.float64, device=cuda))
    assert C.celerite_forward.launches == f0 + 2
    assert C.celerite_adjoint.launches == a0 + 1
    assert C.celerite_solve.launches == s0 + 2


def test_celerite_kernels_raise_and_never_fall_back(cuda, monkeypatch):
    from periodicity_tpu_torch.ops import _kernels
    from periodicity_tpu_torch.ops import celerite as C

    # one slot past the widest instantiation raises on the card, for G1, G2
    # (through CeleriteLikelihood's forward and called alone) and G3; the
    # CPU takes the term
    r = C.MAX_R + 1
    A, U, V, P, y = _celerite_draw(2, 50, r, torch.float64, cuda, 3)
    with pytest.raises(ValueError, match=f"1 to {C.MAX_R}"):
        C.celerite_forward(A, U, V, P, y)
    with pytest.raises(ValueError, match=f"1 to {C.MAX_R}"):
        C.celerite_solve(U[0], P[0], A[0], U[0], y[0])
    with pytest.raises(ValueError, match=f"1 to {C.MAX_R}"):
        C.CeleriteLikelihood.apply(A, U.clone().requires_grad_(), V, P, y)
    with pytest.raises(ValueError, match=f"1 to {C.MAX_R}"):
        C.celerite_adjoint(U, P, A, U, y, U.new_zeros((2, 49, r * (r + 1) // 2)), P, A, y)
    D = C.celerite_forward(*(x.cpu() for x in (A, U, V, P, y)))[0]
    assert D.shape == (2, 50) and bool(torch.isfinite(D).all())
    A, U, V, P, y = _celerite_draw(2, 50, 4, torch.float64, cuda, 3)
    with pytest.raises(ValueError):
        C.celerite_forward(A.float(), U, V, P, y)
    with pytest.raises(ValueError):
        C.celerite_forward(A, U, V, P[:, :10], y)

    class Failing:
        @staticmethod
        def celerite_forward_f64(*args):
            return 700  # cudaErrorIllegalAddress

    monkeypatch.setattr(_kernels, "load", lambda: Failing())
    with pytest.raises(RuntimeError, match="launch failed"):
        C.celerite_forward(A, U, V, P, y)


def test_gp_likelihood_gradient_on_card_matches_cpu(cuda):
    """The likelihood and its gradient through G1 and G2 on the card against
    the CPU port, batched over walkers, within 1e-10 relative."""
    from periodicity_tpu_torch.models.gp.solver import log_likelihood
    from periodicity_tpu_torch.models.gp.terms import BrownianTerm, RotationTerm

    t, y, dy = SpottedStar()
    w = np.random.default_rng(0).uniform(0.8, 1.2, (5, 4))
    out = {}
    for device in (cuda, torch.device("cpu")):
        p = torch.from_numpy(w).to(device).requires_grad_(True)
        tt, yy, dd = (torch.from_numpy(a).to(device) for a in (t, y - y.mean(), dy**2))
        ll = (log_likelihood(BrownianTerm(0.01 * p[:, 0], 20 * p[:, 1], 10 * p[:, 2],
                                          0.3 * p[:, 3]), tt, dd, yy)
              + log_likelihood(RotationTerm(sigma=0.01 * p[:, 0], period=10 * p[:, 2], Q0=p[:, 1],
                                            dQ=p[:, 3], f=0.3), tt, dd, yy))
        (g,) = torch.autograd.grad(ll.sum(), p)
        out[device.type] = (ll.detach().cpu(), g.cpu())
    for a, b in zip(out["cuda"], out["cpu"]):
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-10


def test_gp_arrays_land_on_card_and_card_tensors_stay_there(cuda):
    """Arrays with no device go to the card and launch G1 there; a term of
    CPU tensors follows card times to the card; a term on the card never
    meets CPU times, and card times never meet CPU residuals: both raise."""
    from periodicity_tpu_torch.models.gp.solver import GaussianProcess, log_likelihood
    from periodicity_tpu_torch.models.gp.terms import BrownianTerm, SHOTerm
    from periodicity_tpu_torch.ops import celerite as C

    t, y, dy = SpottedStar()
    t, y, dy = t[:300], y[:300] - y[:300].mean(), dy[:300]
    C.celerite_forward.launches = 0
    ll = log_likelihood(SHOTerm(S0=1e-4, w0=0.6, Q=3.0), t, dy**2, y)
    assert ll.device.type == "cuda" and C.celerite_forward.launches == 1
    gp = GaussianProcess(BrownianTerm(0.01, 20.0, 10.0, 0.3)).compute(t, yerr=dy)
    assert gp._t.device.type == "cuda" and gp.log_likelihood(y).device.type == "cuda"
    assert gp.predict(y, t=t[:5]).device.type == "cuda"
    term = BrownianTerm(0.01, 20.0, 10.0, 0.3)
    assert term.get_value(t[:5]).device.type == "cuda"
    assert term.get_psd(t[:5]).device.type == "cuda"
    tt, yy, dd = (torch.from_numpy(a).to(cuda) for a in (t, y, dy**2))
    cpu_term = BrownianTerm(torch.tensor([0.01, 0.02], dtype=torch.float64), 20.0, 10.0, 0.3)
    C.celerite_forward.launches = 0
    assert log_likelihood(cpu_term, tt, dd, yy).device.type == "cuda"
    assert C.celerite_forward.launches == 1
    card_term = BrownianTerm(torch.tensor([0.01, 0.02], dtype=torch.float64, device=cuda), 20.0,
                             10.0, 0.3)
    with pytest.raises(ValueError, match="move one of them"):
        log_likelihood(card_term, tt.cpu(), dd.cpu(), yy.cpu())
    with pytest.raises(ValueError, match="expected a tensor on cuda"):
        log_likelihood(term, tt, dd, yy.cpu())


def test_qpgp_reference_checks_on_card_from_theta0(cuda):
    """Reference tests/test_gp.py:144-160 on the card: minimize from the
    default theta0 ends at or below nll(theta0), and the prediction there is
    finite with sd >= 0."""
    from periodicity_tpu_torch.gp import QuasiPeriodicGP

    rng = np.random.default_rng(42)
    t = np.linspace(0, 10, 120)
    y = np.sin(np.pi * t) + 0.1 * rng.standard_normal(120)
    model = QuasiPeriodicGP(TSeries(t, y, device=cuda), np.full(120, 0.1))
    nll0 = model.nll(model.theta0)
    assert np.isfinite(nll0)
    soln, _ = model.minimize()
    assert soln.fun <= nll0
    mu, sd = model.predict(soln.x, t[:10])
    assert mu.device.type == "cuda" and bool(torch.isfinite(mu).all())
    assert bool((sd >= 0).all())


@pytest.mark.parametrize("name", ["BrownianGP", "HarmonicGP"])
def test_gp_modelers_reference_thresholds_on_card(cuda, name):
    """Reference tests/test_gp.py:24-58 on the card: minimize below the
    threshold inside the box; mcmc(16, 1000, burn 200, seed 42) with the
    median period rounding to 10 (BrownianGP) and 11 (HarmonicGP)."""
    from periodicity_tpu_torch import gp

    t, y, dy = SpottedStar()
    model = getattr(gp, name)(TSeries(t, y, device=cuda), err=dy)
    soln, _ = model.minimize(model.gp)
    assert soln.fun < {"BrownianGP": -12890, "HarmonicGP": -13180}[name]
    assert np.all((soln.x <= 99.99) & (soln.x >= 0.01))
    trace, _ = model.mcmc(n_walkers=16, n_steps=1000, burn=200, random_seed=42)
    assert trace["period"].shape == (16 * 800,)
    assert np.round(np.median(trace["period"]), 0) == {"BrownianGP": 10.0, "HarmonicGP": 11.0}[name]


def test_gp_modelers_on_card_match_cpu(cuda):
    """nll, log_prob (batched), predictions, PSD and loocv of BrownianGP and
    HarmonicGP, and QuasiPeriodicGP's nll and prediction, card against the
    CPU port in float64."""
    from periodicity_tpu_torch.gp import BrownianGP, HarmonicGP, QuasiPeriodicGP

    t, y, dy = SpottedStar()
    n = 400
    t, y, dy = t[:n], y[:n], dy[:n]
    rng = np.random.default_rng(9)

    def close(a, b, tol=1e-10):
        a, b = torch.as_tensor(a).cpu(), torch.as_tensor(b)
        assert float((a - b).abs().max()) <= tol * max(float(b.abs().max()), 1e-300)

    for cls in (BrownianGP, HarmonicGP):
        mc = cls(TSeries(t, y, device=cuda), err=dy)
        mh = cls(TSeries(t, y, device="cpu"), err=torch.from_numpy(dy))
        U = rng.uniform(5, 95, (4, mc.ndim))
        close(mc._log_prob_u(torch.from_numpy(U).to(cuda)), mh._log_prob_u(torch.from_numpy(U)))
        assert mc.nll(U[0]) == pytest.approx(mh.nll(U[0]), rel=1e-10)
        gc = mc.set_params(dict(mc.prior_transform(U[1])), mc.gp)
        gh = mh.set_params(dict(mh.prior_transform(U[1])), mh.gp)
        tn = np.linspace(t[0], t[-1], 50)
        for a, b in zip(mc.get_prediction(tn, gc), mh.get_prediction(tn, gh)):
            close(a, b, 1e-9)
        close(mc.get_psd(np.linspace(0.01, 2, 30), gc), mh.get_psd(np.linspace(0.01, 2, 30), gh))
        close(mc.loocv(gc), mh.loocv(gh), 1e-9)
    tq = np.linspace(0, 10, 120)
    yq = np.sin(np.pi * tq) + 0.1 * np.random.default_rng(42).standard_normal(120)
    qc = QuasiPeriodicGP(TSeries(tq, yq, device=cuda), np.full(120, 0.1))
    qh = QuasiPeriodicGP(TSeries(tq, yq, device="cpu"), torch.full((120,), 0.1,
                                                                   dtype=torch.float64))
    assert qc.nll(qc.theta0) == pytest.approx(qh.nll(qh.theta0), rel=1e-10)
    theta = np.array([0.0, np.log(0.01), np.log(0.5), np.log(25.0), 2.0, np.log(2.0)])
    for a, b in zip(qc.predict(theta, tq[:10]), qh.predict(theta, tq[:10])):
        close(a, b, 1e-9)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("r", range(1, 17))
def test_kalman_kernel_matches_plain_bit_for_bit(cuda, dtype, r):
    """K1 against its plain version at R = 1..16: from the identity and from
    an incoming carry, block counts that divide N, that do not, and more
    blocks than samples (blocks past the end left out of the scan), and
    scans of 1 to 65 leaves."""
    from chip_smoke import k1_draw
    from periodicity_tpu_torch.models.gp import pscan
    from periodicity_tpu_torch.ops import kalman as K

    rng = np.random.default_rng(r)
    for b, n, nb in ((3, 257, 7), (2, 64, 8), (1, 5, 16), (2, 1, 1), (1, 80, 39), (2, 130, 64),
                     (1, 20, 64), (2, 300, 1)):
        coeffs, dt, A, Q, H, diag, y = k1_draw(rng, r, b, n, dtype)
        _, _, carry = K.kalman_blocked_plain(A, Q, H, diag, y, 3)
        Ac = pscan._ssm_from_dt(coeffs, dt)[0]
        Qc = pscan._noise(Ac, pscan._ssm_from_dt(coeffs, dt)[1])
        for args, start in (((A, Q, H, diag, y), None), ((Ac, Qc, H, diag, y), carry)):
            args = [x.contiguous() for x in args]
            want = K.kalman_blocked_plain(*args, nb, start)
            got = K.kalman_blocked(*(x.to(cuda) for x in args), nb,
                                   None if start is None else tuple(c.to(cuda) for c in start))
            assert all(_bits(a, w) for a, w in zip((got[0], got[1], *got[2]),
                                                   (want[0], want[1], *want[2])))


def test_kalman_launch_geometry(cuda):
    """K1's launches as csrc/kalman.cu reports them: a group of a power of
    two >= R lanes inside a warp; every position, chain and leaf has a
    block and no block is empty; the scan's launches are ceil(log2) of its
    leaves (one for a lone leaf); config 7's points."""
    from periodicity_tpu_torch.ops import kalman as K

    for dtype in (torch.float32, torch.float64):
        for r in range(1, K.MAX_R + 1):
            for b, n, nb in ((1, 10_000, 39), (1, 100_000, 390), (1, 65536, 512), (64, 2148, 64),
                             (3, 5, 16), (2, 1, 1), (1, 16960, 512)):
                for carry in (False, True):
                    g = K.kernel_geometry(b, n, r, nb, carry, dtype)
                    lanes = g["lanes"]
                    assert lanes & (lanes - 1) == 0 and (r <= lanes < 2 * r or lanes == r == 1)
                    length, m = K.block_geometry(n, nb)
                    assert (g["length"], g["blocks"]) == (length, m)
                    assert g["leaves"] == m + carry
                    assert g["tree_launches"] == max(1, K.tree_levels(m + carry))
                    # stages 0 and 2 take half the threads where their
                    # static tiles would outgrow 48 KB (float64, R >= 13)
                    per, blocks = g["element_positions"], g["element_blocks"]
                    assert per * lanes in ((128,) if r <= 8 else (64, 128))
                    assert (blocks - 1) * per < b * n <= blocks * per
                    per, blocks = g["prefix_chains"], g["prefix_blocks"]
                    assert per * lanes == 32 and (blocks - 1) * per < b * m <= blocks * per
                    assert g["prefix_threads"] == 64 and 1 <= g["step_tile"] <= 16
                    per, blocks = g["group_items"], g["innovation_blocks"]
                    assert per * lanes == 128 and (blocks - 1) * per < b * n <= blocks * per
                    per, blocks = g["tree_items"], g["tree_blocks"]
                    assert per * lanes in ((64,) if r <= 8 else (32, 64))
                    assert (blocks - 1) * per < b * (m + carry) <= blocks * per
    g = K.kernel_geometry(1, 100_000, 4, 390)
    assert (g["length"], g["blocks"], g["tree_launches"], g["prefix_blocks"]) == (257, 390, 9, 49)
    g = K.kernel_geometry(1, 10_000, 4, 39)
    assert (g["length"], g["blocks"], g["tree_launches"], g["prefix_blocks"]) == (257, 39, 6, 5)
    with pytest.raises(ValueError):
        K.kernel_geometry(1, 10, K.MAX_R + 1, 2)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("r", range(1, 9))
def test_kalman_uses_no_local_memory(cuda, r, dtype):
    """K1's four stages keep each lane's rows in registers: every
    instantiation compiles to 0 bytes of local memory, and its shared tiles
    fit in 48 KB of static shared memory."""
    from periodicity_tpu_torch.ops import kalman as K

    for stage, a in K.kernel_attributes(r, dtype).items():
        assert a["local_bytes"] == 0, (stage, a)
        assert 0 < a["registers"] <= 255 and 0 < a["shared_bytes"] <= 48 * 1024, (stage, a)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("r", range(9, 17))
def test_wide_kalman_stages_fit_a_block(cuda, r, dtype):
    """Past R = 8 a composition's columns may spill to local memory (the
    smoke prints how much); stages 0, 2 and 3 keep 48 KB of static shared
    memory and stage 1 its dynamic tiles within 96 KB."""
    from periodicity_tpu_torch.ops import kalman as K

    for stage, a in K.kernel_attributes(r, dtype).items():
        limit = 96 * 1024 if stage == "prefix" else 48 * 1024
        assert 0 < a["registers"] <= 255 and 0 < a["shared_bytes"] <= limit, (stage, a)


def test_kalman_quotient_is_fdiv_rn(cuda):
    """K1's float32 division (csrc/kalman.cu::quot: the float64 reciprocal
    estimate, a Newton step and a correction, rounded to float32, with a
    float64 division for subnormal quotients and special operands) gives
    __fdiv_rn's bit pattern: hashed pairs anywhere, tiny and subnormal
    numerators, zero numerators, quotients on subnormal rounding midpoints,
    and both operands within 2^+-60."""
    lib = _kernels.load()
    stream = torch.cuda.current_stream(cuda).cuda_stream
    for mode, n in ((0, 1 << 30), (1, 1 << 30), (2, 1 << 26), (3, 1 << 28), (4, 1 << 30)):
        out = torch.zeros(2, dtype=torch.int64, device=cuda)
        assert lib.kalman_quot_check_f32(n, mode, out.data_ptr(), stream) == 0
        bad, fast = out.tolist()
        assert bad == 0, (mode, bad, fast)
        assert mode not in (1, 4) or fast > n // 2, (mode, bad, fast)


def test_kalman_kernel_counts_raises_and_never_falls_back(cuda, monkeypatch):
    from chip_smoke import k1_draw
    from periodicity_tpu_torch.ops import _kernels
    from periodicity_tpu_torch.ops import kalman as K

    _, _, A, Q, H, diag, y = k1_draw(np.random.default_rng(0), 4, 2, 30, torch.float64)
    A, Q, H, diag, y = (x.to(cuda) for x in (A, Q, H, diag, y))
    before = K.kalman_blocked.launches
    K.kalman_blocked(A, Q, H, diag, y, 4)
    assert K.kalman_blocked.launches == before + 1
    with pytest.raises(ValueError):
        K.kalman_blocked(A.float(), Q, H, diag, y, 4)
    with pytest.raises(ValueError):
        K.kalman_blocked(A, Q[:, :10], H, diag, y, 4)
    r = K.MAX_R + 1
    wide = torch.zeros((1, 5, r, r), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match=f"1 to {K.MAX_R}"):
        K.kalman_blocked(wide, wide, torch.ones(r, dtype=torch.float64, device=cuda),
                         diag[:1, :5], y[:1, :5], 2)

    class Failing:
        @staticmethod
        def kalman_blocked_f64(*args):
            return 700  # cudaErrorIllegalAddress

    monkeypatch.setattr(_kernels, "load", lambda: Failing())
    with pytest.raises(RuntimeError, match="launch failed"):
        K.kalman_blocked(A, Q, H, diag, y, 4)


K2_SHAPES = ((3, 257, 7), (2, 64, 8), (1, 5, 16), (2, 1, 1), (1, 80, 39), (2, 130, 64),
             (1, 20, 64), (2, 300, 1))
K2_SHAPES_WIDE = ((3, 57, 7), (2, 64, 8), (1, 5, 16), (2, 1, 1), (1, 80, 39), (2, 130, 64),
                  (1, 20, 64), (2, 60, 1))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("r", range(1, 17))
def test_kalman_adjoint_matches_plain_bit_for_bit(cuda, dtype, r):
    """K2 against its plain version at R = 1..16 over K1's test geometries
    (past R = 8 shorter series: the plain version steps through numpy),
    from the identity and from a carry, with a cotangent on the outgoing
    carry and without; the prefixes K1 hands it on the card; two launches
    give the same bits."""
    from chip_smoke import k1_draw
    from periodicity_tpu_torch.models.gp import pscan
    from periodicity_tpu_torch.ops import kalman as K

    rng = np.random.default_rng(100 + r)
    for b, n, nb in (K2_SHAPES if r <= 8 else K2_SHAPES_WIDE):
        coeffs, dt, A, Q, H, diag, y = k1_draw(rng, r, b, n, dtype)
        _, _, carry = K.kalman_blocked_plain(A, Q, H, diag, y, 3)
        Ac, Pinf, _ = pscan._ssm_from_dt(coeffs, dt)
        Qc = pscan._noise(Ac, Pinf)
        for args, start in (((A, Q, H, diag, y), None), ((Ac, Qc, H, diag, y), carry)):
            args = [x.contiguous() for x in args]
            dmu, ds = (torch.from_numpy(rng.standard_normal((b, n))).to(dtype) for _ in "ab")
            dc = tuple(torch.from_numpy(rng.standard_normal(x.shape)).to(dtype)
                       for x in (start or carry))
            for dcarry in (None, dc):
                _, _, _, pre = K.kalman_blocked_plain(*args, nb, start, prefixes=True)
                want = K.kalman_blocked_adjoint_plain(*args, nb, start, pre, dmu, ds, dcarry)
                on = [x.to(cuda) for x in args]
                st = None if start is None else tuple(c.to(cuda) for c in start)
                _, _, _, pre_c = K.kalman_blocked(*on, nb, st, prefixes=True)
                assert _bits(pre_c, pre)
                dcc = None if dcarry is None else tuple(c.to(cuda) for c in dcarry)
                got = K.kalman_blocked_adjoint(*on, nb, st, pre_c, dmu.to(cuda), ds.to(cuda),
                                               dcc)
                again = K.kalman_blocked_adjoint(*on, nb, st, pre_c, dmu.to(cuda),
                                                 ds.to(cuda), dcc)
                flat = lambda g: list(g[:4]) + list(g[4] or ())  # noqa: E731
                assert (got[4] is None) == (start is None)
                assert all(_bits(a, w) for a, w in zip(flat(got), flat(want))), (b, n, nb)
                assert all(_bits(a, w.cpu()) for a, w in zip(flat(again), flat(got)))


def test_kalman_adjoint_geometry_and_attributes(cuda):
    """K2's launches as csrc/kalman_adjoint.cu reports them (a group of
    lanes an item, one warp a block; 2 levels + 5 launches a call) and
    every width's compiled resources, printed (run with -s): registers
    within 255 a thread, the groups' slots in shared memory (none in the
    leaf kernel, a thread a value)."""
    from periodicity_tpu_torch.ops import kalman as K

    for b, n, nb, carry in ((1, 100_000, 390, False), (1, 65536, 512, True), (3, 5, 16, False)):
        g = K.kernel_geometry(b, n, 4, nb, carry, adjoint=True)
        length, m = K.block_geometry(n, nb)
        assert (g["length"], g["blocks"], g["leaves"]) == (length, m, m + carry)
        assert g["levels"] == K.tree_levels(m + carry) and g["launches"] == 2 * g["levels"] + 5
        assert (g["lanes"], g["group_items"]) == (4, 8), g
        assert (g["position_blocks"] - 1) * g["group_items"] < b * n <= g["position_blocks"] * g[
            "group_items"]
    for dtype in (torch.float32, torch.float64):
        for r in range(1, K.MAX_R + 1):
            att = K.kernel_attributes(r, dtype, adjoint=True)
            print(f"K2 R={r} {dtype}: " + ", ".join(
                f"{k} {v['local_bytes']} B local / {v['registers']} regs" for k, v in att.items()))
            assert all(0 < v["registers"] <= 255 and (v["shared_bytes"] == 0) == (k == "leaf")
                       for k, v in att.items()), att


def test_kalman_adjoint_counts_raises_and_never_falls_back(cuda, monkeypatch):
    from chip_smoke import k1_draw
    from periodicity_tpu_torch.ops import _kernels
    from periodicity_tpu_torch.ops import kalman as K

    _, _, A, Q, H, diag, y = k1_draw(np.random.default_rng(0), 4, 2, 30, torch.float64)
    A, Q, H, diag, y = (x.to(cuda) for x in (A, Q, H, diag, y))
    _, _, _, pre = K.kalman_blocked(A, Q, H, diag, y, 4, prefixes=True)
    before = K.kalman_blocked_adjoint.launches
    K.kalman_blocked_adjoint(A, Q, H, diag, y, 4, None, pre, diag, y)
    assert K.kalman_blocked_adjoint.launches == before + 1
    with pytest.raises(ValueError):
        K.kalman_blocked_adjoint(A, Q, H, diag, y, 4, None, pre.float(), diag, y)
    with pytest.raises(ValueError):
        K.kalman_blocked_adjoint(A, Q, H, diag, y, 4, None, pre[:, :10], diag, y)

    class Failing:
        @staticmethod
        def kalman_blocked_adjoint_f64(*args):
            return 700  # cudaErrorIllegalAddress

    monkeypatch.setattr(_kernels, "load", lambda: Failing())
    with pytest.raises(RuntimeError, match="launch failed"):
        K.kalman_blocked_adjoint(A, Q, H, diag, y, 4, None, pre, diag, y)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kalman_solvers_on_card_match_cpu(cuda, dtype):
    """pscan, blocked and chunked on the card against the CPU port (the
    card's exp, cos and products may differ from the host's by an ulp), and
    the gradients of blocked and chunked, through K1 and K2: in float64
    within 1e-10 of the CPU port's and within JAX's 1e-6 of the scan's; in
    float32 within twice the float32 scan's own error of the float64
    scan's gradient."""
    from periodicity_tpu_torch.gp import (BrownianTerm, log_likelihood, log_likelihood_blocked,
                                          log_likelihood_chunked, log_likelihood_pscan)

    rng = np.random.default_rng(12)
    n = 777
    t = np.sort(rng.uniform(0, 60, n))
    y = np.sin(2 * np.pi * t / 9.0) + 0.1 * rng.standard_normal(n)
    data = [torch.from_numpy(a).to(dtype) for a in (t, np.full(n, 0.02), y - y.mean())]
    rel = 1e-12 if dtype == torch.float64 else 1e-5
    calls = {"pscan": log_likelihood_pscan,
             "blocked": lambda *a: log_likelihood_blocked(*a, n_blocks=16),
             "chunked": lambda *a: log_likelihood_chunked(*a, chunk=256, inner_blocks=64)}
    for name, fn in calls.items():
        host = fn(BrownianTerm(0.01, 20.0, 10.0, 0.3), *data)
        card = fn(BrownianTerm(0.01, 20.0, 10.0, 0.3), *(a.to(cuda) for a in data))
        assert card.device.type == "cuda"
        assert float(card) == pytest.approx(float(host), rel=rel), name
    grads = {}
    for name, fn in (("scan", log_likelihood), ("blocked", calls["blocked"]),
                     ("chunked", calls["chunked"])):
        for where in ("cuda", "cpu"):
            for dt in (dtype, torch.float64):
                pg = torch.tensor([0.01, 20.0, 10.0, 0.3], dtype=dt, device=where,
                                  requires_grad=True)
                ll = fn(BrownianTerm(pg[0], pg[1], pg[2], pg[3]),
                        *(a.to(where, dt) for a in data))
                (grads[name, where, dt],) = torch.autograd.grad(ll, pg)
    ref = grads["scan", "cpu", torch.float64]

    def rel(a, b):
        a, b = a.cpu().double(), b.cpu().double()
        return float(((a - b) / b).abs().max())

    for name in ("blocked", "chunked"):
        if dtype == torch.float64:
            assert rel(grads[name, "cuda", dtype], grads[name, "cpu", dtype]) <= 1e-10, name
            assert rel(grads[name, "cuda", dtype], grads["scan", "cuda", dtype]) <= 1e-6, name
        else:
            assert rel(grads[name, "cuda", dtype], ref) <= 2 * rel(
                grads["scan", "cuda", dtype], ref), name


def test_nuts_step_on_card_matches_cpu_with_the_same_draws(cuda):
    """One NUTS transition of 4 chains on a BrownianTerm posterior (f64; the
    leapfrog's gradient through G1 and G2 on the card) against the CPU port
    fed the same draws: equal depths, leaf counts and divergence flags, z
    within 1e-10."""
    from periodicity_tpu_torch.gp import BrownianTerm, log_likelihood
    from periodicity_tpu_torch.models.gp import nuts as N

    rng = np.random.default_rng(7)
    t = np.sort(rng.uniform(0, 60, 120))
    y = np.sin(2 * np.pi * t / 9.0) + 0.1 * rng.standard_normal(120)
    max_depth = 5
    draws = (rng.standard_normal((4, 4)), rng.random((4, max_depth)) < 0.5,
             rng.random((4, max_depth, 1 << (max_depth - 1))), rng.random((4, max_depth)))
    z0 = 0.3 * rng.standard_normal((4, 4))
    eps = np.array([0.05, 0.2, 0.6, 1.5])
    results = {}
    for dev in (torch.device("cpu"), cuda):
        tt, yy = (torch.from_numpy(a).to(dev) for a in (t, y - y.mean()))
        diag = torch.full_like(tt, 0.01)

        def lp(w, tt=tt, yy=yy, diag=diag):
            term = BrownianTerm(0.3 * torch.exp(w[:, 0]), 20.0 * torch.exp(w[:, 1]),
                                9.0 * torch.exp(w[:, 2]), 0.3 * torch.sigmoid(w[:, 3]))
            ll = log_likelihood(term, tt, diag, yy)
            return torch.where(torch.isfinite(ll), ll, -1e25) - 0.5 * torch.sum(w**2, dim=-1)

        vg = N._value_and_grad(lp)
        z = torch.from_numpy(z0).to(dev)
        logp, grad = vg(z)
        out = N._nuts_step(vg, z, logp, grad, torch.from_numpy(eps).to(dev),
                           torch.ones_like(z), max_depth,
                           tuple(torch.from_numpy(np.asarray(d)).to(dev) for d in draws))
        results[dev.type] = [x.cpu() for x in out]
    host, card = results["cpu"], results["cuda"]
    for i in (4, 5, 6):  # leaves, divergence, depth
        assert torch.equal(card[i], host[i])
    np.testing.assert_allclose(card[0].numpy(), host[0].numpy(), rtol=1e-10, atol=1e-12)
    assert len(set(host[6].tolist())) > 1


def test_modelers_nuts_and_solvers_on_card(cuda):
    """BrownianGP with every solver on the card against the CPU port (nll,
    f64), and both families' .nuts() on the card at a small shape."""
    from periodicity_tpu_torch.gp import BrownianGP, QuasiPeriodicGP

    t, y, dy = SpottedStar()
    u = np.full(6, 50.0)
    for solver in ("pscan", "blocked", "chunked"):
        card = BrownianGP(TSeries(torch.from_numpy(t).to(cuda), torch.from_numpy(y).to(cuda)),
                          err=torch.from_numpy(dy).to(cuda), solver=solver)
        host = BrownianGP(TSeries(t, y, device="cpu"), err=torch.from_numpy(dy), solver=solver)
        assert card.nll(u) == pytest.approx(host.nll(u), rel=1e-10)
    n = 60
    pm = BrownianGP(TSeries(torch.from_numpy(t[:n]).to(cuda), torch.from_numpy(y[:n]).to(cuda)),
                    err=torch.from_numpy(dy[:n]).to(cuda))
    trace, tau = pm.nuts(n_chains=2, n_steps=8, n_warmup=6, burn=2, max_depth=4,
                         random_seed=1)
    assert trace["period"].shape == (12,) and np.all(np.isfinite(trace["period"]))
    assert np.all((pm.chain > 0) & (pm.chain < 100))
    qp = QuasiPeriodicGP(TSeries(torch.from_numpy(t[:n]).to(cuda),
                                 torch.from_numpy(y[:n]).to(cuda)),
                         torch.from_numpy(dy[:n]).to(cuda))
    samples, _ = qp.nuts(n_chains=2, n_steps=6, n_warmup=4, burn=1, max_depth=3, random_seed=0)
    assert samples.shape == (qp.ndim, 10) and np.all(np.isfinite(samples))


# -- the parallel package and the sharded GP at world size 1 (NCCL), and D = 4
# ranks' stages in turn on the card against the CPU ---------------------------


@pytest.fixture(scope="module")
def nccl_mesh():
    """A world of one on NCCL, started by default_mesh and destroyed when
    the module ends."""
    import torch.distributed as dist

    from periodicity_tpu_torch.parallel import default_mesh

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    started = not dist.is_initialized()
    yield default_mesh(("grid",))
    if started and dist.is_initialized():
        dist.destroy_process_group()


def test_sharded_scans_at_world_one_are_the_kernel_calls(cuda, nccl_mesh):
    """sharded_gls through the spreading kernel, bit-equal to gls_power;
    sharded_bls / sharded_aov through the fold kernel bit-equal to their
    unsharded calls (the fold sums in a fixed order)."""
    from periodicity_tpu_torch.models.phase import aov_scan, bls_scan
    from periodicity_tpu_torch.parallel import sharded_aov, sharded_bls, sharded_gls

    rng = np.random.default_rng(34)
    t = np.sort(rng.uniform(0, 100, 2000)).astype(np.float32)
    y = (np.sin(2 * np.pi * t / 7.7) + 0.3 * rng.standard_normal(2000)).astype(np.float32)
    tc, yc = torch.from_numpy(t).to(cuda), torch.from_numpy(y).to(cuda)
    ec = torch.full_like(tc, 0.3)
    before = extirpolate_grid_factored.launches
    got = sharded_gls(tc, yc, ec, 0.002, 0.001, 4000, nccl_mesh, gridder="kernel")
    assert extirpolate_grid_factored.launches == before + 3
    assert torch.equal(got.full_tensor(), gls_power(tc, yc, ec, 0.002, 0.001, 4000,
                                                    gridder="kernel"))
    periods = torch.linspace(2.0, 20.0, 1024, dtype=torch.float64, device=cuda)
    w = torch.full_like(tc, 1.0 / 2000)
    before = fold_onehot.launches
    out = sharded_bls(tc, yc, w, periods, nccl_mesh, binner="kernel")
    assert fold_onehot.launches == before + 16
    want = bls_scan(tc, yc, w, periods, widths=(3, 13, 26), binner="kernel")
    for a, b in zip(out, want):
        assert torch.equal(a.full_tensor(), b)
    aov = sharded_aov(tc, yc, periods, nccl_mesh, binner="auto").full_tensor()
    assert torch.equal(aov, aov_scan(tc, yc, periods, binner="kernel"))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_distributed_fft_stages_on_card_match_cpu(cuda, nccl_mesh, dtype):
    """World size 1 against torch.fft, and D = 4 ranks' stages in turn on the
    card against the same stages on the CPU (1e-12 of max|X| in f64, 1e-5 in
    f32) and against the f64 FFT in natural order."""
    from chip_smoke import in_turn_fft, in_turn_ifft
    from periodicity_tpu_torch.parallel import default_mesh, distributed_acf, distributed_fft

    smesh = default_mesh(("seq",))
    rng = np.random.default_rng(35)
    n = 1 << 16
    x = torch.from_numpy(rng.standard_normal(n)).to(dtype)
    cd = torch.complex128 if dtype == torch.float64 else torch.complex64
    X1 = distributed_fft(x.to(cuda), smesh).full_tensor()
    assert torch.equal(X1, torch.fft.fft(x.to(cuda).to(cd)))
    Xc, Xh = in_turn_fft(x.to(cuda), 4).cpu(), in_turn_fft(x, 4)
    scale = float(Xh.abs().max())
    lim = 1e-12 if dtype == torch.float64 else 1e-5
    assert float((Xc - Xh).abs().max()) <= lim * scale
    nat = torch.empty(n, dtype=cd)
    for r in range(4):
        nat[r::4] = Xc.reshape(4, n // 4)[r]
    ref = torch.fft.fft(x.double())
    assert float((nat.to(torch.complex128) - ref).abs().max()) <= (
        1e-9 if dtype == torch.float64 else 1e-5) * scale
    back = in_turn_ifft(Xc.to(cuda), 4).real.cpu()
    assert float((back.double() - x.double()).abs().max()) <= (
        1e-10 if dtype == torch.float64 else 1e-4)
    if dtype == torch.float64:
        yv = torch.sin(2 * np.pi * torch.arange(n, dtype=dtype) / 64) + 0.2 * x
        acf = distributed_acf(yv.to(cuda), smesh, max_lag=n // 2).cpu()
        want = TSeries(torch.arange(float(n), dtype=dtype), yv, device="cpu").acf(
            max_lag=n // 2).values
        assert float((acf - want).abs().max()) <= 1e-10


def test_sharded_likelihood_on_card_matches_cpu(cuda, nccl_mesh):
    """World size 1 is one K1 call over the series (the card's against the
    CPU's within 1e-12, f64); D = 4 ranks' stages in turn, card against CPU
    within 1e-12 and against the one-rank value within 1e-10; the gradient,
    through K2, bit for bit the blocked one's at the same blocks, within
    JAX's 1e-6 of the scan's, and the D = 4 stages' gradient (autograd
    through the stacked summaries) card against CPU within 1e-10 and
    against the one-rank gradient within 1e-10."""
    from chip_smoke import in_turn_ll
    from periodicity_tpu_torch.gp import (BrownianTerm, log_likelihood, log_likelihood_blocked,
                                          log_likelihood_sharded)
    from periodicity_tpu_torch.models.gp.pscan import _shard_blocks
    from periodicity_tpu_torch.ops.kalman import kalman_blocked
    from periodicity_tpu_torch.parallel import default_mesh

    smesh = default_mesh(("seq",))
    rng = np.random.default_rng(36)
    n = 4000
    t = np.sort(rng.uniform(0, 400, n))
    y = np.sin(2 * np.pi * t / 20.0) + 0.1 * rng.standard_normal(n)
    data = [torch.from_numpy(a) for a in (t, np.full(n, 0.01), y - y.mean())]
    term = BrownianTerm(0.01, 20.0, 10.0, 0.3)
    before = kalman_blocked.launches
    card = float(log_likelihood_sharded(term, *(a.to(cuda) for a in data), smesh))
    assert kalman_blocked.launches == before + 1
    host = float(log_likelihood_blocked(term, *data, n_blocks=_shard_blocks(n)))
    assert card == pytest.approx(host, rel=1e-12)
    d4_card = float(in_turn_ll(term, *(a.to(cuda) for a in data), 4)[0])
    d4_host = float(in_turn_ll(term, *data, 4)[0])
    assert d4_card == pytest.approx(d4_host, rel=1e-12)
    assert d4_card == pytest.approx(card, rel=1e-10)
    grads = {}
    for name, fn, where in (
            ("scan", log_likelihood, cuda),
            ("sharded", lambda *a: log_likelihood_sharded(*a, smesh), cuda),
            ("blocked", lambda *a: log_likelihood_blocked(*a, n_blocks=_shard_blocks(n)), cuda),
            ("d4", lambda *a: in_turn_ll(*a, 4)[0], cuda),
            ("d4_cpu", lambda *a: in_turn_ll(*a, 4)[0], "cpu")):
        pg = torch.tensor([0.01, 20.0, 10.0, 0.3], dtype=torch.float64, device=where,
                          requires_grad=True)
        ll = fn(BrownianTerm(pg[0], pg[1], pg[2], pg[3]), *(a.to(where) for a in data))
        (grads[name],) = torch.autograd.grad(ll, pg)
    grads = {k: v.cpu() for k, v in grads.items()}
    assert torch.equal(grads["sharded"], grads["blocked"])
    np.testing.assert_allclose(grads["sharded"].numpy(), grads["scan"].numpy(), rtol=1e-6)
    np.testing.assert_allclose(grads["d4"].numpy(), grads["d4_cpu"].numpy(), rtol=1e-10)
    np.testing.assert_allclose(grads["d4"].numpy(), grads["sharded"].numpy(), rtol=1e-10)


def test_sharded_sampler_and_modeler_on_card(cuda, nccl_mesh):
    """The sampler's half-updates on injected draws, card against CPU (f64,
    1e-12), and BrownianGP(solver="sharded") on the card against its scan
    (nll and gradient within 1e-10)."""
    from periodicity_tpu_torch.gp import BrownianGP
    from periodicity_tpu_torch.models.gp.mcmc import _sharded_chain
    from periodicity_tpu_torch.parallel import default_mesh

    rng = np.random.default_rng(37)
    mu, sd = np.array([1.0, -2.0]), np.array([0.5, 2.0])
    x0 = rng.standard_normal((16, 2))
    draws = [[(rng.random(16), rng.integers(0, 8, 16), rng.random(16)) for _ in range(2)]
             for _ in range(6)]
    chains = {}
    for dev in (torch.device("cpu"), cuda):
        m, s = (torch.from_numpy(a).to(dev) for a in (mu, sd))
        dd = [[tuple(torch.from_numpy(np.asarray(a)).to(dev) for a in h) for h in st]
              for st in draws]
        chain, _, acc = _sharded_chain(lambda x: -0.5 * torch.sum(((x - m) / s) ** 2, dim=-1),
                                       torch.from_numpy(x0).to(dev), 0, 8, 6,
                                       lambda step, k: dd[step][k], lambda x: x, 2.0)
        chains[dev.type] = (chain.cpu(), acc.cpu())
    assert torch.equal(chains["cuda"][1], chains["cpu"][1])
    np.testing.assert_allclose(chains["cuda"][0].numpy(), chains["cpu"][0].numpy(), rtol=0,
                               atol=1e-12)
    t, y, dy = SpottedStar()
    sig = TSeries(torch.from_numpy(t).to(cuda), torch.from_numpy(y).to(cuda))
    err = torch.from_numpy(dy).to(cuda)
    shard = BrownianGP(sig, err=err, solver="sharded", mesh=default_mesh(("seq",)))
    scan = BrownianGP(sig, err=err)
    vals = []
    for mm in (shard, scan):
        u = torch.full((6,), 40.0, dtype=torch.float64, device=cuda, requires_grad=True)
        f = mm._nll_u(u)
        vals.append((float(f.detach()), torch.autograd.grad(f, u)[0]))
    assert vals[0][0] == pytest.approx(vals[1][0], rel=1e-10)
    assert float((vals[0][1] - vals[1][1]).abs().max()) <= 1e-10 * float(vals[1][1].abs().max())


def test_trace_names_the_spreading_kernel(cuda, tmp_path):
    import json
    import os

    from periodicity_tpu_torch.utils import timer, trace

    t = torch.sort(torch.rand(2000, device=cuda) * 100)[0]
    y = torch.sin(2 * np.pi * t / 7.7)
    with trace(tmp_path):
        gls_power(t, y, torch.ones_like(t), 0.002, 0.001, 4000, pair_q=1, gridder="kernel")
        torch.cuda.synchronize()
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert any("spread_walk" in n for n in names)
    with timer() as tm:
        gls_power(t, y, torch.ones_like(t), 0.002, 0.001, 4000, pair_q=1, gridder="kernel")
    assert tm["seconds"] > 0
