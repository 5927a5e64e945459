"""GLS main-path parity: periodicity_tpu_torch vs the JAX package.

The same numpy draws go to both packages. Powers agree to 1e-9 of the
peak in float64 and 5e-5 of the peak in float32 (the JAX float32 fast
path alone sits ~1.4e-5 of peak from its float64 path). The whole slice,
``GLS()(TSeries(t, y))``, must give the same grid and the same best
period, for an even and an odd number of sampling intervals (the median
that sets fmax averages the two middle intervals when their count is
even).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import periodicity_tpu_torch
from periodicity_tpu import TSeries as JTSeries
from periodicity_tpu.models import spectral as jspec
from periodicity_tpu.ops import peaks as jpeaks
from periodicity_tpu.spectral import GLS as JGLS
from periodicity_tpu_torch import FSeries, TSeries
from periodicity_tpu_torch.core import from_jax
from periodicity_tpu_torch.models import spectral as pspec
from periodicity_tpu_torch.ops import peaks as ppeaks
from periodicity_tpu_torch.spectral import GLS

TOL = {np.float64: 1e-9, np.float32: 5e-5}


def _curve(n=2000, baseline=100.0, seed=0, dtype=np.float64, noise=0.3):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, baseline, n))
    y = np.sin(2 * np.pi * t / 7.7) + noise * rng.standard_normal(n)
    err = rng.uniform(0.2, 0.4, n)
    return t.astype(dtype), y.astype(dtype), err.astype(dtype)


def _assert_power_close(got, ref, dtype):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL[dtype] * ref.max())


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("method,pair_q", [("fast", 1), ("fast", None), ("direct", None)])
def test_gls_power_matches_jax(dtype, method, pair_q):
    t, y, err = _curve(n=800, dtype=dtype)
    df = 1.0 / (5 * 100.0)
    fmin = 0.5 * df
    nf = 1500
    ref = jspec.gls_power(t, y, err, df, fmin, nf, method=method, pair_q=pair_q)
    got = pspec.gls_power(torch.from_numpy(t), torch.from_numpy(y), torch.from_numpy(err),
                          df, fmin, nf, method=method, pair_q=pair_q)
    _assert_power_close(got, ref, dtype)


@pytest.mark.parametrize("fit_mean,psd", [(False, False), (True, True)])
def test_gls_power_options_match_jax(fit_mean, psd):
    t, y, err = _curve(n=500, seed=3)
    df, nf = 1.0 / 500.0, 1200
    ref = jspec.gls_power(t, y, err, df, df / 2, nf, fit_mean=fit_mean, psd=psd)
    got = pspec.gls_power(torch.from_numpy(t), torch.from_numpy(y), torch.from_numpy(err),
                          df, df / 2, nf, fit_mean=fit_mean, psd=psd)
    _assert_power_close(got, ref, np.float64)


@pytest.mark.parametrize("taps,nfft", [(8, None), (4, 1 << 13), (12, 1 << 14)])
def test_gls_power_taps_and_grid_match_jax(taps, nfft):
    """The extirpolation order and grid-size overrides (the 12-tap
    doubled grid is the accuracy oracle the card's check uses)."""
    t, y, err = _curve(n=400, seed=4)
    df, nf = 1.0 / 500.0, 1000
    ref = jspec.gls_power(t, y, err, df, df / 2, nf, pair_q=1, taps=taps, nfft=nfft)
    got = pspec.gls_power(torch.from_numpy(t), torch.from_numpy(y), torch.from_numpy(err),
                          df, df / 2, nf, pair_q=1, taps=taps, nfft=nfft)
    _assert_power_close(got, ref, np.float64)
    if taps == 12:
        exact = pspec.gls_power(torch.from_numpy(t), torch.from_numpy(y),
                                torch.from_numpy(err), df, df / 2, nf, method="direct")
        assert float((got - exact).abs().max()) <= 1e-8 * float(exact.max())


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n", [2000, 2001])
def test_gls_slice_matches_jax(dtype, n):
    t, y, _ = _curve(n=n, seed=n, dtype=dtype)
    jg = JGLS()
    ref = jg(JTSeries(t, y))
    g = GLS()
    got = g(TSeries(t, y))
    assert g._gridder_resolved == "scatter"
    assert got.values.shape[0] == ref.values.shape[0]
    np.testing.assert_array_equal(got.frequency.numpy(), np.asarray(ref.frequency))
    assert float(TSeries(t, y).median_dt) == float(JTSeries(t, y).median_dt)
    _assert_power_close(got.values, ref.values, dtype)
    p_ref = float(ref.period_at_highest_peak)
    p_got = float(got.period_at_highest_peak)
    assert p_got == p_ref
    assert abs(p_got - 7.7) < 0.05 * 7.7


def test_median_dt_averages_middle_intervals():
    t = np.array([0.0, 1.0, 3.0, 6.0, 10.0])  # intervals 1, 2, 3, 4
    assert float(TSeries(t, np.ones(5)).median_dt) == 2.5
    assert float(TSeries(t[:4], np.ones(4)).median_dt) == 2.0


def test_tseries_sorts_and_gls_defaults():
    rng = np.random.default_rng(11)
    t = rng.uniform(0, 10, 50)
    y = rng.standard_normal(50)
    ts = TSeries(t, y)
    order = np.argsort(t, kind="stable")
    np.testing.assert_array_equal(ts.time.numpy(), t[order])
    np.testing.assert_array_equal(ts.values.numpy(), y[order])
    assert len(ts) == 50 and ts.size == 50 and ts.shape == (50,)
    assert float(ts.baseline) == t.max() - t.min()
    sub = ts[5:10]
    assert isinstance(sub, TSeries) and len(sub) == 5
    assert float(ts[3]) == y[order][3]
    g = GLS(fmax=2.0)
    p = g(ts)
    assert isinstance(p, FSeries) and p.values.dtype == torch.float64
    assert g.copy().fmax == 2.0
    with pytest.raises(NotImplementedError):
        GLS(nterms=2)


def test_from_jax_round_trip():
    t, y, _ = _curve(n=300, dtype=np.float32)
    jts = JTSeries(t, y)
    ts = from_jax(jts)
    assert isinstance(ts, TSeries)
    assert ts.values.dtype == torch.float32 and ts.time.dtype == torch.float32
    np.testing.assert_array_equal(ts.time.numpy(), np.asarray(jts.time))
    np.testing.assert_array_equal(ts.values.numpy(), np.asarray(jts.values))

    jp = JGLS()(JTSeries(t.astype(np.float64), y.astype(np.float64)))
    jp.attrs["note"] = np.arange(3)
    fs = from_jax(jp)
    assert isinstance(fs, FSeries) and fs.values.dtype == torch.float64
    np.testing.assert_array_equal(fs.frequency.numpy(), np.asarray(jp.frequency))
    np.testing.assert_array_equal(fs.values.numpy(), np.asarray(jp.values))
    np.testing.assert_array_equal(fs.attrs["note"], np.arange(3))
    assert float(fs.period_at_highest_peak) == float(jp.period_at_highest_peak)

    a, b = from_jax((np.arange(4, dtype=np.float32), jp.values))
    assert a.dtype == torch.float32 and b.dtype == torch.float64


def test_find_peaks_matches_jax_on_periodogram():
    t, y, _ = _curve(n=1500, seed=5)
    jp = JGLS()(JTSeries(t, y))
    fs = from_jax(jp)
    ref = jp.find_peaks()
    got = fs.find_peaks()
    np.testing.assert_array_equal(got.attrs["indices"].numpy(), ref.attrs["indices"])
    for key in ("left_bases", "right_bases"):
        np.testing.assert_array_equal(got.attrs[key].numpy(), ref.attrs[key])
    np.testing.assert_allclose(got.attrs["prominences"].numpy(), ref.attrs["prominences"],
                               rtol=0, atol=1e-15)
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(ref.values))
    edged = fs.find_peaks(include_edges=True)
    ref_edged = jp.find_peaks(include_edges=True)
    np.testing.assert_array_equal(edged.attrs["indices"].numpy(), ref_edged.attrs["indices"])
    with pytest.raises(NotImplementedError, match="A4"):
        fs.find_peaks(height=0.1)


@pytest.mark.parametrize("wlen", [None, 7])
def test_peaks_plateaus_and_prominences_match_jax(wlen):
    rng = np.random.default_rng(9)
    x = np.round(rng.standard_normal(400), 1)  # rounding makes plateaus
    x[50:55] = 3.0
    x[:3] = 5.0
    idx, cnt, _ = jpeaks.find_peaks_full(x)
    pidx, pcnt, _ = ppeaks.find_peaks_full(torch.from_numpy(x))
    assert pcnt == int(cnt)
    np.testing.assert_array_equal(pidx.numpy(), np.asarray(idx))
    mask, left, right = jpeaks.local_maxima_info(x)
    pmask, pleft, pright = ppeaks.local_maxima_info(torch.from_numpy(x))
    np.testing.assert_array_equal(pmask.numpy(), np.asarray(mask))
    np.testing.assert_array_equal(pleft.numpy(), np.asarray(left))
    np.testing.assert_array_equal(pright.numpy(), np.asarray(right))
    ref = jpeaks.peak_prominences(x, idx, wlen=wlen)
    got = ppeaks.peak_prominences(torch.from_numpy(x), pidx, wlen=wlen)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_port_imports_no_jax():
    pkg = Path(periodicity_tpu_torch.__file__).parent
    chip_smoke = pkg.parent / "chip_smoke.py"
    pattern = re.compile(r"^\s*(import|from)\s+(jax|periodicity_tpu)\b", re.M)
    files = sorted(pkg.rglob("*.py")) + [chip_smoke]
    assert len(files) > 10
    for path in files:
        assert not pattern.search(path.read_text()), path
