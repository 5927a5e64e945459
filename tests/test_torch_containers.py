"""Container parity, core surface: periodicity_tpu_torch.core vs the JAX
package's core, mirroring ``tests/test_core.py``.

The same numpy draws go to both packages, the JAX side on the CPU in x64,
at small sizes: construction and grids, envelopes, calculus, spectra and
the ACF, the Butterworth filter, smoothing, interpolation, and
``acf_period_quality`` on SpottedStar.

Tolerances, with their reasons:
- float64 values from the same arithmetic (calculus, filters, splines,
  spectra): rtol 1e-10, atol 1e-10 of O(1) data, inside the 1e-8 to 1e-10
  of the JAX package's own tests (sums, FFTs and scans round in another
  order);
- the float32 Butterworth (both packages filter in float64 by the same
  arithmetic): equal; against scipy's float64 oracle, the JAX
  test's own bound, 5e-4 of max;
- ``acf_period_quality``: the best period equal, height and quality within
  1e-6 relative (a Nelder-Mead fit on data that differs in the last bits).
"""

import numpy as np
import pytest
import torch

import periodicity_tpu.core as JC
from periodicity_tpu.data import SpottedStar
from periodicity_tpu_torch.core import TFSeries, TSeries

CPU = "cpu"


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rtol=1e-10, atol=1e-10):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


def _pair(t, y):
    return TSeries(t, y, device=CPU), JC.TSeries(t, y)


def test_time_array_is_always_sorted_and_sizes_checked():
    sig = TSeries([3, 2, 1], [3, 5, 7], device=CPU)
    assert _np(sig.time).tolist() == [1, 2, 3] and _np(sig.values).tolist() == [7, 5, 3]
    with pytest.raises(ValueError):
        TSeries([1, 2], [1, 2, 3], device=CPU)


def test_grid_properties():
    sig = TSeries([1, 3, 4], [1, 1, 1], device=CPU)
    assert float(sig.median_dt) == 1.5
    with pytest.raises(AttributeError):
        sig.dt
    assert float(TSeries(np.arange(10), device=CPU).baseline) == 9
    uni = TSeries(np.arange(10), device=CPU)
    assert float(uni.dt) == 1.0
    with pytest.raises(AttributeError):
        uni[[2, 5, 6]].dt


def test_get_constant_envelope_matches_jax():
    t = np.linspace(0, 40, 401)
    sig, jsig = _pair(t, np.sin(t))
    (up, lo), (jup, jlo) = sig.get_envelope(pad_width=2), jsig.get_envelope(pad_width=2)
    _close(up.values, jup.values)
    _close(lo.values, jlo.values)
    assert float(np.abs(up - 1).amax()) < 2e-3 and float(np.abs(lo + 1).amax()) < 2e-3
    up0, lo0 = sig.get_envelope()
    assert float(np.abs(up0 - 1).amax()) < 2e-3 and float(np.abs(lo0 + 1).amax()) < 2e-3


def test_teo_derivative_and_fold_match_jax():
    rng = np.random.default_rng(1)
    t = np.sort(rng.uniform(0, 10, 100))
    sig, jsig = _pair(t, np.sin(t))
    _close(sig.derivative.values, np.gradient(np.sin(t), t))
    _close(sig.TEO.values, jsig.TEO.values)
    f, jf = sig.fold(1.7, t0=0.3), jsig.fold(1.7, t0=0.3)
    _close(f.time, jf.time)
    _close(f.values, jf.values)
    _close(sig.timeshift(2.5).time, jsig.timeshift(2.5).time)
    _close(sig.timescale(-2.0).values, jsig.timescale(-2.0).values)
    assert float(sig.tmax()) == float(jsig.tmax())


@pytest.mark.parametrize("kw", [{}, {"max_lag": 50}, {"max_lag": 20.0},
                                {"max_lag": 50, "unbias": True}])
def test_acf_fft_psd_match_jax(kw):
    t = np.arange(256.0) * 0.5
    y = 2.0 + np.sin(2 * np.pi * t / 8.0) + 0.1 * np.random.default_rng(2).standard_normal(256)
    sig, jsig = _pair(t, y)
    r, jr = sig.acf(**kw), jsig.acf(**kw)
    assert r.size == jr.size and float(r.values[0]) == pytest.approx(1.0)
    _close(r.time, jr.time)
    _close(r.values, jr.values)
    p, jp = sig.psd(oversample=2.0), jsig.psd(oversample=2.0)
    _close(p.frequency, jp.frequency)
    _close(p.values, jp.values, atol=1e-10 * float(jp.values.max()))
    back = sig.fft().ifft()
    _close(back.values, y)
    _close(back.time, jsig.fft().ifft().time)


def test_acf_of_sine_peaks_at_period():
    t = np.arange(512) * 0.1
    r = TSeries(t, np.sin(2 * np.pi * t / 3.0), device=CPU).acf()
    assert float(r.values[0]) == pytest.approx(1.0)
    assert float(r.find_peaks().time[0]) == pytest.approx(3.0, abs=0.2)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_butterworth_matches_jax_and_scipy(dtype):
    from scipy import signal as ssig

    x = np.random.default_rng(0).standard_normal(400)
    t = np.arange(400) * 0.5
    sig, jsig = _pair(t.astype(dtype), x.astype(dtype))
    got = sig.butterworth(fmin=0.05, fmax=0.3).values
    ref = jsig.butterworth(fmin=0.05, fmax=0.3).values
    assert got.dtype == torch.from_numpy(x.astype(dtype)).dtype
    if dtype == np.float32:
        np.testing.assert_array_equal(_np(got), _np(ref))
    else:
        _close(got, ref, rtol=1e-10, atol=1e-12)
        sos = ssig.butter(5, [0.05, 0.3], btype="bandpass", output="sos")
        _close(got, ssig.sosfiltfilt(sos, x), rtol=1e-8, atol=1e-10)
    # high- and low-pass against scipy (JAX compiles its eager scans anew
    # for each filter, ~2 s each)
    for kw, wn, btype in (({"fmin": 0.1}, 0.1, "highpass"), ({"fmax": 0.2}, 0.2, "lowpass")):
        ref = ssig.sosfiltfilt(ssig.butter(5, wn, btype=btype, output="sos"), x)
        _close(sig.butterworth(**kw).values, ref, rtol=1e-8, atol=1e-6 if dtype == np.float32
               else 1e-10)


def test_butterworth_float32_narrow_band_stable():
    """A float32 series is filtered in float64: even at the
    ACF-quality band edges it matches the float64 oracle to float32
    resolution (JAX's test bound, 5e-4 of max)."""
    from scipy import signal as ssig

    n = 500
    t = np.arange(n) * 0.02
    x = np.random.default_rng(3).standard_normal(n)
    got = _np(TSeries(t.astype(np.float32), x.astype(np.float32), device=CPU)
              .butterworth(fmin=1 / 8, fmax=1 / 0.06).values)
    sos = ssig.butter(5, [(1 / 8) / 25, (1 / 0.06) / 25], btype="bandpass", output="sos")
    ref = ssig.sosfiltfilt(sos, x)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=5e-4 * np.abs(ref).max())


@pytest.mark.parametrize("kernel,width", [("gaussian", 3.0), ("boxcar", 4), ("boxcar", 5),
                                          ("triangle", 5)])
def test_smooth_matches_jax_1d_and_2d(kernel, width):
    rng = np.random.default_rng(4)
    x = rng.standard_normal(300)
    sig, jsig = _pair(np.arange(300.0), x)
    _close(sig.smooth(width, kernel=kernel).values, jsig.smooth(width, kernel=kernel).values)
    img = rng.standard_normal((12, 20))
    tf = TFSeries(np.arange(20.0), np.arange(12.0) + 1, img, device=CPU)
    jtf = JC.TFSeries(np.arange(20.0), np.arange(12.0) + 1, img)
    _close(tf.smooth(width, kernel=kernel).values, jtf.smooth(width, kernel=kernel).values)
    k = rng.uniform(0, 1, 5)
    _close(sig.convolve(k).values, jsig.convolve(k).values)
    assert sig.estimate_noise() == pytest.approx(jsig.estimate_noise(), rel=1e-12)
    assert tf.estimate_noise() == pytest.approx(jtf.estimate_noise(), rel=1e-12)


@pytest.mark.parametrize("method", ["linear", "slinear", "nearest", "zero", "quadratic",
                                    "cubic", "spline"])
def test_interp_matches_jax_with_ends(method):
    """Every method on a grid that runs past both ends: NaN outside for the
    xarray methods, splev's extrapolation for 'spline'; linear clamps like
    ``jnp.interp`` before the masking."""
    rng = np.random.default_rng(9)
    x = np.sort(rng.uniform(0, 10, 60))
    y = np.sin(x) + 0.1 * rng.standard_normal(60)
    xe = np.linspace(-0.5, 10.5, 101)
    got = TSeries(x, y, device=CPU).interp(xe, method=method)
    ref = JC.TSeries(x, y).interp(xe, method=method)
    np.testing.assert_allclose(_np(got.values), _np(ref.values), rtol=1e-10, atol=1e-10)
    _close(got.time, ref.time)
    ts2 = TSeries(np.array([1.0, 2.0, 3.0]), np.array([1.0, 2.0, 3.0]), device=CPU)
    out = _np(ts2.interp(np.array([0.0, 2.5, 4.0]), method="linear").values)
    assert np.isnan(out[[0, 2]]).all() and out[1] == 2.5


def test_smoothing_interp_on_the_container():
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(0, 10, 120))
    y = np.sin(x) + 0.2 * rng.standard_normal(120)
    xe = np.linspace(0.5, 9.5, 77)
    sm = TSeries(x, y, device=CPU).interp(xe, method="spline", s=1.6)
    exact = TSeries(x, y, device=CPU).interp(xe, method="spline")
    assert np.isfinite(_np(sm.values)).all()
    assert (np.sum(np.diff(_np(sm.values), 2) ** 2)
            < np.sum(np.diff(_np(exact.values), 2) ** 2))


@pytest.mark.parametrize("dtype,p_max", [(np.float64, 16.0), (np.float32, 32.0)])
def test_acf_period_quality_on_spotted_star_matches_jax(dtype, p_max):
    t, y, _ = SpottedStar()
    sig, jsig = _pair(t.astype(dtype), y.astype(dtype))
    p_min = max(0.1, 3 * float(np.median(np.diff(t))))
    got = sig.acf_period_quality(p_min, p_max)
    ref = jsig.acf_period_quality(p_min, p_max)
    assert got[0] == ref[0]
    assert got[1] == pytest.approx(ref[1], rel=1e-6)
    assert got[2] == pytest.approx(ref[2], rel=1e-6)


def test_linear_interp_clamps_like_jnp_interp():
    """torch has no interp: the port's is searchsorted and clamps to the end
    values outside the data, as ``jnp.interp`` does (TSeries.interp then
    masks those points with NaN)."""
    import jax.numpy as jnp

    from periodicity_tpu_torch.core.containers import _interp

    xp = np.array([1.0, 2.0, 2.0, 4.0, 7.0])
    fp = np.array([3.0, -1.0, 5.0, 0.5, 2.0])
    x = np.array([-3.0, 1.0, 1.5, 2.0, 3.0, 6.9, 7.0, 9.0])
    _close(_interp(torch.from_numpy(x), torch.from_numpy(xp), torch.from_numpy(fp)),
           jnp.interp(x, xp, fp), rtol=0, atol=1e-15)
