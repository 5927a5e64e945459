"""Time-frequency estimators: periodicity_tpu_torch.timefrequency vs the JAX
package, and the JAX package's own behavioural checks on the port.

The same numpy draws go to both packages, the JAX side on the CPU in x64,
the port's on CPU tensors (plain versions). Float64 is the parity dtype.

Tolerances, with their reasons:
- WPS, its band averages, CompositeSpectrum, denoising, reconstruct and
  wps_batch: FFTs, short dot products and means whose summation order
  differs between XLA and PyTorch: within 1e-12 of the output's largest
  value (NaN where JAX has NaN);
- HHT and hht_batch: modes and residues within 1e-9 of max |y| (EMD, as in
  tests/test_torch_emd.py), mode counts equal, amplitudes within 1e-9;
  frequencies and power sample by sample, except where a sample hangs on
  a discrete decision within 1e-12 of its threshold in both packages (the
  rule of tests/test_torch_hht.py);
- integer input is float32 in both packages: within float32 rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_hht import _dq_near, held_sample_by_sample

import periodicity_tpu.timefrequency as J
import periodicity_tpu_torch
import periodicity_tpu_torch.timefrequency as P
from periodicity_tpu.core import TSeries as JTS
from periodicity_tpu.ops import hht as JH
from periodicity_tpu_torch import TSeries
from periodicity_tpu_torch.core.containers import _nanmedian
from periodicity_tpu_torch.ops import hht as PH
from periodicity_tpu_torch.ops import wavelet as PW


@pytest.fixture(autouse=True, scope="module")
def _release_jax_executables():
    """Free this module's compiled JAX executables when it ends: an xdist
    worker runs many modules in one process, and one that accumulates too
    many XLA executables can crash (pyproject.toml)."""
    yield
    jax.clear_caches()


def _T(a):
    return torch.from_numpy(np.array(a))


def _close(jax_out, port_out, tol=1e-12, scale=None):
    want = np.asarray(jax_out)
    got = port_out.numpy() if isinstance(port_out, torch.Tensor) else np.asarray(port_out)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    if scale is None:
        scale = max(float(np.nanmax(np.abs(want))), 1e-300)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


@pytest.fixture(scope="module")
def tone_series():
    rng = np.random.default_rng(0)
    t = np.arange(512) * 0.5
    y = (np.sin(2 * np.pi * t / 7.0) + 0.3 * np.sin(2 * np.pi * t / 23.0)
         + 0.05 * rng.standard_normal(512))
    return t, y


def test_exports_match_jax():
    assert P.__all__ == J.__all__
    assert len(P.__all__) == 8
    assert "timefrequency" in periodicity_tpu_torch.__all__
    assert periodicity_tpu_torch.timefrequency is P


def test_wps_matches_jax(tone_series):
    t, y = tone_series
    periods = np.geomspace(2, 40, 24)
    wj, wp = J.WPS(periods), P.WPS(periods)
    sj, sp = wj(JTS(t, y)), wp(TSeries(t, y, device="cpu"))
    _close(sj.values, sp.values)
    _close(wj.power.values, wp.power.values)
    _close(wj.masked_spectrum.values, wp.masked_spectrum.values)
    _close(wj.coefs, wp.coefs)
    np.testing.assert_array_equal(wj.mask_coi, wp.mask_coi)
    np.testing.assert_array_equal(np.asarray(wj.coi().values), wp.coi().values.numpy())
    np.testing.assert_array_equal(np.asarray(wj.coi().time), wp.coi().time.numpy())
    _close(wj.spectrum.frequency, wp.spectrum.frequency)
    for args in ((), (3.0, 12.0)):
        _close(wj.sav(*args).values, wp.sav(*args).values)
        _close(wj.masked_sav(*args).values, wp.masked_sav(*args).values)
    for args in ((), (20.0, 200.0)):
        _close(wj.gwps(*args).values, wp.gwps(*args).values)
        _close(wj.masked_gwps(*args).values, wp.masked_gwps(*args).values)
        _close(wj.gwps(*args).frequency, wp.gwps(*args).frequency)


def test_composite_spectrum_matches_jax_on_a_gappy_series():
    rng = np.random.default_rng(1)
    t = np.delete(np.arange(400.0), np.arange(150, 170))
    y = np.sin(2 * np.pi * t / 25.0) + 0.1 * rng.standard_normal(t.size)
    periods = np.geomspace(5, 100, 60)
    _close(J.CompositeSpectrum(periods)(JTS(t, y)).values,
           P.CompositeSpectrum(periods)(TSeries(t, y, device="cpu")).values)


def test_denoise_matches_jax():
    rng = np.random.default_rng(2)
    x = np.sin(2 * np.pi * np.arange(512.0) / 100) + 0.3 * rng.standard_normal(512)
    for kw in ({"sigma": 0.3}, {"family": "sym5"}, {"family": "bior2.4", "detrend": True}):
        _close(J.denoise(x, **kw), P.denoise(_T(x), **kw))


def test_mad_sigma_averages_the_two_middle_values():
    """The finest detail band of N = 512 holds 256 values: jnp.median
    averages the middle two, torch.median would return the lower one. The
    draw is one where the two differ, and the port matches JAX."""
    rng = np.random.default_rng(3)
    x = np.cumsum(rng.standard_normal(512))
    band = torch.abs(PW.wavedec(_T(x), "db4")[-1])
    assert band.shape[-1] % 2 == 0
    assert float(_nanmedian(band, dim=-1)) != float(torch.median(band))
    _close(J.denoise(x), P.denoise(_T(x)))
    X = np.stack([x, -x[::-1].copy(), 0.5 * x])
    many = P.denoise_batch(_T(X))
    for r in range(3):
        _close(J.denoise(X[r]), many[r])


def test_denoise_batch_matches_jax():
    rng = np.random.default_rng(5)
    t = np.arange(512.0)
    clean = np.stack([np.sin(2 * np.pi * t / p) for p in (100.0, 128.0, 160.0)])
    batch = clean + 0.25 * rng.standard_normal((3, 512))
    for sigma in (None, 0.25, np.array([0.2, 0.25, 0.3])):
        _close(J.denoise_batch(batch, sigma=sigma), P.denoise_batch(_T(batch), sigma=sigma))
    with pytest.raises(ValueError, match="batch"):
        P.denoise_batch(_T(batch[0]))


@pytest.mark.parametrize("dtype", [np.int32, np.float16, np.float64])
def test_denoise_promotes_like_jax(dtype):
    rng = np.random.default_rng(9)
    base = 100.0 * np.sin(2 * np.pi * np.arange(256.0) / 64.0)
    x = (base + 30.0 * rng.standard_normal(256)).astype(dtype)
    X = np.stack([x, x[::-1].copy()])
    for got, want in ((P.denoise(_T(x), sigma=0.9), J.denoise(x, sigma=0.9)),
                      (P.denoise(_T(x)), J.denoise(x)),
                      (P.denoise_batch(_T(X), sigma=0.9), J.denoise_batch(X, sigma=0.9))):
        want = np.asarray(want)
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        tol = 1e-12 if want.dtype == np.float64 else 2e-6
        _close(want, got, tol=tol)


def test_reconstruct_matches_jax(tone_series):
    t, y = tone_series
    periods = np.geomspace(2, 40, 24)
    wj, wp = J.WPS(periods), P.WPS(periods)
    wj(JTS(t, y))
    wp(TSeries(t, y, device="cpu"))
    _close(J.reconstruct(wj.coefs, periods, 0.5, "cmor2.0-1.0"),
           P.reconstruct(wp.coefs, periods, 0.5, "cmor2.0-1.0"))


def test_wps_batch_matches_jax_and_single():
    t = np.arange(512) * 0.5
    periods = np.geomspace(2, 64, 20)
    ys = np.stack([np.sin(2 * np.pi * t / 7.0),
                   np.sin(2 * np.pi * t / 21.0) + 0.1 * np.cos(2 * np.pi * t / 5.0)])
    sj, cj = J.wps_batch(t, ys, periods)
    sp, cp = P.wps_batch(_T(t), _T(ys), periods)
    assert sp.shape == (2, 20, 512) and cp.shape == (20, 512)
    _close(sj, sp)
    np.testing.assert_array_equal(np.asarray(cj), cp.numpy())
    for i in range(2):
        wps = P.WPS(periods)
        wps(TSeries(t, ys[i], device="cpu"))
        np.testing.assert_allclose(sp[i].numpy(), wps.spectrum.values.numpy(), rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_array_equal(cp.numpy(), wps.mask_coi)


def _power_held(power_p, power_j, freqs_p, freqs_j, F_p, F_j, grid, what):
    """Spectrogram columns sample by sample: a column may differ only where
    one of its modes' frequency hangs on a DQ decision or sits on a bin
    boundary, within 1e-12 in both packages. Returns how many did."""

    def near(freqs, Fs):
        m = np.zeros(power_p.shape[-1], bool)
        for f, F in zip(freqs, Fs):
            m |= (np.abs(f[:, None] - grid[None, :])
                  <= 1e-12 * np.maximum(np.abs(grid[None, :]), 1e-300)).any(1)
            if F is not None:
                m |= _dq_near(F)
        return m

    bad = np.abs(power_p - power_j).max(0) > 1e-9 * float(np.abs(power_j).max())
    decided = bad & near(freqs_p, F_p) & near(freqs_j, F_j)
    assert not (bad & ~decided).any(), (
        f"{what}: {int((bad & ~decided).sum())} columns differ away from any decision; "
        f"{int(decided.sum())} parted at a decision")
    return int(decided.sum())


def test_hht_matches_jax(record_property):
    t = np.linspace(0, 10, 256)
    y = np.sin(2 * np.pi * t * 3.0) + 0.5 * np.sin(2 * np.pi * t * 0.4)
    grid = np.linspace(0.1, 6.0, 40)
    decided = 0
    for method in ("DQ", "TEO"):
        hj, hp = J.HHT(grid, method=method), P.HHT(grid, method=method)
        tfj, tfp = hj(JTS(t, y)), hp(TSeries(t, y, device="cpu"))
        assert len(hj.modes) == len(hp.modes) >= 2
        for a, b in zip(hj.modes, hp.modes):
            _close(a.values, b.values, tol=1e-9, scale=float(np.abs(y).max()))
        for a, b in zip(hj.instant_as, hp.instant_as):
            _close(a.values, b.values, tol=1e-9, scale=float(np.abs(y).max()))
        fj = [np.asarray(f.values) for f in hj.instant_fs]
        fp = [f.values.numpy() for f in hp.instant_fs]
        if method == "DQ":
            Fj = [np.asarray(JH.am_fm_normalize(jnp.asarray(t), m.values)[1]) for m in hj.modes]
            Fp = [PH.am_fm_normalize(_T(t), m.values)[1].numpy() for m in hp.modes]
        else:
            Fj = Fp = [None] * len(fj)
        for k, (a, b) in enumerate(zip(fp, fj)):
            near_p = _dq_near(Fp[k]) if Fp[k] is not None else np.zeros(t.size, bool)
            near_j = _dq_near(Fj[k]) if Fj[k] is not None else np.zeros(t.size, bool)
            decided += held_sample_by_sample(a, b, near_p, near_j, f"HHT {method} mode {k}")
        decided += _power_held(tfp.values.numpy(), np.asarray(tfj.values), fp, fj, Fp, Fj,
                               grid, f"HHT {method} power")
        np.testing.assert_array_equal(tfp.frequency.numpy(), np.asarray(tfj.frequency))
    record_property("samples_parted_at_a_decision", decided)


def test_hht_batch_matches_jax(record_property):
    rng = np.random.default_rng(0)
    n = 256
    t = np.linspace(0, 10, n)
    ys = np.stack([np.sin(2 * np.pi * t * 3.0) + 0.5 * np.sin(2 * np.pi * t * 0.4),
                   np.sin(2 * np.pi * t * 5.0) + 0.3 * np.cos(2 * np.pi * t * 0.7)
                   + 0.05 * rng.standard_normal(n),
                   0.1 * t])
    grid = np.linspace(0.1, 8.0, 32)
    pj, mj, rj, nj = J.hht_batch(t, ys, grid, max_modes=3)
    pp, mp, rp, npp = P.hht_batch(_T(t), _T(ys), grid, max_modes=3)
    np.testing.assert_array_equal(np.asarray(nj), npp.numpy())
    scale = float(np.abs(ys).max())
    _close(mj, mp, tol=1e-9, scale=scale)
    _close(rj, rp, tol=1e-9, scale=scale)
    decided = 0
    for b in range(3):
        live = [k for k in range(3) if k < int(npp[b])]
        Fp = [PH.am_fm_normalize(_T(t), mp[b, k])[1].numpy() for k in live]
        Fj = [np.asarray(JH.am_fm_normalize(jnp.asarray(t), jnp.asarray(mj[b, k]))[1])
              for k in live]
        fp = [PH.dq_frequency(_T(t), _T(F)).numpy() for F in Fp]
        fj = [np.asarray(JH.dq_frequency(jnp.asarray(t), jnp.asarray(F))) for F in Fj]
        decided += _power_held(pp[b].numpy(), np.asarray(pj[b]), fp, fj, Fp, Fj, grid,
                               f"hht_batch member {b}")
    record_property("samples_parted_at_a_decision", decided)


# ---- the JAX package's behavioural checks, on the port ----------------------

def test_wps_finds_tone_period():
    t = np.arange(2000) * 0.5
    wps = P.WPS(np.linspace(2, 30, 80))
    spec = wps(TSeries(t, np.sin(2 * np.pi * t / 7.0), device="cpu"))
    assert spec.shape == (80, 2000)
    gwps = wps.gwps()
    best = float(gwps.period[torch.argmax(gwps.values)])
    assert best == pytest.approx(7.0, abs=0.4)
    assert torch.isnan(wps.masked_spectrum.values).any()
    assert torch.isfinite(wps.masked_gwps().values).any()
    assert wps.sav(pmin=5, pmax=10).size == 2000


def test_wps_unbiased_power_is_flat_across_frequencies():
    t = np.arange(4096) * 1.0
    y = np.sin(2 * np.pi * t / 8) + np.sin(2 * np.pi * t / 64)
    wps = P.WPS(np.geomspace(4, 128, 120))
    wps(TSeries(t, y, device="cpu"))
    g = wps.gwps().values.numpy()
    p = wps.gwps().period.numpy()
    assert g[np.argmin(np.abs(p - 8))] / g[np.argmin(np.abs(p - 64))] == pytest.approx(1.0, rel=0.3)


def test_hht_two_tones_instant_frequencies():
    from periodicity_tpu_torch.data import SustainedPlusGappedPureTones

    x = TSeries(values=torch.from_numpy(SustainedPlusGappedPureTones()))
    hht = P.HHT(np.linspace(0.0, 0.5, 101), method="DQ")
    tf = hht(x)
    assert tf.shape == (101, 1000)
    medians = [float(np.median(f.values.numpy()[100:900])) for f in hht.instant_fs]
    assert any(abs(m - 0.065) < 0.01 for m in medians), medians


def test_hht_methods_and_normalizations_run():
    t = np.arange(600.0)
    sig = TSeries(t, np.sin(2 * np.pi * 0.05 * t), device="cpu")
    freqs = np.linspace(0, 0.25, 64)
    for method, norm in [("NHT", "hilbert"), ("HT", "spline"), ("dq", "LMD")]:
        hht = P.HHT(freqs, method=method, norm_type=norm)
        assert hht(sig) is not None and len(hht.instant_fs) >= 1
    with pytest.raises(ValueError, match="unknown"):
        P.HHT(freqs, method="XX")
    with pytest.raises(ValueError, match="unknown"):
        P.HHT(freqs, norm_type="xx")


def test_composite_spectrum_peak():
    t = np.arange(2000) * 1.0
    cs = P.CompositeSpectrum(np.geomspace(5, 100, 100))(
        TSeries(t, np.sin(2 * np.pi * t / 25.0), device="cpu"))
    best = float(cs.period[np.nanargmax(cs.values.numpy())])
    assert best == pytest.approx(25.0, rel=0.1)


def test_denoise_reduces_noise():
    rng = np.random.default_rng(0)
    t = np.arange(1024.0)
    clean = np.sin(2 * np.pi * t / 100)
    noisy = clean + 0.3 * rng.standard_normal(1024)
    den = P.denoise(_T(noisy), sigma=0.3).numpy()
    assert den.shape == (1024,)
    assert np.std(den - clean) < 0.8 * np.std(noisy - clean)
    pure = 0.3 * rng.standard_normal(1024)
    assert np.std(P.denoise(_T(pure), sigma=0.3).numpy()) < 0.25 * np.std(pure)
    den_auto = P.denoise(_T(noisy)).numpy()
    assert np.std(den_auto - clean) < 0.8 * np.std(noisy - clean)
    assert np.std(den_auto - den) < 0.05
    assert np.std(P.denoise(_T(noisy), family="dmey").numpy() - clean) < 0.8 * np.std(noisy - clean)


def test_hht_batch_matches_single():
    rng = np.random.default_rng(0)
    n = 256
    t = np.linspace(0, 10, n)
    ys = np.stack([np.sin(2 * np.pi * t * 3.0) + 0.5 * np.sin(2 * np.pi * t * 0.4),
                   np.sin(2 * np.pi * t * 5.0) + 0.3 * np.cos(2 * np.pi * t * 0.7)
                   + 0.05 * rng.standard_normal(n)])
    grid = np.linspace(0.1, 8.0, 32)
    for method in ("DQ", "TEO"):
        power, modes, residue, n_modes = P.hht_batch(_T(t), _T(ys), grid, max_modes=6,
                                                     method=method)
        assert power.shape == (2, 32, n)
        for b in range(2):
            h = P.HHT(grid, method=method)
            tf = h(TSeries(t, ys[b], device="cpu"))
            assert int(n_modes[b]) == len(h.modes)
            np.testing.assert_allclose(power[b].numpy(), tf.values.numpy(), atol=1e-8)
            np.testing.assert_allclose(residue[b].numpy(), ys[b] - modes[b].sum(0).numpy(),
                                       atol=1e-8)


def test_hht_all_zero_signal_returns_empty():
    t = np.linspace(0, 10, 256)
    zero = TSeries(t, np.zeros_like(t), device="cpu")
    for method in ("DQ", "TEO", "HT"):
        h = P.HHT(np.linspace(0.1, 5, 16), method=method, smooth_width=5)
        assert h(zero) is None
        assert h.tfs == [] and h.instant_fs == []


def test_hht_batch_zero_mode_member_has_zero_power():
    t = np.linspace(0, 10, 256)
    ys = np.stack([np.sin(2 * np.pi * 2.0 * t), 0.1 * t])
    grid = np.linspace(0.05, 4.0, 32)
    for method in ("TEO", "DQ"):
        power, _, _, n_modes = P.hht_batch(_T(t), _T(ys), grid, max_modes=4, method=method)
        assert int(n_modes[1]) == 0
        assert float(power[1].abs().sum()) == 0.0
        assert float(power[0].abs().sum()) > 0.0


def test_denoise_batch_matches_single():
    rng = np.random.default_rng(5)
    t = np.arange(1024.0)
    clean = np.stack([np.sin(2 * np.pi * t / p) for p in (100.0, 128.0, 160.0)])
    batch = clean + 0.25 * rng.standard_normal((3, 1024))
    many = P.denoise_batch(_T(batch), sigma=0.25).numpy()
    for i in range(3):
        np.testing.assert_allclose(many[i], P.denoise(_T(batch[i]), sigma=0.25).numpy(),
                                   atol=1e-10)
    auto = P.denoise_batch(_T(batch)).numpy()
    assert (np.std(auto - clean, axis=1) < 0.8 * np.std(batch - clean, axis=1)).all()
    arr = P.denoise_batch(_T(batch), sigma=np.full(3, 0.25)).numpy()
    np.testing.assert_allclose(arr, many, atol=1e-10)


def test_hht_batch_sifter_equivalence():
    """JAX's lockstep and pool sifters give the same members; in the port
    both are one launch of the same state machine, so the results are the
    same bits, and a bad name or unroll is rejected."""
    t = np.linspace(0.0, 20.0, 512)
    rng = np.random.default_rng(0)
    ys = np.stack([np.sin(2 * np.pi * t * f) + 0.4 * np.sin(2 * np.pi * t * f / 6.0)
                   + 0.05 * rng.standard_normal(512) for f in np.linspace(2.0, 4.0, 6)])
    grid = np.linspace(0.1, 8.0, 32)
    out = {s: P.hht_batch(_T(t), _T(ys), grid, max_modes=3, sifter=s)
           for s in ("lockstep", "pool", "auto")}
    for s in ("pool", "auto"):
        for a, b in zip(out["lockstep"], out[s]):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="Sifter"):
        P.hht_batch(_T(t), _T(ys), grid, sifter="bogus")
    with pytest.raises(ValueError, match="unroll"):
        P.hht_batch(_T(t), _T(ys), grid, unroll=1.5)
    with pytest.raises(ValueError, match="unknown"):
        P.hht_batch(_T(t), _T(ys), grid, method="XX")


def test_numpy_input_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: numpy input lands on it")
    t = np.arange(64.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.hht_batch(t, np.sin(t)[None], [0.1, 0.2])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.denoise(np.sin(t))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.wps_batch(t, np.sin(t)[None], [4.0, 8.0])
