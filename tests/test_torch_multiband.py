"""Multiband GLS: periodicity_tpu_torch vs the JAX package.

The same numpy draws go to both packages (JAX on the CPU with x64).
float64 results agree to 1e-9 of the largest value, the lowest bins
included. Bootstrap replicates are compared on the within-band indices
the test makes with ``jax.random`` as ``MultibandGLS.bootstrap`` makes
them; the port's estimator draws its own, so there only shapes and
statistics are checked. The behavioural checks of
``tests/test_multiband.py`` run on the port too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from periodicity_tpu import TSeries as JTSeries
from periodicity_tpu.models import spectral as J
from periodicity_tpu_torch import TSeries
from periodicity_tpu_torch.models import spectral as P

T = torch.from_numpy
PERIOD = 2.3
AMPS = (1.0, 0.7, 1.3)
OFFSETS = (0.0, 5.0, -4.0)


@pytest.fixture(scope="module")
def multiband_signal():
    """Three bands sharing one period, phases 120 degrees apart (the
    concatenated signal cancels at the true frequency), different
    amplitudes and large per-band offsets; errors vary per sample."""
    rng = np.random.default_rng(7)
    ts, ys, es, bs = [], [], [], []
    for s in range(3):
        n = 180
        t = np.sort(rng.uniform(0, 40, n))
        y = (OFFSETS[s] + AMPS[s] * np.sin(2 * np.pi * t / PERIOD + 2 * np.pi * s / 3)
             + 0.05 * rng.standard_normal(n))
        ts.append(t)
        ys.append(y)
        es.append(rng.uniform(0.04, 0.06, n))
        bs.append(np.full(n, s, dtype=np.int32))
    t = np.concatenate(ts)
    order = np.argsort(t, kind="stable")
    return (t[order], np.concatenate(ys)[order], np.concatenate(es)[order],
            np.concatenate(bs)[order])


def _close(got, ref, atol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)


@pytest.mark.parametrize("method", ["fast", "direct"])
@pytest.mark.parametrize("kb,ks", [(1, 0), (1, 1), (0, 1), (2, 1)])
def test_gls_power_multiband_matches_jax(multiband_signal, kb, ks, method):
    """float64, 1e-9 of the peak; fast and direct also agree to JAX's own
    bound (``assert_allclose(atol=5e-6)``)."""
    t, y, err, bands = multiband_signal
    df, fmin, nf = 1 / 200.0, 1 / 400.0, 700
    kw = dict(nterms_base=kb, nterms_band=ks)
    ref = np.asarray(J.gls_power_multiband(t, y, err, bands, 3, df, fmin, nf, method=method,
                                           **kw))
    got = P.gls_power_multiband(T(t), T(y), T(err), T(bands), 3, df, fmin, nf, method=method,
                                **kw)
    _close(got, ref, 1e-9 * np.abs(ref).max())
    if method == "direct":
        fast = P.gls_power_multiband(T(t), T(y), T(err), T(bands), 3, df, fmin, nf, **kw)
        np.testing.assert_allclose(fast.numpy(), got.numpy(), atol=5e-6)


def test_single_band_reduces_to_gls_and_rejects_no_terms():
    rng = np.random.default_rng(1)
    n = 200
    t = np.sort(rng.uniform(0, 25, n))
    y = np.sin(2 * np.pi * t / PERIOD) + 0.1 * rng.standard_normal(n)
    err = np.full(n, 0.1)
    df, fmin, nf = 1 / 125.0, 1 / 250.0, 600
    p_ref = P.gls_power(T(t), T(y), T(err), df, fmin, nf, method="direct")
    p_mb = P.gls_power_multiband(T(t), T(y), T(err), torch.zeros(n, dtype=torch.int32), 1, df,
                                 fmin, nf, nterms_base=1, nterms_band=0, method="direct")
    np.testing.assert_allclose(p_mb.numpy(), p_ref.numpy(), atol=2e-5)
    with pytest.raises(ValueError):
        P.gls_power_multiband(torch.arange(8.0), torch.ones(8), torch.ones(8),
                              torch.zeros(8, dtype=torch.int32), 1, 0.01, 0.005, 16,
                              nterms_base=0, nterms_band=0)


def test_bootstrap_powers_multiband_match_jax(multiband_signal):
    """float64 replicates within 1e-9 of the largest, on the within-band
    indices MultibandGLS.bootstrap draws in the JAX package."""
    t, y, err, bands = multiband_signal
    n, r = t.size, 4
    key = jax.random.PRNGKey(0)
    idx = jnp.broadcast_to(jnp.arange(n), (r, n))
    for s in range(3):
        pos = jnp.asarray(np.flatnonzero(bands == s))
        key, sub = jax.random.split(key)
        idx = idx.at[:, pos].set(pos[jax.random.randint(sub, (r, pos.size), 0, pos.size)])
    idx = np.array(idx)
    assert (bands[idx] == bands).all()
    df, fmin, nf = 1 / 200.0, 1 / 400.0, 300
    ref = np.asarray(J._bootstrap_powers_multiband(t, y, err, bands, idx, 3, df, fmin, nf))
    got = P._bootstrap_powers_multiband(T(t), T(y), T(err), T(bands), T(idx), 3, df, fmin, nf)
    _close(got, ref, 1e-9 * ref.max())


def _band_dicts(t, y, err, bands, names=("g", "r", "i")):
    signals = {name: TSeries(t[bands == s], y[bands == s], device="cpu")
               for s, name in enumerate(names)}
    errs = {name: err[bands == s] for s, name in enumerate(names)}
    return signals, errs


def test_multiband_estimator_matches_jax(multiband_signal):
    """Array and dict input against JAX's estimator (float64, 1e-9 of the
    peak), the dict path equal to the array path, refine and model against
    JAX (1e-9 of the largest value; best frequency to 1e-12)."""
    t, y, err, bands = multiband_signal
    jmb = J.MultibandGLS(fmax=2.0)
    ref = jmb(JTSeries(t, y), err=err, bands=bands)
    jref = jmb.refine(n_peaks=1, zoom=16)
    mb = P.MultibandGLS(fmax=2.0)
    got = mb(TSeries(t, y, device="cpu"), err=err, bands=bands)
    np.testing.assert_array_equal(np.asarray(mb.frequency), np.asarray(jmb.frequency))
    peak = np.asarray(ref.values).max()
    _close(got.values, ref.values, 1e-9 * peak)
    assert abs(float(got.period_at_highest_peak) - PERIOD) / PERIOD < 0.05
    refined = mb.refine(n_peaks=1, zoom=16)
    _close(refined.values, jref.values, 1e-9 * peak)
    assert mb.refined_fbest == pytest.approx(jmb.refined_fbest, abs=1e-12)
    tf = np.linspace(5.0, 35.0, 200)
    for s in range(3):
        _close(mb.model(tf, 1 / PERIOD, s).values, jmb.model(tf, 1 / PERIOD, s).values,
               1e-9 * 10)

    signals, errs = _band_dicts(t, y, err, bands)
    mbd = P.MultibandGLS(fmax=2.0)
    fs = mbd(signals, err=errs)
    assert mbd.band_names == ["g", "r", "i"]
    np.testing.assert_allclose(fs.values.numpy(), got.values.numpy(), rtol=1e-10)
    np.testing.assert_allclose(mbd.model(tf, 1 / PERIOD, "r").values.numpy(),
                               mbd.model(tf, 1 / PERIOD, 1).values.numpy(), rtol=1e-12)
    with pytest.raises(ValueError, match="unknown band"):
        mbd.model(tf, 1 / PERIOD, 7)


def test_multiband_err_validated_and_sorted_with_signal(multiband_signal):
    """A wrong-length band error raises; errors given as TSeries over the
    same unsorted times sort as the signal does."""
    t, y, err, bands = multiband_signal
    signals, errs = _band_dicts(t, y, err, bands, names=(0, 1, 2))
    errs[1] = errs[1][:-3]
    with pytest.raises(ValueError, match="err\\[1\\]"):
        P.MultibandGLS(fmax=2.0)(signals, err=errs)
    rng = np.random.default_rng(3)
    shuffled, errs_ts, errs_sorted = {}, {}, {}
    for s in range(3):
        tb, yb, eb = t[bands == s], y[bands == s], err[bands == s]
        perm = rng.permutation(tb.size)
        shuffled[s] = TSeries(tb[perm], yb[perm], device="cpu")
        errs_ts[s] = TSeries(tb[perm], eb[perm], device="cpu")
        errs_sorted[s] = eb
    fs_ts = P.MultibandGLS(fmax=2.0)(shuffled, err=errs_ts)
    fs_raw = P.MultibandGLS(fmax=2.0)(shuffled, err=errs_sorted)
    np.testing.assert_allclose(fs_ts.values.numpy(), fs_raw.values.numpy(), rtol=1e-12)


def test_multiband_recovers_where_concatenation_cancels(multiband_signal):
    t, y, err, bands = multiband_signal
    df, fmin, nf = 1 / 200.0, 1 / 400.0, 700
    freqs = fmin + df * np.arange(nf)
    i0 = int(np.argmin(np.abs(freqs - 1 / PERIOD)))
    p_mb = P.gls_power_multiband(T(t), T(y), T(err), T(bands), 3, df, fmin, nf).numpy()
    p_cat = P.gls_power(T(t), T(y), T(err), df, fmin, nf, method="direct").numpy()
    assert abs(freqs[p_mb.argmax()] - 1 / PERIOD) < 2 * df
    assert p_mb[i0] > 0.8 and p_cat[i0] < 0.3 and p_mb[i0] > p_cat[i0] + 0.5


def test_multiband_bootstrap_model_and_refine(multiband_signal):
    """The peak beats the within-band null; FAL brackets the replicates;
    model() reproduces each band's curve; a coarse scan refines to well
    inside one cell."""
    t, y, err, bands = multiband_signal
    mb = P.MultibandGLS(fmax=2.0)
    fs = mb(TSeries(t, y, device="cpu"), err=err, bands=bands)
    peak = float(fs.values.max())
    reps = mb.bootstrap(6, random_seed=0)
    assert isinstance(reps, np.ndarray) and reps.shape == (6,)
    np.testing.assert_array_equal(mb.bootstrap(6, random_seed=0), reps)
    assert mb.fap(peak) <= 1 / 6
    assert mb.fal(0.01) >= mb.fal(0.5)
    assert reps.min() <= mb.fal(0.5) <= reps.max()
    assert mb.fap(1e-6) == 1.0
    tf = np.linspace(5.0, 35.0, 400)
    for s in range(3):
        pred = mb.model(tf, 1 / PERIOD, s).values.numpy()
        truth = OFFSETS[s] + AMPS[s] * np.sin(2 * np.pi * tf / PERIOD + 2 * np.pi * s / 3)
        assert np.max(np.abs(pred - truth)) < 0.1

    coarse = P.MultibandGLS(fmax=2.0, n=1)
    coarse(TSeries(t, y, device="cpu"), err=err, bands=bands)
    df = coarse.frequency[1] - coarse.frequency[0]
    refined = coarse.refine(n_peaks=1, zoom=16)
    best = coarse.frequency[int(coarse.periodogram.values.argmax())]
    assert abs(best - 1 / PERIOD) < df
    assert abs(coarse.refined_fbest - 1 / PERIOD) < min(abs(best - 1 / PERIOD) + 1e-12, df / 4)
    assert float(refined.values.max()) >= float(coarse.periodogram.values.max()) - 1e-6
