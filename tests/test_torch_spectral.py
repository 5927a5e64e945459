"""The rest of spectral: periodicity_tpu_torch vs the JAX package.

The same numpy draws go to both packages (JAX on the CPU with x64).
Tolerances, stated per test:

- float64: 1e-9 of the largest value (powers, trig sums, log-ML), or the
  exact same array where both run the same numpy code (peak picking,
  Baluev);
- float32: the port's float32 result against JAX's float64 result, within
  the JAX float32 path's own largest error against it on the same input,
  plus 1e-6 of the peak;
- where the normal equations of a frequency are ill-conditioned (the
  lowest bins, where cos(2 pi f t) ~ 1 for every sample), any two
  implementations that round differently disagree by up to about
  eps * cond(G) of the peak, with G the exact float64 weighted Gram matrix
  of the frequency's design [1?, cos, sin, ...]; such bins get that much
  more (``_gram_cond``). Elsewhere cond(G) is a few units.
- bootstrap replicates come from the indices the test makes with
  ``jax.random`` and feeds to both packages; the estimators draw their
  own with ``torch.Generator``, so there only shapes, finiteness and
  statistics are checked.

The behavioural checks of ``tests/test_spectral.py`` run on the port too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from periodicity_tpu import TSeries as JTSeries
from periodicity_tpu import spectral as jalias
from periodicity_tpu.models import spectral as J
from periodicity_tpu.ops import trig_sum as JT
from periodicity_tpu_torch import TSeries, spectral
from periodicity_tpu_torch.models import spectral as P
from periodicity_tpu_torch.ops import trig_sum as PT

T = torch.from_numpy


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, ref, atol):
    got, ref = _np(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype, (got.shape, ref.shape, got.dtype)
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)


def _gram_cond(t, err, freqs, nterms=1, fit_mean=True):
    """Condition number per frequency of the exact weighted Gram matrix
    X^T W X of the harmonic design [1?, cos(m w t), sin(m w t), ...] (with
    the scans' relative 1e-12 ridge), in float64 numpy."""
    t, w = np.asarray(t, np.float64), np.asarray(err, np.float64) ** -2.0
    w = w / w.sum()
    ph = 2 * np.pi * np.asarray(freqs)[:, None] * t[None, :]
    cols = ([np.ones_like(ph)] if fit_mean else []) + [
        fn(m * ph) for m in range(1, nterms + 1) for fn in (np.cos, np.sin)]
    X = np.stack(cols, axis=-1)
    g = np.einsum("fnd,n,fne->fde", X, w, X) + 1e-12 * np.eye(X.shape[-1])
    return np.linalg.cond(g)


def _batch_draw(n=400, b=5, seed=4, dtype=np.float64):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 50, n))
    ys = np.stack([np.sin(2 * np.pi * t / p) + 0.1 * rng.standard_normal(n)
                   for p in (3.0, 5.0, 7.0, 9.0, 11.0, 13.0, 4.4)[:b]])
    errs = rng.uniform(0.08, 0.12, (b, n))
    return t.astype(dtype), ys.astype(dtype), errs.astype(dtype)


def test_alias_exports_the_jax_names():
    assert sorted(spectral.__all__) == sorted(jalias.__all__)
    for name in jalias.__all__:
        assert callable(getattr(spectral, name))


@pytest.mark.parametrize("taps", [4, 8])
def test_trig_sum_batch_and_pair_match_jax(taps):
    """float64, 1e-9 of the largest sum; every row also matches the
    single-series sums (the JAX package's own check)."""
    rng = np.random.default_rng(3)
    n, b, nf = 500, 3, 256
    t = np.sort(rng.uniform(0, 40, n))
    ws = rng.standard_normal((b, n))
    w2 = np.abs(rng.standard_normal((b, n))) + 0.1
    df, fmin = 0.01, 0.005
    ref = JT.trig_sum_batch(t, ws, df, nf, fmin, taps=taps)
    got = PT.trig_sum_batch(T(t), T(ws), df, nf, fmin, taps=taps)
    scale = max(np.abs(r).max() for r in ref)
    for g, r in zip(got, ref):
        _close(g, r, 1e-9 * scale)
    for i in range(b):
        single = PT.trig_sum(T(t), T(ws[i]), df, nf, fmin, taps=taps)
        for g, s in zip(got, single):
            _close(g[i], s.numpy(), 1e-9 * scale)
    ref = JT.trig_sum_batch_pair(t, ws, w2, df, nf, fmin, q=1, taps=taps)
    got = PT.trig_sum_batch_pair(T(t), T(ws), T(w2), df, nf, fmin, q=1, taps=taps)
    scale = max(np.abs(r).max() for r in ref)
    for g, r in zip(got, ref):
        _close(g, r, 1e-9 * scale)


@pytest.mark.parametrize(
    "kw",
    [
        {},
        {"batch_size": 2},  # odd B over chunks of 2
        {"pair_q": 1},
        {"taps": 8},
        {"method": "direct"},
        {"fit_mean": False, "psd": True},
    ],
    ids=["default", "chunks", "pair_q", "taps8", "direct", "nomean_psd"],
)
def test_gls_power_batch_matches_jax(kw):
    """float64, 1e-9 of the peak, and each row the port's gls_power."""
    t, ys, errs = _batch_draw()
    df, fmin, nf = 0.005, 0.0025, 512
    ref = np.asarray(J.gls_power_batch(t, ys, errs, df, fmin, nf, **kw))
    got = P.gls_power_batch(T(t), T(ys), T(errs), df, fmin, nf, **kw)
    _close(got, ref, 1e-9 * ref.max())
    single = {k: v for k, v in kw.items() if k != "batch_size"}
    for i in (0, 4):
        row = P.gls_power(T(t), T(ys[i]), T(errs[i]), df, fmin, nf, **single)
        _close(got[i], row.numpy(), 1e-9 * ref.max())


@pytest.mark.parametrize("pair_q", [None, 1])
def test_gls_power_batch_float32_matches_jax(pair_q):
    """float32 row spreading against JAX's float64: within the JAX f32
    path's own error plus 1e-6 of the peak, plus eps32 * cond(G) of the
    peak per bin (cond(G) is largest at bin 0 of this grid, where
    f * baseline = 0.025 and both packages' float32 powers are noise)."""
    t, ys, errs = _batch_draw(n=600, b=3, seed=8, dtype=np.float32)
    df, nf = float(np.float32(1e-3)), 2048
    fmin = float(np.float32(df / 2))
    ref = np.asarray(J.gls_power_batch(t, ys, errs, np.float32(df), np.float32(fmin), nf,
                                       pair_q=pair_q))
    ref64 = np.asarray(J.gls_power_batch(t.astype(np.float64), ys.astype(np.float64),
                                         errs.astype(np.float64), df, fmin, nf, pair_q=pair_q))
    got = P.gls_power_batch(T(t), T(ys), T(errs), df, fmin, nf, pair_q=pair_q)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    freqs = fmin + df * np.arange(nf)
    cond = np.stack([_gram_cond(t, e, freqs) for e in errs])
    peak = ref64.max()
    tol = np.abs(ref - ref64).max() + 1e-6 * peak + np.finfo(np.float32).eps * cond * peak
    assert (np.abs(got.numpy() - ref64) <= tol).all()


def test_gls_power_batch_kernel_layout_needs_cuda():
    """The kernel layout launches the spreading kernel or raises: on CPU
    tensors it raises, and it never falls back to the row spreading."""
    t, ys, errs = _batch_draw(b=2)
    for gridder in ("kernel", "pallas"):
        with pytest.raises(ValueError, match="CUDA"):
            P.gls_power_batch(T(t), T(ys), T(errs), 0.005, 0.0025, 512, gridder=gridder)
    with pytest.raises(ValueError, match="gridder"):
        P.gls_power_batch(T(t), T(ys), T(errs), 0.005, 0.0025, 512, gridder="mxu")


def _spd(rng, batch, d, near_singular):
    a = rng.standard_normal((batch, d + 3, d))
    if near_singular:  # two almost equal columns
        a[..., -1] = a[..., 0] + 1e-7 * rng.standard_normal((batch, d + 3))
    g = np.einsum("bij,bik->bjk", a, a) + 1e-12 * np.eye(d)
    return g, rng.standard_normal((batch, d))


@pytest.mark.parametrize("d,near_singular", [(3, False), (7, False), (7, True), (18, False)])
def test_solve_spd_small_matches_jax(d, near_singular):
    """The unrolled Cholesky (and torch.linalg.solve above D = 16):
    solutions within 1e-9 of the largest, relative to the condition number
    (1e-15 * cond of the largest), log|G| within 1e-9 absolute."""
    rng = np.random.default_rng(d + 10 * near_singular)
    g, b = _spd(rng, 40, d, near_singular)
    cond = np.linalg.cond(g).max()
    ref = np.asarray(J._solve_spd_small(g, b))
    got = P._solve_spd_small(T(g), T(b))
    _close(got, ref, max(1e-9, 1e-15 * cond) * np.abs(ref).max())
    x_ref, ld_ref = (np.asarray(v) for v in J._solve_spd_small_logdet(g, b))
    x_got, ld_got = P._solve_spd_small_logdet(T(g), T(b))
    _close(x_got, x_ref, max(1e-9, 1e-15 * cond) * np.abs(x_ref).max())
    _close(ld_got, ld_ref, 1e-9 * max(1.0, np.abs(ld_ref).max()))
    if not near_singular:
        np.testing.assert_allclose(ld_got.numpy(), np.linalg.slogdet(g)[1], rtol=0, atol=1e-8)


def test_solve_spd_small_logdet_floors_degenerate_pivots():
    """A doubly collinear design: the pivot floor keeps the solve finite,
    as in the JAX package (same values)."""
    x = np.linspace(0.0, 1.0, 6)
    X = np.stack([np.ones(6), x, np.ones(6), x], axis=1)  # two pairs of equal columns
    g = (X.T @ X)[None]
    b = (X.T @ np.sin(x))[None]
    x_ref, ld_ref = (np.asarray(v) for v in J._solve_spd_small_logdet(g, b))
    x_got, ld_got = P._solve_spd_small_logdet(T(g), T(b))
    assert np.isfinite(x_got.numpy()).all() and np.isfinite(ld_got.numpy()).all()
    _close(ld_got, ld_ref, 1e-9 * np.abs(ld_ref).max())


@pytest.mark.parametrize("nterms", [1, 3])
def test_bootstrap_powers_match_jax_on_the_same_indices(nterms):
    """float64, 1e-9 of the largest replicate; the indices are the ones
    JAX draws from the key it is given."""
    rng = np.random.default_rng(3)
    t = np.arange(100.0)
    y = rng.standard_normal(100)
    err = rng.uniform(0.8, 1.2, 100)
    key = jax.random.PRNGKey(0)
    idx = np.array(jax.random.randint(key, (12, 100), 0, 100))
    df, fmin, nf = 0.002, 0.001, 500
    ref = np.asarray(J._bootstrap_powers(key, t, y, err, df, fmin, nf, 12, pair_q=1,
                                         nterms=nterms))
    got = P._bootstrap_powers(T(idx), T(t), T(y), T(err), df, fmin, nf, pair_q=1,
                              nterms=nterms)
    _close(got, ref, 1e-9 * ref.max())


@pytest.mark.parametrize("psd,fit_mean", [(False, True), (True, True), (False, False)])
def test_baluev_matches_jax(psd, fit_mean):
    """The same numpy arithmetic: FAP equal to 1e-14, FAL to 1e-12; inputs
    given as tensors."""
    rng = np.random.default_rng(8)
    t = np.sort(rng.uniform(0, 50, 200))
    err = rng.uniform(0.2, 0.4, 200)
    z = np.linspace(1.0, 20.0, 10) if psd else np.linspace(0.01, 0.6, 12)
    ref = J.fap_baluev(t, err, z, fmax=5.0, psd=psd, fit_mean=fit_mean)
    got = P.fap_baluev(T(t), T(err), T(z), fmax=5.0, psd=psd, fit_mean=fit_mean)
    np.testing.assert_allclose(got, ref, rtol=1e-14, atol=0)
    assert np.all(np.diff(got) < 0)
    for target in (0.01, 0.1, 0.5):
        zt = P.fal_baluev(T(t), T(err), target, fmax=5.0, psd=psd, fit_mean=fit_mean)
        assert zt == pytest.approx(J.fal_baluev(t, err, target, fmax=5.0, psd=psd,
                                                fit_mean=fit_mean), rel=1e-12)
        assert P.fap_baluev(t, err, zt, fmax=5.0, psd=psd, fit_mean=fit_mean) == pytest.approx(
            target, rel=1e-6)
    with pytest.raises(ValueError):
        P.fal_baluev(t, err, 1.5, fmax=5.0)
    with pytest.raises(ValueError, match="more samples"):
        P.fap_baluev(t[:3], err[:3], 0.5, fmax=5.0)


@pytest.mark.parametrize("fn", ["bglst_log_ml", "bglst_log_ml_fast"])
def test_bglst_matches_jax(fn):
    """float64 log-ML within 1e-9 of its largest magnitude; fast and direct
    agree to JAX's own bound (``assert_allclose(atol=5e-8)``, whose default
    rtol of 1e-7 is what holds at bin 0, where the [cos, sin, t, 1] Gram
    matrix is nearly singular, in the JAX package too)."""
    rng = np.random.default_rng(5)
    n, nf = 600, 2000
    t = np.sort(rng.uniform(0, 80, n))
    y = np.sin(2 * np.pi * t / 7.0) + 0.02 * t + 0.3 * rng.standard_normal(n)
    w = np.full(n, 0.3) ** -2.0
    df = 1.0 / 5 / (t[-1] - t[0])
    ref = np.asarray(getattr(J, fn)(t, y, w, df, df / 2, nf))
    got = getattr(P, fn)(T(t), T(y), T(w), df, df / 2, nf)
    _close(got, ref, 1e-9 * np.abs(ref).max())
    other = P.bglst_log_ml(T(t), T(y), T(w), df, df / 2, nf) if fn.endswith("fast") else \
        P.bglst_log_ml_fast(T(t), T(y), T(w), df, df / 2, nf)
    assert int(other.argmax()) == int(got.argmax())
    np.testing.assert_allclose(other.numpy(), got.numpy(), atol=5e-8)


def test_bglst_near_singular_design_stays_finite():
    rng = np.random.default_rng(7)
    t = np.sort(rng.uniform(0, 10.0, 6))
    y = 0.1 * t + 0.01 * rng.standard_normal(6)
    w = np.full(6, 25.0)
    for fn in ("bglst_log_ml", "bglst_log_ml_fast"):
        got = getattr(P, fn)(T(t), T(y), T(w), 1e-5, 1e-7, 64)
        assert torch.isfinite(got).all()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_gls_estimator_surface_matches_jax(dtype):
    """GLS, refine, window, model and the Baluev FAP/FAL end to end.
    float64 within 1e-9 of the peak (refined best frequency to 1e-12);
    float32 within the JAX f32 path's own error against f64 plus 1e-6 of
    the peak (refined best frequency to the local grid step)."""
    rng = np.random.default_rng(2)
    n = 600
    t = np.sort(rng.uniform(0, 80.0, n))
    y = np.sin(2 * np.pi * t / 7.31) + 0.2 * rng.standard_normal(n)
    err = rng.uniform(0.15, 0.25, n)
    tf = np.linspace(0.0, 80.0, 300)

    def run(pkg_gls, series, dt):
        g = pkg_gls()
        p = g(series(t.astype(dt), y.astype(dt)), err=err.astype(dt))
        r = g.refine(n_peaks=2, zoom=16)
        return g, {"power": p.values, "refined": r.values, "refined_f": r.frequency,
                   "window": g.window().values, "model": g.model(tf, 1 / 7.31).values}

    jg, ref = run(J.GLS, JTSeries, dtype)
    g, got = run(P.GLS, lambda a, b: TSeries(a, b, device="cpu"), dtype)
    if dtype == np.float64:
        tols = {k: 1e-9 * np.abs(np.asarray(v)).max() for k, v in ref.items()}
        f_tol = 1e-12
    else:
        _, ref64 = run(J.GLS, JTSeries, np.float64)
        tols = {k: np.abs(np.asarray(v, np.float64) - np.asarray(ref64[k])).max()
                + 1e-6 * np.abs(np.asarray(v)).max() for k, v in ref.items()}
        f_tol = 2 * 2.0 * (jg.frequency[1] - jg.frequency[0]) / 64
    for key in ref:
        _close(got[key], ref[key], tols[key])
    assert g.refined_fbest == pytest.approx(jg.refined_fbest, abs=f_tol)
    assert abs(1 / g.refined_fbest - 7.31) < 0.01
    z = g.fal(0.05, method="baluev")
    assert z == pytest.approx(jg.fal(0.05, method="baluev"), rel=1e-9)
    assert float(g.fap(z, method="baluev")) == pytest.approx(0.05, rel=1e-6)
    with pytest.raises(ValueError):
        g.fap(0.1, method="nope")


def test_signal_arithmetic_and_amax():
    """The container arithmetic window() rests on: same class, same
    coordinate, as the JAX containers."""
    t = np.array([0.0, 1.0, 2.5, 4.0])
    y = np.array([1.0, -2.0, np.nan, 3.0])
    ts, jts = TSeries(t, y, device="cpu"), JTSeries(t, y)
    for fn in (lambda s: 0.0 * s + 1.0, lambda s: s - 2, lambda s: 2 - s, lambda s: s * s,
               lambda s: s / 4.0, lambda s: 1.0 / s, lambda s: s + np.arange(4.0)):
        got, ref = fn(ts), fn(jts)
        assert isinstance(got, TSeries)
        np.testing.assert_array_equal(got.time.numpy(), np.asarray(ref.time))
        np.testing.assert_array_equal(got.values.numpy(), np.asarray(ref.values))
    assert float(ts.amax()) == float(jts.amax()) == 3.0


# -- behaviour, after tests/test_spectral.py ----------------------------------


def test_window_and_model():
    rng = np.random.default_rng(2)
    t = np.sort(rng.uniform(0, 30, 200))
    y = np.sin(2 * np.pi * t / 5.0)
    gls = P.GLS()
    ls = gls(TSeries(t, y, device="cpu"))
    win = gls.window()
    assert win.size == ls.size
    fit = gls.model(t, 1 / 5.0)
    assert np.corrcoef(fit.values.numpy(), y)[0, 1] > 0.99


def test_bootstrap_fap_and_baluev_calibration():
    """Replicates of pure noise: finite, one per replicate, the same for
    the same seed; the Baluev FAP tracks the bootstrap null within a small
    factor at its quantiles (tests/test_spectral.py's calibration)."""
    rng = np.random.default_rng(7)
    t = np.arange(100.0)
    y = rng.standard_normal(100)
    gls = P.GLS()
    ls = gls(TSeries(t, y, device="cpu"))
    reps = gls.bootstrap(400, random_seed=1)
    assert isinstance(reps, np.ndarray) and reps.shape == (400,)
    assert np.isfinite(reps).all() and (reps >= 0).all()
    again = P.GLS()
    again(TSeries(t, y, device="cpu"))
    np.testing.assert_array_equal(again.bootstrap(400, random_seed=1), reps)
    assert gls.fap(float(ls.amax())) == np.mean(float(ls.amax()) < reps)
    assert gls.fal(0.5) == np.quantile(reps, 0.5) > 0.0
    for q in (0.5, 0.9):
        z = float(np.quantile(reps, q))
        analytic = float(gls.fap(z, method="baluev"))
        assert 0.3 * (1 - q) < analytic < 4.0 * (1 - q)


def test_refine_lands_exact_peak_and_respects_fit_mean():
    rng = np.random.default_rng(2)
    n = 1500
    t = np.sort(rng.uniform(0, 80.0, n))
    f_true = 1.0 / 7.31
    y = np.sin(2 * np.pi * f_true * t) + 0.2 * rng.standard_normal(n)
    err = np.full(n, 0.2)
    gls = P.GLS()
    fs = gls(TSeries(t, y, device="cpu"), err=err)
    df = gls.frequency[1] - gls.frequency[0]
    coarse_err = abs(1.0 / float(fs.period_at_highest_peak) - f_true)
    refined = gls.refine(n_peaks=2, zoom=32)
    assert abs(gls.refined_fbest - f_true) <= coarse_err + 1e-12
    assert abs(gls.refined_fbest - f_true) < df / 4
    assert float(refined.values.max()) > 0.5
    assert bool((torch.diff(refined.frequency) >= 0).all())

    nomean = P.GLS()
    nomean(TSeries(t, y, device="cpu"), err=err, fit_mean=False)
    r = nomean.refine(zoom=16)
    f = r.frequency.numpy()
    direct = P.gls_power(T(t), T(y), T(err), f[1] - f[0], f[0], f.size, fit_mean=False,
                         method="direct")
    np.testing.assert_allclose(r.values.numpy(), direct.numpy(), rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("method", ["fast", "direct"])
def test_bglst_recovers_period_with_trend(method):
    """The estimator against JAX's (float64, 1e-9 of the largest |log-ML|),
    on target under a secular trend."""
    rng = np.random.default_rng(5)
    t = np.sort(rng.uniform(0, 60, 400))
    y = np.sin(2 * np.pi * t / 6.1) + 0.05 * t + 0.2 * rng.standard_normal(400)
    bg = P.BGLST(method=method)
    assert P.BGLST().method == "fast"
    fs = bg(TSeries(t, y, device="cpu"), err=np.full(400, 0.2))
    ref = J.BGLST(method=method)(JTSeries(t, y), err=np.full(400, 0.2))
    np.testing.assert_array_equal(fs.frequency.numpy(), np.asarray(ref.frequency))
    _close(fs.values, ref.values, 1e-9 * np.abs(np.asarray(ref.values)).max())
    f = fs.frequency.numpy()
    assert 1.0 / f[int(fs.values.argmax())] == pytest.approx(6.1, abs=0.1)


# -- multi-term GLS, after tests/test_multiterm.py -----------------------------


@pytest.fixture(scope="module")
def harmonic_signal():
    rng = np.random.default_rng(0)
    n = 300
    t = np.sort(rng.uniform(0, 30, n))
    period = 3.7
    y = (np.sin(2 * np.pi * t / period) + 0.5 * np.sin(4 * np.pi * t / period + 0.3)
         + 0.25 * np.sin(6 * np.pi * t / period + 1.0) + 0.1 * rng.standard_normal(n))
    err = rng.uniform(0.08, 0.12, n)
    return t, y, err, period


@pytest.mark.parametrize(
    "nterms,method,kw",
    [(1, "fast", {}), (1, "direct", {}), (2, "fast", {}), (2, "direct", {}), (3, "fast", {}),
     (3, "direct", {}), (2, "fast", {"fit_mean": False}), (2, "direct", {"fit_mean": False}),
     (3, "fast", {"psd": True})],
)
def test_gls_power_multiterm_matches_jax(harmonic_signal, nterms, method, kw):
    """float64 within 1e-9 of the peak, plus eps * cond(G) of the peak per
    bin: the (2K+1)-column design is nearly singular at the lowest bins of
    this grid (f * baseline = 0.1), where any two implementations that
    round differently part by about that much."""
    t, y, err, _ = harmonic_signal
    df, fmin, nf = 1 / 150.0, 1 / 300.0, 800
    ref = np.asarray(J.gls_power_multiterm(t, y, err, df, fmin, nf, nterms, method=method,
                                           **kw))
    got = P.gls_power_multiterm(T(t), T(y), T(err), df, fmin, nf, nterms, method=method, **kw)
    cond = _gram_cond(t, err, fmin + df * np.arange(nf), nterms, kw.get("fit_mean", True))
    peak = np.abs(ref).max()
    assert got.dtype == torch.float64 and got.shape == ref.shape
    assert (np.abs(got.numpy() - ref) <= (1e-9 + np.finfo(np.float64).eps * cond) * peak).all()


def test_gls_power_multiterm_float32_matches_jax(harmonic_signal):
    """float32 fast path against JAX's float64 direct method: within the JAX
    f32 fast path's own error against it plus 1e-6 of the peak, plus
    eps32 * cond(G) of the peak per bin. At bin 0 the float32 ridge is
    below rounding and JAX's float32 power is NaN; its error is taken over
    the bins where it is finite."""
    t, y, err, _ = harmonic_signal
    df, fmin, nf = float(np.float32(1 / 150.0)), float(np.float32(1 / 300.0)), 800
    t32, y32, e32 = (a.astype(np.float32) for a in (t, y, err))
    ref64 = np.asarray(J.gls_power_multiterm(t32.astype(np.float64), y32.astype(np.float64),
                                             e32.astype(np.float64), df, fmin, nf, 3,
                                             method="direct"))
    ref = np.asarray(J.gls_power_multiterm(t32, y32, e32, np.float32(df), np.float32(fmin), nf,
                                           3))
    got = P.gls_power_multiterm(T(t32), T(y32), T(e32), df, fmin, nf, 3)
    assert got.dtype == torch.float32 and np.isnan(ref[0]) and np.isfinite(ref[1:]).all()
    # the port is finite at JAX's NaN bin (ROADMAP.md C2)
    assert np.isfinite(got.numpy()).all()
    cond = _gram_cond(t32, e32, fmin + df * np.arange(nf), 3)
    peak = ref64.max()
    tol = np.nanmax(np.abs(ref - ref64)) + 1e-6 * peak + np.finfo(np.float32).eps * cond * peak
    assert (np.abs(got.numpy() - ref64) <= tol).all()


def test_solve_spd_small_floors_collapsed_pivots():
    """C2: a nearly collinear float32 Gram matrix whose last pivot rounds to
    zero or below. JAX's unfloored recurrence returns NaN or inf, and so
    does the port's without the floor; the port's solve is finite.
    Healthy systems keep the unfloored bits, and a pivot far below zero
    (not rounding) stays NaN as in JAX."""
    rng = np.random.default_rng(0)
    n = 50
    c = rng.standard_normal(n)
    A = np.stack([np.ones(n), c, c + 1e-4 * rng.standard_normal(n)], 1).astype(np.float32)
    G = A.T @ A + np.float32(1e-8) * np.eye(3, dtype=np.float32)
    b = (A.T @ rng.standard_normal(n)).astype(np.float32)
    assert not np.isfinite(np.asarray(J._solve_spd_small(jnp.asarray(G), jnp.asarray(b)))).all()
    assert not torch.isfinite(P._cholesky_solve_unrolled(T(G), T(b))[0]).all()
    x = P._solve_spd_small(T(G), T(b))
    assert torch.isfinite(x).all()
    # with every pivot positive, b . x = |L^-1 b|^2: a power is never negative
    assert float(torch.dot(T(b), x)) >= 0.0
    healthy = (lambda M: M @ M.transpose(-1, -2) + 3 * torch.eye(3, dtype=torch.float32))(
        torch.from_numpy(rng.standard_normal((64, 3, 3)).astype(np.float32)))
    hb = torch.from_numpy(rng.standard_normal((64, 3)).astype(np.float32))
    assert torch.equal(P._solve_spd_small(healthy, hb), P._cholesky_solve_unrolled(healthy, hb)[0])
    indefinite = torch.tensor([[1.0, 2.0], [2.0, 1.0]])
    assert not torch.isfinite(P._solve_spd_small(indefinite, torch.ones(2))).all()


def test_config12_tolerance_is_jax_float32_error():
    """``chip_smoke.C12_JAX_F32_ERR``, the tolerance the card's config-12
    check doubles: the JAX package's float32 multi-term fast path against
    the float64 direct method (the port's, held to JAX's above), as a share
    of the peak, over the bins where cond(G) <= 1e4, at config 12 reduced to
    N = 2000 (the same grid and signal model). Pinned to within a factor 2
    below."""
    n, nf = 2000, 25_000
    t, y, err = chip_smoke.light_curve(n, 100.0, harmonic=True)
    df, fmin = np.float32(1 / 500.0), np.float32(1 / 1000.0)
    p32 = np.asarray(J.gls_power_multiterm(t, y, err, df, fmin, nf, 3))
    p64 = P.gls_power_multiterm(*(T(a).double() for a in (t, y, err)), float(df), float(fmin),
                                nf, 3, method="direct").numpy()
    freqs = float(fmin) + float(df) * torch.arange(nf, dtype=torch.float64)
    well = chip_smoke.gram_cond(T(t), T(err) ** -2.0, freqs, 3).numpy() <= 1e4
    measured = np.nanmax(np.abs(p32 - p64)[well]) / p64.max()
    assert 0.5 * chip_smoke.C12_JAX_F32_ERR <= measured <= chip_smoke.C12_JAX_F32_ERR


def test_gram_cond_matches_numpy(harmonic_signal):
    """The card's conditioning helper against the numpy one above, to 1e-3
    (a condition number of 3e12 is itself known only to about eps * 3e12)."""
    t, _, err, _ = harmonic_signal
    freqs = 1 / 300.0 + np.arange(300) / 150.0  # two chunks of the card's 256
    got = chip_smoke.gram_cond(T(t), T(err) ** -2.0, T(freqs), 3).numpy()
    np.testing.assert_allclose(got, _gram_cond(t, err, freqs, 3), rtol=1e-3)


def test_multiterm_k1_reduces_to_gls_and_concentrates_harmonic_power(harmonic_signal):
    t, y, err, period = harmonic_signal
    df, fmin, nf = 1 / 150.0, 1 / 300.0, 800
    args = (T(t), T(y), T(err), df, fmin, nf)
    p_gls = P.gls_power(*args, method="direct")
    p_k1 = P.gls_power_multiterm(*args, 1, method="direct")
    np.testing.assert_allclose(p_k1.numpy(), p_gls.numpy(), atol=1e-9)
    freqs = fmin + df * np.arange(nf)
    p1 = P.gls_power_multiterm(*args, 1).numpy()
    p3 = P.gls_power_multiterm(*args, 3).numpy()
    i0 = np.argmin(np.abs(freqs - 1 / period))
    assert abs(freqs[p3.argmax()] - 1 / period) < 2 * df
    assert p3[i0] > p1[i0] + 0.1 and p3[i0] > 0.9
    pf = P.gls_power_multiterm(*args, 2, fit_mean=False).numpy()
    assert np.all((pf > -1e-9) & (pf < 1 + 1e-9))


def test_multiterm_estimator_surface_matches_jax(harmonic_signal):
    """GLS(nterms=3): periodogram, refine and model against JAX (float64,
    1e-9 of the largest value, plus eps * cond(G) for the periodogram);
    the harmonic fit beats the single-term one as in the JAX package."""
    t, y, err, period = harmonic_signal
    jg = J.GLS(nterms=3)
    jp = jg(JTSeries(t, y), err=err)
    jr = jg.refine(n_peaks=1, zoom=16)
    g = P.GLS(nterms=3)
    assert g.copy().nterms == 3
    sig = TSeries(t, y, device="cpu")
    p = g(sig, err=err)
    r = g.refine(n_peaks=1, zoom=16)
    cond = _gram_cond(t, err, g.frequency, 3)
    peak = np.asarray(jp.values).max()
    assert (np.abs(p.values.numpy() - np.asarray(jp.values))
            <= (1e-9 + np.finfo(np.float64).eps * cond) * peak).all()
    _close(r.values, jr.values, 1e-9 * peak)
    assert g.refined_fbest == pytest.approx(jg.refined_fbest, abs=1e-12)
    assert abs(float(p.period_at_highest_peak) - period) / period < 0.05
    assert abs(1.0 / g.refined_fbest - period) / period < 0.02
    tf = np.linspace(t.min(), t.max(), 500)
    model3 = g.model(tf, 1.0 / period)
    _close(model3.values, jg.model(tf, 1.0 / period).values, 1e-9)
    g1 = P.GLS(nterms=1)
    g1(sig, err=err)
    model1 = g1.model(tf, 1.0 / period).values.numpy()
    truth = (np.sin(2 * np.pi * tf / period) + 0.5 * np.sin(4 * np.pi * tf / period + 0.3)
             + 0.25 * np.sin(6 * np.pi * tf / period + 1.0))
    r3 = np.mean((model3.values.numpy() - truth) ** 2)
    r1 = np.mean((model1 - truth) ** 2)
    assert r3 < 0.25 * r1 and r3 < 0.01


def test_multiterm_bootstrap_fap_and_null(harmonic_signal):
    """Harmonic replicates: the 3-harmonic signal beats every resample,
    Baluev refuses nterms > 1, and on pure noise the nterms=2 null
    dominates the nterms=1 null pairwise (the same seed gives the same
    indices, and the single-term model is nested)."""
    t, y, err, _ = harmonic_signal
    gls = P.GLS(nterms=2)
    fs = gls(TSeries(t, y, device="cpu"), err=err)
    reps = gls.bootstrap(12, random_seed=0)
    assert reps.shape == (12,) and np.isfinite(reps).all() and (reps >= 0).all()
    peak = float(fs.values.max())
    assert gls.fap(peak) <= 1.0 / 12.0
    assert float(gls.fal(0.5)) <= peak
    with pytest.raises(NotImplementedError):
        gls.fap(peak, method="baluev")
    with pytest.raises(NotImplementedError):
        gls.fal(0.01, method="baluev")

    rng = np.random.default_rng(11)
    tn = np.sort(rng.uniform(0, 20, 120))
    yn = rng.standard_normal(120)
    null = {}
    for k in (1, 2):
        g = P.GLS(nterms=k, fmax=3.0)
        g(TSeries(tn, yn, device="cpu"), err=np.ones(120))
        null[k] = g.bootstrap(24, random_seed=5)
    assert np.all(null[2] >= null[1] - 1e-9)
    assert np.mean(null[2]) > np.mean(null[1])
