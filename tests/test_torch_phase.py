"""Phase-scorer parity: periodicity_tpu_torch.phase vs the JAX package.

The same numpy draws go to both packages, in float64 and float32.

Tolerances, with their reasons:
- ``binner="scatter"`` against JAX's scatter: 1e-10 relative in float64
  (the sums are taken in another order; measured <= 7e-14), and 1e-5 of
  the peak in float32 (f32 sums in another order, amplified by BLS's and
  AoV's cancellations; measured <= 1e-6). Gregory-Loredo in float32 sums
  lgamma terms of ~1e3 that cancel to log odds of ~1e1, so the few-ulp
  difference between ``torch.lgamma`` and JAX's ``gammaln`` shows at
  ~1.3e-5 of the peak: it is held at 5e-5.
- ``binner="kernel"``, which is the plain fold on the CPU, against JAX's
  ``binner="pallas"`` run through the Pallas interpreter: both bin by the
  same float32 formula (so BLS's best box is the same), but the value rows
  are f32 sums taken in another order, which AoV's within-bin variance
  amplifies to ~2.4e-6 of the peak: 1e-5 of the peak (Gregory-Loredo in
  float32 5e-5, as above).
- BLS's depth in float32 divides a window sum by r(1 - r), about 0.02 for
  the narrowest box, which amplifies the f32 prefix-sum differences: it
  is held at 1e-4 of its largest magnitude.
- BLS's box (width index, start bin) and what follows from it (duration,
  transit time) are exact wherever the best box is unique. Empty bins can
  make two boxes hold the same samples, and then rounding picks between
  them: at least 99% of the periods, and the best period, must agree.
- Best periods and the batch-vs-single comparisons are exact.
"""

import jax
import numpy as np
import pytest
import torch

from periodicity_tpu import TSeries as JTSeries
from periodicity_tpu.models import phase as J
from periodicity_tpu.ops import pallas_bls
from periodicity_tpu_torch import TSeries
from periodicity_tpu_torch.models import phase as P
from periodicity_tpu_torch.ops.fold import fold_onehot

DTYPES = [np.float64, np.float32]
WIDTHS = (3, 6, 13)


def _sine(n=400, period=7.7, noise=0.2, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 100.0, n))
    y = np.sin(2 * np.pi * t / period) + noise * rng.standard_normal(n)
    return t.astype(dtype), y.astype(dtype)


def _transit(n=400, period=5.17, q=0.05, depth=0.02, noise=0.003, seed=3, dtype=np.float64):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 60.0, n))
    y = np.where((t / period) % 1.0 < q, -depth, 0.0) + noise * rng.standard_normal(n)
    return t.astype(dtype), y.astype(dtype)


def _T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, ref, dtype, peak_tol=1e-5):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if dtype == np.float64:
        np.testing.assert_allclose(got, ref, rtol=1e-10, atol=0)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=peak_tol * np.abs(ref).max())


@pytest.fixture
def jax_kernel_binner():
    """JAX's ``binner="pallas"`` routed through the Pallas interpreter, as
    tests/test_phase.py does it (no TPU here; the jitted scans are retraced)."""
    orig = pallas_bls.fold_onehot

    def interp_fold(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    pallas_bls.fold_onehot = interp_fold
    jax.clear_caches()
    try:
        yield
    finally:
        pallas_bls.fold_onehot = orig
        jax.clear_caches()


def _same_boxes(got, ref, power):
    """BLS box indices (or a quantity they fix) agree on >= 99% of the
    periods and exactly at the best one (see the module docstring)."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    same = np.isclose(got, ref, rtol=1e-12, atol=0)
    assert same.mean() >= 0.99
    assert same[int(np.argmax(np.asarray(power)))]


def _fold_scans(dtype):
    t, y = _sine(dtype=dtype)
    periods = np.linspace(2.0, 20.0, 200).astype(dtype)
    return {
        "aov": (J.aov_scan, P.aov_scan, (t, y, periods), {"nb": 9}),
        "ce": (J.conditional_entropy_scan, P.conditional_entropy_scan, (t, y, periods),
               {"n_phi": 10, "n_mag": 5}),
        "gl": (J.gregory_loredo_scan, P.gregory_loredo_scan, (t, periods), {"n_bins": 12}),
    }


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["aov", "ce", "gl"])
def test_fold_scans_scatter_match_jax(dtype, name):
    jf, pf, args, kw = _fold_scans(dtype)[name]
    ref = jf(*args, **kw)
    got = pf(*map(_T, args), **kw)
    _close(got, ref, dtype, peak_tol=5e-5 if name == "gl" else 1e-5)
    pick = np.argmin if name == "ce" else np.argmax
    assert pick(got.numpy()) == pick(np.asarray(ref))


@pytest.mark.parametrize("dtype", DTYPES)
def test_fold_scans_kernel_binner_match_jax_pallas(dtype, jax_kernel_binner):
    """The kernel binner (plain fold on the CPU) against the interpreted
    Pallas fold, and through the public fold with no launch."""
    before = fold_onehot.launches
    for name, (jf, pf, args, kw) in _fold_scans(dtype).items():
        ref = jf(*args, binner="pallas", **kw)
        got = pf(*map(_T, args), binner="kernel", **kw)
        _close(got, ref, np.float32, peak_tol=5e-5 if name == "gl" and dtype == np.float32
               else 1e-5)
        assert got.numpy().dtype == np.asarray(ref).dtype
        pick = np.argmin if name == "ce" else np.argmax
        assert pick(got.numpy()) == pick(np.asarray(ref))
    assert fold_onehot.launches == before


@pytest.mark.parametrize("dtype", DTYPES)
def test_bls_scan_matches_jax(dtype):
    t, y = _transit(dtype=dtype)
    rng = np.random.default_rng(7)
    err = 0.01 * (1 + rng.uniform(size=t.size))
    w = ((1.0 / err**2) / np.sum(1.0 / err**2)).astype(dtype)
    periods = np.linspace(2.0, 9.0, 150).astype(dtype)
    ref = J.bls_scan(t, y, w, periods, widths=WIDTHS, nbins=128)
    got = P.bls_scan(_T(t), _T(y), _T(w), _T(periods), widths=WIDTHS, nbins=128)
    _close(got[0], ref[0], dtype)
    _close(got[1], ref[1], dtype, peak_tol=1e-4)
    for g, r in zip(got[2:], ref[2:]):
        _same_boxes(g, r, ref[0])


@pytest.mark.parametrize("dtype", DTYPES)
def test_bls_scan_kernel_binner_matches_jax_pallas(dtype, jax_kernel_binner):
    t, y = _transit(dtype=dtype)
    w = np.full(t.size, 1.0 / t.size, dtype)
    periods = np.linspace(2.0, 20.0, 160).astype(dtype)
    ref = J.bls_scan(t, y, w, periods, widths=WIDTHS, binner="pallas")
    got = P.bls_scan(_T(t), _T(y), _T(w), _T(periods), widths=WIDTHS, binner="pallas")
    _close(got[0], ref[0], np.float32)
    _close(got[1], ref[1], np.float32, peak_tol=1e-4)
    for g, r in zip(got[2:], ref[2:]):
        _same_boxes(g, r, ref[0])
    # against the scatter binner: the same peak; per-period powers agree
    # except where a sample within f32 rounding of a bin edge hops one bin
    sc = P.bls_scan(_T(t), _T(y), _T(w), _T(periods), widths=WIDTHS)[0].numpy()
    assert int(np.argmax(sc)) == int(np.argmax(got[0].numpy()))
    assert np.isclose(got[0].numpy(), sc, rtol=1e-3, atol=1e-9).mean() > 0.95


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["pdm", "sl", "sl_approx", "sl_fast"])
def test_pdm_and_string_length_scans_match_jax(dtype, name):
    t, y = _sine(dtype=dtype)
    periods = np.linspace(2.0, 20.0, 300).astype(dtype)
    m = ((y - y.max()) / (2 * (y.max() - y.min())) + 0.25).astype(dtype)
    jf, pf, args = {
        "pdm": (J.pdm_scan, P.pdm_scan, (t, y, periods)),
        "sl": (J.string_length_scan, P.string_length_scan, (t, m, periods)),
        "sl_approx": (J.string_length_approx_scan, P.string_length_approx_scan,
                      (t, m, periods)),
        "sl_fast": (J.string_length_scan_fast, P.string_length_scan_fast, (t, m, periods)),
    }[name]
    ref = jf(*args)
    got = pf(*map(_T, args))
    _close(got, ref, dtype)
    assert np.argmin(got.numpy()) == np.argmin(np.asarray(ref))


@pytest.mark.parametrize("binner", ["scatter", "kernel"])
def test_bls_batch_matches_per_series_and_jax(binner):
    rng = np.random.default_rng(5)
    t = np.sort(rng.uniform(0, 60.0, 300))
    ys, ws = [], []
    for period in (4.1, 6.9, 9.3):
        phi = (t / period) % 1.0
        ys.append(np.where(phi < 0.05, -0.02, 0.0) + 0.005 * rng.standard_normal(t.size))
        inv = 1.0 / (0.005 * (1 + rng.uniform(size=t.size))) ** 2
        ws.append(inv / inv.sum())
    ys, ws = np.stack(ys), np.stack(ws)
    periods = np.linspace(2.0, 12.0, 200)
    batched = P.bls_batch(_T(t), _T(ys), _T(ws), _T(periods), widths=(3, 13), nbins=128,
                          binner=binner)
    assert all(b.shape == (3, 200) for b in batched)
    for b in range(3):
        single = P.bls_scan(_T(t), _T(ys[b]), _T(ws[b]), _T(periods), widths=(3, 13),
                            nbins=128, binner=binner)
        for bt, st in zip(batched, single):
            np.testing.assert_array_equal(bt[b].numpy(), st.numpy())
    if binner == "scatter":
        ref = J.bls_batch(t, ys, ws, periods, widths=(3, 13), nbins=128)
        for g, r in zip(batched[:2], ref[:2]):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-10, atol=0)
        for b in range(3):
            for g, r in zip(batched[2:], ref[2:]):
                _same_boxes(g[b], r[b], ref[0][b])


def test_pdm_and_string_length_batch_match_scan_and_jax():
    rng = np.random.default_rng(0)
    t = np.sort(rng.uniform(0, 60, 300))
    ys = np.stack([np.sin(2 * np.pi * t / p) + 0.1 * rng.standard_normal(t.size)
                   for p in (4.0, 6.5, 9.0)])
    periods = np.linspace(2.0, 12.0, 150)
    thetas = P.pdm_batch(_T(t), _T(ys), _T(periods))
    np.testing.assert_allclose(thetas.numpy(), np.asarray(J.pdm_batch(t, ys, periods)),
                               rtol=1e-10)
    ms = (ys - ys.max(axis=1, keepdims=True)) / (
        2 * (ys.max(axis=1, keepdims=True) - ys.min(axis=1, keepdims=True))) + 0.25
    ells = P.string_length_batch(_T(t), _T(ms), _T(periods))
    np.testing.assert_allclose(ells.numpy(),
                               np.asarray(J.string_length_batch(t, ms, periods)), rtol=1e-10)
    for i in range(3):
        np.testing.assert_array_equal(thetas[i].numpy(),
                                      P.pdm_scan(_T(t), _T(ys[i]), _T(periods)).numpy())
        np.testing.assert_array_equal(
            ells[i].numpy(), P.string_length_scan(_T(t), _T(ms[i]), _T(periods)).numpy())


def _assert_fseries_match(got, ref, dtype, peak_tol=1e-5):
    np.testing.assert_array_equal(got.frequency.numpy(), np.asarray(ref.frequency))
    _close(got.values, ref.values, dtype, peak_tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_err", [False, True])
def test_bls_estimator_matches_jax(dtype, with_err):
    t, y = _transit(dtype=dtype)
    err = np.full(t.size, 0.003) if with_err else None
    kw = dict(durations=(0.02, 0.05, 0.1), nbins=256, p_min=2.0, p_max=20.0, n_periods=600)
    jb = J.BLS(**kw)
    ref = jb(JTSeries(t, y), err=err)
    pb = P.BLS(**kw)
    got = pb(TSeries(t, y, device="cpu"), err=err)
    assert pb._binner_resolved == "scatter"
    _assert_fseries_match(got, ref, dtype)
    rtol = 1e-10 if dtype == np.float64 else 1e-5
    _close(got.attrs["depth"], ref.attrs["depth"], dtype, peak_tol=1e-4)
    for key in ("duration", "transit_time"):
        _same_boxes(got.attrs[key], ref.attrs[key], ref.values)
    assert pb.best_period == jb.best_period
    for name in ("best_depth", "best_duration", "best_transit_time", "best_snr"):
        assert getattr(pb, name) == pytest.approx(getattr(jb, name), rel=rtol), name
    assert abs(pb.best_period - 5.17) < 0.01 * 5.17
    # attrs ride the FSeries' ascending-frequency order
    i = int(torch.argmax(got.values))
    assert float(got.period[i]) == pytest.approx(pb.best_period, rel=1e-12)
    assert float(got.attrs["depth"][i]) == pb.best_depth


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["aov", "ce", "gl", "pdm", "pdm_sub", "sl", "sl_exact"])
def test_estimators_match_jax(dtype, name):
    t, y = _sine(dtype=dtype)
    jcls, pcls, kw, pick = {
        "aov": (J.AoV, P.AoV, dict(p_min=2.0, p_max=20.0, n_periods=500), np.argmax),
        "ce": (J.ConditionalEntropy, P.ConditionalEntropy,
               dict(p_min=2.0, p_max=12.0, n_periods=500), np.argmin),
        "gl": (J.GregoryLoredo, P.GregoryLoredo,
               dict(p_min=2.0, p_max=12.0, n_periods=500), np.argmax),
        "pdm": (J.PDM, P.PDM, dict(p_min=2.0, p_max=12.0, n_periods=500), np.argmin),
        "pdm_sub": (J.PDM, P.PDM, dict(p_min=2.0, p_max=30.0, n_periods=500,
                                       do_subharmonic=True), np.argmin),
        "sl": (J.StringLength, P.StringLength, dict(n_periods=800), np.argmin),
        "sl_exact": (J.StringLength, P.StringLength, dict(n_periods=800, method="exact"),
                     np.argmin),
    }[name]
    ref = jcls(**kw)(JTSeries(t, y))
    est = pcls(**kw)
    got = est(TSeries(t, y, device="cpu"))
    _assert_fseries_match(got, ref, dtype, 5e-5 if name == "gl" else 1e-5)
    assert pick(got.values.numpy()) == pick(np.asarray(ref.values))
    if hasattr(est, "_binner_resolved"):
        assert est._binner_resolved == "scatter"


def test_gregory_loredo_on_event_times():
    """Raw event times (sorted by the estimator) and the TSeries surface
    give the same log odds, and find the injected period, as the JAX
    package's own test does."""
    rng = np.random.default_rng(9)
    base = np.sort(rng.uniform(0, 500, 3000))
    keep = rng.random(3000) < 0.15 + 0.8 * np.exp(
        -0.5 * ((((base / 5.0) % 1) - 0.3) / 0.08) ** 2)
    events = base[keep]
    kw = dict(p_min=2.0, p_max=10.0, n_periods=2000)
    got = P.GregoryLoredo(**kw)(_T(events[::-1].copy()))
    via_ts = P.GregoryLoredo(**kw)(TSeries(events, np.ones(events.size), device="cpu"))
    np.testing.assert_array_equal(got.values.numpy(), via_ts.values.numpy())
    ref = J.GregoryLoredo(**kw)(events)
    _close(got.values, ref.values, np.float64)
    best = float(got.period[int(torch.argmax(got.values))])
    assert best == pytest.approx(5.0, abs=0.02)


def test_binner_names():
    t, y = _sine(n=100)
    args = (_T(t), _T(y), _T(np.linspace(2.0, 20.0, 40)))
    np.testing.assert_array_equal(P.aov_scan(*args, binner="pallas").numpy(),
                                  P.aov_scan(*args, binner="kernel").numpy())
    np.testing.assert_array_equal(P.aov_scan(*args, binner="auto").numpy(),
                                  P.aov_scan(*args).numpy())
    with pytest.raises(ValueError, match="binner"):
        P.aov_scan(*args, binner="mxu")
    with pytest.raises(ValueError, match="durations"):
        P.BLS(durations=(0.6,))
