"""Spline parity: periodicity_tpu_torch.ops.spline vs the JAX package.

The same numpy draws go to both packages, the JAX side on the CPU in x64.

Tolerances, with their reasons:
- PCR against Thomas: 1e-12 absolute on diagonally dominant systems with
  O(1) solutions (the JAX package's own test,
  ``tests/test_containers_extra.py``);
- interpolating splines (cubic, masked cubic, quadratic) against JAX:
  1e-10 absolute on O(1) data (JAX holds them at 1e-9/1e-10 against scipy);
- the smoothing spline against JAX: 1e-8 absolute, JAX's own bound
  against ``make_smoothing_spline``; the ``s`` criterion to rtol 1e-6 as
  JAX's test;
- the pentadiagonal solve's plain version against JAX's scans: 1e-12 of
  the solution's scale in float64; in float32 within twice JAX's own
  float32 error of the float64 solve (XLA contracts multiply-adds into
  FMAs on the CPU; the port rounds each operation, as its kernel does).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from periodicity_tpu.ops import spline as J
from periodicity_tpu_torch.ops import spline as P


def _T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _system(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.5, 2.0, n), 4.0 + rng.uniform(0, 1, n), rng.uniform(0.5, 2.0, n),
            rng.standard_normal(n))


@pytest.mark.parametrize("n", [5, 32, 100, 513])
def test_tridiagonal_pcr_matches_thomas_and_jax(n):
    sysm = _system(n, 7)
    thomas = P.tridiagonal_solve(*map(_T, sysm))
    pcr = P.tridiagonal_solve_pcr(*map(_T, sysm))
    np.testing.assert_allclose(pcr.numpy(), thomas.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(pcr.numpy(), np.asarray(J.tridiagonal_solve_pcr(*sysm)),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(thomas.numpy(), np.asarray(J.tridiagonal_solve(*sysm)),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("n", [6, 300])
def test_spline_interp_matches_jax(n):
    """Not-a-knot cubic through the Thomas (n < 32) and PCR paths,
    extrapolated past both ends."""
    rng = np.random.default_rng(1)
    x = np.sort(rng.uniform(0, 10, n))
    y = np.sin(x) + 0.1 * rng.standard_normal(n)
    xn = np.linspace(-0.5, 10.5, 700)
    ref = np.asarray(J.spline_interp(x, y, xn))
    got = P.spline_interp(_T(x), _T(y), _T(xn)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-10)


def test_masked_spline_matches_jax():
    """The fixed-capacity variant EMD's sift uses, with ``count`` and the
    precomputed interval index ``hi``."""
    rng = np.random.default_rng(2)
    cap, cnt = 128, 90
    xk = np.sort(rng.uniform(0, 10, cnt))
    xp = np.concatenate([xk, xk[-1] + 1 + np.arange(cap - cnt)])
    yp = np.concatenate([np.cos(xk), np.zeros(cap - cnt)])
    xn = np.linspace(-0.5, 10.5, 333)
    ref = np.asarray(J.spline_interp(xp, yp, xn, count=cnt))
    got = P.spline_interp(_T(xp), _T(yp), _T(xn), count=cnt)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-10)
    hi = P._interval_index(_T(xp), _T(xn))
    np.testing.assert_array_equal(hi.numpy(), np.searchsorted(xp, xn, side="right"))
    got_hi = P.spline_interp(_T(xp), _T(yp), _T(xn), count=torch.tensor(cnt), hi=hi)
    np.testing.assert_array_equal(got_hi.numpy(), got.numpy())


def test_quadratic_spline_matches_jax():
    rng = np.random.default_rng(9)
    x = np.sort(rng.uniform(0, 10, 60))
    y = np.sin(x) + 0.1 * rng.standard_normal(60)
    xe = np.linspace(x[0], x[-1], 101)
    ref = np.asarray(J.quadratic_spline_interp(x, y, xe))
    got = P.quadratic_spline_interp(_T(x), _T(y), _T(xe)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-10)


@pytest.mark.parametrize("lam", [1e-3, 0.1, 1.0])
def test_smoothing_spline_values_match_jax(lam):
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(0, 10, 200))
    y = np.sin(x) + 0.2 * rng.standard_normal(200)
    w = rng.uniform(0.5, 3.0, 200)
    f_ref, g_ref = J.smoothing_spline_values(x, y, lam, w)
    f, g = P.smoothing_spline_values(_T(x), _T(y), lam, _T(w))
    np.testing.assert_allclose(f.numpy(), np.asarray(f_ref), rtol=0, atol=1e-8)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=0, atol=1e-8)
    xe = np.linspace(-0.5, 10.5, 77)
    np.testing.assert_allclose(P.smoothing_spline_eval(_T(x), f, g, _T(xe)).numpy(),
                               np.asarray(J.smoothing_spline_eval(x, f_ref, g_ref, xe)),
                               rtol=0, atol=1e-8)


def test_smoothing_spline_interp_matches_jax():
    """The bisection on lam lands where JAX's does (one comparison: JAX's
    eager bisection compiles its scans anew at each of its ~62 steps, ~20 s
    on the CPU), and meets FITPACK's criterion sum((w (y - f))^2) = s,
    weighted and not, as JAX's own test checks it."""
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(0, 10, 80))
    y = np.sin(x) + 0.2 * rng.standard_normal(80)
    w = rng.uniform(0.5, 3.0, 80)
    ref = np.asarray(J.smoothing_spline_interp(x, y, x, s=1.6))
    got = P.smoothing_spline_interp(_T(x), _T(y), _T(x), s=1.6).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-8)
    assert np.sum((y - got) ** 2) == pytest.approx(1.6, rel=1e-6)
    for s_val in (0.5, 2.0):
        got = P.smoothing_spline_interp(_T(x), _T(y), _T(x), s=s_val, w=_T(w)).numpy()
        assert np.sum((w * (y - got)) ** 2) == pytest.approx(s_val, rel=1e-5)


@pytest.mark.parametrize("n", [3, 4, 5])
def test_tiny_smoothing_splines_match_jax(n):
    """m = n - 2 in {1, 2, 3}: the banded solve's edge cases."""
    rng = np.random.default_rng(n)
    xs = np.sort(rng.uniform(0, 1, n))
    ys = rng.standard_normal(n)
    f_ref, g_ref = J.smoothing_spline_values(xs, ys, 0.05)
    f, g = P.smoothing_spline_values(_T(xs), _T(ys), 0.05)
    np.testing.assert_allclose(f.numpy(), np.asarray(f_ref), rtol=0, atol=1e-8)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=0, atol=1e-8)
    assert np.isfinite(P.smoothing_spline_interp(_T(xs), _T(ys), _T(xs), s=0.05).numpy()).all()


def _penta(m, seed):
    rng = np.random.default_rng(seed)
    return (4.0 + rng.uniform(0, 1, m), rng.uniform(-1, 1, max(m - 1, 0)),
            rng.uniform(-0.5, 0.5, max(m - 2, 0)), rng.standard_normal(m))


@pytest.mark.parametrize("m", [1, 2, 3, 50])
def test_pentadiagonal_plain_matches_jax_scans(m):
    bands = _penta(m, m)
    ref = np.asarray(J._pentadiagonal_solve(*map(jnp.asarray, bands)))
    got = P._pentadiagonal_solve(*map(_T, bands))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-12 * np.abs(ref).max())
    assert P._pentadiagonal_solve.launches == 0  # CPU tensors never launch the kernel


def test_pentadiagonal_zero_pivot_guards_match_jax():
    """A zero pivot (D = 0) makes JAX's factor take alpha = beta = 0 for
    the rows after it and the substitution divide by zero: the port gives
    the same infinities and NaNs."""
    main = np.array([0.0, 2.0, 3.0, 4.0, 0.0, 5.0])
    off1 = np.array([1.0, 0.5, 0.25, 0.5, 1.0])
    off2 = np.array([0.5, 0.25, 0.5, 0.1])
    rhs = np.array([1.0, 2.0, 3.0, 4.0, 5.0, 6.0])
    ref = np.asarray(J._pentadiagonal_solve(*map(jnp.asarray, (main, off1, off2, rhs))))
    got = P._pentadiagonal_solve(*map(_T, (main, off1, off2, rhs))).numpy()
    assert not np.isfinite(ref).all()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_array_equal(got[np.isinf(ref)], ref[np.isinf(ref)])
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-12)


def test_pentadiagonal_float32_within_jax_float32_error():
    bands = _penta(400, 4)
    exact = P._pentadiagonal_solve(*map(_T, bands)).numpy()
    b32 = [b.astype(np.float32) for b in bands]
    ref = np.asarray(J._pentadiagonal_solve(*map(jnp.asarray, b32)))
    got = P._pentadiagonal_solve(*map(_T, b32))
    assert got.dtype == torch.float32
    jax_err = np.abs(ref - exact).max()
    assert np.abs(got.numpy() - exact).max() <= 2 * max(jax_err, 1e-7 * np.abs(exact).max())
