"""Filter parity: periodicity_tpu_torch.ops.filters vs the JAX package.

The same numpy draws go to both packages, the JAX side on the CPU in x64.

Tolerances, with their reasons:
- convolutions and the Gaussian filter in float64: 1e-12 of the largest
  input magnitude (sums in another order; the JAX package's own tests hold
  its filters at rtol 1e-10 against scipy);
- the kernels and the Butterworth design (host numpy in both packages):
  equal;
- the recursion's plain version against JAX's ``lax.scan`` in float64:
  1e-12 of the output's largest magnitude (the same operations in the
  same order); in float32, within twice JAX's own float32 error of the
  float64 recursion (XLA contracts multiply-adds into FMAs on the CPU, the
  port does not, and a band-pass with poles near the unit circle
  amplifies the one-ulp differences);
- ``sosfiltfilt``: 1e-10 relative in float64, and equal in float32 input,
  where both packages filter in float64 by the same arithmetic and cast
  back.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from periodicity_tpu.ops import filters as J
from periodicity_tpu_torch.ops import filters as P

MODES = ["reflect", "mirror", "nearest", "constant", "wrap"]


def _T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _draw(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n,w", [(200, 7), (5, 13), (1, 3), (9, 41)])
def test_convolve1d_matches_jax(mode, n, w):
    """Every boundary mode, with kernels narrower and wider than the series
    (a reflection as wide as the input or wider, which F.pad refuses and
    jnp.pad reflects again)."""
    x = _draw(n, 1)
    k = np.random.default_rng(2).uniform(0, 1, w)
    ref = np.asarray(J.convolve1d(x, k, mode=mode, cval=0.5))
    got = P.convolve1d(_T(x), _T(k), mode=mode, cval=0.5).numpy()
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12 * np.abs(x).max() * k.sum())


def test_convolve1d_rows_and_float32_promotion():
    """Leading axes are independent rows; a float32 series with a float64
    kernel gives float64, as jnp.convolve does."""
    x = np.random.default_rng(3).standard_normal((4, 50))
    k = P.boxcar_kernel1d(5).numpy()
    rows = P.convolve1d(_T(x), _T(k))
    for i in range(4):
        assert torch.equal(rows[i], P.convolve1d(_T(x[i]), _T(k)))
    x32 = x[0].astype(np.float32)
    ref = np.asarray(J.convolve1d(x32, k))
    got = P.convolve1d(_T(x32), _T(k)).numpy()
    assert got.dtype == ref.dtype == np.float64
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", MODES)
def test_convolve2d_matches_jax(mode):
    x = np.random.default_rng(4).standard_normal((9, 12))
    k = np.random.default_rng(5).uniform(0, 1, (3, 5))
    ref = np.asarray(J.convolve2d(x, k, mode=mode, cval=-1.0))
    got = P.convolve2d(_T(x), _T(k), mode=mode, cval=-1.0).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12 * 15)


@pytest.mark.parametrize("shape,sigma", [((300,), 3.0), ((20, 30), 1.5), ((4,), 2.0)])
def test_gaussian_filter_matches_jax(shape, sigma):
    x = np.random.default_rng(6).standard_normal(shape)
    ref = np.asarray(J.gaussian_filter(x, sigma))
    got = P.gaussian_filter(_T(x), sigma).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12 * np.abs(x).max())


@pytest.mark.parametrize("width", [3, 4, 7, 10])
def test_kernels_equal_jax(width):
    for pk, jk in ((P.boxcar_kernel1d, J.boxcar_kernel1d),
                   (P.triangle_kernel1d, J.triangle_kernel1d)):
        np.testing.assert_array_equal(pk(width).numpy(), np.asarray(jk(width)))
        assert pk(width, dtype=torch.float32).dtype == torch.float32
    np.testing.assert_array_equal(P.gaussian_kernel1d(width / 2).numpy(),
                                  np.asarray(J.gaussian_kernel1d(width / 2)))


@pytest.mark.parametrize("order,wn,btype", [
    (5, [0.05, 0.3], "bandpass"), (4, 0.2, "lowpass"), (3, 0.2, "lowpass"),
    (5, 0.1, "highpass"), (2, [0.01, 0.9], "bandpass"),
])
def test_butterworth_design_equals_jax(order, wn, btype):
    sos = P.butter_sos(order, wn, btype)
    np.testing.assert_array_equal(sos, J.butter_sos(order, wn, btype))
    np.testing.assert_array_equal(P.sosfilt_zi(sos), J.sosfilt_zi(sos))


def test_butterworth_design_rejects_bad_bands():
    for wn in (0.0, 1.0, [0.3, 0.2]):
        with pytest.raises(ValueError):
            P.butter_sos(4, wn, "bandpass" if isinstance(wn, list) else "lowpass")


def test_sosfilt_plain_matches_jax_scan():
    """The plain recursion against JAX's lax.scan in float64, output and
    final state, from a given initial state."""
    sos = J.butter_sos(5, [0.05, 0.3], "bandpass")
    x = _draw(300, 7)
    zi = P.sosfilt_zi(sos) * x[0]
    ref_y, ref_z = J.sosfilt(sos, jnp.asarray(x), jnp.asarray(zi))
    y, z = P.sosfilt(sos, _T(x), _T(zi))
    assert y.dtype == z.dtype == torch.float64
    scale = np.abs(np.asarray(ref_y)).max()
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), rtol=0, atol=1e-12 * scale)
    np.testing.assert_allclose(z.numpy(), np.asarray(ref_z), rtol=0, atol=1e-12 * scale)
    assert P.sosfilt.launches == 0  # CPU tensors never launch the kernel


def test_sosfilt_float32_within_jax_float32_error():
    """In float32, XLA on the CPU contracts ``b0 * v + z0`` and
    ``b1 * v - a1 * y`` into FMAs, while the port rounds every operation on
    its own (as its kernel does, bit for bit). Neither is the float64
    answer: the port must stay within twice JAX's own float32 error of the
    float64 recursion (each is ~4e-5 of the output's scale here)."""
    sos = J.butter_sos(5, [0.05, 0.3], "bandpass")
    x = _draw(300, 7)
    zi = P.sosfilt_zi(sos) * x[0]
    exact = P.sosfilt(sos, _T(x), _T(zi))[0].numpy()
    x32, zi32 = x.astype(np.float32), zi.astype(np.float32)
    ref = np.asarray(J.sosfilt(sos, jnp.asarray(x32), jnp.asarray(zi32))[0])
    got = P.sosfilt(sos, _T(x32), _T(zi32))[0]
    assert got.dtype == torch.float32
    jax_err = np.abs(ref - exact).max()
    assert 0 < np.abs(got.numpy() - exact).max() <= 2 * jax_err


def test_sosfilt_rows_are_independent():
    sos = J.butter_sos(3, 0.2, "lowpass")
    x = np.random.default_rng(8).standard_normal((3, 40))
    y, zf = P.sosfilt(sos, _T(x))
    assert zf.shape == (3, sos.shape[0], 2)
    for i in range(3):
        yi, zi = P.sosfilt(sos, _T(x[i]))
        assert torch.equal(y[i], yi) and torch.equal(zf[i], zi)
    np.testing.assert_array_equal(P.sosfilt_plain(sos, _T(x))[0].numpy(), y.numpy())


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_sosfiltfilt_matches_jax(dtype):
    """Both packages run the recursion in float64 and cast float32 input
    back, so float32 is equal."""
    sos = J.butter_sos(5, [0.05, 0.3], "bandpass")
    x = _draw(400, 9).astype(dtype)
    ref = np.asarray(J.sosfiltfilt(sos, jnp.asarray(x)))
    got = P.sosfiltfilt(sos, _T(x)).numpy()
    assert got.dtype == ref.dtype == dtype
    if dtype == np.float32:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-12)
    with pytest.raises(ValueError, match="padlen"):
        P.sosfiltfilt(sos, _T(x[:30]))
