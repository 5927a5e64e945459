"""Wavelet parity: periodicity_tpu_torch.ops.wavelet vs the JAX package.

The same numpy draws go to both packages, the JAX side on the CPU in x64,
the port's through its plain PyTorch functions (CPU tensors). Float64 is
the parity dtype.

Tolerances, with their reasons:
- the filter families are host numpy in both packages, the same code:
  bit for bit;
- the CWT, the Hilbert transform and the filter banks are FFTs and short
  dot products whose summation order differs between XLA and PyTorch:
  within 1e-12 of the output's largest value;
- rows of a batch equal the 1-D results bit for bit (the batch axis is
  written out where JAX vmaps).

The JAX side runs under ``jax.jit``, as the JAX package's models call
these functions: eagerly, every operation of a multi-level transform
compiles on its own, and an xdist worker that accumulates too many XLA
executables can crash (pyproject.toml).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from periodicity_tpu.ops import wavelet as J
from periodicity_tpu_torch.ops import wavelet as P

ORTHO = [f"db{n}" for n in range(1, 21)] + [f"sym{n}" for n in range(2, 21)]
BIOR = [f"{k}{nr}.{nd}" for nr, nd in J._BIOR_ORDERS for k in ("bior", "rbio")]


def _T(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(autouse=True, scope="module")
def _release_jax_executables():
    """Free this module's compiled JAX executables when it ends: an xdist
    worker runs many modules in one process."""
    yield
    jax.clear_caches()


def _close(jax_out, port_out, tol=1e-12):
    want = np.asarray(jax_out)
    got = port_out.numpy()
    scale = max(float(np.abs(want).max()), 1e-300)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def test_exports_match_jax():
    assert P.__all__ == J.__all__
    assert len(P.__all__) == 12
    for name in ("_parse_cmor", "scale2frequency", "filter_bank", "_dwt_per_bank",
                 "_idwt_per_bank"):
        assert callable(getattr(P, name))


@pytest.mark.parametrize("family", ORTHO)
def test_scaling_filters_equal_jax_bit_for_bit(family):
    want = np.asarray(J.scaling_filter(family))
    got = P.scaling_filter(family)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    for a, b in zip(P.filter_bank(family), J.filter_bank(family)):
        assert np.array_equal(a, b)


def test_other_filter_families_equal_jax_bit_for_bit():
    """dmey, coif1 and all 30 biorthogonal banks (the coiflet multistart
    takes seconds a family from K = 2 on; the orthonormality of coif1-17
    is JAX's own test, on the same code)."""
    for family in ["dmey", "coif1"] + BIOR:
        for a, b in zip(P.filter_bank(family), J.filter_bank(family)):
            assert np.array_equal(a, b), family


def test_scalars_match_jax():
    for fam in ("cmor2.0-1.0", "cmor1.5-0.8", "morl"):
        assert P.central_frequency(fam) == J.central_frequency(fam)
        assert P.psi_zero(fam) == J.psi_zero(fam)
    np.testing.assert_array_equal(P.scale2frequency("cmor2.0-1.0", [1.0, 4.0]),
                                  J.scale2frequency("cmor2.0-1.0", [1.0, 4.0]))
    for n, taps in [(512, 8), (1001, 2), (3, 20), (257, 62)]:
        assert P.max_dwt_level(n, taps) == J.max_dwt_level(n, taps)
    with pytest.raises(ValueError, match="Unknown"):
        P.scaling_filter("haar7")
    with pytest.raises(ValueError, match="Unknown"):
        P.filter_bank("bior9.9")


@pytest.mark.parametrize("n,family,dt", [(300, "cmor2.0-1.0", 0.5), (257, "cmor1.5-0.8", 1.0)])
def test_cwt_matches_jax(n, family, dt):
    rng = np.random.default_rng(n)
    x = rng.standard_normal(n)
    scales = np.geomspace(2, 60, 9)
    _close(J.cwt_morlet(x, scales, family, dt=dt), P.cwt_morlet(_T(x), scales, family, dt=dt))


def test_cwt_and_hilbert_rows_equal_1d_calls():
    rng = np.random.default_rng(4)
    X = _T(rng.standard_normal((3, 200)))
    scales = np.geomspace(2, 30, 5)
    batch = P.cwt_morlet(X, scales)
    h = P.hilbert(X)
    assert batch.shape == (3, 5, 200) and h.shape == (3, 200)
    for r in range(3):
        assert torch.equal(batch[r], P.cwt_morlet(X[r], scales))
        assert torch.equal(h[r], P.hilbert(X[r]))


@pytest.mark.parametrize("n", [256, 255])
def test_hilbert_matches_jax_and_scipy(n):
    from scipy.signal import hilbert as sp_hilbert

    x = np.random.default_rng(n).standard_normal(n)
    got = P.hilbert(_T(x))
    _close(jax.jit(J.hilbert)(x), got)
    np.testing.assert_allclose(got.numpy(), sp_hilbert(x), rtol=0, atol=1e-12)


@pytest.mark.parametrize("family,n", [("db4", 257), ("sym5", 256), ("coif1", 257),
                                      ("bior2.4", 256), ("rbio3.5", 257), ("dmey", 256)])
def test_wavedec_waverec_match_jax(family, n):
    x = np.random.default_rng(7).standard_normal(n)
    cj = jax.jit(lambda v: J.wavedec(v, family))(x)
    cp = P.wavedec(_T(x), family)
    assert len(cj) == len(cp)
    for a, b in zip(cj, cp):
        _close(a, b)
    _close(jax.jit(lambda c: J.waverec(c, family))(cj), P.waverec(cp, family))


def test_dwt_per_idwt_per_match_jax():
    x = np.random.default_rng(8).standard_normal(129)
    lo = J.scaling_filter("db6")
    (aj, dj), (ap, dp) = jax.jit(lambda v: J.dwt_per(v, lo))(x), P.dwt_per(_T(x), lo)
    _close(aj, ap)
    _close(dj, dp)
    _close(jax.jit(lambda a, d: J.idwt_per(a, d, lo))(aj, dj), P.idwt_per(ap, dp, lo))


def test_filter_bank_rows_equal_1d_calls():
    X = _T(np.random.default_rng(9).standard_normal((4, 256)))
    coefs = P.wavedec(X, "sym4")
    rec = P.waverec(coefs, "sym4")
    for r in range(4):
        for a, b in zip(coefs, P.wavedec(X[r], "sym4")):
            assert torch.equal(a[r], b)
        assert torch.equal(rec[r], P.waverec([c[r] for c in coefs], "sym4"))


@pytest.mark.parametrize("family", ["db1", "db4", "db12", "sym5", "sym8", "coif1", "bior4.4"])
def test_perfect_reconstruction(family):
    rng = np.random.default_rng(2)
    for n in (512, 1001):
        x = rng.standard_normal(n)
        rec = P.waverec(P.wavedec(_T(x), family), family)[:n]
        np.testing.assert_allclose(rec.numpy(), x, atol=1e-10)


@pytest.mark.parametrize("detrend", [False, True])
def test_dwt_denoise_and_soft_threshold_match_jax(detrend):
    rng = np.random.default_rng(3)
    clean = np.sin(2 * np.pi * np.arange(512.0) / 128)
    batch = clean[None, :] + 0.3 * rng.standard_normal((3, 512))
    thr = 0.3 * float(np.sqrt(2 * np.log(512)))
    many = P.dwt_denoise(_T(batch), thr, detrend=detrend)
    for r in range(3):
        _close(J.dwt_denoise(jnp.asarray(batch[r]), thr, detrend=detrend), many[r])
    _close(jax.jit(lambda v: J.soft_threshold(v, 0.5))(batch), P.soft_threshold(_T(batch), 0.5))
    if not detrend:
        err_before = np.std(batch - clean[None], axis=1)
        err_after = np.std(many.numpy() - clean[None], axis=1)
        assert (err_after < 0.8 * err_before).all()


def test_soft_threshold_widens_like_jax():
    """A float64 threshold array widens float32 coefficients in JAX (numpy
    promotion); a Python number keeps them float32."""
    x = np.linspace(-1, 1, 9, dtype=np.float32)
    got = P.soft_threshold(_T(x), torch.tensor(0.25, dtype=torch.float64))
    want = J.soft_threshold(jnp.asarray(x), jnp.asarray(0.25, jnp.float64))
    assert got.dtype == torch.float64 and np.asarray(want).dtype == np.float64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert P.soft_threshold(_T(x), 0.25).dtype == torch.float32


def test_numpy_input_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: numpy input lands on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.cwt_morlet(np.ones(16), [1.0, 2.0])
    assert P.hilbert(np.ones(16), device="cpu").device.type == "cpu"
