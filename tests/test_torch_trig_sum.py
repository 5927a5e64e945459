"""Trig-sum parity: periodicity_tpu_torch.ops.trig_sum vs the JAX package.

The same numpy draws go to both packages. float64 agrees to 1e-10 of the
largest sum; float32 to 5e-5 of it (rounding order of the FFT and of the
scatter). The compensated phase helpers are held in float32 against exact
float64 arithmetic.
"""

import numpy as np
import pytest
import torch

from periodicity_tpu.ops import trig_sum as jts
from periodicity_tpu_torch.ops import trig_sum as pts
from periodicity_tpu_torch.ops.grid2 import extirpolate_grid_factored_plain

TOL = {np.float64: 1e-10, np.float32: 5e-5}


def _series(n=600, baseline=100.0, seed=0, dtype=np.float64, offset=0.0):
    rng = np.random.default_rng(seed)
    t = (offset + np.sort(rng.uniform(0, baseline, n))).astype(dtype)
    w1 = rng.standard_normal(n).astype(dtype)
    w2 = rng.uniform(0.5, 1.5, n).astype(dtype)
    return t, w1, w2


def _close(got, ref, tol):
    got = [np.asarray(g) for g in got]
    ref = [np.asarray(r) for r in ref]
    scale = max(np.abs(r).max() for r in ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype, (g.shape, g.dtype, r.dtype)
        np.testing.assert_allclose(g, r, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("offset", [0.0, 2.45e3])
def test_trig_sum_matches_jax(dtype, offset):
    t, w, _ = _series(dtype=dtype, offset=offset)
    df = 1.0 / (5 * 100.0)
    nf = 2500
    fmin = 0.5 * df
    ref = jts.trig_sum(t, w, df, nf, fmin)
    got = pts.trig_sum(torch.from_numpy(t), torch.from_numpy(w), df, nf, fmin)
    _close([g.numpy() for g in got], ref, TOL[dtype])
    # the f32 2f pipeline shape: doubled grid spacing on a half-size grid
    ref = jts.trig_sum(t, w, 2 * df, nf, 2 * fmin, nfft=pts.grid_size(nf) // 2)
    got = pts.trig_sum(torch.from_numpy(t), torch.from_numpy(w), 2 * df, nf,
                       2 * fmin, nfft=pts.grid_size(nf) // 2)
    _close([g.numpy() for g in got], ref, TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("q", [1, 3])
def test_trig_sum_pair_matches_jax(dtype, q):
    t, w1, w2 = _series(seed=2, dtype=dtype, offset=50.0)
    df = 1.0 / (5 * 100.0)
    nf = 2000
    fmin = 0.5 * q * df
    ref = jts.trig_sum_pair(t, w1, w2, df, nf, fmin, q=q)
    got = pts.trig_sum_pair(torch.from_numpy(t), torch.from_numpy(w1),
                            torch.from_numpy(w2), df, nf, fmin, q=q)
    _close([g.numpy() for g in got], ref, TOL[dtype])


def _planes_trig_sums(t, w1, w2, df, nf, fmin, nfft, q=1):
    """Both pipelines as they ran when the spreading returned (re, im)
    planes, each joined by ``torch.complex`` before the IFFT."""
    dtype, cdtype = t.dtype, pts.complex_dtype(t.dtype)
    tmin = t.min()
    trel = t - tmin
    inds, lag = pts._extirpolate_weights(trel, df, nfft, dtype)
    post = pts._grid_rotation(tmin, df, fmin, nf, dtype, cdtype)
    u = torch.complex(w1, w2) * pts._phase_factor(fmin, trel, dtype, cdtype)
    re, im = extirpolate_grid_factored_plain(inds[:, 0], u.real, u.imag, lag, nfft)
    G = nfft * torch.fft.ifft(torch.complex(re, im))
    back = torch.flip(torch.conj(G[nfft - q - nf + 1: nfft - q + 1]), dims=(0,))
    G1 = 0.5 * (G[:nf] + back) * post
    G2 = -0.5j * (G[:nf] - back) * post
    wc = w1.to(cdtype) * pts._phase_factor(fmin, trel, dtype, cdtype)
    re, im = extirpolate_grid_factored_plain(inds[:, 0], wc.real, wc.imag, lag, nfft)
    g = torch.fft.ifft(torch.complex(re, im))[:nf] * post
    return (G1.imag, G1.real, G2.imag, G2.real), (nfft * g.imag, nfft * g.real)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_complex_grid_leaves_cpu_sums_bit_equal(dtype):
    """The pipelines take the complex grid straight from the spreading; on
    the CPU their sums are bit for bit those of the planes joined by
    ``torch.complex``."""
    t, w1, w2 = (torch.from_numpy(a) for a in _series(seed=9, dtype=dtype, offset=50.0))
    df = float(dtype(1.0 / (5 * 100.0)))
    nf = 2000
    fmin = 0.5 * df
    nfft = pts.grid_size(nf)
    want_pair, want_one = _planes_trig_sums(t, w1, w2, df, nf, fmin, nfft)
    got_pair = pts.trig_sum_pair(t, w1, w2, df, nf, fmin)
    got_one = pts.trig_sum(t, w1, df, nf, fmin)
    for got, want in zip(got_pair + got_one, want_pair + want_one):
        assert got.dtype == want.dtype
        assert torch.equal(got, want)


def test_unsorted_times_scatter_and_gridder_names():
    """The scatter gridder takes any order; 'pallas' is an alias of
    'kernel', which needs CUDA tensors."""
    t, w, _ = _series(seed=5)
    perm = np.random.default_rng(6).permutation(t.size)
    df, nf = 1.0 / 500.0, 1000
    a = pts.trig_sum(torch.from_numpy(t), torch.from_numpy(w), df, nf, df / 2)
    b = pts.trig_sum(torch.from_numpy(t[perm]), torch.from_numpy(w[perm]), df, nf, df / 2)
    _close([x.numpy() for x in b], [x.numpy() for x in a], 1e-12)
    for gridder in ("kernel", "pallas"):
        with pytest.raises(ValueError, match="CUDA"):
            pts.trig_sum(torch.from_numpy(t), torch.from_numpy(w), df, nf, df / 2,
                         gridder=gridder)
    with pytest.raises(ValueError, match="gridder"):
        pts.trig_sum(torch.from_numpy(t), torch.from_numpy(w), df, nf, df / 2,
                     gridder="mxu")


def test_two_prod_is_exact_in_float32():
    rng = np.random.default_rng(7)
    a = (rng.uniform(-1, 1, 4096) * 10.0 ** rng.integers(-3, 7, 4096)).astype(np.float32)
    b = (rng.uniform(-1, 1, 4096) * 10.0 ** rng.integers(-3, 7, 4096)).astype(np.float32)
    p, e = pts._two_prod(torch.from_numpy(a), torch.from_numpy(b))
    exact = a.astype(np.float64) * b.astype(np.float64)  # 48 bits: exact
    np.testing.assert_array_equal(p.numpy().astype(np.float64) + e.numpy(), exact)


def _angle_err(z, ref_cycles):
    ref = np.exp(2j * np.pi * ref_cycles)
    return np.abs(np.angle(z.numpy().astype(np.complex128) * np.conj(ref)))


@pytest.mark.parametrize("tmin", [3.0, 2.0e4])
def test_phase_helpers_float32_vs_exact(tmin):
    """Phase error <= 1e-6 rad with tmin * fmax up to 1e6 cycles."""
    f32, c64 = torch.float32, torch.complex64
    rng = np.random.default_rng(8)
    fmin = np.float32(1e-3)
    df = np.float32(2e-4)
    nf = 250_000  # fmax = 50: tmin * fmax = 1e6 cycles at tmin = 2e4
    tmin32 = np.float32(tmin)
    trel = np.sort(rng.uniform(0, 1000.0, 5000)).astype(np.float32)

    z = pts._phase_factor(float(fmin), torch.from_numpy(trel), f32, c64)
    exact = np.mod(np.float64(fmin) * trel.astype(np.float64), 1.0)
    assert _angle_err(z, exact).max() <= 1e-6

    z = pts._grid_rotation(torch.tensor(tmin32), float(df), float(fmin), nf, f32, c64)
    j = np.arange(nf, dtype=np.float64)
    # tmin*df and tmin*fmin are exact in float64 (48-bit products); the
    # remaining product with j rounds at ~1e-10 cycles
    exact = (np.mod(np.float64(tmin32) * np.float64(fmin), 1.0)
             + np.mod(np.float64(tmin32) * np.float64(df) * j, 1.0))
    assert _angle_err(z, exact).max() <= 1e-6
