"""Spreading (extirpolation) parity: periodicity_tpu_torch.ops.grid2 vs the
JAX package's Pallas kernel, run through the Pallas interpreter on CPU as
tests/test_pallas_grid2.py runs it, and vs a float64 np.add.at oracle.

On the CPU the port runs the kernel's plain version (``index_add_``); the
CUDA kernel itself is compared with it on the card (test_torch_gpu.py).
"""

import numpy as np
import pytest
import torch

from periodicity_tpu.ops.pallas_grid2 import extirpolate_grid_factored as jax_grid
from periodicity_tpu_torch.ops.grid2 import (
    extirpolate_grid_factored,
    extirpolate_grid_factored_plain,
)


def _draw(n, nfft, seed=1, taps=4):
    rng = np.random.default_rng(seed)
    ilo = np.sort(rng.integers(0, nfft - 8, n)).astype(np.int32)
    u = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    lag = rng.standard_normal((n, taps)).astype(np.float32)
    return ilo, u, lag


def _add_at_f64(ilo, u, lag, nfft):
    ref = np.zeros(nfft, np.complex128)
    for j in range(lag.shape[1]):
        np.add.at(ref, ilo + j, u.astype(np.complex128) * lag[:, j].astype(np.float64))
    return ref


def _port(ilo, u, lag, nfft, fn=extirpolate_grid_factored_plain):
    gre, gim = fn(
        torch.from_numpy(ilo), torch.from_numpy(u.real.copy()),
        torch.from_numpy(u.imag.copy()), torch.from_numpy(lag), nfft,
    )
    assert gre.dtype == torch.float32 and gre.shape == (nfft,)
    return gre.numpy() + 1j * gim.numpy()


@pytest.mark.parametrize("n,nfft", [(200, 1 << 13), (3000, 1 << 16)])
def test_plain_grid_matches_jax_kernel_and_f64(n, nfft):
    ilo, u, lag = _draw(n, nfft)
    got = _port(ilo, u, lag, nfft)
    gre, gim = jax_grid(ilo, u.real, u.imag, lag, nfft, interpret=True)
    ref_jax = np.asarray(gre) + 1j * np.asarray(gim)
    ref64 = _add_at_f64(ilo, u, lag, nfft)
    scale = max(1.0, np.abs(ref64).max())
    # the TPU kernel's own tolerance (bf16 head+tail split)
    np.testing.assert_allclose(got, ref_jax, rtol=0, atol=5e-5 * scale)
    # f32 summation order only
    np.testing.assert_allclose(got, ref64, rtol=0, atol=1e-6 * scale)


@pytest.mark.parametrize("n,nfft", [(200, 1 << 13), (3000, 1 << 16)])
def test_plain_complex_grid_matches_jax_kernel(n, nfft):
    """``as_complex=True`` gives the complex64 grid the IFFT reads: the
    complex of the planes, held against the complex of JAX's Pallas output
    at the same tolerance as the planes."""
    ilo, u, lag = _draw(n, nfft, seed=2)
    before = extirpolate_grid_factored.launches
    args = (torch.from_numpy(ilo), torch.from_numpy(u.real.copy()),
            torch.from_numpy(u.imag.copy()), torch.from_numpy(lag), nfft)
    got = extirpolate_grid_factored(*args, as_complex=True)
    assert extirpolate_grid_factored.launches == before
    assert got.dtype == torch.complex64 and got.shape == (nfft,)
    gre, gim = extirpolate_grid_factored_plain(*args)
    assert torch.equal(got, torch.complex(gre, gim))
    jre, jim = jax_grid(ilo, u.real, u.imag, lag, nfft, interpret=True)
    ref_jax = np.asarray(jre) + 1j * np.asarray(jim)
    scale = max(1.0, np.abs(_add_at_f64(ilo, u, lag, nfft)).max())
    np.testing.assert_allclose(got.numpy(), ref_jax, rtol=0, atol=5e-5 * scale)


@pytest.mark.parametrize("taps", [4, 8])
def test_cpu_wrapper_is_the_plain_version(taps):
    """A CPU tensor takes the plain path and launches nothing."""
    ilo, u, lag = _draw(500, 1 << 12, seed=3, taps=taps)
    before = extirpolate_grid_factored.launches
    got = _port(ilo, u, lag, 1 << 12, fn=extirpolate_grid_factored)
    np.testing.assert_array_equal(got, _port(ilo, u, lag, 1 << 12))
    assert extirpolate_grid_factored.launches == before


def test_plain_grid_float64_and_clustered():
    """float64 planes stay float64, and a cluster of samples on one cell
    range sums exactly as the oracle does."""
    rng = np.random.default_rng(4)
    nfft = 1 << 10
    ilo = np.sort(np.concatenate([rng.integers(0, nfft - 4, 100),
                                  np.full(400, 37)])).astype(np.int32)
    u = rng.standard_normal(ilo.size) + 1j * rng.standard_normal(ilo.size)
    lag = rng.standard_normal((ilo.size, 4))
    gre, gim = extirpolate_grid_factored_plain(
        torch.from_numpy(ilo), torch.from_numpy(u.real.copy()),
        torch.from_numpy(u.imag.copy()), torch.from_numpy(lag), nfft,
    )
    assert gre.dtype == torch.float64
    ref = _add_at_f64(ilo, u, lag, nfft)
    np.testing.assert_allclose(gre.numpy() + 1j * gim.numpy(), ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())
