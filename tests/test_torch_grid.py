"""Unfactored spreading parity: periodicity_tpu_torch.ops.grid vs the JAX
package's first Pallas spreading kernel, run through the Pallas
interpreter on CPU on tests/test_pallas_grid.py's four cases and at its
atol (2e-5 of the grid's scale: both sides sum f32 values in another
order).

On the CPU the port runs the kernel's plain version (``index_add_``); the
CUDA kernel itself is compared with it on the card (test_torch_gpu.py).
"""

import numpy as np
import pytest
import torch

from periodicity_tpu.ops.pallas_grid import extirpolate_grid as jax_grid
from periodicity_tpu_torch.ops.grid import extirpolate_grid, extirpolate_grid_plain


def _draw(n, lo, hi, seed=0):
    rng = np.random.default_rng(seed)
    ilo = np.sort(rng.integers(lo, hi, n)).astype(np.int32)
    vals = (rng.standard_normal((n, 4)) + 1j * rng.standard_normal((n, 4))).astype(np.complex64)
    return ilo, vals


@pytest.mark.parametrize(
    "n,nfft,lo,hi",
    [
        (50, 2048, 0, 2044),
        (5000, 1 << 16, 0, (1 << 16) - 4),
        (5000, 1 << 16, 1000, 1200),  # heavily clustered in one tile
        (3000, 1 << 14, (1 << 14) - 300, (1 << 14) - 4),  # clustered at the end
    ],
)
def test_plain_grid_matches_jax_kernel(n, nfft, lo, hi):
    ilo, vals = _draw(n, lo, hi)
    ref = np.asarray(jax_grid(ilo, vals, nfft, interpret=True))
    before = extirpolate_grid.launches
    got = extirpolate_grid(torch.from_numpy(ilo), torch.from_numpy(vals), nfft)
    assert extirpolate_grid.launches == before  # a CPU tensor launches nothing
    assert got.dtype == torch.complex64 and got.shape == (nfft,)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2e-5 * max(1.0, np.abs(ref).max()))


def test_plain_grid_planes_and_float64():
    """``as_complex=False`` gives the (re, im) planes; complex128 values
    spread in float64, as the exact oracle ``np.add.at`` does."""
    ilo, vals = _draw(400, 0, 1020, seed=2)
    vals64 = vals.astype(np.complex128) * (1 + 1e-9j)
    re, im = extirpolate_grid_plain(torch.from_numpy(ilo), torch.from_numpy(vals64), 1024,
                                    as_complex=False)
    assert re.dtype == torch.float64
    ref = np.zeros(1024, np.complex128)
    for j in range(4):
        np.add.at(ref, ilo + j, vals64[:, j])
    np.testing.assert_allclose(re.numpy() + 1j * im.numpy(), ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())
