"""The CUDA spreading kernel and the GLS path on the card.

Marked ``gpu``: each test asks the ``cuda`` fixture for the device and
skips where there is none. Run on a GPU machine without the repo's
conftest (it imports JAX, which the port does not need):

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from periodicity_tpu_torch import TSeries
from periodicity_tpu_torch.ops.grid2 import (
    extirpolate_grid_factored,
    extirpolate_grid_factored_plain,
)
from periodicity_tpu_torch.spectral import GLS, default_frequency_grid, gls_power

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _draw(n, nfft, seed, taps=4, cluster=None):
    rng = np.random.default_rng(seed)
    ilo = rng.integers(0, nfft - taps, n)
    if cluster is not None:
        ilo[: n // 2] = cluster + rng.integers(0, 64, n // 2)
    ilo = np.sort(ilo).astype(np.int32)
    return (ilo, rng.standard_normal(n).astype(np.float32),
            rng.standard_normal(n).astype(np.float32),
            rng.standard_normal((n, taps)).astype(np.float32))


def _on(device, arrays):
    return [torch.from_numpy(a).to(device) for a in arrays]


@pytest.mark.parametrize(
    "n,nfft,taps,cluster",
    [
        (200, 1 << 13, 4, None),
        (3000, 1 << 16, 4, None),
        (3000, 1 << 9, 4, None),  # grid smaller than one block's tile
        (100_000, 1 << 22, 4, None),
        (20_000, 1 << 16, 4, 4000),  # many chunks of samples in one tile
        (5000, 1 << 14, 8, None),
        (0, 1 << 12, 4, None),
    ],
)
def test_kernel_matches_plain(cuda, n, nfft, taps, cluster):
    ilo, ure, uim, lag = _on(cuda, _draw(n, nfft, seed=n + nfft, taps=taps, cluster=cluster))
    before = extirpolate_grid_factored.launches
    kre, kim = extirpolate_grid_factored(ilo, ure, uim, lag, nfft)
    assert extirpolate_grid_factored.launches == before + 1
    dre, dim = extirpolate_grid_factored_plain(ilo, ure.double(), uim.double(), lag.double(), nfft)
    torch.cuda.synchronize()
    scale = max(1.0, float(dre.abs().max()), float(dim.abs().max()))
    assert kre.dtype == torch.float32 and kre.shape == (nfft,)
    assert float((kre.double() - dre).abs().max()) <= 1e-6 * scale
    assert float((kim.double() - dim).abs().max()) <= 1e-6 * scale
    # deterministic: the same inputs give the same bits
    kre2, kim2 = extirpolate_grid_factored(ilo, ure, uim, lag, nfft)
    assert torch.equal(kre, kre2) and torch.equal(kim, kim2)


def test_kernel_rejects_what_it_does_not_take(cuda):
    ilo, ure, uim, lag = _on(cuda, _draw(100, 1 << 12, seed=0))
    with pytest.raises(TypeError):
        extirpolate_grid_factored(ilo.long(), ure, uim, lag, 1 << 12)
    with pytest.raises(TypeError):
        extirpolate_grid_factored(ilo, ure.double(), uim, lag, 1 << 12)
    with pytest.raises(ValueError):
        extirpolate_grid_factored(ilo, ure, uim, lag.t(), 1 << 12)
    with pytest.raises(ValueError):
        extirpolate_grid_factored(ilo, ure, uim, lag, 3000)
    with pytest.raises(ValueError):
        extirpolate_grid_factored(ilo, ure.cpu(), uim, lag, 1 << 12)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_gls_on_card_matches_cpu(cuda, dtype):
    """The slice on the card agrees with the port's CPU run, and float32
    spreads through the kernel (two launches per periodogram)."""
    rng = np.random.default_rng(0)
    t = np.sort(rng.uniform(0, 100, 2000)).astype(dtype)
    y = (np.sin(2 * np.pi * t / 7.7) + 0.3 * rng.standard_normal(2000)).astype(dtype)
    ref = GLS()(TSeries(t, y))
    g = GLS()
    before = extirpolate_grid_factored.launches
    got = g(TSeries(torch.from_numpy(t).to(cuda), torch.from_numpy(y).to(cuda)))
    best = float(got.period_at_highest_peak)
    assert g._gridder_resolved == "kernel"
    assert extirpolate_grid_factored.launches - before == (2 if dtype == np.float32 else 0)
    tol = 5e-5 if dtype == np.float32 else 1e-9
    np.testing.assert_allclose(got.values.cpu().numpy(), ref.values.numpy(), rtol=0,
                               atol=tol * float(ref.values.max()))
    assert best == pytest.approx(float(ref.period_at_highest_peak), rel=1e-6)


def test_gls_direct_on_card_matches_cpu_and_oracle(cuda):
    """The exact direct method on the card agrees with the CPU run, and
    with the fast path at 12 taps on a doubled grid."""
    rng = np.random.default_rng(1)
    t = np.sort(rng.uniform(0, 100, 1000))
    y = np.sin(2 * np.pi * t / 7.7) + 0.3 * rng.standard_normal(1000)
    ts = TSeries(torch.from_numpy(t).to(cuda), torch.from_numpy(y).to(cuda))
    _, df, fmin = default_frequency_grid(ts)
    err = torch.ones_like(ts.values)
    direct = gls_power(ts.time, ts.values, err, df, fmin, 2000, method="direct")
    cpu = gls_power(ts.time.cpu(), ts.values.cpu(), err.cpu(), df, fmin, 2000, method="direct")
    oracle = gls_power(ts.time, ts.values, err, df, fmin, 2000, pair_q=1, taps=12,
                       nfft=1 << 15)
    peak = float(cpu.max())
    assert float((direct.cpu() - cpu).abs().max()) <= 1e-9 * peak
    assert float((oracle - direct).abs().max()) <= 1e-8 * peak
