"""Phase-fold parity: periodicity_tpu_torch.ops.fold vs the JAX package's
Pallas fold kernel, run through the Pallas interpreter on CPU as
tests/test_pallas_fold.py runs it, on that file's cases.

On the CPU the port runs the kernel's plain version (``index_add_``); the
CUDA kernel itself is compared with it on the card (test_torch_gpu.py).

Tolerances: count rows (all-ones values) hold integers below 2^24, and
both sides bin by the same float32 formula, so they must be equal exactly.
Value rows are f32 sums taken in another order; they are held at the atol
that test_pallas_fold.py holds the JAX kernel to against its f64 oracle
(5e-5 for unit-scale values, 1e-6 for weights that sum to 1).
"""

import numpy as np
import pytest
import torch

from periodicity_tpu.ops.pallas_bls import fold_bins_onehot as jax_fold_bins
from periodicity_tpu.ops.pallas_bls import fold_onehot as jax_fold
from periodicity_tpu_torch.ops.fold import fold_bins_onehot, fold_onehot, fold_onehot_plain


@pytest.fixture(scope="module")
def sample():
    rng = np.random.default_rng(0)
    n = 700  # not a multiple of the TPU kernel's sample alignment
    t = np.sort(rng.uniform(0, 120.0, n)).astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    return t, x


def _mag_bins(x, n_mag=5):
    return np.clip(((x - x.min()) / (x.max() - x.min() + 1e-12) * n_mag).astype(np.int32),
                   0, n_mag - 1)


def _port(t, values, freqs, **kw):
    off = kw.pop("offsets", None)
    out = fold_onehot_plain(torch.from_numpy(t), torch.from_numpy(values),
                            torch.from_numpy(freqs),
                            offsets=None if off is None else torch.from_numpy(off), **kw)
    assert out.dtype == torch.float32
    return out.numpy()


@pytest.mark.parametrize(
    "case", ["multirow", "offsets", "period_padding", "absolute_epoch"]
)
def test_plain_fold_matches_jax_kernel(sample, case):
    t, x = sample
    kw = {}
    if case == "multirow":
        values = np.stack([np.ones_like(x), x, x * x])
        freqs = (1.0 / np.linspace(0.7, 30.0, 96)).astype(np.float32)
        kw = dict(n_phi=9)
        counts, atol = [0], 5e-5
    elif case == "offsets":
        values = np.ones((1, t.size), np.float32)
        freqs = (1.0 / np.linspace(0.7, 30.0, 64)).astype(np.float32)
        kw = dict(n_phi=10, stride=5, offsets=_mag_bins(x))
        counts, atol = [0], 0.0
    elif case == "period_padding":  # P = 33, not a multiple of the TPU program chunk
        values = np.stack([np.abs(x) / np.sum(np.abs(x))])
        freqs = (1.0 / np.linspace(1.0, 15.0, 33)).astype(np.float32)
        kw = dict(n_phi=16)
        counts, atol = [], 1e-6
    else:  # BJD-epoch times: the epoch comes off in float64 before the cast
        t = t.astype(np.float64) + 2.45e6
        values = np.stack([np.ones_like(x), x])
        freqs = (1.0 / np.linspace(0.7, 30.0, 96)).astype(np.float32)
        kw = dict(n_phi=64)
        counts, atol = [0], 5e-5
    ref = np.asarray(jax_fold(t, values, freqs, interpret=True, **kw))
    got = _port(t, values, freqs, **dict(kw))
    assert got.shape == ref.shape
    for r in counts:
        np.testing.assert_array_equal(got[:, r], ref[:, r])
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)


def test_bls_wrapper_matches_jax(sample):
    t, x = sample
    w = np.full(t.size, 1.0 / t.size, np.float32)
    wyc = (w * (x - np.sum(w * x))).astype(np.float32)
    freqs = (1.0 / np.linspace(1.0, 15.0, 32)).astype(np.float32)
    r_ref, s_ref = jax_fold_bins(t, w, wyc, freqs, nbins=64, interpret=True)
    r, s = fold_bins_onehot(torch.from_numpy(t), torch.from_numpy(w), torch.from_numpy(wyc),
                            torch.from_numpy(freqs), nbins=64)
    assert r.shape == (32, 64) and s.shape == (32, 64)
    np.testing.assert_allclose(r.numpy(), np.asarray(r_ref), rtol=0, atol=1e-6)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=0, atol=1e-6)
    np.testing.assert_allclose(r.numpy().sum(axis=1), 1.0, rtol=1e-5)


def test_cpu_wrapper_is_the_plain_version_in_chunks(sample, monkeypatch):
    """A CPU tensor takes the plain path and launches nothing; the plain
    version's chunking over periods does not change the result."""
    from periodicity_tpu_torch.ops import fold

    t, x = sample
    values = torch.from_numpy(np.stack([np.ones_like(x), x]))
    freqs = torch.from_numpy((1.0 / np.linspace(0.7, 30.0, 50)).astype(np.float32))
    tt = torch.from_numpy(t)
    before = fold_onehot.launches
    whole = fold_onehot(tt, values, freqs, n_phi=12)
    assert fold_onehot.launches == before
    monkeypatch.setattr(fold, "_PLAIN_TRIPLES", 3 * 2 * t.size)  # 3 periods a chunk
    chunked = fold_onehot_plain(tt, values, freqs, n_phi=12)
    np.testing.assert_array_equal(chunked.numpy(), whole.numpy())
    np.testing.assert_array_equal(whole[:, 0].sum(-1).numpy(), np.full(50, t.size))


def _sequential_fold(t, values, periods, n_phi, stride=1, offsets=None):
    """The fold contract in numpy: each sample's float32 bin, then each
    cell summed from +0 in ascending sample order, one float32 addition at
    a time (a loop over the samples, vectorized over periods and rows,
    whose cells a sample touches once each)."""
    t32 = (t - t[0]).astype(np.float32)
    f = (1.0 / periods).astype(np.float32)
    phi = t32[None, :] * f[:, None]
    phi = phi - np.floor(phi)
    pb = np.clip((phi * np.float32(n_phi)).astype(np.int32), 0, n_phi - 1)
    bins = pb.astype(np.int64) * stride + (0 if offsets is None else offsets[None, :])
    p, (nv, n) = periods.shape[0], values.shape
    out = np.zeros((p, nv, n_phi * stride), np.float32)
    rows, cols = np.arange(p)[:, None], np.arange(nv)[None, :]
    for i in range(n):
        cell = (rows, cols, bins[:, i:i + 1])
        out[cell] = out[cell] + values[None, :, i]
    return out


@pytest.mark.parametrize("shape", ["aov", "ce"])
def test_plain_fold_sums_each_cell_in_ascending_sample_order(shape):
    """fold_onehot_plain on the CPU gives a sequential float32 loop's bits
    at the AoV shape (3 rows of 9 bins, ~220 heavy-tailed samples a bin)
    and the conditional-entropy shape (10 x 5 bins through offsets): the
    order the CUDA kernel follows."""
    rng = np.random.default_rng(16)
    n = 2000
    t = np.sort(rng.uniform(0, 1400.0, n))
    x = rng.standard_cauchy(n)
    periods = np.linspace(2.0, 20.0, 40)
    if shape == "aov":
        values = np.stack([np.ones(n), x, x * x]).astype(np.float32)
        kw = dict(n_phi=9)
    else:
        values = rng.standard_normal((1, n)).astype(np.float32)
        kw = dict(n_phi=10, stride=5, offsets=rng.integers(0, 5, n))
    want = _sequential_fold(t, values, periods, **kw)
    off = kw.pop("offsets", None)
    got = fold_onehot_plain(torch.from_numpy(t), torch.from_numpy(values),
                            torch.from_numpy(1.0 / periods), offsets=None if off is None
                            else torch.from_numpy(off), **kw).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
