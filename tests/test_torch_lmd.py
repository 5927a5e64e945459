"""LMD parity: periodicity_tpu_torch.ops.lmd vs the JAX package and the
eager container-op oracle of ``tests/test_lmd.py``.

The oracle reproduces the reference's LMD sift (reference
decomposition.py:127-183) with the JAX package's container ops
(find_peaks/join/pad/fill_gaps/smooth/interp). Tolerances are the JAX
test's: the sift at 1e-10 against the oracle (one of its two candidates:
the smoothing stop rule tests exact zeros, so another summation order may
run one more pass), the demodulated product function at 1e-9. Against the
JAX kernels themselves the helpers agree bit for bit and the sift and the
first product function within 1e-12.

Past the first product function the two packages part (ROADMAP.md C4):
the triangle smoothing's weighted sums round in another order in XLA
(Eigen's matrix-vector product) than in PyTorch, a 1-ulp difference can
flip the exact-zero stop rule or an extremum at the next demodulation
step, and where the demodulation does not converge in ``max_iter`` steps
the difference grows to O(1). So the estimator is held to the first
product function, the reconstruction and the JAX test's behaviour.
"""

import numpy as np
import pytest
import torch

from periodicity_tpu.core import TSeries as JTSeries
from periodicity_tpu.models.decomposition import LMD as JLMD
from periodicity_tpu.ops import lmd as J
from periodicity_tpu_torch.core import TSeries
from periodicity_tpu_torch.models.decomposition import LMD
from periodicity_tpu_torch.ops import lmd as P


def _T(a):
    return torch.from_numpy(np.array(a))


def eager_sift(sig, pad_width=0, smooth_iter=12):
    """Reference-semantics LMD sift via the JAX package's eager container
    ops (``tests/test_lmd.py``); both candidates of the stop rule."""
    peaks = sig.find_peaks(include_edges=True)
    dips = sig.find_dips()
    extrema = peaks.join(dips)
    if extrema.size < (2 + pad_width):
        raise ValueError("not enough extrema")
    if pad_width > 0:
        extrema = extrema.pad(pad_width, mode="reflect", reflect_type="odd").drop(
            [pad_width, -pad_width - 1])
    if extrema.size < 3:
        raise ValueError("not enough extrema")
    out = []
    for series in (0.5 * (extrema.roll(1) + extrema), 0.5 * abs(extrema.roll(1) - extrema)):
        filled = series.fill_gaps(dt=float(sig.dt), method="bfill")
        filled = JTSeries(filled.time, filled.values.at[0].set(filled.values[1]),
                          assume_sorted=True)
        window = float(np.max(np.diff(np.asarray(extrema.time))) / float(sig.dt)) // 3
        window = int(max(3, window + (1 - window % 2)))
        candidates = []
        for it in range(smooth_iter):
            filled = filled.smooth(window, kernel="triangle")
            stop = bool(np.all(np.diff(np.asarray(filled.values))))
            if stop or it == smooth_iter - 1:
                candidates.append(filled.interp(sig.time))
                if stop and it < smooth_iter - 1:
                    candidates.append(filled.smooth(window, kernel="triangle").interp(sig.time))
                break
        out.append(candidates)
    return out[0], out[1]


def _matches_one_of(values, candidates, atol):
    errs = [float(np.max(np.abs(values.numpy() - np.asarray(c.values)))) for c in candidates]
    assert min(errs) < atol, f"no candidate matched: errors {errs}"


def two_tone():
    t = np.arange(1000.0)
    return t, np.sin(2 * np.pi * 0.01 * t) + 0.4 * np.sin(2 * np.pi * 0.1 * t)


def noisy():
    rng = np.random.default_rng(0)
    t = 0.25 * np.arange(512) + 3.0
    return t, np.sin(2 * np.pi * 0.05 * np.arange(512)) + 0.3 * rng.standard_normal(512)


@pytest.mark.parametrize("make", [two_tone, noisy])
@pytest.mark.parametrize("pad_width", [0, 2])
def test_sift_matches_eager_oracle_and_jax(make, pad_width):
    t, x = make()
    mu_c, env_c = eager_sift(JTSeries(t, x), pad_width=pad_width)
    mu, env, ok = P.lmd_sift(_T(t), _T(x), pad_width=pad_width)
    assert bool(ok)
    _matches_one_of(mu, mu_c, 1e-10)
    _matches_one_of(env, env_c, 1e-10)
    jmu, jenv, jok = J.lmd_sift(t, x, pad_width=pad_width)
    assert bool(jok)
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), rtol=0, atol=1e-12)
    np.testing.assert_allclose(env.numpy(), np.asarray(jenv), rtol=0, atol=1e-12)


@pytest.mark.parametrize("pad_width", [0, 1, 3])
def test_helpers_equal_jax(pad_width):
    _, x = noisy()
    idx, m = P._extrema_indices(_T(x))
    jidx, jm = J._extrema_indices(x)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert int(m) == int(jm)
    if pad_width:
        q, v, count = P._pad_reflect_drop_odd(idx, _T(x), m, pad_width)
        jq, jv, jcount = J._pad_reflect_drop_odd(jidx, x, jm, pad_width)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        assert int(count) == int(jcount)
        vals = np.cos(np.asarray(jq, float))
        dense, md = P._zoh_dense(q, _T(vals), count, 3 * x.size)
        jdense, jmd = J._zoh_dense(jq, vals, jcount, 3 * x.size)
        np.testing.assert_array_equal(dense.numpy(), np.asarray(jdense))
        assert int(md) == int(jmd)


def test_sift_monotonic_parity():
    t, x = np.arange(50.0), np.linspace(0.0, 1.0, 50)
    with pytest.raises(ValueError):
        eager_sift(JTSeries(t, x))
    assert not bool(P.lmd_sift(_T(t), _T(x))[2])
    assert not bool(J.lmd_sift(t, x)[2])
    with pytest.raises(ValueError):
        LMD().sift(TSeries(t, x, device="cpu"))


def test_iter_matches_eager_demodulation_and_jax():
    t, x = two_tone()
    sig = JTSeries(t, x)
    F = sig.copy()
    A = JTSeries(t, np.ones(sig.size), assume_sorted=True)
    for _ in range(10):
        mu_c, env_c = eager_sift(F)
        F = (F - mu_c[0]) / env_c[0]
        A = A * env_c[0]
        if float(np.max(np.abs(np.asarray(F.values)))) - 1.0 < 1e-6:
            break
    A_p, F_p, mono = P.lmd_iter(_T(t), _T(x))
    assert not mono
    np.testing.assert_allclose(A_p.numpy(), np.asarray(A.values), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(F_p.numpy(), np.clip(np.asarray(F.values), -1.0, 1.0), atol=1e-9)
    A_j, F_j, mono_j = J.lmd_iter(t, x)
    assert not bool(mono_j)
    np.testing.assert_allclose(A_p.numpy(), np.asarray(A_j), rtol=0, atol=1e-12)
    np.testing.assert_allclose(F_p.numpy(), np.asarray(F_j), rtol=0, atol=1e-12)


def test_lmd_estimator_matches_jax_first_pf_and_reconstructs():
    t, x = two_tone()
    lmd = LMD()
    pfs = lmd(TSeries(t, x, device="cpu"))
    jpfs = JLMD()(JTSeries(t, x))
    assert len(pfs) >= 1 and len(jpfs) >= 1
    A, F = pfs[0]
    jA, jF = jpfs[0]
    np.testing.assert_allclose((A * F).values.numpy(), np.asarray((jA * jF).values), rtol=0,
                               atol=1e-9)
    assert float(F.values.abs().max()) <= 1.0 + 1e-9
    fast = 0.4 * np.sin(2 * np.pi * 0.1 * t)
    sl = slice(100, -100)
    corr = np.corrcoef((A * F).values.numpy()[sl], fast[sl])[0, 1]
    assert abs(corr) > 0.99
    recon = sum(a * f for a, f in pfs) + lmd.residue
    np.testing.assert_allclose(recon.values.numpy(), x, atol=1e-8)
    assert lmd.n_modes == len(pfs)


def test_lmd_host_reads_counted():
    t, x = two_tone()
    before = P.host_reads
    P.lmd_iter(_T(t), _T(x))
    assert P.host_reads > before
