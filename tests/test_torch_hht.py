"""Hilbert-Huang parity: periodicity_tpu_torch.ops.hht vs the JAX package.

The same numpy draws go to both packages, the JAX side on the CPU in x64,
the port's through its plain PyTorch versions (CPU tensors). Float64 is
the parity dtype.

Tolerances, with their reasons:
- gradients and the Teager operator: within 1e-12 of the largest value
  (the same formula; XLA may contract a multiply-add on the CPU);
- the AM/FM normalization (spline and Hilbert envelopes): A and F within
  1e-9 of max |x|, as for EMD's sifts (FFT and spline sums round in
  another order);
- rows of a batch equal the 1-D results bit for bit;
- frequencies and spectrograms sample by sample within 1e-9 of their
  largest value, except where a sample hangs on a discrete decision (DQ's
  clip of F at +-1, the sign of the phase gradient, the unwrap's |dd| <
  pi, the spectrogram's bin): an ulp can flip such a decision, so there a
  difference is accepted only if the deciding quantity lies within 1e-12
  (relative) of its threshold in both packages, and the test reports how
  many samples that was;
- LMD's normalization: its first pass against JAX; past it the smoothing's
  stop rule can part the packages (ROADMAP.md C4), so the full loop is
  held bit for bit against the port's own one-row ``lmd_sift``
  composition instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from periodicity_tpu.ops import hht as J
from periodicity_tpu.ops import lmd as JL
from periodicity_tpu_torch.ops import hht as P
from periodicity_tpu_torch.ops import lmd as PL

DECISION_TOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _release_jax_executables():
    """Free this module's compiled JAX executables when it ends: an xdist
    worker runs many modules in one process, and one that accumulates too
    many XLA executables can crash (pyproject.toml)."""
    yield
    jax.clear_caches()


def _T(a):
    return torch.from_numpy(np.array(a))


def _close(jax_out, port_out, scale, tol=1e-9):
    np.testing.assert_allclose(port_out.numpy(), np.asarray(jax_out), rtol=0, atol=tol * scale)


@pytest.fixture(scope="module")
def am_rows():
    """AM-FM rows on a uniform grid (N = 256) that finish the spline
    normalization at different passes."""
    rng = np.random.default_rng(11)
    t = np.arange(0, 64, 0.25)
    env = 1 + 0.4 * np.sin(2 * np.pi * t / 30)
    X = np.stack([
        env * np.sin(2 * np.pi * 0.5 * t),
        np.sin(2 * np.pi * 0.13 * t) * (1 + 0.5 * np.cos(t / 9)),
        (1 + 0.3 * np.sin(t / 7)) * np.sin(2 * np.pi * 0.3 * t + 0.2 * t**1.2 / 8)
        + 0.01 * rng.standard_normal(t.size),
    ])
    return t, X


def _dq_near(F):
    """Samples of a DQ frequency that hang on a decision within
    DECISION_TOL of its threshold: F at +-1 (the clip), the index gradient
    of the phase at 0 (its sign), |dd| at pi (the unwrap). A decision at
    sample j moves the frequency at j-2..j+2."""
    q = 1.0 - F * F
    near = np.abs(q) <= DECISION_TOL
    phi = np.arctan2(np.sqrt(np.clip(q, 0.0, None)), F)
    g = np.gradient(phi)
    near |= np.abs(g) <= DECISION_TOL * np.maximum(np.abs(phi), 1.0)
    dd = np.diff(phi * np.sign(g))
    near[1:] |= np.abs(np.abs(dd) - np.pi) <= DECISION_TOL * np.pi
    return np.convolve(near, np.ones(5), "same") > 0


def _angle_near(phase):
    """Samples of an unwrapped-phase frequency whose |dd| lies at pi."""
    near = np.zeros(phase.shape, bool)
    near[1:] = np.abs(np.abs(np.diff(phase)) - np.pi) <= DECISION_TOL * np.pi
    return np.convolve(near, np.ones(5), "same") > 0


def held_sample_by_sample(got, want, near_got, near_want, what, tol=1e-9):
    """got vs want within tol of want's largest finite value, except at
    samples near a decision in both packages; returns how many samples
    differed there."""
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.nanmax(np.abs(np.where(np.isfinite(want), want, np.nan)))), 1e-300)
    same = np.isclose(got, want, rtol=0, atol=tol * scale) | (np.isnan(got) & np.isnan(want))
    decided = ~same & near_got & near_want
    unexplained = ~same & ~decided
    assert not unexplained.any(), (
        f"{what}: {int(unexplained.sum())} samples differ away from any decision "
        f"(first at {np.flatnonzero(unexplained)[:5]}); {int(decided.sum())} parted at a "
        "decision within 1e-12 of its threshold in both packages")
    return int(decided.sum())


def test_exports_match_jax():
    assert P.__all__ == J.__all__
    assert len(P.__all__) == 7


def test_gradient_and_teager_match_jax_and_numpy():
    rng = np.random.default_rng(0)
    y = rng.standard_normal(257)
    t = np.sort(rng.uniform(0, 10, 257))
    np.testing.assert_allclose(P.gradient(_T(y)).numpy(), np.gradient(y), rtol=1e-12)
    np.testing.assert_allclose(P.gradient(_T(y), _T(t)).numpy(), np.gradient(y, t), rtol=1e-9,
                               atol=1e-9)
    g = P.gradient(_T(y), _T(t))
    _close(J.gradient(y, t), g, float(np.abs(g.numpy()).max()), tol=1e-12)
    tg = P.teager(_T(y), _T(t))
    _close(J.teager(y, t), tg, float(np.abs(tg.numpy()).max()), tol=1e-12)
    Y = _T(rng.standard_normal((3, 257)))
    for r in range(3):
        assert torch.equal(P.gradient(Y, _T(t))[r], P.gradient(Y[r], _T(t)))
        assert torch.equal(P.teager(Y, _T(t))[r], P.teager(Y[r], _T(t)))


@pytest.mark.parametrize("norm_type", ["spline", "hilbert"])
def test_am_fm_normalize_matches_jax(am_rows, norm_type):
    t, X = am_rows
    A, F = P.am_fm_normalize(_T(t), _T(X), norm_type=norm_type)
    assert A.shape == F.shape == X.shape
    for r in range(X.shape[0]):
        Aj, Fj = J.am_fm_normalize(jnp.asarray(t), jnp.asarray(X[r]), norm_type=norm_type)
        scale = float(np.abs(X[r]).max())
        _close(Aj, A[r], scale)
        _close(Fj, F[r], scale)


def test_am_fm_normalize_rows_keep_their_own_trajectory(am_rows):
    """Rows that finish at different passes: each batch row equals the row
    alone, bit for bit (a finished row keeps its F and A, as JAX's vmapped
    while_loop keeps them)."""
    t, X = am_rows
    tt = _T(t)
    A, F, passes = P.am_fm_normalize_plain(tt, _T(X))
    assert len(set(passes.tolist())) > 1, passes
    for r in range(X.shape[0]):
        a, f, p = P.am_fm_normalize_plain(tt, _T(X[r : r + 1]))
        assert torch.equal(A[r], a[0]) and torch.equal(F[r], f[0]) and p[0] == passes[r]
    A3, F3 = P.am_fm_normalize(tt, _T(np.stack([X, X[::-1].copy()])))
    assert torch.equal(A3[0], A) and torch.equal(F3[0], F)
    assert P.am_fm_normalize(tt, _T(X), n_iter=0)[0].eq(1).all()


@pytest.mark.parametrize("norm_type", ["hilbert", "spline"])
def test_am_fm_normalize_unit_amplitude(norm_type):
    t = np.arange(0, 200, 0.1)
    envelope = 1.0 + 0.3 * np.sin(2 * np.pi * t / 80)
    x = envelope * np.sin(2 * np.pi * 0.5 * t)
    A, F = P.am_fm_normalize(_T(t), _T(x), norm_type=norm_type)
    core = slice(100, -100)
    assert float(F.abs().max()) <= 1.0 + 1e-9
    rel = A.numpy()[core] / envelope[core]
    assert np.median(np.abs(rel - 1)) < 0.05


def _lmd_draw():
    """A uniformly sampled AM tone with a little noise (N = 400)."""
    rng = np.random.default_rng(1)
    t = np.arange(400.0)
    x = (1 + 0.3 * np.sin(2 * np.pi * t / 160)) * np.sin(2 * np.pi * t / 8)
    return t, x + 1e-3 * rng.standard_normal(400)


def test_lmd_normalization_first_pass_matches_jax():
    t, x = _lmd_draw()
    A, F = P.am_fm_normalize(_T(t), _T(x), norm_type="lmd", n_iter=1)
    Aj, Fj = J.am_fm_normalize(jnp.asarray(t), jnp.asarray(x), norm_type="lmd", n_iter=1)
    scale = float(np.abs(x).max())
    _close(Aj, A, scale)
    _close(Fj, F, scale)


def test_lmd_normalization_is_the_one_row_sift_composition():
    """The full loop (10 passes, pad_width 2) bit for bit against the
    port's own one-row lmd_sift demodulation, row by row; one host read a
    pass besides the sift's."""
    t, x = _lmd_draw()
    X = np.stack([x, x[::-1].copy()])
    reads = PL.host_reads
    A, F = P.am_fm_normalize(_T(t), _T(X), norm_type="lmd")
    assert PL.host_reads > reads
    for r in range(2):
        f, a = _T(X[r]), torch.ones(400, dtype=torch.float64)
        for _ in range(10):
            mu, env, ok = PL.lmd_sift(_T(t), f, pad_width=2)
            new_f = (f - mu) / env
            if not bool(ok):
                break
            f, a = new_f, a * env
            if float(new_f.abs().max()) - 1.0 < 1e-6:
                break
        assert torch.equal(A[r], a) and torch.equal(F[r], torch.clamp(f, -1.0, 1.0))


def test_lmd_first_sift_parts_from_jax_only_by_the_smoothing_stop(monkeypatch):
    """ROADMAP.md C4 inside the normalization's first sift: on this draw
    (pad_width 2) JAX's envelope smoothing runs more passes than the
    port's, because an exact zero difference appears in one summation
    order and not the other. Fixing the port's pass count reproduces JAX
    within 1e-12, so the split is the stop rule and nothing else."""
    rng = np.random.default_rng(1)
    t = np.arange(400.0)
    x = (np.sin(2 * np.pi * t / 37) + 0.3 * np.sin(2 * np.pi * t / 9)
         + 0.05 * rng.standard_normal(400))
    mj, ej, _ = JL.lmd_sift(jnp.asarray(t), jnp.asarray(x), pad_width=2)
    mp, ep, _ = PL.lmd_sift(_T(t), _T(x), pad_width=2)
    _close(mj, mp, 1.0, tol=1e-12)
    gap = float(np.abs(np.asarray(ej) - ep.numpy()).max())
    assert gap > 1e-3, "the stop rule no longer parts the packages here: update ROADMAP.md C4"
    smooth = PL._triangle_smooth_until_monotone
    matches = []
    for k in range(1, 13):
        # the same smoothing, with the pass count fixed at k: a stop flag
        # that is never True runs exactly k = smooth_iter passes
        def fixed(y, m_dense, half, smooth_iter, h_cap, k=k):
            return smooth(y, m_dense, half, k, h_cap)

        monkeypatch.setattr(PL, "_read", lambda *flags: [False] * len(flags))
        monkeypatch.setattr(PL, "_triangle_smooth_until_monotone", fixed)
        _, ek, _ = PL.lmd_sift(_T(t), _T(x), pad_width=2)
        monkeypatch.undo()
        if float(np.abs(np.asarray(ej) - ek.numpy()).max()) <= 1e-12:
            matches.append(k)
    assert matches, "no fixed pass count reproduces JAX's envelope"


@pytest.mark.parametrize("method", ["DQ", "NHT", "TEO", "HT"])
def test_instant_frequency_matches_jax_sample_by_sample(am_rows, method, record_property):
    t, X = am_rows
    freq, amp = P.instant_frequency(_T(t), _T(X), method=method)
    if method in ("DQ", "NHT"):
        _, F = P.am_fm_normalize(_T(t), _T(X))
    decided = 0
    for r in range(X.shape[0]):
        fj, aj = J.instant_frequency(jnp.asarray(t), jnp.asarray(X[r]), method=method)
        scale = float(np.abs(X[r]).max())
        _close(aj, amp[r], scale)
        if method == "DQ":
            _, Fj = J.am_fm_normalize(jnp.asarray(t), jnp.asarray(X[r]))
            near_p, near_j = _dq_near(F[r].numpy()), _dq_near(np.asarray(Fj))
        elif method == "NHT":
            _, Fj = J.am_fm_normalize(jnp.asarray(t), jnp.asarray(X[r]))
            near_p = _angle_near(np.angle(P.hilbert(F[r]).numpy()))
            near_j = _angle_near(np.angle(np.asarray(J.hilbert(Fj))))
        elif method == "HT":
            near_p = _angle_near(np.angle(P.hilbert(_T(X[r])).numpy()))
            near_j = _angle_near(np.angle(np.asarray(J.hilbert(X[r]))))
        else:
            near_p = near_j = np.zeros(t.size, bool)
        decided += held_sample_by_sample(freq[r].numpy(), fj, near_p, near_j,
                                          f"{method} row {r}")
    record_property("samples_parted_at_a_decision", decided)


@pytest.mark.parametrize("method", ["DQ", "NHT", "HT"])
def test_instant_frequency_pure_tone(method):
    t = np.arange(0, 400, 0.2)
    x = np.sin(2 * np.pi * 0.25 * t)
    freq, _ = P.instant_frequency(_T(t), _T(x), method=method)
    assert np.median(freq.numpy()[200:-200]) == pytest.approx(0.25, rel=0.02)


def test_teager_pure_tone():
    t = np.arange(0, 100, 0.05)
    freq, amp = P.instant_frequency(_T(t), _T(np.sin(2 * np.pi * 0.5 * t)), method="TEO")
    assert np.median(freq.numpy()[100:-100]) == pytest.approx(0.5, rel=0.02)
    assert np.median(amp.numpy()[100:-100]) == pytest.approx(1.0, rel=0.05)


def test_instant_frequency_over_modes():
    t = np.arange(0, 100, 0.1)
    modes = np.stack([np.sin(2 * np.pi * f * t) for f in (0.3, 1.0)])
    freq, _ = P.instant_frequency(_T(t), _T(modes), method="DQ")
    med = np.median(freq.numpy()[:, 100:-100], axis=1)
    np.testing.assert_allclose(med, [0.3, 1.0], rtol=0.1)
    with pytest.raises(ValueError, match="unknown"):
        P.instant_frequency(_T(t), _T(modes), method="XX")
    with pytest.raises(ValueError, match="unknown"):
        P.am_fm_normalize(_T(t), _T(modes), norm_type="xx")


def test_spectrogram_matches_jax_and_numpy_scatter():
    rng = np.random.default_rng(1)
    grid = np.linspace(0, 1, 33)
    freq = rng.uniform(-0.1, 1.1, (2, 50))
    amp = rng.uniform(0, 1, (2, 50))
    got = P.spectrogram(_T(grid), _T(freq), _T(amp)).numpy()
    assert got.shape == (2, 33, 50)
    for r in range(2):
        want = np.zeros((33, 50))
        rows = np.clip(np.searchsorted(grid, freq[r]), 0, 32)
        want[rows, np.arange(50)] += amp[r]
        want[[0, -1]] = 0
        np.testing.assert_array_equal(got[r], want)
        np.testing.assert_array_equal(got[r], np.asarray(J.spectrogram(
            jnp.asarray(grid), jnp.asarray(freq[r]), jnp.asarray(amp[r]))))


def test_spectrogram_edge_frequencies_match_jax():
    """NaN, +-inf, below and above the grid: the bins JAX's searchsorted
    gives ([64 64 0 0 64 26 64] on this 64-point grid), then the clip and
    the zeroed edge rows."""
    grid = np.linspace(0.0, 8.0, 64)
    freq = np.array([np.nan, np.inf, -np.inf, 0.0, 9.0, 3.3, np.nan])
    amp = np.arange(1.0, 8.0)
    want_bins = np.asarray(jnp.searchsorted(jnp.asarray(grid), jnp.asarray(freq)))
    np.testing.assert_array_equal(want_bins, [64, 64, 0, 0, 64, 26, 64])
    np.testing.assert_array_equal(P._bin_index(_T(grid), _T(freq)).numpy(), want_bins)
    np.testing.assert_array_equal(
        P.spectrogram(_T(grid), _T(freq), _T(amp)).numpy(),
        np.asarray(J.spectrogram(jnp.asarray(grid), jnp.asarray(freq), jnp.asarray(amp))))


def test_spectrogram_bins_float32_frequencies_in_float64():
    """float32 frequencies are compared with the float64 grid after
    promotion, as JAX under x64 does: a value whose float32 rounding
    crosses a grid point keeps its float64 bin."""
    grid = np.array([0.0, 0.1, 0.2, 0.3, 0.4])
    f32 = np.float32(0.1)  # 0.10000000149 > 0.1 in float64
    freq = np.array([f32, np.float32(0.3), np.float32(0.25)], np.float32)
    got = P._bin_index(_T(grid), _T(freq)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.searchsorted(jnp.asarray(grid),
                                                                   jnp.asarray(freq))))
    assert got[0] == 2
    power = P.spectrogram(_T(grid), _T(freq), _T(np.ones(3, np.float32)))
    assert power.dtype == torch.float32


def test_unwrap_matches_numpy_and_jax():
    """numpy's rule: a reduced step of exactly -pi with a positive raw step
    becomes +pi."""
    rng = np.random.default_rng(2)
    p = np.cumsum(rng.uniform(-4, 4, 200))
    p[50:53] = [0.0, np.pi, 0.0]  # raw steps +pi, -pi
    p[80:82] = [0.0, 3 * np.pi]  # raw step +3 pi reduces to -pi, then to +pi
    P2 = np.stack([p, -p])
    got = P._unwrap(_T(P2)).numpy()
    for r in range(2):
        np.testing.assert_allclose(got[r], np.unwrap(P2[r]), rtol=0, atol=1e-12)
        np.testing.assert_allclose(got[r], np.asarray(jnp.unwrap(jnp.asarray(P2[r]))), rtol=0,
                                   atol=1e-12)


def test_numpy_input_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: numpy input lands on it")
    t = np.arange(64.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.am_fm_normalize(t, np.sin(t))
    A, F = P.am_fm_normalize(t, np.sin(t / 3), device="cpu")
    assert A.device.type == F.device.type == "cpu"
