"""Decomposition estimators: periodicity_tpu_torch.decomposition vs the JAX
package, and the behavioural checks of ``tests/test_decomposition.py``.

The same numpy draws go to both packages, the JAX side on the CPU in x64,
the port's through its plain versions (CPU tensors). CEEMDAN draws its
noise from ``np.random.default_rng(random_seed)`` on the host in both, so
both sift the same noise. Tolerances: modes and residues within
1e-9 * max|x| (the sift decides on integer counts, so the mode counts are
equal; XLA may contract a multiply-add into an FMA on the CPU where the
port rounds each operation); VMD's 500 ADMM iterations within 1e-9 in
float64 and 1e-5 of max|x| in float32. The reference's CEEMDAN thresholds
at N = 1000 and 50 realizations run on the card
(``tests/test_torch_gpu.py``); here the same kind of draw is cut to
N = 512 and 8 realizations.
"""

import numpy as np
import pytest

import periodicity_tpu.decomposition as JD
import periodicity_tpu_torch
import periodicity_tpu_torch.decomposition as PD
from periodicity_tpu.core import TSeries as JTSeries
from periodicity_tpu_torch.core import TSeries


def _close(port, jax_series, scale, tol=1e-9):
    np.testing.assert_allclose(port.values.numpy(), np.asarray(jax_series.values), rtol=0,
                               atol=tol * scale)


def _both(t, x):
    return TSeries(t, x, device="cpu"), JTSeries(t, x)


def test_aliases_export_jax_names():
    assert PD.__all__ == JD.__all__ == ["EMD", "CEEMDAN", "LMD", "VMD"]
    assert "decomposition" in periodicity_tpu_torch.__all__
    assert periodicity_tpu_torch.decomposition is PD


def test_emd_two_tones_matches_jax_and_separates():
    t = np.arange(1000, dtype=float)
    slow = np.sin(2 * np.pi * 0.005 * t)
    fast = 0.5 * np.sin(2 * np.pi * 0.1 * t)
    sig, jsig = _both(t, slow + fast)
    emd = PD.EMD()
    imfs = emd(sig)
    jimfs = JD.EMD()(jsig)
    assert len(imfs) == len(jimfs) >= 2
    for a, b in zip(imfs, jimfs):
        _close(a, b, 1.5)
    _close(emd.residue, jsig - sum(jimfs), 1.5)
    got_fast = imfs[0].values.numpy()
    sl = slice(50, -50)
    assert np.linalg.norm(got_fast[sl] - fast[sl]) / np.linalg.norm(fast[sl]) < 0.05
    recon = sum(imfs).values.numpy() + emd.residue.values.numpy()
    np.testing.assert_allclose(recon, slow + fast, atol=1e-10)


def test_emd_monotonic_signal_gives_no_modes():
    sig = TSeries(np.arange(100.0), np.linspace(0, 1, 100), device="cpu")
    assert len(PD.EMD()(sig)) == 0


def test_emd_sift_and_iter_match_jax():
    rng = np.random.default_rng(4)
    t = np.arange(300.0)
    x = np.sin(t / 6.0) + 0.3 * rng.standard_normal(300)
    sig, jsig = _both(t, x)
    mu, sigma, n_ext, n_zero = PD.EMD().sift(sig)
    jmu, jsigma, jn_ext, jn_zero = JD.EMD().sift(jsig)
    _close(mu, jmu, np.abs(x).max())
    assert (n_ext, n_zero) == (jn_ext, jn_zero)
    mode, mono = PD.EMD(max_iter=50).iter(sig)
    jmode, jmono = JD.EMD(max_iter=50).iter(jsig)
    _close(mode, jmode, np.abs(x).max())
    assert mono == jmono
    with pytest.raises(ValueError):
        PD.EMD().sift(TSeries(t, np.linspace(0, 1, 300), device="cpu"))


@pytest.fixture(scope="module")
def ceemdan_pair():
    """A sustained tone plus a gapped one (SustainedPlusGappedPureTones,
    cut from 1000 samples to 512), 8 realizations, seed 42."""
    n = 512
    t = np.arange(float(n))
    x = np.sin(2 * np.pi * 0.065 * t)
    x[256:384] += np.sin(2 * np.pi * 0.255 * np.arange(128))
    sig, jsig = _both(t, x)
    port = PD.CEEMDAN(ensemble_size=8, random_seed=42)
    jax_ = JD.CEEMDAN(ensemble_size=8, random_seed=42)
    port(sig)
    jax_(jsig)
    return port, jax_, np.abs(x).max()


def test_ceemdan_matches_jax(ceemdan_pair):
    port, jax_, scale = ceemdan_pair
    assert port.n_modes == jax_.n_modes >= 2
    for a, b in zip(port.modes, jax_.modes):
        _close(a, b, scale)
    _close(port.residue, jax_.residue, scale)
    err = (sum(port.modes) + port.residue - port.signal).values.numpy()
    assert np.linalg.norm(err) / np.linalg.norm(port.signal.values.numpy()) < 1e-10


def test_ceemdan_postprocessing_and_orthogonality_match_jax(ceemdan_pair):
    port, jax_, scale = ceemdan_pair
    port.postprocessing()
    jax_.postprocessing()
    assert len(port.c_modes) == len(jax_.c_modes)
    for a, b in zip(port.c_modes, jax_.c_modes):
        _close(a, b, scale)
    _close(port.c_residue, jax_.c_residue, scale)
    np.testing.assert_allclose(port.orthogonality_matrix, jax_.orthogonality_matrix, atol=1e-9)
    np.testing.assert_allclose(port.c_orthogonality_matrix, jax_.c_orthogonality_matrix,
                               atol=1e-9)


def test_ceemdan_noise_mode_cap_matches_jax():
    """Stages past the noise pre-decomposition's cap add no noise."""
    rng = np.random.default_rng(9)
    t = np.arange(256.0)
    x = np.sin(t / 5.0) + 0.5 * np.sin(t / 23.0) + 0.1 * rng.standard_normal(256)
    sig, jsig = _both(t, x)
    port = PD.CEEMDAN(ensemble_size=4, random_seed=7)
    jax_ = JD.CEEMDAN(ensemble_size=4, random_seed=7)
    port.noise_modes_cap = jax_.noise_modes_cap = 2
    modes, jmodes = port(sig, max_modes=4), jax_(jsig, max_modes=4)
    assert len(modes) == len(jmodes)
    for a, b in zip(modes, jmodes):
        _close(a, b, np.abs(x).max())


def test_vmd_two_tones_matches_jax():
    t = np.arange(1000, dtype=float)
    s1 = np.sin(2 * np.pi * 0.05 * t)
    s2 = 0.7 * np.sin(2 * np.pi * 0.2 * t)
    sig, jsig = _both(t, s1 + s2)
    vmd = PD.VMD(n_modes=2, alpha=2000.0)
    modes = vmd(sig)
    jvmd = JD.VMD(n_modes=2, alpha=2000.0)
    jmodes = jvmd(jsig)
    assert len(modes) == len(jmodes) == 2
    for a, b in zip(modes, jmodes):
        _close(a, b, 1.7)
    np.testing.assert_allclose(vmd.omegas, jvmd.omegas, rtol=1e-9)
    sl = slice(50, -50)
    for m, s in zip(modes, (s1, s2)):
        got = m.values.numpy()
        assert np.linalg.norm(got[sl] - s[sl]) / np.linalg.norm(s[sl]) < 0.05


def test_vmd_float32_matches_jax():
    t = np.linspace(0, 1, 400, endpoint=False)
    x = (np.cos(2 * np.pi * 5 * t) + 0.5 * np.cos(2 * np.pi * 40 * t)).astype(np.float32)
    sig, jsig = _both(t.astype(np.float32), x)
    modes = PD.VMD(n_modes=2, max_iter=200)(sig)
    jmodes = JD.VMD(n_modes=2, max_iter=200)(jsig)
    for a, b in zip(modes, jmodes):
        assert str(a.values.dtype) == "torch.float32"
        _close(a, b, 1.5, tol=1e-5)


def test_vmd_dual_ascent_converges_with_tau():
    """tau > 0 improves the reconstruction instead of diverging (the dual
    update keeps the paper's sign pairing)."""
    t = np.linspace(0, 1, 500, endpoint=False)
    x = np.cos(2 * np.pi * 5 * t) + 0.5 * np.cos(2 * np.pi * 40 * t)

    def rec_err(tau):
        modes = PD.VMD(n_modes=2, tau=tau, max_iter=300)(TSeries(t, x, device="cpu"))
        rec = np.sum([m.values.numpy() for m in modes], axis=0)
        return np.max(np.abs(rec - x))

    e0, e5 = rec_err(0.0), rec_err(0.5)
    assert np.isfinite(e5)
    assert e5 < e0
    assert e5 < 0.02
