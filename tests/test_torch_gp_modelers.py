"""GP modeler parity: periodicity_tpu_torch.gp's BrownianGP, HarmonicGP and
QuasiPeriodicGP against the JAX package's, and make_gaussian_prior on
SpottedStar against the reference's numbers.

The same light curves go to both packages, the JAX side on the CPU in x64,
the port's on CPU tensors (its plain recursions). Float64 results are held
within 1e-12 relative of JAX (the recursions' sums, and ndtri, round
differently); the L-BFGS minimum within 1e-8 relative (the same algorithm,
whose host algebra sums in another order); predictions within 1e-10 of
their scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from periodicity_tpu.core import TSeries as JTSeries
from periodicity_tpu.data import SpottedStar
from periodicity_tpu.gp import BrownianGP as JBrownianGP
from periodicity_tpu.gp import HarmonicGP as JHarmonicGP
from periodicity_tpu.gp import QuasiPeriodicGP as JQuasiPeriodicGP
from periodicity_tpu_torch import TSeries
from periodicity_tpu_torch.gp import BrownianGP, HarmonicGP, QuasiPeriodicGP, make_gaussian_prior

PAIRS = {"brownian": (JBrownianGP, BrownianGP), "harmonic": (JHarmonicGP, HarmonicGP)}
N_SMALL = 100


@pytest.fixture(autouse=True, scope="module")
def _release_jax_executables():
    """Free this module's compiled JAX executables when it ends: an xdist
    worker runs many modules in one process, and one that accumulates too
    many XLA executables can crash (pyproject.toml)."""
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def spotted():
    return SpottedStar()


def _pair(name, t, y, dy):
    jcls, pcls = PAIRS[name]
    return (jcls(JTSeries(t, y), err=dy),
            pcls(TSeries(t, y, device="cpu"), err=torch.from_numpy(dy)))


@pytest.fixture(scope="module", params=list(PAIRS))
def small(request, spotted):
    t, y, dy = spotted
    return request.param, _pair(request.param, t[:N_SMALL], y[:N_SMALL], dy[:N_SMALL])


def _close(got, want, rel):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(float(np.abs(want).max()), 1e-300))


def test_prior_transform_matches_jax(small):
    _, (jm, pm) = small
    rng = np.random.default_rng(1)
    u = rng.uniform(1, 99, (pm.ndim, 5))  # the first axis is the parameter
    want = jm.prior_transform(jnp.asarray(u))
    got = pm.prior_transform(u)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], 1e-13)


def test_nll_and_batched_log_prob_match_jax(small):
    _, (jm, pm) = small
    rng = np.random.default_rng(2)
    U = rng.uniform(1, 99, (4, pm.ndim))
    U[3, 0] = 99.995  # outside the box: -inf in both
    want = np.asarray(jax.vmap(jm._lp_jit)(jnp.asarray(U)))
    got = pm._log_prob_u(torch.from_numpy(U)).numpy()
    assert got[3] == -np.inf and want[3] == -np.inf
    np.testing.assert_allclose(got[:3], want[:3], rtol=1e-12)
    assert pm.log_prob(U[0]) == got[0] and pm.log_prob(U[3]) == -np.inf
    # inside the box (no clipping) the log-probability is minus the nll
    for u, lp in zip(U[:2], want[:2]):
        assert pm.nll(u) == pytest.approx(-lp, rel=1e-12)


def test_set_params_predictions_kernel_psd_loocv_match_jax(spotted):
    """HarmonicGP (the masked RotationTerm, R = 8). The JAX side runs under
    one jit (its terms then in their masked form, the same numbers) on a
    fresh GaussianProcess."""
    from periodicity_tpu.models.gp.solver import GaussianProcess as JGaussianProcess

    t, y, dy = spotted
    jm, pm = _pair("harmonic", t[:N_SMALL], y[:N_SMALL], dy[:N_SMALL])
    u = np.linspace(30, 70, pm.ndim)
    tn = np.linspace(float(jm.t[0]) - 1, float(jm.t[-1]) + 1, 30)
    tau = np.linspace(0, 5, 20)
    f = np.linspace(0.01, 2, 25)

    @jax.jit
    def jax_side(u):
        params = dict(jm.prior_transform(u))
        mean, jitter = params.pop("mean"), params.pop("jitter")
        gp = JGaussianProcess(jm._kernel(**params), mean=mean)
        gp.compute(jm.t, diag=jm.err**2 + jitter)
        return (jm.get_prediction(tn, gp), jm.get_kernel(tau, gp), jm.get_psd(f, gp),
                jm.loocv(gp))

    (mu, sd), kern, psd, loocv = jax_side(jnp.asarray(u))
    pgp = pm.set_params(dict(pm.prior_transform(u)), pm.gp)
    for got, want in zip(pm.get_prediction(tn, pgp), (mu, sd)):
        _close(got, want, 1e-10)
    _close(pm.get_kernel(tau, pgp), kern, 1e-13)
    _close(pm.get_psd(f, pgp), psd, 1e-13)
    assert float(pm.loocv(pgp)) == pytest.approx(float(loocv), rel=1e-11)


def test_spotted_star_nll_at_the_cube_center(spotted):
    t, y, dy = spotted
    jm, pm = _pair("brownian", t, y, dy)
    u = np.full(pm.ndim, 50.0)
    assert pm.nll(u) == pytest.approx(jm.nll(u), rel=1e-12)


def test_minimize_sets_the_gp_at_the_optimum(spotted):
    """BrownianGP.minimize from the cube's center on a short series: inside
    the box, below the start, and the modeler's gp set at the optimum.
    (The L-BFGS itself is held against JAX's in test_torch_gp_mcmc.py, the
    likelihood's gradient in test_torch_gp.py, and the minimum against
    JAX's in the dense modeler's test below: JAX's celerite minimize
    compiles for ~15 s on a CPU, over half of this file's run time.)"""
    t, y, dy = spotted
    n = 40
    pm = BrownianGP(TSeries(t[:n], y[:n], device="cpu"), err=torch.from_numpy(dy[:n]))
    start = pm.nll(np.full(pm.ndim, 50.0))
    ps, gp = pm.minimize(pm.gp, max_steps=15)
    assert ps.fun < start
    assert ps.fun == pytest.approx(pm.nll(ps.x), rel=1e-13)
    assert np.all((ps.x >= 0.01) & (ps.x <= 99.99))
    assert float(gp.mean) == pytest.approx(float(pm.prior_transform(ps.x)["mean"]), rel=1e-15)


def test_unported_solvers_and_samplers_name_their_slice(spotted):
    """Every solver is ported: an unknown one is an error, and the sharded
    one without a mesh raises as JAX's does (its parity is in
    test_torch_parallel_gp.py)."""
    t, y, dy = spotted
    sig = TSeries(t[:50], y[:50], device="cpu")
    with pytest.raises(ValueError, match="solver='sharded' needs a "):
        JBrownianGP(JTSeries(t[:50], y[:50]), err=dy[:50], solver="sharded")
    with pytest.raises(ValueError, match="solver='sharded' needs a "):
        BrownianGP(sig, err=dy[:50], solver="sharded")
    with pytest.raises(ValueError, match="unknown solver"):
        BrownianGP(sig, err=dy[:50], solver="dense")


@pytest.mark.parametrize("solver", ["pscan", "blocked", "chunked"])
def test_solvers_give_the_scans_nll_on_spotted_star(spotted, solver):
    """tests/test_gp.py::test_pscan_modeler_path and test_chunked_modeler_path
    (rel 1e-8), for every Kalman solver, with its gradient at a batch of
    hypercube points within 1e-8 of the scan's (pscan's by autograd,
    blocked and chunked through K2)."""
    t, y, dy = spotted
    sig = TSeries(t, y, device="cpu")
    scan = BrownianGP(sig, err=torch.from_numpy(dy))
    other = BrownianGP(sig, err=torch.from_numpy(dy), solver=solver)
    u = np.full(6, 50.0)
    assert other.nll(u) == pytest.approx(scan.nll(u), rel=1e-8)
    uu = torch.from_numpy(np.random.default_rng(1).uniform(20, 80, (2, 6)))
    grads = []
    for m in (scan, other):
        x = uu.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(m._nll_u(x).sum(), x)
        grads.append(g)
    np.testing.assert_allclose(grads[1].numpy(), grads[0].numpy(), rtol=1e-8,
                               atol=1e-8 * float(grads[0].abs().max()))


def test_nuts_surface_on_a_short_run(spotted):
    """Both families' .nuts() at a small shape: trace and chain shapes, the
    chain in hypercube coordinates for the celerite modeler, finite values,
    PSDs over the samples, the diagnostics' keys, the same seed the same
    chain."""
    t, y, dy = spotted
    n = 40
    pm = BrownianGP(TSeries(t[:n], y[:n], device="cpu"), err=torch.from_numpy(dy[:n]))
    freq = np.linspace(0.05, 1.0, 5)
    trace, tau = pm.nuts(n_chains=2, n_steps=6, n_warmup=4, burn=2, max_depth=3, psd_at=freq,
                         random_seed=3)
    assert set(trace) == {"mean", "sigma", "tau", "period", "mix", "jitter"}
    assert trace["period"].shape == (2 * 4,) and tau.shape == (pm.ndim,)
    assert pm.chain.shape == (6, 2, pm.ndim) and pm.psds.shape == (2 * 4, freq.size)
    assert np.all((pm.chain > 0) & (pm.chain < 100)) and np.all(np.isfinite(pm.psds))
    assert 0 <= pm.acceptance <= 1
    assert set(pm.nuts_diagnostics) == {"divergences", "step_size", "inv_mass", "tree_depth",
                                        "n_leapfrog", "n_leapfrog_warmup", "ess", "rhat"}
    assert pm.nuts_diagnostics["tree_depth"].shape == (6, 2)
    assert np.all(pm.nuts_diagnostics["tree_depth"] <= 3)
    chain = pm.chain.copy()
    pm.nuts(n_chains=2, n_steps=6, n_warmup=4, burn=2, max_depth=3, random_seed=3)
    np.testing.assert_array_equal(pm.chain, chain)
    qp = QuasiPeriodicGP(TSeries(t[:30], y[:30], device="cpu"), torch.from_numpy(dy[:30]))
    samples, tau = qp.nuts(n_chains=2, n_steps=5, n_warmup=4, burn=1, max_depth=3,
                           random_seed=1)
    assert samples.shape == (qp.ndim, 2 * 4) and qp.chain.shape == (5, 2, qp.ndim)
    assert np.all(np.isfinite(samples)) and 0 <= qp.acceptance <= 1
    assert qp.nuts_diagnostics["rhat"].shape == (qp.ndim,)


def test_make_gaussian_prior_spotted_star(spotted):
    """Reference tests/test_gp.py:8-21: argmax bin 671 and 7 peaks."""
    t, y, _ = spotted
    prior = make_gaussian_prior(TSeries(t, y, device="cpu"))
    prob = prior(np.linspace(-3, 5, 1000))
    assert prob.argmax() == 671
    peaks = [i for i in range(1, 999) if prob[i - 1] < prob[i] > prob[i + 1]]
    assert len(peaks) == 7


@pytest.fixture(scope="module")
def qp():
    rng = np.random.default_rng(42)
    n = 120
    t = np.linspace(0, 10, n)
    y = np.sin(np.pi * t) + 0.1 * rng.standard_normal(n)
    yerr = np.full(n, 0.1)
    return (JQuasiPeriodicGP(JTSeries(t, y), yerr),
            QuasiPeriodicGP(TSeries(t, y, device="cpu"), torch.from_numpy(yerr)), t)


def test_quasi_periodic_gp_matches_jax(qp):
    jm, pm, t = qp
    np.testing.assert_array_equal(pm.theta0.numpy(), np.asarray(jm.theta0))
    assert pm.bounds == pytest.approx(jm.bounds, rel=1e-15)
    theta = np.asarray(jm.theta0) + np.array([0.01, -0.2, 0.1, 0.3, -0.5, 0.4])
    grad = jax.jit(jax.grad(jm._nll_theta))
    for th in (np.asarray(jm.theta0), theta):
        assert pm.nll(th) == pytest.approx(jm.nll(th), rel=1e-12)
        want = np.asarray(grad(jnp.asarray(th)))
        np.testing.assert_allclose(pm.grad_nll(th), want, rtol=0, atol=1e-9 * np.abs(want).max())
    batch = np.stack([np.asarray(jm.theta0), theta])
    lp = np.asarray(jax.vmap(jm._lp_jit)(jnp.asarray(batch)))
    np.testing.assert_allclose(pm._log_prob_theta(torch.from_numpy(batch)).numpy(), lp,
                               rtol=1e-12)
    assert pm.log_prob(theta) == pytest.approx(float(lp[1]), rel=1e-12)
    mu, sd = jax.jit(lambda th: jm.predict(th, t[:10]))(jnp.asarray(theta))
    for got, want in zip(pm.predict(theta, t[:10]), (mu, sd)):
        _close(got, want, 1e-10)
    pm.set_params(theta)
    for got, want in zip(pm.get_prediction(t[:10]), (mu, sd)):
        _close(got, want, 1e-10)
    with pytest.raises(ValueError):
        pm.set_params(theta[:3])


def test_quasi_periodic_gp_minimize_matches_jax(qp):
    """The dense modeler's L-BFGS (with its constraint penalty) from the
    same start near the injected period (from the default theta0 both walk
    into corners of the box, where an ulp decides which): the final
    objective within 1e-8 relative of JAX's, no worse than the start, and a
    finite prediction with sd >= 0 there."""
    jm, pm, t = qp
    pm = QuasiPeriodicGP(pm.signal, pm.err)
    start = np.array([0.0, np.log(0.01), np.log(0.5), np.log(25.0), 2.0, np.log(2.0)])
    pm.set_params(start)
    nll0 = pm.nll(start)
    js, _ = JQuasiPeriodicGP(jm.signal, jm.err).set_params(jnp.asarray(start)).minimize()
    ps, _ = pm.minimize()
    assert ps.fun == pytest.approx(js.fun, rel=1e-8)
    assert ps.fun <= nll0
    mu, sd = pm.predict(ps.x, t[:10])
    assert torch.isfinite(mu).all() and (sd >= 0).all()


def test_mcmc_surface_on_a_short_run(spotted, tmp_path):
    """The samplers' surface on a short run: trace and chain shapes, PSDs
    over the samples with a batch axis, walkers drawn over the whole cube
    with use_prior, the same seed the same chain, and a checkpointed run
    that resumes to the uninterrupted run's samples."""
    t, y, dy = spotted
    n = 40
    pm = BrownianGP(TSeries(t[:n], y[:n], device="cpu"), err=torch.from_numpy(dy[:n]))
    freq = np.linspace(0.05, 1.0, 7)
    trace, tau = pm.mcmc(n_walkers=8, n_steps=6, burn=2, use_prior=True, psd_at=freq,
                         random_seed=3)
    assert set(trace) == {"mean", "sigma", "tau", "period", "mix", "jitter"}
    assert trace["period"].shape == (8 * 4,) and tau.shape == (pm.ndim,)
    assert pm.chain.shape == (6, 8, pm.ndim) and pm.psds.shape == (8 * 4, freq.size)
    assert np.all((pm.chain > 0.01) & (pm.chain < 99.99))
    assert np.all(np.isfinite(pm.psds)) and 0 <= pm.acceptance <= 1
    again, _ = pm.mcmc(n_walkers=8, n_steps=6, burn=2, use_prior=True, random_seed=3)
    np.testing.assert_array_equal(again["period"], trace["period"])
    ckpt = str(tmp_path / "chain")
    pm.mcmc(n_walkers=8, n_steps=4, use_prior=True, random_seed=3, checkpoint_path=ckpt,
            checkpoint_every=2)
    part = pm.chain.copy()
    pm.mcmc(n_walkers=8, n_steps=6, use_prior=True, random_seed=3, checkpoint_path=ckpt,
            checkpoint_every=2)
    resumed = pm.chain.copy()
    pm.mcmc(n_walkers=8, n_steps=6, use_prior=True, random_seed=3,
            checkpoint_path=str(tmp_path / "fresh"), checkpoint_every=2)
    np.testing.assert_array_equal(resumed, pm.chain)
    np.testing.assert_array_equal(resumed[:4], part)
    qp = QuasiPeriodicGP(TSeries(t[:30], y[:30], device="cpu"), torch.from_numpy(dy[:30]))
    samples, tau = qp.mcmc(n_walkers=8, n_steps=3, random_seed=1)
    assert samples.shape == (qp.ndim, 8 * 3) and qp.chain.shape == (3, 8, qp.ndim)
