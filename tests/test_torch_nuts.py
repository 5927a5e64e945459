"""NUTS parity: periodicity_tpu_torch.models.gp.nuts against the JAX
package's sampler.

The port's chains run in lockstep with explicit draws, so one transition
(``_nuts_step``) and the initial step size (``_find_reasonable_eps``) are
fed the numbers JAX draws from its keys (the splits of
periodicity_tpu/models/gp/nuts.py:158, 170, 109-110 and 218, reproduced
here) and must take the same discrete path: equal tree depths, leaf counts
and divergence flags, and z, log-density and the accept statistic within
1e-12 relative (the leapfrog's gradients come from another solver's sums;
JAX's and the port's celerite gradients agree within 1e-10 of their scale).
Warmup's adaptation is held against a numpy transcription of JAX's update
within 1e-14, the schedule and the bit helpers exactly. A port-only run on
a standard normal is held at JAX's own moment tolerances
(tests/test_nuts.py:14-27) with 1200 draws in place of 4000.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from periodicity_tpu.models.gp import nuts as JN
from periodicity_tpu_torch.gp import run_nuts
from periodicity_tpu_torch.models.gp import nuts as PN


@pytest.fixture(autouse=True, scope="module")
def _release_jax_executables():
    """Free this module's compiled JAX executables when it ends: an xdist
    worker runs many modules in one process, and one that accumulates too
    many XLA executables can crash (pyproject.toml)."""
    yield
    jax.clear_caches()


def _T(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("n_warmup", [0, 10, 100, 149, 150, 500, 1000])
def test_warmup_schedule_equals_jax(n_warmup):
    for got, want in zip(PN._warmup_schedule(n_warmup), JN._warmup_schedule(n_warmup)):
        np.testing.assert_array_equal(got, want)


def test_popcount_and_trailing_ones_equal_jax():
    n = jnp.arange(256)
    pop = np.asarray(JN._popcount(n))
    ones = np.asarray(JN._trailing_ones(n))
    assert [PN._popcount(i) for i in range(256)] == pop.tolist()
    assert [PN._trailing_ones(i) for i in range(256)] == ones.tolist()
    assert PN._trailing_ones(0xFFFFFFFF) == 32 and PN._popcount(-1) == 32


def _jax_step_draws(key, d, max_depth):
    """The numbers JAX's _nuts_step draws from ``key``: the momentum normal,
    then per doubling (direction, subtree, accept) keys, and a take-uniform
    per leaf from the subtree key's chain of splits."""
    key, k_mom = jax.random.split(key)
    normal = np.asarray(jax.random.normal(k_mom, (d,), jnp.float64))
    direction = np.zeros(max_depth, bool)
    take = np.zeros((max_depth, 1 << (max_depth - 1)))
    accept = np.zeros(max_depth)
    for depth in range(max_depth):
        key, k_dir, k_sub, k_acc = jax.random.split(key, 4)
        direction[depth] = bool(jax.random.bernoulli(k_dir))
        accept[depth] = float(jax.random.uniform(k_acc, dtype=jnp.float64))
        for leaf in range(1 << depth):
            k_sub, k_take = jax.random.split(k_sub)
            take[depth, leaf] = float(jax.random.uniform(k_take, dtype=jnp.float64))
    return normal, direction, take, accept


def _stacked(draws):
    return tuple(_T(np.stack([d[i] for d in draws])) for i in range(4))


def _gaussian():
    prec = np.array([[2.0, 0.3, 0.0], [0.3, 1.0, 0.2], [0.0, 0.2, 0.5]])
    return (lambda x: -0.5 * x @ jnp.asarray(prec) @ x,
            lambda x: -0.5 * torch.einsum("ci,ij,cj->c", x, _T(prec), x))


@pytest.fixture(scope="module")
def rotator_posterior():
    """A small BrownianTerm posterior in f64, in the form of config 13's
    (benchmarks/run_benchmarks.py:720-733: log-scaled amplitudes and
    times, a sigmoid mix, a unit normal prior), on the first 60 samples of
    tests/test_nuts.py's synthetic rotator. (A modeler's _log_prob_x makes
    JAX compile its while loops for ~40 s on this CPU.)"""
    from periodicity_tpu.models.gp import solver as JS
    from periodicity_tpu.models.gp import terms as JT
    from periodicity_tpu_torch.models.gp import solver as PS
    from periodicity_tpu_torch.models.gp import terms as PT

    rng = np.random.default_rng(7)
    t = np.sort(rng.uniform(0, 60, 300))
    y = (np.sin(2 * np.pi * t / 9.0) + 0.3 * np.sin(4 * np.pi * t / 9.0 + 0.5)
         + 0.1 * rng.standard_normal(t.size))
    t, y, diag = t[:60], y[:60] - y[:60].mean(), np.full(60, 0.01)
    tt, yt, dt = _T(t), _T(y), _T(diag)

    def jlp(w):
        term = JT.BrownianTerm(0.3 * jnp.exp(w[0]), 20.0 * jnp.exp(w[1]), 9.0 * jnp.exp(w[2]),
                               0.3 * jax.nn.sigmoid(w[3]))
        ll = JS.log_likelihood(term, t, diag, y)
        return jnp.where(jnp.isfinite(ll), ll, -1e25) - 0.5 * jnp.sum(w**2)

    def plp(w):
        term = PT.BrownianTerm(0.3 * torch.exp(w[:, 0]), 20.0 * torch.exp(w[:, 1]),
                               9.0 * torch.exp(w[:, 2]), 0.3 * torch.sigmoid(w[:, 3]))
        ll = PS.log_likelihood(term, tt, dt, yt)
        return torch.where(torch.isfinite(ll), ll, -1e25) - 0.5 * torch.sum(w**2, dim=-1)

    return jlp, plp


def _posterior(name, rotator):
    if name == "gaussian":
        return _gaussian() + (np.random.default_rng(0).standard_normal((4, 3)),)
    return rotator + (0.3 * np.random.default_rng(1).standard_normal((4, 4)),)


def _close(got, want, rel=1e-12):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * np.abs(want).max())


@pytest.mark.parametrize("name", ["gaussian", "rotator"])
def test_nuts_step_fed_jax_draws_takes_jax_path(name, request):
    rotator = request.getfixturevalue("rotator_posterior") if name == "rotator" else None
    jlp, plp, z = _posterior(name, rotator)
    c, d = z.shape
    max_depth = 5
    eps = np.array([0.05, 0.3, 0.9, 2.5])[:c]
    im = np.random.default_rng(2).uniform(0.5, 2.0, (c, d))
    keys = jax.random.split(jax.random.PRNGKey(5), c)
    vg = jax.value_and_grad(jlp)
    lf = JN._make_leapfrog(vg)

    def one(z, e, m, k):
        logp, grad = vg(z)
        return JN._nuts_step(lf, z, logp, grad, e, m, max_depth, k)

    want = jax.jit(jax.vmap(one))(jnp.asarray(z), jnp.asarray(eps), jnp.asarray(im), keys)
    draws = _stacked([_jax_step_draws(k, d, max_depth) for k in keys])
    pvg = PN._value_and_grad(plp)
    zt = _T(z)
    logp, grad = pvg(zt)
    got = PN._nuts_step(pvg, zt, logp, grad, _T(eps), _T(im), max_depth, draws)
    z_w, lp_w, _, acc_w, leaf_w, div_w, depth_w = (np.asarray(w) for w in want)
    z_g, lp_g, _, acc_g, leaf_g, div_g, depth_g = (g.numpy() for g in got)
    np.testing.assert_array_equal(depth_g, depth_w)
    np.testing.assert_array_equal(leaf_g, leaf_w)
    np.testing.assert_array_equal(div_g, div_w)
    _close(z_g, z_w)
    _close(lp_g, lp_w)
    _close(acc_g, acc_w)
    # the draws reach more than one depth, and one chain at least stops early
    assert len(set(depth_g.tolist())) > 1 and depth_g.max() > 1


@pytest.mark.parametrize("name", ["gaussian", "rotator"])
def test_find_reasonable_eps_fed_jax_draws_equals_jax(name, request):
    rotator = request.getfixturevalue("rotator_posterior") if name == "rotator" else None
    jlp, plp, z = _posterior(name, rotator)
    c, d = z.shape
    im = np.random.default_rng(3).uniform(0.5, 2.0, (c, d))
    keys = jax.random.split(jax.random.PRNGKey(9), c)
    vg = jax.value_and_grad(jlp)
    lf = JN._make_leapfrog(vg)

    def one(z, m, k):
        logp, grad = vg(z)
        return JN._find_reasonable_eps(lf, z, logp, grad, m, k)

    want = np.asarray(jax.jit(jax.vmap(one))(jnp.asarray(z), jnp.asarray(im), keys))
    normal = _T(np.stack([np.asarray(jax.random.normal(k, (d,), jnp.float64)) for k in keys]))
    pvg = PN._value_and_grad(plp)
    zt = _T(z)
    logp, grad = pvg(zt)
    got = PN._find_reasonable_eps(pvg, zt, logp, grad, _T(im), normal).numpy()
    np.testing.assert_array_equal(got, want)


def _adapt_numpy(state, z, acc, in_win, win_end, target):
    """JAX's warm_step adaptation (nuts.py:316-351), one chain at a time."""
    mu, log_eps, log_eps_avg, h_bar, count, n_w, mean_w, m2_w, inv_mass = (
        np.array(x, dtype=np.float64) for x in state)
    count = count + 1
    w = 1.0 / (count + 10.0)
    h_bar = (1 - w) * h_bar + w * (target - acc)
    log_eps = mu - np.sqrt(count) / 0.05 * h_bar
    eta = count ** (-0.75)
    log_eps_avg = eta * log_eps + (1 - eta) * log_eps_avg
    if in_win:
        n_new = n_w + 1
        delta = z - mean_w
        mean_new = mean_w + delta / n_new[:, None]
        m2_w = m2_w + delta * (z - mean_new)
        n_w, mean_w = n_new, mean_new
    var = m2_w / np.maximum(n_w - 1, 1)[:, None]
    var = (n_w / (n_w + 5.0))[:, None] * var + 1e-3 * (5.0 / (n_w + 5.0))[:, None]
    if win_end:
        inv_mass = np.where((n_w > 1)[:, None], var, inv_mass)
        n_w, mean_w, m2_w = np.zeros_like(n_w), np.zeros_like(mean_w), np.zeros_like(m2_w)
        mu = np.log(10.0) + log_eps
        h_bar = np.zeros_like(h_bar)
        count = np.zeros_like(count)
    return (mu, log_eps, log_eps_avg, h_bar, count, n_w, mean_w, m2_w, inv_mass)


@pytest.mark.parametrize("in_win,win_end", [(False, False), (True, False), (True, True)])
def test_adaptation_step_matches_numpy_transcription(in_win, win_end):
    rng = np.random.default_rng(4)
    c, d = 3, 2
    state = (rng.normal(size=c), rng.normal(size=c), rng.normal(size=c), rng.normal(size=c),
             np.array([3.0, 7.0, 0.0]), np.array([4.0, 9.0, 1.0]), rng.normal(size=(c, d)),
             rng.uniform(0.5, 2.0, (c, d)), rng.uniform(0.5, 2.0, (c, d)))
    z, acc = rng.normal(size=(c, d)), rng.uniform(size=c)
    got = PN._adapt(tuple(_T(x) for x in state), _T(z), _T(acc), in_win, win_end, 0.8)
    want = _adapt_numpy(state, z, acc, in_win, win_end, 0.8)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-14, atol=1e-14)


def test_run_nuts_standard_normal_moments():
    """JAX's test_nuts_std_normal_moments at 4 chains x 300 steps after 300
    warmup steps, port only (the chains differ from JAX's for a seed)."""
    x0 = _T(np.random.default_rng(0).standard_normal((4, 3)))
    out = run_nuts(lambda x: -0.5 * torch.sum(x**2, dim=-1), x0, 0, 300, n_warmup=300)
    s = out["chain"].reshape(-1, 3).numpy()
    assert s.shape == (1200, 3)
    np.testing.assert_allclose(s.mean(0), 0.0, atol=0.1)
    np.testing.assert_allclose(s.var(0), 1.0, rtol=0.15)
    acc = out["accept_prob"].numpy()
    assert np.all((acc > 0.6) & (acc <= 1.0))
    assert np.all(out["divergences"].numpy() == 0)
    assert out["log_probs"].shape == (300, 4) and out["tree_depth"].shape == (300, 4)
    assert out["inv_mass"].shape == (4, 3) and out["step_size"].shape == (4,)
    assert np.all(out["n_leapfrog"].numpy() >= 300) and np.all(out["n_leapfrog_warmup"].numpy() > 0)


def test_run_nuts_deterministic_given_seed():
    x0 = torch.zeros((2, 2), dtype=torch.float64)

    def logp(x):
        return -0.5 * torch.sum(x**2, dim=-1)

    a = run_nuts(logp, x0, 3, 20, n_warmup=30)
    b = run_nuts(logp, x0, 3, 20, n_warmup=30)
    np.testing.assert_array_equal(a["chain"].numpy(), b["chain"].numpy())
    c = run_nuts(logp, x0, 4, 20, n_warmup=30)
    assert not np.array_equal(a["chain"].numpy(), c["chain"].numpy())
    # a Generator draws everything in order; no warmup keeps the initial step size
    g = run_nuts(logp, x0, torch.Generator().manual_seed(1), 5, n_warmup=0)
    assert g["chain"].shape == (5, 2, 2) and torch.all(g["n_leapfrog_warmup"] == 0)
    assert torch.all(g["inv_mass"] == 1)
