"""Ensemble sampler, checkpoints, chain diagnostics and L-BFGS parity:
periodicity_tpu_torch.models.gp.mcmc, utils.checkpoint and
ops.optimize.lbfgs_box against the JAX package.

- The stretch step, fed the JAX sampler's own draws (its threefry keys
  split as run_ensemble splits them), reproduces JAX's chain on an SHO GP
  posterior (N = 150) in float64: the same accept decisions, positions
  and log-probabilities within 1e-12 relative (the likelihoods agree to
  that, so an accept decision could only flip within it of its threshold).
- A checkpointed run resumed after an interruption equals the
  uninterrupted run bit for bit; a checkpoint of another structure raises.
- autocorr_time, ess and rhat are host numpy copies: equal to JAX's.
- lbfgs_box follows optax's algorithm: its minimum within 1e-8 relative of
  JAX's (the host algebra sums in another order than XLA).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from periodicity_tpu.data import SpottedStar
from periodicity_tpu.models.gp import mcmc as JM
from periodicity_tpu.ops.optimize import lbfgs_box as jax_lbfgs_box
from periodicity_tpu_torch.models.gp import mcmc as PM
from periodicity_tpu_torch.ops.optimize import lbfgs_box
from periodicity_tpu_torch.utils.checkpoint import load_state, save_state


@pytest.fixture(autouse=True, scope="module")
def _release_jax_executables():
    """Free this module's compiled JAX executables when it ends: an xdist
    worker runs many modules in one process, and one that accumulates too
    many XLA executables can crash (pyproject.toml)."""
    yield
    jax.clear_caches()


def _jax_draws(key, n_steps, half, dtype):
    """The draws JAX's run_ensemble makes, in its key order: for each step
    and half-update (stretch uniforms, partner indices, acceptance
    uniforms), as numpy [n_steps, 2, half]."""
    def one_step(k):
        out = []
        for kh in jax.random.split(k):
            k1, k2, k3 = jax.random.split(kh, 3)
            out.append((jax.random.uniform(k1, (half,), dtype),
                        jax.random.randint(k2, (half,), 0, half),
                        jax.random.uniform(k3, (half,), dtype)))
        return [jnp.stack(x) for x in zip(*out)]

    return [np.array(x) for x in jax.jit(jax.vmap(one_step))(jax.random.split(key, n_steps))]


def _sho_log_prob(t, diag, y):
    """Both packages' log-probability of (log S0, log w0) under an SHO
    (Q = 3) GP: [B, 2] -> [B] in the port, one walker in JAX (vmapped by
    its sampler)."""
    from periodicity_tpu.models.gp import solver as JS
    from periodicity_tpu.models.gp import terms as JT
    from periodicity_tpu_torch.models.gp import solver as PS
    from periodicity_tpu_torch.models.gp import terms as PT

    def jax_lp(p):
        return JS.log_likelihood(JT.SHOTerm(S0=jnp.exp(p[0]), w0=jnp.exp(p[1]), Q=3.0),
                                 t, diag, y)

    tt, dt, yt = (torch.from_numpy(a) for a in (t, diag, y))

    def port_lp(p):
        return PS.log_likelihood(PT.SHOTerm(S0=torch.exp(p[:, 0]), w0=torch.exp(p[:, 1]), Q=3.0),
                                 tt, dt, yt)

    return jax_lp, port_lp


def test_stretch_step_fed_jax_draws_reproduces_jax_chain():
    t, y, _ = SpottedStar()
    n, w, steps = 150, 8, 10
    y = (y[:n] - y[:n].mean()) / y[:n].std()
    jax_lp, port_lp = _sho_log_prob(t[:n], np.full(n, 0.05), y)
    x0 = np.array([0.0, -1.0]) + 0.3 * np.random.default_rng(0).standard_normal((w, 2))
    key = jax.random.PRNGKey(7)
    chain_j, lps_j, acc_j = JM.run_ensemble(jax_lp, jnp.asarray(x0), key, steps)
    u, j, r = _jax_draws(key, steps, w // 2, jnp.float64)
    x = torch.from_numpy(x0)
    lp = port_lp(x)
    accepts = []
    for i in range(steps):
        d = tuple((torch.from_numpy(u[i, h]), torch.from_numpy(j[i, h]),
                   torch.from_numpy(r[i, h])) for h in range(2))
        x, lp, acc = PM.stretch_step(port_lp, x, lp, d)
        accepts.append(acc.numpy())
        np.testing.assert_allclose(x.numpy(), np.asarray(chain_j[i]), rtol=1e-12)
        np.testing.assert_allclose(lp.numpy(), np.asarray(lps_j[i]), rtol=1e-12)
    assert 0 < np.mean(accepts) < 1
    assert float(np.mean(accepts)) == pytest.approx(float(acc_j), abs=1e-7)


def _log_prob(u):
    return -0.5 * torch.sum(u**2, dim=-1)


def test_run_ensemble_on_a_gaussian():
    x0 = torch.from_numpy(np.random.default_rng(4).standard_normal((16, 2)))
    chain, lps, acc = PM.run_ensemble(_log_prob, x0, 3, 400)
    assert chain.shape == (400, 16, 2) and lps.shape == (400, 16)
    torch.testing.assert_close(lps, _log_prob(chain), rtol=0, atol=0)
    assert 0.3 < acc < 0.9
    samples = chain[100:].reshape(-1, 2).numpy()
    assert np.all(np.abs(samples.mean(0)) < 0.25) and np.all(np.abs(samples.std(0) - 1) < 0.2)
    again, _, _ = PM.run_ensemble(_log_prob, x0, 3, 400)
    assert torch.equal(chain, again)


def test_checkpoint_resume_identical_samples(tmp_path):
    """A run stopped after three chunks and resumed from its checkpoint
    reproduces the uninterrupted run exactly (each chunk's generator comes
    from (seed, chunk))."""
    x0 = torch.from_numpy(np.random.default_rng(4).standard_normal((8, 2)))
    full_chain, full_lps, full_acc = PM.run_ensemble_checkpointed(
        _log_prob, x0, 3, n_steps=50, checkpoint_every=10)
    ckpt = str(tmp_path / "mcmc")  # no extension: '.npz' is appended on both sides
    partial, _, _ = PM.run_ensemble_checkpointed(
        _log_prob, x0, 3, n_steps=30, checkpoint_every=10, checkpoint_path=ckpt)
    assert partial.shape == (30, 8, 2)
    resumed_chain, resumed_lps, resumed_acc = PM.run_ensemble_checkpointed(
        _log_prob, x0, 3, n_steps=50, checkpoint_every=10, checkpoint_path=ckpt)
    assert torch.equal(resumed_chain, full_chain) and torch.equal(resumed_lps, full_lps)
    assert resumed_acc == pytest.approx(full_acc, abs=1e-12)
    assert torch.equal(full_chain[:30], partial)


def test_checkpoint_structure_mismatch_raises(tmp_path):
    state = {"chain": np.arange(6.0).reshape(2, 3), "key": np.arange(2),
             "nested": [torch.ones(2), (np.zeros(1),)]}
    p = str(tmp_path / "ckpt")
    save_state(p, state)
    like = {"chain": np.zeros((2, 3)), "key": np.zeros(2), "nested": [np.zeros(2), (np.zeros(1),)]}
    back = load_state(p, like)
    np.testing.assert_array_equal(back["chain"], state["chain"])
    np.testing.assert_array_equal(back["nested"][0], np.ones(2))
    assert isinstance(back["nested"][1], tuple)
    for wrong in ({"renamed": np.zeros((2, 3)), "key": np.zeros(2), "nested": like["nested"]},
                  {**like, "nested": [np.zeros(2), [np.zeros(1)]]},
                  {**like, "nested": [np.zeros(2)]}):
        with pytest.raises(ValueError, match="structure"):
            load_state(p, wrong)


def test_diagnostics_equal_jax():
    rng = np.random.default_rng(11)
    chain = np.cumsum(rng.standard_normal((300, 6, 3)), axis=0) * 0.1 + rng.standard_normal(
        (300, 6, 3))
    np.testing.assert_array_equal(PM.autocorr_time(chain), JM.autocorr_time(chain))
    np.testing.assert_array_equal(PM.autocorr_time(torch.from_numpy(chain), c=3),
                                  JM.autocorr_time(chain, c=3))
    np.testing.assert_array_equal(PM.ess(chain), JM.ess(chain))
    np.testing.assert_array_equal(PM.rhat(chain), JM.rhat(chain))
    with pytest.raises(ValueError):
        PM.rhat(chain[:3])


def _dense_gp_data():
    rng = np.random.default_rng(0)
    n = 50
    t = np.sort(rng.uniform(0, 20, n))
    return t, np.sin(t) + 0.3 * rng.standard_normal(n), np.full(n, 0.09)


def _dense_nll(xp, lin, cho_solve, p, t, y, diag):
    """Negative log-likelihood (up to a constant) of a squared-exponential
    GP with log-amplitude p[0] and log-length p[1]."""
    dt = t[:, None] - t[None, :]
    K = xp.exp(p[0] - 0.5 * dt**2 / xp.exp(2 * p[1])) + xp.diag(diag)
    L = lin.cholesky(K)
    alpha = cho_solve(L, y)
    return 0.5 * (y @ alpha) + xp.sum(xp.log(xp.diagonal(L)))


PROBLEMS = {
    "quadratic": (np.array([2.0, -1.0, 0.5, 3.3]), -5.0, 9.0),
    "rosenbrock": (np.array([-1.2, 1.0, 0.3]), -3.0, 3.0),
    "dense_gp": (np.array([0.0, 0.0]), -5.0, 3.0),
}


def _objectives(name):
    if name == "quadratic":
        w = np.array([1.0, 3.0, 10.0, 0.5])
        return (lambda x: jnp.sum((x - jnp.arange(4.0)) ** 2 * w),
                lambda x: torch.sum((x - torch.arange(4.0, dtype=x.dtype)) ** 2
                                    * torch.from_numpy(w)))
    if name == "rosenbrock":
        def rosen(x):
            return (100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2).sum()
        return rosen, rosen
    t, y, diag = _dense_gp_data()
    tt, yt, dt = (torch.from_numpy(a) for a in (t, y, diag))
    return (
        lambda p: _dense_nll(jnp, jnp.linalg,
                             lambda L, b: jax.scipy.linalg.cho_solve((L, True), b), p, t, y, diag),
        lambda p: _dense_nll(torch, torch.linalg,
                             lambda L, b: torch.cholesky_solve(b[:, None], L)[:, 0], p, tt, yt, dt),
    )


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_lbfgs_box_matches_jax(name):
    x0, lo, hi = PROBLEMS[name]
    fj, fp = _objectives(name)
    lower, upper = np.full(x0.size, lo), np.full(x0.size, hi)
    xj, vj = jax_lbfgs_box(fj, jnp.asarray(x0), jnp.asarray(lower), jnp.asarray(upper))
    xp, vp = lbfgs_box(fp, torch.from_numpy(x0), lower, upper)
    assert xp.dtype == torch.float64 and xp.shape == x0.shape
    assert np.all((xp.numpy() > lower) & (xp.numpy() < upper))
    scale = max(abs(float(vj)), 1e-12 if name != "dense_gp" else 1.0)
    assert abs(float(vp) - float(vj)) <= 1e-8 * scale
    np.testing.assert_allclose(xp.numpy(), np.asarray(xj), rtol=1e-6, atol=1e-6)


def test_lbfgs_box_stops_at_max_steps_and_returns_interior_points():
    calls = []

    def f(x):
        calls.append(1)
        return torch.sum((x - 2.0) ** 2)

    x, v = lbfgs_box(f, torch.zeros(3, dtype=torch.float64), np.full(3, -1.0), np.full(3, 1.0),
                     max_steps=3)
    # the minimum lies outside the box: the iterate presses against the
    # upper bound from inside
    assert torch.all(x < 1.0) and torch.all(x > 0.9)
    assert float(v) == pytest.approx(float(f(x)), rel=1e-15)
    assert len(calls) <= 3 * (1 + 20) + 2
