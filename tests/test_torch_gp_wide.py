"""GP terms wider than 8 slots: the port against the JAX package on the CPU.

A masked RotationTerm already has R = 8 slots, so the standard stellar
variability model (a RotationTerm plus an SHOTerm for granulation) is R = 10
with the SHO's Q a number (live) and R = 12 with it a tensor (masked, as a
gradient or a batch axis makes it); two masked RotationTerms are R = 16.
The JAX package takes any width; on the card the port's kernels take up to
16 (test_torch_gpu.py holds them bit-equal to their plain versions there).
Here the same numpy parameters build both packages' terms, the JAX side in
x64, the port's on CPU tensors (the plain versions). Tolerances are
tests/test_torch_gp.py's and tests/test_torch_pscan.py's, with their
reasons: the log-likelihood within 1e-12 relative of JAX, its gradient
within 1e-10 of ``jax.grad``, ``predict`` within 1e-11 of the largest
value, the blocked likelihood within JAX's 1e-10 of its scan.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from periodicity_tpu.models.gp import solver as JS
from periodicity_tpu.models.gp import terms as JT
from periodicity_tpu_torch.gp import log_likelihood_blocked
from periodicity_tpu_torch.models.gp import solver as PS
from periodicity_tpu_torch.models.gp import terms as PT


@pytest.fixture(autouse=True, scope="module")
def _release_jax_executables():
    yield
    jax.clear_caches()


def _T(a):
    return torch.from_numpy(np.array(a))


# term from a parameter vector p (a jax array or a torch tensor) and
# module m; the port's width R with p a tensor that needs a gradient
WIDE = {
    10: (lambda m, p: m.RotationTerm(sigma=p[0], period=p[1], Q0=p[2], dQ=p[3], f=p[4])
         + m.SHOTerm(S0=p[5], w0=p[6], Q=1 / np.sqrt(2)),
         [1.2, 7.0, 2.0, 1.0, 0.4, 0.3, 2.5]),
    12: (lambda m, p: m.RotationTerm(sigma=p[0], period=p[1], Q0=p[2], dQ=p[3], f=p[4])
         + m.SHOTerm(S0=p[5], w0=p[6], Q=p[7]),
         [1.2, 7.0, 2.0, 1.0, 0.4, 0.3, 2.5, 1 / np.sqrt(2)]),
    16: (lambda m, p: m.RotationTerm(sigma=p[0], period=p[1], Q0=p[2], dQ=p[3], f=p[4])
         + m.RotationTerm(sigma=p[5], period=p[6], Q0=p[7], dQ=p[8], f=p[9]),
         [1.2, 7.0, 2.0, 1.0, 0.4, 0.5, 2.3, 0.3, 0.2, 0.6]),
}


@pytest.fixture(scope="module")
def series():
    rng = np.random.default_rng(16)
    n = 240
    t = np.sort(rng.uniform(0, 50, n))
    y = np.sin(2 * np.pi * t / 7.0) + 0.3 * rng.standard_normal(n)
    diag = 0.05 + 0.1 * rng.random(n)
    return t, y - y.mean(), diag


def _width(term):
    ar, _, ac, *_ = term.coefficients()
    return ar.shape[-1] + 2 * ac.shape[-1]


@pytest.fixture(scope="module")
def jax_ll(series):
    """JAX's log-likelihood and gradient at each width, compiled once."""
    t, y, diag = series
    cache = {}

    def get(r):
        if r not in cache:
            make, p0 = WIDE[r]
            cache[r] = jax.jit(jax.value_and_grad(
                lambda p: JS.log_likelihood(make(JT, p), t, diag, y)))(jnp.asarray(p0))
        return cache[r]

    return get


@pytest.mark.parametrize("r", sorted(WIDE))
def test_wide_log_likelihood_and_gradient_match_jax(r, series, jax_ll):
    t, y, diag = series
    make, p0 = WIDE[r]
    want_ll, want = jax_ll(r)
    p = _T(p0).requires_grad_(True)
    term = make(PT, p)
    assert _width(term) == r
    ll = PS.log_likelihood(term, _T(t), _T(diag), _T(y))
    (got,) = torch.autograd.grad(ll, p)
    assert float(ll.detach()) == pytest.approx(float(want_ll), rel=1e-12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=0)


@pytest.mark.parametrize("r", sorted(WIDE))
def test_wide_predict_matches_jax(r, series):
    t, y, diag = series
    make, p0 = WIDE[r]
    tn = np.linspace(-1, 52, 30)

    def jax_gp(p):
        gj = JS.GaussianProcess(make(JT, p), mean=0.1).compute(t, diag=diag)
        return gj.predict(y, t=tn, return_var=True)

    mu_j, var_j = jax.jit(jax_gp)(jnp.asarray(p0))
    # a tensor that needs a gradient keeps the port's terms in their masked
    # (wide) form, as JAX's traced ones are
    term = make(PT, _T(p0).requires_grad_(True))
    assert _width(term) == r
    gp = PS.GaussianProcess(term, mean=0.1).compute(_T(t), diag=_T(diag))
    mu_p, var_p = (x.detach() for x in gp.predict(_T(y), t=_T(tn), return_var=True))
    for a, b in ((mu_p, mu_j), (var_p, var_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-11 * float(np.abs(np.asarray(b)).max()))


@pytest.mark.parametrize("r", sorted(WIDE))
def test_wide_blocked_matches_jax_scan(r, series, jax_ll):
    t, y, diag = series
    make, p0 = WIDE[r]
    want = float(jax_ll(r)[0])
    term = make(PT, _T(p0).requires_grad_(True))
    assert _width(term) == r
    for nb in (5, 16):
        got = float(log_likelihood_blocked(term, _T(t), _T(diag), _T(y), n_blocks=nb).detach())
        assert got == pytest.approx(want, rel=1e-10), nb
