"""GP solver parity: periodicity_tpu_torch.models.gp (terms, celerite
matrices, the plain recursions, the likelihood and its gradient,
GaussianProcess) against the JAX package and a dense solve.

The same numpy draws go to both packages, the JAX side on the CPU in x64,
the port's through its plain versions (CPU tensors). Tolerances, with
their reasons:
- coefficients of the same hyperparameters: bit for bit (the same
  correctly rounded operations in the same order);
- float64 results against JAX within 1e-12 relative (the recursions'
  R-term sums and the final sums over N run in another order than XLA's
  dots and reductions); against a dense slogdet/solve within 1e-9, as
  tests/test_gp.py holds the JAX solver;
- gradients within 1e-10 relative (the adjoint sweep and jax.grad sum in
  different orders, and random U, V make K ill-conditioned);
- float32 within twice JAX's own float32 error of float64 (XLA contracts
  multiply-adds into FMAs on the CPU, the port does not);
- the live and the masked forms of a term, and a batched row against a 1-D
  call: bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from periodicity_tpu.models.gp import solver as JS
from periodicity_tpu.models.gp import terms as JT
from periodicity_tpu_torch.core import from_jax
from periodicity_tpu_torch.models.gp import solver as PS
from periodicity_tpu_torch.models.gp import terms as PT
from periodicity_tpu_torch.ops import celerite as C


@pytest.fixture(autouse=True, scope="module")
def _release_jax_executables():
    """Free this module's compiled JAX executables when it ends: an xdist
    worker runs many modules in one process, and one that accumulates too
    many XLA executables can crash (pyproject.toml)."""
    yield
    jax.clear_caches()


def _T(a):
    return torch.from_numpy(np.array(a))


# the five terms of tests/test_gp.py::test_celerite_solver_matches_dense_cholesky
TERMS = {
    "sho_under": lambda m: m.SHOTerm(S0=1.3, w0=2.1, Q=3.0),
    "sho_over": lambda m: m.SHOTerm(S0=0.7, w0=1.1, Q=0.01),
    "rotation": lambda m: m.RotationTerm(sigma=1.2, period=7.0, Q0=2.0, dQ=1.0, f=0.4),
    "brownian": lambda m: m.BrownianTerm(1.1, 20.0, 9.0, 0.3),
    "sum": lambda m: m.SHOTerm(S0=1.0, w0=1.0, Q=4.0) + m.SHOTerm(S0=0.5, w0=0.3, Q=0.2),
}


@pytest.fixture(scope="module")
def series():
    rng = np.random.default_rng(0)
    n = 257
    t = np.sort(rng.uniform(0, 50, n))
    y = rng.standard_normal(n)
    diag = 0.05 + 0.1 * rng.random(n)
    return t, y, diag


@pytest.mark.parametrize("name", list(TERMS))
def test_coefficients_bit_equal(name):
    make = TERMS[name]
    got = [c.numpy() for c in make(PT).coefficients()]
    want = [np.asarray(c) for c in make(JT).coefficients()]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# each term from positional hyperparameters, and values for them
BUILD = {
    "sho_under": (lambda m, S0, w0, Q: m.SHOTerm(S0=S0, w0=w0, Q=Q), (1.3, 2.1, 3.0)),
    "sho_over": (lambda m, S0, w0, Q: m.SHOTerm(S0=S0, w0=w0, Q=Q), (0.7, 1.1, 0.01)),
    "brownian": (lambda m, *p: m.BrownianTerm(*p), (1.1, 20.0, 9.0, 0.3)),
    "rotation": (lambda m, s, p, q0, dq, f: m.RotationTerm(sigma=s, period=p, Q0=q0, dQ=dq, f=f),
                 (1.2, 7.0, 2.0, 1.0, 0.4)),
}


@pytest.mark.parametrize("name", list(BUILD))
def test_masked_coefficients_match_jax_traced_form(name):
    """With a gradient to carry, an SHO emits both branches select-masked,
    as JAX does with its hyperparameters traced. Under jit JAX traces even
    BrownianTerm's background Q = 0.01, a number, and masks that SHO too;
    the port keeps it live (R = 6, not 8), so its dead complex slot is
    dropped from JAX's before the comparison. Within 1e-14: XLA may
    contract a multiply-add under jit."""
    build, values = BUILD[name]
    want = jax.jit(lambda *p: build(JT, *p).coefficients())(*values)
    if name == "brownian":
        want = list(want[:2]) + [c[:1] for c in want[2:]]
    params = [torch.tensor(v, dtype=torch.float64, requires_grad=True) for v in values]
    got = build(PT, *params).coefficients()
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-14, atol=0)


def test_value_psd_k0_match_jax():
    tau = np.linspace(-12, 12, 61)
    w = np.linspace(0.01, 5, 50)
    for make in TERMS.values():
        pt = make(PT)
        value, psd, k0 = jax.jit(lambda: (make(JT).get_value(tau), make(JT).get_psd(w),
                                          make(JT).k0()))()
        np.testing.assert_allclose(pt.get_value(_T(tau)).numpy(), np.asarray(value),
                                   rtol=1e-13, atol=1e-15)
        np.testing.assert_allclose(pt.get_psd(_T(w)).numpy(), np.asarray(psd), rtol=1e-13,
                                   atol=0)
        assert float(pt.k0()) == pytest.approx(float(k0), rel=1e-15)


def test_batched_terms_broadcast_over_walkers():
    """A batch axis on the period (hence on Q) gives masked [B, k]
    coefficients whose rows equal the 1-D masked terms', and values and PSDs
    [B, ...]; a batch axis only on sigma leaves Q a number: live slots."""
    period = torch.tensor([9.0, 4.5, 17.0], dtype=torch.float64)
    batched = PT.BrownianTerm(1.1, 20.0, period, 0.3)
    assert batched.coefficients()[0].shape == (3, 4)
    for i in range(3):
        row = PT.BrownianTerm(1.1, 20.0, period[i].clone().requires_grad_(True), 0.3)
        for a, b in zip(batched.coefficients(), row.coefficients()):
            assert torch.equal(a[i], b.detach())
    sig_only = PT.BrownianTerm(torch.tensor([1.1, 0.7], dtype=torch.float64), 20.0, 9.0, 0.3)
    assert sig_only.coefficients()[0].shape == (2, 2)
    tau = _T(np.linspace(0, 5, 7))
    w = _T(np.linspace(0.1, 2, 5))
    assert batched.get_value(tau).shape == (3, 7)
    assert batched.get_psd(w).shape == (3, 5)
    for i in range(3):
        one = PT.BrownianTerm(1.1, 20.0, float(period[i]), 0.3)
        np.testing.assert_allclose(batched.get_psd(w)[i].numpy(), one.get_psd(w).numpy(),
                                   rtol=1e-14)
        np.testing.assert_allclose(batched.get_value(tau)[i].numpy(),
                                   one.get_value(tau).numpy(), rtol=1e-14)


@pytest.mark.parametrize("name", list(TERMS))
def test_celerite_matrices_match_jax(name, series):
    t, _, diag = series
    make = TERMS[name]
    got = PS.celerite_matrices(make(PT), _T(t), _T(diag))
    want = JS.celerite_matrices(make(JT), t, diag)
    for a, b in zip(got, want):
        assert a.shape == np.shape(b)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-13, atol=1e-15)


@pytest.mark.parametrize("name", list(TERMS))
def test_log_likelihood_matches_jax_and_dense(name, series):
    t, y, diag = series
    make = TERMS[name]
    got = float(PS.log_likelihood(make(PT), _T(t), _T(diag), _T(y)))
    want = float(jax.jit(lambda: JS.log_likelihood(make(JT), t, diag, y))())
    assert got == pytest.approx(want, rel=1e-12)
    gp = PS.GaussianProcess(make(PT)).compute(_T(t), diag=_T(diag))
    K = gp.dense_cov().numpy()
    _, logdet = np.linalg.slogdet(K)
    n = t.size
    dense = -0.5 * (y @ np.linalg.solve(K, y) + logdet + n * np.log(2 * np.pi))
    assert got == pytest.approx(dense, rel=1e-9)


@pytest.mark.parametrize("name", ["sho_over", "rotation", "sum"])
def test_factor_and_solve_match_jax(name, series):
    t, _, diag = series
    make = TERMS[name]
    A, U, V, P = PS.celerite_matrices(make(PT), _T(t), _T(diag))
    D, W = PS.celerite_factor(A, U, V, P)
    rng = np.random.default_rng(5)
    Y = rng.standard_normal((t.size, 3))

    def jax_factor_solve():
        Aj, Uj, Vj, Pj = JS.celerite_matrices(make(JT), t, diag)
        Dj, Wj = JS.celerite_factor(Aj, Uj, Vj, Pj)
        return Dj, Wj, JS.celerite_solve(Uj, Pj, Dj, Wj, jnp.asarray(Y))

    # under jit the JAX term takes its masked form, whose W has more
    # columns; D and the solution (which reads W) are the same in both forms
    Dj, _, xj = jax.jit(jax_factor_solve)()
    np.testing.assert_allclose(D.numpy(), np.asarray(Dj), rtol=1e-12)
    x = C.celerite_solve(U, P, D, W, _T(Y))
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=0,
                               atol=1e-12 * float(np.abs(np.asarray(xj)).max()))
    x1 = C.celerite_solve(U, P, D, W, _T(Y[:, 0]))
    assert torch.equal(x1, x[:, 0])


def _forward_torch(A, U, V, P, y):
    """The fused recursion in differentiable torch (JAX's formulas), for
    autograd to differentiate through the loop."""
    b, n, r = U.shape
    d_prev = A[:, 0]
    w_prev = V[:, 0] / d_prev[:, None]
    S = torch.zeros((b, r, r), dtype=U.dtype)
    f = torch.zeros((b, r), dtype=U.dtype)
    z_prev = y[:, 0]
    Ds, zs = [d_prev], [z_prev]
    for i in range(1, n):
        p = P[:, i - 1]
        S = (p[:, :, None] * p[:, None, :]) * (
            S + d_prev[:, None, None] * (w_prev[:, :, None] * w_prev[:, None, :]))
        su = torch.einsum("bij,bj->bi", S, U[:, i])
        d = A[:, i] - (U[:, i] * su).sum(-1)
        w = (V[:, i] - su) / d[:, None]
        f = p * (f + w_prev * z_prev[:, None])
        z_prev = y[:, i] - (U[:, i] * f).sum(-1)
        Ds.append(d)
        zs.append(z_prev)
        d_prev, w_prev = d, w
    return torch.stack(Ds, 1), torch.stack(zs, 1)


@pytest.mark.parametrize("r,n", [(1, 5), (2, 2), (4, 30), (6, 41), (8, 17)])
def test_adjoint_matches_autograd_through_the_loop(r, n):
    rng = np.random.default_rng(r * 100 + n)
    b = 3
    ins = [_T(rng.uniform(2, 4, (b, n))), _T(0.3 * rng.standard_normal((b, n, r))),
           _T(0.3 * rng.standard_normal((b, n, r))), _T(rng.uniform(0.5, 1, (b, n - 1, r))),
           _T(rng.standard_normal((b, n)))]
    dD, dz = _T(rng.standard_normal((b, n))), _T(rng.standard_normal((b, n)))
    leaves = [x.clone().requires_grad_(True) for x in ins]
    D, z = _forward_torch(*leaves)
    want = torch.autograd.grad((D * dD).sum() + (z * dz).sum(), leaves)
    D2, W2, z2, S_saved, f_saved = C.celerite_forward_plain(*ins, save=True)
    np.testing.assert_allclose(D2.numpy(), D.detach().numpy(), rtol=1e-13)
    got = C.celerite_adjoint_plain(ins[1], ins[3], D2, W2, z2, S_saved, f_saved, dD, dz)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-10 * float(w.abs().max()))


def test_likelihood_gradient_matches_jax(series):
    t, y, diag = series
    n = 120
    t, y, diag = t[:n], y[:n], diag[:n]

    def jax_ll(p):
        term = JT.SHOTerm(S0=p[0], w0=p[1], Q=p[2])
        return JS.log_likelihood(term, t, diag + p[3], y - p[4])

    p0 = np.array([1.1, 2.0, 3.0, 0.01, 0.2])
    want_ll, want = jax.jit(jax.value_and_grad(jax_ll))(jnp.asarray(p0))
    p = _T(p0).requires_grad_(True)
    term = PT.SHOTerm(S0=p[0], w0=p[1], Q=p[2])
    ll = PS.log_likelihood(term, _T(t), _T(diag) + p[3], _T(y) - p[4])
    (got,) = torch.autograd.grad(ll, p)
    assert float(ll.detach()) == pytest.approx(float(want_ll), rel=1e-12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=0)


def test_live_and_masked_forms_give_the_same_bits(series):
    """Dead slots have zero U columns and add exact zeros: the live form
    (a number or a 0-d tensor without grad) and the masked form (a gradient
    to carry, or a batch axis) give the same log-likelihood bit for bit."""
    t, y, diag = series
    args = (_T(t), _T(diag), _T(y))
    for live, masked, batched in [
        (PT.BrownianTerm(1.1, 20.0, 9.0, 0.3),
         PT.BrownianTerm(1.1, torch.tensor(20.0, dtype=torch.float64, requires_grad=True),
                         9.0, 0.3),
         PT.BrownianTerm(1.1, torch.tensor([20.0], dtype=torch.float64), 9.0, 0.3)),
        (PT.RotationTerm(sigma=1.2, period=7.0, Q0=2.0, dQ=1.0, f=0.4),
         PT.RotationTerm(sigma=1.2, period=7.0, Q0=torch.tensor(2.0, dtype=torch.float64,
                                                                requires_grad=True),
                         dQ=1.0, f=0.4),
         PT.RotationTerm(sigma=1.2, period=torch.tensor([7.0], dtype=torch.float64),
                         Q0=2.0, dQ=1.0, f=0.4)),
    ]:
        r_live = live.coefficients()[0].shape[-1] + 2 * live.coefficients()[2].shape[-1]
        r_masked = masked.coefficients()[0].shape[-1] + 2 * masked.coefficients()[2].shape[-1]
        assert r_masked > r_live
        a = PS.log_likelihood(live, *args)
        b = PS.log_likelihood(masked, *args).detach()
        c = PS.log_likelihood(batched, *args)
        assert torch.equal(a, b) and torch.equal(a.reshape(1), c)


def test_batched_rows_equal_one_dimensional_calls(series):
    t, y, diag = series
    sig = _T([0.8, 1.1, 1.7, 2.2])
    ys = np.stack([y, 0.5 * y, -y, y + 0.1])
    ll = PS.log_likelihood(PT.BrownianTerm(sig, 20.0, 9.0, 0.3), _T(t), _T(diag), _T(ys))
    assert ll.shape == (4,)
    for i in range(4):
        one = PS.log_likelihood(PT.BrownianTerm(sig[i].clone().requires_grad_(True), 20.0, 9.0,
                                                0.3), _T(t), _T(diag), _T(ys[i]))
        assert torch.equal(ll[i], one.detach())


def test_log_likelihood_float32_within_twice_jax_float32_error(series):
    """Float32 within twice JAX's own float32 error of float64, for a term
    of float32 tensors and for a term of numbers: a term's coefficients
    take the times' float32 (a term of numbers rounds its float64
    coefficients once, as JAX's weakly typed numbers take float32 data's
    dtype; JAX's scan refuses numbers with float32 data under x64, so its
    error comes from float32 hyperparameters). A float64 tensor among the
    hyperparameters is cast too: the times set the dtype."""
    t, y, diag = series
    f32 = [a.astype(np.float32) for a in (t, diag, y)]
    args32 = dict(S0=np.float32(1.3), w0=np.float32(2.1), Q=np.float32(3.0))

    def jax_ll(S0, w0, Q, *data):
        return JS.log_likelihood(JT.SHOTerm(S0=S0, w0=w0, Q=Q), *data)

    j64 = float(jax.jit(jax_ll)(1.3, 2.1, 3.0, t, diag, y))
    j32 = float(jax.jit(jax_ll)(*args32.values(), *f32))
    numbers = PT.SHOTerm(S0=1.3, w0=2.1, Q=3.0)
    p64 = float(PS.log_likelihood(numbers, _T(t), _T(diag), _T(y)))
    for term in (PT.SHOTerm(**{k: torch.tensor(v) for k, v in args32.items()}), numbers):
        ll32 = PS.log_likelihood(term, *(_T(a) for a in f32))
        assert ll32.dtype == torch.float32
        assert abs(float(ll32) - p64) <= 2 * max(abs(j32 - j64), 1e-7 * abs(j64))
    assert numbers.get_value(_T(f32[0][:5])).dtype == torch.float32
    assert numbers.get_psd(_T(f32[0][:5])).dtype == torch.float32
    cast = PS.log_likelihood(PT.SHOTerm(S0=torch.tensor(1.3, dtype=torch.float64), w0=2.1, Q=3.0),
                             *(_T(a) for a in f32))
    assert cast.dtype == torch.float32


def test_arrays_go_to_the_card_and_the_card_stays_on_it(series):
    """Arrays with no device go to the card (here: raise, there is none);
    a term's CPU coefficients follow the times to their device; a term on
    another device than the CPU never comes to the CPU's times. The meta
    device stands in for the card."""
    t, y, diag = series
    term = PT.SHOTerm(S0=1.3, w0=2.1, Q=3.0)
    for call in (lambda: PS.celerite_matrices(term, t, diag),
                 lambda: PS.log_likelihood(term, t, diag, y),
                 lambda: PS.GaussianProcess(term).compute(t, diag=diag),
                 lambda: term.get_value(t), lambda: term.get_psd(t),
                 lambda: PT.SHOTerm(S0=torch.tensor(1.3), w0=2.1, Q=3.0).get_psd(t)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    meta = torch.empty(len(t), dtype=torch.float64, device="meta")
    for held in (term, PT.BrownianTerm(_T([1.1, 0.7]), 20.0, 9.0, 0.3)):
        assert all(m.device.type == "meta" for m in PS.celerite_matrices(held, meta, meta))
    on_meta = PT.SHOTerm(S0=1.3, w0=2.1, Q=torch.tensor([3.0], device="meta"))  # masked
    for call in (lambda: PS.celerite_matrices(on_meta, _T(t), _T(diag)),
                 lambda: on_meta.get_value(_T(t)), lambda: on_meta.get_psd(_T(t))):
        with pytest.raises(ValueError, match="move one of them"):
            call()
    with pytest.raises(ValueError, match="expected a tensor on cpu"):
        PS.log_likelihood(term, _T(t), _T(diag), meta)


def test_gaussian_process_predict_matches_jax(series):
    t, y, diag = series
    tn = np.linspace(-1, 52, 40)
    for name in ("rotation",):
        make = TERMS[name]
        def jax_gp():
            gj = JS.GaussianProcess(make(JT), mean=0.1).compute(t, diag=diag)
            return gj.predict(y, t=tn, return_var=True), gj.log_likelihood(y)

        (mu_j, var_j), ll_j = jax.jit(jax_gp)()
        gp = PS.GaussianProcess(make(PT), mean=0.1).compute(_T(t), diag=_T(diag))
        mu_p, var_p = gp.predict(_T(y), t=_T(tn), return_var=True)
        np.testing.assert_allclose(mu_p.numpy(), np.asarray(mu_j), rtol=0,
                                   atol=1e-11 * float(np.abs(np.asarray(mu_j)).max()))
        np.testing.assert_allclose(var_p.numpy(), np.asarray(var_j), rtol=0,
                                   atol=1e-11 * float(np.abs(np.asarray(var_j)).max()))
        mean_only = gp.predict(_T(y), t=_T(tn))
        np.testing.assert_allclose(mean_only.numpy(), mu_p.numpy(), rtol=1e-12, atol=1e-14)
        assert float(gp.log_likelihood(_T(y))) == pytest.approx(float(ll_j), rel=1e-12)


@pytest.mark.parametrize("name", list(TERMS))
def test_from_jax_terms(name):
    jt = TERMS[name](JT)
    pt = from_jax(jt, device="cpu")
    assert type(pt).__name__ == type(jt).__name__
    for a, b in zip(pt.coefficients(), jt.coefficients()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

