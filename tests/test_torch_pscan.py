"""Kalman-form GP likelihood parity: periodicity_tpu_torch.models.gp.pscan
(the SSM matrices, the small pivoted solve, the element composition, the
parallel, blocked and chunked likelihoods) and K1's plain version
(ops/kalman.py) against the JAX package and the port's sequential solver.

The same numpy draws go to both packages, the JAX side on the CPU in x64,
the port's on CPU tensors (K1's plain version). Tolerances, with their
reasons:
- SSM matrices within 1e-14 relative (exp, cos and sin of XLA and of torch
  may differ by an ulp);
- the small solve, the composition and the pscan likelihood within 1e-12
  relative of JAX (the same operations; XLA contracts multiply-adds into
  FMAs on the CPU and sums in another order); the small solve against
  ``torch.linalg.solve`` within JAX's own 1e-8 (tests/test_gp.py:326-345);
- the pscan, blocked and chunked likelihoods within JAX's 1e-10 of the
  sequential solvers in float64 (tests/test_gp.py:162-287): blocked and
  chunked compose in another order than JAX's (in exact arithmetic the
  same);
- the gradient of blocked and chunked is the sequential solver's, bit for
  bit (the port returns K1's value with the scan's gradient), held against
  ``jax.grad`` through JAX's scan within 1e-10, where JAX holds its chunked
  gradient against the same scan at 1e-6 (tests/test_gp.py:289-323; a
  ``jax.grad`` through JAX's chunked solver compiles for ~50 s on this CPU);
- a batched row equal to a one-row call bit for bit;
- float32 within twice JAX's own float32 error of float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import K1_SLOTS, k1_draw
from periodicity_tpu.models.gp import pscan as JP
from periodicity_tpu.models.gp import solver as JS
from periodicity_tpu.models.gp import terms as JT
from periodicity_tpu_torch.gp import (
    log_likelihood,
    log_likelihood_blocked,
    log_likelihood_chunked,
    log_likelihood_pscan,
)
from periodicity_tpu_torch.models.gp import pscan as PP
from periodicity_tpu_torch.models.gp import ssm_matrices
from periodicity_tpu_torch.models.gp import terms as PT
from periodicity_tpu_torch.ops import kalman as K


@pytest.fixture(autouse=True, scope="module")
def _release_jax_executables():
    """Free this module's compiled JAX executables when it ends: an xdist
    worker runs many modules in one process, and one that accumulates too
    many XLA executables can crash (pyproject.toml)."""
    yield
    jax.clear_caches()


def _T(a):
    return torch.from_numpy(np.array(a))


def _rel(got, want):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300))


# the four SHO-family terms of tests/test_gp.py::test_pscan_likelihood_matches_sequential_solver
TERMS = {
    "sho_under": lambda m: m.SHOTerm(S0=1.3, w0=2.1, Q=3.0),
    "sho_over": lambda m: m.SHOTerm(S0=0.7, w0=1.1, Q=0.01),
    "rotation": lambda m: m.RotationTerm(sigma=1.2, period=7.0, Q0=2.0, dQ=1.0, f=0.4),
    "brownian": lambda m: m.BrownianTerm(1.1, 20.0, 9.0, 0.3),
}


def _draw(seed, n, span, smooth):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, span, n))
    if smooth:
        y = np.sin(2 * np.pi * t / 9.0) + 0.1 * rng.standard_normal(n)
        return t, y - y.mean(), None
    y = rng.standard_normal(n)
    return t, y, 0.05 + 0.1 * rng.random(n)


@pytest.mark.parametrize("name", list(TERMS))
def test_ssm_matrices_match_jax(name):
    t = np.sort(np.random.default_rng(1).uniform(0, 30, 50))
    got = ssm_matrices(TERMS[name](PT), _T(t))
    want = JP.ssm_matrices(TERMS[name](JT), t)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert _rel(a, b) <= 1e-14


@pytest.mark.parametrize("Q", [3.0, 0.01])
def test_ssm_matrices_masked_slots_match_jax_traced_form(Q):
    """A Q that needs a gradient emits the masked form (both SHO branches),
    as JAX's traced Q does; the dead branch's slots are inert (a complex
    slot with d = 0 takes d_safe = 1, a real slot has zero amplitude)."""
    t = np.sort(np.random.default_rng(2).uniform(0, 30, 40))
    q = torch.tensor(Q, dtype=torch.float64, requires_grad=True)
    got = ssm_matrices(PT.SHOTerm(S0=1.3, w0=2.1, Q=q), _T(t))
    want = jax.jit(lambda q: JP.ssm_matrices(JT.SHOTerm(S0=1.3, w0=2.1, Q=q), t))(Q)
    assert got[0].shape == (40, 4, 4)
    for a, b in zip(got, want):
        assert _rel(a, b) <= 1e-14


def test_solve_small_with_row_swaps_matches_jax_and_linalg():
    """JAX's test_solve_small_matches_linalg_solve draws (tests/test_gp.py:
    326-345), plus systems whose leading diagonal is tiny, so every
    elimination swaps rows."""
    rng = np.random.default_rng(7)
    for r, k, batch in ((2, 5, 64), (4, 9, 32), (8, 17, 16)):
        A = rng.standard_normal((batch, r, r))
        Bm = rng.standard_normal((batch, r, r))
        M = np.eye(r) + (Bm @ np.swapaxes(Bm, -1, -2)) @ (A @ np.swapaxes(A, -1, -2))
        swap = rng.standard_normal((batch, r, r))
        swap[:, np.arange(r), np.arange(r)] *= 1e-3
        for MM in (M, swap):
            rhs = rng.standard_normal((batch, r, k))
            got = PP._solve_small(_T(MM), _T(rhs))
            want = jax.jit(JP._solve_small)(jnp.asarray(MM), jnp.asarray(rhs))
            assert _rel(got, want) <= 1e-12
            want = torch.linalg.solve(_T(MM), _T(rhs))
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-8, atol=1e-10)
    # the pivot is the first maximal |value|: two equal candidates take the upper
    M = np.array([[0.0, 1.0], [2.0, 1.0]])
    rhs = np.array([[1.0], [2.0]])
    assert _rel(PP._solve_small(_T(M), _T(rhs)), np.linalg.solve(M, rhs)) <= 1e-15


def _elements(term_name, n, seed):
    t, y, diag = _draw(seed, n, 20.0, smooth=False)
    jel, _, _ = JP._filter_elements(*JP.ssm_matrices(TERMS[term_name](JT), t), diag, y)
    A, Pinf, H = ssm_matrices(TERMS[term_name](PT), _T(t))
    pel, _, _ = PP._filter_elements(A, Pinf, H, _T(diag), _T(y))
    return jel, pel


@pytest.mark.parametrize("name", ["rotation", "brownian"])
def test_elements_and_combine_match_jax(name):
    jel, pel = _elements(name, 33, 3)
    for a, b in zip(pel, jel):
        assert _rel(a, b) <= 1e-13
    left, right = (slice(0, 32, 2), slice(1, 33, 2))
    got = PP._combine(tuple(x[left] for x in pel), tuple(x[right] for x in pel))
    want = jax.jit(JP._combine)(tuple(x[left] for x in jel), tuple(x[right] for x in jel))
    for a, b in zip(got, want):
        assert _rel(a, b) <= 1e-12
    # identity elements compose to the other operand; padding appends them
    ident = PP._identity_elements((16,), pel[0].shape[-1], torch.float64, torch.device("cpu"))
    for a, b in zip(PP._combine(ident, tuple(x[left] for x in pel)), pel):
        assert torch.equal(a, b[left])
    padded = PP._pad_identity(pel, 3, pel[0].shape[-1], torch.float64, torch.device("cpu"))
    jpadded = JP._pad_identity(jel, 3, jel[0].shape[-1], jnp.float64)
    for a, b in zip(padded, jpadded):
        assert a.shape == b.shape and _rel(a, b) <= 1e-13


@pytest.mark.parametrize("name", list(TERMS))
def test_pscan_matches_jax_and_the_scan(name):
    """tests/test_gp.py::test_pscan_likelihood_matches_sequential_solver's
    draw (N = 400), pscan against JAX's pscan, the port's scan and JAX's."""
    t, y, diag = _draw(7, 400, 80.0, smooth=False)
    got = float(log_likelihood_pscan(TERMS[name](PT), _T(t), _T(diag), _T(y)))
    assert got == pytest.approx(float(JP.log_likelihood_pscan(TERMS[name](JT), t, diag, y)),
                                rel=1e-12)
    assert got == pytest.approx(float(log_likelihood(TERMS[name](PT), _T(t), _T(diag), _T(y))),
                                rel=1e-10)
    assert got == pytest.approx(float(JS.log_likelihood(TERMS[name](JT), t, diag, y)), rel=1e-10)


BLOCK_TERMS = {
    "rotation": lambda m: m.RotationTerm(sigma=1.0, period=9.0, Q0=2.0, dQ=1.0, f=0.3),
    "brownian": lambda m: m.BrownianTerm(0.01, 20.0, 10.0, 0.3),
}


@pytest.fixture(scope="module")
def blocked_draw():
    """tests/test_gp.py::test_blocked_likelihood_matches_scan's draw."""
    rng = np.random.default_rng(12)
    n = 777
    t = np.sort(rng.uniform(0, 60, n))
    y = np.sin(2 * np.pi * t / 9.0) + 0.1 * rng.standard_normal(n)
    return t, y - y.mean(), np.full(n, 0.02)


@pytest.mark.parametrize("name", list(BLOCK_TERMS))
def test_blocked_matches_the_scan_at_every_block_count(name, blocked_draw):
    t, y, diag = blocked_draw
    want = float(JS.log_likelihood(BLOCK_TERMS[name](JT), t, diag, y))
    scan = float(log_likelihood(BLOCK_TERMS[name](PT), _T(t), _T(diag), _T(y)))
    assert scan == pytest.approx(want, rel=1e-12)
    for nb in (1, 3, 16, 128):
        got = float(log_likelihood_blocked(BLOCK_TERMS[name](PT), _T(t), _T(diag), _T(y),
                                           n_blocks=nb))
        assert got == pytest.approx(want, rel=1e-10), nb
    if name == "rotation":
        jb = float(JP.log_likelihood_blocked(BLOCK_TERMS[name](JT), t, diag, y, n_blocks=16))
        assert got == pytest.approx(jb, rel=1e-10)


@pytest.fixture(scope="module")
def chunked_draw():
    """tests/test_gp.py::test_chunked_likelihood_matches_scan's draw."""
    rng = np.random.default_rng(13)
    n = 1003
    t = np.sort(rng.uniform(0, 60, n))
    y = np.sin(2 * np.pi * t / 9.0) + 0.1 * rng.standard_normal(n)
    return t, y - y.mean(), np.full(n, 0.02)


@pytest.mark.parametrize("name,chunk,inner", [("rotation", 256, 64), ("brownian", 100, 7)])
def test_chunked_matches_jax_and_the_scan(name, chunk, inner, chunked_draw):
    """JAX's two geometries at N = 1003 (identity padding of the last chunk
    in JAX; a shorter last chunk here)."""
    t, y, diag = chunked_draw
    got = float(log_likelihood_chunked(BLOCK_TERMS[name](PT), _T(t), _T(diag), _T(y),
                                       chunk=chunk, inner_blocks=inner))
    assert got == pytest.approx(float(JS.log_likelihood(BLOCK_TERMS[name](JT), t, diag, y)),
                                rel=1e-10)
    assert got == pytest.approx(float(log_likelihood(BLOCK_TERMS[name](PT), _T(t), _T(diag),
                                                     _T(y))), rel=1e-10)
    if name == "brownian":
        want = float(JP.log_likelihood_chunked(BLOCK_TERMS[name](JT), t, diag, y, chunk=chunk,
                                               inner_blocks=inner))
        assert got == pytest.approx(want, rel=1e-10)


def test_chunk_geometry_and_validation(chunked_draw):
    """JAX's geometry: inner = min(inner, chunk, N); chunk = max((min(chunk,
    N) // inner) * inner, inner); non-positive sizes raise."""
    t, y, diag = chunked_draw
    term = BLOCK_TERMS["brownian"](PT)
    want = float(log_likelihood(term, _T(t), _T(diag), _T(y)))
    for chunk, inner in ((5000, 512), (1003, 1003), (3, 2), (1, 1000)):
        got = float(log_likelihood_chunked(term, _T(t[:300]), _T(diag[:300]), _T(y[:300]),
                                           chunk=chunk, inner_blocks=inner))
        assert got == pytest.approx(float(log_likelihood(term, _T(t[:300]), _T(diag[:300]),
                                                         _T(y[:300]))), rel=1e-10)
    assert want < 0
    for kw in (dict(chunk=0), dict(inner_blocks=0), dict(chunk=-5)):
        with pytest.raises(ValueError, match="positive"):
            log_likelihood_chunked(term, _T(t), _T(diag), _T(y), **kw)
    with pytest.raises(ValueError, match="positive"):
        log_likelihood_blocked(term, _T(t), _T(diag), _T(y), n_blocks=0)


def test_batched_rows_equal_one_row_calls(chunked_draw):
    """Walker batches: each row of a batched call equals a one-row call of
    the same (masked) form, bit for bit, for pscan, blocked and chunked."""
    t, y, diag = chunked_draw
    t, y, diag = t[:200], y[:200], diag[:200]
    p = np.array([[0.01, 20.0, 10.0, 0.3], [0.011, 22.0, 9.0, 0.33], [0.009, 18.0, 11.0, 0.27]])

    def term(rows):
        return PT.BrownianTerm(*(_T(rows[:, i]) for i in range(4)))

    calls = {
        "pscan": lambda tm: log_likelihood_pscan(tm, _T(t), _T(diag), _T(y)),
        "blocked": lambda tm: log_likelihood_blocked(tm, _T(t), _T(diag), _T(y), n_blocks=9),
        "chunked": lambda tm: log_likelihood_chunked(tm, _T(t), _T(diag), _T(y), chunk=64,
                                                     inner_blocks=5),
    }
    for name, call in calls.items():
        batched = call(term(p))
        assert batched.shape == (3,)
        for i in range(3):
            one = call(term(p[i:i + 1]))
            assert torch.equal(batched[i:i + 1], one), name


def test_gradient_of_blocked_and_chunked_is_the_scans():
    """tests/test_gp.py::test_chunked_likelihood_grad_and_vmap's draw: the
    gradient through blocked and chunked is K1's own, through K2 (the
    chunks reversed, the carry's cotangent handed back), within JAX's 1e-6
    of the scan's and within 1e-8 of jax.grad through JAX's blocked and
    chunked solvers at the same geometry; a walker batch of chunked values
    equals JAX's scan per walker within JAX's 1e-8."""
    rng = np.random.default_rng(14)
    n = 800
    t = np.sort(rng.uniform(0, 100, n))
    y = np.sin(2 * np.pi * t / 20.0) + 0.05 * rng.standard_normal(n)
    y = y - y.mean()
    diag = np.full(n, 0.01)
    p0 = np.array([0.01, 20.0, 10.0, 0.3])
    g_jax = {name: np.asarray(jax.grad(lambda p, fn=fn: fn(
        JT.BrownianTerm(p[0], p[1], p[2], p[3]), t, diag, y))(jnp.asarray(p0)))
        for name, fn in (("blocked", lambda *a: JP.log_likelihood_blocked(*a, n_blocks=16)),
                         ("chunked", lambda *a: JP.log_likelihood_chunked(
                             *a, chunk=256, inner_blocks=64)))}
    grads = {}
    for name, fn in (("scan", log_likelihood),
                     ("blocked", lambda *a: log_likelihood_blocked(*a, n_blocks=16)),
                     ("chunked", lambda *a: log_likelihood_chunked(*a, chunk=256,
                                                                   inner_blocks=64))):
        p = _T(p0).requires_grad_(True)
        ll = fn(PT.BrownianTerm(p[0], p[1], p[2], p[3]), _T(t), _T(diag), _T(y))
        (grads[name],) = torch.autograd.grad(ll, p)
    for name in ("blocked", "chunked"):
        np.testing.assert_allclose(grads[name].numpy(), grads["scan"].numpy(), rtol=1e-6)
        np.testing.assert_allclose(grads[name].numpy(), g_jax[name], rtol=1e-8)
    pv = np.stack([p0, p0 * 1.1, p0 * 0.9])
    lls = log_likelihood_chunked(PT.BrownianTerm(*(_T(pv[:, i]) for i in range(4))), _T(t),
                                 _T(diag), _T(y), chunk=256, inner_blocks=64)
    want = [float(JS.log_likelihood(JT.BrownianTerm(*pi), t, diag, y)) for pi in pv]
    np.testing.assert_allclose(lls.numpy(), want, rtol=1e-8)
    # without an input that needs a gradient, the value is K1's alone
    with torch.no_grad():
        assert log_likelihood_chunked(PT.BrownianTerm(*p0), _T(t), _T(diag), _T(y),
                                      chunk=256, inner_blocks=64).grad_fn is None


def _eager_composition(A, Q, H, diag, y, carry):
    """K1's outputs from the eager torch composition (pscan._combine) of the
    same elements, one position at a time."""
    b, n, r, _ = A.shape
    elems = PP._elements_from_AQ(A, Q, H, diag, y)
    run = carry
    mu, s = [], []
    for k in range(n):
        Ak, Qk = A[:, k], Q[:, k]
        mu.append(torch.einsum("i,bi->b", H, torch.einsum("bij,bj->bi", Ak, run[1])))
        P = Ak @ run[2] @ Ak.transpose(-1, -2) + Qk
        s.append(torch.einsum("i,bij,j->b", H, P, H) + diag[:, k])
        run = PP._combine(run, tuple(e[:, k] for e in elems))
    return torch.stack(mu, 1), torch.stack(s, 1), run


@pytest.mark.parametrize("r", [1, 4, 8])
def test_k1_plain_matches_an_eager_composition(r):
    """K1's plain version (blocks composed to summaries, the summaries from
    a carry, each block again from its exclusive carry) against the eager
    element-by-element composition: mu, s and the outgoing carry within
    1e-12, at block counts that divide N and that do not, from the identity
    and from a carry."""
    rng = np.random.default_rng(r)
    coeffs, dt, A, Q, H, diag, y = k1_draw(rng, r, 2, 37, torch.float64)
    ident = PP._identity_elements((2,), r, torch.float64, torch.device("cpu"))
    _, _, carry = K.kalman_blocked_plain(A, Q, H, diag, y, 4)
    A2 = PP._ssm_from_dt(coeffs, dt)[0]
    Q2 = PP._noise(A2, PP._ssm_from_dt(coeffs, dt)[1])
    for args, start in (((A, Q, H, diag, y), None), ((A2, Q2, H, diag, y), carry)):
        want = _eager_composition(*args, ident if start is None else start)
        for nb in (1, 5, 37, 50):
            mu, s, out = K.kalman_blocked_plain(*args, nb, start)
            assert _rel(mu, want[0]) <= 1e-12 and _rel(s, want[1]) <= 1e-12
            for a, b in zip(out, want[2]):
                assert _rel(a, b) <= 1e-12
    assert K1_SLOTS[r][0] + 2 * K1_SLOTS[r][1] == r


def test_k1_wrapper_checks_and_takes_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(3)
    _, _, A, Q, H, diag, y = k1_draw(rng, 2, 1, 10, torch.float64)
    got = K.kalman_blocked(A, Q, H, diag, y, 3)
    want = K.kalman_blocked_plain(A, Q, H, diag, y, 3)
    before = K.kalman_blocked.launches
    for a, b in zip((got[0], got[1], *got[2]), (want[0], want[1], *want[2])):
        assert torch.equal(a, b)
    assert K.kalman_blocked.launches == before
    with pytest.raises(ValueError, match="n_blocks"):
        K.kalman_blocked(A, Q, H, diag, y, 0)
    packed = K.pack_carry(got[2])
    assert packed.shape == (1, K.state_size(2))
    for a, b in zip(K.unpack_carry(packed, 2), got[2]):
        assert torch.equal(a, b)


def test_float32_within_twice_jax_float32_error(blocked_draw):
    """Float32 pscan, blocked and chunked within twice JAX's own float32
    error (its scan's, which JAX characterizes) of the float64 likelihood, for
    tests/test_gp.py's float32 RotationTerm (float32 hyperparameters: JAX's
    scan refuses a term of numbers with float32 data under x64)."""
    t, y, diag = blocked_draw
    f32 = [a.astype(np.float32) for a in (t, diag, y)]
    p64 = np.array([1.0, 9.0, 2.0, 1.0, 0.3])
    p32 = p64.astype(np.float32)

    def rot(m, p):
        return m.RotationTerm(sigma=p[0], period=p[1], Q0=p[2], dQ=p[3], f=p[4])

    def jax_ll(fn, p, *data):
        return fn(rot(JT, p), *data)

    j64 = float(JS.log_likelihood(rot(JT, p64), t, diag, y))
    j32 = float(jax.jit(lambda p, *d: jax_ll(JS.log_likelihood, p, *d))(p32, *f32))
    err = max(abs(j32 - j64), 1e-7 * abs(j64))
    term = rot(PT, [torch.tensor(v) for v in p32])
    data = [_T(a) for a in f32]
    for fn in (log_likelihood_pscan, lambda *a: log_likelihood_blocked(*a, n_blocks=16),
               lambda *a: log_likelihood_chunked(*a, chunk=256, inner_blocks=64)):
        ll = fn(term, *data)
        assert ll.dtype == torch.float32
        assert abs(float(ll) - j64) <= 2 * err
