"""K2, the adjoint of the blocked Kalman composition (K1), on the CPU.

``kalman_blocked_adjoint_plain`` (the plain version the card's kernel is
held to bit for bit) against autograd through the port's eager
composition (``pscan._combine`` one position at a time, as
``tests/test_torch_pscan.py::_eager_composition`` builds it) at R = 1, 2,
4, 6, 12 and 16, over 1, 3 and 16 blocks (N divisible by the block count,
not, and below it), from the identity and from a carry, with and without
a cotangent on the outgoing carry; and the routing: a gradient goes
through ``KalmanBlocked`` and K2, never through the sequential solver.
(The blocked and chunked gradients against ``jax.grad`` through the JAX
package's blocked and chunked likelihoods and against the scan's are
``tests/test_torch_pscan.py::test_gradient_of_blocked_and_chunked_is_the_scans``.)

The eager and the blocked compositions are the same function wherever C,
J and Q are symmetric, as every element the likelihood forms is; off that
set they differ, so the cotangents of Q and of the carry's C and J are
compared symmetrized (the likelihood's own gradient only ever reads that
part, since Q(theta) is symmetric).
"""

import numpy as np
import pytest
import torch

from chip_smoke import k1_draw
from periodicity_tpu_torch.models.gp import pscan as PP
from periodicity_tpu_torch.ops import kalman as K

# (rows, N, blocks): one block; three, N not divisible; sixteen, N divisible;
# N below the block count. Past R = 8 the case's counterpart in SHAPES_WIDE,
# one row and a shorter series (the eager reference steps through autograd
# a position at a time).
SHAPES = [(2, 12, 1), (2, 13, 3), (1, 32, 16), (2, 5, 16)]
SHAPES_WIDE = [(1, 6, 1), (1, 7, 3), (1, 16, 16), (1, 5, 16)]


def _eager(A, Q, H, diag, y, carry):
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


def _draw(r, b, n, carried, seed):
    rng = np.random.default_rng(seed)
    coeffs, dt, A, Q, H, diag, y = k1_draw(rng, r, b, n, torch.float64)
    carry = None
    if carried:
        _, _, carry = K.kalman_blocked_plain(A, Q, H, diag, y, 3)
        Ac, Pinf, _ = PP._ssm_from_dt(coeffs, dt)
        A, Q = Ac, PP._noise(Ac, Pinf)
    return rng, A.contiguous(), Q.contiguous(), H, diag, y, carry


@pytest.mark.parametrize("dcarry", [False, True])
@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("b,n,nb", SHAPES)
@pytest.mark.parametrize("r", [1, 2, 4, 6, 12, 16])
def test_adjoint_plain_matches_autograd_through_the_eager_composition(r, b, n, nb, carried,
                                                                       dcarry):
    if r > 8:
        b, n, nb = SHAPES_WIDE[SHAPES.index((b, n, nb))]
    rng, A, Q, H, diag, y, carry = _draw(r, b, n, carried, 100 * r + n)
    dmu = torch.from_numpy(rng.standard_normal((b, n)))
    ds = torch.from_numpy(rng.standard_normal((b, n)))
    shapes = [(b, r, r), (b, r), (b, r, r), (b, r), (b, r, r)]
    dc = tuple(torch.from_numpy(rng.standard_normal(sh)) for sh in shapes) if dcarry else None
    mu, s, out, pre = K.kalman_blocked_plain(A, Q, H, diag, y, nb, carry, prefixes=True)
    got = K.kalman_blocked_adjoint_plain(A, Q, H, diag, y, nb, carry, pre, dmu, ds, dc)
    assert (got[4] is None) == (carry is None)

    leaves = [x.clone().requires_grad_(True) for x in (A, Q, diag, y)]
    start = ([c.clone().requires_grad_(True) for c in carry] if carried
             else list(PP._identity_elements((b,), r, torch.float64, "cpu")))
    m2, s2, o2 = _eager(leaves[0], leaves[1], H, leaves[2], leaves[3], tuple(start))
    torch.testing.assert_close(mu, m2.detach(), rtol=1e-10, atol=1e-12)
    f = (m2 * dmu).sum() + (s2 * ds).sum()
    if dc is not None:
        f = f + sum((x * g).sum() for x, g in zip(o2, dc))
    wrt = leaves + (start if carried else [])
    ref = torch.autograd.grad(f, wrt, allow_unused=True)
    names = ["A", "Q", "diag", "y"] + (["cA", "cb", "cC", "ceta", "cJ"] if carried else [])
    mine = list(got[:4]) + (list(got[4]) if carried else [])
    for name, g, w in zip(names, mine, ref):
        w = torch.zeros_like(g) if w is None else w
        if name in ("Q", "cC", "cJ"):
            g, w = g + g.transpose(-1, -2), w + w.transpose(-1, -2)
        scale = max(float(w.abs().max()), 1e-300)
        assert float((g - w).abs().max()) <= 1e-10 * scale, (name, float((g - w).abs().max()),
                                                              scale)


def _series():
    """tests/test_gp.py::test_chunked_likelihood_grad_and_vmap's draw."""
    rng = np.random.default_rng(14)
    n = 800
    t = np.sort(rng.uniform(0, 100, n))
    y = np.sin(2 * np.pi * t / 20.0) + 0.05 * rng.standard_normal(n)
    return t, np.full(n, 0.01), y - y.mean()


def test_gradients_go_through_k2_and_never_the_scan(monkeypatch):
    """With an input that needs a gradient, blocked and chunked run K1 and
    K2 (their plain versions on CPU tensors) and the sequential solver not
    at all; without one, K1 alone, as before, and the value has no graph."""
    from periodicity_tpu_torch.gp import log_likelihood_blocked, log_likelihood_chunked
    from periodicity_tpu_torch.models.gp import solver
    from periodicity_tpu_torch.models.gp import terms as PT

    calls = {"k1": 0, "k2": 0}
    plain1, plain2 = K.kalman_blocked_plain, K.kalman_blocked_adjoint_plain

    def k1(*a, **kw):
        calls["k1"] += 1
        return plain1(*a, **kw)

    def k2(*a, **kw):
        calls["k2"] += 1
        return plain2(*a, **kw)

    def scan(*a, **kw):
        raise AssertionError("the sequential solver ran")

    monkeypatch.setattr(K, "kalman_blocked_plain", k1)
    monkeypatch.setattr(K, "kalman_blocked_adjoint_plain", k2)
    monkeypatch.setattr(solver, "log_likelihood", scan)
    t, diag, y = (torch.from_numpy(a[:300]) for a in _series())
    for fn, n_calls in ((lambda *a: log_likelihood_blocked(*a, n_blocks=8), 1),
                        (lambda *a: log_likelihood_chunked(*a, chunk=128, inner_blocks=16), 3)):
        calls.update(k1=0, k2=0)
        p = torch.tensor([0.01, 20.0, 10.0, 0.3], dtype=torch.float64, requires_grad=True)
        ll = fn(PT.BrownianTerm(p[0], p[1], p[2], p[3]), t, diag, y)
        assert calls == {"k1": n_calls, "k2": 0}
        (g,) = torch.autograd.grad(ll, p)
        assert calls == {"k1": n_calls, "k2": n_calls} and torch.all(torch.isfinite(g))
        calls.update(k1=0, k2=0)
        with torch.no_grad():
            ll = fn(PT.BrownianTerm(*p.detach()), t, diag, y)
        assert ll.grad_fn is None and calls == {"k1": n_calls, "k2": 0}


def test_adjoint_wrapper_takes_the_plain_version_on_the_cpu_and_checks():
    _, A, Q, H, diag, y, carry = _draw(3, 2, 30, True, 7)
    mu, s, out, pre = K.kalman_blocked(A, Q, H, diag, y, 4, carry, prefixes=True)
    want = K.kalman_blocked_plain(A, Q, H, diag, y, 4, carry, prefixes=True)
    assert all(torch.equal(a, w) for a, w in zip((mu, s, pre, *out),
                                                 (want[0], want[1], want[3], *want[2])))
    dmu, ds = torch.ones_like(mu), torch.ones_like(s)
    got = K.kalman_blocked_adjoint(A, Q, H, diag, y, 4, carry, pre, dmu, ds)
    ref = K.kalman_blocked_adjoint_plain(A, Q, H, diag, y, 4, carry, pre, dmu, ds)
    assert all(torch.equal(a, w) for a, w in zip((*got[:4], *got[4]), (*ref[:4], *ref[4])))
    with pytest.raises(ValueError, match="n_blocks"):
        K.kalman_blocked_adjoint(A, Q, H, diag, y, 0, carry, pre, dmu, ds)
