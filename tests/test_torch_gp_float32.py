"""Float32 GP likelihoods of config 7's long series (ROADMAP C5): the
witness from the reference for the fixed float32 limits of
``chip_smoke.py`` phase 32.

The JAX package characterizes its float32 scan at 1e-5 of float64 for
N <= 8192 (tests/test_gp.py:199-233). Here its float32 scan runs on the
CPU on config 7's draws (``chip_smoke.c7_series``, seeds ``C7_F32_SEEDS``)
at N = 1e5 and 1e6 against its float64 scan of the same draw: it is past
1e-5 (so C5 is a property of the reference) and within the smoke's limit
(so the limit admits the reference's own float32 error). The port's float32
solvers on the CPU are held within the same limit, and one lost carry (the
control) outside it. The gradient (phase 39): on a stand-in for config 7's
N = 1e6 series, ``jax.grad`` through the JAX package's float32 chunked
likelihood is past twice its float32 scan's error against the float64
scan's gradient and within the smoke's fixed limit, and so is the port's
(K1 and K2's plain versions); most of it is the float32 process noise Q,
formed alike in both. Run with ``-s`` to print the readings.
"""

import jax
import numpy as np
import pytest
import torch

from chip_smoke import (C7_F32_SEEDS, F32_GRAD_REL_LONG, F32_LL_REL, F32_LL_REL_LONG, c7_blocks,
                        c7_lost_carry, c7_series)
from periodicity_tpu.models.gp import pscan as JP
from periodicity_tpu.models.gp import solver as JS
from periodicity_tpu.models.gp import terms as JT
from periodicity_tpu_torch.gp import log_likelihood, log_likelihood_blocked, log_likelihood_pscan
from periodicity_tpu_torch.models.gp.terms import BrownianTerm

# config 7's term (benchmarks/run_benchmarks.py:354-457)
PARAMS = (0.01, 20.0, 10.0, 0.3)


@pytest.fixture(autouse=True, scope="module")
def _release_jax_executables():
    """Free this module's compiled JAX executables when it ends (see
    tests/test_torch_pscan.py)."""
    yield
    jax.clear_caches()


def _draw(seed, n):
    t, y = c7_series(np.random.default_rng(seed), n)
    return t, np.full(n, 0.01, np.float32), y


def _jax_f64(t, diag, y):
    return float(JS.log_likelihood(JT.BrownianTerm(*PARAMS), *(a.astype(np.float64)
                                                              for a in (t, diag, y))))


@pytest.mark.parametrize("n", sorted(F32_LL_REL_LONG))
def test_jax_float32_scan_is_past_its_characterization_and_within_the_limit(n):
    # JAX's float32 scan needs float32 throughout: x64 off for its trace
    with jax.enable_x64(False):
        f32 = jax.jit(lambda t, d, y: JS.log_likelihood(JT.BrownianTerm(*PARAMS), t, d, y))
        rels = []
        for seed in C7_F32_SEEDS:
            t, diag, y = _draw(seed, n)
            rels.append((seed, float(f32(t, diag, y)), t, diag, y))
    rels = [(seed, abs(ll - _jax_f64(t, d, y)) / abs(_jax_f64(t, d, y)))
            for seed, ll, t, d, y in rels]
    print(f"\nJAX float32 scan, config 7 N={n}, rel to its float64 scan by seed: "
          + ", ".join(f"{s}: {r:.3e}" for s, r in rels))
    for _, rel in rels:
        assert F32_LL_REL < rel <= F32_LL_REL_LONG[n]


def test_port_float32_solvers_within_the_limit_and_a_lost_carry_outside():
    n = min(F32_LL_REL_LONG)
    t, diag, y = (torch.from_numpy(a) for a in _draw(C7_F32_SEEDS[0], n))
    term = BrownianTerm(*PARAMS)
    ref = float(log_likelihood(term, t.double(), diag.double(), y.double()))
    got = {"scan": log_likelihood(term, t, diag, y),
           "pscan": log_likelihood_pscan(term, t, diag, y),
           "blocked": log_likelihood_blocked(term, t, diag, y, n_blocks=c7_blocks(n)),
           "one lost carry": c7_lost_carry(term, t, diag, y, n // 2, c7_blocks(n))}
    rels = {k: abs(float(v) - ref) / abs(ref) for k, v in got.items()}
    print(f"\nport float32 on the CPU, config 7 N={n}, seed {C7_F32_SEEDS[0]}, rel to the "
          "float64 scan: " + ", ".join(f"{k} {v:.3e}" for k, v in rels.items()))
    for k, v in got.items():
        assert v.dtype == torch.float32
    lost = rels.pop("one lost carry")
    assert max(rels.values()) <= F32_LL_REL_LONG[n] < lost


def test_float32_blocked_gradient_is_past_twice_the_scans_in_both_packages():
    """The blocked composition's float32 gradient (the chunked solver) on a
    stand-in for config 7's N = 1e6 series: 16384 samples at its sampling
    density (dt ~ 1e-3) and float32 time resolution (t near 1000), four
    chunks of 4096 over 32 blocks, against the float64 scan's gradient
    (largest relative error over the four parameters). jax.grad through the
    JAX package's float32 log_likelihood_chunked reads past twice its
    float32 scan's, so phase 39 holds N = 1e5 and 1e6 to F32_GRAD_REL_LONG
    instead, and the JAX package's and the port's readings (K1 and K2's
    plain versions) lie within the limit at 1e6. Most of that error is the
    float32 process noise Q = Pinf - A Pinf A^T, formed the same way in
    both packages (a difference of near-equal terms at dt ~ 1e-3): with Q
    formed in float64 and rounded, the port's error falls more than
    tenfold."""
    import jax.numpy as jnp

    from periodicity_tpu_torch.gp import log_likelihood_chunked
    from periodicity_tpu_torch.models.gp import pscan

    n, chunk, inner = 16384, 4096, 32
    rng = np.random.default_rng(C7_F32_SEEDS[0])
    t = (1000.0 - np.sort(rng.uniform(0, n * 1e-3, n))[::-1]).astype(np.float32)
    y = (np.sin(2 * np.pi * t / 20.0) + 0.1 * rng.standard_normal(n)).astype(np.float32)
    y, diag = y - y.mean(), np.full(n, 0.01, np.float32)
    p = torch.tensor(PARAMS, dtype=torch.float64, requires_grad=True)
    ll = log_likelihood(BrownianTerm(*p), *(torch.from_numpy(a).double() for a in (t, diag, y)))
    ref = torch.autograd.grad(ll, p)[0].numpy()
    with jax.enable_x64(False):
        p0 = jnp.asarray(PARAMS, jnp.float32)
        terms = lambda q: JT.BrownianTerm(q[0], q[1], q[2], q[3])  # noqa: E731
        g_scan = np.asarray(jax.grad(lambda q: JS.log_likelihood(terms(q), t, diag, y))(p0))
        g_jax = np.asarray(jax.grad(lambda q: JP.log_likelihood_chunked(
            terms(q), t, diag, y, chunk=chunk, inner_blocks=inner))(p0))

    def port(inputs=pscan._k1_inputs):
        p32 = torch.tensor(PARAMS, dtype=torch.float32, requires_grad=True)
        orig, pscan._k1_inputs = pscan._k1_inputs, inputs
        try:
            ll = log_likelihood_chunked(BrownianTerm(*p32), *(torch.from_numpy(a) for a in (
                t, diag, y)), chunk=chunk, inner_blocks=inner)
        finally:
            pscan._k1_inputs = orig
        return torch.autograd.grad(ll, p32)[0].numpy()

    def wide_q(coeffs, dt, d, yy, batch, first, inputs=pscan._k1_inputs):
        A, _, H, d, yy = inputs(coeffs, dt, d, yy, batch, first)
        Q = inputs(tuple(c.double() for c in coeffs), dt.double(), d, yy, batch, first)[1]
        return A, Q.float(), H, d, yy

    rel = {k: float(np.max(np.abs((g.astype(np.float64) - ref) / ref)))
           for k, g in (("JAX scan", g_scan), ("JAX chunked", g_jax), ("port chunked", port()),
                        ("port chunked, Q from float64", port(wide_q)))}
    print(f"\nfloat32 gradients, config 7's N = 1e6 stand-in (N={n}), seed {C7_F32_SEEDS[0]}, "
          "rel to the float64 scan's: " + ", ".join(f"{k} {v:.3e}" for k, v in rel.items()))
    assert rel["JAX chunked"] > 2 * rel["JAX scan"]
    assert max(rel["JAX chunked"], rel["port chunked"]) <= F32_GRAD_REL_LONG[1_000_000]
    assert rel["port chunked, Q from float64"] < rel["port chunked"] / 10
