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
control) outside it. Run with ``-s`` to print the readings.
"""

import jax
import numpy as np
import pytest
import torch

from chip_smoke import (C7_F32_SEEDS, F32_LL_REL, F32_LL_REL_LONG, c7_blocks, c7_lost_carry,
                        c7_series)
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
