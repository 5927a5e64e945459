"""The port's sharded GP likelihood, sharded sampler, sharded modeler and
profiling against the JAX package's.

One gloo group of 4 CPU ranks (``tests/_torch_ranks.py``, suite "gp")
runs the port while this process runs the JAX package on as many of its
virtual devices: the time-sharded likelihood at D = 4 and on a (2, 2) mesh
(D = 2) within 1e-12 relative of JAX's sharded value and of JAX's scan
(``tests/test_parallel.py:137-158``) and its gradient within 1e-10 of
``jax.grad`` through JAX's scan; the walker-sharded sampler at D = 2 fed
JAX's own per-device draws within 1e-12 of JAX's chain, and JAX's moment
test on the port's own generator at D = 4; the modeler's ``nll`` with
``solver="sharded"`` within 1e-10 of JAX's. World-size-1 cases, the
profiling helpers and the ``utils`` surface run in this process.
"""

import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
from _torch_ranks import Ranks

D = 4
N = 256
STEPS, WALKERS = 5, 8
PARAMS = {"rotation": [1.2, 7.7, 2.0, 1.0, 0.3], "sho": [0.8, 3.0, 4.0]}


def _jterm(name, p):
    from periodicity_tpu.models.gp.terms import RotationTerm, SHOTerm

    if name == "rotation":
        return RotationTerm(sigma=p[0], period=p[1], Q0=p[2], dQ=p[3], f=p[4])
    return SHOTerm(sigma=p[0], rho=p[1], Q=p[2])


def _jax_draws(key, n_dev):
    """JAX's per-device stretch draws of ``run_ensemble_sharded``
    (``periodicity_tpu/models/gp/mcmc.py:181-214``): fold_in the device,
    split by step, by half-update, then (uniform, randint, uniform)."""
    import jax
    import jax.numpy as jnp

    wl, half = WALKERS // n_dev, WALKERS // 2
    u, j, r = (np.zeros((n_dev, STEPS, 2, wl), dt) for dt in (np.float64, np.int64, np.float64))
    for dev in range(n_dev):
        keys = jax.random.split(jax.random.fold_in(key, dev), STEPS)
        for s in range(STEPS):
            for h, kh in enumerate(jax.random.split(keys[s])):
                k1, k2, k3 = jax.random.split(kh, 3)
                u[dev, s, h] = jax.random.uniform(k1, (wl,), jnp.float64)
                j[dev, s, h] = jax.random.randint(k2, (wl,), 0, half)
                r[dev, s, h] = jax.random.uniform(k3, (wl,), jnp.float64)
    return u, j, r


@pytest.fixture(scope="module")
def inputs():
    import jax

    rng = np.random.default_rng(0)
    t = np.sort(rng.uniform(0, 100.0, N))
    y = np.sin(2 * np.pi * t / 7.7) + 0.3 * rng.standard_normal(N)
    u, j, r = _jax_draws(jax.random.PRNGKey(1), 2)
    tm = np.sort(rng.uniform(0, 50.0, 128))
    ym = np.sin(2 * np.pi * tm / 5.0) + 0.1 * rng.standard_normal(128)
    return {"t": t, "y": y, "diag": np.full(N, 0.09),
            "x0": np.asarray(jax.random.normal(jax.random.PRNGKey(0), (WALKERS, 2))),
            "x0_moments": np.asarray(jax.random.normal(jax.random.PRNGKey(0), (64, 2))),
            "draw_u": u, "draw_j": j, "draw_r": r,
            "t_model": tm, "y_model": ym, "dy_model": np.full(128, 0.1)}


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    work = tmp_path_factory.mktemp("gp_ranks")
    np.savez(work / "inputs.npz", **inputs)
    group = Ranks("gp", work, world=D)
    yield group
    group.close()


def _each_rank(ranks, key):
    res = ranks.results()
    for r in range(1, D):
        np.testing.assert_array_equal(res[r][key], res[0][key], err_msg=f"rank {r}: {key}")
    return res[0][key]


def _jmesh(axis, d):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:d]), (axis,))


@pytest.mark.parametrize("d", [4, 2])
@pytest.mark.parametrize("name", ["rotation", "sho"])
def test_sharded_likelihood_matches_jax(ranks, inputs, name, d):
    from periodicity_tpu.models.gp.pscan import log_likelihood_sharded
    from periodicity_tpu.models.gp.solver import log_likelihood

    t, y, diag = inputs["t"], inputs["y"], inputs["diag"]
    term = _jterm(name, PARAMS[name])
    got = float(_each_rank(ranks, f"ll_{name}_D{d}"))
    assert got == pytest.approx(float(log_likelihood_sharded(term, t, diag, y,
                                                             _jmesh("seq", d))), rel=1e-12)
    assert got == pytest.approx(float(log_likelihood(term, t, diag, y)), rel=1e-12)


def test_sharded_likelihood_gradient_matches_jax_grad(ranks, inputs):
    """The gradient is the two-level composition's own: each of the D = 4
    ranks reverses its stretch's K1 passes (K2's plain version here), the
    summaries' and the shared inputs' cotangents summed over ranks. Every
    rank returns the same gradient, within 1e-10 of the port's
    single-process blocked gradient and within JAX's 1e-6
    (tests/test_gp.py:318) of jax.grad through JAX's scan."""
    import jax
    import jax.numpy as jnp

    from periodicity_tpu.models.gp.solver import log_likelihood
    from periodicity_tpu_torch.gp import log_likelihood_blocked
    from periodicity_tpu_torch.models.gp.terms import RotationTerm

    t, y, diag = inputs["t"], inputs["y"], inputs["diag"]
    ref = np.asarray(jax.grad(lambda p: log_likelihood(_jterm("rotation", p), t, diag, y))(
        jnp.asarray(PARAMS["rotation"])))
    got = _each_rank(ranks, "grad_rotation_D4")
    p = torch.tensor(PARAMS["rotation"], dtype=torch.float64, requires_grad=True)
    ll = log_likelihood_blocked(RotationTerm(sigma=p[0], period=p[1], Q0=p[2], dQ=p[3], f=p[4]),
                                *(torch.from_numpy(a) for a in (t, diag, y)))
    (blocked,) = torch.autograd.grad(ll, p)
    np.testing.assert_allclose(got, blocked.numpy(), rtol=1e-10)
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_sharded_sampler_reproduces_jax_chain_on_its_draws(ranks, inputs):
    """Each rank's half-updates fed JAX's per-device draws (D = 2 on the
    walkers axis of a (2, 2) mesh) give JAX's chain for its walkers."""
    import jax
    import jax.numpy as jnp

    from periodicity_tpu.models.gp.mcmc import run_ensemble_sharded

    mu, sd = jnp.asarray([1.0, -2.0]), jnp.asarray([0.5, 2.0])
    chain, lps, _ = run_ensemble_sharded(lambda x: -0.5 * jnp.sum(((x - mu) / sd) ** 2),
                                         jnp.asarray(inputs["x0"]), jax.random.PRNGKey(1),
                                         STEPS, _jmesh("walkers", 2))
    chain, lps = np.asarray(chain), np.asarray(lps)
    wl = WALKERS // 2
    for res in ranks.results():
        idx = int(res["chain_D2_index"])
        block = slice(idx * wl, (idx + 1) * wl)
        np.testing.assert_allclose(res["chain_D2"], chain[:, block], rtol=0, atol=1e-12)
        np.testing.assert_allclose(res["lps_D2"], lps[:, block], rtol=0, atol=1e-12)
    assert np.any(np.diff(chain, axis=0) != 0), "the chain moved"


def test_sharded_sampler_samples_a_gaussian(ranks):
    """JAX's moment test (tests/test_parallel.py:109-134) on the port's own
    generator, walkers over 4 ranks; a rerun from the same seed repeats."""
    chain = _each_rank(ranks, "moments_chain")
    samples = chain[500:].reshape(-1, 2)
    assert 0.1 < float(_each_rank(ranks, "moments_acc")) < 0.95
    np.testing.assert_allclose(samples.mean(0), [1.0, -2.0], atol=0.15)
    np.testing.assert_allclose(samples.std(0), [0.5, 2.0], rtol=0.15)
    np.testing.assert_array_equal(_each_rank(ranks, "moments_first5"), chain[:5])


def test_sharded_modeler_matches_jax(ranks, inputs):
    from periodicity_tpu.core import TSeries as JTSeries
    from periodicity_tpu.gp import BrownianGP as JBrownianGP

    sig = JTSeries(inputs["t_model"], inputs["y_model"])
    ref = float(JBrownianGP(sig, err=inputs["dy_model"], solver="sharded",
                            mesh=_jmesh("seq", D)).nll(np.full(6, 50.0)))
    got = float(_each_rank(ranks, "nll_sharded"))
    assert got == pytest.approx(ref, rel=1e-10)
    assert got == pytest.approx(float(_each_rank(ranks, "nll_scan")), rel=1e-10)


@pytest.mark.parametrize("key,words", [
    ("err_ll", "n=254 must be divisible by mesh axis size 4"),
    ("err_walkers", "n_walkers=60 must be divisible by 2*4"),
    ("err_modeler", "series length 126 must be divisible by mesh axis 'seq' size 4"),
])
def test_sizes_that_do_not_divide_raise_as_jax(ranks, key, words):
    assert words in str(_each_rank(ranks, key))


def test_rank_processes_import_neither_jax_nor_the_jax_package(ranks):
    assert list(_each_rank(ranks, "foreign_modules")) == [""]


# -- in this process -----------------------------------------------------------


@pytest.fixture(scope="module")
def mesh1():
    from periodicity_tpu_torch.parallel import default_mesh

    started = not dist.is_initialized()
    yield default_mesh(("seq",), device="cpu")
    if started and dist.is_initialized():
        dist.destroy_process_group()


def test_world_of_one_is_one_blocked_call(mesh1, inputs):
    """At D = 1 the sharded likelihood is one K1 call over the series,
    bit for bit, and its gradient that call's, through K2: bit for bit the
    blocked likelihood's at the same blocks, within JAX's 1e-6 of the
    scan's."""
    from periodicity_tpu_torch.gp import (
        RotationTerm,
        log_likelihood,
        log_likelihood_blocked,
        log_likelihood_sharded,
    )
    from periodicity_tpu_torch.models.gp.pscan import _shard_blocks

    t, y, diag = (torch.from_numpy(inputs[k]) for k in ("t", "y", "diag"))
    p = torch.tensor(PARAMS["rotation"], dtype=torch.float64, requires_grad=True)

    def term():
        return RotationTerm(sigma=p[0], period=p[1], Q0=p[2], dQ=p[3], f=p[4])

    got = log_likelihood_sharded(term(), t, diag, y, mesh1)
    ref = log_likelihood_blocked(term(), t, diag, y, n_blocks=_shard_blocks(N))
    assert torch.equal(got.detach(), ref.detach())
    (g,) = torch.autograd.grad(got, p)
    (g_blocked,) = torch.autograd.grad(ref, p)
    (g_scan,) = torch.autograd.grad(log_likelihood(term(), t, diag, y), p)
    assert torch.equal(g, g_blocked)
    np.testing.assert_allclose(g.numpy(), g_scan.numpy(), rtol=1e-6)


def test_sharded_solver_needs_a_mesh_and_knows_its_solvers(inputs):
    from periodicity_tpu_torch import TSeries
    from periodicity_tpu_torch.gp import BrownianGP

    sig = TSeries(torch.from_numpy(inputs["t_model"]), torch.from_numpy(inputs["y_model"]),
                  device="cpu")
    err = torch.from_numpy(inputs["dy_model"])
    with pytest.raises(ValueError, match="solver='sharded' needs a torch.distributed"):
        BrownianGP(sig, err=err, solver="sharded")
    with pytest.raises(ValueError, match="unknown solver"):
        BrownianGP(sig, err=err, solver="dense")


def test_trace_writes_a_chrome_trace_and_timer_times(tmp_path):
    """tests/test_containers_extra.py::test_utils_checkpoint_and_logging's
    timer, and a trace exported into its directory."""
    from periodicity_tpu_torch.utils import timer, trace

    with trace(tmp_path / "trace"):
        torch.fft.fft(torch.arange(64.0))
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    with open(tmp_path / "trace" / files[0]) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert any("fft" in n for n in names)
    seen = []
    with timer("block", sink=seen.append) as tm:
        torch.sum(torch.arange(100.0))
    assert tm["seconds"] >= 0 and tm["label"] == "block" and seen == [tm]


def test_utils_exports_match_jax(tmp_path):
    import periodicity_tpu.utils as jutils

    import periodicity_tpu_torch.utils as putils

    assert putils.__all__ == jutils.__all__
    state = {"chain": torch.arange(12.0).reshape(3, 4), "step": np.asarray(7)}
    putils.save_state(tmp_path / "state", state)
    back = putils.load_state(tmp_path / "state", state)
    np.testing.assert_array_equal(np.asarray(back["chain"]), np.arange(12.0).reshape(3, 4))
    assert int(back["step"]) == 7
