"""The port's parallel package against the JAX package's, at the same D.

One gloo group of D = 4 CPU ranks (``tests/_torch_ranks.py``, suite
"parallel") runs every case through the port's public functions while this
process runs the JAX package's sharded functions on 4 of its 8 virtual
devices; the ranks join within a time limit and a hung rank fails these
tests instead of the suite. Tolerances are the JAX package's own
(``tests/test_parallel.py``): the periodogram as ``test_torch_gls.py``
holds ``gls_power`` (1e-9 of the peak in float64, 5e-5 in float32) with the
same argmax, the period scorers at rtol 1e-10, ``sharded_acf`` at rtol
1e-8 / atol 1e-10, the distributed FFT at 1e-9 max|X| and its ACF at 1e-10.
World-size-1 cases run in this process, on a group of one that the module
destroys when it ends.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist
from _torch_ranks import Ranks

D = 4
N = 500
DF, FMIN, NF = 0.001, 0.0005, 4096
# float32: test_torch_gls.py's curve and grid, where JAX's own float32
# periodogram stays within its 5e-5 of the peak (on the float64 draw above
# it does not: 2.4e-4)
DF32, NF32 = 1.0 / 500.0, 1500


def _data():
    rng = np.random.default_rng(0)
    t = np.sort(rng.uniform(0, 60, N))
    y = np.sin(2 * np.pi * t / 5.5) + 0.2 * rng.standard_normal(N)
    err = np.full(N, 0.2)
    m = (y - y.max()) / (2 * (y.max() - y.min())) + 0.25
    w = (1.0 / err**2) / np.sum(1.0 / err**2)
    rng1 = np.random.default_rng(1)
    n = 4096
    x = rng1.standard_normal(n)
    y_acf = np.sin(2 * np.pi * np.arange(n) / 64) + 0.2 * rng1.standard_normal(n)
    rng2 = np.random.default_rng(0)
    t32 = np.sort(rng2.uniform(0, 100.0, 800))
    y32 = np.sin(2 * np.pi * t32 / 7.7) + 0.3 * rng2.standard_normal(800)
    err32 = rng2.uniform(0.2, 0.4, 800)
    return {"t": t, "y": y, "err": err, "m": m, "w": w, "periods": np.linspace(2.0, 12.0, 800),
            "y_batch": rng1.standard_normal((8, 256)), "x": x, "y_acf": y_acf,
            "t32": t32.astype(np.float32), "y32": y32.astype(np.float32),
            "err32": err32.astype(np.float32)}


@pytest.fixture(scope="module")
def inputs():
    return _data()


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    work = tmp_path_factory.mktemp("parallel_ranks")
    np.savez(work / "inputs.npz", **inputs)
    group = Ranks("parallel", work, world=D)
    yield group
    group.close()


@pytest.fixture(scope="module")
def jmesh():
    import jax

    from periodicity_tpu.parallel import default_mesh

    return lambda axis: default_mesh((axis,), devices=jax.devices()[:D])


def _each_rank(ranks, key):
    """Every rank's ``key``, checked equal across ranks; rank 0's."""
    res = ranks.results()
    for r in range(1, D):
        np.testing.assert_array_equal(res[r][key], res[0][key], err_msg=f"rank {r}: {key}")
    return res[0][key]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_sharded_gls_matches_jax_sharded(ranks, inputs, jmesh, dtype):
    from periodicity_tpu.parallel import sharded_gls as j_sharded_gls
    from periodicity_tpu.spectral import gls_power as j_gls_power

    if dtype == np.float64:
        t, y, err = (inputs[k] for k in ("t", "y", "err"))
        df, fmin, nf = DF, FMIN, NF
    else:
        t, y, err = (inputs[k] for k in ("t32", "y32", "err32"))
        df, fmin, nf = DF32, DF32 / 2, NF32
    ref = np.asarray(j_sharded_gls(t, y, err, df, fmin, nf, jmesh("grid")))
    got = _each_rank(ranks, "gls" if dtype == np.float64 else "gls_f32")
    tol = {np.float64: 1e-9, np.float32: 5e-5}[dtype]
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * ref.max())
    assert np.argmax(got) == np.argmax(ref)
    if dtype == np.float64:
        exact = np.asarray(j_gls_power(t, y, err, DF, FMIN, NF, method="direct"))
        assert np.max(np.abs(got - exact)) < 2e-3
        for r, res in enumerate(ranks.results()):
            np.testing.assert_array_equal(res["gls_local"], got[r * NF // D:(r + 1) * NF // D])


@pytest.mark.parametrize("name", ["pdm", "string_length", "aov", "conditional_entropy",
                                  "gregory_loredo"])
def test_sharded_period_scorers_match_jax_sharded(ranks, inputs, jmesh, name):
    from periodicity_tpu import parallel as jpar

    t, y, m, periods = (inputs[k] for k in ("t", "y", "m", "periods"))
    fn = getattr(jpar, f"sharded_{name}")
    if name == "gregory_loredo":
        ref = fn(t, periods, jmesh("grid"))
    else:
        ref = fn(t, m if name == "string_length" else y, periods, jmesh("grid"))
    np.testing.assert_allclose(_each_rank(ranks, name), np.asarray(ref), rtol=1e-10)


def test_sharded_bls_matches_jax_sharded(ranks, inputs, jmesh):
    from periodicity_tpu.parallel import sharded_bls as j_sharded_bls

    ref = j_sharded_bls(*(inputs[k] for k in ("t", "y", "w", "periods")), jmesh("grid"),
                        widths=(3, 13, 26), nbins=128)
    for name, r in zip(("power", "depth", "width_idx", "bin_start"), ref):
        np.testing.assert_allclose(_each_rank(ranks, f"bls_{name}"), np.asarray(r), rtol=1e-10)


def test_sharded_kernel_binner_equals_the_unsharded_scan(ranks):
    """binner="kernel" folds each rank's slice as the unsharded scan folds
    it (the fold kernel's plain version on CPU tensors)."""
    np.testing.assert_array_equal(_each_rank(ranks, "aov_kernel"),
                                  _each_rank(ranks, "aov_kernel_unsharded"))


def test_sharded_acf_matches_jax_and_the_container(ranks, inputs, jmesh):
    from periodicity_tpu import TSeries as JTSeries
    from periodicity_tpu.parallel import sharded_acf as j_sharded_acf

    got = _each_rank(ranks, "acf")
    ref = np.asarray(j_sharded_acf(inputs["y_batch"], jmesh("batch")))
    assert got.shape == (8, 256)
    np.testing.assert_allclose(got, ref, rtol=1e-8, atol=1e-10)
    one = np.asarray(JTSeries(np.arange(256.0), inputs["y_batch"][3]).acf(max_lag=256).values)
    np.testing.assert_allclose(got[3], one, rtol=1e-8, atol=1e-10)


def test_distributed_fft_matches_jax_and_numpy(ranks, inputs, jmesh):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    from periodicity_tpu.parallel import distributed_fft as j_fft

    x = inputs["x"]
    n = x.shape[0]
    X = _each_rank(ranks, "fft")
    smesh = jmesh("seq")
    xs = jax.device_put(jnp.asarray(x), NamedSharding(smesh, PartitionSpec("seq")))
    scale = np.max(np.abs(np.fft.fft(x)))
    np.testing.assert_allclose(X, np.asarray(j_fft(xs, smesh)), atol=1e-9 * scale)
    natural = np.empty(n, complex)
    for r in range(D):
        natural[r::D] = X.reshape(D, n // D)[r]
    np.testing.assert_allclose(natural, np.fft.fft(x), atol=1e-9 * scale)
    np.testing.assert_allclose(_each_rank(ranks, "ifft"), x, atol=1e-10)
    np.testing.assert_array_equal(_each_rank(ranks, "fft_from_dtensor"), X)
    f32 = _each_rank(ranks, "fft_f32")
    assert f32.dtype == np.complex64
    np.testing.assert_allclose(f32, X, atol=1e-5 * scale)


def test_distributed_acf_matches_jax_and_the_container(ranks, inputs, jmesh):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    from periodicity_tpu import TSeries as JTSeries
    from periodicity_tpu.parallel import distributed_acf as j_acf

    y = inputs["y_acf"]
    n = y.shape[0]
    got = _each_rank(ranks, "dacf")
    smesh = jmesh("seq")
    ys = jax.device_put(jnp.asarray(y), NamedSharding(smesh, PartitionSpec("seq")))
    np.testing.assert_allclose(got, np.asarray(j_acf(ys, smesh)), atol=1e-10)
    ref = np.asarray(JTSeries(np.arange(float(n)), y).acf(max_lag=n // 2).values)
    np.testing.assert_allclose(got[: n // 2], ref, atol=1e-10)
    np.testing.assert_array_equal(_each_rank(ranks, "dacf_max_lag"), got[:100])


@pytest.mark.parametrize("key,words", [
    ("err_gls", "nf=4098 must be divisible by mesh axis size 4"),
    ("err_periods", "n_periods=798 must be divisible by mesh axis size 4"),
    ("err_bls", "n_periods=798 must be divisible by mesh axis size 4"),
    ("err_fft", "must be divisible by mesh axis size 4"),
    ("err_acf", "must be divisible by mesh axis size 4"),
    ("err_mh", "does not cover 4 devices"),
])
def test_sizes_that_do_not_divide_raise_as_jax(ranks, key, words):
    assert words in str(_each_rank(ranks, key))


def test_initialize_distributed_reads_no_run_from_an_empty_environment(ranks):
    """False before a group exists (nothing names a multi-process run), True
    once one does; the ranks hold the placements JAX's P(axis) means."""
    for res in ranks.results():
        assert not bool(res["init_before"]) and bool(res["init_after"])
    assert list(_each_rank(ranks, "placements")) == ["S(0)"]


def test_multihost_mesh_puts_hosts_major(ranks, inputs):
    """With LOCAL_WORLD_SIZE = 2 the 4 ranks form a (2 hosts, 2 devices)
    mesh: host axis major, each host's ranks contiguous; a periodogram
    sharded over the in-host axis is replicated over hosts."""
    res = ranks.results()
    np.testing.assert_array_equal(res[0]["mh_ranks"], [[0, 1], [2, 3]])
    assert list(res[0]["mh_names"]) == ["batch", "grid"]
    for r in range(D):
        np.testing.assert_array_equal(res[r]["mh_coord"], [r // 2, r % 2])
        np.testing.assert_array_equal(res[r]["mh_gls_local"],
                                      res[r % 2]["mh_gls_local"])
    full = _each_rank(ranks, "mh_gls")
    assert full.shape == (256,) and np.all(np.isfinite(full))


def test_rank_processes_import_neither_jax_nor_the_jax_package(ranks):
    assert list(_each_rank(ranks, "foreign_modules")) == [""]


# -- a world of one, in this process -------------------------------------------


@pytest.fixture(scope="module")
def mesh1():
    from periodicity_tpu_torch.parallel import default_mesh

    started = not dist.is_initialized()
    yield default_mesh(("grid",), device="cpu")
    if started and dist.is_initialized():
        dist.destroy_process_group()


def _cpu(inputs, *keys):
    return tuple(torch.from_numpy(inputs[k]) for k in keys)


def test_world_of_one_equals_the_unsharded_calls(mesh1, inputs):
    """At D = 1 every sharded scan is its unsharded call, bit for bit."""
    from periodicity_tpu_torch.models import phase as P
    from periodicity_tpu_torch.models.spectral import gls_power
    from periodicity_tpu_torch.parallel import (
        grid_sharding,
        sharded_aov,
        sharded_bls,
        sharded_conditional_entropy,
        sharded_gls,
        sharded_gregory_loredo,
        sharded_pdm,
        sharded_string_length,
    )

    t, y, err, m, w, periods = _cpu(inputs, "t", "y", "err", "m", "w", "periods")
    got = sharded_gls(t, y, err, DF, FMIN, NF, mesh1)
    assert list(got.placements) == grid_sharding(mesh1)
    assert torch.equal(got.full_tensor(), gls_power(t, y, err, DF, FMIN, NF))
    for fn, scan, args in ((sharded_pdm, P.pdm_scan, (t, y)),
                           (sharded_string_length, P.string_length_scan, (t, m)),
                           (sharded_aov, P.aov_scan, (t, y)),
                           (sharded_conditional_entropy, P.conditional_entropy_scan, (t, y)),
                           (sharded_gregory_loredo, P.gregory_loredo_scan, (t,))):
        assert torch.equal(fn(*args, periods, mesh1).to_local(), scan(*args, periods))
    for a, b in zip(sharded_bls(t, y, w, periods, mesh1, binner="kernel"),
                    P.bls_scan(t, y, w, periods, widths=(3, 13, 26), binner="kernel")):
        assert torch.equal(a.to_local(), b)


def test_world_of_one_transforms(mesh1, inputs):
    """At D = 1 the distributed FFT is one FFT, its inverse returns the
    series, and the ACF is the container's."""
    from periodicity_tpu_torch import TSeries
    from periodicity_tpu_torch.parallel import (
        default_mesh,
        distributed_acf,
        distributed_fft,
        distributed_ifft,
        sharded_acf,
    )

    smesh = default_mesh(("seq",), device="cpu")
    (x,) = _cpu(inputs, "x")
    X = distributed_fft(x, smesh).to_local()
    assert torch.allclose(X, torch.fft.fft(x), rtol=0, atol=1e-9 * float(X.abs().max()))
    assert torch.allclose(distributed_ifft(X, smesh).to_local().real, x, rtol=0, atol=1e-10)
    (y,) = _cpu(inputs, "y_acf")
    ref = TSeries(torch.arange(float(y.shape[0])), y, device="cpu").acf(max_lag=100).values
    assert torch.allclose(distributed_acf(y, smesh, max_lag=100), ref, rtol=0, atol=1e-10)
    (yb,) = _cpu(inputs, "y_batch")
    one = TSeries(torch.arange(256.0, dtype=torch.float64), yb[3], device="cpu").acf(
        max_lag=256).values
    acf = sharded_acf(yb, default_mesh(("batch",), device="cpu")).to_local()
    assert torch.allclose(acf[3], one, rtol=1e-8, atol=1e-10)


def test_default_mesh_lays_the_world_on_the_first_axis(mesh1):
    from periodicity_tpu_torch.parallel import default_mesh, grid_sharding, multihost_mesh

    two = default_mesh(("batch", "grid"), device="cpu")
    assert two.mesh_dim_names == ("batch", "grid") and tuple(two.mesh.shape) == (1, 1)
    assert [str(p) for p in grid_sharding(two, "grid")] == ["R", "S(0)"]
    mh = multihost_mesh(device="cpu")
    assert mh.mesh_dim_names == ("batch", "grid") and tuple(mh.mesh.shape) == (1, 1)
    with pytest.raises(ValueError, match="does not cover 1 devices"):
        default_mesh(("grid",), shape=(2,), device="cpu")
