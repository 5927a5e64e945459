"""EMD sifting parity: periodicity_tpu_torch.ops.emd vs the JAX package.

The same numpy draws go to both packages, the JAX side on the CPU in x64,
the port's side through its plain version (CPU tensors). Float64 is the
parity dtype.

Tolerances, with their reasons:
- the batched building blocks (peaks, zero crossings, PCR, Thomas,
  masked splines): rows of a batch equal the 1-D results bit for bit;
- the capacity buffers (compaction, padding): bit for bit, since they are
  copies and one rounding each in both packages;
- a sift and whole decompositions: modes and residues within
  1e-9 * max|y| (XLA may contract a multiply-add into an FMA on the CPU,
  the port rounds each operation, as its kernel does); the integer results
  (extrema, zero crossings, mode counts, sift units) equal;
- the pool, the lockstep batch and a member alone: bit for bit, since the
  sift decides on integer counts only.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from periodicity_tpu.ops import emd as J
from periodicity_tpu.ops import peaks as JP
from periodicity_tpu_torch.ops import emd as P
from periodicity_tpu_torch.ops import peaks as PP
from periodicity_tpu_torch.ops import spline as PS


def _T(a):
    return torch.from_numpy(np.array(a))


def _close(jax_out, port_out, scale):
    np.testing.assert_allclose(port_out.numpy(), np.asarray(jax_out), rtol=0,
                               atol=1e-9 * scale)


@pytest.fixture(scope="module")
def skewed_batch():
    """Members that need very different numbers of sifts (the pool's case),
    at N = 512."""
    n = 512
    t = np.linspace(0.0, 20.0, n)
    rng = np.random.default_rng(0)
    ys = np.stack([
        np.sin(2 * np.pi * t * f) + 0.4 * np.sin(2 * np.pi * t * f / 6.0)
        + 0.05 * rng.standard_normal(n)
        for f in np.linspace(2.0, 4.0, 6)
    ])
    return t, ys


# ---- the leading batch axis of the sift's building blocks -----------------

@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_batched_masks_equal_1d_rows(dtype):
    rng = np.random.default_rng(3)
    # rounded values give plateaus and exact zeros
    X = _T(np.round(rng.standard_normal((4, 257)), 1)).to(dtype)
    X[3] = 0.0
    info = PP.local_maxima_info(X)
    zc = PP.zero_crossings_mask(X)
    for r in range(X.shape[0]):
        for got, want in zip(info, PP.local_maxima_info(X[r])):
            assert torch.equal(got[r], want)
        assert torch.equal(zc[r], PP.zero_crossings_mask(X[r]))
        np.testing.assert_array_equal(info[0][r].numpy(),
                                      np.asarray(JP.local_maxima_mask(X[r].double().numpy())))


@pytest.mark.parametrize("k", [20, 300])
def test_batched_tridiagonal_solves_equal_1d_rows(k):
    rng = np.random.default_rng(k)
    lower, upper = (_T(rng.uniform(0.5, 2.0, (3, k))) for _ in range(2))
    diag, rhs = _T(4.0 + rng.uniform(0, 1, (3, k))), _T(rng.standard_normal((3, k)))
    for solve in (PS.tridiagonal_solve, PS.tridiagonal_solve_pcr):
        batch = solve(lower, diag, upper, rhs)
        for r in range(3):
            assert torch.equal(batch[r], solve(lower[r], diag[r], upper[r], rhs[r]))


@pytest.mark.parametrize("k", [12, 200])
def test_batched_masked_spline_equals_1d_rows(k):
    """Masked not-a-knot splines with a count per row and a precomputed
    interval index, through the Thomas (k < 32) and PCR paths."""
    rng = np.random.default_rng(k)
    x = _T(np.sort(rng.uniform(0, 50, (3, k)), axis=1))
    y = _T(rng.standard_normal((3, k)))
    q = _T(rng.uniform(-5, 55, 400))
    count = torch.tensor([k, 4, k // 2 + 2])
    hi = torch.stack([torch.searchsorted(x[r], q, side="right") for r in range(3)])
    batch = PS.spline_interp(x, y, q, count=count, hi=hi)
    for r in range(3):
        assert torch.equal(batch[r], PS.spline_interp(x[r], y[r], q, count=count[r], hi=hi[r]))
        assert torch.equal(batch[r], PS.spline_interp(x[r], y[r], q, count=int(count[r])))


def test_pow2_is_a_product():
    """The kernel mirrors (1 - t) ** 2 in the Hermite basis as a product;
    PyTorch computes x ** 2 as x * x."""
    x = _T(np.random.default_rng(0).standard_normal(1000))
    for v in (x, x.float()):
        assert torch.equal((1 - v) ** 2, (1 - v) * (1 - v))


# ---- the capacity buffers (tests/test_emd_padding.py) ----------------------

def _numpy_padded_extrema(t, x, mask, pad_width):
    """Reference semantics in plain numpy: extrema with the edges,
    odd-reflected times and even-reflected values, edges dropped."""
    idx = np.where(mask)[0]
    et = np.concatenate([[t[0]], t[idx], [t[-1]]])
    ev = np.concatenate([[x[0]], x[idx], [x[-1]]])
    tp = np.pad(et, pad_width, mode="reflect", reflect_type="odd")
    vp = np.pad(ev, pad_width, mode="reflect")
    keep = np.ones(tp.size, bool)
    keep[pad_width] = False
    keep[-pad_width - 1] = False
    return tp[keep], vp[keep]


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("pad_width", [1, 2, 3])
def test_padded_extrema_match_reference_semantics_and_jax(seed, pad_width):
    rng = np.random.default_rng(seed)
    n = 257
    t = np.sort(rng.uniform(0, 40, n))
    x = np.sin(2 * np.pi * t / 5.0) + 0.5 * rng.standard_normal(n)
    mask = np.asarray(JP.local_maxima_mask(x))
    cap = n // 2 + 2
    et, ev, m = P._compact_with_edges(_T(t), _T(x), _T(mask), cap)
    pt, pv, count = P._pad_reflect_drop(et, ev, m, pad_width)
    ref_t, ref_v = _numpy_padded_extrema(t, x, mask, pad_width)
    k = int(count)
    assert k == ref_t.size
    np.testing.assert_allclose(pt[:k].numpy(), ref_t, rtol=1e-12)
    np.testing.assert_allclose(pv[:k].numpy(), ref_v, rtol=1e-12)
    assert bool((torch.diff(pt) > 0).all())
    jet, jev, jm = J._compact_with_edges(jnp.asarray(t), jnp.asarray(x), jnp.asarray(mask), cap)
    jpt, jpv, jcount = J._pad_reflect_drop(jet, jev, jm, pad_width)
    for got, want in ((et, jet), (ev, jev), (pt, jpt), (pv, jpv)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (int(m), k) == (int(jm), int(jcount))


def test_sift_mean_envelope_on_pure_tone():
    """For a pure tone the sifting mean is ~0 away from the edges and the
    IMF criteria hold at once."""
    t = np.arange(512.0)
    x = np.sin(2 * np.pi * t / 16)
    mu, sigma, n_ext, n_zero, ok = P.sift(_T(t), _T(x))
    assert bool(ok)
    assert float(mu[32:-32].abs().max()) < 5e-3
    assert abs(int(n_zero) - int(n_ext)) <= 1


@pytest.mark.parametrize("pad_width", [1, 2, 3])
def test_sift_matches_jax(pad_width):
    rng = np.random.default_rng(pad_width)
    t = np.sort(rng.uniform(0, 40, 300))
    x = np.sin(2 * np.pi * t / 5.0) + 0.5 * rng.standard_normal(300)
    want = J.sift(jnp.asarray(t), jnp.asarray(x), pad_width=pad_width)
    got = P.sift(_T(t), _T(x), pad_width=pad_width)
    scale = np.abs(x).max()
    _close(want[0], got[0], scale)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-9, atol=1e-12)
    for a, b in zip(got[2:], want[2:]):
        assert int(a) == int(b)


def test_upper_envelope_matches_jax_with_fallback():
    """Rows of a batch, one of them monotonic (the max|x| fallback)."""
    rng = np.random.default_rng(5)
    t = np.arange(200.0)
    ys = np.stack([np.sin(t / 7.0) + 0.3 * rng.standard_normal(200), np.linspace(0, 2, 200)])
    got = P.upper_envelope(_T(t), _T(ys))
    for r in range(2):
        want = J.upper_envelope(jnp.asarray(t), jnp.asarray(ys[r]))
        _close(want, got[r], np.abs(ys[r]).max())


# ---- whole decompositions ---------------------------------------------------

def test_emd_batch_matches_jax(skewed_batch):
    t, ys = skewed_batch
    jm, jr, jk, ju = J.emd_batch(t, jnp.asarray(ys), max_modes=4, return_units=True)
    pm, pr, pk, pu = P.emd_batch(_T(t), _T(ys), max_modes=4, return_units=True)
    scale = np.abs(ys).max()
    _close(jm, pm, scale)
    _close(jr, pr, scale)
    np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(pu.numpy(), np.asarray(ju))


def test_pool_units_skewed(skewed_batch):
    """The fixture really is skewed, or the pool tests exercise nothing."""
    t, ys = skewed_batch
    *_, units = P.emd_batch(_T(t), _T(ys), max_modes=4, return_units=True)
    assert int(units.max()) > 2 * int(units.min())


def test_pool_matches_lockstep_and_members_alone(skewed_batch):
    """Bit for bit: the pool, the batch, and each member run alone."""
    t, ys = skewed_batch
    batch = P.emd_batch(_T(t), _T(ys), max_modes=4, return_units=True)
    pool = P.emd_pool(_T(t), _T(ys), max_modes=4, return_units=True)
    for a, b in zip(batch, pool):
        assert torch.equal(a, b)
    for r in (0, 5):
        alone = P.emd_batch(_T(t), _T(ys[r:r + 1]), max_modes=4, return_units=True)
        for a, b in zip(batch, alone):
            assert torch.equal(a[r], b[0])


def test_emd_iter_matches_jax_and_iter_pool(skewed_batch):
    t, ys = skewed_batch
    m_p, mono_p = P.emd_iter_pool(_T(t), _T(ys))
    for r in (0, 3, 5):
        (jmode, jmono), jits = J._emd_iter_counted(jnp.asarray(t), jnp.asarray(ys[r]))
        (mode, mono), its = P._emd_iter_counted(_T(t), _T(ys[r]))
        _close(jmode, mode, np.abs(ys[r]).max())
        assert (mono, its) == (bool(jmono), int(jits))
        assert mono == bool(mono_p[r])
        if not mono:
            assert torch.equal(P.emd_iter(_T(t), _T(ys[r]))[0], m_p[r])
    # a monotonic series: JAX returns the series as sifted so far and True
    ramp = np.linspace(0.0, 1.0, t.size) ** 2
    (jmode, jmono), jits = J._emd_iter_counted(jnp.asarray(t), jnp.asarray(ramp))
    (mode, mono), its = P._emd_iter_counted(_T(t), _T(ramp))
    assert mono and bool(jmono) and its == int(jits)
    np.testing.assert_array_equal(mode.numpy(), np.asarray(jmode))


@pytest.mark.parametrize("case", ["short", "ramp", "plateau", "pad1", "pad3", "max_iter"])
def test_edge_draws_match_jax(case):
    """Series too short to sift, monotonic, with plateaus, at pad widths 1
    and 3, and with max_iter reached."""
    rng = np.random.default_rng(11)
    kw = {}
    t = np.arange(200.0)
    if case == "short":
        t, Y = np.arange(3.0), np.ones((2, 3))
    elif case == "ramp":
        Y = np.stack([np.linspace(0, 1, 200), np.linspace(0, 1, 200) ** 2])
    elif case == "plateau":
        Y = np.stack([np.round(3 * np.sin(t / 5.0)),
                      np.round(2 * np.sin(t / 3.0) + np.cos(t / 11.0))])
    else:
        Y = np.sin(t[None] / np.array([[4.0], [7.0]])) + 0.3 * rng.standard_normal((2, 200))
        kw = {"pad1": {"pad_width": 1}, "pad3": {"pad_width": 3},
              "max_iter": {"max_iter": 3}}[case]
    jm, jr, jk, ju = J.emd_batch(t, jnp.asarray(Y), max_modes=3, return_units=True, **kw)
    pm, pr, pk, pu = P.emd_batch(_T(t), _T(Y), max_modes=3, return_units=True, **kw)
    scale = np.abs(Y).max()
    _close(jm, pm, scale)
    _close(jr, pr, scale)
    np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(pu.numpy(), np.asarray(ju))
    if case == "short":
        assert int(pk.max()) == 0 and torch.equal(pr, _T(Y))
    if case == "max_iter":
        assert int(pk.min()) >= 1


def test_pool_short_series_all_done():
    modes, residue, n_modes = P.emd_pool(_T(np.arange(3.0)), _T(np.ones((5, 3))), max_modes=2)
    assert int(n_modes.abs().max()) == 0
    assert torch.equal(residue, _T(np.ones((5, 3))))
    assert float(modes.abs().max()) == 0.0


def test_pool_scheduling_knobs_change_nothing(skewed_batch):
    """min_bucket larger than the batch, and unroll <= 0 (an endless loop
    in the JAX package) taken as 1; bad values raise."""
    t, ys = skewed_batch
    ref = P.emd_batch(_T(t), _T(ys[:3]), max_modes=3)
    for kw in ({"min_bucket": 64}, {"unroll": 0}, {"unroll": -3}, {"unroll": 1}):
        for a, b in zip(ref, P.emd_pool(_T(t), _T(ys[:3]), max_modes=3, **kw)):
            assert torch.equal(a, b)
    for kw in ({"min_bucket": 0}, {"min_bucket": 2.5}, {"unroll": 1.5}):
        with pytest.raises(ValueError):
            P.emd_pool(_T(t), _T(ys[:3]), max_modes=3, **kw)


@pytest.mark.parametrize("n", [7, 1000, 1024])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_imf_count_limit_is_the_float_mean_rule(n, dtype):
    """count < limit is exactly JAX's mean(sigma > theta_1) < alpha."""
    limit = P._imf_count_limit(n, torch.float32 if dtype == np.float32 else torch.float64, 0.05)
    counts = np.arange(n + 1)
    rule = np.asarray(jnp.mean(jnp.asarray(counts[:, None] > np.arange(n)[None, :], dtype),
                               axis=1) < 0.05)
    np.testing.assert_array_equal(counts < limit, rule)


def test_sift_machine_checks_its_inputs():
    t, y = _T(np.arange(8.0)), _T(np.ones((2, 8)))
    with pytest.raises(ValueError):
        P.sift_machine(t, y, max_modes=0)
    with pytest.raises(ValueError):
        P.sift_machine(t, y[0], max_modes=1)
    with pytest.raises(TypeError):
        P.sift_machine(t.half(), y.half(), max_modes=1)
    # the kernel entry takes CUDA tensors only
    with pytest.raises(ValueError):
        P._sift_machine_cuda(t, y, 1, 10, 2, 0.05, 0.5, 0.05)
