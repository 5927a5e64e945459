"""Optimizer parity: periodicity_tpu_torch.ops.optimize vs the JAX package.

The same numpy draws go to both packages, the JAX side on the CPU in x64.
``nelder_mead`` is the same host numpy in both and must be equal.
``levenberg_marquardt`` takes the same fixed number of damped steps from
the same start, with Jacobians from ``torch.func.jacfwd`` and
``jax.jacfwd``: parameters within rtol 1e-8 and covariances within rtol
1e-6 (its ``1e-12 I`` ridge against J^T J of ~1e2 leaves ~1e-8 of
rounding to amplify). On float32 data torch evaluates the model in
float32 (a 0-d float64 parameter does not promote a float32 tensor), where
JAX promotes it to float64: there the parameters agree to 1e-5 and the
covariances to 1e-4, a few float32 ulps amplified by the fit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from periodicity_tpu.ops import optimize as J
from periodicity_tpu_torch.ops import optimize as P


def test_nelder_mead_equals_jax():
    def rosen(p, a):
        return (a - p[0]) ** 2 + 100.0 * (p[1] - p[0] ** 2) ** 2

    for x0 in ([-1.2, 1.0], [0.0, 0.0], [3.0, -2.0]):
        x, f = P.nelder_mead(rosen, x0, args=(1.0,))
        jx, jf = J.nelder_mead(rosen, x0, args=(1.0,))
        np.testing.assert_array_equal(x, jx)
        assert f == jf


@pytest.mark.parametrize("dtype,rtol", [(np.float64, (1e-8, 1e-6)), (np.float32, (1e-5, 1e-4))])
def test_levenberg_marquardt_matches_jax(dtype, rtol):
    rng = np.random.default_rng(0)
    t = np.linspace(0, 10, 120).astype(dtype)
    y = (2.5 * np.sin(1.3 * t) + 0.5 + 0.05 * rng.standard_normal(120)).astype(dtype)
    tt, yt = torch.from_numpy(t), torch.from_numpy(y)

    def port_res(p):
        return p[0] * torch.sin(p[1] * tt) + p[2] - yt

    def jax_res(p):
        return p[0] * jnp.sin(p[1] * t) + p[2] - y

    p, cov = P.levenberg_marquardt(port_res, [1.0, 1.2, 0.0])
    jp, jcov = J.levenberg_marquardt(jax_res, jnp.asarray([1.0, 1.2, 0.0]))
    assert p.dtype == cov.dtype == torch.float64
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=rtol[0])
    np.testing.assert_allclose(cov.numpy(), np.asarray(jcov), rtol=rtol[1])
    np.testing.assert_allclose(p.numpy(), [2.5, 1.3, 0.5], rtol=0, atol=0.05)
