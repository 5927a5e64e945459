"""Celerite semiseparable GP solver: O(N) factor, solve and log-determinant.

Port of ``periodicity_tpu/models/gp/solver.py``. The kernel matrix

    K = diag(A) + tril(U W^T) + triu(W U^T)    (semiseparable, rank R)

is built by :func:`celerite_matrices` (eager torch, with any leading batch
axes of the term's hyperparameters), and its three recursions run in
``ops/celerite.py``: on a CUDA tensor the hand-written kernels (the fused
factor and forward substitution, its adjoint, the two-sweep solve), on a
CPU tensor their plain versions. :func:`log_likelihood` is differentiable
through the adjoint kernel; its final sums stay eager torch, so both paths
sum in the same order.

The predictive mean and variance use dense cross-covariances (an [M, N]
product), as in the JAX package.

Times given as arrays go to the card (``core.as_tensor``) unless they are
CPU tensors; the diagonal, the residuals and the prediction times go to the
times' device when they are arrays and must already be there when they are
tensors. Nothing is copied off the card.
"""

import math

import torch

from ...core import as_tensor
from ...ops.celerite import CeleriteLikelihood, celerite_forward, celerite_solve
from ...utils.dtypes import full_float32
from .terms import _k0

__all__ = ["celerite_matrices", "celerite_factor", "celerite_solve",
           "log_likelihood", "GaussianProcess"]


def _at(x, device):
    """``x`` as a tensor on ``device``: an array goes there, a 0-d CPU
    tensor is moved (torch takes CPU scalars beside card tensors too), and
    any other tensor must be there already."""
    if not isinstance(x, torch.Tensor) or (x.dim() == 0 and x.device.type == "cpu"):
        return as_tensor(x, device)
    if x.device != device:
        raise ValueError(f"expected a tensor on {device}, got one on {x.device}")
    return x


def celerite_matrices(term, t, diag):
    """Build (A, U, V, P) for sorted times t [N] and extra diagonal diag.

    A [..., N], U [..., N, R], V [..., N, R], P [..., N-1, R] with R =
    n_real + 2 n_complex and ``...`` the term's batch axes.
    """
    (ar, cr, ac, bc, cc, dc), t = term.coefficients_beside(as_tensor(t))
    batch = ar.shape[:-1]
    n = t.shape[0]
    dt = torch.diff(t)
    tc = t - t[0]  # center for trig accuracy
    cols_u, cols_v, cols_p = [], [], []
    for j in range(ar.shape[-1]):
        cols_u.append(ar[..., j, None].expand(batch + (n,)))
        cols_v.append(torch.ones(batch + (n,), dtype=t.dtype, device=t.device))
        cols_p.append(torch.exp(-cr[..., j, None] * dt))
    for j in range(ac.shape[-1]):
        arg = dc[..., j, None] * tc
        cos, sin = torch.cos(arg), torch.sin(arg)
        a, b = ac[..., j, None], bc[..., j, None]
        cols_u.append(a * cos + b * sin)
        cols_u.append(a * sin - b * cos)
        cols_v.append(cos)
        cols_v.append(sin)
        e = torch.exp(-cc[..., j, None] * dt)
        cols_p.append(e)
        cols_p.append(e)
    U = torch.stack(torch.broadcast_tensors(*cols_u), dim=-1)
    V = torch.stack(torch.broadcast_tensors(*cols_v), dim=-1)
    P = torch.stack(torch.broadcast_tensors(*cols_p), dim=-1)
    A = _at(diag, t.device) + _k0(ar, ac)[..., None]
    return A, U, V, P


def _rows(A, U, V, P, y=None):
    """The operands broadcast to one batch and flattened to rows [B, ...];
    returns them and the batch shape."""
    n, r = U.shape[-2:]
    shapes = [A.shape[:-1], U.shape[:-2], V.shape[:-2], P.shape[:-2]]
    if y is not None:
        shapes.append(y.shape[:-1])
    batch = torch.broadcast_shapes(*shapes)
    b = math.prod(batch)
    A = A.expand(batch + (n,)).reshape(b, n)
    U = U.expand(batch + (n, r)).reshape(b, n, r)
    V = V.expand(batch + (n, r)).reshape(b, n, r)
    P = P.expand(batch + (n - 1, r)).reshape(b, n - 1, r)
    if y is not None:
        y = y.expand(batch + (n,)).reshape(b, n)
    return (A, U, V, P, y), batch


def celerite_factor(A, U, V, P):
    """Cholesky-like factorization K = L diag(D) L^T, L = I + tril(U W^T).

    Returns (D [..., N], W [..., N, R]): one launch of the fused kernel
    (without a right-hand side) on the card, the plain recursion on the CPU.
    """
    (A, U, V, P, _), batch = _rows(A, U, V, P)
    D, W, _, _, _ = celerite_forward(A, U, V, P)
    n, r = U.shape[1:]
    return D.reshape(batch + (n,)), W.reshape(batch + (n, r))


def log_likelihood(term, t, diag, resid):
    """Marginal GP log-likelihood of residuals (y - mean), [...] over the
    term's and the residuals' batch axes.

    One fused sweep: with K = L D L^T and z = L^{-1} y, the quadratic form
    is y^T K^{-1} y = sum z_n^2 / D_n, so the factorization and the forward
    substitution run together and no backward substitution is needed.
    """
    A, U, V, P = celerite_matrices(term, t, diag)
    resid = _at(resid, U.device)
    (A, U, V, P, y), batch = _rows(A, U, V, P, resid)
    n = U.shape[1]
    D, z = CeleriteLikelihood.apply(A, U, V, P, y)
    ll = -0.5 * (torch.sum(z * z / D, dim=-1) + torch.sum(torch.log(D), dim=-1)
                 + n * math.log(2 * math.pi))
    return ll.reshape(batch)


class GaussianProcess:
    """celerite2-like convenience wrapper (reference gp.py:363-396 surface).

    Holds (term, t, diag, mean); exposes compute/log_likelihood/predict used
    by the modelers. One system (no batch axes) for the solves.
    """

    def __init__(self, kernel, mean=0.0):
        self.kernel = kernel
        self.mean = mean
        self._t = None
        self._diag = None

    def compute(self, t, diag=None, yerr=None, quiet=True):
        t = as_tensor(t)
        if diag is None:
            diag = _at(yerr, t.device) ** 2 if yerr is not None else torch.zeros_like(t)
        self._t = t
        self._diag = _at(diag, t.device).expand(t.shape)
        return self

    def log_likelihood(self, y):
        resid = _at(y, self._t.device) - self.mean
        return log_likelihood(self.kernel, self._t, self._diag, resid)

    def _solve(self, rhs):
        A, U, V, P = celerite_matrices(self.kernel, self._t, self._diag)
        D, W = celerite_factor(A, U, V, P)
        return celerite_solve(U, P, D, W, rhs)

    def predict(self, y, t=None, return_var=False):
        """Conditional mean (and variance) at times t, from dense
        cross-covariances. The semiseparable factorization is computed once
        and reused for both solves (one stacked right-hand side)."""
        resid = _at(y, self._t.device) - self.mean
        if t is None:
            t = self._t
        t = _at(t, self._t.device)
        Kstar = self.kernel.get_value(t[:, None] - self._t[None, :])  # [M, N]
        with full_float32():
            if not return_var:
                return self.mean + Kstar @ self._solve(resid)
            rhs = torch.cat([resid[:, None], Kstar.T], dim=1)
            sol = self._solve(rhs)
            alpha, KinvKs = sol[:, 0], sol[:, 1:]
            mu = self.mean + Kstar @ alpha
        var = self.kernel.k0() - torch.sum(Kstar * KinvKs.T, dim=1)
        return mu, var

    def dense_cov(self):
        """Dense K (validation / small-N paths)."""
        t = self._t
        K = self.kernel.get_value(t[:, None] - t[None, :])
        return K + torch.diag(self._diag)
