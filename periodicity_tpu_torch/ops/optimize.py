"""Optimizers behind the containers' fits (scipy.optimize-free).

Port of ``nelder_mead`` and ``levenberg_marquardt`` from
``periodicity_tpu/ops/optimize.py``:

- ``nelder_mead``: the simplex minimizer with scipy's defaults, host numpy
  (a copy of the JAX package's), used by the ACF-quality fit of
  ``TSeries.acf_period_quality``;
- ``levenberg_marquardt``: damped least squares with ``torch.func.jacfwd``
  Jacobians and a fixed iteration count, backing ``TSeries.curvefit`` and
  ``FSeries.curvefit``. It runs on the device of ``p0``.

``lbfgs_box`` (the GP modelers' optimizer) comes with the GP slice.
"""

import numpy as np
import torch

__all__ = ["nelder_mead", "levenberg_marquardt"]


def nelder_mead(fun, x0, args=(), maxiter=None, xatol=1e-4, fatol=1e-4):
    """Nelder-Mead simplex, scipy-default parameters (adaptive=False).
    Returns (x_best, f_best) as numpy."""
    x0 = np.asarray(x0, float)
    n = x0.size
    if maxiter is None:
        maxiter = n * 200
    rho, chi, psi, sigma = 1.0, 2.0, 0.5, 0.5
    nonzdelt, zdelt = 0.05, 0.00025
    sim = np.empty((n + 1, n))
    sim[0] = x0
    for k in range(n):
        y = x0.copy()
        y[k] = y[k] * (1 + nonzdelt) if y[k] != 0 else zdelt
        sim[k + 1] = y
    fsim = np.array([fun(s, *args) for s in sim])
    order = np.argsort(fsim, kind="stable")
    sim, fsim = sim[order], fsim[order]
    it = 1
    while it < maxiter:
        if (
            np.max(np.abs(sim[1:] - sim[0])) <= xatol
            and np.max(np.abs(fsim[0] - fsim[1:])) <= fatol
        ):
            break
        xbar = sim[:-1].mean(axis=0)
        xr = (1 + rho) * xbar - rho * sim[-1]
        fxr = fun(xr, *args)
        doshrink = False
        if fxr < fsim[0]:
            xe = (1 + rho * chi) * xbar - rho * chi * sim[-1]
            fxe = fun(xe, *args)
            if fxe < fxr:
                sim[-1], fsim[-1] = xe, fxe
            else:
                sim[-1], fsim[-1] = xr, fxr
        elif fxr < fsim[-2]:
            sim[-1], fsim[-1] = xr, fxr
        else:
            if fxr < fsim[-1]:
                xc = (1 + psi * rho) * xbar - psi * rho * sim[-1]
                fxc = fun(xc, *args)
                if fxc <= fxr:
                    sim[-1], fsim[-1] = xc, fxc
                else:
                    doshrink = True
            else:
                xcc = (1 - psi) * xbar + psi * sim[-1]
                fxcc = fun(xcc, *args)
                if fxcc < fsim[-1]:
                    sim[-1], fsim[-1] = xcc, fxcc
                else:
                    doshrink = True
            if doshrink:
                for j in range(1, n + 1):
                    sim[j] = sim[0] + sigma * (sim[j] - sim[0])
                    fsim[j] = fun(sim[j], *args)
        order = np.argsort(fsim, kind="stable")
        sim, fsim = sim[order], fsim[order]
        it += 1
    return sim[0], fsim[0]


def levenberg_marquardt(residual_fn, p0, n_iter=50, lam0=1e-3):
    """Damped least squares: minimize ||residual_fn(p)||^2.

    ``residual_fn`` maps a parameter tensor [P] to residuals [N] with
    torch operations. ``p0`` is cast to float64 (a tensor keeps its
    device; anything else goes to the CPU), and so are the residuals: JAX
    promotes a float32 model with float64 parameters to float64 too, where
    torch would keep float32. Every step solves
    (H + lam diag(H) + 1e-12 I) dp = -g with H = J^T J, g = J^T r, as the
    JAX package does, and keeps the step only where it lowers the sum of
    squares; the iteration count is fixed. Returns (p_opt, covariance)
    like curve_fit.
    """
    p = torch.as_tensor(p0).to(torch.float64)

    def residual(q):
        return residual_fn(q).to(q.dtype)

    jac = torch.func.jacfwd(residual)
    eye = 1e-12 * torch.eye(p.shape[0], dtype=p.dtype, device=p.device)
    lam = torch.tensor(lam0, dtype=p.dtype, device=p.device)
    for _ in range(n_iter):
        r = residual(p)
        J = jac(p)
        g = J.T @ r
        H = J.T @ J
        dp = torch.linalg.solve(H + lam * torch.diag(torch.diag(H)) + eye, -g)
        p_new = p + dp
        better = (residual(p_new) ** 2).sum() < (r**2).sum()
        p = torch.where(better, p_new, p)
        lam = torch.where(better, lam * 0.5, lam * 2.0)
    r = residual(p)
    J = jac(p)
    dof = max(r.shape[0] - p.shape[0], 1)
    s2 = (r**2).sum() / dof
    return p, s2 * torch.linalg.inv(J.T @ J + eye)
