"""Optimizers behind the containers' fits (scipy.optimize-free).

Port of ``nelder_mead`` and ``levenberg_marquardt`` from
``periodicity_tpu/ops/optimize.py``:

- ``nelder_mead``: the simplex minimizer with scipy's defaults, host numpy
  (a copy of the JAX package's), used by the ACF-quality fit of
  ``TSeries.acf_period_quality``;
- ``levenberg_marquardt``: damped least squares with ``torch.func.jacfwd``
  Jacobians and a fixed iteration count, backing ``TSeries.curvefit`` and
  ``FSeries.curvefit``. It runs on the device of ``p0``;
- ``lbfgs_box``: L-BFGS under box bounds for the GP modelers, the port's
  own copy of optax's ``lbfgs`` (memory 10, the scaled initial
  preconditioner, the zoom line search with its defaults; optax 0.2.6),
  with ``torch.autograd`` gradients of an objective on the card.
"""

import math

import numpy as np
import torch

__all__ = ["nelder_mead", "levenberg_marquardt", "lbfgs_box"]


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


# optax.lbfgs()'s defaults: scale_by_lbfgs(memory_size=10,
# scale_init_precond=True) and scale_by_zoom_linesearch(
# max_linesearch_steps=20, initial_guess_strategy="one") with that
# transform's other defaults
_MEMORY = 10
_LS_STEPS = 20
_LS_TOL = 0.0
_LS_INCREASE = 2.0
_SLOPE_RTOL = 1e-4
_CURV_RTOL = 0.9
_APPROX_DEC_RTOL = 1e-6
_INTERVAL_THRESHOLD = 1e-5


def _lbfgs_direction(grad, dp_mem, du_mem, rho, scale, idx):
    """The two-loop product of the inverse-Hessian approximation with
    ``grad`` (optax's _precondition_by_lbfgs): memory slots from the newest
    back, the scaled identity, then forwards."""
    m = rho.shape[0]
    order = [(idx + k) % m for k in range(m)]
    vec = grad
    alphas = {}
    for i in reversed(order):
        alphas[i] = rho[i] * np.dot(dp_mem[i], vec)
        vec = vec + (-alphas[i]) * du_mem[i]
    vec = scale * vec
    for i in order:
        beta = rho[i] * np.dot(du_mem[i], vec)
        vec = vec + (alphas[i] - beta) * dp_mem[i]
    return vec


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a; NaN where there is none."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    d1 = np.array([[dc**2, -(db**2)], [-(dc**3), db**3]])
    A, B = np.dot(d1, np.array([fb - fa - C * db, fc - fa - C * dc])) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + np.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the parabola through (a, fa), (b, fb) with slope
    fpa at a."""
    db = b - a
    B = (fb - fa - fpa * db) / (db**2)
    return a - fpa / (2.0 * B)


def _nan_to_inf(x):
    return np.inf if np.isnan(x) else x


def _zoom_linesearch(value_and_grad, params, updates, value, grad):
    """optax's zoom line search (Nocedal and Wright, algorithms 3.5 and
    3.6) along ``updates`` from ``params``, with the defaults above and an
    initial guess of 1. Returns the step size."""
    slope_init = np.dot(updates, grad)

    def on_line(stepsize):
        v, g = value_and_grad(params + stepsize * updates)
        return v, np.dot(g, updates)

    def decrease_error(stepsize, value_step, slope_step):
        err = value_step - value - _SLOPE_RTOL * stepsize * slope_init
        approx = np.maximum(slope_step - (2 * _SLOPE_RTOL - 1.0) * slope_init,
                            value_step - value - _APPROX_DEC_RTOL * np.abs(value))
        return _nan_to_inf(np.maximum(np.minimum(approx, err), 0.0))

    def curvature_error(slope_step):
        return _nan_to_inf(np.maximum(np.abs(slope_step) - _CURV_RTOL * np.abs(slope_init), 0.0))

    zero = params.dtype.type(0.0)
    s = {"count": 0, "stepsize": zero, "value": value, "slope": slope_init,
         "decrease_error": np.inf, "interval_found": False, "done": False, "failed": False,
         "low": zero, "value_low": value, "slope_low": slope_init, "high": zero,
         "value_high": value, "slope_high": slope_init, "cubic_ref": zero,
         "value_cubic_ref": value, "safe_stepsize": zero, "safe_value": value}

    def search(s):
        new = params.dtype.type(1.0) if s["count"] == 0 else _LS_INCREASE * s["stepsize"]
        v, sl = on_line(new)
        dec, curv = decrease_error(new, v, sl), curvature_error(sl)
        error = max(dec, curv)
        if dec <= _LS_TOL:
            s["safe_stepsize"], s["safe_value"] = new, v
        high_new = dec > 0.0 or (v >= s["value"] and s["count"] > 0)
        low_new = sl >= 0.0 and not high_new
        prev, cur = (s["stepsize"], s["value"], s["slope"]), (new, v, sl)
        lo, hi = (cur, prev) if low_new else (prev, cur)
        s["low"], s["value_low"], s["slope_low"] = lo
        s["high"], s["value_high"], s["slope_high"] = hi
        s["interval_found"] = high_new or low_new or error <= _LS_TOL
        s["done"] = error <= _LS_TOL
        s["failed"] = s["count"] + 1 >= _LS_STEPS and not s["done"]
        s.update(count=s["count"] + 1, stepsize=new, value=v, slope=sl, decrease_error=dec,
                 cubic_ref=lo[0], value_cubic_ref=lo[1])

    def zoom(s):
        low, high = s["low"], s["high"]
        delta = np.abs(high - low)
        left, right = np.minimum(high, low), np.maximum(high, low)
        cubic = _cubicmin(low, s["value_low"], s["slope_low"], high, s["value_high"],
                          s["cubic_ref"], s["value_cubic_ref"])
        quad = _quadmin(low, s["value_low"], s["slope_low"], high, s["value_high"])
        if left + 0.2 * delta < cubic < right - 0.2 * delta:
            middle = cubic
        elif left + 0.1 * delta < quad < right - 0.1 * delta:
            middle = quad
        else:
            middle = (low + high) / 2.0
        v, sl = on_line(middle)
        dec, curv = decrease_error(middle, v, sl), curvature_error(sl)
        if dec <= _LS_TOL and v < s["safe_value"]:
            s["safe_stepsize"], s["safe_value"] = middle, v
        s["done"] = max(dec, curv) <= _LS_TOL
        high_mid = dec > 0.0 or v >= s["value_low"]
        high_low = sl * (high - low) >= 0.0 and not high_mid
        mid = (middle, v, sl)
        lo = (low, s["value_low"], s["slope_low"])
        hi = (high, s["value_high"], s["slope_high"])
        cref = hi if (high_mid or high_low) else lo
        s["high"], s["value_high"], s["slope_high"] = lo if high_low else (
            mid if high_mid else hi)
        s["low"], s["value_low"], s["slope_low"] = lo if high_mid else mid
        s["cubic_ref"], s["value_cubic_ref"] = cref[0], cref[1]
        too_small = delta <= _INTERVAL_THRESHOLD
        s["failed"] = (s["count"] + 1 >= _LS_STEPS
                       or (too_small and s["safe_stepsize"] > 0.0)) and not s["done"]
        s.update(count=s["count"] + 1, stepsize=middle, value=v, slope=sl, decrease_error=dec)

    with np.errstate(all="ignore"):
        while not (s["done"] or s["failed"]):
            (zoom if s["interval_found"] else search)(s)
            # a failed search falls back on the best step with sufficient
            # decrease, and on no step where the last one left the domain
            if s["failed"] and (s["safe_stepsize"] > 0.0 or np.isinf(s["decrease_error"])):
                s["stepsize"] = s["safe_stepsize"]
    return s["stepsize"]


def lbfgs_box(fun, x0, lower, upper, max_steps=200, tol=1e-9):
    """L-BFGS minimization of fun(x) subject to lower < x < upper.

    The box is a scaled-sigmoid change of variables (always strictly
    interior, like the reference's hypercube bounds, gp.py:409): x = lower
    + (upper - lower) sigmoid(v). ``fun`` maps a tensor [D] on x0's device
    (the card for an array) to a 0-d tensor, differentiably; its gradient
    in v comes from torch.autograd. The L-BFGS algebra over the D numbers
    runs on the host in x0's dtype, and each evaluation of the objective
    makes one host read (its value and gradient together). The loop stops
    when the gradient norm at the start of an iteration is at most ``tol``
    or after ``max_steps`` iterations, as the JAX package's while-loop does.
    Returns (x_opt, f_opt) as tensors on x0's device.
    """
    from ..core import as_tensor

    x0 = as_tensor(x0)
    if not x0.is_floating_point():
        x0 = x0.to(torch.float64)
    device, dtype = x0.device, x0.dtype
    lower = torch.as_tensor(lower, device=device).to(dtype)
    upper = torch.as_tensor(upper, device=device).to(dtype)
    frac = torch.clamp((x0 - lower) / (upper - lower), 1e-6, 1 - 1e-6)
    v = torch.log(frac / (1 - frac)).cpu().numpy()
    np_dtype = v.dtype.type

    def to_x(vt):
        return lower + (upper - lower) * torch.sigmoid(vt)

    def value_and_grad(v_host):
        vt = torch.from_numpy(np.asarray(v_host, np_dtype)).to(device).requires_grad_(True)
        with torch.enable_grad():
            f = fun(to_x(vt))
            (g,) = torch.autograd.grad(f, vt)
        out = torch.cat([f.detach().reshape(1).to(dtype), g]).cpu().numpy()
        return out[0], out[1:]

    d = v.shape[0]
    dp_mem = np.zeros((_MEMORY, d), np_dtype)
    du_mem = np.zeros((_MEMORY, d), np_dtype)
    rho = np.zeros(_MEMORY, np_dtype)
    prev_v = prev_g = None
    k = 0
    gnorm = math.inf
    with np.errstate(all="ignore"):
        while k < max_steps and gnorm > tol:
            value, grad = value_and_grad(v)
            # the memory of parameter and gradient differences (none at the
            # first iteration), and the scale of the initial inverse
            # Hessian: a capped reciprocal gradient norm at first
            idx, prev_idx = k % _MEMORY, (k - 1) % _MEMORY
            if k > 0:
                dparams, dgrad = v - prev_v, grad - prev_g
                vd = np.dot(dgrad, dparams)
                dp_mem[prev_idx], du_mem[prev_idx] = dparams, dgrad
                rho[prev_idx] = 0.0 if vd == 0.0 else 1.0 / vd
                den = np.dot(dgrad, dgrad)
                scale = vd / den if den > 0.0 else np_dtype(1.0)
            else:
                scale = np.minimum(np_dtype(1.0), 1.0 / np.sqrt(np.dot(grad, grad)))
            direction = -_lbfgs_direction(grad, dp_mem, du_mem, rho, scale, idx)
            prev_v, prev_g = v, grad
            step = _zoom_linesearch(value_and_grad, v, direction, value, grad)
            v = v + step * direction
            k += 1
            gnorm = float(np.sqrt(np.dot(grad, grad)))
    with torch.no_grad():
        x = to_x(torch.from_numpy(np.asarray(v, np_dtype)).to(device))
        return x, fun(x)
