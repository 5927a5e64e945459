"""GP period-inference modelers.

Port of ``periodicity_tpu/models/gp/modelers.py`` (reference gp.py:156-538):

- CeleriteModeler / BrownianGP / HarmonicGP: unit-hypercube
  parameterization (prior_transform with ndtri-based gaussian PPFs), the
  celerite solver for O(N) likelihoods (on the card, the fused recursion
  kernel and its adjoint; ``solver="pscan"``, ``"blocked"`` or
  ``"chunked"`` for the Kalman forms of ``pscan.py``; ``solver="sharded"``
  with a ``mesh`` for the time axis laid over its ``mesh_axis``), exact autograd
  gradients for the hypercube L-BFGS, the ensemble sampler and NUTS.
  Log-probabilities are batched: a [B, D] batch of hypercube points
  becomes terms with a batch axis, one kernel launch for all of them.
- GeorgeModeler / QuasiPeriodicGP: the dense Const x ExpSquared x ExpSine2
  GP through ``torch.linalg.cholesky`` (batched over walkers), in the
  signal's dtype.

Modeler objects are thin shells holding data and configuration; they live
on the signal's device.
"""

import functools
import math
import types

import numpy as np
import torch

from ...core import TSeries, as_tensor
from ...core.containers import _host
from ...ops.optimize import lbfgs_box
from ...utils.dtypes import full_float32
from ...utils.logging import log_event
from . import mcmc as _mcmc
from .nuts import run_nuts
from ...parallel.mesh import axis_info
from .pscan import (
    log_likelihood_blocked,
    log_likelihood_chunked,
    log_likelihood_pscan,
    log_likelihood_sharded,
)
from .solver import GaussianProcess, log_likelihood
from .terms import BrownianTerm, RotationTerm

__all__ = [
    "CeleriteModeler",
    "BrownianGP",
    "HarmonicGP",
    "GeorgeModeler",
    "QuasiPeriodicGP",
]

_LOG_2PI = math.log(2 * math.pi)
_SOLVERS = {"scan": log_likelihood, "pscan": log_likelihood_pscan,
            "blocked": log_likelihood_blocked, "chunked": log_likelihood_chunked}


def _norm_ppf(u, mu, sd):
    return mu + sd * torch.special.ndtri(u)


def _norm_logpdf(x, mu, sd):
    z = (x - mu) / sd
    return -0.5 * z * z - math.log(sd) - 0.5 * _LOG_2PI


def _signal(signal):
    return signal if isinstance(signal, TSeries) else TSeries(values=signal)


def _dtype(y):
    return y.dtype if y.is_floating_point() else torch.float64


def _nuts_run_and_record(modeler, log_prob_fn, x0, seed, n_steps, n_warmup, max_depth,
                         target_accept, burn, chain_transform=None):
    """NUTS bookkeeping shared by both modeler families: run the sampler,
    keep chain, acceptance, diagnostics and a sampler shim on the modeler,
    log the done event, and return (flat post-burn samples, autocorr time)."""
    out = run_nuts(log_prob_fn, x0, seed, int(n_steps), n_warmup=int(n_warmup),
                   max_depth=max_depth, target_accept=target_accept)
    chain = out["chain"]
    if chain_transform is not None:
        chain = chain_transform(chain)
    modeler.chain = _host(chain)
    modeler.acceptance = float(out["accept_prob"].mean())
    modeler.nuts_diagnostics = {k: _host(out[k]) for k in (
        "divergences", "step_size", "inv_mass", "tree_depth", "n_leapfrog", "n_leapfrog_warmup")}
    samples = modeler.chain[burn:].reshape(-1, modeler.ndim)
    tau = _mcmc.autocorr_time(modeler.chain[burn:])
    modeler.nuts_diagnostics["ess"] = _mcmc.ess(modeler.chain[burn:], tau=tau)
    try:
        modeler.nuts_diagnostics["rhat"] = _mcmc.rhat(modeler.chain[burn:])
    except ValueError:  # fewer than 4 post-burn steps
        modeler.nuts_diagnostics["rhat"] = np.full(modeler.ndim, np.nan)
    log_event("gp_nuts_done", modeler=type(modeler).__name__, acceptance=modeler.acceptance,
              divergences=int(np.sum(modeler.nuts_diagnostics["divergences"])),
              min_ess=float(np.min(modeler.nuts_diagnostics["ess"])),
              max_rhat=float(np.nanmax(modeler.nuts_diagnostics["rhat"])))
    modeler.sampler = types.SimpleNamespace(chain=modeler.chain, acceptance=modeler.acceptance)
    return samples, tau


class CeleriteModeler:
    """Hypercube-parameterized celerite GP modeler
    (reference gp.py:340-484). Subclasses define ndim, _kernel(params) and
    prior_transform(u) with u in (0, 100)^ndim (u [ndim] or [ndim, ...]:
    the first axis is the parameter)."""

    def __init__(self, signal, err, init_period=None, period_ppf=None,
                 solver="scan", mesh=None, mesh_axis="seq"):
        signal = _signal(signal)
        if solver == "sharded":
            if mesh is None:
                raise ValueError("solver='sharded' needs a torch.distributed DeviceMesh via mesh=")
            d = axis_info(mesh, mesh_axis)[0]
            if signal.size % d:
                raise ValueError(f"series length {signal.size} must be divisible by mesh axis "
                                 f"{mesh_axis!r} size {d}")
            self._ll = functools.partial(log_likelihood_sharded, mesh=mesh, axis=mesh_axis)
        elif solver in _SOLVERS:
            self._ll = _SOLVERS[solver]
        else:
            raise ValueError(f"unknown solver {solver!r}")
        self.solver = solver
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        self.signal = signal
        self.err = as_tensor(err, signal.device)
        self.t = signal.time
        self.y = signal.values
        self.dtype = _dtype(self.y)
        self.sigma = float(np.std(_host(self.y)))
        self.jitter = float(np.min(_host(self.err))) ** 2
        self.mean = float(np.mean(_host(self.y)))
        if init_period is None:
            init_period = float(np.sqrt(signal.size) * float(signal.median_dt))
        self.init_period = init_period
        self.sigma_period = 0.5 * np.log(signal.size)
        if period_ppf is None:
            lp = float(np.log(init_period))
            sp = float(self.sigma_period)

            def period_ppf(u):
                return torch.exp(_norm_ppf(u, lp, sp))

        self.period_ppf = period_ppf
        init_params = self.prior_transform(self._u(np.full(self.ndim, 50.0)))
        params = dict(init_params)
        mean = params.pop("mean")
        jitter = params.pop("jitter")
        self.gp = GaussianProcess(self._kernel(**params), mean=mean)
        self.gp.compute(self.t, diag=self.err**2 + jitter)

    def _u(self, u):
        """A hypercube point (or a batch) as a tensor on the signal's device."""
        if isinstance(u, torch.Tensor):
            return u.to(self.t.device)
        return torch.as_tensor(np.array(u), dtype=self.dtype, device=self.t.device)

    # -- functions of the hypercube vector u [ndim] or a batch [B, ndim] -----
    def _build(self, u):
        params = dict(self.prior_transform(u.movedim(-1, 0)))
        mean = params.pop("mean")
        jitter = params.pop("jitter")
        kernel = self._kernel(**params)
        return kernel, mean, jitter

    def _nll_u(self, u):
        kernel, mean, jitter = self._build(u)
        ll = self._ll(kernel, self.t, self.err**2 + jitter[..., None], self.y - mean[..., None])
        return -ll

    def _log_prob_u(self, u):
        inside = torch.all((u > 0.01) & (u < 99.99), dim=-1)
        u_c = torch.clamp(u, 0.0101, 99.9899)
        ll = -self._nll_u(u_c)
        ll = torch.where(torch.isfinite(ll), ll, -math.inf)
        return torch.where(inside, ll, -math.inf)

    def _log_prob_x(self, x):
        """Unconstrained-space log posterior [...] for gradient-based
        sampling: x in R^ndim (or a batch [..., ndim]), u = 100 sigmoid(x),
        plus the log-Jacobian of the transform (so the density over x
        matches the hypercube posterior)."""
        u = torch.clamp(100.0 * torch.sigmoid(x), 0.0101, 99.9899)
        ll = -self._nll_u(u)
        ll = torch.where(torch.isfinite(ll), ll, -math.inf)
        log_jac = torch.sum(math.log(100.0) + torch.nn.functional.logsigmoid(x)
                            + torch.nn.functional.logsigmoid(-x), dim=-1)
        return ll + log_jac

    # -- reference API surface ------------------------------------------------
    def prior_transform(self, u):
        raise NotImplementedError("subclasses must implement this method")

    def set_params(self, params, gp):
        params = dict(params)
        gp.mean = params.pop("mean")
        jitter = params.pop("jitter")
        gp.kernel = self._kernel(**params)
        gp.compute(self.t, diag=self.err**2 + jitter, quiet=True)
        return gp

    def get_psd(self, frequency, gp):
        return gp.kernel.get_psd(2 * math.pi * as_tensor(frequency, self.t.device))

    def get_prediction(self, time, gp):
        mu, var = gp.predict(self.y, t=as_tensor(time, self.t.device), return_var=True)
        return mu, torch.sqrt(var)

    def get_kernel(self, tau, gp):
        return gp.kernel.get_value(as_tensor(tau, self.t.device))

    def loocv(self, gp):
        """Log leave-one-out CV (reference gp.py:387-396): O(N^2) solves on
        the factorized kernel (on the card, one launch of the solve kernel
        with N columns)."""
        n = self.signal.size
        r = self.y - gp.mean
        q = gp._solve(r)
        c = torch.diagonal(gp._solve(torch.eye(n, dtype=r.dtype, device=r.device)))
        return -0.5 * (torch.sum(q**2 / c) - torch.sum(torch.log(c)) + n * _LOG_2PI)

    def nll(self, u, gp=None):
        with torch.no_grad():
            return float(self._nll_u(self._u(u)))

    def minimize(self, gp=None, u0=None, **kwargs):
        """Exact-gradient L-BFGS in the unit hypercube
        (reference gp.py:404-415)."""
        if u0 is None:
            u0 = np.full(self.ndim, 50.0)
        log_event("gp_minimize", modeler=type(self).__name__,
                  n=self.signal.size, ndim=self.ndim, solver=self.solver)
        full = lambda v: torch.full((self.ndim,), v, dtype=self.dtype,  # noqa: E731
                                    device=self.t.device)
        x, fval = lbfgs_box(self._nll_u, self._u(u0), lower=full(0.01), upper=full(99.99),
                            **kwargs)
        log_event("gp_minimize_done", modeler=type(self).__name__, fun=float(fval))
        soln = types.SimpleNamespace(x=_host(x), fun=float(fval))
        with torch.no_grad():
            opt_params = self.prior_transform(x)
            opt_gp = self.set_params(dict(opt_params), self.gp)
        return soln, opt_gp

    def log_prob(self, u, gp=None, psd_at=None):
        u = self._u(u)
        with torch.no_grad():
            ll = float(self._log_prob_u(u))
            if psd_at is None:
                return ll
            kernel, _, _ = self._build(torch.clamp(u, 0.0101, 99.9899))
            return ll, kernel.get_psd(2 * math.pi * as_tensor(psd_at, self.t.device))

    def mcmc(
        self,
        n_walkers=50,
        n_steps=1000,
        burn=0,
        use_prior=False,
        psd_at=None,
        random_seed=None,
        checkpoint_path=None,
        checkpoint_every=100,
    ):
        """Posterior sampling with the ensemble sampler (reference
        gp.py:428-484 drives emcee): batched stretch moves, one likelihood
        launch a half-ensemble.

        With ``checkpoint_path``, the run saves resumable state every
        ``checkpoint_every`` steps and continues from an existing
        checkpoint after an interruption.

        Returns (trace dict, tau) like the reference; also sets self.chain,
        self.acceptance, and self.psds when psd_at is given. The draws come
        from torch generators seeded from ``random_seed``, so the chain
        differs from the JAX package's.

        Divergence: ``use_prior=True`` initializes walkers uniformly over
        the full hypercube (0, 100)^ndim, where the reference draws from
        (0, 1)^ndim (gp.py:467), as in the JAX package.
        """
        log_event("gp_mcmc", modeler=type(self).__name__,
                  n=self.signal.size, n_walkers=n_walkers, n_steps=n_steps,
                  solver=self.solver, checkpointed=checkpoint_path is not None)
        seed = 0 if random_seed is None else int(random_seed)
        dev = self.t.device
        g_init = _mcmc._generator(dev, (seed, 0))
        shape = (n_walkers, self.ndim)
        with torch.no_grad():
            if use_prior:
                u0 = torch.rand(shape, generator=g_init, dtype=self.dtype, device=dev) * 100.0
                u0 = torch.clamp(u0, 0.02, 99.98)
            else:
                soln, _ = self.minimize(self.gp)
                u0 = self._u(soln.x)[None, :] + 1e-3 * torch.randn(
                    shape, generator=g_init, dtype=self.dtype, device=dev)
            if checkpoint_path is not None:
                chain, _, acc = _mcmc.run_ensemble_checkpointed(
                    self._log_prob_u, u0, (seed, 1), int(n_steps),
                    checkpoint_path=checkpoint_path, checkpoint_every=checkpoint_every)
            else:
                chain, _, acc = _mcmc.run_ensemble(self._log_prob_u, u0, (seed, 1), int(n_steps))
            self.chain = _host(chain)
            self.acceptance = float(acc)
            log_event("gp_mcmc_done", modeler=type(self).__name__, acceptance=self.acceptance)
            samples = self.chain[burn:].reshape(-1, self.ndim)
            tau = _mcmc.autocorr_time(self.chain[burn:])
            trace = self.prior_transform(self._u(samples.T))
            trace = {k: _host(v) for k, v in dict(trace).items()}
            if psd_at is not None:
                kernel, _, _ = self._build(self._u(samples))
                self.psds = _host(kernel.get_psd(2 * math.pi * as_tensor(psd_at, dev)))
        self.sampler = types.SimpleNamespace(chain=self.chain, acceptance=self.acceptance)
        return trace, tau

    def nuts(self, n_chains=4, n_steps=1000, n_warmup=500, burn=0, max_depth=8,
             target_accept=0.8, psd_at=None, random_seed=None):
        """Gradient-based posterior sampling with NUTS: exact autograd
        gradients through the celerite solver (G2 on the card), in the
        logit-unconstrained image of the unit hypercube. This fills the role
        of the reference's dead ``celerite2.theano`` backend (gp.py:541-637).
        Chains start around the MLE and adapt step size and diagonal mass
        independently.

        Returns (trace dict, tau) like :meth:`mcmc`; also sets ``self.chain``
        (hypercube coordinates), ``self.acceptance``,
        ``self.nuts_diagnostics`` (divergences, step sizes, mass, tree
        depths, leapfrog counts, ESS, split R-hat) and, with ``psd_at``,
        ``self.psds``. The start's draw comes from a generator seeded
        (seed, 0) and the run's from (seed, 1), so the chains differ from
        the JAX package's.
        """
        log_event("gp_nuts", modeler=type(self).__name__, n=self.signal.size,
                  n_chains=n_chains, n_steps=n_steps, n_warmup=n_warmup, solver=self.solver)
        seed = 0 if random_seed is None else int(random_seed)
        dev = self.t.device
        g_init = _mcmc._generator(dev, (seed, 0))
        soln, _ = self.minimize(self.gp)
        frac = torch.clamp(self._u(soln.x) / 100.0, 1e-4, 1 - 1e-4)
        x_mle = torch.log(frac / (1 - frac))
        x0 = x_mle[None, :] + 0.1 * torch.randn((n_chains, self.ndim), generator=g_init,
                                                dtype=self.dtype, device=dev)
        samples, tau = _nuts_run_and_record(
            self, self._log_prob_x, x0, (seed, 1), n_steps, n_warmup, max_depth,
            target_accept, burn, chain_transform=lambda c: 100.0 * torch.sigmoid(c))
        with torch.no_grad():
            trace = self.prior_transform(self._u(samples.T))
            trace = {k: _host(v) for k, v in dict(trace).items()}
            if psd_at is not None:
                kernel, _, _ = self._build(self._u(samples))
                self.psds = _host(kernel.get_psd(2 * math.pi * as_tensor(psd_at, dev)))
        return trace, tau


class BrownianGP(CeleriteModeler):
    """SHO + overdamped-background kernel modeler (reference gp.py:500-517)."""

    def __init__(self, signal, err, init_period=None, period_ppf=None,
                 solver="scan", **kw):
        self.ndim = 6
        super().__init__(signal, err, init_period, period_ppf, solver, **kw)

    def _kernel(self, sigma, tau, period, mix):
        return BrownianTerm(sigma, tau, period, mix)

    def prior_transform(self, u):
        u = self._u(u) / 100
        # reference coordinate order (gp.py:508-512): u[3] -> period,
        # u[2] -> the log-uniform tau multiplier
        period = self.period_ppf(u[3])
        return {
            "mean": _norm_ppf(u[0], self.mean, self.sigma),
            "sigma": torch.exp(_norm_ppf(u[1], math.log(self.sigma), 2.0)),
            "tau": period * 10 ** u[2],
            "period": period,
            "mix": u[4] * 0.5,
            "jitter": torch.exp(_norm_ppf(u[5], math.log(self.jitter), 2.0)),
        }


class HarmonicGP(CeleriteModeler):
    """RotationTerm kernel modeler (reference gp.py:520-538)."""

    def __init__(self, signal, err, init_period=None, period_ppf=None,
                 solver="scan", **kw):
        self.ndim = 7
        super().__init__(signal, err, init_period, period_ppf, solver, **kw)

    def _kernel(self, sigma, period, Q0, dQ, f):
        return RotationTerm(sigma=sigma, period=period, Q0=Q0, dQ=dQ, f=f)

    def prior_transform(self, u):
        u = self._u(u) / 100
        period = self.period_ppf(u[2])
        return {
            "mean": _norm_ppf(u[0], self.mean, self.sigma),
            "sigma": torch.exp(_norm_ppf(u[1], math.log(self.sigma), 2.0)),
            "period": period,
            "Q0": torch.exp(_norm_ppf(u[3], 1.0, 5.0)),
            "dQ": torch.exp(_norm_ppf(u[4], 2.0, 5.0)),
            "f": u[5],
            "jitter": torch.exp(_norm_ppf(u[6], math.log(self.jitter), 2.0)),
        }


class GeorgeModeler:
    """Dense quasi-periodic GP modeler (reference gp.py:156-293).

    Parameter vector follows george's ordering for the
    Const*ExpSquared*ExpSine2 kernel: [mean, log_jitter, log_sigma2,
    log_tau2, gamma, log_period]. Functions of theta take [D] or a batch
    [..., D]; the dense kernel and its Cholesky factor are batched along.
    Gradients come from autograd.
    """

    def __init__(
        self,
        signal,
        err,
        init_period=None,
        period_prior=None,
        bounds=None,
        constraints=None,
    ):
        signal = _signal(signal)
        self.signal = signal
        self.err = as_tensor(err, signal.device)
        self.t = signal.time
        self.y = signal.values
        self.dtype = _dtype(self.y)
        self.sigma = float(np.std(_host(self.y)))
        self.jitter = float(np.min(_host(self.err))) ** 2
        self.mean = float(np.mean(_host(self.y)))
        if init_period is None:
            init_period = float(np.sqrt(signal.size) * float(signal.median_dt))
        self.init_period = init_period
        if period_prior is None:
            sd_p = float(0.2 * np.log(signal.size))
            lp0 = float(np.log(init_period))

            def period_prior(period):
                return _norm_logpdf(torch.log(period), lp0, sd_p)

        self.period_prior = period_prior
        self.bounds = bounds
        self.constraints = constraints
        self.theta0 = self._theta(self._init_theta())
        self.ndim = self.theta0.shape[0]

    def _theta(self, theta):
        if isinstance(theta, torch.Tensor):
            return theta.to(self.t.device)
        return torch.as_tensor(np.array(theta), dtype=self.dtype, device=self.t.device)

    def _init_theta(self):
        raise NotImplementedError("subclasses must implement this method")

    def _kernel_value(self, theta, dt):
        raise NotImplementedError("subclasses must implement this method")

    def _nll_theta(self, theta):
        t = self.t
        K = self._kernel_value(theta, t[:, None] - t[None, :])
        K = K + torch.diag_embed(self.err**2 + torch.exp(theta[..., 1, None]))
        r = self.y - theta[..., 0, None]
        with full_float32():
            L, info = torch.linalg.cholesky_ex(K)
            alpha = torch.cholesky_solve(r[..., None], L)[..., 0]
        n = r.shape[-1]
        ll = -0.5 * (
            torch.sum(r * alpha, dim=-1)
            + 2 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)
            + n * _LOG_2PI
        )
        # a matrix that is not positive definite has no factor (JAX's is NaN)
        ll = torch.where(info == 0, ll, math.nan)
        return torch.where(torch.isfinite(ll), -ll, 1e25)

    def log_prior(self, theta):
        raise NotImplementedError("subclasses must implement this method")

    def _log_prob_theta(self, theta):
        lp = self.log_prior(theta)
        ll = -self._nll_theta(theta)
        total = lp + ll
        return torch.where(torch.isfinite(total), total, -math.inf)

    def nll(self, theta, gp=None):
        with torch.no_grad():
            return float(self._nll_theta(self._theta(theta)))

    def grad_nll(self, theta, gp=None):
        theta = self._theta(theta).detach().requires_grad_(True)
        (g,) = torch.autograd.grad(self._nll_theta(theta), theta)
        return _host(g)

    def minimize(self, gp=None, grad=True, **kwargs):
        lower = self._theta([b[0] for b in self.bounds])
        upper = self._theta([b[1] for b in self.bounds])

        fun = self._nll_theta
        if self.constraints is not None:
            cons = self.constraints

            def fun(theta, _base=self._nll_theta):
                c = cons["fun"](theta)
                return _base(theta) + torch.where(c < 0, 1e6 * c**2, 0.0)

        log_event("gp_minimize", modeler=type(self).__name__,
                  n=self.signal.size, ndim=self.ndim)
        x, _ = lbfgs_box(fun, self.theta0, lower=lower, upper=upper, **kwargs)
        soln = types.SimpleNamespace(x=_host(x), fun=self.nll(x))
        log_event("gp_minimize_done", modeler=type(self).__name__, fun=soln.fun)
        return soln, self

    def log_prob(self, theta, gp=None):
        with torch.no_grad():
            return float(self._log_prob_theta(self._theta(theta)))

    def predict(self, theta, t_new, return_var=True):
        """Conditional prediction at new times under hyperparameters theta."""
        theta = self._theta(theta)
        t = self.t
        t_new = as_tensor(t_new, t.device)
        K = self._kernel_value(theta, t[:, None] - t[None, :])
        K = K + torch.diag(self.err**2 + torch.exp(theta[1]))
        Ks = self._kernel_value(theta, t_new[:, None] - t[None, :])
        r = self.y - theta[0]
        with full_float32():
            L = torch.linalg.cholesky(K)
            alpha = torch.cholesky_solve(r[:, None], L)[:, 0]
            mu = theta[0] + Ks @ alpha
            if not return_var:
                return mu
            v = torch.cholesky_solve(Ks.T, L)
        k0 = self._kernel_value(theta, torch.zeros(1, dtype=t.dtype, device=t.device))[0]
        var = k0 - torch.sum(Ks * v.T, dim=1)
        return mu, torch.sqrt(var)

    def set_params(self, theta, gp=None):
        """Apply a hyperparameter vector (reference gp.py:208-211): the
        vector becomes the default theta of get_prediction/get_kernel, and
        the modeler itself plays the gp role in the return value."""
        theta = self._theta(theta)
        if theta.shape != (self.ndim,):
            # the reference's set_parameter_vector raises on a length mismatch
            raise ValueError(f"theta has shape {tuple(theta.shape)}, expected ({self.ndim},)")
        self.theta0 = theta
        return self

    def _theta_of(self, theta):
        if theta is None:
            return self.theta0
        if isinstance(theta, GeorgeModeler):
            return theta.theta0
        return self._theta(theta)

    def get_prediction(self, time, theta=None):
        """Conditional mean and sd at new times (reference gp.py:213-216).
        ``theta`` may be a hyperparameter vector, None (the stored default),
        or another modeler instance (the reference's ``gp`` argument)."""
        return self.predict(self._theta_of(theta), time, return_var=True)

    def get_kernel(self, tau, theta=None):
        """Kernel values at lags tau (reference gp.py:218-219); theta as in
        :meth:`get_prediction`."""
        return self._kernel_value(self._theta_of(theta), as_tensor(tau, self.t.device))

    def mcmc(self, n_walkers=50, n_steps=1000, burn=0, random_seed=None,
             checkpoint_path=None, checkpoint_every=100):
        """Ensemble sampling (reference gp.py:257-293 drives emcee), the
        walkers' dense likelihoods batched. With ``checkpoint_path``,
        resumable state is saved every ``checkpoint_every`` steps, as in
        CeleriteModeler.mcmc."""
        log_event("gp_mcmc", modeler=type(self).__name__,
                  n=self.signal.size, n_walkers=n_walkers, n_steps=n_steps,
                  checkpointed=checkpoint_path is not None)
        seed = 0 if random_seed is None else int(random_seed)
        dev = self.t.device
        g_init = _mcmc._generator(dev, (seed, 0))
        soln, _ = self.minimize()
        with torch.no_grad():
            x0 = self._theta(soln.x)[None, :] + 1e-3 * torch.randn(
                (n_walkers, self.ndim), generator=g_init, dtype=self.dtype, device=dev)
            if checkpoint_path is not None:
                chain, _, acc = _mcmc.run_ensemble_checkpointed(
                    self._log_prob_theta, x0, (seed, 1), int(n_steps),
                    checkpoint_path=checkpoint_path, checkpoint_every=checkpoint_every)
            else:
                chain, _, acc = _mcmc.run_ensemble(self._log_prob_theta, x0, (seed, 1),
                                                   int(n_steps))
        self.chain = _host(chain)
        self.acceptance = float(acc)
        log_event("gp_mcmc_done", modeler=type(self).__name__, acceptance=self.acceptance)
        samples = self.chain[burn:].reshape(-1, self.ndim)
        tau = _mcmc.autocorr_time(self.chain[burn:])
        self.sampler = types.SimpleNamespace(chain=self.chain, acceptance=self.acceptance)
        return samples.T, tau

    def nuts(self, n_chains=4, n_steps=1000, n_warmup=500, burn=0, max_depth=8,
             target_accept=0.8, random_seed=None):
        """Gradient-based posterior sampling (NUTS) in parameter space, with
        exact autograd gradients through the dense-Cholesky likelihood.
        Counterpart of :meth:`CeleriteModeler.nuts`; the QP posterior's hard
        tau/period constraint shows up as divergences at the boundary, which
        the sampler rejects. Returns (samples.T, tau) like :meth:`mcmc`."""
        log_event("gp_nuts", modeler=type(self).__name__, n=self.signal.size,
                  n_chains=n_chains, n_steps=n_steps, n_warmup=n_warmup)
        seed = 0 if random_seed is None else int(random_seed)
        dev = self.t.device
        g_init = _mcmc._generator(dev, (seed, 0))
        soln, _ = self.minimize()
        x0 = self._theta(soln.x)[None, :] + 1e-3 * torch.randn(
            (n_chains, self.ndim), generator=g_init, dtype=self.dtype, device=dev)
        samples, tau = _nuts_run_and_record(self, self._log_prob_theta, x0, (seed, 1), n_steps,
                                            n_warmup, max_depth, target_accept, burn)
        return samples.T, tau


class QuasiPeriodicGP(GeorgeModeler):
    """Const x ExpSquared x ExpSine2 kernel (reference gp.py:296-337)."""

    def _init_theta(self):
        return np.array(
            [
                self.mean,
                np.log(self.jitter),
                np.log(np.var(_host(self.y))),
                np.log(10.0),
                4.5,
                0.0,
            ]
        )

    def __init__(self, signal, err, init_period=None, period_prior=None,
                 bounds=None, constraints=None):
        super().__init__(signal, err, init_period, period_prior, bounds, constraints)
        if self.bounds is None:
            pmin = 2 * float(self.signal.median_dt)
            pmax = 0.5 * float(self.signal.baseline)
            self.bounds = [
                (self.mean - self.sigma, self.mean + self.sigma),
                (np.log(self.jitter) - 5, np.log(self.jitter) + 5),
                (2 * np.log(self.sigma) - 10, 2 * np.log(self.sigma) + 10),
                (2 * np.log(pmin), 2 * np.log(10 * pmax)),
                (1.0, 20.0),
                (np.log(pmin), np.log(pmax)),
            ]
        if self.constraints is None:
            # guarantee tau > period (reference gp.py:322-324)
            self.constraints = {"type": "ineq", "fun": lambda x: 0.5 * x[..., 3] - x[..., 5]}

    def _kernel_value(self, theta, dt):
        lead = theta.shape[:-1] + (1,) * dt.dim()
        _, _, log_sigma2, log_tau2, gamma, log_period = (
            theta[..., i].reshape(lead) for i in range(6))
        return torch.exp(
            log_sigma2
            - 0.5 * dt**2 / torch.exp(log_tau2)
            - gamma * torch.sin(math.pi * torch.abs(dt) / torch.exp(log_period)) ** 2
        )

    def log_prior(self, theta):
        mean, log_jitter, log_sigma2, log_tau2, gamma, log_period = theta.unbind(-1)
        tau = torch.exp(log_tau2 / 2)
        period = torch.exp(log_period)
        lp = _norm_logpdf(mean, self.mean, self.sigma)
        lp = lp + _norm_logpdf(log_jitter, float(np.log(self.jitter)), 2.0)
        lp = lp + _norm_logpdf(log_sigma2, float(2 * np.log(self.sigma)), 4.0)
        lp = lp + 1 / np.log(100)
        ratio = tau / period
        lp = lp + torch.where((ratio > 1) & (ratio < 10), 0.0, -math.inf)
        lp = lp + _norm_logpdf(torch.log(gamma), 1.5, 1.5)
        lp = lp + self.period_prior(period)
        return lp
