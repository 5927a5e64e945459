"""No-U-Turn sampler (gradient-based posterior sampling) on the chains'
device.

Port of ``periodicity_tpu/models/gp/nuts.py``: multinomial NUTS (Hoffman &
Gelman 2014; Betancourt 2017) with Stan's warmup (dual-averaging step size,
diagonal mass on the windowed schedule), the tree built iteratively (Phan,
Pradhan & Jankowiak 2019: a subtree of depth d is 2^d leapfrog steps from
one end, with an O(max_depth) checkpoint buffer for the sub-U-turn checks).

JAX vmaps a one-chain ``while_loop`` over the chains. Here every chain's
state is a ``[C, ...]`` tensor and the chains run in lockstep: a doubling or
a leaf runs for every chain, and the chains that have stopped are masked
with ``torch.where``, which is what ``vmap`` of a ``while_loop`` does. A
loop ends when no chain is active, one host read a leaf. ``log_prob_fn``
takes ``[C, D]`` and returns ``[C]``; its value and gradient come from one
``torch.autograd.grad`` of the sum, so with the celerite solver a leapfrog
is one batched forward (G1) and one backward (G2) launch for all chains.

The random numbers enter :func:`_nuts_step` and :func:`_find_reasonable_eps`
as arguments (momentum normals, direction bits, a take-uniform a (depth,
leaf), an accept-uniform a depth), so a test can feed them JAX's draws.
:func:`run_nuts` draws step i's numbers (warmup steps first) from a
generator seeded ``(seed, 1, i)`` and the initial step size's momentum from
``(seed, 2)`` (``mcmc._generator``), so chains differ from JAX's for the
same seed; the same seed on the same device gives the same chains.

Conventions: the inverse mass matrix is diagonal, ``inv_mass ~ var(z)``;
kinetic energy ``0.5 * sum(r^2 * inv_mass)``; velocity ``v = inv_mass*r``.
"""

import math

import numpy as np
import torch

from ...core import as_tensor
from .mcmc import _generator

__all__ = ["run_nuts"]

_MAX_DELTA_ENERGY = 1000.0  # divergence threshold (Stan's default)
# dual-averaging constants (Hoffman & Gelman 2014)
_DA_GAMMA, _DA_T0, _DA_KAPPA = 0.05, 10.0, 0.75


def _popcount(n):
    """Set bits of a 32-bit unsigned integer."""
    return bin(int(n) & 0xFFFFFFFF).count("1")


def _trailing_ones(n):
    """Contiguous low 1-bits: popcount(n & ~(n + 1)) in 32 bits."""
    n = int(n) & 0xFFFFFFFF
    return _popcount(n & ~((n + 1) & 0xFFFFFFFF))


def _is_turning(inv_mass, r_left, r_right, rho):
    """Generalized U-turn criterion on a trajectory segment, [C]: ``rho`` is
    the sum of all momenta in the segment (endpoints included); turning when
    the segment momentum points against either end velocity."""
    v_left = inv_mass * r_left
    v_right = inv_mass * r_right
    return (torch.sum(v_left * rho, dim=-1) <= 0) | (torch.sum(v_right * rho, dim=-1) <= 0)


def _value_and_grad(log_prob_fn):
    """[C, D] -> (log_prob [C], its gradient [C, D]), detached."""
    def vg(z):
        with torch.enable_grad():
            x = z.detach().requires_grad_(True)
            lp = log_prob_fn(x)
            (g,) = torch.autograd.grad(lp.sum(), x)
        return lp.detach(), g
    return vg


def _leapfrog(vg, z, r, grad, eps, inv_mass):
    e = eps[:, None]
    r = r + 0.5 * e * grad  # grad of log_prob, so +
    z = z + e * inv_mass * r
    logp, grad = vg(z)
    r = r + 0.5 * e * grad
    return z, r, logp, grad


def _kinetic(r, inv_mass):
    return 0.5 * torch.sum(r * r * inv_mass, dim=-1)


def _pick(mask, new, old):
    """``new`` where the [C] ``mask`` holds, else ``old``."""
    return torch.where(mask.reshape(mask.shape + (1,) * (new.dim() - 1)), new, old)


def _build_subtree(vg, depth, direction, z0, r0, grad0, joint0, eps, inv_mass, max_depth,
                   take_u, active):
    """Build a subtree of 2**depth leapfrog steps from one end, for the
    chains in ``active`` [C] (the others are carried through unchanged).

    ``direction`` [C] bool (True: forward), ``take_u`` [C, >= 2**depth] the
    take-uniform of each leaf. Returns a dict with the final end state, the
    multinomial proposal drawn from the subtree, its total log weight and
    momentum sum, turning/diverging flags, the summed Metropolis accept
    statistic and the leaves built, each [C, ...]."""
    c, d = z0.shape
    dtype, dev = z0.dtype, z0.device
    signed_eps = torch.where(direction, eps, -eps)
    z, r, grad = z0, r0, grad0
    z_prop, grad_prop = z0, grad0
    logp_prop = torch.full((c,), -math.inf, dtype=dtype, device=dev)
    lsw = torch.full((c,), -math.inf, dtype=dtype, device=dev)
    rho = torch.zeros((c, d), dtype=dtype, device=dev)
    r_ckpts = torch.zeros((c, max_depth, d), dtype=dtype, device=dev)
    rsum_ckpts = torch.zeros((c, max_depth, d), dtype=dtype, device=dev)
    sum_acc = torch.zeros((c,), dtype=dtype, device=dev)
    turning = torch.zeros((c,), dtype=torch.bool, device=dev)
    diverging = torch.zeros((c,), dtype=torch.bool, device=dev)
    n_leaf = torch.zeros((c,), dtype=torch.int64, device=dev)
    for leaf in range(1 << depth):
        go = active & ~turning & ~diverging
        if not bool(go.any()):
            break
        z_n, r_n, logp, grad_n = _leapfrog(vg, z, r, grad, signed_eps, inv_mass)
        lw = logp - _kinetic(r_n, inv_mass) - joint0
        lw = torch.where(torch.isnan(lw), -math.inf, lw)
        div_n = lw < -_MAX_DELTA_ENERGY
        acc_n = sum_acc + torch.clamp(torch.exp(lw), max=1.0)
        # progressive multinomial sampling within the subtree
        lsw_n = torch.logaddexp(lsw, lw)
        take = go & (torch.log(take_u[:, leaf]) < lw - lsw_n)
        z_prop = _pick(take, z_n, z_prop)
        logp_prop = _pick(take, logp, logp_prop)
        grad_prop = _pick(take, grad_n, grad_prop)
        rho_before = rho
        rho_n = rho + r_n
        # iterative sub-U-turn bookkeeping (arXiv:1912.11554): an even leaf
        # checkpoints (its momentum, the momentum sum before it) at slot
        # popcount(leaf >> 1); an odd leaf checks every complete subtree
        # ending at it
        idx_max = _popcount(leaf >> 1)
        turn_n = turning
        if leaf % 2 == 0:
            slot = go[:, None] & (torch.arange(max_depth, device=dev) == idx_max)
            r_ckpts = torch.where(slot[:, :, None], r_n[:, None, :], r_ckpts)
            rsum_ckpts = torch.where(slot[:, :, None], rho_before[:, None, :], rsum_ckpts)
        else:
            for i in range(idx_max - _trailing_ones(leaf) + 1, idx_max + 1):
                turn_n = turn_n | _is_turning(inv_mass, r_ckpts[:, i], r_n,
                                             rho_n - rsum_ckpts[:, i])
        z, r, grad = _pick(go, z_n, z), _pick(go, r_n, r), _pick(go, grad_n, grad)
        lsw = _pick(go, lsw_n, lsw)
        rho = _pick(go, rho_n, rho)
        sum_acc = _pick(go, acc_n, sum_acc)
        turning = _pick(go, turn_n, turning)
        diverging = _pick(go, div_n, diverging)
        n_leaf = torch.where(go, leaf + 1, n_leaf)
    return dict(z_end=z, r_end=r, grad_end=grad, z_prop=z_prop, logp_prop=logp_prop,
                grad_prop=grad_prop, lsw=lsw, rho=rho, turning=turning, diverging=diverging,
                sum_acc=sum_acc, n_leaf=n_leaf)


def _nuts_step(vg, z, logp, grad, eps, inv_mass, max_depth, draws):
    """One multinomial-NUTS transition of every chain.

    z, grad [C, D], logp [C], eps [C], inv_mass [C, D]; ``draws`` is
    (momentum normals [C, D], direction bits [C, max_depth] (True: forward),
    take-uniforms [C, max_depth, 2**(max_depth-1)], accept-uniforms [C,
    max_depth]). Returns the new (z, logp, grad) and (accept_stat,
    n_leapfrog, diverging, depth), each [C]."""
    normal, direction, take_u, accept_u = draws
    c = z.shape[0]
    dtype, dev = z.dtype, z.device
    r0 = normal / torch.sqrt(inv_mass)
    joint0 = logp - _kinetic(r0, inv_mass)
    z_l = z_r = z
    r_l = r_r = r0
    g_l = g_r = grad
    rho = r0
    z_prop, logp_prop, g_prop = z, logp, grad
    lsw = torch.zeros((c,), dtype=dtype, device=dev)
    sum_acc = torch.zeros((c,), dtype=dtype, device=dev)
    n_leaf = torch.zeros((c,), dtype=torch.int64, device=dev)
    depth = torch.zeros((c,), dtype=torch.int64, device=dev)
    turning = torch.zeros((c,), dtype=torch.bool, device=dev)
    diverging = torch.zeros((c,), dtype=torch.bool, device=dev)
    for d in range(max_depth):
        active = ~turning & ~diverging
        if not bool(active.any()):
            break
        go_right = direction[:, d]
        sub = _build_subtree(vg, d, go_right, _pick(go_right, z_r, z_l),
                             _pick(go_right, r_r, r_l), _pick(go_right, g_r, g_l), joint0, eps,
                             inv_mass, max_depth, take_u[:, d], active)
        ok = active & ~sub["turning"] & ~sub["diverging"]
        # biased progressive sampling across doublings
        accept_new = ok & (torch.log(accept_u[:, d]) < sub["lsw"] - lsw)
        z_prop = _pick(accept_new, sub["z_prop"], z_prop)
        logp_prop = _pick(accept_new, sub["logp_prop"], logp_prop)
        g_prop = _pick(accept_new, sub["grad_prop"], g_prop)
        lsw = _pick(ok, torch.logaddexp(lsw, sub["lsw"]), lsw)
        rho = _pick(ok, rho + sub["rho"], rho)
        left, right = ok & ~go_right, ok & go_right
        z_l, r_l, g_l = (_pick(left, sub[k], x) for k, x in
                         (("z_end", z_l), ("r_end", r_l), ("grad_end", g_l)))
        z_r, r_r, g_r = (_pick(right, sub[k], x) for k, x in
                         (("z_end", z_r), ("r_end", r_r), ("grad_end", g_r)))
        turn_new = torch.where(ok, _is_turning(inv_mass, r_l, r_r, rho), True)
        turning = _pick(active, turn_new, turning)
        diverging = diverging | (active & sub["diverging"])
        sum_acc = _pick(active, sum_acc + sub["sum_acc"], sum_acc)
        n_leaf = _pick(active, n_leaf + sub["n_leaf"], n_leaf)
        depth = _pick(active, depth + 1, depth)
    accept_stat = sum_acc / torch.clamp(n_leaf, min=1).to(dtype)
    return z_prop, logp_prop, g_prop, accept_stat, n_leaf, diverging, depth


def _find_reasonable_eps(vg, z, logp, grad, inv_mass, normal):
    """Hoffman & Gelman Algorithm 4 for every chain: double or halve the
    step size until the one-step acceptance crosses 1/2 (at most 60 times),
    clipped to [1e-8, 1e3]. ``normal`` [C, D] are the momentum normals."""
    c = z.shape[0]
    r0 = normal / torch.sqrt(inv_mass)
    joint0 = logp - _kinetic(r0, inv_mass)
    log_half = math.log(0.5)

    def delta(eps):
        _, r, logp1, _ = _leapfrog(vg, z, r0, grad, eps, inv_mass)
        dj = logp1 - _kinetic(r, inv_mass) - joint0
        return torch.where(torch.isnan(dj), -math.inf, dj)

    eps = torch.ones((c,), dtype=z.dtype, device=z.device)
    dj = delta(eps)
    up = dj > log_half
    it = torch.zeros((c,), dtype=torch.int64, device=z.device)
    going = torch.ones((c,), dtype=torch.bool, device=z.device)
    while True:
        keep = torch.where(up, dj > log_half, dj < log_half)
        going = going & keep & (it < 60) & torch.isfinite(eps) & (eps > 1e-10)
        if not bool(going.any()):
            break
        eps = torch.where(going, eps * torch.where(up, 2.0, 0.5), eps)
        it = torch.where(going, it + 1, it)
        dj = delta(eps)
    return torch.clamp(eps, 1e-8, 1e3)


def _warmup_schedule(n_warmup, init_buffer=75, term_buffer=50, base_window=25):
    """Stan's three-stage warmup: step-size-only head, doubling
    mass-estimation windows, step-size-only tail. Returns per-step bool
    arrays (in_mass_window, is_window_end)."""
    in_window = np.zeros(n_warmup, bool)
    window_end = np.zeros(n_warmup, bool)
    if n_warmup <= 0:
        # no adaptation at all (e.g. reusing a tuned step size)
        return in_window, window_end
    if n_warmup < init_buffer + term_buffer + base_window:
        # too short for the full schedule: single window over the middle
        lo = n_warmup // 4
        hi = min(max(lo + 1, (3 * n_warmup) // 4), n_warmup)
        in_window[lo:hi] = True
        window_end[hi - 1] = True
        return in_window, window_end
    start = init_buffer
    size = base_window
    while start < n_warmup - term_buffer:
        end = start + size
        if end + 2 * size > n_warmup - term_buffer:
            end = n_warmup - term_buffer
        in_window[start:end] = True
        window_end[end - 1] = True
        start = end
        size *= 2
    return in_window, window_end


def _adapt(state, z, acc, in_window, window_end, target_accept):
    """One warmup step's adaptation of every chain: dual averaging of the
    step size, Welford accumulation of z inside a mass window, and at a
    window's end the regularized diagonal inverse mass, a reset of the
    Welford state and dual averaging re-centred on the current step size.

    ``state`` is (mu, log_eps, log_eps_avg, h_bar, count, n_w [C], mean_w,
    m2_w, inv_mass [C, D]); ``in_window`` and ``window_end`` are bools."""
    mu, log_eps, log_eps_avg, h_bar, count, n_w, mean_w, m2_w, inv_mass = state
    count = count + 1
    w = 1.0 / (count + _DA_T0)
    h_bar = (1 - w) * h_bar + w * (target_accept - acc)
    log_eps = mu - torch.sqrt(count) / _DA_GAMMA * h_bar
    eta = count ** (-_DA_KAPPA)
    log_eps_avg = eta * log_eps + (1 - eta) * log_eps_avg
    if in_window:
        n_new = n_w + 1
        delta = z - mean_w
        mean_new = mean_w + delta / n_new[:, None]
        m2_w = m2_w + delta * (z - mean_new)
        n_w, mean_w = n_new, mean_new
    if window_end:
        var = m2_w / torch.clamp(n_w - 1, min=1)[:, None]
        var = (n_w / (n_w + 5.0))[:, None] * var + 1e-3 * (5.0 / (n_w + 5.0))[:, None]
        inv_mass = _pick(n_w > 1, var, inv_mass)
        n_w, mean_w, m2_w = torch.zeros_like(n_w), torch.zeros_like(mean_w), torch.zeros_like(m2_w)
        mu = math.log(10.0) + log_eps
        h_bar = torch.zeros_like(h_bar)
        count = torch.zeros_like(count)
    return (mu, log_eps, log_eps_avg, h_bar, count, n_w, mean_w, m2_w, inv_mass)


def _seeded(device, seed, *purpose):
    """The generator of one purpose: ``seed`` itself when it is a Generator,
    else one seeded from (seed..., purpose...)."""
    if isinstance(seed, torch.Generator):
        return seed
    key = list(seed) if isinstance(seed, (tuple, list)) else [int(seed)]
    return _generator(device, tuple(key) + purpose)


def _step_draws(gen, c, d, max_depth, dtype, device):
    """One transition's draws (see :func:`_nuts_step`)."""
    normal = torch.randn((c, d), generator=gen, dtype=dtype, device=device)
    direction = torch.rand((c, max_depth), generator=gen, dtype=dtype, device=device) < 0.5
    take = torch.rand((c, max_depth, 1 << (max_depth - 1)), generator=gen, dtype=dtype,
                      device=device)
    accept = torch.rand((c, max_depth), generator=gen, dtype=dtype, device=device)
    return normal, direction, take, accept


def run_nuts(log_prob_fn, x0, seed, n_steps, n_warmup=500, max_depth=8, target_accept=0.8):
    """Multinomial NUTS with Stan-style warmup adaptation.

    Parameters
    ----------
    log_prob_fn : differentiable batched fn params [C, D] -> [C] log
        densities (unnormalized). Must be finite at ``x0``.
    x0 : [C, D] initial positions (one row per chain), a tensor (its device
        runs the chains) or an array (to the card).
    seed : an int, a tuple of ints or a torch.Generator on x0's device.
    n_steps, n_warmup : post-warmup and warmup step counts.
    max_depth : maximum tree doubling depth (at most 2**max_depth - 1
        leapfrog steps a transition).
    target_accept : dual-averaging target (Stan's ``adapt_delta``).

    Returns
    -------
    dict with ``chain`` [n_steps, C, D], ``log_probs`` [n_steps, C],
    ``accept_prob`` [C] (post-warmup mean), ``divergences`` [C]
    (post-warmup count), ``step_size`` [C], ``inv_mass`` [C, D],
    ``tree_depth`` [n_steps, C], ``n_leapfrog`` and ``n_leapfrog_warmup``
    [C], tensors on x0's device. Each chain adapts its own step size and
    diagonal mass.
    """
    x = as_tensor(x0)
    if x.dim() == 1:
        x = x[None]
    c, d = x.shape
    dtype, dev = x.dtype, x.device
    n_steps, n_warmup, max_depth = int(n_steps), int(n_warmup), int(max_depth)
    vg = _value_and_grad(log_prob_fn)
    in_window, window_end = _warmup_schedule(n_warmup)
    z, (logp, grad) = x, vg(x)
    inv_mass = torch.ones((c, d), dtype=dtype, device=dev)
    normal = torch.randn((c, d), generator=_seeded(dev, seed, 2), dtype=dtype, device=dev)
    eps0 = _find_reasonable_eps(vg, z, logp, grad, inv_mass, normal)
    zero = torch.zeros((c,), dtype=dtype, device=dev)
    state = (torch.log(10.0 * eps0), torch.log(eps0), zero, zero, zero, zero,
             torch.zeros_like(z), torch.zeros_like(z), inv_mass)
    warm_leaves = torch.zeros((c,), dtype=torch.int64, device=dev)
    for i in range(n_warmup):
        draws = _step_draws(_seeded(dev, seed, 1, i), c, d, max_depth, dtype, dev)
        z, logp, grad, acc, n_leaf, _, _ = _nuts_step(vg, z, logp, grad, torch.exp(state[1]),
                                                      state[8], max_depth, draws)
        state = _adapt(state, z, acc, bool(in_window[i]), bool(window_end[i]), target_accept)
        warm_leaves = warm_leaves + n_leaf
    inv_mass = state[8]
    # averaged step size; with no warmup there is nothing averaged: fall
    # back to the Algorithm-4 initial guess
    eps = torch.exp(state[2]) if n_warmup > 0 else eps0
    rec = {k: [] for k in ("chain", "log_probs", "acc", "div", "depth", "n_leaf")}
    for i in range(n_warmup, n_warmup + n_steps):
        draws = _step_draws(_seeded(dev, seed, 1, i), c, d, max_depth, dtype, dev)
        z, logp, grad, acc, n_leaf, div, depth = _nuts_step(vg, z, logp, grad, eps, inv_mass,
                                                           max_depth, draws)
        for k, v in zip(rec, (z, logp, acc, div, depth, n_leaf)):
            rec[k].append(v)

    def stacked(k, shape, kind):
        if rec[k]:
            return torch.stack(rec[k])
        return torch.zeros((0,) + shape, dtype=kind, device=dev)

    accs = stacked("acc", (c,), dtype)
    return dict(
        chain=stacked("chain", (c, d), dtype), log_probs=stacked("log_probs", (c,), dtype),
        accept_prob=accs.mean(dim=0), divergences=stacked("div", (c,), torch.bool).sum(dim=0),
        step_size=eps, inv_mass=inv_mass, tree_depth=stacked("depth", (c,), torch.int64),
        n_leapfrog=stacked("n_leaf", (c,), torch.int64).sum(dim=0),
        n_leapfrog_warmup=warm_leaves,
    )
