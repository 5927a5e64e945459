"""Affine-invariant ensemble MCMC on the walkers' device.

Port of ``periodicity_tpu/models/gp/mcmc.py`` (emcee's stretch move,
Goodman & Weare 2010, as two half-ensemble updates a step, and emcee's FFT
autocorrelation time). ``log_prob_fn`` takes a batch of walkers [B, D] and
returns [B]: one call evaluates a whole half-ensemble, so with the celerite
solver every walker's O(N) recursion runs in one kernel launch.

The random draws come from a seeded ``torch.Generator`` on the walkers'
device, so the chains differ from the JAX package's for the same seed.
:func:`stretch_step` takes its draws explicitly (each half's stretch
uniforms, partner indices and acceptance uniforms), so a test can feed it
the JAX package's draws. :func:`run_ensemble_sharded` lays the walkers
over a mesh axis, one all-gather a half-update; its rank-local chain
(``_sharded_chain``) takes its draws from a callable, so a test can feed
it JAX's per-device draws too. The diagnostics are host numpy, as in JAX.
"""

import os

import numpy as np
import torch
import torch.distributed as dist

from ...core import as_tensor
from ...parallel.mesh import axis_info, local_block, mesh_device, sharded_output
from ...utils.checkpoint import _npz_path, load_state, save_state

__all__ = [
    "run_ensemble",
    "run_ensemble_checkpointed",
    "run_ensemble_sharded",
    "stretch_step",
    "autocorr_time",
    "ess",
    "rhat",
]


def _generator(device, seed):
    """``seed`` as a torch.Generator on ``device``: a Generator as it is;
    an int, or a tuple of ints, through numpy's SeedSequence."""
    if isinstance(seed, torch.Generator):
        return seed
    key = list(seed) if isinstance(seed, (tuple, list)) else [int(seed)]
    state = int(np.random.SeedSequence(key).generate_state(1, np.uint64)[0])
    gen = torch.Generator(device=device)
    gen.manual_seed(state)
    return gen


def _draws(gen, half, dtype, device, size=None):
    """One half-update's draws: (stretch uniforms, partner indices in [0,
    half), acceptance uniforms), each [size] ([half] by default)."""
    size = half if size is None else size
    u = torch.rand(size, generator=gen, dtype=dtype, device=device)
    j = torch.randint(0, half, (size,), generator=gen, device=device)
    r = torch.rand(size, generator=gen, dtype=dtype, device=device)
    return u, j, r


def _half_update(log_prob_fn, x_move, lp_move, x_other, draws, a, active=None):
    """Walkers x_move propose with partners x_other[j]; only the ``active``
    ones (all when None) may accept."""
    u, j, r = draws
    d = x_move.shape[1]
    z = ((a - 1.0) * u + 1.0) ** 2 / a
    partners = x_other[j]
    prop = partners + z[:, None] * (x_move - partners)
    lp_prop = log_prob_fn(prop)
    log_r = (d - 1) * torch.log(z) + lp_prop - lp_move
    accept = torch.log(r) < log_r
    if active is not None:
        accept = accept & active
    x_new = torch.where(accept[:, None], prop, x_move)
    lp_new = torch.where(accept, lp_prop, lp_move)
    return x_new, lp_new, accept


def stretch_step(log_prob_fn, x, lp, draws, a=2.0):
    """One step of the stretch move: the first half of the walkers moves
    against the second, then the second against the moved first.

    x [W, D] (W even), lp [W]; ``draws`` is ``(first, second)``, each
    ``(u, j, r)`` of [W/2] stretch uniforms in [0, 1), partner indices in
    [0, W/2) and acceptance uniforms. Returns (x, lp, accepted [W])."""
    half = x.shape[0] // 2
    x1, lp1, acc1 = _half_update(log_prob_fn, x[:half], lp[:half], x[half:], draws[0], a)
    x2, lp2, acc2 = _half_update(log_prob_fn, x[half:], lp[half:], x1, draws[1], a)
    return torch.cat([x1, x2]), torch.cat([lp1, lp2]), torch.cat([acc1, acc2])


def run_ensemble(log_prob_fn, x0, seed, n_steps, a=2.0):
    """Goodman-Weare stretch-move ensemble sampler.

    Parameters
    ----------
    log_prob_fn: batched fn params [B, D] -> log-probabilities [B].
    x0: [W, D] initial walkers (W even), a tensor (its device runs the
        chain) or an array (to the card).
    seed: an int, a tuple of ints or a torch.Generator on x0's device.
    n_steps: steps (each = both half-updates).

    Returns
    -------
    chain [n_steps, W, D], log_probs [n_steps, W] (tensors on x0's
    device) and the acceptance fraction (a float: one host read).
    """
    x = as_tensor(x0)
    w, _ = x.shape
    half = w // 2
    gen = _generator(x.device, seed)
    lp = log_prob_fn(x)
    chain, lps, accepts = [], [], []
    for _ in range(int(n_steps)):
        draws = (_draws(gen, half, x.dtype, x.device), _draws(gen, half, x.dtype, x.device))
        x, lp, acc = stretch_step(log_prob_fn, x, lp, draws, a)
        chain.append(x)
        lps.append(lp)
        accepts.append(acc)
    if not chain:
        empty = x.new_zeros((0,) + x.shape)
        return empty, x.new_zeros((0, w)), float("nan")
    acceptance = float(torch.stack(accepts).to(torch.float32).mean())
    return torch.stack(chain), torch.stack(lps), acceptance


def run_ensemble_checkpointed(log_prob_fn, x0, seed, n_steps, a=2.0,
                              checkpoint_path=None, checkpoint_every=100,
                              progress=False):
    """Chunked ensemble sampler with save/resume.

    Runs :func:`run_ensemble` in chunks of ``checkpoint_every`` steps,
    saving resumable state (walker positions, accumulated chain, chunk
    counter) after each chunk. If ``checkpoint_path`` exists the run
    resumes from it; each chunk's generator is seeded from (seed, chunk
    index), not from the interrupted process, so a resumed run equals an
    uninterrupted one. ``seed`` is an int or a tuple of ints.

    Returns (chain [n_steps, W, D], log_probs [n_steps, W], acceptance).
    """
    x0 = as_tensor(x0)
    device = x0.device
    w, d = x0.shape
    key = tuple(seed) if isinstance(seed, (tuple, list)) else (int(seed),)
    n_chunks = -(-n_steps // checkpoint_every)
    np_dtype = x0.detach().cpu().numpy().dtype

    start = 0
    x = x0
    chain = np.zeros((0, w, d), np_dtype)
    lps = np.zeros((0, w), np_dtype)
    acc_steps = np.zeros((0, 2))  # (acceptance, n_steps) per chunk

    like = {"chunk": np.asarray(0), "x": np.zeros((w, d), np_dtype), "chain": chain,
            "lps": lps, "acc_steps": acc_steps}
    # save_state/load_state append '.npz' when missing; the existence probe
    # looks for the same name, or an extensionless path would restart
    if checkpoint_path and os.path.exists(_npz_path(checkpoint_path)):
        saved = load_state(checkpoint_path, like)
        start = int(saved["chunk"])
        x = torch.from_numpy(saved["x"]).to(device)
        chain = saved["chain"]
        lps = saved["lps"]
        acc_steps = saved["acc_steps"]

    chunk_iter = range(start, n_chunks)
    if progress:
        from tqdm.auto import tqdm

        chunk_iter = tqdm(chunk_iter, total=n_chunks, initial=start, desc="MCMC chunks")
    for i in chunk_iter:
        steps = min(checkpoint_every, n_steps - i * checkpoint_every)
        c, lp, acc = run_ensemble(log_prob_fn, x, _generator(device, key + (i,)), steps, a=a)
        chain = np.concatenate([chain, c.cpu().numpy()])
        lps = np.concatenate([lps, lp.cpu().numpy()])
        acc_steps = np.concatenate([acc_steps, np.asarray([[acc, steps]])])
        x = c[-1]
        if checkpoint_path:
            save_state(checkpoint_path, {
                "chunk": np.asarray(i + 1), "x": x, "chain": chain, "lps": lps,
                "acc_steps": acc_steps,
            })

    acceptance = float(np.average(acc_steps[:, 0], weights=acc_steps[:, 1]))
    return torch.from_numpy(chain).to(device), torch.from_numpy(lps).to(device), acceptance


def _sharded_half_update(log_prob_fn, x_local, lp_local, full, active, draws, half, a):
    """One half-update of a rank's walkers x_local [Wl, D] against the
    gathered ensemble ``full`` [W, D]: every walker proposes with a partner
    from the other half (``draws`` = (u, j, r), each [Wl], j in [0, half)),
    and only the ``active`` ones may accept."""
    u, j, r = draws
    # walkers of the first half draw partners from the second, and back
    return _half_update(log_prob_fn, x_local, lp_local, full,
                        (u, torch.where(active, j + half, j), r), a, active)


def _sharded_chain(log_prob_fn, x_local, first, half, n_steps, draw, gather, a):
    """A rank's chain: its walkers x_local [Wl, D], whose global indices
    start at ``first``; ``draw(step, k)`` gives the draws of half-update k
    (0 moves the first half of the ensemble, 1 the second) and
    ``gather(x)`` the whole ensemble [W, D]. Returns (chain [n_steps, Wl,
    D], log-probabilities [n_steps, Wl], accepted [n_steps, Wl])."""
    wl = x_local.shape[0]
    in_first = (first + torch.arange(wl, device=x_local.device)) < half
    x, lp = x_local, log_prob_fn(x_local)
    chain, lps, accepts = [], [], []
    for step in range(int(n_steps)):
        x, lp, acc1 = _sharded_half_update(log_prob_fn, x, lp, gather(x), in_first,
                                           draw(step, 0), half, a)
        x, lp, acc2 = _sharded_half_update(log_prob_fn, x, lp, gather(x), ~in_first,
                                           draw(step, 1), half, a)
        chain.append(x)
        lps.append(lp)
        accepts.append(acc1 | acc2)
    if not chain:
        return x.new_zeros((0,) + x.shape), lp.new_zeros((0, wl)), x.new_zeros((0, wl), dtype=bool)
    return torch.stack(chain), torch.stack(lps), torch.stack(accepts)


def run_ensemble_sharded(log_prob_fn, x0, seed, n_steps, mesh, axis="walkers", a=2.0):
    """Stretch-move ensemble MCMC with the walker axis sharded over a mesh.

    Each rank owns W/D walkers and evaluates their log-probabilities
    locally; the complementary half-ensemble needed for partner draws is
    exchanged with one ``all_gather`` per half-update. Detailed balance
    follows the red-black (two-half) scheme: walkers with global index <
    W/2 form the first half. Proposals are computed for every local walker
    each half-update, but only the moving half may accept.

    log_prob_fn: batched fn [B, D] -> [B]. x0 [W, D], whole on every rank
    (or a DTensor sharded on its walkers), with W divisible by 2 D. Each
    rank draws from a generator seeded through SeedSequence from (seed, 1,
    its index on ``axis``). Returns (chain [n_steps, W, D] and log_probs
    [n_steps, W], DTensors sharded over ``axis`` on the walker dimension;
    the acceptance fraction, a float: the mean over ranks).
    """
    n_dev, idx, group = axis_info(mesh, axis)
    x0 = as_tensor(x0, mesh_device(mesh))
    w = x0.shape[0]
    if w % (2 * n_dev):
        raise ValueError(f"n_walkers={w} must be divisible by 2*{n_dev}")
    x_local = local_block(x0, mesh, axis)
    half, wl = w // 2, w // n_dev
    key = tuple(seed) if isinstance(seed, (tuple, list)) else (int(seed),)
    gen = _generator(x_local.device, key + (1, idx))

    def draw(step, k):
        return _draws(gen, half, x_local.dtype, x_local.device, size=wl)

    def gather(x):
        parts = [torch.empty_like(x) for _ in range(n_dev)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    chain, lps, accepts = _sharded_chain(log_prob_fn, x_local, idx * wl, half, n_steps, draw,
                                         gather, a)
    acc = torch.mean(accepts.to(torch.float32)).reshape(1)
    dist.all_reduce(acc, group=group)
    return (sharded_output(chain, mesh, axis, dim=1), sharded_output(lps, mesh, axis, dim=1),
            float(acc) / n_dev)


def _acf_1d(x):
    """Normalized autocorrelation function via FFT (emcee function_1d)."""
    x = np.asarray(x, float)
    n = len(x)
    nfft = 1 << (2 * n - 1).bit_length()
    f = np.fft.fft(x - np.mean(x), n=nfft)
    acf = np.fft.ifft(f * np.conjugate(f))[:n].real
    if acf[0] == 0:
        return np.zeros(n)
    return acf / acf[0]


def _numpy(chain):
    return chain.detach().cpu().numpy() if isinstance(chain, torch.Tensor) else np.asarray(chain)


def autocorr_time(chain, c=5, quiet=True):
    """Integrated autocorrelation time per dimension (emcee's estimator:
    walker-averaged FFT autocorrelation + Sokal auto-windowing).

    chain: [n_steps, W, D]. Returns tau [D].
    """
    chain = _numpy(chain)
    n_steps, n_walkers, ndim = chain.shape
    taus = np.empty(ndim)
    for dim in range(ndim):
        f = np.zeros(n_steps)
        for w in range(n_walkers):
            f += _acf_1d(chain[:, w, dim])
        f /= n_walkers
        t = 2.0 * np.cumsum(f) - 1.0
        # emcee's auto_window: the smallest M with M >= c * tau[M]; when the
        # window never closes, argmin over the all-True mask gives 0
        m = np.arange(len(t)) < c * t
        window = np.argmin(m) if np.any(m) else len(t) - 1
        taus[dim] = t[window]
    if not quiet and np.any(taus * 50 > n_steps):
        raise RuntimeError("chain too short for reliable autocorr time")
    return taus


def ess(chain, c=5, tau=None):
    """Effective sample size per dimension, ``n_steps * n_chains / tau``,
    with a tiny positive floor on tau against constant chains.

    chain: [n_steps, C, D]. Pass a precomputed ``tau`` to reuse one
    estimate.
    """
    chain = _numpy(chain)
    n_steps, n_chains, _ = chain.shape
    if tau is None:
        tau = autocorr_time(chain, c=c)
    return n_steps * n_chains / np.maximum(np.asarray(tau, float), 1e-3)


def rhat(chain):
    """Split-R-hat per dimension (Gelman et al. 2013): each chain split in
    half, the pooled between/within variance ratio of the 2C half-chains.

    chain: [n_steps, C, D] -> [D].
    """
    x = np.asarray(_numpy(chain), float)
    n, _, _ = x.shape
    half = n // 2
    if half < 2:
        raise ValueError("split R-hat needs at least 4 steps")
    x = np.concatenate([x[:half], x[half: 2 * half]], axis=1)  # [half, 2C, D]
    means = x.mean(axis=0)  # [2C, D]
    within = x.var(axis=0, ddof=1).mean(axis=0)  # [D]
    between = half * means.var(axis=0, ddof=1)  # [D]
    var_hat = (half - 1) / half * within + between / half
    return np.sqrt(var_hat / np.maximum(within, 1e-300))
