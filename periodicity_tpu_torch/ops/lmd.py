"""Local Mean Decomposition: the sift and the demodulation loop.

Port of ``periodicity_tpu/ops/lmd.py``, with its names. LMD is defined for
uniformly sampled signals only, and on a uniform grid every step is index
arithmetic: the extrema (both edges included) as grid indices in a
capacity buffer, their odd reflection, the zero-order-hold fill of the
local means and envelopes between extrema (one ``searchsorted`` of the
dense grid into the extrema), and the triangle smoothing with a window
set by the widest extrema gap, repeated until no flat segment is left.

Plain PyTorch on either device; there is no kernel. JAX's two
``lax.while_loop`` (the smoothing, ``:142-157``, and the demodulation,
``:231-254``) are Python loops here, with one host read a pass: the
smoothing loop reads its stop flag, the demodulation loop reads ``ok``
and its convergence flag together. ``host_reads`` counts them.
"""

import torch

from . import peaks as _peaks
from .emd import _series
from .spline import _interval_index

__all__ = ["lmd_sift", "lmd_iter"]

# host reads made by the smoothing and demodulation loops
host_reads = 0


def _read(*flags):
    """The 0-d boolean tensors ``flags`` as Python bools, in one host read."""
    global host_reads
    host_reads += 1
    return torch.stack(flags).tolist()


def _extrema_indices(x):
    """Indices of local extrema of ``x`` plus both edges, in a capacity-n
    int32 buffer (sentinel ``n`` past the count), with the count."""
    n = x.shape[0]
    mask = _peaks.local_maxima_mask(x) | _peaks.local_maxima_mask(-x)
    mask[0] = True
    mask[n - 1] = True
    # each extremum to its rank, the rest to a slot past the end
    slot = torch.where(mask, torch.cumsum(mask, 0) - 1, n)
    idx = torch.full((n + 1,), n, dtype=torch.int64, device=x.device)
    idx = idx.scatter(0, slot, torch.arange(n, device=x.device))[:n].to(torch.int32)
    return idx, mask.sum().to(torch.int32)


def _pad_reflect_drop_odd(idx, x, m, pad_width):
    """Odd-reflect the extrema sequence by ``pad_width`` entries per side
    and drop the original edge samples (reference decomposition.py:131-133:
    ``pad(mode="reflect", reflect_type="odd")`` applies the odd reflection
    to both times and values, then ``drop`` removes the edge knots).

    idx: [n] int32 extrema grid indices (ascending, sentinel n); x: [n]
    signal; m: extrema count. Returns (q [n+2w] int32 grid indices which
    may be negative or >= n, v [n+2w] values, count = m + 2w - 2).
    """
    n = x.shape[0]
    c0 = idx.shape[0]
    w = pad_width
    c = c0 + 2 * w
    i = torch.arange(c, dtype=torch.int32, device=x.device)
    count = m + 2 * w - 2

    def gi(s):
        return idx[torch.clamp(s, 0, c0 - 1).long()]

    def gv(s):
        return x[torch.clamp(gi(s), 0, n - 1).long()]

    p0, v0 = gi(m * 0), gv(m * 0)
    plast, vlast = gi(m - 1), gv(m - 1)
    src_left = w - i
    src_mid = i - w + 1
    src_right = 2 * m + w - 4 - i
    in_left = i < w
    in_mid = (i >= w) & (i < m + w - 2)
    q = torch.where(in_left, 2 * p0 - gi(src_left),
                    torch.where(in_mid, gi(src_mid), 2 * plast - gi(src_right)))
    v = torch.where(in_left, 2 * v0 - gv(src_left),
                    torch.where(in_mid, gv(src_mid), 2 * vlast - gv(src_right)))
    q = torch.where(i < count, q, 3 * n + 1).to(torch.int32)
    v = torch.where(i < count, v, 0.0)
    return q, v, count


def _zoh_dense(q, vals, count, ne):
    """Backward-fill the per-extremum values ``vals`` onto the dense
    integer grid spanned by the extrema indices ``q`` (the
    ``fill_gaps(method="bfill")`` + ``values[0] = values[1]`` construct of
    reference decomposition.py:139-144). Returns (dense [ne], m_dense)."""
    q0 = q[0]
    i = q0 + torch.arange(ne, dtype=torch.int32, device=q.device)
    k = _interval_index(q, i, side="left")
    k = torch.minimum(torch.clamp(k, min=1), torch.clamp(count - 1, min=1))
    m_dense = q[torch.clamp(count - 1, 0, q.shape[0] - 1).long()] - q0 + 1
    return vals[k.long()], m_dense


def _triangle_smooth_until_monotone(y, m_dense, half, smooth_iter, h_cap):
    """Repeat triangle smoothing (window = 2*half+1, jnp.pad-'reflect'
    boundary like filters.convolve1d(mode="mirror")) until the valid region
    has no zero first differences, at most ``smooth_iter`` times
    (reference decomposition.py:148-155). The window's gather [ne, 2h+1]
    is taken once per pass, as in JAX."""
    ne = y.shape[0]
    dev = y.device
    d = torch.arange(-h_cap, h_cap + 1, device=dev)
    wts = torch.clamp((half + 1) - torch.abs(d), min=0).to(y.dtype)
    wts = wts / ((half + 1).to(y.dtype) ** 2)
    j = torch.arange(ne, dtype=torch.int32, device=dev)
    p = torch.clamp(2 * m_dense - 2, min=1)
    r = torch.remainder(j[:, None] + d[None, :], p)
    ridx = torch.clamp(torch.where(r < m_dense, r, p - r), 0, ne - 1)
    valid_diff = torch.arange(ne - 1, device=dev) < (m_dense - 1)
    for _ in range(smooth_iter):
        y = (y[ridx] * wts).sum(-1)
        diffs = y[1:] - y[:-1]
        (done,) = _read(torch.where(valid_diff, diffs != 0, True).all())
        if done:
            break
    return y


def lmd_sift(t, x, pad_width=0, smooth_iter=12, *, device=None):
    """One LMD sifting evaluation (reference decomposition.py:127-163).

    Requires a uniformly sampled ``t`` (the reference reads ``signal.dt``);
    the caller validates uniformity. A tensor x [N] keeps its device unless
    ``device`` is given; an array goes to ``device``, else to the card.

    Returns (mu [N], env [N], ok). ``ok`` (a 0-d tensor) is False where the
    reference raises ValueError (fewer than ``2 + pad_width`` extrema, or
    fewer than 3 knots after padding).
    """
    _, x = _series(t, x, device)  # t is uniform by contract: the arithmetic is on indices
    n = x.shape[0]
    idx, m = _extrema_indices(x)
    ok = m >= (2 + pad_width)
    if pad_width > 0:
        q, v, count = _pad_reflect_drop_odd(idx, x, m, pad_width)
        ne = 3 * n
    else:
        q, count = idx, m
        v = torch.where(idx < n, x[torch.clamp(idx, 0, n - 1).long()], 0.0)
        ne = n
    ok = ok & (count >= 3)
    count_s = torch.clamp(count, min=2)

    # per-extremum local mean / envelope magnitude between knots k-1 and k
    # (reference decomposition.py:139-144: roll(1) midpoints / half-ranges)
    vprev = v[torch.clamp(torch.arange(v.shape[0], device=x.device) - 1, 0, v.shape[0] - 1)]
    muv = 0.5 * (vprev + v)
    envv = 0.5 * torch.abs(v - vprev)

    mu_dense, m_dense = _zoh_dense(q, muv, count_s, ne)
    env_dense, _ = _zoh_dense(q, envv, count_s, ne)

    # window = (max extrema spacing / dt) // 3, forced odd and >= 3
    # (reference decomposition.py:146-147)
    karr = torch.arange(q.shape[0] - 1, device=x.device)
    gaps = torch.where(karr < count_s - 1, q[1:] - q[:-1], 0)
    wf = torch.div(gaps.max(), 3, rounding_mode="floor")
    window = torch.clamp(torch.where(wf % 2 == 0, wf + 1, wf), min=3)
    half = torch.div(window, 2, rounding_mode="floor")
    h_cap = ne // 6 + 2

    mu_dense = _triangle_smooth_until_monotone(mu_dense, m_dense, half, smooth_iter, h_cap)
    env_dense = _triangle_smooth_until_monotone(env_dense, m_dense, half, smooth_iter, h_cap)

    # restrict to the original grid (the reference's final interp back onto
    # signal.time, decomposition.py:156-157, is an exact lookup here)
    orig = torch.clamp(torch.arange(n, device=x.device) - q[0], 0, ne - 1)
    return mu_dense[orig], env_dense[orig], ok


def lmd_iter(t, x, max_iter=10, pad_width=0, smooth_iter=12, eps=1e-6, *, device=None):
    """Extract one product function by iterated demodulation (reference
    decomposition.py:165-183).

    Returns (A [N], F [N], is_monotonic). ``F`` is clipped to [-1, 1]; the
    monotonic flag mirrors the reference's ValueError path (sifting ran out
    of extrema at a demodulation step, discarding that step's update).
    """
    t, F = _series(t, x, device)
    A = torch.ones_like(F)
    mono = False
    for _ in range(max_iter):
        mu, env, ok = lmd_sift(t, F, pad_width=pad_width, smooth_iter=smooth_iter)
        newF = (F - mu) / env
        converged = (newF.abs().max() - 1.0) < eps
        ok, converged = _read(ok, converged)
        if not ok:
            mono = True
            break
        F, A = newF, A * env
        if converged:
            break
    return A, torch.clamp(F, -1.0, 1.0), mono
