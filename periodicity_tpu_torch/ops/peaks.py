"""Local maxima and prominences, vectorised over all peaks at once.

Port of the part of ``periodicity_tpu/ops/peaks.py`` that
``FSeries.find_peaks`` needs with no selection criteria: scipy plateau
semantics for the maxima, and prominences from range-max / range-min
sparse tables with a binary descent per peak. JAX's ``vmap`` over peaks
becomes plain tensor ops over a [K] vector of peaks, on the input's
device. The selection criteria wait for the full container port
(ROADMAP A4).
"""

import math

import torch

__all__ = ["local_maxima_info", "peak_prominences", "find_peaks_full"]


def _ilog2(n):
    """Exact floor(log2(n)) of an integer tensor n >= 1 (frexp of the
    float64 value, exact for n < 2^53)."""
    return torch.frexp(n.to(torch.float64)).exponent.to(torch.int64) - 1


def local_maxima_info(x):
    """Local maxima with scipy plateau semantics, plus plateau edges.

    A sample i (0 < i < N-1) is a peak if it is the midpoint of a maximal
    run of equal values whose left and right neighbours are strictly
    smaller (scipy.signal._local_maxima_1d).

    Returns (mask [N] bool, left_edges [N], right_edges [N] int32): at a
    peak midpoint m the first/last sample of its plateau, elsewhere 0.
    """
    n = x.shape[0]
    device = x.device
    if n < 3:
        z = torch.zeros(n, dtype=torch.int32, device=device)
        return torch.zeros(n, dtype=torch.bool, device=device), z, z
    # run_start(m) = last change position <= m (cummax of packed keys),
    # run_end(m) = last plateau sample (reverse cummin of packed keys), with
    # the rising/falling comparison carried in the key's low bit
    diff_gt = x[1:] > x[:-1]
    diff_lt = x[1:] < x[:-1]
    chg = diff_gt | diff_lt
    k = torch.arange(1, n, dtype=torch.int64, device=device)
    minus1 = torch.full((1,), -1, dtype=torch.int64, device=device)
    key_l = torch.where(chg, 2 * k + diff_gt.to(torch.int64), minus1)
    v_l = torch.cummax(torch.cat([minus1, key_l]), dim=0).values
    has_l = v_l >= 0
    run_start = torch.where(has_l, v_l >> 1, 0)
    rising = has_l & ((v_l & 1) == 1)
    # change between k and k+1 recorded AT k = 0..n-2; sentinel at n-1
    kk = torch.arange(0, n - 1, dtype=torch.int64, device=device)
    sentinel = torch.full((1,), 2 * (n - 1) + 1, dtype=torch.int64, device=device)
    key_r = torch.where(chg, 2 * kk + diff_lt.to(torch.int64), sentinel)
    rev = torch.flip(torch.cat([key_r, sentinel]), dims=(0,))
    v_r = torch.flip(torch.cummin(rev, dim=0).values, dims=(0,))
    run_end = v_r >> 1
    falling = ((v_r & 1) == 1) & (run_end <= n - 2)
    m = torch.arange(n, dtype=torch.int64, device=device)
    mask = rising & falling & (m == torch.div(run_start + run_end, 2, rounding_mode="floor"))
    left = torch.where(mask, run_start, 0).to(torch.int32)
    right = torch.where(mask, run_end, 0).to(torch.int32)
    return mask, left, right


def _sparse_tables(x):
    """Range-max and range-min sparse tables, each [levels, N]."""
    n = x.shape[0]
    levels = 1
    while (1 << levels) <= n:
        levels += 1
    mx = [x]
    mn = [x]
    for k in range(1, levels):
        h = 1 << (k - 1)
        prev_mx, prev_mn = mx[-1], mn[-1]
        shifted_mx = torch.cat([prev_mx[h:], prev_mx[-1:].repeat(h)])
        shifted_mn = torch.cat([prev_mn[h:], prev_mn[-1:].repeat(h)])
        mx.append(torch.maximum(prev_mx, shifted_mx))
        mn.append(torch.minimum(prev_mn, shifted_mn))
    return torch.stack(mx), torch.stack(mn)


def _range_query(table, lo, hi, op):
    n = table.shape[1]
    k = _ilog2(torch.clamp(hi - lo + 1, min=1))
    a = table[k, torch.clamp(lo, 0, n - 1)]
    b = table[k, torch.clamp(hi - (torch.ones_like(k) << k) + 1, 0, n - 1)]
    return op(a, b)


def _range_max(mx, lo, hi):
    return _range_query(mx, lo, hi, torch.maximum)


def _range_min(mn, lo, hi):
    return _range_query(mn, lo, hi, torch.minimum)


def _argmin_in_range(mn, lo, hi, steps, leftmost=True):
    """Index of the min over [lo, hi]; leftmost or rightmost occurrence
    (scipy's base is the occurrence of the range-min closest to the
    peak)."""
    target = _range_min(mn, lo, hi)
    lo_, hi_ = lo, hi
    for _ in range(steps):
        if leftmost:
            mid = torch.div(lo_ + hi_, 2, rounding_mode="floor")
            go_left = _range_min(mn, lo_, mid) <= target
            lo_, hi_ = torch.where(go_left, lo_, mid + 1), torch.where(go_left, mid, hi_)
        else:
            mid = torch.div(lo_ + hi_ + 1, 2, rounding_mode="floor")
            go_right = _range_min(mn, mid, hi_) <= target
            lo_, hi_ = torch.where(go_right, mid, lo_), torch.where(go_right, hi_, mid - 1)
    return lo_ if leftmost else hi_


def peak_prominences(x, peaks, wlen=None):
    """Prominences and bases for peak indices (scipy.signal.peak_prominences).

    x: [N] signal. peaks: [K] integer peak indices on ``x``'s device;
    entries >= N are padding and yield 0. wlen: optional window length in
    samples (rounded up to the next odd integer; the base search is
    restricted to ``[p - wlen//2, p + wlen//2]``).

    Returns prominences [K], left_bases [K], right_bases [K] (int64).
    """
    n = x.shape[0]
    mx, mn = _sparse_tables(x)
    steps = 1
    while (1 << steps) <= n:
        steps += 1
    p = peaks.to(torch.int64)
    p_safe = torch.clamp(p, 0, n - 1)
    v = x[p_safe]
    if wlen is None:
        w_lo = torch.zeros_like(p_safe)
        w_hi = torch.full_like(p_safe, n - 1)
    else:
        w = math.ceil(wlen)
        half_w = (w if w % 2 == 0 else w - 1) // 2
        w_lo = torch.clamp(p_safe - half_w, min=0)
        w_hi = torch.clamp(p_safe + half_w, max=n - 1)

    # rightmost index j in [w_lo, p-1] with x[j] > v (or w_lo - 1)
    lo, hi = w_lo, torch.maximum(p_safe - 1, w_lo)
    has = (p_safe - 1 >= w_lo) & (_range_max(mx, w_lo, hi) > v)
    for _ in range(steps):
        mid = torch.div(lo + hi + 1, 2, rounding_mode="floor")
        go_right = _range_max(mx, mid, hi) > v
        lo, hi = torch.where(go_right, mid, lo), torch.where(go_right, hi, mid - 1)
    lh = torch.where(has, lo, w_lo - 1)

    # leftmost index j in [p+1, w_hi] with x[j] > v (or w_hi + 1)
    lo, hi = torch.minimum(p_safe + 1, w_hi), w_hi
    has = (w_hi >= p_safe + 1) & (_range_max(mx, lo, w_hi) > v)
    for _ in range(steps):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        go_left = _range_max(mx, lo, mid) > v
        lo, hi = torch.where(go_left, lo, mid + 1), torch.where(go_left, mid, hi)
    rh = torch.where(has, lo, w_hi + 1)

    l_lo = torch.maximum(lh + 1, w_lo)
    r_hi = torch.minimum(rh - 1, w_hi)
    lmin = _range_min(mn, l_lo, p_safe)
    rmin = _range_min(mn, p_safe, r_hi)
    prom = v - torch.maximum(lmin, rmin)
    lbase = _argmin_in_range(mn, l_lo, p_safe, steps, leftmost=False)
    rbase = _argmin_in_range(mn, p_safe, r_hi, steps, leftmost=True)
    ok = p < n
    return (
        torch.where(ok, prom, torch.zeros_like(prom)),
        torch.where(ok, lbase, 0),
        torch.where(ok, rbase, 0),
    )


def find_peaks_full(x, capacity=None, height=None, threshold=None,
                    distance=None, prominence=None, width=None, wlen=None,
                    rel_height=0.5, plateau_size=None):
    """scipy.signal.find_peaks with no selection criteria: every local
    maximum (plateau midpoints). Returns (indices [capacity] int64, count,
    properties) with sentinel index ``n`` past the count, as the JAX
    package does. The criteria raise NotImplementedError (ROADMAP A4)."""
    criteria = {
        "height": height, "threshold": threshold, "distance": distance,
        "prominence": prominence, "width": width, "plateau_size": plateau_size,
    }
    named = [k for k, v in criteria.items() if v is not None]
    if named:
        raise NotImplementedError(
            f"find_peaks criteria {named} are not ported yet (ROADMAP A4)"
        )
    n = x.shape[0]
    if capacity is None:
        capacity = n // 2 + 1
    mask, _, _ = local_maxima_info(x)
    found = torch.nonzero(mask)[:, 0][:capacity]
    idx = torch.full((capacity,), n, dtype=torch.int64, device=x.device)
    idx[: found.shape[0]] = found
    return idx, found.shape[0], {}
