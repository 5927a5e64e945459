"""Local maxima, prominences, widths and scipy's peak selection,
vectorised over all peaks at once.

Port of ``periodicity_tpu/ops/peaks.py``, with its names: scipy plateau
semantics for the maxima, prominences and widths from range-max /
range-min sparse tables with a binary descent per peak, and every
criterion of ``scipy.signal.find_peaks`` in scipy's order. JAX's ``vmap``
over peaks becomes plain tensor ops over a [K] vector of peaks, on the
input's device; its ``nonzero(size=K)`` capacity buffers keep their
sentinel index ``n`` past the count. The maxima and zero-crossing masks
take a leading batch axis ``[..., N]`` (EMD sifts many series at once,
where JAX vmaps them).
"""

import math

import torch

__all__ = [
    "local_maxima_mask",
    "local_maxima_info",
    "peak_prominences",
    "peak_widths",
    "select_by_peak_distance",
    "find_peaks",
    "find_peaks_full",
    "zero_crossings_mask",
]


def _ilog2(n):
    """Exact floor(log2(n)) of an integer tensor n >= 1 (frexp of the
    float64 value, exact for n < 2^53)."""
    return torch.frexp(n.to(torch.float64)).exponent.to(torch.int64) - 1


def local_maxima_info(x):
    """Local maxima with scipy plateau semantics, plus plateau edges.

    A sample i (0 < i < N-1) is a peak if it is the midpoint of a maximal
    run of equal values whose left and right neighbours are strictly
    smaller (scipy.signal._local_maxima_1d).

    x: [..., N], rows independent (the JAX package vmaps the 1-D function).
    Returns (mask [..., N] bool, left_edges [..., N], right_edges [..., N]
    int32): at a peak midpoint m the first/last sample of its plateau,
    elsewhere 0.
    """
    n = x.shape[-1]
    device = x.device
    lead = x.shape[:-1]
    if n < 3:
        z = torch.zeros(x.shape, dtype=torch.int32, device=device)
        return torch.zeros(x.shape, dtype=torch.bool, device=device), z, z
    # run_start(m) = last change position <= m (cummax of packed keys),
    # run_end(m) = last plateau sample (reverse cummin of packed keys), with
    # the rising/falling comparison carried in the key's low bit
    diff_gt = x[..., 1:] > x[..., :-1]
    diff_lt = x[..., 1:] < x[..., :-1]
    chg = diff_gt | diff_lt
    k = torch.arange(1, n, dtype=torch.int64, device=device)
    minus1 = torch.full((*lead, 1), -1, dtype=torch.int64, device=device)
    key_l = torch.where(chg, 2 * k + diff_gt.to(torch.int64), minus1)
    v_l = torch.cummax(torch.cat([minus1, key_l], -1), dim=-1).values
    has_l = v_l >= 0
    run_start = torch.where(has_l, v_l >> 1, 0)
    rising = has_l & ((v_l & 1) == 1)
    # change between k and k+1 recorded AT k = 0..n-2; sentinel at n-1
    kk = torch.arange(0, n - 1, dtype=torch.int64, device=device)
    sentinel = torch.full((*lead, 1), 2 * (n - 1) + 1, dtype=torch.int64, device=device)
    key_r = torch.where(chg, 2 * kk + diff_lt.to(torch.int64), sentinel)
    rev = torch.flip(torch.cat([key_r, sentinel], -1), dims=(-1,))
    v_r = torch.flip(torch.cummin(rev, dim=-1).values, dims=(-1,))
    run_end = v_r >> 1
    falling = ((v_r & 1) == 1) & (run_end <= n - 2)
    m = torch.arange(n, dtype=torch.int64, device=device)
    mask = rising & falling & (m == torch.div(run_start + run_end, 2, rounding_mode="floor"))
    left = torch.where(mask, run_start, 0).to(torch.int32)
    right = torch.where(mask, run_end, 0).to(torch.int32)
    return mask, left, right


def local_maxima_mask(x):
    """Boolean mask [..., N] of local maxima with scipy plateau semantics."""
    return local_maxima_info(x)[0]


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


def peak_widths(x, peaks, prominences, left_bases, right_bases, rel_height=0.5):
    """Peak widths at a relative height (scipy.signal.peak_widths), from
    the prominence data of :func:`peak_prominences` (with the same
    ``wlen``). Entries with ``peaks >= N`` are padding and yield 0.

    Returns (widths [K], width_heights [K], left_ips [K], right_ips [K]).
    """
    n = x.shape[0]
    _, mn = _sparse_tables(x)
    steps = 1
    while (1 << steps) <= n:
        steps += 1
    p = peaks.to(torch.int64)
    p_safe = torch.clamp(p, 0, n - 1)
    height = x[p_safe] - prominences * rel_height
    lb = torch.clamp(left_bases.to(torch.int64), 0, n - 1)
    rb = torch.clamp(right_bases.to(torch.int64), 0, n - 1)

    def descend(lo0, hi0, rightmost):
        # rightmost: the largest i in [lo0, hi0] with x[i] <= height;
        # otherwise the smallest
        lo, hi = lo0, hi0
        for _ in range(steps):
            if rightmost:
                mid = torch.div(lo + hi + 1, 2, rounding_mode="floor")
                good = _range_min(mn, mid, hi0) <= height
                lo, hi = torch.where(good, mid, lo), torch.where(good, hi, mid - 1)
            else:
                mid = torch.div(lo + hi, 2, rounding_mode="floor")
                good = _range_min(mn, lo0, mid) <= height
                lo, hi = torch.where(good, lo, mid + 1), torch.where(good, mid, hi)
        return lo if rightmost else hi

    # walking down from the peak, the first sample at or below the height,
    # then interpolated toward the peak when strictly below it (scipy
    # _peak_widths: left_ip = i + (height - x[i]) / (x[i+1] - x[i]))
    zero = torch.zeros((), dtype=height.dtype, device=x.device)
    lhas = _range_min(mn, lb, p_safe) <= height
    li = torch.where(lhas, descend(lb, p_safe, True), lb)
    li1 = torch.clamp(li + 1, 0, n - 1)
    lfrac = torch.where(x[li] < height, (height - x[li]) / (x[li1] - x[li]), zero)
    left_ip = li + lfrac
    rhas = _range_min(mn, p_safe, rb) <= height
    ri = torch.where(rhas, descend(p_safe, rb, False), rb)
    ri1 = torch.clamp(ri - 1, 0, n - 1)
    rfrac = torch.where(x[ri] < height, (height - x[ri]) / (x[ri1] - x[ri]), zero)
    right_ip = ri - rfrac
    ok = p < n
    return (
        torch.where(ok, right_ip - left_ip, zero),
        torch.where(ok, height, zero),
        torch.where(ok, left_ip, zero),
        torch.where(ok, right_ip, zero),
    )


def select_by_peak_distance(peaks, priority, distance, count=None):
    """Keep mask for peaks closer than ``distance`` (scipy semantics:
    iterate peaks by descending priority; each still-kept peak removes all
    others within ``distance`` samples).

    peaks: [K] ascending positions (sentinel-padded entries must be far
    apart); priority: [K] (peak heights, -inf for padding); count: the
    number of real peaks, which come first in priority order (all K when
    None). Returns keep [K] bool.
    """
    k = peaks.shape[0]
    if count is None:
        count = k
    distance = math.ceil(float(distance))
    # descending priority; stable ascending-position order among ties,
    # reversed (scipy iterates argsort(priority) back to front)
    order = torch.flip(torch.argsort(priority, stable=True), (0,))
    keep = torch.ones(k, dtype=torch.bool, device=peaks.device)
    ar = torch.arange(k, device=peaks.device)
    # JAX's fori_loop over all K slots becomes a loop over the real peaks
    # (padding has the lowest priority and removes nothing real), so its
    # length is the peak count
    for s in range(count):
        j = order[s]
        near = ((peaks - peaks[j]).abs() < distance) & (ar != j)
        keep = torch.where(keep[j], keep & ~near, keep)
    return keep


def _capacity(mask, capacity, n):
    """``jnp.nonzero(mask, size=capacity, fill_value=n)[0]``."""
    found = torch.nonzero(mask)[:, 0][:capacity]
    idx = torch.full((capacity,), n, dtype=torch.int64, device=mask.device)
    idx[: found.shape[0]] = found
    return idx


def find_peaks(x, capacity=None, height=None, prominence=None):
    """Peak indices and prominences with a fixed capacity.

    Returns (indices [K], count, prominences [K], left_bases [K],
    right_bases [K]); slots >= count hold index n and zeros.
    """
    n = x.shape[0]
    if capacity is None:
        capacity = n // 2 + 1
    mask = local_maxima_mask(x)
    if height is not None:
        mask = mask & (x >= height)
    idx = _capacity(mask, capacity, n)
    proms, lb, rb = peak_prominences(x, idx)
    if prominence is not None:
        keep = (idx < n) & (proms >= prominence)
        order = torch.argsort(torch.where(keep, idx, n), stable=True)
        idx = torch.where(keep, idx, n)[order]
        proms = torch.where(keep, proms, 0.0)[order]
        lb = torch.where(keep, lb, 0)[order]
        rb = torch.where(keep, rb, 0)[order]
    return idx, int((idx < n).sum()), proms, lb, rb


def _interval(arg):
    """Split a scipy-style criterion into (min, max); scalars are minima."""
    if isinstance(arg, (tuple, list)):
        return arg[0], (arg[1] if len(arg) > 1 else None)
    return arg, None


def find_peaks_full(x, capacity=None, height=None, threshold=None,
                    distance=None, prominence=None, width=None, wlen=None,
                    rel_height=0.5, plateau_size=None):
    """scipy.signal.find_peaks parity: every selection criterion, evaluated
    in scipy's order (plateau_size, height, threshold, distance,
    prominence, width), with the matching properties dict.

    Criteria are scalars or (min, max) tuples (None = unbounded);
    per-sample criterion arrays are not supported. Returns
    (indices [K] int64, count, properties) with sentinel index ``n`` past
    the count; property tensors are aligned with ``indices``.
    """
    n = x.shape[0]
    if capacity is None:
        capacity = n // 2 + 1
    mask, ledge, redge = local_maxima_info(x)
    idx = _capacity(mask, capacity, n)
    props = {}

    def compact(keep, idx, props):
        new_idx = torch.where(keep & (idx < n), idx, n)
        order = torch.argsort(new_idx, stable=True)
        return new_idx[order], {k: v[order] for k, v in props.items()}

    def within(values, lo, hi):
        keep = torch.ones_like(idx, dtype=torch.bool)
        if lo is not None:
            keep &= values >= lo
        if hi is not None:
            keep &= values <= hi
        return keep

    if plateau_size is not None:
        pmin, pmax = _interval(plateau_size)
        safe = torch.clamp(idx, 0, n - 1)
        le = ledge[safe]
        re = redge[safe]
        sizes = re - le + 1
        props.update(plateau_sizes=sizes, left_edges=le, right_edges=re)
        idx, props = compact(within(sizes, pmin, pmax), idx, props)

    if height is not None:
        hmin, hmax = _interval(height)
        ph = x[torch.clamp(idx, 0, n - 1)]
        props["peak_heights"] = ph
        idx, props = compact(within(ph, hmin, hmax), idx, props)

    if threshold is not None:
        tmin, tmax = _interval(threshold)
        safe = torch.clamp(idx, 0, n - 1)
        lt = x[safe] - x[torch.clamp(safe - 1, 0, n - 1)]
        rt = x[safe] - x[torch.clamp(safe + 1, 0, n - 1)]
        props.update(left_thresholds=lt, right_thresholds=rt)
        keep = (within(torch.minimum(lt, rt), tmin, None)
                & within(torch.maximum(lt, rt), None, tmax))
        idx, props = compact(keep, idx, props)

    if distance is not None:
        valid = idx < n
        # spread sentinel positions far apart so they can't suppress real
        # peaks (or each other) for any sane distance
        k = idx.shape[0]
        pos = torch.where(valid, idx, n + (1 + torch.arange(k, device=x.device)) * n)
        prio = torch.where(valid, x[torch.clamp(idx, 0, n - 1)], float("-inf"))
        keep = select_by_peak_distance(pos, prio, distance, count=int(valid.sum()))
        idx, props = compact(keep, idx, props)

    if prominence is not None or width is not None:
        proms, lb, rb = peak_prominences(x, idx, wlen=wlen)
        props.update(prominences=proms, left_bases=lb, right_bases=rb)

    if prominence is not None:
        pmin, pmax = _interval(prominence)
        idx, props = compact(within(props["prominences"], pmin, pmax), idx, props)

    if width is not None:
        wmin, wmax = _interval(width)
        widths, wh, lip, rip = peak_widths(x, idx, props["prominences"], props["left_bases"],
                                           props["right_bases"], rel_height)
        props.update(widths=widths, width_heights=wh, left_ips=lip, right_ips=rip)
        idx, props = compact(within(widths, wmin, wmax), idx, props)

    return idx, int((idx < n).sum()), props


def zero_crossings_mask(x):
    """Mask m[..., i] = True where the sign bit changes between x[..., i]
    and x[..., i+1] (``np.diff(np.signbit(x))``: the index of the sample
    before the crossing), rows independent. The last element is always
    False."""
    sb = torch.signbit(x)
    last = torch.zeros((*x.shape[:-1], 1), dtype=torch.bool, device=x.device)
    return torch.cat([sb[..., 1:] != sb[..., :-1], last], -1)
