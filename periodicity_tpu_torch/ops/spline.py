"""Cubic, quadratic and smoothing splines as banded solves.

Port of ``periodicity_tpu/ops/spline.py``, with its names: the not-a-knot
cubic spline (``splrep(s=0)``/``splev``) in the first-derivative form,
solved by parallel cyclic reduction (or the Thomas recursion below 32
knots), with the masked fixed-capacity variant (``count``, ``hi``) that
EMD's sift uses, over a leading batch axis of independent splines
(``[..., K]``, where JAX vmaps); the quadratic B-spline interpolant; and the Reinsch
smoothing spline with FITPACK's ``s`` criterion.

The smoothing spline's pentadiagonal LDL^T solve is the recursion JAX runs
as ``lax.scan`` (``periodicity_tpu/ops/spline.py:379-431``). On a CUDA
tensor ``_pentadiagonal_solve`` launches the hand-written kernel
``csrc/recursions.cu`` (one thread, one launch a system); on a CPU tensor
it is ``pentadiagonal_solve_plain``, which steps through numpy scalars of
the working dtype. Both round every operation on its own in JAX's order,
so they agree bit for bit.
"""

import ctypes

import numpy as np
import torch

__all__ = [
    "tridiagonal_solve",
    "tridiagonal_solve_pcr",
    "spline_derivatives",
    "spline_eval",
    "spline_interp",
    "quadratic_spline_interp",
    "smoothing_spline_values",
    "smoothing_spline_eval",
    "smoothing_spline_interp",
]


def _const(value, like, n=1):
    """[..., n] of ``value`` in like's dtype and device, like's leading shape."""
    return torch.full((*like.shape[:-1], n), value, dtype=like.dtype, device=like.device)


def tridiagonal_solve_pcr(lower, diag, upper, rhs):
    """Parallel cyclic reduction: a tridiagonal solve in ceil(log2 n)
    levels of full-width elementwise ops. Out-of-range neighbours are
    identity rows (a = c = 0, b = 1, d = 0). All inputs [..., n], one
    system a row; lower[..., 0] and upper[..., -1] are ignored."""
    n = diag.shape[-1]
    a = torch.cat([_const(0.0, diag), lower[..., 1:]], -1)
    c = torch.cat([upper[..., :-1], _const(0.0, diag)], -1)
    b = diag
    d = rhs

    def shift_up(v, s, fill):
        # v[i - s], identity-row fill for i < s
        return torch.cat([_const(fill, v, s), v[..., : n - s]], -1)

    def shift_dn(v, s, fill):
        # v[i + s], identity-row fill for i >= n - s
        return torch.cat([v[..., s:], _const(fill, v, s)], -1)

    s = 1
    while s < n:
        a_u, b_u, c_u, d_u = (shift_up(v, s, f) for v, f in ((a, 0.0), (b, 1.0), (c, 0.0),
                                                              (d, 0.0)))
        a_d, b_d, c_d, d_d = (shift_dn(v, s, f) for v, f in ((a, 0.0), (b, 1.0), (c, 0.0),
                                                              (d, 0.0)))
        alpha = -a / b_u
        beta = -c / b_d
        a = alpha * a_u
        c = beta * c_d
        b = b + alpha * c_u + beta * a_d
        d = d + alpha * d_u + beta * d_d
        s *= 2
    return d / b


def tridiagonal_solve(lower, diag, upper, rhs):
    """Thomas algorithm, a loop over the n rows. All inputs [..., n], one
    system a row; lower[..., 0] and upper[..., -1] are ignored."""
    n = diag.shape[-1]
    a = torch.cat([torch.zeros_like(lower[..., :1]), lower[..., 1:]], -1)
    cp = [torch.zeros_like(diag[..., 0])]
    dp = [torch.zeros_like(rhs[..., 0])]
    for i in range(n):
        denom = diag[..., i] - a[..., i] * cp[-1]
        dp.append((rhs[..., i] - a[..., i] * dp[-1]) / denom)
        cp.append(upper[..., i] / denom)
    xs = [torch.zeros_like(rhs[..., 0])]
    for i in range(n, 0, -1):
        xs.append(dp[i] - cp[i] * xs[-1])
    return torch.stack(xs[:0:-1], -1)


# below this size the two Thomas loops are shallow enough that PCR's ~2x
# arithmetic buys nothing (the JAX package's threshold)
_PCR_MIN_SIZE = 32


def _solve_tridiag(lower, diag, upper, rhs):
    if diag.shape[-1] >= _PCR_MIN_SIZE:
        return tridiagonal_solve_pcr(lower, diag, upper, rhs)
    return tridiagonal_solve(lower, diag, upper, rhs)


def _take(v, i):
    """v[..., i] for an index tensor i [..., M] (negative indices count
    from the end, as in numpy)."""
    i = torch.where(i < 0, i + v.shape[-1], i).long()
    return torch.gather(v, -1, i.expand(*v.shape[:-1], i.shape[-1]))


def spline_derivatives(x, y, count=None):
    """First derivatives s_i of the not-a-knot cubic spline through (x, y).

    x: [..., K] strictly increasing knots (entries >= count are padding and
    must still be strictly increasing); y: [..., K] values; one spline a
    row. count: optional number of valid knots (>= 4 for true not-a-knot
    behaviour; the rows beyond it become identity equations), an int, a
    0-d integer tensor or one per row [...].
    """
    k = x.shape[-1]
    dx = torch.diff(x, dim=-1)
    slope = torch.diff(y, dim=-1) / dx
    dx0, dx1 = dx[..., :1], dx[..., 1:2]
    zero, one = _const(0.0, x), _const(1.0, x)
    # interior rows i = 1..k-2: dx[i] s[i-1] + 2(dx[i-1] + dx[i]) s[i] + dx[i-1] s[i+1]
    lower = torch.cat([zero, dx[..., 1:], zero], -1)
    diag = torch.cat([one, 2.0 * (dx[..., :-1] + dx[..., 1:]), one], -1)
    upper = torch.cat([zero, dx[..., :-1], zero], -1)
    rhs = torch.cat([zero, 3.0 * (dx[..., 1:] * slope[..., :-1] + dx[..., :-1] * slope[..., 1:]),
                     zero], -1)
    d0 = x[..., 2:3] - x[..., :1]
    b0 = ((dx0 + 2.0 * d0) * dx1 * slope[..., :1] + dx0 * dx0 * slope[..., 1:2]) / d0

    if count is None:
        # not-a-knot boundary rows
        dxl, dxm = dx[..., -1:], dx[..., -2:-1]
        dn = x[..., -1:] - x[..., -3:-2]
        bn = (dxl * dxl * slope[..., -2:-1] + (2.0 * dn + dxl) * dxm * slope[..., -1:]) / dn
        diag = torch.cat([dx1, diag[..., 1:-1], dxm], -1)
        upper = torch.cat([d0, upper[..., 1:]], -1)
        lower = torch.cat([lower[..., :-1], dn], -1)
        rhs = torch.cat([b0, rhs[..., 1:-1], bn], -1)
        return _solve_tridiag(lower, diag, upper, rhs)

    # masked variant: the valid knots are x[..., 0:count]
    c = torch.as_tensor(count, device=x.device).expand(x.shape[:-1])[..., None]
    i1, i2, i3 = (torch.clamp(c - j, max=k - 1) for j in (1, 2, 3))
    dx_l = _take(x, i1) - _take(x, i2)
    dx_m = _take(x, i2) - _take(x, i3)
    sl_l = (_take(y, i1) - _take(y, i2)) / dx_l
    sl_m = (_take(y, i2) - _take(y, i3)) / dx_m
    dn = _take(x, i1) - _take(x, i3)
    bn = (dx_l * dx_l * sl_m + (2.0 * dn + dx_l) * dx_m * sl_l) / dn
    diag = torch.cat([dx1, diag[..., 1:]], -1)
    upper = torch.cat([d0, upper[..., 1:]], -1)
    rhs = torch.cat([b0, rhs[..., 1:]], -1)
    idx = torch.arange(k, device=x.device)
    is_last = idx == (c - 1)
    pad = idx >= c
    lower = torch.where(is_last, dn, torch.where(pad, 0.0, lower))
    diag = torch.where(is_last, dx_m, torch.where(pad, 1.0, diag))
    upper = torch.where(is_last | pad, 0.0, upper)
    rhs = torch.where(is_last, bn, torch.where(pad, 0.0, rhs))
    return _solve_tridiag(lower, diag, upper, rhs)


# the comparison sum below is quadratic in the problem size, so it is used
# only while M*K stays small, as in the JAX package
_CMPSUM_MAX_ELEMS = 1 << 26


def _interval_index(x, q, side="right"):
    """``searchsorted(x, q, side)``: #{j : x[j] <= q} (right) or < q (left)."""
    if q.dim() == 1 and x.shape[0] * q.shape[0] <= _CMPSUM_MAX_ELEMS:
        if side == "right":
            return (x[None, :] <= q[:, None]).sum(1)
        return (x[None, :] < q[:, None]).sum(1)
    return torch.searchsorted(x, q.contiguous(), side=side)


def spline_eval(x, y, s, xnew, count=None, hi=None):
    """Evaluate the Hermite form of the spline at xnew (cubic
    extrapolation). x, y, s: [..., K] knots, values, derivatives, one
    spline a row; xnew: [M] or [..., M]; count: valid knot count (an int,
    a 0-d tensor or one per row); ``hi`` optionally the precomputed
    interval index ``searchsorted(x, xnew, "right")`` [..., M]."""
    k = x.shape[-1]
    if hi is None:
        if x.dim() == 1:
            hi = _interval_index(x, xnew)
        else:
            q = xnew.expand(*x.shape[:-1], xnew.shape[-1]).contiguous()
            hi = torch.searchsorted(x.contiguous(), q, side="right")
    if count is None:
        i = torch.clamp(hi - 1, 0, k - 2)
    else:
        c = torch.as_tensor(count, device=x.device).expand(x.shape[:-1])[..., None]
        top = torch.clamp(c - 2, min=0)
        i = torch.minimum(torch.clamp(hi - 1, min=0), top)
    nxt = torch.cat([torch.arange(1, k, device=x.device),
                     torch.tensor([k - 1], device=x.device)])
    rows = torch.stack([x, x[..., nxt], y, y[..., nxt], s, s[..., nxt]], dim=-1)  # [..., K, 6]
    i = i.long().expand(*x.shape[:-1], i.shape[-1])
    rows = torch.gather(rows, -2, i[..., None].expand(*i.shape, 6))  # [..., M, 6]
    x0, x1, y0, y1, s0, s1 = rows.unbind(-1)
    h = x1 - x0
    t = (xnew - x0) / h
    h00 = (1 + 2 * t) * (1 - t) ** 2
    h10 = t * (1 - t) ** 2
    h01 = t * t * (3 - 2 * t)
    h11 = t * t * (t - 1)
    return h00 * y0 + h10 * h * s0 + h01 * y1 + h11 * h * s1


def spline_interp(x, y, xnew, count=None, hi=None):
    """Not-a-knot cubic spline interpolation (== scipy splrep(s=0)/splev),
    one spline a row of x, y [..., K]."""
    s = spline_derivatives(x, y, count=count)
    return spline_eval(x, y, s, xnew, count=count, hi=hi)


def _quadratic_bspline_basis(knots, x):
    """The three nonzero degree-2 B-spline values at x: (j0 [M], b [M, 3])
    with b[:, r] the value of basis j0 + r (unrolled de Boor recurrence,
    0/0 taken as 0)."""
    n_knots = knots.shape[0]
    ind = torch.clamp(_interval_index(knots, x) - 1, 2, n_knots - 4)

    def basis_step(bs, degree):
        out = []
        for r in range(degree + 1):
            j = ind - degree + r
            left = bs[r - 1] if r > 0 else torch.zeros_like(x)
            right = bs[r] if r < degree else torch.zeros_like(x)
            tj = knots[j]
            tjd = knots[torch.clamp(j + degree, 0, n_knots - 1)]
            tj1 = knots[torch.clamp(j + 1, 0, n_knots - 1)]
            tjd1 = knots[torch.clamp(j + degree + 1, 0, n_knots - 1)]
            d1 = tjd - tj
            d2 = tjd1 - tj1
            a = torch.where(d1 > 0, (x - tj) / torch.where(d1 > 0, d1, 1.0), 0.0)
            c = torch.where(d2 > 0, (tjd1 - x) / torch.where(d2 > 0, d2, 1.0), 0.0)
            out.append(a * left + c * right)
        return out

    b2 = basis_step(basis_step([torch.ones_like(x)], 1), 2)
    return ind - 2, torch.stack(b2, dim=-1)


def quadratic_spline_interp(x, y, xnew):
    """Quadratic (k=2) B-spline interpolation with midpoint interior knots
    (scipy make_interp_spline(k=2) parity). The collocation system is
    tridiagonal for this knot layout."""
    n = x.shape[0]
    mids = 0.5 * (x[1:-2] + x[2:-1])
    knots = torch.cat([x[:1].repeat(3), mids, x[-1:].repeat(3)])
    j0, basis = _quadratic_bspline_basis(knots, x)
    # row i's nonzero columns are j0[i] + (0, 1, 2), at offsets -1, 0, 1 from i
    offs = (j0[:, None] + torch.arange(3, device=x.device)[None, :]
            - torch.arange(n, device=x.device)[:, None])
    lower = torch.where(offs == -1, basis, 0.0).sum(1)
    diag = torch.where(offs == 0, basis, 0.0).sum(1)
    upper = torch.where(offs == 1, basis, 0.0).sum(1)
    coefs = _solve_tridiag(lower, diag, upper, y)
    j0n, basis_n = _quadratic_bspline_basis(knots, xnew)
    cols = j0n[:, None] + torch.arange(3, device=x.device)[None, :]
    return (coefs[torch.clamp(cols, 0, n - 1)] * basis_n).sum(1)


def smoothing_spline_values(x, y, lam, w=None):
    """Cubic smoothing spline (Reinsch 1967): fitted values and natural
    second derivatives at the knots.

    Minimizes sum_i w_i (y_i - f(x_i))^2 + lam * int f''(t)^2 dt. Returns
    (f [n], gamma [n]) where gamma are f'' at the knots (natural ends = 0).
    """
    n = x.shape[0]
    (main, off1, off2), (q0, q1, q2), Dinv2 = _reinsch_system(x, lam, w)
    gamma_int = _pentadiagonal_solve(main, off1, off2, _qt_apply(q0, q1, q2, y))
    f = y - lam * Dinv2 * _qt_transpose_apply(q0, q1, q2, gamma_int, n)
    zero = _const(0.0, x)
    return f, torch.cat([zero, gamma_int, zero])


def _reinsch_system(x, lam, w=None):
    """The bands (main [m], off1 [m-1], off2 [m-2]) of M = lam Q^T W^-1 Q + T,
    symmetric pentadiagonal with m = n - 2, built directly (never as a dense
    matrix); the second-difference operator Q^T's rows (q0, q1, q2) at
    columns (i, i+1, i+2); and the variance weights 1 / w."""
    n = x.shape[0]
    if w is None:
        w = torch.ones(n, dtype=x.dtype, device=x.device)
    h = torch.diff(x)
    hi = h[:-1]
    hj = h[1:]
    main_T = (hi + hj) / 3.0
    off_T = h[1:-1] / 6.0
    q0 = 1.0 / hi
    q1 = -1.0 / hi - 1.0 / hj
    q2 = 1.0 / hj
    Dinv2 = 1.0 / w
    wi = Dinv2[: n - 2]
    wi1 = Dinv2[1: n - 1]
    wi2 = Dinv2[2:]
    a0 = wi * q0**2 + wi1 * q1**2 + wi2 * q2**2
    a1 = wi1[: n - 3] * q1[: n - 3] * q0[1:] + wi2[: n - 3] * q2[: n - 3] * q1[1:]
    a2 = wi2[: n - 4] * q2[: n - 4] * q0[2:]
    bands = (lam * a0 + main_T, lam * a1 + off_T[: n - 3], lam * a2)
    return bands, (q0, q1, q2), Dinv2


def _qt_apply(q0, q1, q2, y):
    """Q^T y for the banded second-difference operator."""
    return q0 * y[:-2] + q1 * y[1:-1] + q2 * y[2:]


def _qt_transpose_apply(q0, q1, q2, g, n):
    """Q g (length n) for the banded second-difference operator."""
    out = torch.zeros(n, dtype=g.dtype, device=g.device)
    out[: n - 2] += q0 * g
    out[1: n - 1] += q1 * g
    out[2:] += q2 * g
    return out


def _bands(main, off1, off2, rhs):
    """The four inputs of one system in its working dtype, on main's
    device, and m."""
    m = main.shape[0]
    shapes = (off1.shape[0], off2.shape[0], rhs.shape[0])
    if shapes != (max(m - 1, 0), max(m - 2, 0), m):
        raise ValueError(f"bands of a size-{m} system: off1 [{m - 1}], off2 [{m - 2}], "
                         f"rhs [{m}]; got {shapes}")
    dtype = main.dtype
    return [v.to(dtype) for v in (main, off1, off2, rhs)], m


def _pentadiagonal_rows(main, off1, off2, rhs):
    """The LDL^T factor and the two substitutions on host numpy, in JAX's
    order of operations, with its zero-pivot guards."""
    m = main.shape[0]
    zero = main.dtype.type(0)
    # numpy scalars of the working dtype: a zero pivot gives inf or NaN as
    # in JAX, where a Python float would raise
    a, r, b, c = list(main), list(rhs), [zero, *off1], [zero, zero, *off2]
    alpha, beta, zd = [], [], []
    D1 = D2 = al1 = z1 = z2 = zero
    for i in range(m):
        be = c[i] / D2 if D2 != 0 else zero
        al = (b[i] - be * al1 * D2) / D1 if D1 != 0 else zero
        D = a[i] - al * al * D1 - be * be * D2
        z = r[i] - al * z1 - be * z2
        alpha.append(al)
        beta.append(be)
        zd.append(z / D)
        D1, D2, al1, z1, z2 = D, D1, al, z, z1
    alpha += [zero]
    beta += [zero, zero]
    out = [zero] * m
    x1 = x2 = zero
    for i in range(m - 1, -1, -1):
        xv = zd[i] - alpha[i + 1] * x1 - beta[i + 2] * x2
        out[i] = xv
        x1, x2 = xv, x1
    return np.array(out, dtype=main.dtype)


def pentadiagonal_solve_plain(main, off1, off2, rhs):
    """:func:`_pentadiagonal_solve` as its plain version: the recursions
    step through numpy scalars of the working dtype on the host, and the
    solution goes back to main's device."""
    (main, off1, off2, rhs), m = _bands(main, off1, off2, rhs)
    host = (v.cpu().numpy() for v in (main, off1, off2, rhs))
    with np.errstate(all="ignore"):
        x = _pentadiagonal_rows(*host)
    return torch.from_numpy(x).to(main.device)


def _pentadiagonal_solve(main, off1, off2, rhs):
    """Solve the symmetric positive-definite pentadiagonal system with
    diagonals (main [m], off1 [m-1], off2 [m-2]) by an LDL^T factorization
    and a forward and a backward substitution (O(m) work, depth O(m)).

    On a CUDA tensor this launches the kernel once, on the current stream,
    without synchronising; on a CPU tensor it is
    :func:`pentadiagonal_solve_plain`. ``_pentadiagonal_solve.launches``
    counts the kernel launches.
    """
    if main.device.type == "cpu":
        return pentadiagonal_solve_plain(main, off1, off2, rhs)
    if main.device.type != "cuda":
        raise ValueError(f"unsupported device {main.device}")
    (main, off1, off2, rhs), m = _bands(main, off1, off2, rhs)
    if main.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the kernel takes float32 or float64, got {main.dtype}")
    for name, v in (("off1", off1), ("off2", off2), ("rhs", rhs)):
        if v.device != main.device:
            raise ValueError(f"{name} is on {v.device}, main on {main.device}")
    out = torch.empty(m, dtype=main.dtype, device=main.device)
    if m == 0:
        return out
    main, off1, off2, rhs = (v.contiguous() for v in (main, off1, off2, rhs))
    scratch = torch.empty(2 * m, dtype=main.dtype, device=main.device)

    from ._kernels import load

    fn = getattr(load(), "pentadiagonal_solve_f32" if main.dtype == torch.float32
                 else "pentadiagonal_solve_f64")
    with torch.cuda.device(main.device):
        stream = torch.cuda.current_stream(main.device).cuda_stream
        err = fn(main.data_ptr(), off1.data_ptr(), off2.data_ptr(), rhs.data_ptr(), m,
                 scratch.data_ptr(), out.data_ptr(), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"pentadiagonal_solve launch failed: cudaError {err}")
    _pentadiagonal_solve.launches += 1
    return out


_pentadiagonal_solve.launches = 0


def kernel_attributes(dtype):
    """The solve kernel's ``local_bytes`` of local memory and ``registers``
    a thread and static ``shared_bytes`` a block in ``dtype``, as the runtime
    reports them on the current card (its ring of tiles is dynamic shared
    memory, sized by :func:`pentadiagonal_capacity`)."""
    from ._kernels import _recursion_attributes

    return _recursion_attributes(dtype)[0]


def pentadiagonal_capacity(dtype):
    """Rows of a system that the solve kernel keeps in shared memory from
    the first load to the store of x on the current card; a larger system
    streams its tiles through the global scratch."""
    from ._kernels import load

    rows = load().pentadiagonal_capacity(torch.empty((), dtype=dtype).element_size())
    if rows < 0:
        raise RuntimeError(f"pentadiagonal_capacity failed: cudaError {-rows}")
    return rows


def smoothing_spline_eval(x, f, gamma, xnew):
    """Evaluate the natural cubic spline with knot values f and second
    derivatives gamma at xnew. Beyond the data range the edge segment's
    cubic is extrapolated (as splev and make_smoothing_spline do)."""
    n = x.shape[0]
    i = torch.clamp(torch.searchsorted(x, xnew.contiguous(), side="right") - 1, 0, n - 2)
    h = x[i + 1] - x[i]
    a = (x[i + 1] - xnew) / h
    b = (xnew - x[i]) / h
    return (a * f[i] + b * f[i + 1]
            + ((a**3 - a) * gamma[i] + (b**3 - b) * gamma[i + 1]) * h**2 / 6.0)


def smoothing_spline_interp(x, y, xnew, s, w=None, max_iter=60):
    """splrep(s)/splev-style smoothing interpolation: picks lam so that
    FITPACK's smoothing condition sum((w * (y - f))**2) ~= s holds, by
    bisection on log(lam) in [1e-12, 1e12] (``max_iter`` halvings), then
    evaluates at xnew. FITPACK weights residuals by w**2, so the Reinsch
    solve receives squared weights. s == 0 is the interpolating
    not-a-knot spline. Each bisection step reads one sum back to the
    host."""
    if s == 0:
        return spline_interp(x, y, xnew)
    w2 = None if w is None else w**2

    def rss(lam):
        f, _ = smoothing_spline_values(x, y, lam, w2)
        r = y - f
        ww = torch.ones_like(y) if w2 is None else w2
        return float((ww * r * r).sum())

    # bisection on log(lam): rss is monotone increasing in lam
    lo, hi = 1e-12, 1e12
    if rss(hi) < s:
        lam = hi
    elif rss(lo) > s:
        lam = lo
    else:
        for _ in range(max_iter):
            mid = float(np.sqrt(lo * hi))
            if rss(mid) > s:
                hi = mid
            else:
                lo = mid
        lam = float(np.sqrt(lo * hi))
    f, gamma = smoothing_spline_values(x, y, lam, w2)
    return smoothing_spline_eval(x, f, gamma, xnew)
