"""Parallel and blocked Kalman forms of the celerite GP log-likelihood.

Port of ``periodicity_tpu/models/gp/pscan.py``. Every SHO-family celerite
term is an exact Gauss-Markov process: a complex pair ``(a, b, c, d)`` has
the 2-state realization ``A(dt) = exp(-c dt) [[cos d dt, sin d dt], [-sin,
cos]]``, ``Pinf = [[a, b], [b, a (1 + 2 c^2 / d^2)]]``, ``H = [1, 0]``, and
a real term ``(a, c)`` the 1-state ``A = exp(-c dt)``, ``Pinf = a``, ``H =
1``; with ``Q_k = Pinf - A_k Pinf A_k^T`` the Kalman innovations give the
dense GP likelihood exactly. The filter is written with the associative
filtering elements of Särkkä & García-Fernández (2021), 5-tuples ``(A, b,
C, eta, J)`` composed by :func:`_combine`.

- :func:`log_likelihood_pscan`: one associative scan over the N elements,
  the port's own copy of ``lax.associative_scan``'s odd/even recursion (the
  same tree as JAX's), each level one batched :func:`_combine`; eager torch
  on both devices (~2 log2 N levels), differentiable by autograd.
- :func:`log_likelihood_blocked`, :func:`log_likelihood_chunked` and
  :func:`log_likelihood_sharded`: the blocked composition K1 (``ops/kalman.py``; a hand kernel on the card, its
  plain version on the CPU), once for the series or once a chunk with the
  composed element carried between chunks, or once a rank's stretch and
  again from the carry the earlier ranks' summaries compose. Their
  gradient is K1's own: autograd runs K1's adjoint K2 (``ops.kalman.
  KalmanBlocked``) on each call, the chunks in reverse with the carry's
  cotangent handed back from the chunk after, and the sharded form
  reverses its rank's passes and sums what the ranks share
  (:class:`_ShardedK1`); the sequential solver is not run.

Every function takes the term's leading batch axes (walkers): elements are
``[..., N, R, R]``. Times are placed by ``core.as_tensor`` (arrays to the
card); the diagonal and the residuals go to the times' device, as in
``solver.log_likelihood``. Float32 products run in full float32.
"""

import math

import torch
import torch.distributed as dist

from ...core import as_tensor
from ...ops.kalman import kalman_blocked, kalman_blocked_adjoint, pack_carry, unpack_carry
from ...parallel.mesh import axis_info
from ...utils.dtypes import full_float32
from .solver import _at

__all__ = [
    "ssm_matrices",
    "log_likelihood_pscan",
    "log_likelihood_blocked",
    "log_likelihood_chunked",
    "log_likelihood_sharded",
]


def ssm_matrices(term, t):
    """Exact discrete SSM (A_k [..., N, R, R], Pinf [..., R, R], H [R]) for
    a celerite SHO-family term on the (sorted) time grid t."""
    coeffs, t = term.coefficients_beside(as_tensor(t))
    dt = torch.cat([t.new_zeros(1), torch.diff(t)])
    return _ssm_from_dt(coeffs, dt)


def _ssm_from_dt(coeffs, dt):
    """SSM matrices from the term's coefficients (on dt's device and dtype)
    and per-step time deltas dt [N] (dt[0] is the slot of the stationary
    prior and may hold any value). Real slots first, then complex pairs."""
    ar, cr, ac, bc, cc, dc = coeffs
    batch = torch.broadcast_shapes(*(c.shape[:-1] for c in coeffs))
    n = dt.shape[0]
    jr, jc = ar.shape[-1], ac.shape[-1]
    r = jr + 2 * jc
    A = dt.new_zeros(batch + (n, r, r))
    Pinf = dt.new_zeros(batch + (r, r))
    for j in range(jr):
        A[..., j, j] = torch.exp(-cr[..., j, None] * dt)
        Pinf[..., j, j] = ar[..., j]
    for j in range(jc):
        p = jr + 2 * j
        e = torch.exp(-cc[..., j, None] * dt)
        arg = dc[..., j, None] * dt
        cosd, sind = torch.cos(arg), torch.sin(arg)
        A[..., p, p] = e * cosd
        A[..., p, p + 1] = e * sind
        A[..., p + 1, p] = e * -sind
        A[..., p + 1, p + 1] = e * cosd
        # masked (zero-amplitude) slots carry dc == 0; keep them inert
        d_safe = torch.where(torch.abs(dc[..., j]) < 1e-30, 1.0, dc[..., j])
        Pinf[..., p, p] = ac[..., j]
        Pinf[..., p, p + 1] = bc[..., j]
        Pinf[..., p + 1, p] = bc[..., j]
        Pinf[..., p + 1, p + 1] = ac[..., j] * (1.0 + 2.0 * cc[..., j] ** 2 / d_safe**2)
    H = torch.tensor([1.0] * jr + [1.0, 0.0] * jc, dtype=dt.dtype, device=dt.device)
    return A, Pinf, H


def _noise(A, Pinf):
    """The exact process noise Q_k = Pinf - A_k Pinf A_k^T [..., N, R, R]."""
    P = Pinf[..., None, :, :]
    return P - A @ P @ A.transpose(-1, -2)


def _process_noise(A, Pinf):
    """(A, Q) with step 0 the stationary prior: A_0 := 0, Q_0 := Pinf."""
    Q = _noise(A, Pinf)
    first = Pinf[..., None, :, :].expand(Q.shape[:-3] + (1,) + Q.shape[-2:])
    Q = torch.cat([first, Q[..., 1:, :, :]], dim=-3)
    A = torch.cat([torch.zeros_like(A[..., :1, :, :]), A[..., 1:, :, :]], dim=-3)
    return A, Q


def _elements_from_AQ(A, Q, H, diag, y):
    """Särkkä & García-Fernández filtering elements from discrete (A, Q):
    A, Q [..., N, R, R], diag, y [..., N]."""
    r = A.shape[-1]
    eye = torch.eye(r, dtype=A.dtype, device=A.device)
    HQH = torch.einsum("i,...nij,j->...n", H, Q, H) + diag  # S_k = H Q H^T + R
    K = (Q @ H) / HQH[..., None]  # [..., N, R]
    ImKH = eye - K[..., :, None] * H
    A_el = ImKH @ A
    b_el = K * y[..., None]
    C_el = ImKH @ Q
    HA = torch.einsum("i,...nij->...nj", H, A)
    eta_el = HA * (y / HQH)[..., None]
    J_el = HA[..., :, None] * HA[..., None, :] / HQH[..., None, None]
    return (A_el, b_el, C_el, eta_el, J_el)


def _filter_elements(A, Pinf, H, diag, y):
    """Filtering elements and the fixed (A, Q): step 0 starts from the
    stationary prior (A_0 := 0, Q_0 := Pinf)."""
    A, Q = _process_noise(A, Pinf)
    return _elements_from_AQ(A, Q, H, diag, y), A, Q


def _solve_small(M, B):
    """Batched solve M X = B by unrolled Gaussian elimination with partial
    pivoting (the first maximal |value|: ``torch.argmax`` returns the first
    index, as ``jnp.argmax`` does); M [..., r, r], B [..., r, k]. Rows are
    swapped with one-hot selects, as in JAX."""
    r = M.shape[-1]
    MB = torch.cat([M, B], dim=-1)  # [..., r, r+k]
    rows = torch.arange(r, device=M.device)
    for col in range(r - 1):
        mags = torch.where(rows >= col, torch.abs(MB[..., :, col]), -1.0)
        p = torch.argmax(mags, dim=-1)
        is_p = (rows == p[..., None])[..., None]  # [..., r, 1]
        is_col = (rows == col)[..., None]
        row_p = torch.sum(torch.where(is_p, MB, 0.0), dim=-2)  # [..., r+k]
        row_col = MB[..., col, :]
        MB = torch.where(is_col, row_p[..., None, :],
                         torch.where(is_p, row_col[..., None, :], MB))
        pivot = MB[..., col:col + 1, col:col + 1]
        factors = MB[..., col + 1:, col:col + 1] / pivot
        MB = torch.cat([MB[..., :col + 1, :],
                        MB[..., col + 1:, :] + (-factors * MB[..., col:col + 1, :])], dim=-2)
    xrows = [None] * r
    for i in reversed(range(r)):
        s = MB[..., i, r:]
        for j in range(i + 1, r):
            s = s - MB[..., i, j:j + 1] * xrows[j]
        xrows[i] = s / MB[..., i, i:i + 1]
    return torch.stack(xrows, dim=-2)  # [..., r, k]


def _combine(ei, ej):
    """Associative composition of filtering elements: ``ei`` earlier,
    ``ej`` later, any matching leading dims. C and J are symmetric, so the
    three solves of the composition share one matrix M = I + J_j C_i and one
    unrolled factorization with a stacked [r, 2r+1] right-hand side."""
    Ai, bi, Ci, etai, Ji = ei
    Aj, bj, Cj, etaj, Jj = ej
    r = Ai.shape[-1]
    eye = torch.eye(r, dtype=Ai.dtype, device=Ai.device)
    M = eye + Jj @ Ci
    rhs = torch.cat([
        Aj.transpose(-1, -2),
        (etaj - torch.einsum("...ij,...j->...i", Jj, bi))[..., None],
        Jj @ Ai,
    ], dim=-1)
    sol = _solve_small(M, rhs)
    m1t = sol[..., :r].transpose(-1, -2)  # = Aj (I + Ci Jj)^{-1}
    m2 = sol[..., r]  # = M^{-1} (etaj - Jj bi)
    m3 = sol[..., r + 1:]  # = M^{-1} Jj Ai
    A_n = m1t @ Ai
    b_n = torch.einsum("...ij,...j->...i", m1t,
                       bi + torch.einsum("...ij,...j->...i", Ci, etaj)) + bj
    C_n = m1t @ Ci @ Aj.transpose(-1, -2) + Cj
    eta_n = torch.einsum("...ji,...j->...i", Ai, m2) + etai
    J_n = torch.einsum("...ji,...jk->...ik", Ai, m3) + Ji
    return (A_n, b_n, C_n, eta_n, J_n)


def _innovation_sum(y, mu, s):
    """-0.5 * sum((y - mu)^2 / s + log(2 pi s)) over the last axis."""
    return -0.5 * torch.sum((y - mu) ** 2 / s + torch.log(2 * math.pi * s), dim=-1)


def _innovation_loglik(A, Q, Pinf, H, diag, y, m_filt, P_filt):
    """Log-likelihood [...] from filtered means/covariances via one-step
    predictive innovations."""
    m_pred = torch.einsum("...nij,...nj->...ni", A[..., 1:, :, :], m_filt[..., :-1, :])
    P_pred = (A[..., 1:, :, :] @ P_filt[..., :-1, :, :] @ A[..., 1:, :, :].transpose(-1, -2)
              + Q[..., 1:, :, :])
    zero = y.new_zeros(y.shape[:-1] + (1,))
    mu = torch.cat([zero, m_pred @ H], dim=-1)
    s = torch.cat([
        (H @ Pinf @ H)[..., None] + diag[..., :1],
        torch.einsum("i,...nij,j->...n", H, P_pred, H) + diag[..., 1:],
    ], dim=-1)
    return _innovation_sum(y, mu, s)


def _identity_elements(shape_prefix, r, dtype, device):
    eye = torch.eye(r, dtype=dtype, device=device).expand(shape_prefix + (r, r))
    zv = torch.zeros(shape_prefix + (r,), dtype=dtype, device=device)
    zm = torch.zeros(shape_prefix + (r, r), dtype=dtype, device=device)
    return (eye, zv, zm, zv, zm)


def _pad_identity(elems, pad, r, dtype, device):
    """Append ``pad`` composition-identity slots to a 5-tuple of elements
    along their leading (time) axis."""
    if not pad:
        return elems
    ident = _identity_elements((pad,) + elems[1].shape[1:-1], r, dtype, device)
    return tuple(torch.cat([leaf, iv]) for leaf, iv in zip(elems, ident))


def _interleave(a, b):
    """a[0], b[0], a[1], b[1], ... along the leading axis (len(a) is len(b)
    or one more)."""
    k = b.shape[0]
    both = torch.stack([a[:k], b], dim=1).reshape((2 * k,) + a.shape[1:])
    return torch.cat([both, a[k:]])


def _associative_scan(fn, elems):
    """Inclusive scan of the tuple of leaves ``elems`` (time on the leading
    axis) under the associative ``fn``, by ``lax.associative_scan``'s
    recursive odd/even reduction: the same tree of compositions as JAX's."""
    n = elems[0].shape[0]
    if n < 2:
        return elems
    reduced = fn(tuple(e[0:-1:2] for e in elems), tuple(e[1::2] for e in elems))
    odd = _associative_scan(fn, reduced)
    right = tuple(e[2::2] for e in elems)
    left = tuple(e[:-1] for e in odd) if n % 2 == 0 else odd
    even = fn(left, right) if right[0].shape[0] else tuple(e[:0] for e in elems)
    even = tuple(torch.cat([e[:1], r]) for e, r in zip(elems, even))
    return tuple(_interleave(a, b) for a, b in zip(even, odd))


def _pkf_loglik(A, Pinf, H, diag, y):
    """Parallel-Kalman GP log-likelihood (O(log N) depth). A [..., N, R, R]
    transitions (A[0] unused), Pinf [..., R, R], H [R], diag, y [..., N]."""
    elems, A, Q = _filter_elements(A, Pinf, H, diag, y)
    # time leads for the scan: [N, ..., R, R] and [N, ..., R]
    lead = tuple(leaf.movedim(-2 if i % 2 else -3, 0) for i, leaf in enumerate(elems))
    scanned = _associative_scan(_combine, lead)
    b_c = scanned[1].movedim(0, -2)
    C_c = scanned[2].movedim(0, -3)
    return _innovation_loglik(A, Q, Pinf, H, diag, y, b_c, C_c)


def _prepared(term, t, diag, resid):
    """(coefficients, t, diag, y, batch) for a likelihood: the coefficients
    beside the placed times, diag and y on the times' device broadcast to the
    batch of the term, the diagonal and the residuals, one floating dtype."""
    coeffs, t = term.coefficients_beside(as_tensor(t))
    diag = _at(diag, t.device)
    y = _at(resid, t.device)
    dtype = torch.promote_types(torch.promote_types(t.dtype, diag.dtype), y.dtype)
    coeffs = tuple(c.to(dtype) for c in coeffs)
    t, diag, y = t.to(dtype), diag.to(dtype), y.to(dtype)
    n = t.shape[0]
    batch = torch.broadcast_shapes(*(c.shape[:-1] for c in coeffs), diag.shape[:-1],
                                   y.shape[:-1])
    return coeffs, t, diag.expand(batch + (n,)), y.expand(batch + (n,)), batch


def log_likelihood_pscan(term, t, diag, resid):
    """GP log-likelihood [...] via the O(log N)-depth parallel Kalman
    filter (one associative scan of the filtering elements, eager torch).
    Matches ``solver.log_likelihood`` (and the dense Cholesky) for all
    SHO-family terms."""
    coeffs, t, diag, y, batch = _prepared(term, t, diag, resid)
    dt = torch.cat([t.new_zeros(1), torch.diff(t)])
    with full_float32():
        A, Pinf, H = _ssm_from_dt(coeffs, dt)
        A = A.expand(batch + A.shape[-3:])
        Pinf = Pinf.expand(batch + Pinf.shape[-2:])
        return _pkf_loglik(A, Pinf, H, diag, y)


def _k1_inputs(coeffs, dt, diag, y, batch, first):
    """K1's operands for a stretch of the series: the SSM matrices of dt and
    the process noise (the stationary prior at the series' first step when
    ``first``), rows flattened: (A, Q [B, n, R, R], H [R], diag, y [B, n])."""
    n = dt.shape[0]
    A, Pinf, H = _ssm_from_dt(coeffs, dt)
    A, Q = _process_noise(A, Pinf) if first else (A, _noise(A, Pinf))
    r = H.shape[0]
    rows = math.prod(batch)
    return (A.expand(batch + (n, r, r)).reshape(rows, n, r, r),
            Q.expand(batch + (n, r, r)).reshape(rows, n, r, r), H,
            diag.reshape(rows, n), y.reshape(rows, n))


def _k1(coeffs, dt, diag, y, batch, n_blocks, first, carry):
    """One K1 call over a stretch of the series (see :func:`_k1_inputs`).
    Returns (ll [batch], the outgoing carry)."""
    A, Q, H, d, yb = _k1_inputs(coeffs, dt, diag, y, batch, first)
    mu, s, carry = kalman_blocked(A, Q, H, d, yb, n_blocks, carry)
    return _innovation_sum(yb, mu, s).reshape(batch), carry


def _positive(name, value):
    value = int(value)
    if value < 1:
        raise ValueError(f"{name} must be a positive integer, got {value}")
    return value


def log_likelihood_blocked(term, t, diag, resid, n_blocks=64):
    """GP log-likelihood [...] via the blocked two-level Kalman composition
    (K1: depth N/n_blocks within blocks, log2(n_blocks) across them). Matches
    ``solver.log_likelihood`` for SHO-family terms; its gradient is the
    composition's own, through K2 (see the module)."""
    n_blocks = _positive("n_blocks", n_blocks)
    coeffs, tt, dd, y, batch = _prepared(term, t, diag, resid)
    with full_float32():
        dt = torch.cat([tt.new_zeros(1), torch.diff(tt)])
        ll, _ = _k1(coeffs, dt, dd, y, batch, n_blocks, True, None)
    return ll


def log_likelihood_chunked(term, t, diag, resid, chunk=65536, inner_blocks=512):
    """GP log-likelihood [...] over chunks of the series, each one K1 call
    with ``inner_blocks`` blocks, the composed filtering element (five
    tensors of at most [R, R] a row) carried from one chunk to the next. The
    chunk geometry is JAX's: ``inner = min(inner_blocks, chunk, N)``, then
    ``chunk = max((min(chunk, N) // inner) * inner, inner)``. Matches
    ``solver.log_likelihood`` for SHO-family terms; its gradient is the
    composition's own, through K2 a chunk (see the module)."""
    chunk = _positive("chunk", chunk)
    inner_blocks = _positive("inner_blocks", inner_blocks)
    coeffs, tt, dd, y, batch = _prepared(term, t, diag, resid)
    n = tt.shape[0]
    inner = min(inner_blocks, chunk, n)
    chunk = max((min(chunk, n) // inner) * inner, inner)
    with full_float32():
        dt = torch.cat([tt.new_zeros(1), torch.diff(tt)])
        ll = None
        carry = None
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            part, carry = _k1(coeffs, dt[lo:hi], dd[..., lo:hi], y[..., lo:hi], batch, inner,
                              lo == 0, carry)
            ll = part if ll is None else ll + part
    return ll


def _shard_blocks(nl):
    """K1's block count for a rank's stretch of ``nl`` samples: about
    sqrt(2 nl). A K1 call is L + ceil(log2(m + 1)) + 1 compositions deep
    (L = ceil(nl / nb) positions a block, m blocks), so more blocks shorten
    its chain, while the scan over the block summaries costs about
    m log2(m) compositions and a launch a level; at sqrt(2 nl) blocks that
    scan stays well below the stretch's own nl compositions. (The count
    dates from K1's first design, whose carry stage was an nb-deep chain;
    no card measurement has asked for another since.)"""
    return max(1, min(nl, math.isqrt(2 * nl)))


def _shard_pass(coeffs, dt, diag, y, batch, d, idx, carry):
    """K1 over rank ``idx``'s contiguous stretch of ``d`` (its first ``dt``
    the step from the sample before it; only rank 0 with no carry starts
    from the stationary prior), from ``carry`` or, when it is None, the
    identity. Returns (the stretch's share of the log-likelihood [batch];
    the packed summary [rows, S] of K1's outgoing carry)."""
    nl = dt.shape[0] // d
    lo, hi = idx * nl, (idx + 1) * nl
    ll, out = _k1(coeffs, dt[lo:hi], diag[..., lo:hi], y[..., lo:hi], batch,
                  _shard_blocks(nl), idx == 0 and carry is None, carry)
    return ll, pack_carry(out)


def _states(coeffs):
    """R, the state size of a term's coefficients: its real slots and two
    for each complex pair."""
    return coeffs[0].shape[-1] + 2 * coeffs[2].shape[-1]


def _shard_carry(summaries, idx, r):
    """Rank ``idx``'s exclusive carry: the packed summaries [D, rows, S] of
    ranks 0 .. idx-1 composed in order."""
    run = unpack_carry(summaries[0], r)
    for k in range(1, idx):
        run = _combine(run, unpack_carry(summaries[k], r))
    return run


class _RankSum(torch.autograd.Function):
    """The sum over the group's ranks of each rank's share; the gradient,
    the same on every rank, passes to each share unchanged."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Shared(torch.autograd.Function):
    """The inputs every rank holds whole, unchanged; the backward sums
    their gradients over the group's ranks (each rank's is what its own
    stretch gives) in one all_reduce."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        ctx.like = [torch.empty((), dtype=x.dtype, device=x.device).expand(x.shape) for x in xs]
        return tuple(x.clone() for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        need = [i for i, w in enumerate(ctx.needs_input_grad[1:]) if w]
        grads = [torch.zeros_like(x) if g is None else g for g, x in zip(grads, ctx.like)]
        flat = torch.cat([grads[i].reshape(-1) for i in need])
        dist.all_reduce(flat, group=ctx.group)
        out = [None] * len(grads)
        for i, part in zip(need, torch.split(flat, [grads[i].numel() for i in need])):
            out[i] = part.reshape(grads[i].shape)
        return (None, *out)


class _ShardedK1(torch.autograd.Function):
    """Rank ``idx``'s K1 passes over its stretch's (A, Q, diag, y) (see
    :func:`log_likelihood_sharded`): the first from the identity (rank 0
    from the stationary prior), the ``all_gather`` of the summaries, and
    past rank 0 the second from the composed carry. Returns the stretch's
    (mu, s). The backward reverses them: past rank 0 K2 of the second pass,
    its carry's cotangent back through :func:`_shard_carry` to the D
    summaries; those summed over ranks (the ``all_gather``'s transpose);
    K2 of the first pass from this rank's own summary's cotangent (and, on
    rank 0, the innovations'). Every rank runs one collective each way."""

    @staticmethod
    def forward(ctx, H, nb, d, idx, group, A, Q, diag, y):
        r = H.shape[0]
        mu, s, out, pre1 = kalman_blocked(A, Q, H, diag, y, nb, None, prefixes=True)
        summary = pack_carry(out).contiguous()
        parts = [torch.empty_like(summary) for _ in range(d)]
        dist.all_gather(parts, summary, group=group)
        parts = torch.stack(parts)
        saved = [A, Q, H, diag, y, pre1, parts]
        if idx:
            mu, s, _, pre2 = kalman_blocked(A, Q, H, diag, y, nb, _shard_carry(parts, idx, r),
                                            prefixes=True)
            saved.append(pre2)
        ctx.save_for_backward(*saved)
        ctx.nb, ctx.idx, ctx.group = nb, idx, group
        return mu, s

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dmu, ds):
        A, Q, H, diag, y, pre1, parts, *pre2 = ctx.saved_tensors
        nb, idx, r = ctx.nb, ctx.idx, H.shape[0]
        zero = torch.zeros_like(diag)
        dmu = zero if dmu is None else dmu
        ds = zero if ds is None else ds
        dparts = torch.zeros_like(parts)
        if idx:
            carry = _shard_carry(parts, idx, r)
            second = kalman_blocked_adjoint(A, Q, H, diag, y, nb, carry, pre2[0], dmu, ds)
            with torch.enable_grad():
                pp = parts.detach().requires_grad_(True)
                (dparts,) = torch.autograd.grad(_shard_carry(pp, idx, r), pp, second[4])
        dist.all_reduce(dparts, group=ctx.group)
        first = kalman_blocked_adjoint(A, Q, H, diag, y, nb, None, pre1,
                                       zero if idx else dmu, zero if idx else ds,
                                       unpack_carry(dparts[idx], r))
        grads = first[:4] if not idx else tuple(a + b for a, b in zip(first[:4], second[:4]))
        return (None, None, None, None, None, *grads)


def log_likelihood_sharded(term, t, diag, resid, mesh, axis="seq"):
    """GP log-likelihood [...] with the TIME axis sharded over a mesh axis.

    The multi-rank extension of :func:`log_likelihood_blocked`: each of the
    D ranks composes its contiguous N/D stretch with K1, one ``all_gather``
    shares the D block summaries (O(D R^2) values a row, independent of
    N), each rank composes those of the ranks before it into its exclusive
    carry (:func:`_shard_carry`) and runs K1 again from it (rank 0 needs no
    second call; :class:`_ShardedK1`; :func:`_shard_pass` is one such pass
    on its own), and one ``all_reduce`` adds the innovation sums. Every
    rank holds the whole series and returns the same value. N must divide
    by D.

    Matches ``solver.log_likelihood`` for SHO-family terms. Its gradient is
    that of the two-level composition: each rank reverses only its own
    stretch's passes with K2 (:class:`_ShardedK1`), the summaries'
    cotangents are summed over ranks, and so are the gradients of what
    every rank holds whole (the term's coefficients, the times, diag and
    resid, each rank's share its own stretch's), so that every rank returns
    the gradient of the total. No rank runs the sequential solver.
    """
    d, idx, group = axis_info(mesh, axis)
    coeffs, tt, dd, y, batch = _prepared(term, t, diag, resid)
    n = tt.shape[0]
    if n % d:
        raise ValueError(f"n={n} must be divisible by mesh axis size {d}")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (*coeffs, tt, dd, y)):
        *coeffs, tt, dd, y = _Shared.apply(group, *coeffs, tt, dd, y)
    with full_float32():
        dt = torch.cat([tt.new_zeros(1), torch.diff(tt)])
        nl = n // d
        lo, hi = idx * nl, (idx + 1) * nl
        A, Q, H, dl, yl = _k1_inputs(tuple(coeffs), dt[lo:hi], dd[..., lo:hi], y[..., lo:hi],
                                     batch, idx == 0)
        mu, s = _ShardedK1.apply(H, _shard_blocks(nl), d, idx, group, A, Q, dl, yl)
        ll = _innovation_sum(yl, mu, s).reshape(batch)
    return _RankSum.apply(ll, group)
