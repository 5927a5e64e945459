"""K1: the blocked Kalman composition of the celerite GP likelihood.

The JAX package evaluates the blocked and the chunked likelihoods
(``periodicity_tpu/models/gp/pscan.py``: ``_pkf_loglik_blocked`` at
``:332-346``, one chunk of ``_pkf_loglik_chunked`` at ``:349-407``) with
``_blocked_inclusive_prefixes`` (``:279-329``): a ``lax.scan`` of
``_combine`` over ``ceil(N / n_blocks)`` dependent steps, vectorized over
the blocks, then an associative scan of the block summaries and a stitch of
every position. XLA fuses each step into one dispatch; eager PyTorch would
pay ~150 launches for every step (the unrolled pivoted solve of a
composition alone is most of them). So on a CUDA tensor the whole
composition is one call of a hand-written kernel (``csrc/kalman.cuh``, R
= 1 to ``MAX_R`` states), and
on a CPU tensor its plain version here. Both round every product, sum,
difference and quotient on its own, in the same order, so they agree bit
for bit.

A filtering element (Särkkä & García-Fernández 2021) is the 5-tuple
``(A, b, C, eta, J)``; position k's comes from the step's transition
``A_k``, process noise ``Q_k``, the observation row ``H``, the noise
variance ``diag_k`` and the residual ``y_k``, as JAX's ``_elements_from_AQ``
builds it. The composition ``combine(ei, ej)`` (``ei`` earlier) solves one
``R x R`` system ``M = I + J_j C_i`` by elimination with partial pivoting
(the first maximal |value|) against ``[A_j^T | eta_j - J_j b_i | J_j A_i]``.
Per row (walker), with ``L = ceil(N / n_blocks)`` positions a block and the
``m = ceil(N / L)`` blocks that hold a position (:func:`block_geometry`),
JAX's two-level structure in four stages:

0. every position's element, all positions at once;
1. each block walks its elements from the identity and overwrites each with
   its inclusive prefix; the last is the block's summary S_k;
2. an inclusive scan over ``[carry, S_0, .., S_{m-1}]`` (the incoming carry
   only when given) in ceil(log2) levels (:func:`tree_levels`), at level d
   ``x[i] = x[i - 2^d] o x[i]``, the earlier always on the left: each
   block's exclusive carry and the row's outgoing carry;
3. at every position p at once, the filtered ``(b, C)`` at p - 1 as
   ``exclusive carry o prefix`` (the prefix alone in block 0 without a
   carry; the carry's, or zeros, at p = 0), from the solve's m1t columns
   alone, then the predicted mean and variance (JAX's
   ``_innovation_loglik`` and the chunked body, ``:227-240``,
   ``:389-395``)::

       mu_p = H . (A_p b),   s_p = H (A_p C A_p^T + Q_p) H + diag_p

The log-likelihood's sums stay eager torch, outside. The call is
``L + ceil(log2(m + 1)) + 1`` compositions deep; its stage 1 sets the
kernel's time. Every sum below runs over its index in ascending order, one
add at a time; the plain version steps through host numpy (which rounds
every operation on its own) vectorized over rows, blocks and positions.

``kalman_blocked.launches`` counts the calls that launched the kernel (each
runs its stages as ``3 + max(1, levels)`` launches: elements, prefixes, a
launch a level of the scan, stitch and innovations).

K2, :func:`kalman_blocked_adjoint` (``csrc/kalman_adjoint.cuh``), is K1's
adjoint: from the cotangents of mu, s and the outgoing carry, those of A,
Q, diag, y and the incoming carry, K1's stages reversed (JAX's
``jax.grad`` through ``_blocked_inclusive_prefixes``). It reads the
stage-1 prefixes K1 returns with ``prefixes=True`` and forms the scan's
levels, the filtered states and the elements again exactly as K1 does, so
the pivots are K1's. :class:`KalmanBlocked` pairs them for autograd, and
:func:`kalman_blocked` goes through it when an input needs a gradient.
``kalman_blocked_adjoint.launches`` counts K2's calls (2 levels + 5
launches each).
"""

import ctypes

import numpy as np
import torch

from ._kernels import MAX_R, _back, _check, _entry, _host, _launch, _on_cpu, load

__all__ = ["kalman_blocked", "kalman_blocked_plain", "kalman_blocked_adjoint",
           "kalman_blocked_adjoint_plain", "KalmanBlocked", "pack_carry", "unpack_carry",
           "state_size", "block_geometry", "tree_levels", "kernel_geometry",
           "kernel_attributes"]


def state_size(r):
    """Values in one packed 5-tuple: A, b, C, eta, J (3 R^2 + 2 R)."""
    return 3 * r * r + 2 * r


def pack_carry(carry):
    """A 5-tuple (A [..., R, R], b [..., R], C, eta, J) as one [..., S]
    tensor in the order A, b, C, eta, J, each row-major."""
    A = carry[0]
    lead = A.shape[:-2]
    return torch.cat([x.reshape(lead + (-1,)) for x in carry], dim=-1)


def unpack_carry(packed, r):
    """The inverse of :func:`pack_carry`."""
    lead = packed.shape[:-1]
    sizes = [r * r, r, r * r, r, r * r]
    parts = torch.split(packed, sizes, dim=-1)
    shapes = [(r, r), (r,), (r, r), (r,), (r, r)]
    return tuple(p.reshape(lead + s) for p, s in zip(parts, shapes))


# -- the plain version: numpy arrays with one leading axis of independent
# rows; X [M, R, R], v [M, R]; every sum over k ascending ------------------

def _mm(X, Y):
    """X @ Y."""
    acc = X[:, :, 0, None] * Y[:, None, 0, :]
    for k in range(1, X.shape[-1]):
        acc = acc + X[:, :, k, None] * Y[:, None, k, :]
    return acc


def _mmt(X, Y):
    """X @ Y^T."""
    acc = X[:, :, None, 0] * Y[:, None, :, 0]
    for k in range(1, X.shape[-1]):
        acc = acc + X[:, :, None, k] * Y[:, None, :, k]
    return acc


def _mtm(X, Y):
    """X^T @ Y."""
    acc = X[:, 0, :, None] * Y[:, None, 0, :]
    for k in range(1, X.shape[-1]):
        acc = acc + X[:, k, :, None] * Y[:, None, k, :]
    return acc


def _mv(X, v):
    """X @ v."""
    acc = X[:, :, 0] * v[:, None, 0]
    for k in range(1, X.shape[-1]):
        acc = acc + X[:, :, k] * v[:, None, k]
    return acc


def _mtv(X, v):
    """X^T @ v."""
    acc = X[:, 0, :] * v[:, 0, None]
    for k in range(1, X.shape[-1]):
        acc = acc + X[:, k, :] * v[:, k, None]
    return acc


def _hv(H, v):
    """H . v for a constant row H [R] and v [M, R]."""
    acc = H[0] * v[:, 0]
    for k in range(1, v.shape[-1]):
        acc = acc + H[k] * v[:, k]
    return acc


def _elements(A, Q, H, d, y):
    """Filtering elements of M positions: A, Q [M, R, R], d, y [M]."""
    r = H.shape[0]
    eye = np.eye(r, dtype=A.dtype)
    qh = _mv(Q, np.broadcast_to(H, (A.shape[0], r)))
    hqh = _hv(H, qh) + d
    K = qh / hqh[:, None]
    ImKH = eye[None] - K[:, :, None] * H[None, None, :]
    HA = _mtv(A, np.broadcast_to(H, (A.shape[0], r)))
    ry = y / hqh
    return (_mm(ImKH, A), K * y[:, None], _mm(ImKH, Q), HA * ry[:, None],
            (HA[:, :, None] * HA[:, None, :]) / hqh[:, None, None])


def _identity(m, r, dtype):
    eye = np.broadcast_to(np.eye(r, dtype=dtype), (m, r, r)).copy()
    zv = np.zeros((m, r), dtype)
    zm = np.zeros((m, r, r), dtype)
    return (eye, zv, zm.copy(), zv.copy(), zm.copy())


def _solve(MB, r, factors=False):
    """Solve M X = B for MB = [M | B] [m, R, W]: elimination with partial
    pivoting (the first maximal |value| of the column at or below the
    diagonal), then back substitution. Columns left of the pivot are not
    updated: nothing reads them again. With ``factors`` also (the
    eliminated MB, whose upper triangle is U; F [m, R, R] with F[:, i, col]
    the multiplier of row i at step col; the pivot row of each step [m, R -
    1]), which the adjoint reads."""
    m = MB.shape[0]
    rows = np.arange(m)
    MB = MB.copy()
    F = np.zeros((m, r, r), MB.dtype) if factors else None
    pivots = np.zeros((m, max(r - 1, 0)), np.int64)
    for col in range(r - 1):
        p = np.full(m, col)
        best = np.abs(MB[:, col, col])
        for i in range(col + 1, r):
            mag = np.abs(MB[:, i, col])
            take = mag > best
            best = np.where(take, mag, best)
            p = np.where(take, i, p)
        pivots[:, col] = p
        row_col = MB[:, col, col:].copy()
        MB[:, col, col:] = MB[rows, p, col:]
        MB[rows, p, col:] = row_col
        piv = MB[:, col, col]
        for i in range(col + 1, r):
            f = MB[:, i, col] / piv
            if factors:
                F[:, i, col] = f
            MB[:, i, col + 1:] = MB[:, i, col + 1:] - f[:, None] * MB[:, col, col + 1:]
    k = MB.shape[2] - r
    X = np.empty((m, r, k), MB.dtype)
    for i in range(r - 1, -1, -1):
        s = MB[:, i, r:].copy()
        for j in range(i + 1, r):
            s = s - MB[:, i, j, None] * X[:, j]
        X[:, i] = s / MB[:, i, i, None]
    return (X, MB, F, pivots) if factors else X


def _solve_transposed(Z, U, F, pivots, r):
    """The adjoint of :func:`_solve` in its right-hand side: M^-T dX for dX
    = ``Z`` [m, R, W], through the factors it returned (pivots fixed): U^T
    forward substitution, then each step's multipliers transposed and its
    row swap undone, last step first."""
    rows = np.arange(Z.shape[0])
    Z = Z.copy()
    for i in range(r):
        s = Z[:, i].copy()
        for j in range(i):
            s = s - U[:, j, i, None] * Z[:, j]
        Z[:, i] = s / U[:, i, i, None]
    for col in range(r - 2, -1, -1):
        s = Z[:, col].copy()
        for i in range(col + 1, r):
            s = s - F[:, i, col, None] * Z[:, i]
        p = pivots[:, col]
        Z[:, col] = Z[rows, p]
        Z[rows, p] = s
    return Z


def _combine(ei, ej, full=True):
    """The composition of elements ``ei`` (earlier) and ``ej`` (later). With
    ``full`` False only its (b, C), from the solve's m1t columns alone (the
    elimination updates each right-hand column on its own, so the columns
    kept have the bits they have in the full solve)."""
    Ai, bi, Ci, etai, Ji = ei
    Aj, bj, Cj, etaj, Jj = ej
    r = Ai.shape[-1]
    eye = np.eye(r, dtype=Ai.dtype)
    M = eye[None] + _mm(Jj, Ci)
    cols = [M, np.swapaxes(Aj, 1, 2)]
    if full:
        cols += [(etaj - _mv(Jj, bi))[:, :, None], _mm(Jj, Ai)]
    X = _solve(np.concatenate(cols, axis=2), r)
    m1t = np.swapaxes(X[:, :, :r], 1, 2)
    b_n = _mv(m1t, bi + _mv(Ci, etaj)) + bj
    C_n = _mmt(_mm(m1t, Ci), Aj) + Cj
    if not full:
        return b_n, C_n
    m2 = X[:, :, r]
    m3 = X[:, :, r + 1:]
    A_n = _mm(m1t, Ai)
    eta_n = _mtv(Ai, m2) + etai
    J_n = _mtm(Ai, m3) + Ji
    return (A_n, b_n, C_n, eta_n, J_n)


def _combine_vjp(ei, ej, dout, full=True):
    """The adjoint of :func:`_combine`: the cotangents (dei, dej) of its
    operands from ``dout``, the result's (a 5-tuple; without ``full`` the
    (b, C) of the partial composition, and dei's A, eta and J are zeros).
    The forward's M, pivots and multipliers are formed again as
    :func:`_combine` forms them; the pivots are constants."""
    Ai, bi, Ci, etai, Ji = ei
    Aj, bj, Cj, etaj, Jj = ej
    r = Ai.shape[-1]
    eye = np.eye(r, dtype=Ai.dtype)
    M = eye[None] + _mm(Jj, Ci)
    cols = [M, np.swapaxes(Aj, 1, 2)]
    if full:
        cols += [(etaj - _mv(Jj, bi))[:, :, None], _mm(Jj, Ai)]
    X, U, F, pivots = _solve(np.concatenate(cols, axis=2), r, factors=True)
    m1t = np.swapaxes(X[:, :, :r], 1, 2)
    t1 = bi + _mv(Ci, etaj)
    T2 = _mm(m1t, Ci)
    if full:
        dAn, dbn, dCn, detan, dJn = dout
    else:
        dbn, dCn = dout
    # A_n = m1t Ai, b_n = m1t t1 + bj, C_n = (m1t Ci) Aj^T + Cj
    dT2 = _mm(dCn, Aj)
    dm1t = dbn[:, :, None] * t1[:, None, :]
    if full:
        dm1t = _mmt(dAn, Ai) + dm1t
    dm1t = dm1t + _mmt(dT2, Ci)
    dt1 = _mtv(m1t, dbn)
    dX = [np.swapaxes(dm1t, 1, 2)]
    if full:
        # eta_n = Ai^T m2 + etai, J_n = Ai^T m3 + Ji
        dX += [_mv(Ai, detan)[:, :, None], _mm(Ai, dJn)]
    Z = _solve_transposed(np.concatenate(dX, axis=2), U, F, pivots, r)
    dM = -_mmt(Z, X)
    dCi = dt1[:, :, None] * etaj[:, None, :]
    dCi = dCi + _mtm(m1t, dT2)
    dCi = dCi + _mtm(Jj, dM)
    dAj = _mtm(dCn, T2) + np.swapaxes(Z[:, :, :r], 1, 2)
    detaj = _mtv(Ci, dt1)
    dJj = _mmt(dM, Ci)
    if not full:
        zv = np.zeros_like(bi)
        zm = np.zeros_like(Ai)
        return (zm, dt1, dCi, zv, zm.copy()), (dAj, dbn, dCn, detaj, dJj)
    m2, m3 = X[:, :, r], X[:, :, r + 1:]
    dv, dG = Z[:, :, r], Z[:, :, r + 1:]
    dAi = _mtm(m1t, dAn)
    dAi = dAi + m2[:, :, None] * detan[:, None, :]
    dAi = dAi + _mmt(m3, dJn)
    dAi = dAi + _mtm(Jj, dG)
    dbi = dt1 - _mtv(Jj, dv)
    detaj = detaj + dv
    dJj = dJj - dv[:, :, None] * bi[:, None, :]
    dJj = dJj + _mmt(dG, Ai)
    return (dAi, dbi, dCi, detan, dJn), (dAj, dbn, dCn, detaj, dJj)


def _dot(u, v):
    """The sum over the last axis of u * v [M, K], ascending."""
    acc = u[:, 0] * v[:, 0]
    for k in range(1, u.shape[-1]):
        acc = acc + u[:, k] * v[:, k]
    return acc


def _elements_vjp(A, Q, H, d, y, de):
    """The adjoint of :func:`_elements`: (dA, dQ, dd, dy) from the
    elements' cotangents ``de``; the element is formed again as there."""
    r = H.shape[0]
    m = A.shape[0]
    Hm = np.broadcast_to(H, (m, r))
    eye = np.eye(r, dtype=A.dtype)
    qh = _mv(Q, Hm)
    hqh = _hv(H, qh) + d
    K = qh / hqh[:, None]
    ImKH = eye[None] - K[:, :, None] * H[None, None, :]
    HA = _mtv(A, Hm)
    ry = y / hqh
    J = (HA[:, :, None] * HA[:, None, :]) / hqh[:, None, None]
    dAe, dbe, dCe, detae, dJe = de
    dA = _mtm(ImKH, dAe)
    dQ = _mtm(ImKH, dCe)
    dImKH = _mmt(dAe, A) + _mmt(dCe, Q)
    dK = dbe * y[:, None]
    dK = dK - _mv(dImKH, Hm)
    dy = _dot(dbe, K)
    dry = _dot(detae, HA)
    dy = dy + dry / hqh
    W = dJe / hqh[:, None, None]
    dHA = detae * ry[:, None]
    dHA = dHA + _mv(W, HA)
    dHA = dHA + _mtv(W, HA)
    acc = _dot(dJe.reshape(m, r * r), J.reshape(m, r * r))
    acc = acc + dry * ry
    acc = acc + _dot(dK, K)
    dhqh = -(acc / hqh)
    dqh = dK / hqh[:, None]
    dqh = dqh + H[None, :] * dhqh[:, None]
    dQ = dQ + dqh[:, :, None] * H[None, None, :]
    dA = dA + H[None, :, None] * dHA[:, None, :]
    return dA, dQ, dhqh, dy


def _innovation_vjp(A, Q, H, b, C, dmu, ds):
    """The adjoint of :func:`_innovation`: (dA, dQ, dd, db, dC) from the
    cotangents of mu and s."""
    dmi = H[None, :] * dmu[:, None]
    dA = dmi[:, :, None] * b[:, None, :]
    db = _mtv(A, dmi)
    dph = H[None, :] * ds[:, None]
    dP = dph[:, :, None] * H[None, None, :]
    T = _mm(A, C)
    dT = _mm(dP, A)
    dA = dA + _mtm(dP, T)
    dA = dA + _mmt(dT, C)
    dC = _mtm(A, dT)
    return dA, dP, ds.copy(), db, dC


def _innovation(A, Q, H, d, b, C):
    """Predicted mean and variance at positions with transitions A, noise
    Q [M, R, R], variances d [M], from the filtered (b, C) before them."""
    mu = _hv(H, _mv(A, b))
    P = _mmt(_mm(A, C), A) + Q
    s = _hv(H, _mv(P, np.broadcast_to(H, (A.shape[0], H.shape[0])))) + d
    return mu, s


def _select(valid, new, old):
    out = []
    for a, b in zip(new, old):
        mask = valid.reshape(valid.shape + (1,) * (a.ndim - 1))
        out.append(np.where(mask, a, b))
    return tuple(out)


def block_geometry(n, n_blocks):
    """(L, m): positions a block, ceil(N / n_blocks), and the blocks that
    hold a position, ceil(N / L); blocks past the series' end are empty and
    take no part."""
    length = -(-n // n_blocks)
    return length, -(-n // length)


def tree_levels(leaves):
    """Levels of the scan over ``leaves`` block summaries: ceil(log2)."""
    return (leaves - 1).bit_length()


# positions a slice of the plain version's stages 0 and 3 (host memory)
_SLICE = 1 << 15


def kalman_blocked_plain(A, Q, H, diag, y, n_blocks, carry=None, prefixes=False):
    """K1's plain version: A, Q [B, N, R, R] (step 0 of a series already
    A = 0, Q = Pinf), H [R], diag, y [B, N], one dtype; ``carry`` an
    incoming 5-tuple of [B, ...] or None (the identity). Returns (mu [B, N],
    s [B, N], the outgoing carry: a 5-tuple of [B, ...]) on the inputs'
    device, and with ``prefixes`` stage 1's inclusive prefixes, packed [B,
    N, S] (what the kernel leaves in its scratch, and the adjoint reads);
    the stages step through numpy arrays on the host, vectorized over rows,
    blocks and positions."""
    device = A.device
    A, Q, H, diag, y = _host(A, Q, H, diag, y)
    b, n, r, _ = A.shape
    length, m = block_geometry(n, int(n_blocks))
    dtype = A.dtype
    A, Q = A.reshape(b * n, r, r), Q.reshape(b * n, r, r)
    diag, y = diag.reshape(b * n), y.reshape(b * n)
    cuts = range(0, b * n, _SLICE)
    with np.errstate(all="ignore"):
        # stage 0: every position's element, [B N, ...]
        parts = [_elements(A[c:c + _SLICE], Q[c:c + _SLICE], H, diag[c:c + _SLICE],
                           y[c:c + _SLICE]) for c in cuts]
        pre = [np.concatenate([p[i] for p in parts]) for i in range(5)]
        del parts
        # stage 1: each (row, block) walks its positions from the identity
        # and overwrites each element with its inclusive prefix
        first = (np.arange(b)[:, None] * n + np.arange(m)[None, :] * length).reshape(-1)
        last = (np.arange(b)[:, None] * n + np.minimum(np.arange(1, m + 1) * length, n)[None, :]
                - 1).reshape(-1)
        state = _identity(b * m, r, dtype)
        for l in range(length):
            at = first + l
            valid = at <= last
            at = np.minimum(at, last)
            new = _combine(state, tuple(x[at] for x in pre))
            state = _select(valid, new, state)
            for x, v in zip(pre, new):
                x[at[valid]] = v[valid]
        saved = np.concatenate([x.reshape(b * n, -1) for x in pre], axis=1) if prefixes else None
        # stage 2: an inclusive scan over [carry, S_0, .., S_{m-1}] (the
        # carry only when given) in ceil(log2) levels: at level d,
        # x[i] = x[i - 2^d] o x[i] for i >= 2^d
        tree = [x[last].reshape((b, m) + x.shape[1:]) for x in pre]
        if carry is not None:
            tree = [np.concatenate([c[:, None], x], axis=1) for c, x in zip(_host(*carry), tree)]
        k = tree[0].shape[1]
        for level in range(tree_levels(k)):
            h = 1 << level
            new = _combine(*(tuple(x[:, lo:hi].reshape((-1,) + x.shape[2:]) for x in tree)
                             for lo, hi in ((0, k - h), (h, k))))
            tree = [np.concatenate([x[:, :h], v.reshape((b, k - h) + x.shape[2:])], axis=1)
                    for x, v in zip(tree, new)]
        run = tuple(x[:, -1] for x in tree)
        # stage 3: the filtered (b, C) at p - 1 = exclusive carry of its
        # block o its prefix (the prefix alone in block 0 without a carry),
        # at p = 0 the carry's or zeros; then mu_p, s_p
        fb = np.zeros((b * n, r), dtype)
        fC = np.zeros((b * n, r, r), dtype)
        if carry is not None:
            fb[::n], fC[::n] = tree[1][:, 0], tree[2][:, 0]
        p = np.arange(b * n)
        q = p - 1
        excl = (q % n) // length - (carry is None)
        stitch = (p % n > 0) & (excl >= 0)
        alone = (p % n > 0) & (excl < 0)
        fb[alone], fC[alone] = pre[1][q[alone]], pre[2][q[alone]]
        rows = p // n
        for c in cuts:
            at = p[c:c + _SLICE][stitch[c:c + _SLICE]]
            if at.size:
                ei = tuple(x[rows[at], excl[at]] for x in tree)
                fb[at], fC[at] = _combine(ei, tuple(x[q[at]] for x in pre), full=False)
        del pre
        mu = np.empty(b * n, dtype)
        s = np.empty(b * n, dtype)
        for c in cuts:
            sl = slice(c, c + _SLICE)
            mu[sl], s[sl] = _innovation(A[sl], Q[sl], H, diag[sl], fb[sl], fC[sl])
    out = _back(device, mu.reshape(b, n), s.reshape(b, n), *run)
    if prefixes:
        return out[0], out[1], tuple(out[2:]), _back(device, saved.reshape(b, n, -1))[0]
    return out[0], out[1], tuple(out[2:])


def _unpack(packed, r):
    """A packed [M, S] numpy array as a 5-tuple (A, b, C, eta, J)."""
    cuts = np.cumsum([r * r, r, r * r, r])
    parts = np.split(packed, cuts, axis=1)
    shapes = [(r, r), (r,), (r, r), (r,), (r, r)]
    return tuple(p.reshape((packed.shape[0],) + sh) for p, sh in zip(parts, shapes))


def _leaf_spans(k, length, n, carried):
    """For each of the scan's k leaves, the positions p [start, end) whose
    filtered state at p - 1 composes that leaf as the exclusive carry (with
    an incoming carry, leaf 0 also the position 0, which starts from it)."""
    j = np.arange(k)
    if carried:
        start = np.where(j == 0, 0, j * length + 1)
        end = np.minimum((j + 1) * length + 1, n)
    else:
        start = (j + 1) * length + 1
        end = np.minimum((j + 2) * length + 1, n)
    return start, end


def kalman_blocked_adjoint_plain(A, Q, H, diag, y, n_blocks, carry, prefixes, dmu, ds,
                                 dcarry=None):
    """K2's plain version, the adjoint of :func:`kalman_blocked_plain`: the
    operands of K1's call (``carry`` None or a 5-tuple), its stage-1
    ``prefixes`` [B, N, S], the cotangents ``dmu``, ``ds`` [B, N] and
    ``dcarry`` (the outgoing carry's 5-tuple, or None for zeros). Returns
    (dA, dQ [B, N, R, R], ddiag, dy [B, N], dcarry_in: a 5-tuple, or None
    without a carry) on the inputs' device.

    K1's stages in reverse: the scan's levels formed again from the
    prefixes; at every position the innovations' and the stitch's adjoint
    (the latter's partial composition), giving each prefix's cotangent and
    each exclusive carry's share, summed a leaf in ascending position; the
    scan's levels last to first, a leaf's cotangent its own share then the
    one it gets as the earlier operand; each block walked backwards from its
    summary's cotangent, the prefix before a step and the step's element
    (formed again) composed; every element's adjoint. Every sum in a fixed
    order, one rounding an operation."""
    device = A.device
    A, Q, H, diag, y, prefixes, dmu, ds = _host(A, Q, H, diag, y, prefixes, dmu, ds)
    b, n, r, _ = A.shape
    length, m = block_geometry(n, int(n_blocks))
    dtype = A.dtype
    A, Q = A.reshape(b * n, r, r), Q.reshape(b * n, r, r)
    diag, y = diag.reshape(b * n), y.reshape(b * n)
    dmu, ds = dmu.reshape(b * n), ds.reshape(b * n)
    pre = _unpack(prefixes.reshape(b * n, -1), r)
    cuts = range(0, b * n, _SLICE)
    carried = carry is not None
    with np.errstate(all="ignore"):
        # the scan's levels again, as stage 2 forms them
        first = (np.arange(b)[:, None] * n + np.arange(m)[None, :] * length).reshape(-1)
        last = (np.arange(b)[:, None] * n + np.minimum(np.arange(1, m + 1) * length, n)[None, :]
                - 1).reshape(-1)
        tree = [x[last].reshape((b, m) + x.shape[1:]) for x in pre]
        if carried:
            tree = [np.concatenate([c[:, None], x], axis=1) for c, x in zip(_host(*carry), tree)]
        k = tree[0].shape[1]
        levels = [tree]
        for level in range(tree_levels(k)):
            h = 1 << level
            new = _combine(*(tuple(x[:, lo:hi].reshape((-1,) + x.shape[2:]) for x in tree)
                             for lo, hi in ((0, k - h), (h, k))))
            tree = [np.concatenate([x[:, :h], v.reshape((b, k - h) + x.shape[2:])], axis=1)
                    for x, v in zip(tree, new)]
            levels.append(tree)
        # stage 3's adjoint at every position: the innovations', then the
        # stitch's (its partial composition) or the prefix's own (b, C);
        # d3[q] the prefix at q's cotangent, w[p] the exclusive carry's share
        d3 = tuple(np.zeros_like(x) for x in pre)
        w = (np.zeros((b * n, r), dtype), np.zeros((b * n, r, r), dtype))
        dA = np.empty((b * n, r, r), dtype)
        dQ = np.empty((b * n, r, r), dtype)
        dd = np.empty(b * n, dtype)
        p = np.arange(b * n)
        q = p - 1
        excl = (q % n) // length - (not carried)
        stitch = (p % n > 0) & (excl >= 0)
        alone = (p % n > 0) & (excl < 0)
        rows = p // n
        for c in cuts:
            sl = slice(c, c + _SLICE)
            ps = p[sl]
            fb = np.zeros((ps.size, r), dtype)
            fC = np.zeros((ps.size, r, r), dtype)
            at0 = (ps % n == 0)
            if carried:
                fb[at0], fC[at0] = tree[1][rows[ps[at0]], 0], tree[2][rows[ps[at0]], 0]
            al, st = alone[sl], stitch[sl]
            fb[al], fC[al] = pre[1][q[sl][al]], pre[2][q[sl][al]]
            at = ps[st]
            ei = tuple(x[rows[at], excl[at]] for x in tree)
            ej = tuple(x[q[at]] for x in pre)
            if at.size:
                fb[st], fC[st] = _combine(ei, ej, full=False)
            dA[sl], dQ[sl], dd[sl], db, dC = _innovation_vjp(A[sl], Q[sl], H, fb, fC, dmu[sl],
                                                             ds[sl])
            if carried:
                w[0][ps[at0]], w[1][ps[at0]] = db[at0], dC[at0]
            d3[1][q[sl][al]], d3[2][q[sl][al]] = db[al], dC[al]
            if at.size:
                dei, dej = _combine_vjp(ei, ej, (db[st], dC[st]), full=False)
                w[0][at], w[1][at] = dei[1], dei[2]
                for x, v in zip(d3, dej):
                    x[q[at]] = v
        # each leaf's share summed in ascending position from zero, then the
        # outgoing carry's cotangent on the last leaf
        start, end = _leaf_spans(k, length, n, carried)
        dt = [np.zeros((b, k) + x.shape[2:], dtype) for x in tree]
        base = np.arange(b)[:, None] * n
        for o in range(length + 1):
            pos = start + o
            valid = (pos < end)[None, :]
            at = base + np.minimum(pos, n - 1)[None, :]
            dt[1] = np.where(valid[..., None], dt[1] + w[0][at], dt[1])
            dt[2] = np.where(valid[..., None, None], dt[2] + w[1][at], dt[2])
        if dcarry is not None:
            for x, v in zip(dt, _host(*dcarry)):
                x[:, -1] = x[:, -1] + v
        # the scan's levels in reverse: leaf i's cotangent is its own share
        # (the later operand's at i >= h, else passed on), then the earlier
        # operand's of the pair (i, i + h)
        for level in range(len(levels) - 2, -1, -1):
            h = 1 << level
            x = levels[level]
            flat = lambda v, lo, hi: tuple(e[:, lo:hi].reshape((-1,) + e.shape[2:])  # noqa: E731
                                           for e in v)
            dl, dr = _combine_vjp(flat(x, 0, k - h), flat(x, h, k), flat(dt, h, k))
            new = [np.concatenate([e[:, :h], v.reshape((b, k - h) + e.shape[2:])], axis=1)
                   for e, v in zip(dt, dr)]
            for e, v in zip(new, dl):
                e[:, :k - h] = e[:, :k - h] + v.reshape((b, k - h) + e.shape[2:])
            dt = new
        dcarry_in = tuple(x[:, 0] for x in dt) if carried else None
        # each block walked backwards from its summary's cotangent: the
        # prefix's cotangent is what the step after it handed back plus its
        # stitch share; the step composed the prefix before (the identity at
        # a block's first) with the element, formed again
        parts = [_elements(A[c:c + _SLICE], Q[c:c + _SLICE], H, diag[c:c + _SLICE],
                           y[c:c + _SLICE]) for c in cuts]
        elems = [np.concatenate([p_[i] for p_ in parts]) for i in range(5)]
        del parts
        de = tuple(np.zeros_like(x) for x in elems)
        run = tuple(x[:, int(carried):].reshape((b * m,) + x.shape[2:]) for x in dt)
        ident = _identity(b * m, r, dtype)
        for l in range(length - 1, -1, -1):
            at = first + l
            valid = at <= last
            at = np.minimum(at, last)
            more = valid & ((at % n) + 1 < n)
            dp = _select(more, tuple(u + v[at] for u, v in zip(run, d3)), run)
            prev = ident if l == 0 else tuple(x[at - 1] for x in pre)
            dprev, dej = _combine_vjp(prev, tuple(x[at] for x in elems), dp)
            for x, v in zip(de, dej):
                x[at[valid]] = v[valid]
            run = _select(valid, dprev, run)
        del elems, d3
        dy = np.empty(b * n, dtype)
        for c in cuts:
            sl = slice(c, c + _SLICE)
            ea, eq, ed, dy[sl] = _elements_vjp(A[sl], Q[sl], H, diag[sl], y[sl],
                                               tuple(x[sl] for x in de))
            dA[sl] = dA[sl] + ea
            dQ[sl] = dQ[sl] + eq
            dd[sl] = dd[sl] + ed
    out = _back(device, dA.reshape(b, n, r, r), dQ.reshape(b, n, r, r), dd.reshape(b, n),
                dy.reshape(b, n))
    if carried:
        return (*out, tuple(_back(device, *dcarry_in)))
    return (*out, None)


def kalman_blocked(A, Q, H, diag, y, n_blocks, carry=None, prefixes=False):
    """K1: the blocked Kalman composition (see the module). A, Q [B, N, R,
    R], H [R], diag, y [B, N], one floating dtype; ``n_blocks`` >= 1;
    ``carry`` an incoming 5-tuple (A [B, R, R], b [B, R], C [B, R, R], eta
    [B, R], J [B, R, R]) or None. Returns (mu, s, outgoing carry), and with
    ``prefixes`` also stage 1's inclusive prefixes [B, N, S], which K2 reads.

    On a CUDA tensor one call of the kernel (its stages' launches on the
    current stream, no synchronise; scratch of [B, N, S] and [2, B, m + 1,
    S] values, S = :func:`state_size`); on a CPU tensor the plain
    version. Where gradients are on and A, Q, diag, y or the carry needs
    one, the call goes through :class:`KalmanBlocked`, whose backward is
    K2 (:func:`kalman_blocked_adjoint`)."""
    nb = int(n_blocks)
    if nb < 1:
        raise ValueError(f"kalman_blocked needs n_blocks >= 1, got {n_blocks}")
    if not prefixes and torch.is_grad_enabled() and any(
            x.requires_grad for x in (A, Q, diag, y, *(carry or ()))):
        r = A.shape[-1]
        packed = () if carry is None else (pack_carry(carry),)
        mu, s, out = KalmanBlocked.apply(H, nb, A, Q, diag, y, *packed)
        return mu, s, unpack_carry(out, r)
    if _on_cpu(A):
        return kalman_blocked_plain(A, Q, H, diag, y, nb, carry, prefixes)
    if A.dim() != 4 or A.shape[-1] != A.shape[-2]:
        raise ValueError(f"kalman_blocked: A is [B, N, R, R], got {tuple(A.shape)}")
    b, n, r, _ = A.shape
    if not 1 <= r <= MAX_R:
        raise ValueError(f"the Kalman kernel takes 1 to {MAX_R} states (R), got {r}; a term "
                         f"this wide runs only on CPU tensors, whose plain version takes any R")
    if b < 1 or n < 1:
        raise ValueError(f"kalman_blocked needs B, N >= 1, got {tuple(A.shape)}")
    dtype = A.dtype
    packed = None if carry is None else pack_carry(carry)
    _check("kalman_blocked", {"Q": Q, "H": H, "diag": diag, "y": y, "carry": packed},
           dtype, A.device)
    k = state_size(r)
    if Q.shape != A.shape or H.shape != (r,) or diag.shape != (b, n) or y.shape != (b, n) or (
            packed is not None and packed.shape != (b, k)):
        raise ValueError("kalman_blocked: A, Q [B, N, R, R], H [R], diag, y [B, N], carry of "
                         "[B, ...]")
    A, Q, H, diag, y = (x.contiguous() for x in (A, Q, H, diag, y))
    packed = None if packed is None else packed.contiguous()
    _, m = block_geometry(n, nb)
    elems = A.new_empty((b, n, k))
    tree = A.new_empty((2, b, m + (packed is not None), k))
    mu = A.new_empty((b, n))
    s = A.new_empty((b, n))
    out = A.new_empty((b, k))
    _launch("kalman_blocked", _entry("kalman_blocked", dtype), A, Q, H, diag, y, packed, b, n,
            r, nb, elems, tree, mu, s, out)
    kalman_blocked.launches += 1
    if prefixes:
        return mu, s, unpack_carry(out, r), elems
    return mu, s, unpack_carry(out, r)


kalman_blocked.launches = 0


def kalman_blocked_adjoint(A, Q, H, diag, y, n_blocks, carry, prefixes, dmu, ds,
                           dcarry=None):
    """K2: the adjoint of K1 (:func:`kalman_blocked`), the vector-Jacobian
    product of its call on A, Q, H, diag, y, ``n_blocks`` and ``carry``
    (None or a 5-tuple), from the stage-1 ``prefixes`` [B, N, S] that call
    returned, the cotangents ``dmu``, ``ds`` [B, N] and ``dcarry`` (the
    outgoing carry's 5-tuple, or None for zeros). Returns (dA, dQ [B, N, R,
    R], ddiag, dy [B, N], the incoming carry's 5-tuple or None). H is a
    constant.

    On a CUDA tensor one call of the kernel (``csrc/kalman_adjoint.cuh``,
    a group of lanes a composition as in K1: the scan's levels again, the
    stitch's and innovations' adjoint at every position, each leaf's sum, a
    launch a level of the scan in reverse, each block's backward walk, the
    elements' adjoint, 2 levels + 5 launches; scratch of [B, N, S + R + R^2] and [levels + 3, B, m + 1,
    S] values); on a CPU tensor the plain version, with which it agrees bit
    for bit."""
    nb = int(n_blocks)
    if nb < 1:
        raise ValueError(f"kalman_blocked_adjoint needs n_blocks >= 1, got {n_blocks}")
    if _on_cpu(A):
        return kalman_blocked_adjoint_plain(A, Q, H, diag, y, nb, carry, prefixes, dmu, ds,
                                            dcarry)
    b, n, r, _ = A.shape
    if not 1 <= r <= MAX_R:
        raise ValueError(f"the Kalman kernel takes 1 to {MAX_R} states (R), got {r}")
    dtype = A.dtype
    k = state_size(r)
    packed = None if carry is None else pack_carry(carry).contiguous()
    dpacked = None if dcarry is None else pack_carry(dcarry).contiguous()
    _check("kalman_blocked_adjoint", {"Q": Q, "H": H, "diag": diag, "y": y, "carry": packed,
                                      "prefixes": prefixes, "dmu": dmu, "ds": ds,
                                      "dcarry": dpacked}, dtype, A.device)
    if (Q.shape != A.shape or H.shape != (r,) or diag.shape != (b, n) or y.shape != (b, n)
            or prefixes.shape != (b, n, k) or dmu.shape != (b, n) or ds.shape != (b, n)
            or any(x is not None and x.shape != (b, k) for x in (packed, dpacked))):
        raise ValueError("kalman_blocked_adjoint: A, Q [B, N, R, R], H [R], diag, y, dmu, ds "
                         "[B, N], prefixes [B, N, S], carries of [B, ...]")
    A, Q, H, diag, y, prefixes, dmu, ds = (
        x.contiguous() for x in (A, Q, H, diag, y, prefixes, dmu, ds))
    _, m = block_geometry(n, nb)
    leaves = m + (packed is not None)
    levels = A.new_empty((tree_levels(leaves) + 1, b, leaves, k))
    dtree = A.new_empty((2, b, leaves, k))
    dpre = A.new_empty((b, n, k))
    share = A.new_empty((b, n, r + r * r))
    dA, dQ = torch.empty_like(A), torch.empty_like(Q)
    dd, dy = torch.empty_like(diag), torch.empty_like(y)
    dc = None if packed is None else A.new_empty((b, k))
    _launch("kalman_blocked_adjoint", _entry("kalman_blocked_adjoint", dtype), A, Q, H, diag, y,
            packed, prefixes, dmu, ds, dpacked, b, n, r, nb, levels, dtree, dpre, share, dA, dQ,
            dd, dy, dc)
    kalman_blocked_adjoint.launches += 1
    return dA, dQ, dd, dy, None if dc is None else unpack_carry(dc, r)


kalman_blocked_adjoint.launches = 0


class KalmanBlocked(torch.autograd.Function):
    """(A, Q, diag, y, packed carry) -> (mu, s, packed outgoing carry)
    through K1, with K2 as its backward. H and the block count are
    constants. The forward keeps K1's stage-1 prefixes [B, N, S] for the
    backward."""

    @staticmethod
    def forward(ctx, H, n_blocks, A, Q, diag, y, *packed):
        r = A.shape[-1]
        carry = unpack_carry(packed[0], r) if packed else None
        mu, s, out, pre = kalman_blocked(A, Q, H, diag, y, n_blocks, carry, prefixes=True)
        ctx.save_for_backward(A, Q, H, diag, y, pre, *packed)
        ctx.n_blocks = n_blocks
        ctx.set_materialize_grads(False)
        return mu, s, pack_carry(out)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dmu, ds, dout):
        A, Q, H, diag, y, pre, *packed = ctx.saved_tensors
        r = A.shape[-1]
        dmu = torch.zeros_like(diag) if dmu is None else dmu
        ds = torch.zeros_like(diag) if ds is None else ds
        dA, dQ, dd, dy, dc = kalman_blocked_adjoint(
            A, Q, H, diag, y, ctx.n_blocks, unpack_carry(packed[0], r) if packed else None, pre,
            dmu, ds, None if dout is None else unpack_carry(dout, r))
        return (None, None, dA, dQ, dd, dy, *((pack_carry(dc),) if packed else ()))


_GEOMETRY_KEYS = ("lanes", "element_positions", "element_blocks", "prefix_chains",
                  "prefix_blocks", "prefix_threads", "step_tile", "length", "blocks",
                  "leaves", "tree_launches", "group_items", "innovation_blocks",
                  "tree_items", "tree_blocks")
_ADJOINT_KEYS = ("lanes", "group_items", "position_blocks", "leaf_blocks", "value_blocks",
                 "chain_blocks", "length", "blocks", "leaves", "levels", "launches")


def kernel_geometry(b, n, r, n_blocks, carry=False, dtype=torch.float32, adjoint=False):
    """The launch geometry ``csrc/kalman.cu`` uses, read from the built
    library (built if it is missing), for ``b`` rows of ``n`` samples at
    ``r`` states over ``n_blocks`` blocks, with an incoming carry or not:
    ``lanes`` a group (the next power of two >= R); stage 0's
    ``element_positions`` a block and ``element_blocks``; stage 1's
    ``prefix_chains`` a block (one warp walks them, a second stages their
    tiles), ``prefix_blocks``, ``prefix_threads`` and ``step_tile``, the
    steps staged at a time; ``length`` (L) and ``blocks`` (m, those that
    hold a position); the scan's ``leaves`` and ``tree_launches``; stage
    3's ``group_items`` a block and ``innovation_blocks``; stage 2's
    ``tree_items`` a block and ``tree_blocks`` a level.

    With ``adjoint`` K2's (``csrc/kalman_adjoint.cu``): its ``lanes`` a
    group (as K1's) and ``group_items`` a block (one warp of groups, a
    group an item); the blocks over the positions, the leaves, the leaf
    kernel's over the leaves' values (a thread a value) and over the
    chains; L, m, the ``leaves``, the scan's ``levels`` and the
    ``launches`` a call (2 levels + 5)."""
    keys, fn = ((_ADJOINT_KEYS, "kalman_blocked_adjoint_geometry") if adjoint
                else (_GEOMETRY_KEYS, "kalman_blocked_geometry"))
    out = (ctypes.c_int * len(keys))()
    err = getattr(load(), fn)(b, n, r, int(n_blocks), int(bool(carry)),
                              torch.empty((), dtype=dtype).element_size(), out)
    if err != 0:
        raise ValueError(f"no Kalman launch for b={b}, n={n}, r={r}, n_blocks={n_blocks}")
    return dict(zip(keys, out))


def kernel_attributes(r, dtype, adjoint=False):
    """K1's four compiled stages at ``r`` states in ``dtype``, as the
    runtime reports them on the current card: for each of ``element``,
    ``prefix``, ``tree`` and ``innovation``, its ``local_bytes`` of local
    memory a thread, ``registers`` a thread and static ``shared_bytes`` a
    block. With ``adjoint`` K2's six kernels: ``levels``, ``stitch``,
    ``leaf``, ``tree``, ``walk`` and ``element``, their ``shared_bytes``
    the static and dynamic shared memory a block (the groups' slots)."""
    if not 1 <= r <= MAX_R:
        raise ValueError(f"the Kalman kernel takes 1 to {MAX_R} states (R), got {r}")
    stages = (("levels", "stitch", "leaf", "tree", "walk", "element") if adjoint
              else ("element", "prefix", "tree", "innovation"))
    out = (ctypes.c_int * (3 * len(stages)))()
    fn = "kalman_blocked_adjoint_attributes" if adjoint else "kalman_blocked_attributes"
    err = getattr(load(), fn)(r, torch.empty((), dtype=dtype).element_size(), out)
    if err != 0:
        raise RuntimeError(f"{fn} failed: cudaError {err}")
    keys = ("local_bytes", "registers", "shared_bytes")
    return {stage: dict(zip(keys, out[3 * k:3 * k + 3])) for k, stage in enumerate(stages)}
