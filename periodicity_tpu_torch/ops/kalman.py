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
"""

import ctypes

import numpy as np
import torch

from ._kernels import MAX_R, _back, _check, _entry, _host, _launch, _on_cpu, load

__all__ = ["kalman_blocked", "kalman_blocked_plain", "pack_carry", "unpack_carry",
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


def _solve(MB, r):
    """Solve M X = B for MB = [M | B] [m, R, W]: elimination with partial
    pivoting (the first maximal |value| of the column at or below the
    diagonal), then back substitution. Columns left of the pivot are not
    updated: nothing reads them again."""
    m = MB.shape[0]
    rows = np.arange(m)
    MB = MB.copy()
    for col in range(r - 1):
        p = np.full(m, col)
        best = np.abs(MB[:, col, col])
        for i in range(col + 1, r):
            mag = np.abs(MB[:, i, col])
            take = mag > best
            best = np.where(take, mag, best)
            p = np.where(take, i, p)
        row_col = MB[:, col, col:].copy()
        MB[:, col, col:] = MB[rows, p, col:]
        MB[rows, p, col:] = row_col
        piv = MB[:, col, col]
        for i in range(col + 1, r):
            f = MB[:, i, col] / piv
            MB[:, i, col + 1:] = MB[:, i, col + 1:] - f[:, None] * MB[:, col, col + 1:]
    k = MB.shape[2] - r
    X = np.empty((m, r, k), MB.dtype)
    for i in range(r - 1, -1, -1):
        s = MB[:, i, r:].copy()
        for j in range(i + 1, r):
            s = s - MB[:, i, j, None] * X[:, j]
        X[:, i] = s / MB[:, i, i, None]
    return X


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


def kalman_blocked_plain(A, Q, H, diag, y, n_blocks, carry=None):
    """K1's plain version: A, Q [B, N, R, R] (step 0 of a series already
    A = 0, Q = Pinf), H [R], diag, y [B, N], one dtype; ``carry`` an
    incoming 5-tuple of [B, ...] or None (the identity). Returns (mu [B, N],
    s [B, N], the outgoing carry: a 5-tuple of [B, ...]) on the inputs'
    device; the stages step through numpy arrays on the host, vectorized
    over rows, blocks and positions."""
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
    return out[0], out[1], tuple(out[2:])


def kalman_blocked(A, Q, H, diag, y, n_blocks, carry=None):
    """K1: the blocked Kalman composition (see the module). A, Q [B, N, R,
    R], H [R], diag, y [B, N], one floating dtype; ``n_blocks`` >= 1;
    ``carry`` an incoming 5-tuple (A [B, R, R], b [B, R], C [B, R, R], eta
    [B, R], J [B, R, R]) or None. Returns (mu, s, outgoing carry).

    On a CUDA tensor one call of the kernel (its stages' launches on the
    current stream, no synchronise; scratch of [B, N, S] and [2, B, m + 1,
    S] values, S = :func:`state_size`); on a CPU tensor the plain
    version."""
    nb = int(n_blocks)
    if nb < 1:
        raise ValueError(f"kalman_blocked needs n_blocks >= 1, got {n_blocks}")
    if _on_cpu(A):
        return kalman_blocked_plain(A, Q, H, diag, y, nb, carry)
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
    return mu, s, unpack_carry(out, r)


kalman_blocked.launches = 0


_GEOMETRY_KEYS = ("lanes", "element_positions", "element_blocks", "prefix_chains",
                  "prefix_blocks", "prefix_threads", "step_tile", "length", "blocks",
                  "leaves", "tree_launches", "group_items", "innovation_blocks",
                  "tree_items", "tree_blocks")


def kernel_geometry(b, n, r, n_blocks, carry=False, dtype=torch.float32):
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
    ``tree_items`` a block and ``tree_blocks`` a level."""
    out = (ctypes.c_int * len(_GEOMETRY_KEYS))()
    err = load().kalman_blocked_geometry(b, n, r, int(n_blocks), int(bool(carry)),
                                         torch.empty((), dtype=dtype).element_size(), out)
    if err != 0:
        raise ValueError(f"no Kalman launch for b={b}, n={n}, r={r}, n_blocks={n_blocks}")
    return dict(zip(_GEOMETRY_KEYS, out))


def kernel_attributes(r, dtype):
    """K1's four compiled stages at ``r`` states in ``dtype``, as the
    runtime reports them on the current card: for each of ``element``,
    ``prefix``, ``tree`` and ``innovation``, its ``local_bytes`` of local
    memory a thread, ``registers`` a thread and static ``shared_bytes`` a
    block."""
    if not 1 <= r <= MAX_R:
        raise ValueError(f"the Kalman kernel takes 1 to {MAX_R} states (R), got {r}")
    out = (ctypes.c_int * 12)()
    err = load().kalman_blocked_attributes(r, torch.empty((), dtype=dtype).element_size(), out)
    if err != 0:
        raise RuntimeError(f"kalman_blocked_attributes failed: cudaError {err}")
    keys = ("local_bytes", "registers", "shared_bytes")
    return {stage: dict(zip(keys, out[3 * k:3 * k + 3]))
            for k, stage in enumerate(("element", "prefix", "tree", "innovation"))}
