"""K1: the blocked Kalman composition of the celerite GP likelihood.

The JAX package evaluates the blocked and the chunked likelihoods
(``periodicity_tpu/models/gp/pscan.py``: ``_pkf_loglik_blocked`` at
``:332-346``, one chunk of ``_pkf_loglik_chunked`` at ``:349-407``) as a
``lax.scan`` of ``_combine`` over ``ceil(N / n_blocks)`` dependent steps,
vectorized over the blocks, then an associative scan of the block summaries
and a stitch. XLA fuses each step into one dispatch; eager PyTorch would pay
~150 launches for every step (the unrolled pivoted solve of a composition
alone is most of them). So on a CUDA tensor the whole composition is one
call of a hand-written kernel (``csrc/kalman.cu``), and on a CPU tensor its
plain version here. Both round every product, sum, difference and quotient
on its own, in the same order, so they agree bit for bit.

A filtering element (Särkkä & García-Fernández 2021) is the 5-tuple
``(A, b, C, eta, J)``; position k's comes from the step's transition
``A_k``, process noise ``Q_k``, the observation row ``H``, the noise
variance ``diag_k`` and the residual ``y_k``, as JAX's ``_elements_from_AQ``
builds it. The composition ``combine(ei, ej)`` (``ei`` earlier) solves one
``R x R`` system ``M = I + J_j C_i`` by elimination with partial pivoting
(the first maximal |value|) against ``[A_j^T | eta_j - J_j b_i | J_j A_i]``.
Per row (walker), with ``L = ceil(N / n_blocks)`` positions a block:

1. each block composes its elements in order from the identity: its summary;
2. the summaries are composed in order from the incoming carry (or the
   identity): each block's exclusive carry, and the row's outgoing carry;
3. each block composes its elements again from its exclusive carry; before
   position k's element it forms the predicted mean and variance from the
   filtered ``(b, C)`` of the position before (JAX's ``_innovation_loglik``
   and the chunked body, ``:227-240``, ``:389-395``)::

       mu_k = H . (A_k b),   s_k = H (A_k C A_k^T + Q_k) H + diag_k

The log-likelihood's sums stay eager torch, outside. Stage 3's composition
from the carry equals JAX's ``carry o prefix`` stitch in exact arithmetic,
not in rounding. Every sum below runs over its index in ascending order,
one add at a time; the plain version steps through host numpy (which rounds
every operation on its own) vectorized over rows and blocks.

``kalman_blocked.launches`` counts the calls that launched the kernel (each
runs its three stages as three launches).
"""

import numpy as np
import torch

from ._kernels import MAX_R, _back, _check, _entry, _host, _launch, _on_cpu

__all__ = ["kalman_blocked", "kalman_blocked_plain", "pack_carry", "unpack_carry",
           "state_size"]


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


def _combine(ei, ej):
    """The composition of elements ``ei`` (earlier) and ``ej`` (later)."""
    Ai, bi, Ci, etai, Ji = ei
    Aj, bj, Cj, etaj, Jj = ej
    r = Ai.shape[-1]
    eye = np.eye(r, dtype=Ai.dtype)
    M = eye[None] + _mm(Jj, Ci)
    MB = np.concatenate([M, np.swapaxes(Aj, 1, 2), (etaj - _mv(Jj, bi))[:, :, None],
                         _mm(Jj, Ai)], axis=2)
    X = _solve(MB, r)
    m1t = np.swapaxes(X[:, :, :r], 1, 2)
    m2 = X[:, :, r]
    m3 = X[:, :, r + 1:]
    A_n = _mm(m1t, Ai)
    b_n = _mv(m1t, bi + _mv(Ci, etaj)) + bj
    C_n = _mmt(_mm(m1t, Ci), Aj) + Cj
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


def kalman_blocked_plain(A, Q, H, diag, y, n_blocks, carry=None):
    """K1's plain version: A, Q [B, N, R, R] (step 0 of a series already
    A = 0, Q = Pinf), H [R], diag, y [B, N], one dtype; ``carry`` an
    incoming 5-tuple of [B, ...] or None (the identity). Returns (mu [B, N],
    s [B, N], the outgoing carry: a 5-tuple of [B, ...]) on the inputs'
    device; the composition steps through numpy arrays on the host."""
    device = A.device
    A, Q, H, diag, y = _host(A, Q, H, diag, y)
    b, n, r, _ = A.shape
    nb = int(n_blocks)
    length = -(-n // nb)
    dtype = A.dtype
    m = b * nb
    # position of (row, block, l) and its clamp; rows major, blocks minor
    blocks = np.arange(nb)

    def at(l):
        pos = blocks * length + l
        valid = np.tile(pos < n, b)
        p = np.minimum(pos, n - 1)
        return valid, p

    def gather(p):
        take = lambda x: x[:, p].reshape((m,) + x.shape[2:])  # noqa: E731
        return take(A), take(Q), take(diag), take(y)

    with np.errstate(all="ignore"):
        # stage 1: block summaries
        state = _identity(m, r, dtype)
        for l in range(length):
            valid, p = at(l)
            a, q, d, yy = gather(p)
            state = _select(valid, _combine(state, _elements(a, q, H, d, yy)), state)
        summ = tuple(x.reshape((b, nb) + x.shape[1:]) for x in state)
        # stage 2: exclusive carries and the outgoing carry
        run = _identity(b, r, dtype) if carry is None else tuple(_host(*carry))
        excl = []
        for k in range(nb):
            excl.append(run)
            run = _combine(run, tuple(x[:, k] for x in summ))
        state = tuple(np.stack([e[i] for e in excl], axis=1).reshape((m,) + excl[0][i].shape[1:])
                      for i in range(5))
        # stage 3: innovations from each block's exclusive carry
        mu = np.empty((b, n), dtype)
        s = np.empty((b, n), dtype)
        for l in range(length):
            valid, p = at(l)
            a, q, d, yy = gather(p)
            mu_l, s_l = _innovation(a, q, H, d, state[1], state[2])
            vb = valid.reshape(b, nb)
            pb = np.broadcast_to(p, (b, nb))
            rows = np.broadcast_to(np.arange(b)[:, None], (b, nb))
            mu[rows[vb], pb[vb]] = mu_l.reshape(b, nb)[vb]
            s[rows[vb], pb[vb]] = s_l.reshape(b, nb)[vb]
            state = _select(valid, _combine(state, _elements(a, q, H, d, yy)), state)
    out = _back(device, mu, s, *run)
    return out[0], out[1], tuple(out[2:])


def kalman_blocked(A, Q, H, diag, y, n_blocks, carry=None):
    """K1: the blocked Kalman composition (see the module). A, Q [B, N, R,
    R], H [R], diag, y [B, N], one floating dtype; ``n_blocks`` >= 1;
    ``carry`` an incoming 5-tuple (A [B, R, R], b [B, R], C [B, R, R], eta
    [B, R], J [B, R, R]) or None. Returns (mu, s, outgoing carry).

    On a CUDA tensor one call of the kernel (three launches on the current
    stream, no synchronise); on a CPU tensor the plain version."""
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
                         f"this wide runs only on CPU tensors")
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
    summ = A.new_empty((b, nb, k))
    excl = A.new_empty((b, nb, k))
    mu = A.new_empty((b, n))
    s = A.new_empty((b, n))
    out = A.new_empty((b, k))
    _launch("kalman_blocked", _entry("kalman_blocked", dtype), A, Q, H, diag, y, packed, b, n,
            r, nb, summ, excl, mu, s, out)
    kalman_blocked.launches += 1
    return mu, s, unpack_carry(out, r)


kalman_blocked.launches = 0
