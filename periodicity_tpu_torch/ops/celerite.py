"""The celerite recursions: the fused factor and forward substitution (G1),
its adjoint (G2) and the two-sweep solve (G3).

The JAX package runs each as a ``lax.scan`` over the N samples
(``periodicity_tpu/models/gp/solver.py``: the fused likelihood at
``:150-167``, the factor at ``:71-86``, the solve at ``:88-130``), which XLA
fuses into one dispatch and differentiates with ``jax.grad``. Eager PyTorch
would pay a handful of launches for every step of every sweep, so on a CUDA
tensor each recursion is one launch of a hand-written kernel
(``csrc/celerite.cuh``, R = 1 to :data:`MAX_R` slots): G1 walks a walker
on a group of lanes, lane i
owning row i of the state; G2 walks it back on the same lanes, lane i
owning row i of the adjoint state and of the state it rebuilds; G3 walks
a column of the right-hand sides on one lane, the coefficients staged in
shared memory (:func:`kernel_geometry`). On a CPU tensor each is its
plain version here. Both round every product, sum, difference and
quotient on its own, in the same order, so they agree bit for bit.

The kernel matrix is ``K = diag(A) + tril(U W^T) + triu(W U^T)`` with the
semiseparable factor ``K = L diag(D) L^T``, ``L = I + tril(U W^T)``. Rows
(walkers, or any leading batch) are independent. Per step n >= 1, with
``p = P[n-1]``::

    S   = (p_i p_j) (S_ij + D_{n-1} (W_{n-1,i} W_{n-1,j}))
    Su  = S u_n;  D_n = a_n - u_n . Su;  W_n = (v_n - Su) / D_n
    f   = p (f + W_{n-1} z_{n-1});  z_n = y_n - u_n . f

Every sum over the R slots is taken left to right, one add at a time. The
state S is symmetric bit for bit (each entry is a product of commuting
factors), so the kernel keeps its upper triangle; the forward saves S before
each step's update (packed, ``R (R + 1) / 2`` values, row-major upper
triangle) and f for the adjoint sweep, which recomputes the rest. The plain
versions step through numpy arrays on the host, as ``sosfilt_plain`` does.

``celerite_forward.launches``, ``celerite_adjoint.launches`` and
``celerite_solve.launches`` count the kernel launches.
"""

import ctypes

import numpy as np
import torch

from ._kernels import MAX_R, _back, _check, _entry, _host, _launch, _on_cpu, load

__all__ = [
    "MAX_R",
    "celerite_forward",
    "celerite_forward_plain",
    "celerite_adjoint",
    "celerite_adjoint_plain",
    "celerite_solve",
    "celerite_solve_plain",
    "CeleriteLikelihood",
]


def _rowsum(x):
    """Sum over the last axis, left to right, one add at a time."""
    acc = x[..., 0]
    for j in range(1, x.shape[-1]):
        acc = acc + x[..., j]
    return acc


def _unpack_index(r):
    """Row-major upper triangle (iu, ju) and the [R, R] index of each
    entry's slot in it."""
    iu, ju = np.triu_indices(r)
    full = np.empty((r, r), dtype=np.int64)
    full[iu, ju] = np.arange(iu.shape[0])
    full[ju, iu] = np.arange(iu.shape[0])
    return iu, ju, full


def celerite_forward_plain(A, U, V, P, y=None, save=False):
    """G1's plain version: A [B, N], U, V [B, N, R], P [B, N-1, R] and
    optionally y [B, N], one dtype. Returns (D [B, N], W [B, N, R], z [B, N]
    or None, S_saved [B, N-1, R(R+1)/2] or None, f_saved [B, N-1, R] or
    None); the saved state (with ``save``) is S before each step's update
    and f before it (zeros without y).

    The recursion steps through numpy arrays of the working dtype on the
    host (numpy rounds every operation on its own), one row per batch
    entry, and the results go back to the inputs' device."""
    device = U.device
    A, U, V, P, y = _host(A, U, V, P, y)
    b, n, r = U.shape
    iu, ju, _ = _unpack_index(r)
    D = np.empty_like(A)
    W = np.empty_like(U)
    z = np.empty_like(y) if y is not None else None
    d_prev = D[:, 0] = A[:, 0]
    w_prev = W[:, 0] = V[:, 0] / d_prev[:, None]
    S = np.zeros((b, r, r), U.dtype)
    f = np.zeros((b, r), U.dtype)
    if y is not None:
        z_prev = z[:, 0] = y[:, 0]
    k = iu.shape[0]
    S_saved = np.empty((b, n - 1, k), U.dtype) if save else None
    f_saved = np.empty((b, n - 1, r), U.dtype) if save else None
    for i in range(1, n):
        p = P[:, i - 1]
        u = U[:, i]
        if save:
            S_saved[:, i - 1] = S[:, iu, ju]
            f_saved[:, i - 1] = f
        pp = p[:, :, None] * p[:, None, :]
        S = pp * (S + d_prev[:, None, None] * (w_prev[:, :, None] * w_prev[:, None, :]))
        su = _rowsum(S * u[:, None, :])
        d = D[:, i] = A[:, i] - _rowsum(u * su)
        w = W[:, i] = (V[:, i] - su) / d[:, None]
        if y is not None:
            f = p * (f + w_prev * z_prev[:, None])
            z_prev = z[:, i] = y[:, i] - _rowsum(u * f)
        d_prev, w_prev = d, w
    return tuple(_back(device, D, W, z, S_saved, f_saved))


def celerite_adjoint_plain(U, P, D, W, z, S_saved, f_saved, dD, dz):
    """G2's plain version: the reverse sweep of G1 with y. Given G1's
    inputs U, P, its outputs D, W, z and saved state, and the adjoints dD,
    dz [B, N] of D and z, returns (dA [B, N], dU [B, N, R], dV [B, N, R],
    dP [B, N-1, R], dy [B, N]). An explicit sweep in the kernel's order of
    operations, on host numpy as :func:`celerite_forward_plain`."""
    device = U.device
    U, P, D, W, z, S_saved, f_saved, dD, dz = _host(U, P, D, W, z, S_saved, f_saved, dD, dz)
    b, n, r = U.shape
    _, _, full = _unpack_index(r)
    dA = np.empty_like(D)
    dU = np.empty_like(U)
    dV = np.empty_like(U)
    dP = np.empty_like(P)
    dy = np.empty_like(D)
    G = np.zeros((b, r, r), U.dtype)
    wb = np.zeros((b, r), U.dtype)
    fb = np.zeros((b, r), U.dtype)
    db = dD[:, n - 1]
    zb = dz[:, n - 1]
    for i in range(n - 1, 0, -1):
        p = P[:, i - 1]
        u = U[:, i]
        w_prev, d_prev, z_prev = W[:, i - 1], D[:, i - 1], z[:, i - 1]
        # the forward step again, from the saved state
        st = S_saved[:, i - 1][:, full] + d_prev[:, None, None] * (
            w_prev[:, :, None] * w_prev[:, None, :])
        pp = p[:, :, None] * p[:, None, :]
        sn = pp * st
        su = _rowsum(sn * u[:, None, :])
        ft = f_saved[:, i - 1] + w_prev * z_prev[:, None]
        fn = p * ft
        d, w = D[:, i], W[:, i]
        # z_n = y_n - u . f_n
        dy[:, i] = zb
        nzb = -zb
        ub = nzb[:, None] * fn
        fb = fb + nzb[:, None] * u
        # f_n = p (f_{n-1} + W_{n-1} z_{n-1})
        pb = fb * ft
        ftb = fb * p
        wb_prev = ftb * z_prev[:, None]
        zb_prev = dz[:, i - 1] + _rowsum(ftb * w_prev)
        # W_n = (v_n - Su) / D_n
        vb = dV[:, i] = wb / d[:, None]
        sub = -vb
        db = db - _rowsum(wb * w) / d
        # D_n = a_n - u_n . Su
        dA[:, i] = db
        ub = ub - db[:, None] * su
        sub = sub - db[:, None] * u
        # Su = S_n u_n (S_n symmetric); the adjoint of S_n kept symmetric
        dU[:, i] = ub + _rowsum(sn * sub[:, None, :])
        G = G + (sub[:, :, None] * u[:, None, :] + u[:, :, None] * sub[:, None, :]) * 0.5
        # S_n = (p_i p_j) S~
        rp = _rowsum((G * st) * p[:, None, :])
        dP[:, i - 1] = pb + (rp + rp)
        G = G * pp
        # S~ = S_{n-1} + D_{n-1} W_{n-1} W_{n-1}^T
        q = _rowsum(G * w_prev[:, None, :])
        db = dD[:, i - 1] + _rowsum(w_prev * q)
        wb = wb_prev + d_prev[:, None] * (q + q)
        fb = ftb
        zb = zb_prev
    # n = 0: D_0 = A_0, W_0 = V_0 / D_0, z_0 = y_0
    dy[:, 0] = zb
    dV[:, 0] = wb / D[:, 0, None]
    dA[:, 0] = db - _rowsum(wb * W[:, 0]) / D[:, 0]
    dU[:, 0] = 0
    return tuple(_back(device, dA, dU, dV, dP, dy))


def celerite_solve_plain(U, P, D, W, Y):
    """G3's plain version: x = K^{-1} Y for one factored system, U, W
    [N, R], P [N-1, R], D [N], Y [N, K]. The forward substitution writes z /
    D, the backward one x, all columns at once, on host numpy as
    :func:`celerite_forward_plain`."""
    device = U.device
    U, P, D, W, Y = _host(U, P, D, W, Y)
    n, r = U.shape
    k = Y.shape[1]
    X = np.empty_like(Y)
    f = np.zeros((k, r), U.dtype)
    z_prev = Y[0]
    X[0] = z_prev / D[0]
    for i in range(1, n):
        f = P[i - 1] * (f + W[i - 1] * z_prev[:, None])
        z_prev = Y[i] - _rowsum(U[i] * f)
        X[i] = z_prev / D[i]
    g = np.zeros((k, r), U.dtype)
    x_next = X[n - 1]
    for i in range(n - 2, -1, -1):
        g = P[i] * (g + U[i + 1] * x_next[:, None])
        x_next = X[i] = X[i] - _rowsum(W[i] * g)
    return _back(device, X)[0]


def _check_r(r):
    if not 1 <= r <= MAX_R:
        raise ValueError(f"the celerite kernels take 1 to {MAX_R} slots (R), got {r}; a term "
                         f"this wide runs only on CPU tensors, whose plain versions take any R")


def kernel_geometry(b=None, r=None, k=None, adjoint=False):
    """The launch geometry ``csrc/celerite.cu`` uses, read from the built
    library (built if it is missing). For ``b`` walkers of ``r`` slots,
    G1's, or G2's with ``adjoint``: ``lanes`` a walker (the next power of
    two >= R, so a group never straddles a warp), ``walkers`` a block (one
    warp walks them; one more warp stages their tiles in G1, three in G2),
    ``blocks``, ``threads`` a block and ``step_tile``, the steps staged at
    a time. For ``k`` right-hand sides of ``r`` slots, G3's: ``columns`` a
    block (a lane a column), ``blocks``, ``threads`` a block (a warp walks
    the columns' recursions, four stage its tiles and divide by D) and
    ``row_tile``, the rows staged at a time (32, 16 past R = 8)."""
    if k is not None:
        out = (ctypes.c_int * 4)()
        keys = ("columns", "blocks", "threads", "row_tile")
        err = load().celerite_solve_geometry(k, r, out)
    else:
        out = (ctypes.c_int * 5)()
        keys = ("lanes", "walkers", "blocks", "threads", "step_tile")
        lib = load()
        err = (lib.celerite_adjoint_geometry if adjoint else lib.celerite_forward_geometry)(
            b, r, out)
    if err != 0:
        raise ValueError(f"no celerite launch for b={b}, r={r}, k={k}")
    return dict(zip(keys, out))


_ATTRIBUTE_KERNELS = ("forward_y_save", "forward_y", "forward_save", "forward", "adjoint",
                      "solve")


def kernel_attributes(r, dtype):
    """Every celerite kernel compiled at ``r`` slots in ``dtype``, as the
    runtime reports it on the current card: for G1 with y and the saved
    state (``forward_y_save``), with y, with the saved state, with neither
    (``forward``), G2 (``adjoint``) and G3 (``solve``), its ``local_bytes``
    of local memory a thread, ``registers`` a thread and ``shared_bytes`` a
    block (G2's dynamic tiles included)."""
    _check_r(r)
    out = (ctypes.c_int * 18)()
    err = load().celerite_kernel_attributes(r, dtype.itemsize, out)
    if err != 0:
        raise RuntimeError(f"celerite_kernel_attributes failed: cudaError {err}")
    keys = ("local_bytes", "registers", "shared_bytes")
    return {name: dict(zip(keys, out[3 * k:3 * k + 3]))
            for k, name in enumerate(_ATTRIBUTE_KERNELS)}


def celerite_forward(A, U, V, P, y=None, save=False, want_w=True):
    """G1: the celerite factor, fused with the forward substitution of y.

    A [B, N], U, V [B, N, R], P [B, N-1, R], y [B, N] or None; one floating
    dtype. Returns (D, W, z, S_saved, f_saved) as
    :func:`celerite_forward_plain`; W is None on the card unless
    ``want_w`` or ``save``. On a CUDA tensor one kernel launch on the
    current stream (no synchronise), a group of lanes a walker
    (:func:`kernel_geometry`); on a CPU tensor the plain version.
    """
    if _on_cpu(U):
        return celerite_forward_plain(A, U, V, P, y, save)
    b, n, r = U.shape
    _check_r(r)
    if n < 1 or b < 1:
        raise ValueError(f"celerite_forward needs B, N >= 1, got {tuple(U.shape)}")
    dtype = U.dtype
    _check("celerite_forward", {"A": A, "V": V, "P": P, "y": y}, dtype, U.device)
    if A.shape != (b, n) or V.shape != U.shape or P.shape != (b, n - 1, r) or (
            y is not None and y.shape != (b, n)):
        raise ValueError("celerite_forward: A [B, N], U, V [B, N, R], P [B, N-1, R], y [B, N]")
    A, U, V, P = (x.contiguous() for x in (A, U, V, P))
    y = None if y is None else y.contiguous()
    D = torch.empty_like(A)
    W = torch.empty_like(U) if (want_w or save) else None
    z = torch.empty_like(y) if y is not None else None
    k = r * (r + 1) // 2
    S_saved = U.new_empty((b, n - 1, k)) if save else None
    f_saved = U.new_empty((b, n - 1, r)) if save else None
    _launch("celerite_forward", _entry("celerite_forward", dtype), A, U, V, P, y, b, n, r, D, W,
            z, S_saved, f_saved)
    celerite_forward.launches += 1
    return D, W, z, S_saved, f_saved


celerite_forward.launches = 0


def celerite_adjoint(U, P, D, W, z, S_saved, f_saved, dD, dz):
    """G2: the adjoint of G1 with y, as :func:`celerite_adjoint_plain`. On
    a CUDA tensor one kernel launch on the current stream, on G1's lanes
    (:func:`kernel_geometry` with ``adjoint``); on a CPU tensor the plain
    version."""
    if _on_cpu(U):
        return celerite_adjoint_plain(U, P, D, W, z, S_saved, f_saved, dD, dz)
    b, n, r = U.shape
    _check_r(r)
    dtype = U.dtype
    _check("celerite_adjoint", {"P": P, "D": D, "W": W, "z": z, "S_saved": S_saved,
                                "f_saved": f_saved, "dD": dD, "dz": dz}, dtype, U.device)
    k = r * (r + 1) // 2
    if (P.shape != (b, n - 1, r) or D.shape != (b, n) or W.shape != U.shape
            or z.shape != (b, n) or S_saved.shape != (b, n - 1, k)
            or f_saved.shape != (b, n - 1, r) or dD.shape != (b, n) or dz.shape != (b, n)):
        raise ValueError("celerite_adjoint: shapes do not match G1's")
    args = [x.contiguous() for x in (U, P, D, W, z, S_saved, f_saved, dD, dz)]
    dA = U.new_empty((b, n))
    dU = U.new_empty((b, n, r))
    dV = U.new_empty((b, n, r))
    dP = U.new_empty((b, n - 1, r))
    dy = U.new_empty((b, n))
    _launch("celerite_adjoint", _entry("celerite_adjoint", dtype), *args, b, n, r, dA, dU, dV,
            dP, dy)
    celerite_adjoint.launches += 1
    return dA, dU, dV, dP, dy


celerite_adjoint.launches = 0


def celerite_solve(U, P, D, W, Y):
    """G3: x = K^{-1} Y for one system factored by G1. U, W [N, R], P
    [N-1, R], D [N], Y [N, K] (or [N]). On a CUDA tensor one kernel launch,
    a lane a column and 32 columns a block, the coefficients every column
    shares and each lane's column staged in shared memory ahead of the
    walk (:func:`kernel_geometry`); on a CPU tensor the plain version. Not
    differentiable on the card."""
    squeeze = Y.dim() == 1
    if squeeze:
        Y = Y[:, None]
    if _on_cpu(U):
        x = celerite_solve_plain(U, P, D, W, Y)
        return x[:, 0] if squeeze else x
    n, r = U.shape
    _check_r(r)
    dtype = U.dtype
    _check("celerite_solve", {"P": P, "D": D, "W": W, "Y": Y}, dtype, U.device)
    if P.shape != (n - 1, r) or D.shape != (n,) or W.shape != U.shape or Y.shape[0] != n:
        raise ValueError("celerite_solve: U, W [N, R], P [N-1, R], D [N], Y [N, K]")
    k = Y.shape[1]
    U, P, D, W, Y = (x.contiguous() for x in (U, P, D, W, Y))
    X = torch.empty_like(Y)
    if k:
        _launch("celerite_solve", _entry("celerite_solve", dtype), U, P, D, W, Y, n, r, k, X)
        celerite_solve.launches += 1
    return X[:, 0] if squeeze else X


celerite_solve.launches = 0


class CeleriteLikelihood(torch.autograd.Function):
    """(A, U, V, P, y) -> (D, z) through G1, with G2 as its backward. The
    saved state is written only when an input needs a gradient."""

    @staticmethod
    def forward(ctx, A, U, V, P, y):
        save = any(ctx.needs_input_grad)
        D, W, z, S_saved, f_saved = celerite_forward(A, U, V, P, y, save=save, want_w=False)
        if save:
            ctx.save_for_backward(U, P, D, W, z, S_saved, f_saved)
        return D, z

    @staticmethod
    def backward(ctx, dD, dz):
        U, P, D, W, z, S_saved, f_saved = ctx.saved_tensors
        dD = torch.zeros_like(D) if dD is None else dD
        dz = torch.zeros_like(z) if dz is None else dz
        return celerite_adjoint(U, P, D, W, z, S_saved, f_saved, dD, dz)
