"""The celerite kernels' layouts, rehearsed on the CPU.

G1 (``csrc/celerite.cu::celerite_forward_kernel``) walks a walker on a
group of G lanes, G the next power of two >= R: lane i owns row i of the
state S in full and its own u_i, v_i, p_i, W_i and f_i; lanes past R repeat
row R - 1. The sums across rows (u . Su for D, u . f for z) are taken by
every lane from the other lanes' products in the plain order. G2
(``celerite_adjoint_kernel``) walks it back on the same lanes, in tiles of
steps going down in t: lane i owns row i of the adjoint state G and of the
rebuilt S~ and S_t, the sums within a row stay on the lane, and the three
across rows come from the other lanes' products. G3
(``celerite_solve_kernel``) walks a column on one lane, row by row in tiles,
each row's update touching that row's coefficients only, and P's missing
row n - 1 read as zeros. Numpy replays all three, one operation at a time
in the kernels' order (numpy rounds every operation on its own, as
``__*_rn`` do), and the replays must equal the plain versions bit for bit:
R = 1..16, float32 and float64, with and without y and the saved state, one
sample, one step, a row whose D goes non-positive, tiles cut at every edge.
These tests check the designs' operation order, not the kernels: no line of
``csrc/celerite.cuh`` runs here. The kernels themselves are held against
the plain versions bit for bit on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py`` phase 27).
"""

import numpy as np
import pytest
import torch

from periodicity_tpu_torch.ops import celerite as C

DTYPES = [np.float32, np.float64]


def _draw(b, n, r, dtype, seed):
    rng = np.random.default_rng(seed)
    arrays = (rng.uniform(2, 4, (b, n)), 0.3 * rng.standard_normal((b, n, r)),
              0.3 * rng.standard_normal((b, n, r)), rng.uniform(0.5, 1, (b, n - 1, r)),
              rng.standard_normal((b, n)))
    return [a.astype(dtype) for a in arrays]


def _bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return (a.shape == b.shape and np.array_equal(np.isnan(a), np.isnan(b))
            and np.array_equal(np.nan_to_num(a, nan=0.0), np.nan_to_num(b, nan=0.0)))


def _lanes_forward(A, U, V, P, y, save):
    """G1 lane by lane: [b, G] arrays hold each lane's scalars, S [b, G, R]
    each lane's row. Returns what the plain version returns."""
    b, n, r = U.shape
    g = 1 << (r - 1).bit_length()
    ir = np.minimum(np.arange(g), r - 1)
    D = np.empty_like(A)
    W = np.empty_like(U)
    z = np.empty_like(y) if y is not None else None
    kk = r * (r + 1) // 2
    S_saved = np.empty((b, n - 1, kk), U.dtype) if save else None
    f_saved = np.empty((b, n - 1, r), U.dtype) if save else None
    iu, ju = np.triu_indices(r)
    d_prev = D[:, 0] = A[:, 0]
    w = V[:, 0][:, ir] / d_prev[:, None]  # each lane's own W
    W[:, 0] = w[:, :r]
    S = np.zeros((b, g, r), U.dtype)
    f = np.zeros((b, g), U.dtype)
    if y is not None:
        z_prev = z[:, 0] = y[:, 0]
    for t in range(1, n):
        p, u = P[:, t - 1], U[:, t]
        pi, ui = p[:, ir], u[:, ir]
        wp = w[:, :r]  # W of the step before, from lanes 0..R-1
        if save:
            # lane i writes its entries (i, j >= i) and its f
            S_saved[:, t - 1] = S[:, iu, ju]
            f_saved[:, t - 1] = f[:, :r]
        if y is not None:
            f = pi * (f + w * z_prev[:, None])
            qf = ui * f
            dotf = qf[:, 0]
            for j in range(1, r):
                dotf = dotf + qf[:, j]
            z_prev = z[:, t] = y[:, t] - dotf
        S = (pi[:, :, None] * p[:, None, :]) * (
            S + d_prev[:, None, None] * (w[:, :, None] * wp[:, None, :]))
        su = S[:, :, 0] * u[:, None, 0]
        for j in range(1, r):
            su = su + S[:, :, j] * u[:, None, j]
        q = ui * su
        dot = q[:, 0]
        for j in range(1, r):
            dot = dot + q[:, j]
        d = D[:, t] = A[:, t] - dot
        w = (V[:, t][:, ir] - su) / d[:, None]
        W[:, t] = w[:, :r]
        d_prev = d
        # a lane past R holds what lane R - 1 holds
        assert _bits(S[:, r - 1:], np.broadcast_to(S[:, r - 1:r], S[:, r - 1:].shape))
        assert _bits(w[:, r - 1:], np.broadcast_to(w[:, r - 1:r], w[:, r - 1:].shape))
    return D, W, z, S_saved, f_saved


def _rows_sum(x, r):
    """Every lane's sum of x [b, G] over lanes 0 .. R - 1, left to right."""
    acc = x[:, 0]
    for j in range(1, r):
        acc = acc + x[:, j]
    return acc


def _row_dot(a, b, r):
    """Each lane's sum over j of a[:, lane, j] * b[:, j], left to right."""
    acc = a[:, :, 0] * b[:, None, 0]
    for j in range(1, r):
        acc = acc + a[:, :, j] * b[:, None, j]
    return acc


def _lanes_adjoint(U, P, D, W, z, S_saved, f_saved, dD, dz):
    """G2 lane by lane: [b, G] arrays hold each lane's scalars, [b, G, R]
    each lane's row of G, S~ and S_t. The steps go down in t in tiles of 16
    (8 at R <= 2) staged as the kernel stages them: step t at k = t - t_lo,
    W and D from row t_lo - 1, S_saved unpacked into full rows. Returns what
    the plain version returns."""
    b, n, r = U.shape
    g = 1 << (r - 1).bit_length()
    ir = np.minimum(np.arange(g), r - 1)
    ts = 16 if r > 2 else 8
    _, _, full = C._unpack_index(r)
    half = U.dtype.type(0.5)
    dA, dy = np.empty_like(D), np.empty_like(D)
    dU, dV, dP = np.empty_like(U), np.empty_like(U), np.empty_like(P)
    G = np.zeros((b, g, r), U.dtype)
    wb = np.zeros((b, g), U.dtype)
    fb = np.zeros((b, g), U.dtype)
    db, zb = dD[:, n - 1], dz[:, n - 1]
    for m in range(-(-(n - 1) // ts)):
        t_hi = n - 1 - m * ts
        cnt = min(ts, t_hi)
        t_lo = t_hi - cnt + 1
        rows = slice(t_lo - 1, t_lo - 1 + cnt)  # the rows t - 1 of the tile's steps
        tU, tP, tF = U[:, t_lo:t_hi + 1], P[:, rows], f_saved[:, rows]
        tW, tD = W[:, t_lo - 1:t_hi + 1], D[:, t_lo - 1:t_hi + 1]
        tZ, tDD, tDZ = z[:, rows], dD[:, rows], dz[:, rows]
        tS = S_saved[:, rows][:, :, full]
        oU, oV, oP = (np.empty((b, cnt, r), U.dtype) for _ in range(3))
        oY, oA = np.empty((b, cnt), U.dtype), np.empty((b, cnt), U.dtype)
        for k in range(cnt - 1, -1, -1):
            u, p, wp = tU[:, k], tP[:, k], tW[:, k]
            ui, pi, wpi, wi = u[:, ir], p[:, ir], wp[:, ir], tW[:, k + 1][:, ir]
            d_prev, d, z_prev = tD[:, k], tD[:, k + 1], tZ[:, k]
            st = tS[:, k][:, ir] + d_prev[:, None, None] * (wpi[:, :, None] * wp[:, None, :])
            sn = (pi[:, :, None] * p[:, None, :]) * st
            su = _row_dot(sn, u, r)
            ft = tF[:, k][:, ir] + wpi * z_prev[:, None]
            oY[:, k] = zb
            nzb = -zb
            ub = nzb[:, None] * (pi * ft)
            fb = fb + nzb[:, None] * ui
            pb = fb * ft
            ftb = fb * pi
            wb_prev = ftb * z_prev[:, None]
            zb_prev = tDZ[:, k] + _rows_sum(ftb * wpi, r)
            vb = wb / d[:, None]
            oV[:, k] = vb[:, :r]
            db = db - _rows_sum(wb * wi, r) / d
            oA[:, k] = db
            ub = ub - db[:, None] * su
            sub = -vb - db[:, None] * ui
            sj = sub[:, :r]  # sub of lanes 0 .. R - 1, to every lane
            oU[:, k] = (ub + _row_dot(sn, sj, r))[:, :r]
            G = G + (sub[:, :, None] * u[:, None, :] + ui[:, :, None] * sj[:, None, :]) * half
            rp = _row_dot(G * st, p, r)
            oP[:, k] = (pb + (rp + rp))[:, :r]
            G = G * (pi[:, :, None] * p[:, None, :])
            q = _row_dot(G, wp, r)
            db = tDD[:, k] + _rows_sum(wpi * q, r)
            wb = wb_prev + d_prev[:, None] * (q + q)
            fb, zb = ftb, zb_prev
            # a lane past R holds what lane R - 1 holds
            assert _bits(G[:, r - 1:], np.broadcast_to(G[:, r - 1:r], G[:, r - 1:].shape))
            assert _bits(wb[:, r - 1:], np.broadcast_to(wb[:, r - 1:r], wb[:, r - 1:].shape))
        dU[:, t_lo:t_hi + 1], dV[:, t_lo:t_hi + 1], dP[:, rows] = oU, oV, oP
        dy[:, t_lo:t_hi + 1], dA[:, t_lo:t_hi + 1] = oY, oA
    # t = 0
    dy[:, 0] = zb
    dV[:, 0] = (wb / D[:, 0, None])[:, :r]
    dA[:, 0] = db - _rows_sum(wb * W[:, 0][:, ir], r) / D[:, 0]
    dU[:, 0] = 0
    return dA, dU, dV, dP, dy


def _tiled_solve(U, P, D, W, Y, tile):
    """G3 row by row, in tiles of ``tile`` rows, forward then backward with
    the tiles in reverse; P's row n - 1 reads as zeros."""
    n, r = U.shape
    Pz = np.concatenate([P, np.zeros((1, r), P.dtype)])
    X = np.empty_like(Y)
    f = np.zeros((Y.shape[1], r), U.dtype)
    tiles = -(-n // tile)
    for m in range(tiles):
        for row in range(m * tile, min(n, (m + 1) * tile)):
            dotf = U[row, 0] * f[:, 0]
            for j in range(1, r):
                dotf = dotf + U[row, j] * f[:, j]
            zr = Y[row] if row == 0 else Y[row] - dotf
            X[row] = zr / D[row]
            f = Pz[row] * (f + W[row] * zr[:, None])
    g = np.zeros_like(f)
    for m in range(tiles - 1, -1, -1):
        for row in range(min(n, (m + 1) * tile) - 1, m * tile - 1, -1):
            g = Pz[row] * g
            dotg = W[row, 0] * g[:, 0]
            for j in range(1, r):
                dotg = dotg + W[row, j] * g[:, j]
            x = X[row] - dotg if row + 1 < n else X[row]
            X[row] = x
            g = g + U[row] * x[:, None]
    return X


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("r", range(1, C.MAX_R + 1))
@pytest.mark.parametrize("n", [1, 2, 300])
def test_g1_lane_order_is_the_plain_order(n, r, dtype):
    # 5 walkers (a partial block at R <= 4); one sample (no step), one step,
    # and 300 steps with a row whose D goes non-positive
    A, U, V, P, y = _draw(5, n, r, dtype, 100 * n + r)
    if n > 40:
        A[1, 40] = -1.0
    for yy, save in ((y, True), (None, True), (y, False), (None, False)):
        got = _lanes_forward(A, U, V, P, yy, save)
        want = C.celerite_forward_plain(*(None if x is None else torch.from_numpy(x)
                                          for x in (A, U, V, P, yy)), save=save)
        for name, a, w in zip(("D", "W", "z", "S_saved", "f_saved"), got, want):
            assert (a is None) == (w is None), name
            if a is not None:
                assert _bits(a, w.numpy()), (name, yy is not None, save)
    if n > 40:
        D = _lanes_forward(A, U, V, P, y, False)[0]
        assert (D[1, 40:] <= 0).any() or np.isnan(D[1, 40:]).any()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("r", range(1, C.MAX_R + 1))
def test_g3_row_local_tiled_walk_is_the_plain_order(r, dtype):
    rng = np.random.default_rng(r)
    for n in (1, 2, 31, 32, 33, 65):
        A, U, V, P, _ = _draw(1, n, r, dtype, 7 * n + r)
        D, W, *_ = C.celerite_forward_plain(*(torch.from_numpy(x) for x in (A, U, V, P)))
        D, W = D[0].numpy(), W[0].numpy()
        for k in (1, 3):
            Y = rng.standard_normal((n, k)).astype(dtype)
            want = C.celerite_solve_plain(torch.from_numpy(U[0]), torch.from_numpy(P[0]),
                                          torch.from_numpy(D), torch.from_numpy(W),
                                          torch.from_numpy(Y)).numpy()
            assert _bits(_tiled_solve(U[0], P[0], D, W, Y, 32), want), (n, k)
    # Y's sign of zero on row 0 passes through (no sum is subtracted there)
    A, U, V, P, _ = _draw(1, 4, r, dtype, 3)
    D, W, *_ = C.celerite_forward_plain(*(torch.from_numpy(x) for x in (A, U, V, P)))
    Y = np.array([[-0.0], [1.0], [-2.0], [0.5]], dtype)
    got = _tiled_solve(U[0], P[0], D[0].numpy(), W[0].numpy(), Y, 32)
    want = C.celerite_solve_plain(torch.from_numpy(U[0]), torch.from_numpy(P[0]), D[0], W[0],
                                  torch.from_numpy(Y)).numpy()
    assert _bits(got, want) and np.signbit(got[0, 0]) == np.signbit(want[0, 0])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("r", range(1, C.MAX_R + 1))
@pytest.mark.parametrize("n", [1, 2, 17, 300])
def test_g2_lane_order_is_the_plain_order(n, r, dtype):
    # 5 walkers; one sample (no step), one step, 16 steps (one full tile of
    # 16, two of 8), and 299 steps ending in a partial tile, with a row
    # whose D goes non-positive (NaN for NaN)
    A, U, V, P, y = _draw(5, n, r, dtype, 300 * n + r)
    if n > 40:
        A[1, 40] = -1.0
    fwd = C.celerite_forward_plain(*(torch.from_numpy(x) for x in (A, U, V, P, y)), save=True)
    rng = np.random.default_rng(n + r)
    dD, dz = (torch.from_numpy(rng.standard_normal((5, n)).astype(dtype)) for _ in range(2))
    args = (torch.from_numpy(U), torch.from_numpy(P), *fwd, dD, dz)
    want = C.celerite_adjoint_plain(*args)
    got = _lanes_adjoint(*(x.numpy() for x in args))
    for name, a, w in zip(("dA", "dU", "dV", "dP", "dy"), got, want):
        assert _bits(a, w.numpy()), name
    if n > 40:
        assert (fwd[0][1, 40:] <= 0).any() or torch.isnan(fwd[0][1, 40:]).any()
