"""K1's lane order, rehearsed on the CPU.

``csrc/kalman.cu`` spreads each composition of filtering elements over a
group of G lanes, G the next power of two >= R. The solve of M X = [Aj^T |
etaj - Jj bi | Jj Ai] runs a column a lane: lane i holds column i of M, of
Aj^T and of Jj Ai, every lane the column etaj - Jj bi. At each step of the
pivoted elimination the pivot column comes from its lane (__shfl_sync, here
an index read), and every lane takes the same first maximal |value| in
ascending row order, swaps the same two rows of its columns at or right of
the pivot, forms the same multipliers and updates its own columns. The back
substitution reads the eliminated M from the lanes that hold its columns
and solves the lane's own: m1t's row i on lane i, m2 on every lane, m3's
column i on lane i. Lane i then writes row i of A, b, C, eta and column i
of J. Around the compositions: stage 0 builds every position's element a
group a position (lane i a row), stage 1 walks each block from the
identity and keeps every prefix, stage 2 scans the block summaries (after
the incoming carry, when there is one) in ceil(log2) levels, x[i] =
x[i - 2^d] o x[i], and stage 3 forms each position's filtered (b, C) from
its block's exclusive carry and its prefix with the solve's m1t columns
alone, then the predicted mean and variance, the sums across rows taken
from the other lanes' values in the plain order.

Numpy replays those stages lane by lane, one operation at a time in the
kernel's order (numpy rounds every operation on its own, as ``__*_rn``
do), and the replay must equal ``kalman_blocked_plain`` bit for bit: R =
1..8, float32 and float64, 1, 2, 3, 5, 16, 39 and 64 blocks, N divisible by
the block count and not, N below it, from the identity and from a carry.
These tests check the design's operation order, not the kernel: no line of
``csrc/kalman.cu`` runs here. The kernel itself is held against the plain
version bit for bit on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py`` phase 31).
"""

import numpy as np
import pytest
import torch

from chip_smoke import k1_draw
from periodicity_tpu_torch.models.gp import pscan
from periodicity_tpu_torch.ops import kalman as K

# (B, N, n_blocks): every block count with N divisible by it, N not
# divisible, and N below it (empty blocks)
SHAPES = [(2, 3, 1), (1, 1, 1), (2, 6, 2), (1, 7, 2), (1, 1, 2), (1, 23, 3), (2, 9, 3),
          (2, 10, 5), (1, 13, 5), (1, 4, 5), (1, 32, 16), (2, 35, 16), (1, 9, 16), (1, 78, 39),
          (1, 80, 39), (1, 20, 39), (1, 128, 64), (1, 130, 64), (2, 63, 64)]
# past R = 8 (16 lanes a group) the same cuts at shorter lengths, so the
# replay keeps to seconds: N divisible, not, and below the block count
SHAPES_WIDE = [(2, 3, 1), (1, 1, 2), (2, 9, 3), (1, 13, 5), (1, 9, 16), (2, 35, 16),
               (1, 20, 39)]


def _bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    view = np.int32 if a.dtype == np.float32 else np.int64
    na, nb = np.isnan(a), np.isnan(b)
    return np.array_equal(na, nb) and np.array_equal(a.view(view)[~na], b.view(view)[~nb])


class Pack:
    """Offsets in a packed element (A, b, C, eta, J, each row-major) and a
    group's lanes: ``ir`` the row each lane owns (lanes past R repeat row
    R - 1 and write nothing)."""

    def __init__(self, r):
        self.r = r
        self.A, self.B, self.C = 0, r * r, r * r + r
        self.ETA, self.J, self.S = 2 * r * r + r, 2 * r * r + 2 * r, 3 * r * r + 2 * r
        self.G = 1 << (r - 1).bit_length()
        self.ir = np.minimum(np.arange(self.G), r - 1)

    def mat(self, rec, at):
        return rec[:, at:at + self.r * self.r].reshape(-1, self.r, self.r)

    def rows(self, rec, at):
        """Each lane's own row i of the matrix at ``at``: [M, G, R]."""
        return rec[:, at + self.ir[:, None] * self.r + np.arange(self.r)[None, :]]


def _one(dtype, ir, j):
    return np.where(ir == j, dtype.type(1), dtype.type(0)).astype(dtype)


def _element_lanes(a, q, H, d, y, pk):
    """Stage 0 lane by lane: a, q [M, R, R], d, y [M] -> records [M, S]."""
    r, ir = pk.r, pk.ir
    dt = a.dtype
    qh = q[:, ir, 0] * H[0]
    for j in range(1, r):
        qh = qh + q[:, ir, j] * H[j]
    hqh = H[0] * qh[:, :1]  # lane k's qh by a shuffle, the same sum on every lane
    for k in range(1, r):
        hqh = hqh + H[k] * qh[:, k:k + 1]
    hqh = hqh + d[:, None]
    kk = qh / hqh
    imkh = np.stack([_one(dt, ir, j)[None] - kk * H[j] for j in range(r)], axis=-1)
    ha = a[:, 0, ir] * H[0]
    for k in range(1, r):
        ha = ha + a[:, k, ir] * H[k]
    ry = y[:, None] / hqh
    out = np.empty((a.shape[0], pk.S), dt)
    accA = imkh[..., 0, None] * a[:, None, 0, :]
    accC = imkh[..., 0, None] * q[:, None, 0, :]
    for l in range(1, r):
        accA = accA + imkh[..., l, None] * a[:, None, l, :]
        accC = accC + imkh[..., l, None] * q[:, None, l, :]
    jj = (ha[:, :, None] * ha[:, None, :r]) / hqh[:, :, None]
    out[:, pk.A:pk.B] = accA[:, :r].reshape(-1, r * r)
    out[:, pk.C:pk.ETA] = accC[:, :r].reshape(-1, r * r)
    out[:, pk.J:] = jj[:, :r].reshape(-1, r * r)
    out[:, pk.B:pk.C] = (kk * y[:, None])[:, :r]
    out[:, pk.ETA:pk.J] = (ha * ry)[:, :r]
    return out


def _swap(x, col, p, lanes=None):
    """Rows col and p (per composition) of each lane's column x [M, G, R],
    on the lanes selected (all by default)."""
    at = np.arange(x.shape[0])
    a, b = x[at, :, col].copy(), x[at, :, p].copy()
    if lanes is not None:
        a, b = np.where(lanes[None], b, a), np.where(lanes[None], a, b)
    else:
        a, b = b, a
    x[at, :, col] = a
    x[at, :, p] = b


def _compose_lanes(ei, ej, pk, full):
    """ei o ej on groups of lanes: records [M, S] each. Returns the record
    [M, S], or without ``full`` the filtered (b [M, R], C [M, R, R]). The
    solve runs a column a lane: [M, G, R] arrays hold each lane's column
    (row index last)."""
    r, ir, G = pk.r, pk.ir, pk.G
    m = ei.shape[0]
    dt = ei.dtype
    Ci, Ai, Aj, Jj = pk.mat(ei, pk.C), pk.mat(ei, pk.A), pk.mat(ej, pk.A), pk.mat(ej, pk.J)
    bi = ei[:, pk.B:pk.C]
    etaj = ej[:, pk.ETA:pk.J]
    cc = np.swapaxes(Ci[:, :, ir], 1, 2)  # each lane's column ir of Ci
    ai = np.swapaxes(Ai[:, :, ir], 1, 2)
    mc = np.empty((m, G, r), dt)
    ac = np.empty((m, G, r), dt)
    vc = np.empty((m, G, r), dt)
    gc = np.empty((m, G, r), dt)
    for rr in range(r):
        acc = Jj[:, rr, 0, None] * cc[..., 0]
        for l in range(1, r):
            acc = acc + Jj[:, rr, l, None] * cc[..., l]
        mc[..., rr] = _one(dt, ir, rr)[None] + acc
        ac[..., rr] = Aj[:, ir, rr]
        if full:
            jb = Jj[:, rr, 0, None] * bi[:, None, 0]
            g = Jj[:, rr, 0, None] * ai[..., 0]
            for l in range(1, r):
                jb = jb + Jj[:, rr, l, None] * bi[:, None, l]
                g = g + Jj[:, rr, l, None] * ai[..., l]
            vc[..., rr] = etaj[:, rr, None] - jb
            gc[..., rr] = g
    t1 = Ci[:, ir, 0] * etaj[:, None, 0]
    for l in range(1, r):
        t1 = t1 + Ci[:, ir, l] * etaj[:, None, l]
    t1 = bi[:, ir] + t1

    # elimination: the pivot column from its lane (a shuffle, here an index
    # read), the same pivot, swap and multipliers on every lane
    for col in range(r - 1):
        pc = mc[:, col].copy()  # lane col's column
        best = np.abs(pc[:, col])
        p = np.full(m, col)
        for k in range(col + 1, r):
            v = np.abs(pc[:, k])
            take = v > best
            best = np.where(take, v, best)
            p = np.where(take, k, p)
        _swap(pc[:, None], col, p)
        _swap(mc, col, p, ir >= col)
        for x in (ac, vc, gc) if full else (ac,):
            _swap(x, col, p)
        own = (ir > col)[None]
        for rr in range(col + 1, r):
            f = (pc[:, rr] / pc[:, col])[:, None]
            mc[..., rr] = np.where(own, mc[..., rr] - f * mc[..., col], mc[..., rr])
            for x in (ac, vc, gc) if full else (ac,):
                x[..., rr] = x[..., rr] - f * x[..., col]

    # back substitution of each lane's columns, the eliminated M's row rr
    # from its lanes (lane j's column holds M[rr, j])
    x0 = np.empty((m, G, r), dt)
    x1 = np.empty((m, G, r), dt)
    x2 = np.empty((m, G, r), dt)
    for rr in range(r - 1, -1, -1):
        s0, s1, s2 = ac[..., rr], vc[..., rr], gc[..., rr]
        for j in range(rr + 1, r):
            u = mc[:, j, rr, None]
            s0 = s0 - u * x0[..., j]
            if full:
                s1 = s1 - u * x1[..., j]
                s2 = s2 - u * x2[..., j]
        dd = mc[:, rr, rr, None]
        x0[..., rr] = s0 / dd
        if full:
            x1[..., rr] = s1 / dd
            x2[..., rr] = s2 / dd

    bn = x0[..., 0] * t1[:, None, 0]  # lane k's t1 by a shuffle
    for k in range(1, r):
        bn = bn + x0[..., k] * t1[:, None, k]
    bn = bn + ej[:, pk.B + ir]
    t2 = [None] * r
    for l in range(r):
        acc = x0[..., 0] * Ci[:, None, 0, l]
        for k in range(1, r):
            acc = acc + x0[..., k] * Ci[:, None, k, l]
        t2[l] = acc
    Cj = pk.rows(ej, pk.C)
    cn = np.empty((m, G, r), dt)
    for j in range(r):
        acc = t2[0] * Aj[:, None, j, 0]
        for l in range(1, r):
            acc = acc + t2[l] * Aj[:, None, j, l]
        cn[..., j] = acc + Cj[..., j]
    if not full:
        return bn[:, :r], cn[:, :r]
    an = np.empty((m, G, r), dt)
    for j in range(r):
        acc = x0[..., 0] * Ai[:, None, 0, j]
        for k in range(1, r):
            acc = acc + x0[..., k] * Ai[:, None, k, j]
        an[..., j] = acc
    et = Ai[:, 0, ir] * x1[..., 0]
    for j in range(1, r):
        et = et + Ai[:, j, ir] * x1[..., j]
    et = et + ei[:, pk.ETA + ir]
    jn = np.empty((m, G, r), dt)  # lane c's column c of J
    for rr in range(r):
        acc = Ai[:, 0, rr, None] * x2[..., 0]
        for j in range(1, r):
            acc = acc + Ai[:, j, rr, None] * x2[..., j]
        jn[..., rr] = acc + ei[:, pk.J + rr * r + ir]
    out = np.empty_like(ei)
    out[:, pk.A:pk.B] = an[:, :r].reshape(m, -1)
    out[:, pk.B:pk.C] = bn[:, :r]
    out[:, pk.C:pk.ETA] = cn[:, :r].reshape(m, -1)
    out[:, pk.ETA:pk.J] = et[:, :r]
    out[:, pk.J:] = np.swapaxes(jn[:, :r], 1, 2).reshape(m, -1)
    return out


def _innovation_lanes(a, q, H, d, fb, fC, pk):
    """mu and s at M positions, lane by lane, the sums over rows from the
    other lanes' values in the plain order."""
    r, ir = pk.r, pk.ir
    ar = a[:, ir, :]
    mi = ar[..., 0] * fb[:, None, 0]
    for k in range(1, r):
        mi = mi + ar[..., k] * fb[:, None, k]
    t = []
    for l in range(r):
        acc = ar[..., 0] * fC[:, None, 0, l]
        for k in range(1, r):
            acc = acc + ar[..., k] * fC[:, None, k, l]
        t.append(acc)
    ph = None
    for j in range(r):
        acc = t[0] * a[:, None, j, 0]
        for l in range(1, r):
            acc = acc + t[l] * a[:, None, j, l]
        acc = acc + q[:, ir, j]
        ph = acc * H[0] if j == 0 else ph + acc * H[j]
    mu = H[0] * mi[:, 0]
    s = H[0] * ph[:, 0]
    for k in range(1, r):
        mu = mu + H[k] * mi[:, k]
        s = s + H[k] * ph[:, k]
    return mu, s + d


def _blocked_lanes(A, Q, H, diag, y, nb, carry):
    """K1's four stages on groups of lanes (numpy arrays; ``carry`` packed
    [B, S] or None). Returns (mu, s, the packed outgoing carry)."""
    b, n, r, _ = A.shape
    pk = Pack(r)
    dt = A.dtype
    length, m = K.block_geometry(n, nb)
    flat = lambda x: x.reshape((b * n,) + x.shape[2:])  # noqa: E731
    with np.errstate(all="ignore"):
        elems = _element_lanes(flat(A), flat(Q), H, flat(diag), flat(y), pk)
        # stage 1: a chain (row, block) walks its positions from the identity
        lo = (np.arange(b)[:, None] * n + np.arange(m)[None, :] * length).reshape(-1)
        cnt = np.tile(np.minimum(length, n - np.arange(m) * length), b)
        state = np.zeros((b * m, pk.S), dt)
        state[:, pk.A:pk.B] = np.eye(r, dtype=dt).reshape(-1)
        for s in range(length):
            live = s < cnt
            at = lo[live] + s
            new = _compose_lanes(state[live], elems[at], pk, True)
            state[live] = new
            elems[at] = new
        # stage 2: the leaves (carry, each block's last prefix), then levels
        leaves = m + (carry is not None)

        def leaf(x):
            row, j = x // leaves, x % leaves
            if carry is not None:
                out = np.empty((x.size, pk.S), dt)
                first = j == 0
                out[first] = carry[row[first]]
                jj = j[~first] - 1
                out[~first] = elems[row[~first] * n + np.minimum((jj + 1) * length, n) - 1]
                return out
            return elems[row * n + np.minimum((j + 1) * length, n) - 1]

        items = np.arange(b * leaves)
        tree = leaf(items)
        levels = K.tree_levels(leaves)
        for d in range(levels):
            h = 1 << d
            nxt = tree.copy()
            comp = items % leaves >= h
            nxt[comp] = _compose_lanes(tree[items[comp] - h], tree[comp], pk, True)
            tree = nxt
        carry_out = tree[items % leaves == leaves - 1]
        # stage 3: a group a position
        p = np.arange(b * n)
        row, pp = p // n, p % n
        fb = np.zeros((b * n, r), dt)
        fC = np.zeros((b * n, r, r), dt)
        if carry is not None:
            fb[pp == 0] = carry[row[pp == 0], pk.B:pk.C]
            fC[pp == 0] = carry[row[pp == 0], pk.C:pk.ETA].reshape(-1, r, r)
        j = (pp - 1) // length - (carry is None)
        alone = (pp > 0) & (j < 0)
        fb[alone] = elems[p[alone] - 1, pk.B:pk.C]
        fC[alone] = pk.mat(elems[p[alone] - 1], pk.C)
        st = (pp > 0) & (j >= 0)
        if st.any():
            fb[st], fC[st] = _compose_lanes(tree[row[st] * leaves + j[st]], elems[p[st] - 1], pk,
                                            False)
        mu, s = _innovation_lanes(flat(A), flat(Q), H, flat(diag), fb, fC, pk)
    return mu.reshape(b, n), s.reshape(b, n), carry_out


@pytest.mark.parametrize("with_carry", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("r", range(1, K.MAX_R + 1))
def test_k1_lane_order_is_the_plain_order(r, dtype, with_carry):
    rng = np.random.default_rng(100 + r)
    for b, n, nb in SHAPES if r <= 8 else SHAPES_WIDE:
        coeffs, dt, A, Q, H, diag, y = k1_draw(rng, r, b, n, dtype)
        carry = None
        if with_carry:
            # the same stretch continuing a series: a first stretch's carry,
            # no stationary prior at step 0
            _, _, carry = K.kalman_blocked_plain(A, Q, H, diag, y, 3)
            A = pscan._ssm_from_dt(coeffs, dt)[0]
            Q = pscan._noise(A, pscan._ssm_from_dt(coeffs, dt)[1])
        args = [x.contiguous() for x in (A, Q, H, diag, y)]
        want = K.kalman_blocked_plain(*args, nb, carry)
        got = _blocked_lanes(*(x.numpy() for x in args), nb,
                             None if carry is None else K.pack_carry(carry).numpy())
        label = f"R={r}, {dtype}, B={b}, N={n}, {nb} blocks, carry={with_carry}"
        assert _bits(got[0], want[0].numpy()), f"mu differs: {label}"
        assert _bits(got[1], want[1].numpy()), f"s differs: {label}"
        assert _bits(got[2], K.pack_carry(want[2]).numpy()), f"carry differs: {label}"


def test_k1_geometry_helpers():
    """L, m and the scan's levels as the kernel computes them: blocks past
    the series' end are left out, and the levels are ceil(log2)."""
    assert K.block_geometry(100_000, 390) == (257, 390)
    assert K.block_geometry(10_000, 39) == (257, 39)
    assert K.block_geometry(5, 16) == (1, 5)
    assert K.block_geometry(9, 4) == (3, 3)
    assert K.block_geometry(65536, 512) == (128, 512)
    assert [K.tree_levels(k) for k in (1, 2, 3, 4, 5, 39, 391, 512, 513)] == [
        0, 1, 2, 2, 3, 6, 9, 9, 10]
