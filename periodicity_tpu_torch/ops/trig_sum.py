"""Press-Rybicki fast trig sums in PyTorch.

Port of ``periodicity_tpu/ops/trig_sum.py``. Computes, for a uniform
frequency grid f_j = fmin + j*df (j < nf):

    S_j = sum_i w_i sin(2 pi f_j t_i)
    C_j = sum_i w_i cos(2 pi f_j t_i)

in O(N + nfft log nfft) by Lagrange extirpolation of the samples onto a
power-of-two grid followed by one complex IFFT (Press & Rybicki 1989).

Numerics follow the JAX package cast for cast: the scalars ``df`` and
``fmin`` enter the working dtype at the same points, positions carry a
Dekker two-product compensation so float32 offsets stay accurate over
long baselines, and ``%`` is the floored modulus (``torch.remainder``).
The two-product relies on every product and difference being rounded on
its own; eager PyTorch runs each elementwise op as its own kernel, so
nothing here may be fused (no ``addcmul``, no ``torch.compile``).

Gridders: ``"scatter"`` is the plain ``index_add_`` spreading on any
device; ``"kernel"`` (alias ``"pallas"``, the JAX package's name) runs
the hand-written CUDA kernel for float32 grids of at least 512 cells and
needs time-sorted samples on a non-wrapping grid (df * baseline < 1).

``trig_sum_batch`` and ``trig_sum_batch_pair`` take B weight rows sharing
one time grid through one ``index_add_`` of (tap x re/im x row)-packed
rows, the counterpart of the JAX package's XLA row scatter.
"""

import math

import torch

from ..utils.dtypes import complex_dtype, result_dtype
from .grid2 import extirpolate_grid_factored, extirpolate_grid_factored_plain

__all__ = ["trig_sum", "trig_sum_batch", "trig_sum_batch_pair", "trig_sum_pair", "grid_size"]


def grid_size(nf, n=5):
    """Power-of-two extirpolation grid size (reference spectral.py:18)."""
    return 1 << int(nf * n - 1).bit_length()


def _resolve_gridder(gridder, device):
    """Canonical gridder name; ``"kernel"`` needs a CUDA tensor."""
    if gridder == "pallas":
        gridder = "kernel"
    if gridder not in ("scatter", "kernel"):
        raise ValueError(f"gridder must be 'scatter' or 'kernel', got {gridder!r}")
    if gridder == "kernel" and device.type != "cuda":
        raise ValueError(f"gridder='kernel' needs CUDA tensors, got {device}")
    return gridder


def _two_prod(a, b):
    """Dekker two-product: a*b = p + err exactly (each op rounded alone)."""
    p = a * b
    # split constant: 2^ceil(mantissa/2)+1
    shift = 4097.0 if a.dtype == torch.float32 else 134217729.0
    ac = a * shift
    ah = ac - (ac - a)
    al = a - ah
    bc = b * shift
    bh = bc - (bc - b)
    bl = b - bh
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def _scalar(x, dtype, device):
    """0-d tensor of ``x`` rounded to ``dtype``, made on the device (no
    host-to-device copy, so no stream synchronisation)."""
    return torch.full((), x, dtype=dtype, device=device)


def _phase_factor(a, b, dtype, cdtype):
    """exp(2*pi*i * a * b) with the product reduced mod 1 in compensated
    arithmetic, accurate to ~1e-7 rad in float32 whatever |a*b|. ``a`` a
    Python scalar, ``b`` a tensor of ``dtype``."""
    a = _scalar(a, dtype, b.device)
    p, e = _two_prod(a, b)
    frac = torch.remainder(p, 1.0) + e
    ang = (2 * math.pi) * frac
    return torch.complex(torch.cos(ang), torch.sin(ang)).to(cdtype)


def _grid_rotation(tmin, df, fmin, nf, dtype, cdtype):
    """Post-rotation exp(2*pi*i * tmin * (fmin + df*j)) for j < nf with
    compensated mod-1 phase. ``tmin`` a 0-d tensor of ``dtype``."""
    device = tmin.device
    j = torch.arange(nf, dtype=dtype, device=device)
    h1, l1 = _two_prod(tmin, _scalar(fmin, dtype, device))
    h2, l2 = _two_prod(tmin, _scalar(df, dtype, device))
    p, e = _two_prod(h2, j)
    frac = torch.remainder(p, 1.0) + (
        torch.remainder(h1, 1.0) + (e + (l1 + l2 * j))
    )
    ang = (2 * math.pi) * frac
    return torch.complex(torch.cos(ang), torch.sin(ang)).to(cdtype)


def _extirpolate_weights(trel, df, nfft, dtype, taps=4):
    """Positions + ``taps``-point Lagrange weights for spreading samples
    onto the oversampled grid. Returns (inds [N, taps] int64,
    lagrange [N, taps])."""
    device = trel.device
    scale = _scalar(df, dtype, device) * nfft
    tnorm, terr = _two_prod(trel, scale)
    tnorm = torch.remainder(tnorm, nfft) + terr
    half = taps // 2
    ilo = torch.clamp(
        torch.floor(tnorm - (half - 1) - 1.0).to(torch.int32), 0, nfft - taps
    )
    frac = tnorm - ilo
    offs = torch.arange(taps, dtype=dtype, device=device)
    d = frac[:, None] - offs[None, :]
    prod_all = d[:, 0]
    for j in range(1, taps):
        prod_all = prod_all * d[:, j]
    denom = [
        ((-1.0) ** (taps - 1 - j)) * math.factorial(j) * math.factorial(taps - 1 - j)
        for j in range(taps)
    ]
    is_int = torch.abs(d) < 1e-12
    safe_d = torch.where(is_int, torch.ones_like(d), d)
    scaled = torch.stack([denom[j] * safe_d[:, j] for j in range(taps)], dim=1)
    lagrange = prod_all[:, None] / scaled
    lagrange = torch.where(
        is_int.any(dim=1, keepdim=True), is_int.to(dtype), lagrange
    )
    inds = torch.remainder(
        ilo.to(torch.int64)[:, None] + torch.arange(taps, device=device)[None, :], nfft
    )
    return inds, lagrange


def _grid(u, inds, lag, nfft, gridder):
    """Complex extirpolation grid [nfft], as the IFFT reads it. The kernel
    runs for float32 grids of at least 512 cells and writes the complex64
    grid itself; float64 pipelines keep the plain spreading, so
    ``gridder="kernel"`` never demotes a float64 computation. ``inds``
    never wraps (the bases are clamped to nfft - taps), so both gridders
    spread from the base column alone."""
    ilo = inds[:, 0]
    if gridder == "kernel" and nfft >= 512 and u.real.dtype == torch.float32:
        return extirpolate_grid_factored(
            ilo.to(torch.int32).contiguous(), u.real.contiguous(),
            u.imag.contiguous(), lag.contiguous(), nfft, as_complex=True,
        )
    return extirpolate_grid_factored_plain(ilo, u.real, u.imag, lag, nfft, as_complex=True)


def trig_sum_pair(t, w1, w2, df, nf, fmin, nfft=None, n=5, q=1,
                  gridder="scatter", taps=4):
    """Two trig sums over REAL weights at the same grid from ONE
    extirpolation + FFT.

    When ``2*fmin/df`` is an integer ``q`` (the GLS default grid has
    fmin = df/2, i.e. q = 1), the extirpolated spectrum of real weights is
    conjugate-symmetric about the wrap, so the complex packed weights
    u = w1 + i*w2 give both sums:

        G1[k] = (G[k] + conj(G[nfft - k - q])) / 2
        G2[k] = (G[k] - conj(G[nfft - k - q])) / (2i)

    t, w1, w2: tensors [N] on one device. df, fmin: Python scalars.
    Returns (S1, C1, S2, C2), each [nf].
    """
    if nfft is None:
        nfft = grid_size(nf, n)
    if not 1 <= q <= nfft - nf:
        raise ValueError(
            f"pairing needs 1 <= q <= nfft - nf (q={q}, nf={nf}, "
            f"nfft={nfft}); use the unpaired kernels"
        )
    gridder = _resolve_gridder(gridder, t.device)
    dtype = result_dtype(t, w1, w2)
    cdtype = complex_dtype(dtype)
    t = t.to(dtype)
    tmin = t.min()
    trel = t - tmin
    rot = _phase_factor(fmin, trel, dtype, cdtype)
    u = torch.complex(w1.to(dtype), w2.to(dtype)) * rot
    inds, lag = _extirpolate_weights(trel, df, nfft, dtype, taps=taps)
    G = nfft * torch.fft.ifft(_grid(u, inds, lag, nfft, gridder))
    # indices nfft - k - q for k in [0, nf): a contiguous descending range
    back = torch.flip(torch.conj(G[nfft - q - nf + 1: nfft - q + 1]), dims=(0,))
    G1 = 0.5 * (G[:nf] + back)
    G2 = -0.5j * (G[:nf] - back)
    post = _grid_rotation(tmin, df, fmin, nf, dtype, cdtype)
    G1 = G1 * post
    G2 = G2 * post
    return G1.imag, G1.real, G2.imag, G2.real


def _batch_row_grid(u_rows, trel, df, nfft, dtype, taps=4):
    """Complex grids [B, nfft] of B complex weight rows on one time grid:
    ONE ``index_add_`` of N bases whose rows pack (tap x re/im x row) =
    2*taps*B values onto an (nfft + taps)-row grid, then the tap blocks
    recombined by shifted slices. Bases never wrap (they are clamped to
    nfft - taps), so any sample order is summed correctly."""
    b = u_rows.shape[0]
    inds, lag = _extirpolate_weights(trel, df, nfft, dtype, taps=taps)
    ur = u_rows.real.T
    ui = u_rows.imag.T
    rows = torch.cat(
        [torch.cat([lag[:, j:j + 1] * ur, lag[:, j:j + 1] * ui], dim=1) for j in range(taps)],
        dim=1,
    )  # [N, taps * 2B]
    grid = torch.zeros(nfft + taps, 2 * taps * b, dtype=dtype, device=trel.device)
    grid.index_add_(0, inds[:, 0], rows)
    total = grid[0:nfft, 0:2 * b]
    for j in range(1, taps):
        block = grid[:, 2 * b * j: 2 * b * (j + 1)]
        total = total + torch.cat(
            [torch.zeros(j, 2 * b, dtype=dtype, device=trel.device), block[: nfft - j]], dim=0
        )
    return torch.complex(total[:, :b].T, total[:, b:].T)


def trig_sum_batch_pair(t, w1_rows, w2_rows, df, nf, fmin, nfft=None, n=5, q=1, taps=4):
    """The (w1, w2) sums of B rows at the same half-bin grid
    (fmin = q*df/2) from ONE row spreading and ONE batched IFFT: the row
    packing of :func:`trig_sum_batch` with the separation of
    :func:`trig_sum_pair`. Returns (S1, C1, S2, C2), each [B, nf]."""
    if nfft is None:
        nfft = grid_size(nf, n)
    dtype = result_dtype(t, w1_rows, w2_rows)
    cdtype = complex_dtype(dtype)
    t = t.to(dtype)
    tmin = t.min()
    trel = t - tmin
    rot = _phase_factor(fmin, trel, dtype, cdtype)
    u = torch.complex(w1_rows.to(dtype), w2_rows.to(dtype)) * rot[None, :]
    G = nfft * torch.fft.ifft(_batch_row_grid(u, trel, df, nfft, dtype, taps=taps), dim=-1)
    back = torch.flip(torch.conj(G[:, nfft - q - nf + 1: nfft - q + 1]), dims=(-1,))
    G1 = 0.5 * (G[:, :nf] + back)
    G2 = -0.5j * (G[:, :nf] - back)
    post = _grid_rotation(tmin, df, fmin, nf, dtype, cdtype)[None, :]
    G1 = G1 * post
    G2 = G2 * post
    return G1.imag, G1.real, G2.imag, G2.real


def trig_sum_batch(t, w_rows, df, nf, fmin, nfft=None, n=5, taps=4):
    """Fast trig sums for B weight rows sharing one time grid.

    t: [N] shared sample times (any order: the row spreading is
       ``index_add_``, which needs no sorted bases).
    w_rows: [B, N] real weight rows, on ``t``'s device.
    df, fmin: uniform grid spec (Python scalars); nf frequencies; nfft
       the FFT size, next_pow2(nf*n - 1) by default.

    Returns (S [B, nf], C [B, nf]).
    """
    if nfft is None:
        nfft = grid_size(nf, n)
    dtype = result_dtype(t, w_rows)
    cdtype = complex_dtype(dtype)
    t = t.to(dtype)
    w_rows = w_rows.to(dtype)
    tmin = t.min()
    trel = t - tmin
    rot = _phase_factor(fmin, trel, dtype, cdtype)
    u = w_rows.to(cdtype) * rot[None, :]
    fftgrid = torch.fft.ifft(_batch_row_grid(u, trel, df, nfft, dtype, taps=taps), dim=-1)[:, :nf]
    fftgrid = fftgrid * _grid_rotation(tmin, df, fmin, nf, dtype, cdtype)[None, :]
    return nfft * fftgrid.imag, nfft * fftgrid.real


def trig_sum(t, w, df, nf, fmin, nfft=None, n=5, gridder="scatter", taps=4):
    """Fast trig sums; returns (S [nf], C [nf]).

    Parameters
    ----------
    t: [N] sample times (any order for the scatter gridder; the
       ``gridder="kernel"`` path requires TIME-SORTED samples on a
       non-wrapping grid — df * baseline < 1 — or results are silently
       wrong; the GLS estimator guards both).
    w: [N] weights (real), on ``t``'s device.
    df, fmin: uniform grid spec (Python scalars).
    nf: number of frequencies.
    nfft: FFT size; defaults to next_pow2(nf*n - 1).
    """
    if nfft is None:
        nfft = grid_size(nf, n)
    gridder = _resolve_gridder(gridder, t.device)
    dtype = result_dtype(t, w)
    cdtype = complex_dtype(dtype)
    t = t.to(dtype)
    w = w.to(dtype)
    tmin = t.min()
    trel = t - tmin
    wc = w.to(cdtype) * _phase_factor(fmin, trel, dtype, cdtype)
    inds, lagrange = _extirpolate_weights(trel, df, nfft, dtype, taps=taps)
    fftgrid = torch.fft.ifft(_grid(wc, inds, lagrange, nfft, gridder))[:nf]
    fftgrid = fftgrid * _grid_rotation(tmin, df, fmin, nf, dtype, cdtype)
    C = nfft * fftgrid.real
    S = nfft * fftgrid.imag
    return S, C
