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
"""

import math

import torch

from ..utils.dtypes import complex_dtype, result_dtype
from .grid2 import extirpolate_grid_factored, extirpolate_grid_factored_plain

__all__ = ["trig_sum", "trig_sum_pair", "grid_size"]


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
