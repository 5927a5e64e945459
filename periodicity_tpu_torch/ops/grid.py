"""Spreading of unfactored per-tap complex values onto an nfft grid.

Port of ``periodicity_tpu/ops/pallas_grid.py``, the first spreading
kernel, which no estimator calls (the GLS path spreads factored weights,
``ops/grid2.py``). The TPU kernel (``extirpolate_grid``) becomes the
hand-written Hopper kernel ``csrc/extirpolate_grid_walk.cu``, which the
factored spreading shares;
``extirpolate_grid_plain`` is the same function in plain PyTorch
(``index_add_`` into two planes).
"""

import ctypes

import torch

__all__ = ["extirpolate_grid", "extirpolate_grid_plain"]

TAPS = 4


def extirpolate_grid_plain(ilo, vals, nfft, as_complex=True):
    """``grid[ilo[p] + j] += vals[p, j]`` for j < 4, by ``index_add_`` into
    two zeroed planes of ``vals``' real dtype (complex64 -> float32,
    complex128 -> float64), on ``ilo``'s device. Any order of ``ilo``;
    ``ilo + j`` must lie in [0, nfft). Returns the complex grid [nfft], or
    (re, im) with ``as_complex=False``."""
    flat = (ilo.to(torch.int64)[:, None]
            + torch.arange(TAPS, device=ilo.device)[None, :]).reshape(-1)
    real = vals.real.dtype
    re = torch.zeros(nfft, dtype=real, device=ilo.device)
    im = torch.zeros(nfft, dtype=real, device=ilo.device)
    re.index_add_(0, flat, vals.real.reshape(-1))
    im.index_add_(0, flat, vals.imag.reshape(-1))
    return torch.complex(re, im) if as_complex else (re, im)


def extirpolate_grid(ilo, vals, nfft, as_complex=True):
    """Spread complex ``vals`` [N, 4] at bases ``ilo`` [N] onto an nfft grid:
    ``grid[ilo[p] + j] += vals[p, j]``.

    ilo: int32 [N], SORTED ascending, with ``ilo + 4 <= nfft``; the kernel
        finds each tile's samples by binary search, so unsorted or wrapped
        bases give silently wrong grids, as with the TPU kernel.
    vals: complex [N, 4]; the kernel spreads it in float32, as the TPU
        kernel does, reading complex64 as it lies in memory.
    nfft: a multiple of 8.

    Returns complex64 [nfft], or float32 (re, im) with ``as_complex=False``,
    on ``ilo``'s device. On a CUDA tensor this launches the hand-written
    kernel on the current stream, without synchronising; on a CPU tensor it
    is :func:`extirpolate_grid_plain`. ``extirpolate_grid.launches`` counts
    the kernel launches.
    """
    if ilo.device.type == "cpu":
        return extirpolate_grid_plain(ilo, vals, nfft, as_complex)
    if ilo.device.type != "cuda":
        raise ValueError(f"unsupported device {ilo.device}")
    if ilo.dtype != torch.int32 or ilo.dim() != 1 or not ilo.is_contiguous():
        raise TypeError("ilo must be a contiguous int32 vector")
    n = ilo.shape[0]
    if not vals.is_complex():
        raise TypeError(f"vals must be complex, got {vals.dtype}")
    if vals.shape != (n, TAPS):
        raise ValueError(f"shapes: ilo {tuple(ilo.shape)}, vals {tuple(vals.shape)}; "
                         f"want [N], [N, {TAPS}]")
    if vals.device != ilo.device:
        raise ValueError(f"vals is on {vals.device}, ilo on {ilo.device}")
    if nfft < 8 or nfft > (1 << 30) or nfft % 8:
        raise ValueError(f"nfft must be a multiple of 8 in [8, 2^30], got {nfft}")
    vals = vals.to(torch.complex64).contiguous()
    if vals.data_ptr() % 16:  # the kernel reads each sample's taps as two float4
        vals = vals.clone()

    from ._kernels import load

    fn = load().extirpolate_grid_f32
    if as_complex:  # the kernel writes the interleaved complex64 grid itself
        grid = torch.empty(nfft, dtype=torch.complex64, device=ilo.device)
        ptrs = (None, None, grid.data_ptr())
    else:
        grid = (torch.empty(nfft, dtype=torch.float32, device=ilo.device),
                torch.empty(nfft, dtype=torch.float32, device=ilo.device))
        ptrs = (grid[0].data_ptr(), grid[1].data_ptr(), None)
    with torch.cuda.device(ilo.device):
        stream = torch.cuda.current_stream(ilo.device).cuda_stream
        err = fn(ilo.data_ptr(), vals.data_ptr(), n, nfft, *ptrs, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"extirpolate_grid launch failed: cudaError {err}")
    extirpolate_grid.launches += 1
    return grid


extirpolate_grid.launches = 0
