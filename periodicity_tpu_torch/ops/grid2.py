"""Press-Rybicki spreading of factored sample weights onto an nfft grid.

Port of ``periodicity_tpu/ops/pallas_grid2.py``. The TPU kernel
(``extirpolate_grid_factored``, one-hot MXU matmuls) becomes the
hand-written Hopper kernel ``csrc/extirpolate_grid_walk.cu``, which serves
the unfactored spreading (``ops/grid.py``) too;
``extirpolate_grid_factored_plain`` is the same function in plain PyTorch
(``index_add_`` into two planes, the counterpart of the scatter in
``periodicity_tpu/ops/trig_sum.py::_grid_planes``). The CPU tests use the
plain version, and the card's check compares the kernel with it.
"""

import ctypes

import torch

__all__ = ["extirpolate_grid_factored", "extirpolate_grid_factored_plain"]

_MAX_TAPS = 16  # the kernel's ring of staged products is sized for this


def extirpolate_grid_factored_plain(ilo, u_re, u_im, lag, nfft, as_complex=False):
    """``grid[ilo[i] + j] += u[i] * lag[i, j]`` for j < taps, by
    ``index_add_`` into two zeroed planes of ``u_re``'s dtype (f32 or f64),
    on ``ilo``'s device. Any order of ``ilo``; ``ilo + j`` must lie in
    [0, nfft). Returns (grid_re, grid_im) [nfft], or their complex grid
    with ``as_complex=True``."""
    taps = lag.shape[1]
    flat = (ilo.to(torch.int64)[:, None]
            + torch.arange(taps, device=ilo.device)[None, :]).reshape(-1)
    lag = lag.to(u_re.dtype)
    grid_re = torch.zeros(nfft, dtype=u_re.dtype, device=ilo.device)
    grid_im = torch.zeros(nfft, dtype=u_re.dtype, device=ilo.device)
    grid_re.index_add_(0, flat, (u_re[:, None] * lag).reshape(-1))
    grid_im.index_add_(0, flat, (u_im[:, None] * lag).reshape(-1))
    return torch.complex(grid_re, grid_im) if as_complex else (grid_re, grid_im)


def extirpolate_grid_factored(ilo, u_re, u_im, lag, nfft, as_complex=False):
    """Spread ``u * lag[:, j]`` at bases ``ilo`` onto an nfft grid.

    ilo: int32 [N], SORTED ascending, with ``ilo + taps <= nfft`` (a
        non-wrapping grid, as every default GLS grid is). The kernel finds
        each block's first sample by binary search and walks on from
        there, so unsorted or wrapped bases give silently wrong grids,
        exactly as with the TPU kernel; the GLS estimator guarantees both
        conditions (TSeries sorts, and the gridder is chosen only where
        2*df*baseline < 1).
    u_re, u_im: float32 [N]; lag: float32 [N, taps], taps <= 16.
    nfft: a power of two >= 512.

    Returns (grid_re, grid_im), float32 [nfft], or with ``as_complex=True``
    the complex64 grid [nfft], which the kernel writes itself (what
    ``torch.fft`` reads), on the inputs' device. On a CUDA tensor this
    launches the hand-written kernel on the current stream, without
    synchronising; on a CPU tensor it is
    :func:`extirpolate_grid_factored_plain`. ``extirpolate_grid_factored.
    launches`` counts the kernel launches.
    """
    if ilo.device.type == "cpu":
        return extirpolate_grid_factored_plain(ilo, u_re, u_im, lag, nfft, as_complex)
    n = ilo.shape[0]
    taps = lag.shape[1] if lag.dim() == 2 else 0
    if ilo.device.type != "cuda":
        raise ValueError(f"unsupported device {ilo.device}")
    for name, x in (("u_re", u_re), ("u_im", u_im), ("lag", lag)):
        if x.device != ilo.device:
            raise ValueError(f"{name} is on {x.device}, ilo on {ilo.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if ilo.dtype != torch.int32 or ilo.dim() != 1 or not ilo.is_contiguous():
        raise TypeError("ilo must be a contiguous int32 vector")
    if u_re.shape != (n,) or u_im.shape != (n,) or lag.shape != (n, taps):
        raise ValueError(
            f"shapes: ilo {tuple(ilo.shape)}, u_re {tuple(u_re.shape)}, "
            f"u_im {tuple(u_im.shape)}, lag {tuple(lag.shape)}; want [N], [N], [N], [N, taps]"
        )
    if not 1 <= taps <= _MAX_TAPS:
        raise ValueError(f"taps must be in [1, {_MAX_TAPS}], got {taps}")
    if nfft < 512 or nfft > (1 << 30) or nfft & (nfft - 1):
        raise ValueError(f"nfft must be a power of two in [512, 2^30], got {nfft}")
    if taps == 4 and lag.data_ptr() % 16:  # the kernel reads each row as one float4
        lag = lag.clone()

    from ._kernels import load

    fn = load().extirpolate_grid_factored_f32
    if as_complex:
        grid = torch.empty(nfft, dtype=torch.complex64, device=ilo.device)
        ptrs = (None, None, grid.data_ptr())
    else:
        grid = (torch.empty(nfft, dtype=torch.float32, device=ilo.device),
                torch.empty(nfft, dtype=torch.float32, device=ilo.device))
        ptrs = (grid[0].data_ptr(), grid[1].data_ptr(), None)
    with torch.cuda.device(ilo.device):
        stream = torch.cuda.current_stream(ilo.device).cuda_stream
        err = fn(ilo.data_ptr(), u_re.data_ptr(), u_im.data_ptr(), lag.data_ptr(),
                 n, taps, nfft, *ptrs, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"extirpolate_grid_factored launch failed: cudaError {err}")
    extirpolate_grid_factored.launches += 1
    return grid


extirpolate_grid_factored.launches = 0
