"""Distributed FFT over a time-sharded axis (sequence parallelism).

Port of ``periodicity_tpu/parallel/dfft.py``: the communication-optimal
radix-D Cooley-Tukey factorization of a series laid over D ranks in
contiguous blocks of L = N / D samples:

  forward (block -> cyclic), decimation in frequency:
      X[D m + r] = DFT_L( s_r[n] * e^{-2 pi i n r / N} )[m]
      s_r[n]     = sum_j x_j[n] * omega_D^{j r}
  - each rank forms its D weighted copies (:func:`_fwd_copies`), ONE
    ``all_to_all_single`` delivers the r-th copies to rank r, and a local
    sum, a twiddle and a local L-point FFT finish (:func:`_fwd_finish`);
  inverse (cyclic -> block) is the exact mirror (:func:`_inv_copies`, the
  exchange, :func:`_inv_finish`).

Rank r ends holding the frequency residue class X[r::D] ("cyclic"
layout): the returned DTensor is ordered [r, m] -> X[D m + r] and sharded
over the axis. Phases and twiddles are formed as JAX forms them: the
angle's ratio in float64, cast to the working complex dtype, then the
exponential.

:func:`distributed_acf` takes the 2N-point transform of the zero-padded
series as its even and odd frequencies, two N-point transforms of the
blocks where they lie (the odd one of the block modulated by
e^{-i pi n / N}), so padding moves no data; the two rows share one
exchange each way.
"""

import math

import torch
import torch.distributed as dist

from ..core import as_tensor
from .mesh import axis_info, local_block, mesh_device, sharded_output

__all__ = ["distributed_fft", "distributed_ifft", "distributed_acf"]


def _cdtype(x):
    return torch.complex128 if x.dtype in (torch.float64, torch.complex128) else torch.complex64


def _unit(sign, num, den, cdtype):
    """exp(sign * 2 pi i * (num / den)) with the ratio of the int64 tensor
    ``num`` in float64, cast to ``cdtype`` before the exponential."""
    return torch.exp(sign * 2j * math.pi * (num.to(torch.float64) / den).to(cdtype))


def _fwd_copies(x_local, j, d, cdtype):
    """Rank ``j``'s weighted copies [D, ..., L] of its block [..., L], copy
    r for rank r."""
    r = torch.arange(d, device=x_local.device)
    w = _unit(-1, j * r, d, cdtype)  # [D]
    return w.reshape((d,) + (1,) * x_local.dim()) * x_local.to(cdtype)[None]


def _fwd_finish(z, j, n):
    """Rank ``j``'s residue class [..., L] from the copies [D, ..., L] it
    received (row k from rank k)."""
    el = z.shape[-1]
    s = torch.sum(z, dim=0)
    twiddle = _unit(-1, torch.arange(el, device=z.device) * j, n, z.dtype)
    return torch.fft.fft(s * twiddle, dim=-1)


def _inv_copies(X_local, r, d, n, cdtype):
    """Rank ``r``'s contributions [D, ..., L] to every block from its
    residue class [..., L]."""
    el = X_local.shape[-1]
    u = torch.fft.ifft(X_local, dim=-1)
    jj = torch.arange(d, device=X_local.device)
    phase_block = _unit(1, jj * r, d, cdtype)  # [D]
    phase_in = _unit(1, torch.arange(el, device=X_local.device) * r, n, cdtype)  # [L]
    return phase_block.reshape((d,) + (1,) * X_local.dim()) * (u * phase_in)[None]


def _inv_finish(z, d):
    """Rank ``r``'s block [..., L] from the contributions it received."""
    return torch.sum(z, dim=0) / d


def _all_to_all(y, group):
    """Row k of ``y`` [D, ...] to rank k of ``group``; row k of the result
    from rank k."""
    send = torch.view_as_real(y.contiguous()) if y.is_complex() else y.contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.view_as_complex(recv) if y.is_complex() else recv


def _local(x, mesh, axis):
    return local_block(as_tensor(x, mesh_device(mesh)), mesh, axis)


def _fft_local(x_local, n, mesh, axis, cdtype):
    d, j, group = axis_info(mesh, axis)
    return _fwd_finish(_all_to_all(_fwd_copies(x_local, j, d, cdtype), group), j, n)


def _ifft_local(X_local, n, mesh, axis, cdtype):
    d, r, group = axis_info(mesh, axis)
    return _inv_finish(_all_to_all(_inv_copies(X_local, r, d, n, cdtype), group), d)


def distributed_fft(x, mesh, axis="seq"):
    """DFT of x [N] laid over ``axis`` in contiguous blocks (a DTensor
    sharded on the axis, or the whole series on every rank).

    Returns the spectrum in cyclic layout: rank r holds X[r::D] (the
    returned DTensor is ordered [r, m] -> X[D m + r], sharded).
    """
    d = axis_info(mesh, axis)[0]
    x_local = _local(x, mesh, axis)
    n = x_local.shape[-1] * d
    return sharded_output(_fft_local(x_local, n, mesh, axis, _cdtype(x_local)), mesh, axis)


def distributed_ifft(X_cyclic, mesh, axis="seq"):
    """Inverse of distributed_fft: cyclic-layout spectrum -> block-layout
    time series (a DTensor sharded over ``axis``)."""
    d = axis_info(mesh, axis)[0]
    X_local = _local(X_cyclic, mesh, axis)
    n = X_local.shape[-1] * d
    return sharded_output(_ifft_local(X_local, n, mesh, axis, _cdtype(X_local)), mesh, axis)


def _acf_rows(yc_local, j, n, cdtype):
    """The block [L] as the rows [2, L] whose N-point spectra are the even
    and the odd frequencies of the 2N-point spectrum of the padded series:
    the block, and the block times e^{-i pi n / N} at its global n."""
    el = yc_local.shape[-1]
    g = torch.arange(el, device=yc_local.device) + j * el
    x = yc_local.to(cdtype)
    return torch.stack([x, x * _unit(-1, g, 2 * n, cdtype)])


def _acf_lags(rows, j, n):
    """The block's lags [L] (times 2N, which the lag-0 normalization
    cancels) from the inverse transforms [2, L] of the two power rows."""
    el = rows.shape[-1]
    g = torch.arange(el, device=rows.device) + j * el
    return (rows[0] + rows[1] * _unit(1, g, 2 * n, rows.dtype)).real


def distributed_acf(y, mesh, axis="seq", max_lag=None):
    """Autocorrelation of one long series, time-sharded end to end.

    y [N] laid over ``axis`` in blocks (a DTensor, or the whole series on
    every rank); the mean is one ``all_reduce``, each transform one
    ``all_to_all`` each way, the lag-0 value one ``broadcast``. Returns the
    lag-0-normalized ACF [N] as a DTensor in block layout, or, with
    ``max_lag``, its first ``max_lag`` lags gathered on every rank.
    """
    d, j, group = axis_info(mesh, axis)
    y_local = _local(y, mesh, axis)
    n = y_local.shape[-1] * d
    cdtype = _cdtype(y_local)
    total = torch.sum(y_local)
    dist.all_reduce(total, group=group)
    yc = y_local - total / n
    X = _fft_local(_acf_rows(yc, j, n, cdtype), n, mesh, axis, cdtype)
    ps = (X * torch.conj(X)).to(cdtype)
    r = _acf_lags(_ifft_local(ps, n, mesh, axis, cdtype), j, n)
    r0 = r[:1].clone()
    dist.broadcast(r0, group=group, group_src=0)
    out = sharded_output(r / r0, mesh, axis)
    if max_lag is not None:
        return out.full_tensor()[:max_lag]
    return out
