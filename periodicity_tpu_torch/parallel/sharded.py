"""Sharded estimator scans over a device mesh.

Port of ``periodicity_tpu/parallel/sharded.py``. Each scorer shards its
*grid* axis: the series (t, y, w) arrives whole on every rank (JAX's
``in_specs=P()``), every rank scores a contiguous slice of the trial grid
with the same single-device scan (on the card, ``gridder="kernel"``
spreads each sub-band with the B1 kernel and ``binner="kernel"`` folds
with the B2 kernel), and nothing is exchanged.

Each function returns a ``torch.distributed.tensor.DTensor`` sharded over
the axis (BLS: a tuple of four), the counterpart of JAX's global array
sharded over the mesh: ``.to_local()`` is this rank's slice and
``.full_tensor()`` gathers the whole. No gather is forced, because a
caller that reduces the periodogram (an argmax, a threshold) needs only
its slice and one small collective, as JAX inserts the all-gather only
when a replicated result is asked for.

Every function is a rank-local stage (``_gls_stage``, ``_period_stage``,
``_acf_stage``) that a rank runs on its own index; the public function
reads the axis from the mesh and wraps the stage's result.
"""

import torch

from ..core import as_tensor
from ..models.phase import (
    aov_scan,
    bls_scan,
    conditional_entropy_scan,
    gregory_loredo_scan,
    pdm_scan,
    string_length_scan,
)
from ..models.spectral import gls_power
from .mesh import axis_info, local_block, mesh_device, sharded_output

__all__ = [
    "sharded_gls",
    "sharded_pdm",
    "sharded_string_length",
    "sharded_bls",
    "sharded_aov",
    "sharded_conditional_entropy",
    "sharded_gregory_loredo",
    "sharded_acf",
]


def _placed(mesh, *xs):
    """Inputs as tensors on the mesh's device (arrays go there; tensors
    move there)."""
    device = mesh_device(mesh)
    return tuple(as_tensor(x, device) for x in xs)


def _divisible(n, d, what):
    if n % d:
        raise ValueError(f"{what}={n} must be divisible by mesh axis size {d}")


def _gls_stage(t, y, err, df, fmin, nf_local, idx, fit_mean, psd, gridder):
    """Rank ``idx``'s periodogram: the sub-band of ``nf_local`` frequencies
    from ``fmin + idx * nf_local * df``."""
    fmin_local = fmin + idx * nf_local * df
    return gls_power(t, y, err, df, fmin_local, nf_local, fit_mean=fit_mean, psd=psd,
                     gridder=gridder)


def sharded_gls(t, y, err, df, fmin, nf, mesh, axis="grid", fit_mean=True, psd=False,
                gridder="scatter"):
    """GLS periodogram with the frequency band split across ``axis``.

    Each of the D ranks runs the Press-Rybicki pipeline on its own nf/D
    sub-band (its extirpolation grid is D-fold smaller), so the scan is
    compute- and memory-parallel. Returns the power [nf] as a DTensor
    sharded over ``axis``.
    """
    d, idx, _ = axis_info(mesh, axis)
    _divisible(nf, d, "nf")
    t, y, err = _placed(mesh, t, y, err)
    power = _gls_stage(t, y, err, df, fmin, nf // d, idx, fit_mean, psd, gridder)
    return sharded_output(power, mesh, axis)


def _period_stage(scan, args, periods, d, idx, **kw):
    """Rank ``idx``'s scores: ``scan`` over its contiguous slice of the
    periods."""
    pl = periods.shape[0] // d
    return scan(*args, periods[idx * pl:(idx + 1) * pl], **kw)


def _sharded_period_scan(scan, args, periods, mesh, axis, **kw):
    d, idx, _ = axis_info(mesh, axis)
    *args, periods = _placed(mesh, *args, periods)
    _divisible(periods.shape[0], d, "n_periods")
    out = _period_stage(scan, args, periods, d, idx, **kw)
    if isinstance(out, tuple):
        return tuple(sharded_output(o, mesh, axis) for o in out)
    return sharded_output(out, mesh, axis)


def sharded_pdm(t, x, periods, mesh, axis="grid", nb=5, nc=2, batch_size=128):
    """PDM theta over a period grid sharded across ranks."""
    return _sharded_period_scan(pdm_scan, (t, x), periods, mesh, axis, nb=nb, nc=nc,
                                batch_size=batch_size)


def sharded_string_length(t, m, periods, mesh, axis="grid", batch_size=128):
    """String lengths over a period grid sharded across ranks."""
    return _sharded_period_scan(string_length_scan, (t, m), periods, mesh, axis,
                                batch_size=batch_size)


def sharded_aov(t, x, periods, mesh, axis="grid", nb=9, batch_size=128, binner="scatter"):
    """AoV F-statistic over a period grid sharded across ranks. Same
    trial-grid split as :func:`sharded_pdm`; ``binner="kernel"`` (or
    ``"pallas"``, or ``"auto"`` on the card) folds each rank's slice with
    the fold kernel."""
    return _sharded_period_scan(aov_scan, (t, x), periods, mesh, axis, nb=nb,
                                batch_size=batch_size, binner=binner)


def sharded_conditional_entropy(t, x, periods, mesh, axis="grid", n_phi=10, n_mag=5,
                                batch_size=128, binner="scatter"):
    """Conditional entropy H(mag | phase) over a sharded period grid."""
    return _sharded_period_scan(conditional_entropy_scan, (t, x), periods, mesh, axis,
                                n_phi=n_phi, n_mag=n_mag, batch_size=batch_size, binner=binner)


def sharded_gregory_loredo(t, periods, mesh, axis="grid", n_bins=12, batch_size=128,
                           binner="scatter"):
    """Gregory-Loredo log odds over a sharded period grid (the scorer
    folds only the sample times)."""
    return _sharded_period_scan(gregory_loredo_scan, (t,), periods, mesh, axis, n_bins=n_bins,
                                batch_size=batch_size, binner=binner)


def sharded_bls(t, y, w, periods, mesh, axis="grid", widths=(3, 13, 26), nbins=256,
                batch_size=64, binner="scatter"):
    """BLS over a period grid sharded across ranks: each rank folds and
    scores its own contiguous slice of the trial periods with the
    single-device scan (series replicated, no collectives). ``binner``
    passes through to :func:`bls_scan`. Returns the (power, depth,
    width_idx, bin_start) tuple, each a DTensor sharded over ``axis``."""
    return _sharded_period_scan(bls_scan, (t, y, w), periods, mesh, axis, widths=widths,
                                nbins=nbins, batch_size=batch_size, binner=binner)


def _acf_stage(y):
    """FFT autocorrelation [B, N] of rows of uniform series [B, N],
    normalized by lag 0."""
    n = y.shape[-1]
    yc = y - torch.mean(y, dim=-1, keepdim=True)
    ps = torch.abs(torch.fft.rfft(yc, n=2 * n, dim=-1)) ** 2
    r = torch.fft.irfft(ps, dim=-1)[..., :n]
    return r / r[..., :1]


def sharded_acf(y_batch, mesh, batch_axis="batch"):
    """FFT autocorrelation of a batch of uniform series, batch sharded.

    y_batch: [B, N] series, whole on every rank (or a DTensor sharded on
    its rows). Each rank transforms its B/D rows where they lie; no
    collective runs. Returns [B, N] as a DTensor sharded over
    ``batch_axis``.
    """
    (y_batch,) = _placed(mesh, y_batch)
    return sharded_output(_acf_stage(local_block(y_batch, mesh, batch_axis)), mesh,
                          batch_axis)
