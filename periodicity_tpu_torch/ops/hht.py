"""Hilbert-Huang functions: AM/FM normalization, instantaneous frequency,
scatter spectrogram.

Port of ``periodicity_tpu/ops/hht.py``, with its names. Every function
takes leading batch axes ``[..., N]`` (the JAX package vmaps its 1-D
functions over modes and members):

- ``gradient`` and ``teager``: numpy's nonuniform second-order gradient in
  JAX's operation order;
- ``am_fm_normalize``: the iterative AM/FM split (Huang et al. 2009). JAX
  runs it as a vmapped ``lax.while_loop`` (``:88-117``). With the spline
  envelope (the default), a CUDA tensor launches the hand-written kernel
  ``csrc/amfm.cu`` (N1): one launch for all rows, one thread block a row,
  which retires when its row is done, and no host read (``kernel_geometry``
  and ``kernel_attributes`` report its launch and resources). A CPU tensor takes
  :func:`am_fm_normalize_plain`, the same loop over the rows still running,
  one host read a pass. Kernel and plain version round every operation
  alike and agree bit for bit. The Hilbert envelope is plain PyTorch on
  either device (one FFT pair a pass); the LMD envelope runs the 1-D
  ``lmd_sift`` one row at a time;
- ``dq_frequency``, ``nht_frequency``, ``instant_frequency``: DQ, NHT, TEO
  and HT, with numpy's ``unwrap`` written out (torch has none);
- ``spectrogram``: ``searchsorted`` into the frequency grid and a scatter
  of each sample's amplitude into its (bin, sample) cell.
"""

import ctypes
import math

import torch

from ..core.containers import _place, as_tensor
from . import lmd as _lmd
from .emd import _series, upper_envelope
from .wavelet import hilbert

__all__ = [
    "gradient",
    "teager",
    "am_fm_normalize",
    "dq_frequency",
    "nht_frequency",
    "instant_frequency",
    "spectrogram",
]

_NORM_TYPES = ("hilbert", "spline", "lmd")
_TWO_PI = 2 * math.pi


def gradient(y, t=None, *, device=None):
    """np.gradient parity on a (possibly nonuniform) grid, over the last
    axis of y [..., N].

    Second-order central differences in the interior, first-order one-sided
    differences at the edges (numpy's default edge_order=1). With ``t``
    omitted the sample index is the coordinate.
    """
    y = as_tensor(y, device)
    if t is None:
        interior = (y[..., 2:] - y[..., :-2]) * 0.5
        return torch.cat([y[..., 1:2] - y[..., :1], interior, y[..., -1:] - y[..., -2:-1]], -1)
    t = _place(t, None, y).to(y.device)
    dt = torch.diff(t)
    h1, h2 = dt[:-1], dt[1:]
    interior = (
        y[..., 2:] * h1**2 - y[..., :-2] * h2**2 + y[..., 1:-1] * (h2**2 - h1**2)
    ) / (h1 * h2 * (h1 + h2))
    first = (y[..., 1:2] - y[..., :1]) / dt[:1]
    last = (y[..., -1:] - y[..., -2:-1]) / dt[-1:]
    return torch.cat([first, interior, last], -1)


def teager(y, t, *, device=None):
    """Teager energy operator on a nonuniform grid: TEO = (dy)^2 - y d2y."""
    y = as_tensor(y, device)
    g = gradient(y, t)
    return g * g - y * gradient(g, t)


def _converged(F, eps):
    """JAX's stop rule ``max|F| - 1 < eps``, per row, in F's dtype."""
    return (F.abs().amax(-1) - 1.0) < torch.tensor(eps, dtype=F.dtype, device=F.device)


def _check_rows(t, X, n_iter, pad_width):
    if X.dim() != 2 or t.shape != X.shape[1:]:
        raise ValueError(f"t {tuple(t.shape)} and rows {tuple(X.shape)}: t must be [N] with "
                         "the rows [R, N]")
    if X.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the normalization takes float32 or float64, got {X.dtype}")
    if int(n_iter) < 0 or int(pad_width) < 0:
        raise ValueError(f"n_iter {n_iter} and pad_width {pad_width} must be >= 0")


def am_fm_normalize_plain(t, X, norm_type="spline", n_iter=10, pad_width=2, eps=1e-6):
    """:func:`am_fm_normalize` on rows X [R, N] in plain PyTorch, with the
    number of passes each row ran: (A [R, N], F [R, N] clipped to [-1, 1],
    passes [R] int32).

    Spline and Hilbert envelopes: the rows still running take one pass
    together, with one host read a pass for the rows that are left; a
    finished row keeps its F and A, as in JAX's vmapped ``while_loop``.
    LMD envelopes: one row at a time (``lmd_sift`` is 1-D), with one host
    read a pass besides the sift's own (both counted in ``lmd.host_reads``).
    """
    _check_rows(t, X, n_iter, pad_width)
    if norm_type == "lmd":
        return _lmd_rows(t, X, n_iter, pad_width, eps)
    F = X.clone()
    A = torch.ones_like(X)
    passes = torch.zeros(X.shape[0], dtype=torch.int32, device=X.device)
    running = torch.arange(X.shape[0], device=X.device)
    for _ in range(int(n_iter)):
        if running.numel() == 0:
            break
        f = F[running]
        if norm_type == "hilbert":
            env = torch.abs(hilbert(f))
        else:
            env = upper_envelope(t, torch.abs(f), pad_width=pad_width)
        f = f / env
        F[running] = f
        A[running] = A[running] * env
        passes[running] += 1
        running = running[~_converged(f, eps)]
    return A, torch.clamp(F, -1.0, 1.0), passes


def _lmd_rows(t, X, n_iter, pad_width, eps):
    """LMD normalization, one row at a time: F <- (F - mu) / env, A <- A env;
    a sift that finds too few extrema stops the row with its current F, A
    (JAX's ``where(ok, ...)``)."""
    A = torch.ones_like(X)
    F = X.clone()
    passes = torch.zeros(X.shape[0], dtype=torch.int32, device=X.device)
    for r in range(X.shape[0]):
        f, a = F[r], A[r]
        for _ in range(int(n_iter)):
            mu, env, ok = _lmd.lmd_sift(t, f, pad_width=pad_width)
            new_f = (f - mu) / env
            ok, conv = _lmd._read(ok, _converged(new_f, eps))
            passes[r] += 1
            if not ok:
                break
            f, a = new_f, a * env
            if conv:
                break
        F[r], A[r] = f, a
    return A, torch.clamp(F, -1.0, 1.0), passes


def _am_fm_cuda(t, X, n_iter, pad_width, eps):
    """Launch N1 (``csrc/amfm.cu``) once for all rows, on the current
    stream, without synchronising. Returns (A, F clipped, passes [R]).
    Raises on a tensor that is not a contiguous float32/float64 CUDA
    tensor, or on a failed launch."""
    _check_rows(t, X, n_iter, pad_width)
    if X.device.type != "cuda":
        raise ValueError(f"the normalization kernel takes CUDA tensors, got {X.device}")
    if t.device != X.device or t.dtype != X.dtype:
        raise ValueError(f"t {t.dtype} on {t.device} does not match the rows {X.dtype} on "
                         f"{X.device}")
    if not (t.is_contiguous() and X.is_contiguous()):
        raise ValueError("the normalization kernel takes contiguous tensors")
    rows, n = X.shape
    dev = X.device
    A = torch.empty_like(X)
    F = torch.empty_like(X)
    passes = torch.empty(rows, dtype=torch.int32, device=dev)
    if rows == 0:
        return A, F, passes

    from ._kernels import load

    lib = load()
    f64 = X.dtype == torch.float64
    with torch.cuda.device(dev):
        # rows whose arrays exceed the block's shared memory work in global
        # scratch instead
        per_row = lib.amfm_scratch_bytes(n, int(pad_width), 8 if f64 else 4)
        if per_row < 0:
            raise RuntimeError(f"amfm_scratch_bytes failed: cudaError {-per_row}")
        scratch = torch.empty(rows * per_row, dtype=torch.uint8, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        fn = lib.amfm_normalize_f64 if f64 else lib.amfm_normalize_f32
        err = fn(t.data_ptr(), X.data_ptr(), n, rows, int(n_iter), int(pad_width), float(eps),
                 A.data_ptr(), F.data_ptr(), passes.data_ptr(),
                 scratch.data_ptr() if per_row else None, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"amfm_normalize launch failed: cudaError {err}")
    am_fm_normalize.launches += 1
    return A, F, passes


def am_fm_normalize(t, x, norm_type="spline", n_iter=10, pad_width=2, eps=1e-6, *,
                    device=None):
    """Iterative AM/FM splitting (Huang et al. 2009; reference
    timefrequency.py:71-89) of every row of x [..., N] on the grid t [N].

    Repeatedly divides the mode by its amplitude envelope until the
    residual FM part has unit amplitude (within ``eps``) or ``n_iter``
    passes ran. Returns ``(A, F)`` with ``F`` clipped to [-1, 1].
    ``norm_type`` is ``"hilbert"`` (|analytic signal|), ``"spline"``
    (cubic-spline envelope of |F|), or ``"lmd"`` (single LMD sifts as the
    mean/envelope estimator, reference timefrequency.py:81-83; requires a
    uniformly sampled ``t``).

    With ``"spline"``, a CUDA tensor launches the normalization kernel once
    (``am_fm_normalize.launches`` counts the launches); a CPU tensor takes
    :func:`am_fm_normalize_plain`.
    """
    if norm_type not in _NORM_TYPES:
        raise ValueError(f"norm_type {norm_type!r} unknown")
    t, x = _series(t, x, device)
    rows = x.reshape(-1, x.shape[-1]).contiguous()
    if norm_type == "spline" and rows.device.type != "cpu":
        A, F, _ = _am_fm_cuda(t, rows, n_iter, pad_width, eps)
    else:
        A, F, _ = am_fm_normalize_plain(t, rows, norm_type, n_iter, pad_width, eps)
    return A.reshape(x.shape), F.reshape(x.shape)


am_fm_normalize.launches = 0


def kernel_geometry(n, rows, dtype=torch.float32, pad_width=2):
    """The launch N1 (``csrc/amfm.cu``) makes for ``rows`` rows of ``n``
    samples on the current card, read from the built library: ``threads``
    a block, ``rows_per_block``, ``blocks``, ``blocks_per_sm`` (the
    occupancy calculator's at the launch's dynamic shared memory), ``sms``,
    ``in_shared`` (the row's arrays in shared memory, else global scratch),
    ``row_bytes`` and ``waves``."""
    from ._kernels import load

    out = (ctypes.c_int * 8)()
    err = load().amfm_geometry(int(n), int(pad_width), torch.empty((), dtype=dtype).element_size(),
                               int(rows), out)
    if err != 0:
        raise ValueError(f"no normalization launch for n={n}, rows={rows}: cudaError {err}")
    keys = ("threads", "rows_per_block", "blocks", "blocks_per_sm", "sms", "in_shared",
            "row_bytes", "waves")
    return dict(zip(keys, out))


def kernel_attributes(dtype):
    """N1's two instances compiled in ``dtype``, the row's arrays in shared
    memory (``shared``) or in global scratch (``global``), as the runtime
    reports them on the current card: ``local_bytes`` of local memory a
    thread, ``registers`` a thread and static ``shared_bytes`` a block."""
    from ._kernels import load

    out = (ctypes.c_int * 6)()
    err = load().amfm_kernel_attributes(torch.empty((), dtype=dtype).element_size(), out)
    if err != 0:
        raise RuntimeError(f"amfm_kernel_attributes failed: cudaError {err}")
    keys = ("local_bytes", "registers", "shared_bytes")
    return {name: dict(zip(keys, out[3 * k:3 * k + 3])) for k, name in enumerate(("shared", "global"))}


def _unwrap(p):
    """``jnp.unwrap(p)`` over the last axis (numpy's rule: a step of
    exactly -pi after reduction with a positive raw step becomes +pi)."""
    period = torch.tensor(_TWO_PI, dtype=p.dtype, device=p.device)
    interval = period / 2
    dd = torch.diff(p, dim=-1)
    ddmod = torch.remainder(dd + interval, period) - interval
    ddmod = torch.where((ddmod == -interval) & (dd > 0), interval, ddmod)
    ph_correct = torch.where(torch.abs(dd) < interval, 0.0, ddmod - dd)
    return torch.cat([p[..., :1], p[..., 1:] + torch.cumsum(ph_correct, -1)], -1)


def dq_frequency(t, F, *, device=None):
    """Direct-quadrature instantaneous frequency of a unit-amplitude FM
    part: sign-corrected unwrapped arctan2 quadrature phase, then the
    nonuniform phase gradient over 2 pi."""
    F = as_tensor(F, device)
    quad = torch.sqrt(torch.clamp(1.0 - F * F, min=0.0))
    phi = torch.atan2(quad, F)
    phi = _unwrap(phi * torch.sign(gradient(phi)))
    return gradient(phi, t) / _TWO_PI


def nht_frequency(t, F, *, device=None):
    """Normalized-Hilbert-transform instantaneous frequency of a
    unit-amplitude FM part."""
    F = as_tensor(F, device)
    phi = _unwrap(torch.angle(hilbert(F)))
    return gradient(phi, t) / _TWO_PI


def instant_frequency(t, x, method="DQ", norm_type="spline", n_iter=10, pad_width=2, *,
                      device=None):
    """Instantaneous frequency + amplitude of AM-FM components x [..., N].

    Methods (reference timefrequency.py:108-134):
    - ``DQ``  direct quadrature of the normalized FM part,
    - ``NHT`` normalized Hilbert transform,
    - ``TEO`` Teager energy operator (no normalization),
    - ``HT``  plain Hilbert transform (no normalization).

    Returns ``(freq [..., N], amp [..., N])`` in cycles per time unit.
    """
    if method in ("DQ", "NHT"):
        A, F = am_fm_normalize(t, x, norm_type=norm_type, n_iter=n_iter, pad_width=pad_width,
                               device=device)
        t = _place(t, None, F).to(F.device)
        freq = dq_frequency(t, F) if method == "DQ" else nht_frequency(t, F)
        return freq, A
    x = as_tensor(x, device)
    t = _place(t, None, x).to(x.device)
    if method == "TEO":
        e_x = teager(x, t)
        e_dx = teager(gradient(x, t), t)
        amp = e_x / torch.sqrt(e_dx)
        return torch.sqrt(e_dx / e_x) / _TWO_PI, amp
    if method == "HT":
        analytic = hilbert(x)
        phi = _unwrap(torch.angle(analytic))
        return gradient(phi, t) / _TWO_PI, torch.abs(analytic)
    raise ValueError(f"Method {method} is unknown.")


def _bin_index(freq_grid, freq):
    """``jnp.searchsorted(freq_grid, freq)`` (left side) after promoting
    both to one dtype, with NaN after every bin as in JAX's sort order."""
    dtype = torch.promote_types(freq_grid.dtype, freq.dtype)
    grid = freq_grid.to(dtype)
    q = freq.to(dtype)
    rows = torch.searchsorted(grid, q.contiguous(), side="left")
    return torch.where(torch.isnan(q), grid.shape[0], rows)


def spectrogram(freq_grid, freq, amp, *, device=None):
    """Scatter per-sample amplitude into the nearest-above frequency bin
    (reference timefrequency.py:91-98). Edge rows are zeroed so energy
    landing outside the grid is discarded. freq, amp [..., N] -> [...,
    n_freq, N]. Each (bin, sample) cell takes at most one sample, so the
    scatter has no order to match."""
    amp = as_tensor(amp, device)
    freq = _place(freq, None, amp).to(amp.device)
    freq_grid = _place(freq_grid, None, amp).to(amp.device)
    nf = freq_grid.shape[0]
    rows = torch.clamp(_bin_index(freq_grid, freq), 0, nf - 1)
    power = torch.zeros((*amp.shape[:-1], nf, amp.shape[-1]), dtype=amp.dtype,
                        device=amp.device)
    power.scatter_add_(-2, rows[..., None, :], amp[..., None, :])
    power[..., 0, :] = 0.0
    power[..., -1, :] = 0.0
    return power
