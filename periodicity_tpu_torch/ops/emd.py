"""EMD sifting: extrema envelopes, one sift, and the whole decomposition
of a batch of series.

Port of ``periodicity_tpu/ops/emd.py``, with its names. One sift
evaluation (``sift``) is plateau-aware extrema masks, the extrema
compacted into capacity buffers with the series' edges, the odd-reflection
padding as index arithmetic, two masked not-a-knot spline envelopes and
the mean and normalised amplitude of the two; JAX vmaps it over the upper
and lower envelope and over a batch, the port writes the batch axis out.

The whole decomposition of a batch (``emd_batch``, ``emd_pool``,
``emd_iter``, ``emd_iter_pool``) is one state machine per member: JAX's
``_emd_pool_segment`` step (``periodicity_tpu/ops/emd.py:354-373``), in
which every sift either subtracts the mean from the mode being sifted,
accepts the mode (it is an IMF, or ``max_iter`` is reached), or finds too
few extrema and ends the member. JAX runs it as a ``lax.while_loop`` on the
device (``:238-263``, ``:332-406``). Here it is :func:`sift_machine`:

- on a CUDA tensor, the hand-written kernel ``csrc/sift.cu`` (S1): one
  launch for the whole batch, one thread block a member, which retires
  when its decomposition is done. There is no host read inside a
  decomposition;
- on a CPU tensor, :func:`sift_machine_plain`: the same state machine in
  plain PyTorch, stepping the members that are still running in lockstep
  with one host read a step.

Each member's trajectory is the same whatever the batch holds: the sift
decides on integer counts only (extrema, zero crossings, the samples with
sigma > theta_1 against a count limit taken from the float ``mean < alpha``
rule, and any sigma >= theta_2). Kernel and plain version round every
operation alike and agree bit for bit.

``sift`` and ``upper_envelope`` are plain PyTorch on either device.
"""

import ctypes

import numpy as np
import torch

from ..core.containers import _place, as_tensor
from ..utils.dtypes import result_dtype
from . import peaks as _peaks
from . import spline as _spline

__all__ = ["sift", "emd_iter", "emd_batch", "emd_pool", "emd_iter_pool",
           "upper_envelope", "EMDConfig"]

# the kernel packs three extrema counts of up to 21 bits into one 64-bit sum
_MAX_N = 1 << 20


def _take(v, j, c0):
    """v[..., clip(j, 0, c0 - 1)] for an index tensor j [..., M]."""
    return _spline._take(v, torch.clamp(j, 0, c0 - 1))


def _div(a, n):
    """a / n rounded as one division in a's dtype on its device (a Python
    divisor on the card would be turned into a product by its reciprocal)."""
    return a / torch.tensor(n, dtype=a.dtype, device=a.device)


def _compact_with_edges(t, x, mask, cap):
    """Extrema sequence [x0, interior..., x_{N-1}] in capacity buffers.

    t [N]; x, mask [..., N]. Returns (et [..., cap+2], ev [..., cap+2], m
    [...]) with m = interior_count + 2; the slots past m - 1 hold strictly
    increasing filler times (and value 0). JAX compacts with one sort keyed
    by position; each extremum's slot is its rank among the extrema, so a
    scatter to the running count gives the same order.
    """
    n = t.shape[0]
    m_int = mask.sum(-1)
    m = (m_int + 2)[..., None]
    slots = torch.arange(cap + 2, device=x.device)
    # slot of each extremum (1-based rank), the rest to a slot past the end
    pos = torch.where(mask, torch.cumsum(mask, -1), cap + 2)
    buf = torch.zeros((*x.shape[:-1], cap + 3), dtype=x.dtype, device=x.device)
    mid_t = buf.scatter(-1, pos, t.expand(x.shape))[..., : cap + 2]
    mid_v = buf.scatter(-1, pos, x)[..., : cap + 2]
    fdt = _div(t[-1] - t[0], n) + 1.0
    filler_t = t[-1] + (slots - (m - 1)) * fdt
    inner = slots <= m_int[..., None]
    et = torch.where(slots == 0, t[0],
                     torch.where(inner, mid_t, torch.where(slots == m - 1, t[-1], filler_t)))
    ev = torch.where(slots == 0, x[..., :1],
                     torch.where(inner, mid_v, torch.where(slots == m - 1, x[..., -1:], 0.0)))
    return et, ev, m[..., 0]


def _pad_reflect_drop(et, ev, m, pad_width):
    """Odd-reflect pad by pad_width extrema on each side, dropping the
    original edge samples (reference decomposition.py:55-60).

    Input buffers [..., C0]; output buffers [..., C0 + 2*pad_width] with
    count = m + 2*pad_width - 2 and strictly increasing padded times.
    """
    c0 = et.shape[-1]
    w = pad_width
    c = c0 + 2 * w
    i = torch.arange(c, device=et.device)
    mm = m[..., None]
    count = mm + 2 * w - 2
    t0 = et[..., :1]
    tl = _take(et, mm - 1, c0)
    src_left = torch.clamp(w - i, 0, c0 - 1)
    src_mid = torch.clamp(i - w + 1, 0, c0 - 1)
    in_left = i < w
    in_mid = (i >= w) & (i < mm + w - 2)
    in_right = (i >= mm + w - 2) & (i < count)
    out_t = torch.where(in_left, 2 * t0 - et[..., src_left], et[..., src_mid])
    out_v = torch.where(in_left, ev[..., src_left], ev[..., src_mid])
    # right section: the w slots i = m+w-2+k reflect source m-2-k
    for k in range(w):
        sel = i == (mm + w - 2 + k)
        out_t = torch.where(sel, 2 * tl - _take(et, mm - 2 - k, c0), out_t)
        out_v = torch.where(sel, _take(ev, mm - 2 - k, c0), out_v)
    # strictly increasing fillers past the valid range
    fdt = (tl - t0) + 1.0
    last_valid_t = 2 * tl - _take(et, mm - 1 - w, c0)
    filler = last_valid_t + (i - (count - 1)) * (_div(fdt, c) + 1e-3)
    valid = in_left | in_mid | in_right
    out_t = torch.where(valid, out_t, filler)
    out_v = torch.where(valid, out_v, 0.0)
    return out_t, out_v, count[..., 0]


class EMDConfig:
    """Static sifting configuration (reference decomposition.py:13-15)."""

    def __init__(self, max_iter=2000, pad_width=2, theta_1=0.05, theta_2=0.50,
                 alpha=0.05):
        self.max_iter = max_iter
        self.pad_width = pad_width
        self.theta_1 = theta_1
        self.theta_2 = theta_2
        self.alpha = alpha


def _envelope(t, x, mask, pad_width):
    """The spline envelope through the maxima ``mask`` of x [..., N] with
    the edges as knots, and the padded knot count."""
    n = t.shape[0]
    et, ev, m = _compact_with_edges(t, x, mask, n // 2 + 2)
    pt, pv, cnt = _pad_reflect_drop(et, ev, m, pad_width)
    # every query is a sample of t, and the padded knots are [pad_width
    # reflections < t[0]] + [interior extrema] + [reflections > t[-1]], so
    # searchsorted(knots, t[i], "right") is pad_width + #{extrema <= i}
    hi = pad_width + torch.cumsum(mask.to(torch.int64), -1)
    env = _spline.spline_interp(pt, pv, t, count=torch.clamp(cnt, min=4), hi=hi)
    return env, cnt


def _sift_rows(t, x, pad_width):
    """One sift of every row of x [..., N]: (mu, sigma, n_ext, n_zero, ok)."""
    xx = torch.stack([x, -x], dim=-2)
    masks = _peaks.local_maxima_mask(xx)
    n_each = masks.sum(-1)
    n_ext = n_each[..., 0] + n_each[..., 1]
    n_zero = _peaks.zero_crossings_mask(x).sum(-1)
    envs, counts = _envelope(t, xx, masks, pad_width)
    upper = envs[..., 0, :]
    lower = -envs[..., 1, :]
    ok = (n_each[..., 0] >= pad_width) & (n_each[..., 1] >= pad_width)
    ok = ok & (counts[..., 0] >= 4) & (counts[..., 1] >= 4)
    mu = (upper + lower) / 2
    amp = (upper - lower) / 2
    sigma = torch.abs(mu / amp)
    return mu, sigma, n_ext, n_zero, ok


def _series(t, x, device):
    """(t, x) as tensors of one floating dtype (at least float32) on x's
    device: a tensor x keeps its device unless ``device`` is given, and t
    follows it."""
    x = as_tensor(x, device)
    t = _place(t, device, x)
    dtype = result_dtype(t, x)
    if x.ndim < 1 or t.shape != x.shape[-1:]:
        raise ValueError(f"t {tuple(t.shape)} and series {tuple(x.shape)}: t must be [N] "
                         "with the series [..., N]")
    return t.to(device=x.device, dtype=dtype).contiguous(), x.to(dtype).contiguous()


def sift(t, x, pad_width=2, *, device=None):
    """One sifting evaluation (reference decomposition.py:45-70).

    Returns (mu [N], sigma [N], n_ext, n_zero, ok). ``ok`` is False where
    the reference raises ValueError (not enough extrema). Plain PyTorch on
    either device; ``x`` may carry leading batch axes [..., N].
    """
    t, x = _series(t, x, device)
    return _sift_rows(t, x, pad_width)


def upper_envelope(t, x, pad_width=2, *, device=None):
    """Cubic-spline envelope through the local maxima of ``x`` (edges
    included as knots, odd-reflection padded by ``pad_width`` extrema),
    over a leading batch axis [..., N]: the building block of HHT's
    amplitude normalisation (reference timefrequency.py:79).

    Where the reference raises ValueError for a signal without enough
    extrema to pad (core.py:741-774), this falls back to the constant
    max|x| envelope, as the JAX package does. Plain PyTorch on either
    device.
    """
    t, x = _series(t, x, device)
    mask = _peaks.local_maxima_mask(x)
    n_interior = mask.sum(-1)
    env, cnt = _envelope(t, x, mask, pad_width)
    ok = (n_interior >= max(pad_width, 1)) & (cnt >= 4)
    fallback = torch.abs(x).amax(-1, keepdim=True).expand_as(env)
    return torch.where(ok[..., None], env, fallback)


def _imf_count_limit(n, dtype, alpha):
    """The least count c of samples with sigma > theta_1 for which JAX's
    ``mean(sigma > theta_1) < alpha`` is False: c / n rounded in the
    working dtype is nondecreasing in c, so ``count < limit`` is the same
    test on integers."""
    dt = np.float32 if dtype == torch.float32 else np.float64
    frac = np.arange(n + 1, dtype=dt) / dt(n)
    return int(np.count_nonzero(frac < dt(alpha)))


def _check_machine(y, max_modes, max_iter, pad_width):
    if y.dim() != 2:
        raise ValueError(f"series [B, N] expected, got {tuple(y.shape)}")
    if y.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"sifting takes float32 or float64, got {y.dtype}")
    if not 1 <= y.shape[1] <= _MAX_N:
        raise ValueError(f"series length {y.shape[1]} outside [1, {_MAX_N}]")
    if int(max_modes) < 1 or int(max_iter) < 1 or int(pad_width) < 0:
        raise ValueError(f"max_modes {max_modes} and max_iter {max_iter} must be >= 1, "
                         f"pad_width {pad_width} >= 0")


def sift_machine_plain(t, y, max_modes, max_iter=2000, pad_width=2, theta_1=0.05,
                       theta_2=0.50, alpha=0.05):
    """:func:`sift_machine` in plain PyTorch: the members still running step
    in lockstep (one sift each a step), with one host read a step for the
    members that are left.

    t [N]; y [B, N]. Returns (modes [B, max_modes, N], residue [B, N],
    kmode [B] int32, units [B] int32, cur [B, N]).
    """
    _check_machine(y, max_modes, max_iter, pad_width)
    b, n = y.shape
    limit = _imf_count_limit(n, y.dtype, alpha)
    cur = y.clone()
    residue = y.clone()
    modes = torch.zeros((b, max_modes, n), dtype=y.dtype, device=y.device)
    kmode = torch.zeros(b, dtype=torch.int64, device=y.device)
    it = torch.zeros_like(kmode)
    units = torch.zeros_like(kmode)
    done = torch.full((b,), n < 4, dtype=torch.bool, device=y.device)
    while True:
        rows = torch.nonzero(~done)[:, 0]
        if rows.numel() == 0:
            break
        c, r, k = cur[rows], residue[rows], kmode[rows]
        mu, sigma, n_ext, n_zero, ok = _sift_rows(t, c, pad_width)
        is_imf = (sigma > theta_1).sum(-1) < limit
        is_imf = is_imf & (sigma < theta_2).all(-1)
        is_imf = is_imf & ((n_zero - n_ext).abs() <= 1)
        new_cur = torch.where((ok & ~is_imf)[:, None], c - mu, c)
        it1 = it[rows] + 1
        finished = ~ok | is_imf | (it1 >= max_iter)
        accept = finished & ok
        modes[rows, k] = torch.where(accept[:, None], new_cur, modes[rows, k])
        r = torch.where(accept[:, None], r - new_cur, r)
        k = k + accept.to(k.dtype)
        now_done = (finished & ~ok) | (k >= max_modes)
        # a member that is done keeps its last sifted series in cur (the
        # mode emd_iter returns); the others restart from the residue
        cur[rows] = torch.where((finished & ~now_done)[:, None], r, new_cur)
        residue[rows] = r
        kmode[rows] = k
        it[rows] = torch.where(finished, 0, it1)
        units[rows] += 1
        done[rows] = now_done
    return modes, residue, kmode.to(torch.int32), units.to(torch.int32), cur


def _sift_machine_cuda(t, y, max_modes, max_iter, pad_width, theta_1, theta_2, alpha):
    """Launch S1 (``csrc/sift.cu``) once for the whole batch, on the
    current stream, without synchronising. Raises on a tensor that is not
    a contiguous float32/float64 CUDA tensor, or on a failed launch."""
    _check_machine(y, max_modes, max_iter, pad_width)
    if y.device.type != "cuda":
        raise ValueError(f"the sift kernel takes CUDA tensors, got {y.device}")
    if t.device != y.device or t.dtype != y.dtype or t.shape != (y.shape[1],):
        raise ValueError(f"t {tuple(t.shape)} {t.dtype} on {t.device} does not match the "
                         f"series {tuple(y.shape)} {y.dtype} on {y.device}")
    if not (t.is_contiguous() and y.is_contiguous()):
        raise ValueError("the sift kernel takes contiguous tensors")
    b, n = y.shape
    dev = y.device
    modes = torch.zeros((b, max_modes, n), dtype=y.dtype, device=dev)
    residue = torch.empty_like(y)
    cur = torch.empty_like(y)
    kmode = torch.empty(b, dtype=torch.int32, device=dev)
    units = torch.empty(b, dtype=torch.int32, device=dev)

    from ._kernels import load

    lib = load()
    f64 = y.dtype == torch.float64
    with torch.cuda.device(dev):
        # members whose arrays exceed the block's shared memory work in
        # global scratch instead
        per_member = lib.emd_sift_scratch_bytes(n, pad_width, 8 if f64 else 4)
        if per_member < 0:
            raise RuntimeError(f"emd_sift_scratch_bytes failed: cudaError {-per_member}")
        scratch = torch.empty(b * per_member, dtype=torch.uint8, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        fn = lib.emd_sift_f64 if f64 else lib.emd_sift_f32
        err = fn(t.data_ptr(), y.data_ptr(), n, b, max_modes, max_iter, pad_width,
                 float(theta_1), float(theta_2), _imf_count_limit(n, y.dtype, alpha),
                 modes.data_ptr(), residue.data_ptr(), cur.data_ptr(), kmode.data_ptr(),
                 units.data_ptr(), scratch.data_ptr() if per_member else None,
                 ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"emd_sift launch failed: cudaError {err}")
    sift_machine.launches += 1
    return modes, residue, kmode, units, cur


def sift_machine(t, y, max_modes, max_iter=2000, pad_width=2, theta_1=0.05, theta_2=0.50,
                 alpha=0.05):
    """Run every member of y [B, N] (on the time grid t [N]) through the
    EMD state machine until its decomposition is done: up to ``max_modes``
    IMFs, each sifted until it is an IMF or ``max_iter`` sifts, ending early
    where a series has too few extrema.

    Returns (modes [B, max_modes, N] with zeros past each member's count,
    residue [B, N], kmode [B] int32 modes found, units [B] int32 sift
    evaluations, cur [B, N] the series being sifted when the member ended).

    On a CUDA tensor this launches the kernel once (``sift_machine.launches``
    counts the launches); on a CPU tensor it is :func:`sift_machine_plain`.
    """
    if y.device.type == "cpu":
        return sift_machine_plain(t, y, max_modes, max_iter, pad_width, theta_1, theta_2,
                                  alpha)
    return _sift_machine_cuda(t, y, max_modes, max_iter, pad_width, theta_1, theta_2, alpha)


sift_machine.launches = 0


def _emd_iter_counted(t, x, max_iter=2000, pad_width=2, theta_1=0.05, theta_2=0.50,
                      alpha=0.05, *, device=None):
    """emd_iter plus the number of sift evaluations consumed."""
    t, x = _series(t, x, device)
    if x.shape[-1] < 4:
        # JAX's loop runs one sift, which finds too few extrema
        return (x.clone(), True), 1
    _, _, kmode, units, cur = sift_machine(t, x[None], 1, max_iter, pad_width, theta_1,
                                           theta_2, alpha)
    return (cur[0], bool(kmode[0] == 0)), int(units[0])


def emd_iter(t, x, max_iter=2000, pad_width=2, theta_1=0.05, theta_2=0.50, alpha=0.05, *,
             device=None):
    """Extract one IMF by iterated sifting (reference decomposition.py:72-91).

    Returns (mode [N], is_monotonic). The monotonic flag mirrors the
    reference's ValueError path: the signal ran out of extrema, and the mode
    is then the series as far as it was sifted. One launch of the sift
    kernel on the card, and one host read of the flag.
    """
    (mode, mono), _ = _emd_iter_counted(t, x, max_iter, pad_width, theta_1, theta_2, alpha,
                                        device=device)
    return mode, mono


def emd_batch(t, Y, max_modes=8, max_iter=2000, pad_width=2, theta_1=0.05, theta_2=0.50,
              alpha=0.05, return_units=False, *, device=None):
    """Full EMD of a batch of series sharing one time grid.

    t [N], Y [B, N] -> (modes [B, max_modes, N], residue [B, N], n_modes
    [B]). Mode slots past a member's own count are zero; each member's
    decomposition matches ``EMD()(y_b)``. ``return_units=True`` appends
    ``sift_units [B]``, the sift evaluations each member consumed. One
    launch of the sift kernel on the card.
    """
    t, Y = _series(t, Y, device)
    modes, residue, kmode, units, _ = sift_machine(t, Y, max_modes, max_iter, pad_width,
                                                   theta_1, theta_2, alpha)
    if return_units:
        return modes, residue, kmode, units
    return modes, residue, kmode


def _schedule_args(min_bucket, unroll):
    """Validate JAX's pool scheduling knobs; neither changes a result.
    ``unroll <= 0`` loops forever in JAX and is taken as 1 here."""
    if isinstance(min_bucket, bool) or not isinstance(min_bucket, (int, np.integer)) \
            or min_bucket < 1:
        raise ValueError(f"min_bucket must be a positive integer, got {min_bucket!r}")
    if isinstance(unroll, bool) or not isinstance(unroll, (int, np.integer)):
        raise ValueError(f"unroll must be an integer, got {unroll!r}")
    return max(int(unroll), 1)


def emd_pool(t, Y, max_modes=8, max_iter=2000, pad_width=2, theta_1=0.05, theta_2=0.50,
             alpha=0.05, min_bucket=8, return_units=False, unroll=4, *, device=None):
    """Full EMD of a batch in which every member retires when its own
    decomposition is done: the same signature and results as
    :func:`emd_batch`.

    JAX runs the batch as segments of a device loop between host reads,
    compacting the running members into buckets of at least ``min_bucket``
    and unrolling ``unroll`` sifts a loop trip. On the card the kernel
    retires members on its own (one thread block each), so both knobs only
    scheduled JAX's dispatches: they are validated and change nothing.
    """
    _schedule_args(min_bucket, unroll)
    return emd_batch(t, Y, max_modes, max_iter, pad_width, theta_1, theta_2, alpha,
                     return_units, device=device)


def emd_iter_pool(t, X, max_iter=2000, pad_width=2, theta_1=0.05, theta_2=0.50, alpha=0.05,
                  min_bucket=8, *, device=None):
    """One IMF of every member of X [B, N] (CEEMDAN's ensemble fan-out,
    reference decomposition.py:277,304). Returns (modes [B, N], mono [B]),
    with a zero mode where a member is monotonic, as JAX's pool returns."""
    modes, _, kmode = emd_pool(t, X, 1, max_iter, pad_width, theta_1, theta_2, alpha,
                               min_bucket=min_bucket, device=device)
    return modes[:, 0, :], kmode == 0
