"""Phase-fold histograms for every trial frequency.

Port of ``periodicity_tpu/ops/pallas_bls.py``. The TPU kernel
(``fold_onehot``, one-hot MXU matmuls) becomes the hand-written Hopper
kernel ``csrc/fold.cu``; ``fold_onehot_plain`` is the same function in
plain PyTorch (``index_add_`` over a chunk of periods at a time). The CPU
tests use the plain version, and the card's check compares the kernel with
it.

The bin is the contract, in float32, as in the TPU kernel::

    t32 = float32(t - t[0])          # the subtraction in t's dtype
    phi = t32 * float32(f); phi = phi - floor(phi)
    bin = clamp(int(phi * n_phi), 0, n_phi - 1) * stride + offset

Every product and difference is rounded on its own in both versions, so
the kernel and the plain version put every sample in the same bin.

So is the sum. On the CPU, ``fold_onehot_plain`` adds each cell's
samples with one ``index_add_`` in index order, [chunk, row, sample]: each
cell is the float32 sum, from +0, of its samples in ascending sample
order, each addition rounded on its own. The kernel sums in that order
too, so on the same inputs it gives the CPU plain version's bits, and two
of its launches give the same bits. (``index_add_`` on a CUDA tensor adds
with atomics, in no fixed order.)
"""

import ctypes

import torch

__all__ = ["fold_onehot", "fold_onehot_plain", "fold_bins_onehot", "histogram_rows"]

# the kernel's limit on nv * n_phi * stride cells: past 2048 samples a
# block carries every cell's f32 sum in shared memory from one tile of
# samples to the next, beside the sort's ~33 KB, in 227 KB
_MAX_CELLS = 29056
# the plain version folds at most this many (period, row, sample) triples
# per index_add_
_PLAIN_TRIPLES = 1 << 24


def _f32_inputs(t, values, freqs):
    """(t - t[0]) in t's dtype then float32, value rows [nv, N] and the
    frequencies in float32, as the TPU wrapper casts them."""
    t32 = (t - t[0]).to(torch.float32)
    values = values.to(torch.float32)
    if values.dim() == 1:
        values = values[None]
    return t32, values, freqs.to(torch.float32)


def histogram_rows(bins, values, nbins, out):
    """``out[c, v, k] += sum_i values[v, i] * [bins[c, i] == k]`` by one
    ``index_add_`` over the flattened ``out`` [C, nv, nbins] (contiguous).
    ``bins`` [C, N] int64 in [0, nbins); ``values`` [nv, N] of ``out``'s
    dtype. Returns ``out``."""
    c, n = bins.shape
    nv = values.shape[0]
    rows = torch.arange(nv, device=bins.device) * nbins
    cells = torch.arange(c, device=bins.device) * (nv * nbins)
    idx = cells[:, None, None] + rows[None, :, None] + bins[:, None, :]
    out.view(-1).index_add_(0, idx.reshape(-1), values.expand(c, nv, n).reshape(-1))
    return out


def fold_onehot_plain(t, values, freqs, n_phi, stride=1, offsets=None):
    """:func:`fold_onehot` in plain PyTorch, on ``t``'s device: the bins of
    a chunk of periods as one [chunk, N] tensor, then one ``index_add_``
    into that chunk's [chunk * nv * nbins] output."""
    t32, values, freqs = _f32_inputs(t, values, freqs)
    nv, n = values.shape
    nbins = n_phi * stride
    p = freqs.shape[0]
    out = torch.zeros((p, nv, nbins), dtype=torch.float32, device=t.device)
    off = 0 if offsets is None else offsets.to(torch.int64)
    step = max(1, _PLAIN_TRIPLES // max(1, nv * n))
    for c0 in range(0, p, step):
        phi = t32[None, :] * freqs[c0:c0 + step, None]
        phi = phi - torch.floor(phi)
        pb = (phi * n_phi).to(torch.int32).clamp_(0, n_phi - 1)
        bins = pb.to(torch.int64) * stride + off
        histogram_rows(bins, values, nbins, out[c0:c0 + step])
    return out


def fold_onehot(t, values, freqs, n_phi, stride=1, offsets=None):
    """Weighted phase-fold histograms for every trial frequency.

    t [N] times (any float dtype; the epoch t[0] is taken off in that
    dtype before the float32 cast); values [nv, N] (or [N]) value rows;
    freqs [P] trial frequencies (1/period), cast to float32; n_phi phase
    bins; optional per-sample integer ``offsets`` [N] in [0, stride) for
    2-D histograms (flat bin = phase_bin * stride + offset).

    Returns [P, nv, n_phi * stride] float32 on ``t``'s device. On a CUDA
    tensor this launches the hand-written kernel on the current stream,
    without synchronising; on a CPU tensor it is :func:`fold_onehot_plain`.
    ``fold_onehot.launches`` counts the kernel launches.
    """
    if t.device.type == "cpu":
        return fold_onehot_plain(t, values, freqs, n_phi, stride, offsets)
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    if t.dim() != 1 or not t.is_floating_point():
        raise TypeError("t must be a floating-point vector")
    t32, values, freqs = _f32_inputs(t, values, freqs)
    nv, n = values.shape
    if n != t.shape[0] or freqs.dim() != 1 or nv < 1:
        raise ValueError(
            f"shapes: t {tuple(t.shape)}, values {tuple(values.shape)}, "
            f"freqs {tuple(freqs.shape)}; want [N], [nv >= 1, N], [P]"
        )
    for name, x in (("values", values), ("freqs", freqs), ("offsets", offsets)):
        if x is not None and x.device != t.device:
            raise ValueError(f"{name} is on {x.device}, t on {t.device}")
    if n_phi < 1 or stride < 1:
        raise ValueError(f"n_phi and stride must be >= 1, got {n_phi}, {stride}")
    nbins = n_phi * stride
    if nv * nbins > _MAX_CELLS:
        raise ValueError(
            f"nv * n_phi * stride = {nv * nbins} cells; the kernel takes at most "
            f"{_MAX_CELLS}"
        )
    if offsets is not None:
        if offsets.shape != (n,) or offsets.dtype.is_floating_point:
            raise TypeError("offsets must be an integer vector [N]")
        offsets = offsets.to(torch.int32).contiguous()
    t32 = t32.contiguous()
    values = values.contiguous()
    freqs = freqs.contiguous()
    p = freqs.shape[0]

    from ._kernels import load

    fn = load().fold_onehot_f32
    out = torch.empty((p, nv, nbins), dtype=torch.float32, device=t.device)
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        err = fn(t32.data_ptr(), values.data_ptr(),
                 None if offsets is None else offsets.data_ptr(), freqs.data_ptr(),
                 n, nv, p, n_phi, stride, out.data_ptr(), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"fold_onehot launch failed: cudaError {err}")
    fold_onehot.launches += 1
    return out


fold_onehot.launches = 0


def fold_bins_onehot(t, w, wyc, freqs, nbins=256):
    """BLS-shaped wrapper: (r_bin, s_bin) each [P, nbins] from value rows
    [w, w*yc] (see :func:`fold_onehot`)."""
    values = torch.stack([w.to(torch.float32), wyc.to(torch.float32)])
    out = fold_onehot(t, values, freqs, n_phi=nbins)
    return out[:, 0, :], out[:, 1, :]
