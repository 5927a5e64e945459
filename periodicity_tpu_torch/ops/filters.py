"""FIR/IIR filtering: convolutions with ndimage boundary modes, the
Gaussian, boxcar and triangle kernels, the Butterworth design and the
cascaded second-order-section recursion.

Port of ``periodicity_tpu/ops/filters.py``, with its names. The convolutions
are ``F.conv1d``/``F.conv2d`` on the input's device, padded by an index
gather (numpy's ``"symmetric"``, scipy's default ``"reflect"``, has no
``F.pad`` mode, and ``F.pad`` refuses a reflection as wide as the input,
where ``jnp.pad`` reflects again), and run in full float32 whatever the
process's TF32 switches say. The Butterworth design (``butter_sos``,
``sosfilt_zi``) is host numpy, as in JAX.

``sosfilt`` is the recursion JAX runs as a ``lax.scan``
(``periodicity_tpu/ops/filters.py:273-299``). On a CUDA tensor it launches
the hand-written kernel ``csrc/recursions.cu`` (one thread per row, the
state in registers); on a CPU tensor it is ``sosfilt_plain``, which steps
through numpy scalars of the working dtype. Both round every product and
sum on its own in the same order, so they agree bit for bit.
``sosfiltfilt`` keeps JAX's precision rule, the recursion in float64:
input that is not float64 is cast to float64 on its own device and the
result cast back, so on the card every dtype runs the kernel.
"""

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.dtypes import full_float32, result_dtype

__all__ = [
    "convolve1d",
    "convolve2d",
    "gaussian_kernel1d",
    "gaussian_filter",
    "boxcar_kernel1d",
    "triangle_kernel1d",
    "butter_sos",
    "sosfilt",
    "sosfilt_zi",
    "sosfiltfilt",
]

# ndimage boundary mode -> numpy pad mode, as in the JAX package
_PAD_MODE = {
    "reflect": "symmetric",
    "mirror": "reflect",
    "nearest": "edge",
    "constant": "constant",
    "wrap": "wrap",
}

# the kernel keeps each row's state and coefficients in registers, which
# it can do for up to this many sections (a Butterworth band-pass of
# order 16)
MAX_SECTIONS = 16


def _pad_index(n, lpad, rpad, mode, device):
    """Source index of every sample of ``np.pad(x, (lpad, rpad), mode)`` for
    a length-``n`` axis. Repeated reflection is the periodic extension, so
    a pad wider than the input reflects again, as ``jnp.pad`` does."""
    i = torch.arange(-lpad, n + rpad, device=device)
    if mode == "symmetric":
        j = torch.remainder(i, 2 * n)
        return torch.where(j >= n, 2 * n - 1 - j, j)
    if mode == "reflect":
        if n == 1:
            return torch.zeros_like(i)
        p = 2 * (n - 1)
        j = torch.remainder(i, p)
        return torch.where(j >= n, p - j, j)
    if mode == "edge":
        return torch.clamp(i, 0, n - 1)
    if mode == "wrap":
        return torch.remainder(i, n)
    raise ValueError(f"unknown pad mode {mode!r}")


def _pad(x, dim, lpad, rpad, mode, cval):
    """``x`` padded along ``dim`` with the ndimage boundary ``mode``."""
    np_mode = _PAD_MODE[mode]
    n = x.shape[dim]
    if np_mode == "constant":
        shape = list(x.shape)
        shape[dim] = lpad
        left = torch.full(shape, cval, dtype=x.dtype, device=x.device)
        shape[dim] = rpad
        right = torch.full(shape, cval, dtype=x.dtype, device=x.device)
        return torch.cat([left, x, right], dim=dim)
    return torch.index_select(x, dim, _pad_index(n, lpad, rpad, np_mode, x.device))


def _kernel(kernel, device):
    return kernel.to(device) if isinstance(kernel, torch.Tensor) else (
        torch.from_numpy(np.asarray(kernel)).to(device))


def convolve1d(x, kernel, mode="mirror", cval=0.0):
    """ndimage.convolve-compatible 1-D convolution along the last axis of
    ``x`` (odd-length kernels). Leading axes are independent rows, so a
    batch [B, N] is one call. The dtype is ``x``'s and the kernel's,
    promoted, as ``jnp.convolve`` gives."""
    kernel = _kernel(kernel, x.device)
    dtype = torch.promote_types(x.dtype, kernel.dtype)
    x = x.to(dtype)
    w = kernel.shape[0]
    lpad = w // 2
    xp = _pad(x, -1, lpad, w - 1 - lpad, mode, cval)
    # convolution flips the kernel relative to correlation
    weight = torch.flip(kernel.to(dtype), (0,)).reshape(1, 1, w)
    with full_float32():
        out = F.conv1d(xp.reshape(-1, 1, xp.shape[-1]), weight)
    return out.reshape(x.shape)


def convolve2d(x, kernel, mode="mirror", cval=0.0):
    """ndimage.convolve-compatible 2-D convolution, in the kernel's dtype
    (the JAX package casts the padded input to it)."""
    kernel = _kernel(kernel, x.device)
    kh, kw = kernel.shape
    xp = _pad(x, 0, kh // 2, kh - 1 - kh // 2, mode, cval)
    xp = _pad(xp, 1, kw // 2, kw - 1 - kw // 2, mode, cval)
    flipped = torch.flip(kernel, (0, 1))
    with full_float32():
        out = F.conv2d(xp[None, None].to(flipped.dtype), flipped[None, None])
    return out[0, 0]


def gaussian_kernel1d(sigma, radius=None, truncate=4.0, dtype=torch.float64):
    """scipy.ndimage._gaussian_kernel1d equivalent (normalized), as a CPU
    tensor; the convolutions move it to their input's device."""
    if radius is None:
        radius = int(truncate * float(sigma) + 0.5)
    x = np.arange(-radius, radius + 1)
    phi = np.exp(-0.5 / float(sigma) ** 2 * x**2)
    phi = phi / phi.sum()
    return torch.from_numpy(phi).to(dtype)


def boxcar_kernel1d(width, dtype=torch.float64):
    """Boxcar kernel with the reference's even-width half-weight edges:
    even widths become width+1 taps whose two edge taps carry half
    weight."""
    width = int(width)
    if width % 2 == 0:
        w = np.ones(width + 1) / width
        w[0] /= 2
        w[-1] /= 2
    else:
        w = np.ones(width) / width
    return torch.from_numpy(w).to(dtype)


def triangle_kernel1d(width, dtype=torch.float64):
    """Triangle kernel (integer ramp, normalized)."""
    half = int(width // 2)
    w = np.array(list(range(1, half + 2)) + list(range(half, 0, -1)), float)
    w = w / w.sum()
    return torch.from_numpy(w).to(dtype)


def gaussian_filter(x, sigma, truncate=4.0, mode="reflect"):
    """scipy.ndimage.gaussian_filter: separable, one 1-D pass per axis."""
    k = gaussian_kernel1d(sigma, truncate=truncate, dtype=x.dtype)
    if x.dim() == 1:
        return convolve1d(x, k, mode=mode)
    out = x
    for axis in range(x.dim()):
        out = convolve1d(out.movedim(axis, -1), k, mode=mode).movedim(-1, axis)
    return out


# ---------------------------------------------------------------------------
# Butterworth IIR design (host numpy) and the cascaded recursion
# ---------------------------------------------------------------------------


def _butter_zpk(order, wn, btype):
    """Digital Butterworth (z, p, k); wn normalized to Nyquist like scipy."""
    # analog prototype: poles on the unit circle, no zeros, unit gain
    m = np.arange(-order + 1, order, 2)
    p = -np.exp(1j * np.pi * m / (2 * order))
    z = np.array([], complex)
    k = 1.0
    fs = 2.0
    warped = 2 * fs * np.tan(np.pi * np.asarray(wn) / fs)
    if btype == "lowpass":
        wo = warped
        p = p * wo
        k = k * wo**order
    elif btype == "highpass":
        wo = warped
        p = wo / p
        z = np.zeros(order, complex)
    elif btype == "bandpass":
        w1, w2 = warped
        bw = w2 - w1
        wo = np.sqrt(w1 * w2)
        p_lp = p * bw / 2
        k = k * bw**order
        p = np.concatenate([p_lp + np.sqrt(p_lp**2 - wo**2), p_lp - np.sqrt(p_lp**2 - wo**2)])
        z = np.zeros(order, complex)
    else:
        raise ValueError(f"Unknown btype {btype}")
    # bilinear transform
    fs2 = 2.0 * fs
    z_d = (fs2 + z) / (fs2 - z)
    p_d = (fs2 + p) / (fs2 - p)
    k_d = k * np.real(np.prod(fs2 - z) / np.prod(fs2 - p))
    z_d = np.concatenate([z_d, -np.ones(len(p_d) - len(z_d))])
    return z_d, p_d, k_d


def _zpk2sos(z, p, k):
    """Pair conjugate poles/zeros into second-order sections.

    The cascade product equals the full transfer function for any valid
    conjugate pairing, which is all zero-phase filtfilt needs; pairing
    order follows poles sorted by proximity to the unit circle.
    """
    z = np.asarray(z, complex)
    p = np.asarray(p, complex)
    n = len(p)
    if len(z) != n or n % 2:
        raise ValueError("even order expected")

    def conj_pairs(arr):
        arr = sorted(arr, key=lambda c: (np.round(c.real, 12), np.round(abs(c.imag), 12)))
        used = [False] * len(arr)
        pairs = []
        for i, c in enumerate(arr):
            if used[i]:
                continue
            used[i] = True
            if abs(c.imag) < 1e-12:
                # find another real
                for j in range(i + 1, len(arr)):
                    if not used[j] and abs(arr[j].imag) < 1e-12:
                        used[j] = True
                        pairs.append((c, arr[j]))
                        break
            else:
                for j in range(i + 1, len(arr)):
                    if not used[j] and abs(arr[j] - np.conj(c)) < 1e-9:
                        used[j] = True
                        pairs.append((c, arr[j]))
                        break
        return pairs

    ppairs = conj_pairs(p)
    zpairs = conj_pairs(z)
    ppairs.sort(key=lambda pr: -max(abs(pr[0]), abs(pr[1])))
    sos = np.zeros((n // 2, 6))
    for i, (pp, zz) in enumerate(zip(ppairs, zpairs)):
        sos[i, :3] = np.real(np.poly([zz[0], zz[1]]))
        sos[i, 3:] = np.real(np.poly([pp[0], pp[1]]))
    sos[0, :3] *= k
    return sos


def butter_sos(order, wn, btype):
    """Butterworth design returning second-order sections [ns, 6] (numpy).

    Like scipy.signal.butter, critical frequencies must satisfy
    0 < Wn < 1 (normalized to Nyquist): the bilinear prewarp wraps past
    Nyquist and yields unstable poles otherwise.
    """
    wn_arr = np.atleast_1d(np.asarray(wn, float))
    if np.any(wn_arr <= 0) or np.any(wn_arr >= 1):
        raise ValueError(
            f"Digital filter critical frequencies must be 0 < Wn < 1 (got {wn!r})"
        )
    if wn_arr.size == 2 and wn_arr[0] >= wn_arr[1]:
        raise ValueError(f"Band edges must be increasing (got {wn!r})")
    z, p, k = _butter_zpk(order, wn, btype)
    if len(p) % 2 == 1:
        # odd order: absorb one real pole/zero into a first-order section
        # encoded as a biquad with trailing zeros
        ip = int(np.argmin(np.abs(p.imag)))
        pr = p[ip]
        p = np.delete(p, ip)
        real_zs = np.where(np.abs(z.imag) < 1e-12)[0]
        if len(real_zs) % 2 == 1:
            iz = real_zs[0]
            zr = z[iz]
            z = np.delete(z, iz)
        else:
            zr = None
        sos_rest = _zpk2sos(z, p, 1.0) if len(p) else np.zeros((0, 6))
        first = np.zeros(6)
        first[0] = k
        first[1] = -k * np.real(zr) if zr is not None else 0.0
        first[3] = 1.0
        first[4] = -np.real(pr)
        return np.vstack([first[None], sos_rest]) if len(sos_rest) else first[None]
    return _zpk2sos(z, p, k)


def sosfilt_zi(sos):
    """Steady-state initial conditions per section (scipy.signal.sosfilt_zi),
    numpy [ns, 2]."""
    sos = np.asarray(sos, float)
    ns = sos.shape[0]
    zi = np.zeros((ns, 2))
    scale = 1.0
    for s in range(ns):
        b, a = sos[s, :3], sos[s, 3:]
        b = b / a[0]
        a = a / a[0]
        # lfilter_zi: solve (I - companion(a).T) zi = B
        AT = np.array([[-a[1], 1.0], [-a[2], 0.0]])
        Bv = np.array([b[1] - a[1] * b[0], b[2] - a[2] * b[0]])
        zi[s] = scale * np.linalg.solve(np.eye(2) - AT, Bv)
        scale *= b.sum() / a.sum()
    return zi


def _coefficients(sos, dtype):
    """(b0, b1, b2, a1, a2) of every section [ns, 5], normalized by a0 in
    the working dtype, as the JAX scan divides them."""
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    sos = np.asarray(sos, np_dtype)
    if sos.ndim != 2 or sos.shape[1] != 6:
        raise ValueError(f"sos must be [n_sections, 6], got {sos.shape}")
    b = sos[:, :3] / sos[:, 3:4]
    a = sos[:, 3:] / sos[:, 3:4]
    return np.ascontiguousarray(np.concatenate([b, a[:, 1:]], axis=1))


def _scalars(a):
    """Elements of a numpy array as scalars that round as its dtype does:
    Python floats for float64, numpy float32 scalars for float32."""
    return a.tolist() if a.dtype == np.float64 else list(a)


def _sosfilt_rows(coef, x, zi):
    """The recursion on host numpy: ``coef`` [ns, 5], ``x`` [B, N], ``zi``
    [B, ns, 2], all of one dtype. Returns (y [B, N], zf [B, ns, 2])."""
    sections = [tuple(_scalars(c)) for c in coef]
    y = np.empty_like(x)
    zf = np.empty_like(zi)
    for r in range(x.shape[0]):
        state = [tuple(_scalars(z)) for z in zi[r]]
        out_row = []
        for v in _scalars(x[r]):
            for s, (b0, b1, b2, a1, a2) in enumerate(sections):
                z0, z1 = state[s]
                out = b0 * v + z0
                state[s] = (b1 * v - a1 * out + z1, b2 * v - a2 * out)
                v = out
            out_row.append(v)
        y[r] = out_row
        zf[r] = state
    return y, zf


def _prepare(sos, x, zi):
    """Working dtype, coefficients [ns, 5], ``x`` as rows [B, N] and ``zi``
    as [B, ns, 2] on ``x``'s device."""
    dtype = result_dtype(x)
    coef = _coefficients(sos, dtype)
    ns = coef.shape[0]
    if x.dim() not in (1, 2):
        raise ValueError(f"x must be [N] or [B, N], got {tuple(x.shape)}")
    rows = x.to(dtype).reshape(x.shape[0] if x.dim() == 2 else 1, x.shape[-1])
    if zi is None:
        zi = torch.zeros((ns, 2), dtype=dtype, device=x.device)
    zi = torch.as_tensor(zi).to(device=x.device, dtype=dtype)
    zi = zi.expand(rows.shape[0], ns, 2) if zi.dim() == 2 else zi
    if zi.shape != (rows.shape[0], ns, 2):
        raise ValueError(f"zi must be [{ns}, 2] or [B, {ns}, 2], got {tuple(zi.shape)}")
    return coef, rows, zi


def sosfilt_plain(sos, x, zi=None):
    """:func:`sosfilt` as its plain version: the recursion steps through
    numpy scalars of the working dtype on the host, and the result goes
    back to ``x``'s device."""
    coef, rows, zi = _prepare(sos, x, zi)
    y, zf = _sosfilt_rows(coef, rows.cpu().numpy(), zi.cpu().numpy())
    y = torch.from_numpy(y).to(x.device).reshape(x.shape)
    zf = torch.from_numpy(zf).to(x.device)
    return y, zf if x.dim() == 2 else zf[0]


def sosfilt(sos, x, zi=None):
    """Cascaded biquad filtering, direct form II transposed.

    sos: [ns, 6] (array-like); x: [N] tensor, or [B, N] independent rows;
    zi: [ns, 2] (or [B, ns, 2]) initial state. The working dtype is x's,
    at least float32. Returns (y, zf) on x's device.

    On a CUDA tensor this launches the kernel on the current stream,
    without synchronising (one launch for all rows); on a CPU tensor it is
    :func:`sosfilt_plain`. ``sosfilt.launches`` counts the kernel launches.
    """
    if x.device.type == "cpu":
        return sosfilt_plain(sos, x, zi)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    coef, rows, zi = _prepare(sos, x, zi)
    ns = coef.shape[0]
    if not 1 <= ns <= MAX_SECTIONS:
        raise ValueError(f"the kernel takes 1 to {MAX_SECTIONS} sections, got {ns}")
    dtype = rows.dtype
    rows = rows.contiguous()
    zi = zi.contiguous()
    b, n = rows.shape
    y = torch.empty_like(rows)
    zf = torch.empty((b, ns, 2), dtype=dtype, device=x.device)

    from ._kernels import load

    fn = getattr(load(), "sosfilt_f32" if dtype == torch.float32 else "sosfilt_f64")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        # the coefficients stay in host memory: the launch copies them into
        # its parameters
        err = fn(coef.ctypes.data, rows.data_ptr(), zi.data_ptr(), n, ns, b,
                 y.data_ptr(), zf.data_ptr(), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"sosfilt launch failed: cudaError {err}")
    sosfilt.launches += 1
    return y.reshape(x.shape), zf if x.dim() == 2 else zf[0]


sosfilt.launches = 0


def kernel_attributes(dtype):
    """The filter kernel's compiled resources in ``dtype`` on the current
    card, by its group width (1, 2, 4, 8, 16 lanes a row): ``local_bytes``
    of local memory and ``registers`` a thread, static ``shared_bytes`` a
    block."""
    from ._kernels import _recursion_attributes

    return dict(zip((1, 2, 4, 8, 16), _recursion_attributes(dtype)[1:]))


def _padlen(sos):
    """scipy's default odd-extension length of ``sosfiltfilt`` for ``sos``."""
    sos = np.asarray(sos, float)
    ntaps = 2 * sos.shape[0] + 1
    ntaps -= min((sos[:, 2] == 0).sum(), (sos[:, 5] == 0).sum())
    return int(ntaps) * 3


def sosfiltfilt(sos, x):
    """Zero-phase forward-backward filtering (scipy.signal.sosfiltfilt
    parity: odd padding with the default padlen, steady-state initial
    conditions), along ``x`` [N].

    An IIR recursion is not float32-safe: narrow bands put poles within
    ~1e-3 of the unit circle, where single-precision state feedback
    amplifies rounding into O(1) errors. So the recursion always runs in
    float64, as the JAX package does: input that is not float64 is cast to
    float64 on its own device and the result cast back. On the card that is
    the kernel, two launches; the float64 arithmetic is the JAX package's
    host float64, so the results agree bit for bit.
    """
    sos_np = np.asarray(sos, float)
    n = x.shape[0]
    edge = _padlen(sos_np)
    if n <= edge:
        raise ValueError("The length of the input vector x must be greater than padlen.")
    dtype = x.dtype
    x = x.to(torch.float64)
    # odd extension
    left = 2 * x[0] - torch.flip(x[1: edge + 1], (0,))
    right = 2 * x[-1] - torch.flip(x[-(edge + 1): -1], (0,))
    ext = torch.cat([left, x, right])
    zi = torch.from_numpy(sosfilt_zi(sos_np)).to(x.device)
    y, _ = sosfilt(sos_np, ext, zi * ext[0])
    y_rev = torch.flip(y, (0,))
    y2, _ = sosfilt(sos_np, y_rev, zi * y_rev[0])
    return torch.flip(y2, (0,))[edge: edge + n].to(dtype)
