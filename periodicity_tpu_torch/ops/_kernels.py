"""Build and bind the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` has a plain C interface. ``build()`` compiles each
source with nvcc for Hopper (``sm_90a``), one nvcc process per source, all
started together, and links the objects into one shared library under
``build/kernels/`` at the root of the checkout. The library is named by a
hash over all the sources, the headers they share (``csrc/*.cuh``) and the
flags, so an edited or added file is never served by a stale library.
``load()`` binds every entry point in ``ENTRY_POINTS`` with ctypes at
first use, building the library if it is missing. No PyTorch header is
included, which keeps the build to seconds.

Each entry point launches on the stream it is given, without
synchronising, and returns ``cudaGetLastError()``; its wrapper raises if
that is not 0. The helpers at the end are shared by the wrappers of the
celerite and Kalman kernels: dispatch by device, input checks, the launch,
and the host round trip of their plain versions.
"""

import ctypes
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

__all__ = ["build", "load", "ENTRY_POINTS"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC"]
_COMPILE = [*_ARCH, "-c", "-Xptxas", "-v"]
_LINK = [*_ARCH, "-shared"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
# C name -> argtypes (pointers and the stream as void*, sizes as int)
ENTRY_POINTS = {
    # ilo, u_re, u_im, lag, n, taps, nfft, out_re, out_im, out_c, stream
    "extirpolate_grid_factored_f32": [_P] * 4 + [_I] * 3 + [_P] * 4,
    # ilo, vals (complex64 [N, 4] as f32 pairs), n, nfft, out_re, out_im, out_c, stream
    "extirpolate_grid_f32": [_P] * 2 + [_I] * 2 + [_P] * 4,
    # t, values, offsets, freqs, n, nv, p, n_phi, stride, out, stream
    "fold_onehot_f32": [_P] * 4 + [_I] * 5 + [_P] * 2,
    # coef (host memory), x, zi, n, ns, rows, y, zf, stream
    "sosfilt_f32": [_P] * 3 + [_I] * 3 + [_P] * 3,
    "sosfilt_f64": [_P] * 3 + [_I] * 3 + [_P] * 3,
    # main, off1, off2, rhs, m, scratch [2m], out, stream
    "pentadiagonal_solve_f32": [_P] * 4 + [_I] + [_P] * 3,
    "pentadiagonal_solve_f64": [_P] * 4 + [_I] + [_P] * 3,
    # element size -> rows a solve holds in shared memory on the current card
    "pentadiagonal_capacity": [_I],
    # pairs, mode, a, d (mode 5), unsigned long long[2] out, stream: the
    # solve's checked quotient against __fdiv_rn / __ddiv_rn (a card test)
    "recursions_quot_check_f32": [ctypes.c_ulonglong, _I] + [_P] * 4,
    "recursions_quot_check_f64": [ctypes.c_ulonglong, _I] + [_P] * 4,
    # element size, int[18] out: local memory, registers and shared memory of
    # the solve and of the filter at 1, 2, 4, 8, 16 lanes a row
    "recursions_kernel_attributes": [_I, _P],
    # t, Y, n, b, max_modes, max_iter, pad_width, theta_1, theta_2, imf_limit,
    # modes, residue, cur, kmode, units, scratch, stream
    "emd_sift_f32": [_P] * 2 + [_I] * 5 + [_D] * 2 + [_I] + [_P] * 7,
    "emd_sift_f64": [_P] * 2 + [_I] * 5 + [_D] * 2 + [_I] + [_P] * 7,
    # n, pad_width, element size -> global scratch bytes a member needs
    "emd_sift_scratch_bytes": [_I] * 3,
    # pairs, mode, unsigned long long[2] out, stream: the sift's float32
    # quotient against __fdiv_rn (a card test)
    "emd_sift_quot_check_f32": [ctypes.c_ulonglong, _I, _P, _P],
    # t, X, n, rows, n_iter, pad_width, eps, A, F, passes, scratch, stream
    "amfm_normalize_f32": [_P] * 2 + [_I] * 4 + [_D] + [_P] * 5,
    "amfm_normalize_f64": [_P] * 2 + [_I] * 4 + [_D] + [_P] * 5,
    # n, pad_width, element size -> global scratch bytes a row needs
    "amfm_scratch_bytes": [_I] * 3,
    # n, pad_width, element size, rows, int[8] out: N1's launch geometry
    "amfm_geometry": [_I] * 4 + [_P],
    # element size, int[6] out: local memory, registers and shared memory of
    # N1's two instances (arrays in shared memory, in global scratch)
    "amfm_kernel_attributes": [_I, _P],
    # pairs, mode, unsigned long long[2] out, stream: N1's float32 quotient
    # against __fdiv_rn (a card test)
    "amfm_quot_check_f32": [ctypes.c_ulonglong, _I, _P, _P],
    # A, U, V, P, y, b, n, r, D, W, z, s_saved, f_saved, stream (null pointers skip)
    "celerite_forward_f32": [_P] * 5 + [_I] * 3 + [_P] * 6,
    "celerite_forward_f64": [_P] * 5 + [_I] * 3 + [_P] * 6,
    # U, P, D, W, z, s_saved, f_saved, dD, dz, b, n, r, dA, dU, dV, dP, dy, stream
    "celerite_adjoint_f32": [_P] * 9 + [_I] * 3 + [_P] * 6,
    "celerite_adjoint_f64": [_P] * 9 + [_I] * 3 + [_P] * 6,
    # U, P, D, W, Y, n, r, k, X, stream
    "celerite_solve_f32": [_P] * 5 + [_I] * 3 + [_P] * 2,
    "celerite_solve_f64": [_P] * 5 + [_I] * 3 + [_P] * 2,
    # b, r, int[5] out; k, r, int[4] out: the launch geometry the kernels use
    "celerite_forward_geometry": [_I] * 2 + [_P],
    "celerite_adjoint_geometry": [_I] * 2 + [_P],
    "celerite_solve_geometry": [_I] * 2 + [_P],
    # r, element size, int[18] out: local memory, registers and shared memory
    # of G1's four forms, G2 and G3
    "celerite_kernel_attributes": [_I] * 2 + [_P],
    # A, Q, H, diag, y, carry_in, b, n, r, n_blocks, elems, tree, mu, s, carry_out, stream
    "kalman_blocked_f32": [_P] * 6 + [_I] * 4 + [_P] * 6,
    "kalman_blocked_f64": [_P] * 6 + [_I] * 4 + [_P] * 6,
    # b, n, r, n_blocks, carry, element size, int[15] out: K1's launch geometry
    "kalman_blocked_geometry": [_I] * 6 + [_P],
    # r, element size, int[12] out: K1's four stages' local memory, registers, shared memory
    "kalman_blocked_attributes": [_I] * 2 + [_P],
    # pairs, mode, unsigned long long[2] out, stream: K1's float32 quotient
    # against __fdiv_rn (a card test)
    "kalman_quot_check_f32": [ctypes.c_ulonglong, _I, _P, _P],
    # A, Q, H, diag, y, carry_in, prefixes, dmu, ds, dcarry_out, b, n, r, n_blocks,
    # levels, dtree, dpre, share, dA, dQ, ddiag, dy, dcarry_in, stream
    "kalman_blocked_adjoint_f32": [_P] * 10 + [_I] * 4 + [_P] * 10,
    "kalman_blocked_adjoint_f64": [_P] * 10 + [_I] * 4 + [_P] * 10,
    # b, n, r, n_blocks, carry, element size, int[10] out: K2's launch geometry
    "kalman_blocked_adjoint_geometry": [_I] * 6 + [_P],
    # r, element size, int[18] out: K2's six kernels' local memory, registers, shared memory
    "kalman_blocked_adjoint_attributes": [_I] * 2 + [_P],
}

# the celerite and Kalman kernels take up to this many slots (R): a
# masked RotationTerm is 8, plus a granulation SHOTerm 12, a BrownianTerm
# plus a RotationTerm 14 to 16. Each width is a template instance; past 8
# a lane group is 16 lanes and the widths are built in units of their own
# (csrc/celerite_r*.cu, csrc/kalman_r*.cu). A wider term runs only on CPU
# tensors.
MAX_R = 16

_LIB = None


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _lib_path():
    digest = hashlib.sha256(" ".join(_COMPILE + _LINK).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"libperiodicity_kernels_{digest.hexdigest()[:16]}.so"


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); nvcc is needed")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def build():
    """Compile the kernel library from source. Returns a dict with the
    library ``path``, the build ``seconds``, each source's compile
    ``source_seconds`` (all start together) and nvcc's ``ptxas`` report
    (registers, shared memory and spills of each kernel)."""
    path = _lib_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    # objects and the library go to private names, then the library is
    # renamed into place: a concurrent build never loads a half-written file
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        # each nvcc's report goes to a file, so that the loop below can poll
        # the processes for each unit's compile time (an unread pipe fills
        # and stalls nvcc)
        procs = []
        for src in _sources():
            obj = Path(tmp) / f"{src.stem}.o"
            log = open(Path(tmp) / f"{src.stem}.log", "w+")
            cmd = [nvcc, *_COMPILE, "-o", str(obj), str(src)]
            procs.append((src, obj, log, subprocess.Popen(
                cmd, stdout=subprocess.DEVNULL, stderr=log, text=True)))
        source_seconds = {}
        while len(source_seconds) < len(procs):
            for src, _, _, proc in procs:
                if src.name not in source_seconds and proc.poll() is not None:
                    source_seconds[src.name] = time.perf_counter() - t0
            if time.perf_counter() - t0 > 600:
                for *_, proc in procs:
                    proc.kill()
                raise RuntimeError("nvcc did not finish within 600 s")
            time.sleep(0.05)
        reports = []
        failed = []
        for src, _, log, proc in procs:
            log.seek(0)
            err = log.read()
            log.close()
            reports.append(f"== {src.name}\n{err}")
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}) on {src}:\n{err}")
        if failed:
            raise RuntimeError("\n".join(failed))
        lib_tmp = Path(tmp) / path.name
        proc = subprocess.run(
            [nvcc, *_LINK, "-o", str(lib_tmp), *(str(o) for _, o, _, _ in procs)],
            capture_output=True, text=True, timeout=600,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(lib_tmp, path)
    seconds = time.perf_counter() - t0
    ptxas = "\n".join(reports)
    path.with_suffix(".ptxas.txt").write_text(ptxas)
    return {"path": str(path), "seconds": seconds, "source_seconds": source_seconds,
            "ptxas": ptxas}


def load():
    """The bound kernel library, built on first use if missing."""
    global _LIB
    if _LIB is None:
        path = _lib_path()
        if not path.exists():
            build()
        lib = ctypes.CDLL(str(path))
        for name, argtypes in ENTRY_POINTS.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


# -- shared by the wrappers: host round trips for the plain versions, input
# checks, dispatch and the launch ------------------------------------------

def _host(*tensors):
    return [None if x is None else x.detach().cpu().numpy() for x in tensors]


def _back(device, *arrays):
    return [None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays]


def _check(name, tensors, dtype, device):
    for label, x in tensors.items():
        if x is None:
            continue
        if x.dtype != dtype or x.device != device:
            raise ValueError(f"{name}: {label} is {x.dtype} on {x.device}, expected {dtype} on "
                             f"{device}")


def _launch(name, fn, *args):
    """Launch ``fn`` on the current stream of the first tensor's device.
    Tensors pass as their data pointers, None as a null pointer."""
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    conv = [ctypes.c_void_p(a.data_ptr()) if isinstance(a, torch.Tensor)
            else ctypes.c_void_p(None) if a is None else a for a in args]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*conv, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _entry(base, dtype):
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the kernels take float32 or float64, got {dtype}")
    return getattr(load(), f"{base}_{'f32' if dtype == torch.float32 else 'f64'}")


def _on_cpu(x):
    """True for a CPU tensor, False for a CUDA one; raises for others."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type == "cpu"


def _recursion_attributes(dtype):
    """Local memory and registers a thread and static shared memory a block
    of each kernel in ``csrc/recursions.cu`` on the current card: the
    pentadiagonal solve, then the filter at 1, 2, 4, 8 and 16 lanes a row."""
    out = (ctypes.c_int * 18)()
    err = load().recursions_kernel_attributes(torch.empty((), dtype=dtype).element_size(), out)
    if err != 0:
        raise RuntimeError(f"recursions_kernel_attributes failed: cudaError {err}")
    keys = ("local_bytes", "registers", "shared_bytes")
    return [dict(zip(keys, out[3 * i:3 * i + 3])) for i in range(6)]
