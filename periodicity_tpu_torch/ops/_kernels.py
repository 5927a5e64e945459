"""Build and bind the port's hand-written CUDA kernels.

``csrc/*.cu`` has a plain C interface. ``build()`` compiles it with nvcc
for Hopper (``sm_90a``) into a shared library under ``build/kernels/`` at
the root of the checkout, named by a hash of the source and the flags, so
an edited source is never served by a stale library. ``load()`` binds it
with ctypes at first use, building it if it is missing. No PyTorch header
is included, which keeps the build to seconds.
"""

import ctypes
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path

__all__ = ["build", "load"]

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "extirpolate_grid.cu"
BUILD_DIR = _PKG.parent / "build" / "kernels"
_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIB = None


def _lib_path():
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(_FLAGS).encode())
    return BUILD_DIR / f"libperiodicity_kernels_{digest.hexdigest()[:16]}.so"


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); nvcc is needed")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def build():
    """Compile the kernel library from source. Returns a dict with the
    library ``path``, the build ``seconds`` and nvcc's ``ptxas`` report
    (registers, shared memory and spills of each kernel)."""
    path = _lib_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a concurrent build never
    # loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [_nvcc(), *_FLAGS, "-o", tmp, str(SOURCE)],
            capture_output=True, text=True, timeout=600,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) on {SOURCE}:\n{proc.stderr}"
            )
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    seconds = time.perf_counter() - t0
    path.with_suffix(".ptxas.txt").write_text(proc.stderr)
    return {"path": str(path), "seconds": seconds, "ptxas": proc.stderr}


def load():
    """The bound kernel library, built on first use if missing."""
    global _LIB
    if _LIB is None:
        path = _lib_path()
        if not path.exists():
            build()
        lib = ctypes.CDLL(str(path))
        fn = lib.extirpolate_grid_factored_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB
