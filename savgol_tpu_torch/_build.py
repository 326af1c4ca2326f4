"""Build and load the port's CUDA kernels at first use.

The kernel sources under ``csrc/`` are compiled by ``nvcc`` for Hopper
(``sm_90a``) into one shared library with a plain ``extern "C"`` interface,
which is loaded with ``ctypes``. Nothing here includes PyTorch's headers, so
a build takes seconds rather than minutes. The library is named after a hash
of the sources and flags, so an edited source builds anew and an unchanged
one is loaded from ``build/savgol_tpu_torch/``.

Importing this module builds nothing: the first call of :func:`library`
does, and a failed build raises with ``nvcc``'s output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

__all__ = ["build", "library", "BUILD_DIR"]

_PKG = pathlib.Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "savgol_tpu_torch"
_SOURCES = ("sg1d_poly.cu", "corr1d_valid.cu")
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_SIGNATURES = {
    "sg1d_poly_f32": [_P, _P, _P, _P, _LL, _LL, ctypes.c_int,
                      ctypes.c_float, _P],
    "sg1d_poly_f64": [_P, _P, _P, _P, _LL, _LL, ctypes.c_int,
                      ctypes.c_double, _P],
    "corr1d_valid_f32": [_P, _P, _P, _LL, _LL, ctypes.c_int, _P],
    "corr1d_valid_f64": [_P, _P, _P, _LL, _LL, ctypes.c_int, _P],
}


def _nvcc() -> str:
    """nvcc from CUDA_HOME, then /usr/local/cuda, then PATH."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(pathlib.Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(pathlib.Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the savgol_tpu_torch CUDA kernels cannot be built")
    return found


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for p in sorted(_CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> pathlib.Path:
    """Compile the kernels unless a library for these sources exists;
    returns its path. Raises RuntimeError with nvcc's output on failure."""
    lib = BUILD_DIR / f"libsavgol_tpu_torch_{_source_hash()}.so"
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_FLAGS, "-o", str(tmp),
           *(str(_CSRC / s) for s in _SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)          # atomic: a concurrent loader sees all or none
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
