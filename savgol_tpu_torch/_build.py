"""Build and load the port's CUDA kernels at first use.

The kernel sources under ``csrc/`` are compiled by ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` process per source, all started together, and
linked into one shared library with a plain ``extern "C"`` interface, which
is loaded with ``ctypes``. Nothing here includes PyTorch's headers, so a
build takes seconds rather than minutes. The library is named after a hash
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
import tempfile

__all__ = ["build", "library", "BUILD_DIR"]

_PKG = pathlib.Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "savgol_tpu_torch"
_SOURCES = ("sg1d_poly.cu", "corr1d_valid.cu", "corr1d_bank.cu",
            "corr2d_valid.cu", "corr2d_bf16_mma.cu", "corr2d_sep.cu",
            "plane_solve.cu", "masked1d.cu", "masked2d.cu", "nonuniform.cu",
            "resample.cu", "halo_ring.cu", "probe_bf16_1d.cu",
            "probe_rowband2d.cu", "probe_dma1d.cu")
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double
_SIGNATURES = {
    "sg1d_poly_f32": [_P, _P, _P, _P, _LL, _LL, ctypes.c_int,
                      ctypes.c_float, _P],
    "sg1d_poly_f64": [_P, _P, _P, _P, _LL, _LL, ctypes.c_int,
                      ctypes.c_double, _P],
    # x, w, out, B, N, n, mode, stream
    "sg1d_pad_f32": [_P, _P, _P, _LL, _LL, _I, _I, _P],
    "sg1d_pad_f64": [_P, _P, _P, _LL, _LL, _I, _I, _P],
    "corr1d_valid_f32": [_P, _P, _P, _LL, _LL, ctypes.c_int, _P],
    "corr1d_valid_f64": [_P, _P, _P, _LL, _LL, ctypes.c_int, _P],
    # method="bf16": the same arguments and a last int, 1 for bf16 storage
    # (0 for f32) before the stream
    "sg1d_poly_bf16": [_P, _P, _P, _P, _LL, _LL, _I, _F, _I, _P],
    "sg1d_pad_bf16": [_P, _P, _P, _LL, _LL, _I, _I, _I, _P],
    "corr1d_valid_bf16": [_P, _P, _P, _LL, _LL, _I, _I, _P],
    "corr2d_valid_bf16": [_P, _P, _P, _LL, _LL, _LL, _LL, _LL, _LL, _I, _I,
                          _P],
    # P3: x, w, out, B, N, ws, variant, stream; the tile width
    "probe_bf16_1d": [_P, _P, _P, _LL, _LL, _I, _I, _P],
    "probe_bf16_1d_tile": [],
    # P2 B_alignctl: x, w, out, B, R, C, H, W, mode, bf16 storage, stream
    "probe_rowband2d": [_P, _P, _P, _LL, _LL, _LL, _LL, _LL, _I, _I, _P],
    # P1: x, w, out, B, N, ws, n_out, rows, cols, stream
    "corr1d_dma_f32": [_P, _P, _P, _LL, _LL, _I, _LL, _I, _I, _P],
    # x, w, out, B, N, K, ws, pad, mode, stream
    "corr1d_bank_f32": [_P, _P, _P, _LL, _LL, _I, _I, _I, _I, _P],
    "corr1d_bank_f64": [_P, _P, _P, _LL, _LL, _I, _I, _I, _I, _P],
    # x, w, out, B, R, C, K, H, W, mode, stream
    "corr2d_valid_f32": [_P, _P, _P, _LL, _LL, _LL, _LL, _LL, _LL, _I, _P],
    "corr2d_valid_f64": [_P, _P, _P, _LL, _LL, _LL, _LL, _LL, _LL, _I, _P],
    # x, u, v, out, B, R, C, rank, H, W, mode, stream
    "corr2d_sep_f32": [_P, _P, _P, _P, _LL, _LL, _LL, _LL, _LL, _LL, _I, _P],
    "corr2d_sep_f64": [_P, _P, _P, _P, _LL, _LL, _LL, _LL, _LL, _LL, _I, _P],
    # H, W, rank, element size -> the instance a launch runs
    "corr2d_sep_instance": [_LL, _LL, _LL, _I],
    # gram, rhs, quorum, pair_index, coef, ok, k, pos, use_rcond,
    # sqrt_rcond, scratch, scratch_threads, stream
    "plane_solve_f32": [_P, _P, _P, _P, _P, _P, _I, _LL, _I, _D, _P, _LL, _P],
    "plane_solve_f64": [_P, _P, _P, _P, _P, _P, _I, _LL, _I, _D, _P, _LL, _P],
    # gram hi, lo, rhs hi, lo, quorum, pair_index, coef, ok, k, pos,
    # use_rcond, sqrt_rcond, scratch, scratch_threads, force_runtime, stream
    "plane_solve_dd_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _LL, _I, _D,
                           _P, _LL, _I, _P],
    "plane_solve_dd_f64": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _LL, _I, _D,
                           _P, _LL, _I, _P],
    # x, w, out, B, Np, n, k, pairs, qt, extract, kmin, fill, scratch,
    # scratch_threads, stream
    "masked1d_f32": [_P, _P, _P, _LL, _LL, _I, _I, _P, _P, _P, _I, _F, _P,
                     _LL, _P],
    "masked1d_f64": [_P, _P, _P, _LL, _LL, _I, _I, _P, _P, _P, _I, _D, _P,
                     _LL, _P],
    # x, w, out, B, Rp, Cp, nx, ny, m, P, Sx, Sy, M, nnz, ftab, itab, kmin,
    # fill, use_rcond, sqrt_rcond, stream
    "masked2d_f32": [_P, _P, _P, _LL, _LL, _LL, _I, _I, _I, _I, _I, _I, _I,
                     _I, _P, _P, _I, _F, _I, _D, _P],
    "masked2d_f64": [_P, _P, _P, _LL, _LL, _LL, _I, _I, _I, _I, _I, _I, _I,
                     _I, _P, _P, _I, _D, _I, _D, _P],
    # x, w, t, out, B, N, t_stride, n, m, d, kmin, fill, sqrt_rcond,
    # emit_planes, scratch, scratch_threads, stream
    **{f"nonuniform_{x}_t{t}": [_P, _P, _P, _P, _LL, _LL, _LL, _I, _I, _I, _I,
                                _D, _D, _I, _P, _LL, _P]
       for x in ("f32", "f64") for t in ("32", "64")},
    # n, m, x element size, t element size, out (3 long long)
    "nonuniform_layout": [_I, _I, _I, _I, ctypes.POINTER(_LL)],
    # planes, t, ctr, tq, out, B, N, Nq, m, d, fill, stream
    **{f"resample_{x}_t{t}": [_P, _P, _P, _P, _P, _LL, _LL, _LL, _I, _I, _D,
                              _P]
       for x in ("f32", "f64") for t in ("32", "64")},
    # bytes a side -> blocks of the exchange
    "halo_ring_blocks": [_LL],
    # tail, head, right buffer, left buffer, own buffer, out left, out right,
    # bytes a side, slot stride, blocks, epoch, timeout ns, stream
    "halo_ring": [_P, _P, _P, _P, _P, _P, _P, _LL, _LL, _I, ctypes.c_ulonglong,
                  _LL, _P],
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


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands concurrently; raise with the output of the first
    that fails, after all have ended."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outputs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outputs):
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{out}")


def build() -> pathlib.Path:
    """Compile the kernels unless a library for these sources exists;
    returns its path. Raises RuntimeError with nvcc's output on failure."""
    lib = BUILD_DIR / f"libsavgol_tpu_torch_{_source_hash()}.so"
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp_dir:
        nvcc, tmp = _nvcc(), pathlib.Path(tmp_dir)
        objs = [tmp / f"{pathlib.Path(s).stem}.o" for s in _SOURCES]
        _run_all([[nvcc, *_FLAGS, "-c", str(_CSRC / s), "-o", str(o)]
                  for s, o in zip(_SOURCES, objs)])
        tmp_lib = tmp / lib.name
        _run_all([[nvcc, *_FLAGS, "-shared", "-o", str(tmp_lib),
                   *map(str, objs)]])
        os.replace(tmp_lib, lib)  # atomic: a concurrent loader sees all or none
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
