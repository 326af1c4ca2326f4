"""ctypes bindings to the host C++ engine in ``native/`` (counterpart of
``savgol_tpu.native``, keyed by ``savgol_tpu_torch.config``'s enums).

The engine owns the host latency domain the reference targets (the
reference is a host C library): microsecond-latency streaming and a CPU
batch path. Here it serves as an oracle independent of the port's PyTorch
code: the same classes and functions as the JAX package's loader, numpy in
and out.

The library is built on first use with ``g++`` and ``native/Makefile``'s
flags into ``build/savgol_tpu_torch/``, named after a hash of the sources,
the flags and what ``-march=native`` means on this machine, written to a
temporary file and moved into place, so concurrent loaders see all of it or
none. It never builds or loads ``native/libsavgolhost.so``, the JAX
package's. ``load_library`` raises ImportError where it cannot build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np

from savgol_tpu_torch._build import BUILD_DIR
from savgol_tpu_torch.config import (Boundary2D, BoundaryMode, Savgol2DConfig,
                                     SavgolConfig)

__all__ = ["HostSavgol1D", "HostSavgolStream", "HostSavgol2D",
           "gradient2d", "hessian2d", "laplacian2d", "load_library"]

_NATIVE_DIR = pathlib.Path(__file__).resolve().parent.parent / "native"
_SOURCES = ("savgol_host.cpp", "savgol_host2d.cpp")
# native/Makefile: $(CXX) $(CXXFLAGS) $(LDFLAGS) $(SRCS) -o $(OUT)
_CXX = "g++"
_CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra",
             "-march=native", "-pthread")
_LDFLAGS = ("-shared", "-pthread")

_BOUNDARY_1D = {
    BoundaryMode.POLYNOMIAL: 0,
    BoundaryMode.REFLECT: 1,
    BoundaryMode.PERIODIC: 2,
    BoundaryMode.CONSTANT: 3,
}
_BOUNDARY_2D = {
    Boundary2D.VALID: 0,
    Boundary2D.CONSTANT: 1,
    Boundary2D.REFLECT: 2,
    Boundary2D.PERIODIC: 3,
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_f32p = ctypes.POINTER(ctypes.c_float)
_f64p = ctypes.POINTER(ctypes.c_double)


def _build() -> pathlib.Path:
    """The engine's library for these sources, flags and CPU, built unless
    it exists."""
    # what -march=native selects on this CPU: a library built for another
    # machine's CPU (a copied build directory) gets another name
    target = subprocess.run(
        [_CXX, "-march=native", "-Q", "--help=target"], check=True,
        capture_output=True, text=True).stdout
    h = hashlib.sha256(" ".join((_CXX,) + _CXXFLAGS + _LDFLAGS).encode())
    h.update(target.encode())
    for name in _SOURCES:
        h.update(name.encode())
        h.update((_NATIVE_DIR / name).read_bytes())
    lib = BUILD_DIR / f"libsavgolhost_{h.hexdigest()[:16]}.so"
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp_dir:
        tmp = pathlib.Path(tmp_dir) / lib.name
        subprocess.run([_CXX, *_CXXFLAGS, *_LDFLAGS,
                        *(str(_NATIVE_DIR / s) for s in _SOURCES),
                        "-o", str(tmp)], check=True, capture_output=True)
        os.replace(tmp, lib)
    return lib


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the host engine."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        try:
            so = _build()
        except (subprocess.CalledProcessError, FileNotFoundError) as e:
            raise ImportError(
                f"cannot build the native host engine: {e}") from e
        lib = ctypes.CDLL(str(so))
        lib.sgh_create.restype = ctypes.c_void_p
        lib.sgh_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_float, ctypes.c_int]
        lib.sgh_destroy.argtypes = [ctypes.c_void_p]
        lib.sgh_apply.restype = ctypes.c_int
        lib.sgh_apply.argtypes = [ctypes.c_void_p, _f32p, _f32p,
                                  ctypes.c_int64, ctypes.c_int]
        lib.sgh_apply_strided.restype = ctypes.c_int
        lib.sgh_apply_strided.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
        lib.sgh_apply_valid.restype = ctypes.c_int64
        lib.sgh_apply_valid.argtypes = [ctypes.c_void_p, _f32p,
                                        ctypes.c_int64, _f32p]
        lib.sgh_apply_threaded.restype = ctypes.c_int
        lib.sgh_apply_threaded.argtypes = [ctypes.c_void_p, _f32p, _f32p,
                                           ctypes.c_int64, ctypes.c_int,
                                           ctypes.c_int]
        lib.sgh_apply_batch.restype = ctypes.c_int
        lib.sgh_apply_batch.argtypes = [ctypes.c_void_p, _f32p, _f32p,
                                        ctypes.c_int64, ctypes.c_int64,
                                        ctypes.c_int, ctypes.c_int]
        lib.sgh_weights.restype = ctypes.c_int
        lib.sgh_weights.argtypes = [ctypes.c_void_p, _f64p, _f64p]
        lib.sgh_stream_create.restype = ctypes.c_void_p
        lib.sgh_stream_create.argtypes = [ctypes.c_void_p]
        lib.sgh_stream_destroy.argtypes = [ctypes.c_void_p]
        lib.sgh_stream_reset.argtypes = [ctypes.c_void_p]
        lib.sgh_stream_ready.restype = ctypes.c_int
        lib.sgh_stream_ready.argtypes = [ctypes.c_void_p]
        lib.sgh_stream_received.restype = ctypes.c_uint64
        lib.sgh_stream_received.argtypes = [ctypes.c_void_p]
        lib.sgh_stream_emitted.restype = ctypes.c_uint64
        lib.sgh_stream_emitted.argtypes = [ctypes.c_void_p]
        lib.sgh_stream_push.restype = ctypes.c_float
        lib.sgh_stream_push.argtypes = [ctypes.c_void_p, ctypes.c_float,
                                        ctypes.POINTER(ctypes.c_int)]
        lib.sgh_stream_push_full.restype = ctypes.c_int
        lib.sgh_stream_push_full.argtypes = [ctypes.c_void_p,
                                             ctypes.c_float, _f32p,
                                             ctypes.c_int]
        lib.sgh_stream_flush.restype = ctypes.c_int
        lib.sgh_stream_flush.argtypes = [ctypes.c_void_p, _f32p,
                                         ctypes.c_int]
        lib.sgh_stream_flush_leading.restype = ctypes.c_int
        lib.sgh_stream_flush_leading.argtypes = [ctypes.c_void_p, _f32p,
                                                 ctypes.c_int]
        lib.sgh_stream_set_reference_edge_sign.argtypes = [
            ctypes.c_void_p, ctypes.c_int]
        lib.sgh_stream_sizeof.restype = ctypes.c_int64
        lib.sgh_stream_sizeof.argtypes = []
        lib.sgh_stream_alignof.restype = ctypes.c_int64
        lib.sgh_stream_alignof.argtypes = []
        lib.sgh_stream_init.restype = ctypes.c_void_p
        lib.sgh_stream_init.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.sgh2_create.restype = ctypes.c_void_p
        lib.sgh2_create.argtypes = [ctypes.c_int] * 5 + [ctypes.c_float] * 2
        lib.sgh2_destroy.argtypes = [ctypes.c_void_p]
        lib.sgh2_apply.restype = ctypes.c_int
        lib.sgh2_apply.argtypes = [ctypes.c_void_p, _f32p, ctypes.c_int64,
                                   ctypes.c_int64, ctypes.c_int64, _f32p,
                                   ctypes.c_int64, ctypes.c_int]
        lib.sgh2_apply_threaded.restype = ctypes.c_int
        lib.sgh2_apply_threaded.argtypes = [
            ctypes.c_void_p, _f32p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, _f32p, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int]
        lib.sgh2_weights.restype = ctypes.c_int
        lib.sgh2_weights.argtypes = [ctypes.c_void_p, _f64p]
        _conv_head = [ctypes.c_int] * 3 + [ctypes.c_float] * 2 + [
            _f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
        _conv_tail = [ctypes.c_int64, ctypes.c_int, ctypes.c_int]
        lib.sgh2_gradient.restype = ctypes.c_int
        lib.sgh2_gradient.argtypes = _conv_head + [_f32p, _f32p] + _conv_tail
        lib.sgh2_hessian.restype = ctypes.c_int
        lib.sgh2_hessian.argtypes = (_conv_head + [_f32p, _f32p, _f32p]
                                     + _conv_tail)
        lib.sgh2_laplacian.restype = ctypes.c_int
        lib.sgh2_laplacian.argtypes = _conv_head + [_f32p] + _conv_tail
        _lib = lib
        return lib


def _ptr32(a: np.ndarray):
    return a.ctypes.data_as(_f32p)


class HostSavgol1D:
    """Native 1D filter (host CPU)."""

    def __init__(self, config: SavgolConfig):
        self.config = config
        self._lib = load_library()
        self._h = self._lib.sgh_create(
            config.half_window, config.poly_order, config.derivative,
            config.time_step, _BOUNDARY_1D[config.boundary])
        if not self._h:
            raise ValueError("native sgh_create rejected config")

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.sgh_destroy(self._h)
            self._h = None

    def apply(self, x, reference_edge_sign: bool = False) -> np.ndarray:
        x = np.ascontiguousarray(x, dtype=np.float32)
        out = np.empty_like(x)
        rc = self._lib.sgh_apply(self._h, _ptr32(x), _ptr32(out), x.size,
                                 int(reference_edge_sign))
        if rc != 0:
            raise ValueError("native apply failed (input too short?)")
        return out

    def apply_strided(self, x: np.ndarray, out: Optional[np.ndarray] = None,
                      reference_edge_sign: bool = False) -> np.ndarray:
        """Filter a strided float32 field (reference parity:
        ``savgol_apply_strided``, src/savgolFilter.c:877-934).

        ``x`` is any 1D float32 view with a positive byte stride — e.g. a
        structured-array field (``arr['value']``) or an interleaved column
        (``arr[:, k]``) — no copy is made by the caller. If ``out`` is a
        strided view into an element array, ONLY the addressed floats are
        written; sibling bytes stay untouched (the reference's contract,
        test/iterative/test_savgol.c:245-294). Returns ``out`` (a fresh
        contiguous array if None).
        """
        x = np.asarray(x)
        if x.ndim != 1 or x.dtype != np.float32:
            raise ValueError("apply_strided expects a 1D float32 view")
        if x.strides[0] <= 0:
            raise ValueError("apply_strided requires a positive stride")
        if out is None:
            out = np.empty(x.size, dtype=np.float32)
        else:
            out = np.asarray(out)
            if (out.ndim != 1 or out.dtype != np.float32
                    or out.size != x.size):
                raise ValueError("out must be a 1D float32 view of len(x)")
            if out.strides[0] <= 0:
                raise ValueError("apply_strided requires a positive stride")
        rc = self._lib.sgh_apply_strided(
            self._h, ctypes.c_void_p(x.ctypes.data), x.strides[0], 0,
            ctypes.c_void_p(out.ctypes.data), out.strides[0], 0, x.size,
            int(reference_edge_sign))
        if rc != 0:
            raise ValueError("native strided apply failed "
                             "(input too short?)")
        return out

    def apply_valid(self, x) -> np.ndarray:
        x = np.ascontiguousarray(x, dtype=np.float32)
        n = self.config.half_window
        out = np.empty(max(x.size - 2 * n, 0), dtype=np.float32)
        count = self._lib.sgh_apply_valid(self._h, _ptr32(x), x.size,
                                          _ptr32(out))
        return out[:count]

    def apply_threaded(self, x, reference_edge_sign: bool = False,
                       n_threads: int = 0) -> np.ndarray:
        """Multithreaded apply — the reference's vestigial OpenMP option
        (CMakeLists.txt:16, wired to no pragmas), actually implemented.

        1D input: overlap-save split of the interior across host threads
        (no halo copies — shared memory IS the halo). 2D input (B, N):
        rows partitioned across threads. ``n_threads<=0`` = hardware
        concurrency; small inputs silently run single-threaded."""
        x = np.ascontiguousarray(x, dtype=np.float32)
        out = np.empty_like(x)
        if x.ndim == 1:
            rc = self._lib.sgh_apply_threaded(
                self._h, _ptr32(x), _ptr32(out), x.size,
                int(reference_edge_sign), int(n_threads))
        elif x.ndim == 2:
            rc = self._lib.sgh_apply_batch(
                self._h, _ptr32(x), _ptr32(out), x.shape[0], x.shape[1],
                int(reference_edge_sign), int(n_threads))
        else:
            raise ValueError("apply_threaded expects a 1D or 2D array")
        if rc != 0:
            raise ValueError("native apply failed (input too short?)")
        return out

    def apply_batch(self, x, reference_edge_sign: bool = False,
                    n_threads: int = 1) -> np.ndarray:
        """Filter a (B, N) batch, each row independently (the native
        analog of the tensor paths' batch axis). ``n_threads``: 1 =
        sequential rows, 0 = hardware concurrency, k = k threads; any
        setting is bit-identical to per-row :meth:`apply` (rows never share
        state)."""
        x = np.ascontiguousarray(x, dtype=np.float32)
        if x.ndim != 2:
            raise ValueError("apply_batch expects a (B, N) array")
        out = np.empty_like(x)
        rc = self._lib.sgh_apply_batch(
            self._h, _ptr32(x), _ptr32(out), x.shape[0], x.shape[1],
            int(reference_edge_sign), int(n_threads))
        if rc != 0:
            raise ValueError("native batch apply failed "
                             "(input too short?)")
        return out

    def weights(self):
        """(center, edge) tables in f64."""
        n = self.config.half_window
        ws = self.config.window_size
        center = np.empty(ws, dtype=np.float64)
        edge = np.empty((n, ws), dtype=np.float64)
        self._lib.sgh_weights(self._h, center.ctypes.data_as(_f64p),
                              edge.ctypes.data_as(_f64p))
        return center, edge


class HostSavgolStream:
    """Native streaming filter: microsecond-latency push path.

    ``static_storage=True`` uses the reference's no-malloc init path
    (src/savgol_stream.c:108-120): the whole stream state lives in a
    caller-side buffer (here a numpy byte array held by this object)
    with a NON-owning filter ref, placement-initialized via
    ``sgh_stream_init`` — zero heap allocation in the native engine,
    the embedded story the reference's static init exists for. Both
    modes behave identically."""

    def __init__(self, filter_or_config,
                 reference_edge_sign: bool = False,
                 static_storage: bool = False):
        if isinstance(filter_or_config, SavgolConfig):
            self._filter = HostSavgol1D(filter_or_config)
        else:
            self._filter = filter_or_config
        self.config = self._filter.config
        self._lib = self._filter._lib
        self._owns_native = not static_storage
        if static_storage:
            size = self._lib.sgh_stream_sizeof()
            align = self._lib.sgh_stream_alignof()
            # over-allocate so we can slide to the alignment boundary
            buf = np.zeros(size + align, dtype=np.uint8)
            base = buf.ctypes.data
            off = (-base) % align
            self._storage = buf              # keepalive
            self._h = self._lib.sgh_stream_init(
                ctypes.c_void_p(base + off), self._filter._h)
        else:
            self._h = self._lib.sgh_stream_create(self._filter._h)
        if not self._h:
            raise RuntimeError("native stream create failed")
        if reference_edge_sign:
            self._lib.sgh_stream_set_reference_edge_sign(self._h, 1)

    def __del__(self):
        if getattr(self, "_h", None):
            if getattr(self, "_owns_native", True):
                self._lib.sgh_stream_destroy(self._h)
            self._h = None

    @property
    def ready(self) -> bool:
        return bool(self._lib.sgh_stream_ready(self._h))

    @property
    def latency(self) -> int:
        return self.config.half_window

    @property
    def samples_received(self) -> int:
        return self._lib.sgh_stream_received(self._h)

    @property
    def samples_output(self) -> int:
        return self._lib.sgh_stream_emitted(self._h)

    def reset(self):
        self._lib.sgh_stream_reset(self._h)

    def push(self, sample: float):
        valid = ctypes.c_int(0)
        v = self._lib.sgh_stream_push(self._h, sample,
                                      ctypes.byref(valid))
        return v, bool(valid.value)

    def push_full(self, sample: float,
                  max_outputs: Optional[int] = None) -> np.ndarray:
        n = self.config.half_window
        cap = (n + 1) if max_outputs is None else int(max_outputs)
        out = np.empty(max(cap, 1), dtype=np.float32)
        c = self._lib.sgh_stream_push_full(self._h, sample, _ptr32(out),
                                           cap)
        return out[:c]

    def flush(self, max_count: Optional[int] = None) -> np.ndarray:
        n = self.config.half_window
        cap = n if max_count is None else int(max_count)
        out = np.empty(max(cap, 1), dtype=np.float32)
        c = self._lib.sgh_stream_flush(self._h, _ptr32(out), cap)
        return out[:c]

    def flush_leading(self, max_count: Optional[int] = None) -> np.ndarray:
        n = self.config.half_window
        cap = n if max_count is None else int(max_count)
        out = np.empty(max(cap, 1), dtype=np.float32)
        c = self._lib.sgh_stream_flush_leading(self._h, _ptr32(out), cap)
        return out[:c]


class HostSavgol2D:
    """Native 2D filter (host CPU)."""

    def __init__(self, config: Savgol2DConfig):
        self.config = config
        self._lib = load_library()
        self._h = self._lib.sgh2_create(
            config.half_window_x, config.half_window_y, config.poly_order,
            config.deriv_x, config.deriv_y, config.delta_x, config.delta_y)
        if not self._h:
            raise ValueError("native sgh2_create rejected config")

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.sgh2_destroy(self._h)
            self._h = None

    def _run_apply(self, img, boundary: Boundary2D,
                   n_threads: Optional[int]) -> np.ndarray:
        if not isinstance(boundary, Boundary2D):
            boundary = Boundary2D(boundary)   # accept "periodic" etc.
        if boundary not in _BOUNDARY_2D:
            raise ValueError(
                f"native 2D engine supports {sorted(b.value for b in _BOUNDARY_2D)}; "
                f"{boundary.value!r} is an extension of the tensor path — "
                f"use Savgol2D.apply")
        img = np.ascontiguousarray(img, dtype=np.float32)
        rows, cols = img.shape
        if boundary is Boundary2D.VALID:
            ny, nx = self.config.half_window_y, self.config.half_window_x
            out = np.empty((rows - 2 * ny, cols - 2 * nx), dtype=np.float32)
            ostride = out.shape[1]
        else:
            out = np.empty_like(img)
            ostride = cols
        if n_threads is None:
            rc = self._lib.sgh2_apply(self._h, _ptr32(img), rows, cols,
                                      cols, _ptr32(out), ostride,
                                      _BOUNDARY_2D[boundary])
        else:
            rc = self._lib.sgh2_apply_threaded(
                self._h, _ptr32(img), rows, cols, cols, _ptr32(out),
                ostride, _BOUNDARY_2D[boundary], int(n_threads))
        if rc != 0:
            raise ValueError("native 2d apply failed")
        return out

    def apply(self, img, boundary: Boundary2D = Boundary2D.CONSTANT
              ) -> np.ndarray:
        return self._run_apply(img, boundary, None)

    def apply_threaded(self, img, boundary: Boundary2D = Boundary2D.CONSTANT,
                       n_threads: int = 0) -> np.ndarray:
        """Multithreaded 2D apply: output rows partitioned across host
        threads, bit-identical to :meth:`apply` (rows are independent;
        boundary modes pad once, then each thread runs the blocked VALID
        kernel on a disjoint row span). ``n_threads<=0`` = hardware
        concurrency; small images silently run single-threaded."""
        return self._run_apply(img, boundary, n_threads)

    def weights(self) -> np.ndarray:
        out = np.empty((self.config.window_height,
                        self.config.window_width), dtype=np.float64)
        self._lib.sgh2_weights(self._h, out.ctypes.data_as(_f64p))
        return out


# ---- native 2D convenience fields ------------------------------------------
# Mirrors the reference's savgol2d_gradient / _hessian / _laplacian API
# (reference src/savgol2d.c:462-618) over the native engine's
# blocked/threaded applies. ``n_threads``: None = single thread (like
# ``HostSavgol2D.apply``), 0 = hardware concurrency, k = k threads.


def _conv2d_prep(img, hx: int, hy: int, boundary):
    if not isinstance(boundary, Boundary2D):
        boundary = Boundary2D(boundary)
    if boundary not in _BOUNDARY_2D:
        raise ValueError(f"unsupported native 2D boundary "
                         f"{getattr(boundary, 'value', boundary)!r}")
    img = np.ascontiguousarray(img, dtype=np.float32)
    if img.ndim != 2:
        raise ValueError("expected a (rows, cols) image")
    rows, cols = img.shape
    if boundary is Boundary2D.VALID:
        oshape = (rows - 2 * hy, cols - 2 * hx)
        if min(oshape) <= 0:
            raise ValueError("image smaller than the window")
    else:
        oshape = (rows, cols)
    return img, oshape, _BOUNDARY_2D[boundary]


def gradient2d(img, half_window_x: int, half_window_y: int,
               poly_order: int, delta_x: float = 1.0, delta_y: float = 1.0,
               boundary=Boundary2D.CONSTANT,
               n_threads: Optional[int] = None):
    """(∂/∂x, ∂/∂y) of the local polynomial fit (x = columns, y = rows;
    reference parity: savgol2d_gradient, src/savgol2d.c:462-499)."""
    lib = load_library()
    img, oshape, b = _conv2d_prep(img, half_window_x, half_window_y,
                                  boundary)
    gx = np.empty(oshape, dtype=np.float32)
    gy = np.empty(oshape, dtype=np.float32)
    rc = lib.sgh2_gradient(
        half_window_x, half_window_y, poly_order, delta_x, delta_y,
        _ptr32(img), img.shape[0], img.shape[1], img.shape[1],
        _ptr32(gx), _ptr32(gy), oshape[1], b,
        -1 if n_threads is None else int(n_threads))
    if rc != 0:
        raise ValueError("native 2d gradient failed (bad config?)")
    return gx, gy


def hessian2d(img, half_window_x: int, half_window_y: int,
              poly_order: int, delta_x: float = 1.0, delta_y: float = 1.0,
              boundary=Boundary2D.CONSTANT,
              n_threads: Optional[int] = None):
    """(∂²/∂x², ∂²/∂x∂y, ∂²/∂y²) of the local fit (reference parity:
    savgol2d_hessian, src/savgol2d.c:501-558)."""
    lib = load_library()
    img, oshape, b = _conv2d_prep(img, half_window_x, half_window_y,
                                  boundary)
    hxx = np.empty(oshape, dtype=np.float32)
    hxy = np.empty(oshape, dtype=np.float32)
    hyy = np.empty(oshape, dtype=np.float32)
    rc = lib.sgh2_hessian(
        half_window_x, half_window_y, poly_order, delta_x, delta_y,
        _ptr32(img), img.shape[0], img.shape[1], img.shape[1],
        _ptr32(hxx), _ptr32(hxy), _ptr32(hyy), oshape[1], b,
        -1 if n_threads is None else int(n_threads))
    if rc != 0:
        raise ValueError("native 2d hessian failed (bad config?)")
    return hxx, hxy, hyy


def laplacian2d(img, half_window_x: int, half_window_y: int,
                poly_order: int, delta_x: float = 1.0,
                delta_y: float = 1.0, boundary=Boundary2D.CONSTANT,
                n_threads: Optional[int] = None) -> np.ndarray:
    """∂²/∂x² + ∂²/∂y² of the local fit, summed via the reference's
    temp-buffer scheme (savgol2d_laplacian, src/savgol2d.c:560-618)."""
    lib = load_library()
    img, oshape, b = _conv2d_prep(img, half_window_x, half_window_y,
                                  boundary)
    out = np.empty(oshape, dtype=np.float32)
    rc = lib.sgh2_laplacian(
        half_window_x, half_window_y, poly_order, delta_x, delta_y,
        _ptr32(img), img.shape[0], img.shape[1], img.shape[1],
        _ptr32(out), oshape[1], b,
        -1 if n_threads is None else int(n_threads))
    if rc != 0:
        raise ValueError("native 2d laplacian failed (bad config?)")
    return out
