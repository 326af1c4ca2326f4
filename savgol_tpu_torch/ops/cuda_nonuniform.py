"""The fused nonuniform fit kernel of the port (K11 and its planes mode K11p,
``csrc/nonuniform.cu``), its plain version and its launch count
(counterpart of ``savgol_tpu.ops.pallas_nonuniform`` and of the fit half of
``savgol_tpu.ops.nonuniform``).

Per output position p the order-m polynomial is fitted, by weighted least
squares, to the positive-weight samples among p's ``2n+1`` index-neighbours
(edges truncate) in p's own coordinates ``u = t[p+j] - t[p]``, normalized by
``s = max|u|``. The normal equations are a Hankel of ``2m+1`` moments,
formed in double-word arithmetic and solved by the double-word plane
Cholesky. :func:`savgol_nonuniform_fused_cuda` returns the d-th derivative
at p (``fill`` where the window is under quorum or does not identify the
fit); :func:`savgol_nonuniform_planes_cuda` returns the ``(m+3, ..., N)``
stack ``savgol_resample`` evaluates: the coefficients in the ``u/s`` basis,
then ``s``, then ``ok`` as 0/1.

A CPU tensor takes the plain version (:func:`_fit_coeffs` over
:func:`_staged_taps`, the JAX package's staged twin step by step, on the
double-word helpers of ``ops/lsq.py``); a CUDA tensor launches the kernel or
raises. ``t`` may be float32 or float64 whatever the data's dtype: offsets
are formed in ``t``'s own dtype before the cast to the working dtype, so
epoch-scale float64 time stamps keep their resolution beside float32 data.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch
import torch.nn.functional as F

from savgol_tpu_torch._build import library
from savgol_tpu_torch.ops.cuda_conv import (_check_cuda_input, _enqueue,
                                            _plain_or_cuda, _raise_on_error)
from savgol_tpu_torch.ops.cuda_solve import scratch_for
from savgol_tpu_torch.ops.lsq import (_dd_add, _dd_mul, _split_const,
                                      cholesky_solve_planes_dd)

__all__ = ["LAUNCHES", "reset_launches", "nonuniform_plain",
           "nonuniform_planes_plain", "savgol_nonuniform_fused_cuda",
           "savgol_nonuniform_planes_cuda", "nonuniform_layout",
           "SMEM_LIMIT"]

# Kernel launches since the last reset_launches(), both modes of K11 in one
# count. Only the line that launches the kernel adds to it.
LAUNCHES = {"nonuniform": 0}

SMEM_LIMIT = 232_448        # bytes of shared memory a block may use (H100)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# -- the plain version ---------------------------------------------------------


def _staged_taps(xz, wts, tl, n: int):
    """Tap accessor over index-window planes, edges truncated (zero pad,
    weight 0): ``tap(j)`` gives the j-th tap of every window as (..., N)
    planes ``(x_j, w_j, u_j)``, the offsets in ``tl``'s own dtype."""
    n_out = xz.shape[-1]
    xzp, wp, tzp = (F.pad(a, (n, n)) for a in (xz, wts, tl))

    def tap(j):
        return (xzp[..., j:j + n_out], wp[..., j:j + n_out],
                tzp[..., j:j + n_out] - tl)

    return tap


def _fit_coeffs(tap, ws: int, m: int, kmin: int, rcond: float, dtype,
                solve=cholesky_solve_planes_dd, acc=None):
    """Per-window weighted LS from a tap accessor: ``(coef, s, ok)`` with
    coef the (m+1, ..., P) coefficients in each window's ``u/s`` basis, s
    the (..., P) normalizers and ok the quorum-and-identifiability mask.

    Pass 1 takes the normalizer (largest valid |u|, 1 when all coincide)
    and the quorum count; pass 2 accumulates the Hankel moments
    ``S_p = sum w (u/s)^p``, p <= 2m, and the rhs ``sum w x (u/s)^q``, q <= m,
    in double-word arithmetic, invalid taps carrying u = 0 so that a NaN or
    epoch-scale offset cannot turn a w = 0 product into inf * 0. The solve
    squares ``rcond``: it gates on the Cholesky diagonal, the square roots
    of the design's singular values' squares.

    ``solve`` is the double-word plane solve (the plain one by default;
    ``cuda_solve.plane_cholesky_solve_dd`` launches K8b on a CUDA tensor).
    ``acc`` is the dtype of the moments and the solve, the working dtype by
    default: float64 on float32 data keeps the float32 design and does
    K11's own arithmetic (double-word FP64) in plain PyTorch."""
    acc = dtype if acc is None else acc
    s = count = None
    for j in range(ws):
        _, w_j, u_j = tap(j)
        valid = w_j > 0
        au = torch.where(valid, u_j.abs(), 0)
        s = au if s is None else torch.maximum(s, au)
        c_j = valid.to(dtype)
        count = c_j if count is None else count + c_j
    s = torch.where(s > 0, s, 1).to(dtype)
    sinv = 1.0 / s
    quorum = count >= kmin

    c = _split_const(acc)
    zero = torch.zeros_like(s, dtype=acc)
    n_mom = 2 * m + 1
    S = [(zero, zero)] * n_mom
    r = [(zero, zero)] * (m + 1)
    for j in range(ws):
        x_j, w_j, u_j = tap(j)
        wx_j = (w_j * x_j).to(acc)
        u_j = torch.where(w_j > 0, u_j, 0)
        un_j = ((u_j.to(dtype) * sinv).to(acc), zero)
        w_j = w_j.to(acc)
        pw = (torch.ones_like(zero), zero)
        for p in range(n_mom):
            S[p] = _dd_add(S[p], _dd_mul(pw, (w_j, zero), c))
            if p <= m:
                r[p] = _dd_add(r[p], _dd_mul(pw, (wx_j, zero), c))
            if p + 1 < n_mom:
                pw = _dd_mul(pw, un_j, c)

    hankel = np.add.outer(np.arange(m + 1), np.arange(m + 1))
    coef, ok = solve(
        torch.stack([h for h, _ in S]), torch.stack([lo for _, lo in S]),
        hankel, torch.stack([h for h, _ in r]),
        torch.stack([lo for _, lo in r]), quorum, rcond=float(rcond) ** 2)
    return coef.to(dtype), s, ok


def _fit_taps(tap, ws: int, m: int, d: int, kmin: int, rcond: float, fill,
              dtype, **fit):
    """The d-th derivative at each window's own abscissa, ``c_d d! / s^d``,
    with ``fill`` where :func:`_fit_coeffs` (given ``fit``'s ``solve`` and
    ``acc``) reports not ok."""
    coef, s, ok = _fit_coeffs(tap, ws, m, kmin, rcond, dtype, **fit)
    y = coef[d] * (float(math.factorial(d)) / s ** d)
    return torch.where(ok, y, torch.full((), float(fill), dtype=dtype,
                                         device=y.device))


def _full_t(tl: torch.Tensor, xz: torch.Tensor) -> torch.Tensor:
    """Abscissae shaped like the data (a shared (N,) row broadcast)."""
    return tl.expand(xz.shape) if tl.dim() == 1 else tl


def nonuniform_plain(xz, wts, tl, *, half_window: int, poly_order: int,
                     derivative: int, kmin: int, fill, rcond: float,
                     acc=None):
    """The staged fit of mask-sanitized values ``xz``, weights ``wts`` (0 =
    missing) and raw abscissae ``tl`` (shaped like ``xz`` or a shared (N,)
    row), (..., N) -> (..., N): the d-th derivative at each sample. ``acc``
    as in :func:`_fit_coeffs`."""
    n = int(half_window)
    return _fit_taps(_staged_taps(xz, wts, _full_t(tl, xz), n), 2 * n + 1,
                     int(poly_order), int(derivative), int(kmin), rcond, fill,
                     xz.dtype, acc=acc)


def nonuniform_planes_plain(xz, wts, tl, *, half_window: int,
                            poly_order: int, kmin: int, rcond: float):
    """The staged fit as the (m+3, ..., N) plane stack: coefficients 0..m
    in the ``u/s`` basis, then ``s``, then ``ok`` as 0/1."""
    n = int(half_window)
    coef, s, ok = _fit_coeffs(_staged_taps(xz, wts, _full_t(tl, xz), n),
                              2 * n + 1, int(poly_order), int(kmin), rcond,
                              xz.dtype)
    return torch.cat([coef, s[None], ok.to(xz.dtype)[None]])


# -- the kernel ------------------------------------------------------------------


def nonuniform_layout(n: int, m: int, x_dtype, t_dtype) -> tuple[int, int,
                                                                   int]:
    """(shared memory bytes of a block, doubles of device scratch a thread
    (0 when the compile-time instance for k = m + 1 runs at this n), outputs
    a block) of K11
    for half window n and order m, as ``nonuniform.cu`` states them. Builds
    the kernel library."""
    out = (ctypes.c_longlong * 3)()
    err = library().nonuniform_layout(
        int(n), int(m), torch.empty((), dtype=x_dtype).element_size(),
        torch.empty((), dtype=t_dtype).element_size(), out)
    _raise_on_error(err, "nonuniform_layout")
    return out[0], out[1], out[2]


def _launch(name, xz, wts, tl, n, m, d, kmin, fill, rcond, emit_planes):
    _check_cuda_input(xz, name)
    _check_cuda_input(wts, name)
    if wts.shape != xz.shape or wts.dtype != xz.dtype \
            or wts.device != xz.device:
        raise ValueError(f"{name}: values {tuple(xz.shape)} {xz.dtype} and "
                         f"weights {tuple(wts.shape)} {wts.dtype} differ")
    if tl.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: the kernel takes t in float32 or float64, "
                        f"got {tl.dtype}")
    N = xz.shape[-1]
    if tl.device != xz.device or not tl.is_contiguous() or \
            tuple(tl.shape) not in (tuple(xz.shape), (N,)):
        raise ValueError(f"{name}: t {tuple(tl.shape)} on {tl.device} must "
                         f"be contiguous on {xz.device}, shaped like the data "
                         f"{tuple(xz.shape)} or ({N},)")
    if n < 1 or not 0 <= m <= 2 * n or not 0 <= d <= m:
        raise ValueError(f"{name}: need n >= 1, 0 <= m <= 2n, 0 <= d <= m; "
                         f"got n={n}, m={m}, d={d}")
    smem, work, tile = nonuniform_layout(n, m, xz.dtype, tl.dtype)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"{name}: half window {n} needs {smem} bytes of shared memory "
            f"for the staged tile, past the {SMEM_LIMIT} a block may use; "
            "method='xla' runs the plain version")
    shape = ((m + 3,) if emit_planes else ()) + tuple(xz.shape)
    out = torch.empty(shape, dtype=xz.dtype, device=xz.device)
    B = xz.numel() // N if N else 0
    if B == 0:
        return out
    scratch, threads = None, 0
    if work:
        scratch, threads = scratch_for(m + 1, B * -(-N // tile) * tile, work,
                                       torch.float64, xz.device, 0)
    # the plain solve takes rcond**2 and gates on its square root (as K8b)
    _enqueue(name, LAUNCHES, "nonuniform", xz.device,
             "nonuniform_{}_t{}".format(
                 "f32" if xz.dtype == torch.float32 else "f64",
                 "32" if tl.dtype == torch.float32 else "64"),
             xz.data_ptr(), wts.data_ptr(), tl.data_ptr(), out.data_ptr(), B,
             N, 0 if tl.dim() == 1 else N, n, m, d, int(kmin), float(fill),
             math.sqrt(float(rcond) ** 2), int(emit_planes),
             scratch.data_ptr() if scratch is not None else None, threads)
    return out


def savgol_nonuniform_fused_cuda(xz, wts, tl, *, half_window: int,
                                 poly_order: int, derivative: int, kmin: int,
                                 fill, rcond: float) -> torch.Tensor:
    """Fused nonuniform fit, (..., N) -> (..., N): the d-th derivative at
    each sample's own abscissa, ``fill`` where not ok.

    CUDA tensors: kernel K11 on the current stream, no synchronisation.
    CPU tensors: :func:`nonuniform_plain`."""
    name = "savgol_nonuniform_fused_cuda"
    kw = dict(half_window=half_window, poly_order=poly_order, kmin=kmin,
              rcond=rcond)
    if not _plain_or_cuda(xz, name):
        return nonuniform_plain(xz, wts, tl, derivative=derivative,
                                fill=fill, **kw)
    return _launch(name, xz, wts, tl, int(half_window), int(poly_order),
                   int(derivative), kmin, fill, rcond, False)


def savgol_nonuniform_planes_cuda(xz, wts, tl, *, half_window: int,
                                  poly_order: int, kmin: int,
                                  rcond: float) -> torch.Tensor:
    """Fused nonuniform fit as the (m+3, ..., N) plane stack (coefficients,
    ``s``, ``ok`` as 0/1).

    CUDA tensors: kernel K11 in its planes mode (K11p). CPU tensors:
    :func:`nonuniform_planes_plain`."""
    name = "savgol_nonuniform_planes_cuda"
    if not _plain_or_cuda(xz, name):
        return nonuniform_planes_plain(xz, wts, tl, half_window=half_window,
                                       poly_order=poly_order, kmin=kmin,
                                       rcond=rcond)
    return _launch(name, xz, wts, tl, int(half_window), int(poly_order), 0,
                   kmin, 0.0, rcond, True)
