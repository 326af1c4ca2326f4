"""The fused masked 1D kernel of the port (K9, ``csrc/masked1d.cu``), its
plain version and its launch count (counterpart of
``savgol_tpu.ops.pallas_masked``).

:func:`savgol_masked1d_fused_cuda` fits the order-m polynomial to the
positive-weight samples of every window of boundary-padded values and
weights and evaluates the derivative row ``extract`` at the window center,
with ``fill`` under quorum. A CPU tensor takes :func:`masked1d_plain`, the
staged version (pair-stencil and basis-stencil bank correlations, the plain
plane Cholesky, the extraction); a CUDA tensor launches K9 or raises.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from savgol_tpu_torch.ops.cuda_bank import bank_correlate_plain
from savgol_tpu_torch.ops.cuda_conv import (_check_cuda_input, _enqueue,
                                            _plain_or_cuda)
from savgol_tpu_torch.ops.cuda_solve import _work_size, scratch_for
from savgol_tpu_torch.ops.lsq import cholesky_solve_planes

__all__ = ["LAUNCHES", "reset_launches", "extract_fill", "masked1d_plain", "savgol_masked1d_fused_cuda",
           "SMEM_LIMIT"]

# Kernel launches since the last reset_launches(). Only the line that
# launches the kernel adds to its count.
LAUNCHES = {"masked1d": 0}

SMEM_LIMIT = 232_448        # bytes of shared memory a block may use (H100)
_TILE = 128                 # masked1d.cu kTile


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def extract_fill(coef: torch.Tensor, row, ok: torch.Tensor,
                 fill) -> torch.Tensor:
    """``sum_a row[a] * coef[a]`` over the planes of ``coef`` (k, ...), with
    ``fill`` where not ``ok``; ``row`` is a host (k,) array."""
    ex = torch.as_tensor(np.asarray(row), dtype=coef.dtype,
                         device=coef.device)
    y = (coef * ex.reshape((-1,) + (1,) * (coef.dim() - 1))).sum(0)
    return torch.where(ok, y, torch.full((), float(fill), dtype=y.dtype,
                                         device=y.device))


def masked1d_plain(xzp: torch.Tensor, wp: torch.Tensor, pair_w, pair_index,
                   qw, extract, *, half_window: int, kmin: int,
                   fill) -> torch.Tensor:
    """The staged masked fit over boundary-padded ``xzp`` (mask-sanitized
    values) and ``wp`` (weights, 0 = missing), (..., N + 2n) -> (..., N):
    the pair-stencil Gram of ``wp``, the basis-stencil rhs of ``xzp * wp``,
    the positive-weight count by a box correlation, the plane solve and the
    extraction (a bool mask is the weights 0 and 1)."""
    ws = 2 * int(half_window) + 1
    pi = np.asarray(pair_index)
    gram = bank_correlate_plain(wp, pair_w)
    rhs = bank_correlate_plain(xzp * wp, qw)
    count = bank_correlate_plain((wp > 0).to(xzp.dtype), np.ones((1, ws)))[0]
    coef, ok = cholesky_solve_planes(gram, pi, rhs, count >= (kmin - 0.5))
    return extract_fill(coef, extract, ok, fill)


@functools.lru_cache(maxsize=64)
def _device_tables(key: bytes, k: int, ws: int, dtype, device):
    """(pairs (Kp, ws) in packed lower order, qt (k, ws), extract (k,)) on
    the device, uploaded once per table set."""
    arr = np.frombuffer(key, dtype=np.float64)
    kp = k * (k + 1) // 2
    pairs, qt, ex = np.split(arr, [kp * ws, kp * ws + k * ws])
    return tuple(torch.as_tensor(a.copy(), dtype=dtype, device=device)
                 for a in (pairs, qt, ex))


def savgol_masked1d_fused_cuda(xzp: torch.Tensor, wp: torch.Tensor, pair_w,
                               pair_index, qw, extract, *, half_window: int,
                               kmin: int, fill) -> torch.Tensor:
    """Fused masked fit over boundary-padded values and weights, (..., N +
    2n) -> (..., N), with ``fill`` where fewer than ``kmin`` samples of the
    window have a positive weight. ``pair_w`` (Kp, ws), ``pair_index``
    (k, k), ``qw`` (k, ws) and ``extract`` (k,) are the host f64 tables.

    CUDA tensors: kernel K9 on the current stream, no synchronisation.
    CPU tensors: :func:`masked1d_plain`."""
    name = "savgol_masked1d_fused_cuda"
    n = int(half_window)
    if not _plain_or_cuda(xzp, name):
        return masked1d_plain(xzp, wp, pair_w, pair_index, qw, extract,
                              half_window=n, kmin=kmin, fill=fill)
    _check_cuda_input(xzp, name)
    _check_cuda_input(wp, name)
    if wp.shape != xzp.shape or wp.dtype != xzp.dtype \
            or wp.device != xzp.device:
        raise ValueError(f"{name}: values {tuple(xzp.shape)} {xzp.dtype} "
                         f"and weights {tuple(wp.shape)} {wp.dtype} differ")
    pi = np.asarray(pair_index)
    k = pi.shape[0]
    ws = 2 * n + 1
    Np = xzp.shape[-1]
    if n < 1 or Np < ws:
        raise ValueError(f"{name}: padded length {Np} is shorter than the "
                         f"window {ws}")
    smem = 2 * (_TILE + 2 * n) * xzp.element_size()
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"{name}: half window {n} needs {smem} bytes of shared memory "
            f"for the staged tile, past the {SMEM_LIMIT} a block may use")
    rows = [np.asarray(pair_w, np.float64)[pi[i, j]]
            for i in range(k) for j in range(i + 1)]
    key = np.concatenate([np.ravel(rows), np.ravel(np.asarray(qw, np.float64)),
                          np.asarray(extract, np.float64)]).tobytes()
    pairs, qt, ex = _device_tables(key, k, ws, xzp.dtype, xzp.device)
    out = torch.empty(xzp.shape[:-1] + (Np - 2 * n,), dtype=xzp.dtype,
                      device=xzp.device)
    B = xzp.numel() // Np
    if B == 0:
        return out
    tiles = B * -(-(Np - 2 * n) // _TILE)
    scratch, threads = scratch_for(k, tiles * _TILE, _work_size(k),
                                   xzp.dtype, xzp.device)
    _enqueue(name, LAUNCHES, "masked1d", xzp.device,
             "masked1d_f32" if xzp.dtype == torch.float32 else "masked1d_f64",
             xzp.data_ptr(), wp.data_ptr(), out.data_ptr(), B, Np, n, k,
             pairs.data_ptr(), qt.data_ptr(), ex.data_ptr(), int(kmin),
             float(fill), scratch.data_ptr() if scratch is not None else None,
             threads)
    return out
