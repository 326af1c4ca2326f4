"""The plane-Cholesky solve kernels of the port and their launch counts
(counterpart of ``savgol_tpu.ops.pallas_solve``).

``plane_cholesky_solve`` (kernel K8a) and ``plane_cholesky_solve_dd``
(kernel K8b), both in ``csrc/plane_solve.cu``, solve one k x k SPD system
per position from Gram entry planes. Each dispatches on the device of the
tensors it is given: CPU tensors take the plain versions of ``ops/lsq.py``,
CUDA tensors launch the kernel or raise. Each is differentiable in the Gram
and rhs planes through autograd of its plain version, as the JAX package's
custom VJPs take the VJP of their jnp twins; ``ok`` has no gradient.

K8a solves k = 10 and 15 (the staged masked 2D route's orders 3 and 4), and
K8b every k <= 8, in compile-time instances whose workspace lives in
registers and shared memory; every other k (K8a's 21 and 28 among them)
keeps a thread's system in a local array up to k = 32 and past that in a
scratch buffer in device memory that the wrapper allocates. Which instance
runs is decided in the launch from k and the dtype. A pair table is
uploaded to the card once, keyed by its bytes, k and the device.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from savgol_tpu_torch.ops.apply import _grads_through
from savgol_tpu_torch.ops.cuda_conv import (_check_cuda_input, _enqueue,
                                            _plain_or_cuda)
from savgol_tpu_torch.ops.lsq import (cholesky_solve_planes,
                                      cholesky_solve_planes_dd)

__all__ = ["LAUNCHES", "reset_launches", "plane_cholesky_solve",
           "plane_cholesky_solve_dd", "plane_solve_cuda",
           "plane_solve_dd_cuda"]

# Kernel launches since the last reset_launches(), one count per wrapper.
# Only the line that launches a kernel adds to its count.
LAUNCHES = {"plane_solve": 0, "plane_solve_dd": 0}

LOCAL_KMAX = 32                 # plane_chol.cuh kLocalKmax
_SCRATCH_BLOCK = 128            # threads a block of the scratch kernels
_SCRATCH_BUDGET = 1 << 30       # bytes of scratch a launch may take


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def scratch_for(k: int, n_items: int, words_per_item: int, dtype,
                device, local_kmax: int = LOCAL_KMAX
                ) -> tuple[torch.Tensor | None, int]:
    """(scratch, threads) for a kernel whose k passes ``local_kmax``: each
    thread takes ``words_per_item`` elements of ``dtype``; the thread count
    is a multiple of 128, no more than ``n_items`` rounded up and no more
    than the budget allows. (None, 0) when k fits the local arrays."""
    if k <= local_kmax:
        return None, 0
    esize = torch.empty((), dtype=dtype).element_size()
    cap = max(1, _SCRATCH_BUDGET // (words_per_item * esize) // _SCRATCH_BLOCK)
    need = -(-n_items // _SCRATCH_BLOCK)
    threads = min(cap, need) * _SCRATCH_BLOCK
    return torch.empty(threads * words_per_item, dtype=dtype,
                       device=device), threads


def _work_size(k: int) -> int:
    return k * (k + 1) + 6 * k          # plane_chol.cuh work_size


def _dd_work_size(k: int) -> int:
    return 2 * k * (k + 1) + 8 * k      # plane_chol.cuh dd_work_size


@functools.lru_cache(maxsize=64)
def _device_table(raw: bytes, k: int, device: str) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(raw, dtype=np.int32).reshape(
        k, k).copy()).to(device)


def _pair_table(pair_index, k: int, planes: int, device) -> torch.Tensor:
    """pair_index as an int32 table on the device; each entry names one of
    the ``planes`` Gram planes (k(k+1)/2 for a full Gram, 2k-1 for a
    Hankel). The device copy is made once for each table's bytes, k and
    device, so a caller who edits their array gets a new one."""
    pi = np.asarray(pair_index, dtype=np.int32)
    if pi.shape != (k, k):
        raise ValueError(f"pair_index must be ({k}, {k}), got {pi.shape}")
    if pi.min() < 0 or pi.max() >= planes:
        raise ValueError(f"pair_index names planes {pi.min()}..{pi.max()} "
                         f"of a gram stack of {planes}")
    return _device_table(np.ascontiguousarray(pi).tobytes(), k,
                         str(torch.device(device)))


def _geometry(gram: torch.Tensor, rhs: torch.Tensor, quorum: torch.Tensor,
              name: str) -> tuple[int, int]:
    """(k, positions); raises for shapes and devices the kernels do not
    take."""
    _check_cuda_input(gram, name)
    _check_cuda_input(rhs, name)
    k = rhs.shape[0]
    if gram.shape[1:] != rhs.shape[1:]:
        raise ValueError(f"{name}: gram {tuple(gram.shape)} and rhs "
                         f"{tuple(rhs.shape)} are not planes of one shape")
    if quorum.shape != rhs.shape[1:]:
        raise ValueError(f"{name}: quorum {tuple(quorum.shape)} is not the "
                         f"plane shape {tuple(rhs.shape[1:])}")
    if rhs.dtype != gram.dtype or {gram.device, rhs.device,
                                   quorum.device} != {gram.device}:
        raise ValueError(f"{name}: gram, rhs and quorum need one dtype and "
                         "one device")
    return k, rhs[0].numel()


def plane_solve_cuda(gram: torch.Tensor, pair_index, rhs: torch.Tensor,
                     quorum: torch.Tensor, rcond: float | None = None):
    """``(coef, ok)`` of ``G c = r`` per position from Gram entry planes
    (gram (Kp, ...), rhs (k, ...), quorum (...) bool).

    CUDA tensors: kernel K8a on the current stream, no synchronisation.
    CPU tensors: :func:`ops.lsq.cholesky_solve_planes`.
    """
    name = "plane_solve_cuda"
    if not _plain_or_cuda(gram, name):
        return cholesky_solve_planes(gram, pair_index, rhs, quorum, rcond)
    k, pos = _geometry(gram, rhs, quorum, name)
    pi = _pair_table(pair_index, k, gram.shape[0], gram.device)
    coef = torch.empty_like(rhs)
    ok = torch.empty(quorum.shape, dtype=torch.bool, device=gram.device)
    if pos == 0:
        return coef, ok
    q = quorum.to(torch.bool).contiguous()
    scratch, threads = scratch_for(k, pos, _work_size(k), gram.dtype,
                                   gram.device)
    _enqueue(name, LAUNCHES, "plane_solve", gram.device,
             "plane_solve_f32" if gram.dtype == torch.float32
             else "plane_solve_f64",
             gram.data_ptr(), rhs.data_ptr(), q.data_ptr(), pi.data_ptr(),
             coef.data_ptr(), ok.data_ptr(), k, pos, int(rcond is not None),
             math.sqrt(rcond) if rcond is not None else 0.0,
             scratch.data_ptr() if scratch is not None else None, threads)
    return coef, ok


def plane_solve_dd_cuda(gram_hi, gram_lo, pair_index, rhs_hi, rhs_lo,
                        quorum, rcond: float | None = None, *,
                        runtime_form: bool = False):
    """``(coef, ok)`` of ``G c = r`` from (hi, lo) Gram and rhs planes.

    CUDA tensors: kernel K8b (double-word arithmetic on FP64 pairs; float32
    pairs enter exactly as doubles) on the current stream; ``runtime_form``
    runs its runtime instance at every k (the compile-time ones take k <=
    8), which must give the same bits. CPU tensors:
    :func:`ops.lsq.cholesky_solve_planes_dd`.
    """
    name = "plane_solve_dd_cuda"
    if not _plain_or_cuda(gram_hi, name):
        return cholesky_solve_planes_dd(gram_hi, gram_lo, pair_index, rhs_hi,
                                        rhs_lo, quorum, rcond)
    k, pos = _geometry(gram_hi, rhs_hi, quorum, name)
    for lo, hi in ((gram_lo, gram_hi), (rhs_lo, rhs_hi)):
        _check_cuda_input(lo, name)
        if lo.shape != hi.shape or lo.dtype != hi.dtype \
                or lo.device != hi.device:
            raise ValueError(f"{name}: a lo word differs from its hi word "
                             "in shape, dtype or device")
    pi = _pair_table(pair_index, k, gram_hi.shape[0], gram_hi.device)
    coef = torch.empty_like(rhs_hi)
    ok = torch.empty(quorum.shape, dtype=torch.bool, device=gram_hi.device)
    if pos == 0:
        return coef, ok
    q = quorum.to(torch.bool).contiguous()
    scratch, threads = scratch_for(k, pos, _dd_work_size(k), torch.float64,
                                   gram_hi.device)
    _enqueue(name, LAUNCHES, "plane_solve_dd", gram_hi.device,
             "plane_solve_dd_f32" if gram_hi.dtype == torch.float32
             else "plane_solve_dd_f64",
             gram_hi.data_ptr(), gram_lo.data_ptr(), rhs_hi.data_ptr(),
             rhs_lo.data_ptr(), q.data_ptr(), pi.data_ptr(), coef.data_ptr(),
             ok.data_ptr(), k, pos, int(rcond is not None),
             math.sqrt(rcond) if rcond is not None else 0.0,
             scratch.data_ptr() if scratch is not None else None, threads,
             int(runtime_form))
    return coef, ok


class _SolveFn(torch.autograd.Function):
    """K8a forward; backward through ``cholesky_solve_planes`` (the
    counterpart of ``pallas_solve._solve_diff``)."""

    @staticmethod
    def forward(ctx, gram, rhs, quorum, pair_index, rcond):
        coef, ok = plane_solve_cuda(gram, pair_index, rhs, quorum, rcond)
        ctx.save_for_backward(gram, rhs, quorum)
        ctx.pair_index, ctx.rcond = pair_index, rcond
        ctx.mark_non_differentiable(ok)
        return coef, ok

    @staticmethod
    def backward(ctx, g_coef, _g_ok):
        gram, rhs, quorum = ctx.saved_tensors

        def plain(g, r):
            return cholesky_solve_planes(g, ctx.pair_index, r, quorum,
                                         ctx.rcond)[0]
        grads = _grads_through(plain, (gram, rhs), ctx.needs_input_grad[:2],
                               g_coef)
        return (*grads, None, None, None)


class _SolveDdFn(torch.autograd.Function):
    """K8b forward; backward through ``cholesky_solve_planes_dd`` (the
    counterpart of ``pallas_solve._solve_diff_dd``)."""

    @staticmethod
    def forward(ctx, ghi, glo, rhi, rlo, quorum, pair_index, rcond):
        coef, ok = plane_solve_dd_cuda(ghi, glo, pair_index, rhi, rlo, quorum,
                                       rcond)
        ctx.save_for_backward(ghi, glo, rhi, rlo, quorum)
        ctx.pair_index, ctx.rcond = pair_index, rcond
        ctx.mark_non_differentiable(ok)
        return coef, ok

    @staticmethod
    def backward(ctx, g_coef, _g_ok):
        *planes, quorum = ctx.saved_tensors

        def plain(gh, gl, rh, rl):
            return cholesky_solve_planes_dd(gh, gl, ctx.pair_index, rh, rl,
                                            quorum, ctx.rcond)[0]
        grads = _grads_through(plain, planes, ctx.needs_input_grad[:4],
                               g_coef)
        return (*grads, None, None, None)


def plane_cholesky_solve(gram, pair_index, rhs, quorum, rcond=None):
    """Per-position SPD solve on Gram entry planes (K8a on the card),
    differentiable in ``gram`` and ``rhs``. Returns ``(coef, ok)``."""
    return _SolveFn.apply(gram.contiguous(), rhs.contiguous(), quorum,
                          np.asarray(pair_index),
                          None if rcond is None else float(rcond))


def plane_cholesky_solve_dd(gram_hi, gram_lo, pair_index, rhs_hi, rhs_lo,
                            quorum, rcond=None):
    """Double-word per-position solve (K8b on the card), differentiable in
    the four plane stacks. Returns ``(coef, ok)``."""
    return _SolveDdFn.apply(gram_hi.contiguous(), gram_lo.contiguous(),
                            rhs_hi.contiguous(), rhs_lo.contiguous(), quorum,
                            np.asarray(pair_index),
                            None if rcond is None else float(rcond))
