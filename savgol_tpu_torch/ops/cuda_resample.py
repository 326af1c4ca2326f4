"""The resample gather-evaluate kernel of the port (K12,
``csrc/resample.cu``), its plain version and its launch count (counterpart
of ``savgol_tpu.ops.pallas_resample`` and of the evaluation half of
``savgol_resample``'s ``method="auto"``).

Given the (m+3, ..., N) plane stack of the nonuniform fit (coefficients in
each window's ``u/s`` basis, then ``s``, then ``ok`` as 0/1), the window
centre ``ctr[q]`` of every query and the query abscissae, it evaluates the
d-th derivative of each centre's polynomial at its query:

    u = (tq[q] - t[ctr[q]]) / s,   y = sum_{k>=d} c_k k!/(k-d)! u^(k-d) / s^d,

with ``fill`` where the centre's fit is not ok. The offset is formed in
``t``'s own dtype before the cast to the working dtype. A CPU tensor takes
:func:`resample_eval_plain`; a CUDA tensor launches the kernel or raises.
The TPU kernel gathers by a one-hot matmul over two slabs and is only
valid for clustered queries; one thread per (row, query) reads its own
centre here, so any query order is valid.
"""

from __future__ import annotations

import math

import torch

from savgol_tpu_torch.ops.cuda_conv import (_check_cuda_input, _enqueue,
                                            _plain_or_cuda)

__all__ = ["LAUNCHES", "reset_launches", "resample_eval_plain",
           "resample_eval_cuda"]

# Kernel launches since the last reset_launches(). Only the line that
# launches the kernel adds to its count.
LAUNCHES = {"resample": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def resample_eval_plain(planes: torch.Tensor, t: torch.Tensor,
                        ctr: torch.Tensor, tq: torch.Tensor, *,
                        poly_order: int, derivative: int,
                        fill) -> torch.Tensor:
    """Gather the plane stack (m+3, ..., N) at the centres ``ctr`` (Nq,)
    and Horner-evaluate the d-th derivative at ``tq`` (Nq,); -> (..., Nq).
    """
    m, d = int(poly_order), int(derivative)
    dtype = planes.dtype
    g = planes.index_select(-1, ctr)                    # (m+3, ..., Nq)
    ck, sg, okg = g[:m + 1], g[m + 1], g[m + 2] > 0.5
    uq = (tq - t[ctr]).to(dtype) / sg
    acc = ck[m] * float(math.factorial(m) // math.factorial(m - d))
    for k in range(m - 1, d - 1, -1):
        acc = acc * uq + ck[k] * float(math.factorial(k)
                                       // math.factorial(k - d))
    y = acc / sg ** d
    return torch.where(okg, y, torch.full((), float(fill), dtype=dtype,
                                          device=y.device))


def resample_eval_cuda(planes: torch.Tensor, t: torch.Tensor,
                       ctr: torch.Tensor, tq: torch.Tensor, *,
                       poly_order: int, derivative: int,
                       fill) -> torch.Tensor:
    """Evaluate the plane stack at the query centres, as
    :func:`resample_eval_plain`.

    CUDA tensors: kernel K12 on the current stream, no synchronisation;
    ``t`` and ``tq`` share a dtype (float32 or float64), ``ctr`` is int64.
    CPU tensors: :func:`resample_eval_plain`."""
    name = "resample_eval_cuda"
    m, d = int(poly_order), int(derivative)
    if not _plain_or_cuda(planes, name):
        return resample_eval_plain(planes, t, ctr, tq, poly_order=m,
                                   derivative=d, fill=fill)
    _check_cuda_input(planes, name)
    if planes.dim() < 2 or planes.shape[0] != m + 3 or not 0 <= d <= m:
        raise ValueError(f"{name}: planes {tuple(planes.shape)} is not an "
                         f"(m+3, ..., N) stack for m={m}, d={d}")
    N = planes.shape[-1]
    Nq = tq.shape[0] if tq.dim() == 1 else -1
    for a, what in ((t, "t"), (tq, "t_query")):
        _check_cuda_input(a, name)
        if a.dim() != 1 or a.device != planes.device:
            raise ValueError(f"{name}: {what} must be 1D on {planes.device}")
    if t.shape[0] != N or tq.dtype != t.dtype:
        raise ValueError(f"{name}: t ({t.shape[0]},) {t.dtype} must hold N="
                         f"{N} samples in t_query's dtype {tq.dtype}")
    if ctr.dtype != torch.int64 or tuple(ctr.shape) != (Nq,) or \
            not ctr.is_contiguous() or ctr.device != planes.device:
        raise ValueError(f"{name}: centres must be a contiguous int64 "
                         f"({Nq},) tensor on {planes.device}")
    out = torch.empty(planes.shape[1:-1] + (Nq,), dtype=planes.dtype,
                      device=planes.device)
    B = planes[0].numel() // N if N else 0
    if B == 0 or Nq == 0:
        return out
    _enqueue(name, LAUNCHES, "resample", planes.device,
             "resample_{}_t{}".format(
                 "f32" if planes.dtype == torch.float32 else "f64",
                 "32" if t.dtype == torch.float32 else "64"),
             planes.data_ptr(), t.data_ptr(), ctr.data_ptr(), tq.data_ptr(),
             out.data_ptr(), B, N, Nq, m, d, float(fill))
    return out
