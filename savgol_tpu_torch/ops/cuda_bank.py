"""The K-stencil bank kernel of the port (K4, ``csrc/corr1d_bank.cu``), its
plain version and its launch count (counterpart of
``savgol_tpu.ops.pallas_conv.correlate_valid_bank_pallas`` and
``correlate_valid_bank_pallas_mxu``).

Both compute ``out[k, ..., j] = sum_t w[k, t] * xv[..., j - pad + t]`` for
every stencil of a (K, ws) stack, where ``xv`` is the last axis of ``x``
extended by ``pad`` samples on each side (zeros, or numpy's ``pad_mode``):
the VALID bank of the TPU kernels at ``pad = 0``, and the same-length
(K, ..., N) output of ``SavgolBank`` (``pad = n``) and of the sweep
(``pad = 32``) in one pass, with no padded copy of ``x``. A CPU tensor takes
:func:`bank_correlate_plain`, a CUDA tensor launches K4 or raises.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from savgol_tpu_torch.ops.cuda_conv import (MODE_CODE, _check_cuda_input,
                                            _enqueue, _plain_or_cuda,
                                            _weights_on,
                                            correlate_valid_plain, pad_last)

__all__ = ["LAUNCHES", "reset_launches", "bank_correlate_plain",
           "correlate_valid_bank_cuda"]

# Kernel launches since the last reset_launches(). Only the line that
# launches the kernel adds to its count.
LAUNCHES = {"corr1d_bank": 0}


# The bank's tap buffer (csrc/corr1d_bank.cu kBankMaxWs): the sweep's and
# SavgolBank's 2 * MAX_HALF_WINDOW + 1, below the 1D tile kernels' 129.
_BANK_MAX_WS = 65


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def bank_correlate_plain(x: torch.Tensor, w, pad: int = 0,
                         pad_mode: Optional[str] = None) -> torch.Tensor:
    """K-stencil correlation, (..., N) x (K, ws) -> (K, ..., N + 2 pad - ws
    + 1), of ``x`` padded by ``pad`` on each side (counterpart of
    ``savgol_tpu.ops.masked._bank_correlate`` after a pad); ``w`` is a host
    array or a tensor, taken in ``x``'s dtype."""
    if isinstance(w, torch.Tensor):
        w = w.to(x.dtype)
    else:
        w = torch.as_tensor(np.asarray(w), dtype=x.dtype, device=x.device)
    xp = pad_last(x, int(pad), pad_mode) if pad else x
    return torch.stack([correlate_valid_plain(xp, wk) for wk in w])


def correlate_valid_bank_cuda(x: torch.Tensor, w: torch.Tensor, pad: int = 0,
                              pad_mode: Optional[str] = None) -> torch.Tensor:
    """K-stencil correlation along the last axis of ``x`` (..., N) with the
    (K, ws) stack ``w``, ws <= 65, any K >= 1; output (K, ..., N + 2 pad -
    ws + 1), ``x`` padded by ``pad`` zeros (``pad_mode`` None) or in
    ``pad_mode`` ("edge" / "symmetric" / "wrap", any width).

    CUDA tensor: kernel K4 on the current stream, no synchronisation, one
    read of ``x`` for the whole stack. CPU tensor:
    :func:`bank_correlate_plain`.
    """
    name = "correlate_valid_bank_cuda"
    if not _plain_or_cuda(x, name):
        return bank_correlate_plain(x, w, pad, pad_mode)
    _check_cuda_input(x, name)
    if pad_mode not in MODE_CODE:
        raise ValueError(f"{name}: unsupported pad mode {pad_mode!r}")
    if w.dim() != 2 or w.shape[0] < 1 or not 1 <= w.shape[1] <= _BANK_MAX_WS:
        raise ValueError(f"{name}: stencils must be (K >= 1, "
                         f"1..{_BANK_MAX_WS}), "
                         f"got shape {tuple(w.shape)}")
    K, ws = w.shape
    pad = int(pad)
    N = x.shape[-1]
    n_out = N + 2 * pad - ws + 1
    if pad < 0 or N < 1 or n_out < 1:
        raise ValueError(f"data length ({N}) padded by {pad} on each side "
                         f"must be >= window size ({ws})")
    wc = _weights_on(w, x, name).contiguous()
    out = torch.empty((K,) + x.shape[:-1] + (n_out,), dtype=x.dtype,
                      device=x.device)
    B = x.numel() // N
    if B == 0:
        return out
    _enqueue(name, LAUNCHES, "corr1d_bank", x.device,
             "corr1d_bank_f32" if x.dtype == torch.float32
             else "corr1d_bank_f64",
             x.data_ptr(), wc.data_ptr(), out.data_ptr(), B, N, K, ws, pad,
             MODE_CODE[pad_mode])
    return out
