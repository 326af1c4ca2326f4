"""Numeric helpers shared by the plain references: TF32 rounding (the
control's precision) and the largest error of an output block. Plain
PyTorch; nothing of the program."""

from __future__ import annotations

import torch

_TF32_MASK = -(1 << 13)        # keep the sign, the exponent, 10 mantissa bits


def tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to TF32's 10 explicit mantissa bits, to
    nearest (ties away from zero), as float32: what a TF32 tensor-core
    product reads of each operand."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + (1 << 12)) & _TF32_MASK).view(torch.float32)


def max_abs(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| in float64, +inf where either side is not finite
    (a NaN would otherwise compare as no error)."""
    d = (got.double() - want).abs()
    if d.numel() == 0:
        return 0.0
    d = torch.where(torch.isfinite(d), d, torch.full_like(d, float("inf")))
    return float(d.max())
