"""The program's entry for ``sg1d_n12m4_bf16``:
``Savgol1D.create(SavgolConfig(12, 4)).apply(x, method="bf16")`` on bf16
samples: POLYNOMIAL boundary, derivative 0, float32 weights (kernel
K1-bf16 on the card, after the taps' rounding to bf16)."""

from __future__ import annotations

import torch

from savgol_tpu_torch import Savgol1D, SavgolConfig


def make(cfg: dict, device) -> Savgol1D:
    """The filter module, its weights on ``device``."""
    return Savgol1D.create(
        SavgolConfig(cfg["half_window"], cfg["poly_order"],
                     derivative=cfg["derivative"],
                     time_step=cfg["time_step"]),
        dtype=getattr(torch, cfg["weights_dtype"]), device=device)


def call(program: Savgol1D, x: torch.Tensor) -> torch.Tensor:
    """One call, as a user makes it."""
    return program.apply(x, method="bf16")
