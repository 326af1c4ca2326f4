"""The program's entry for ``sg2d_11x11o3_f32``:
``Savgol2D.create(Savgol2DConfig(5, 5, 3)).apply(img)``: CONSTANT boundary
(the entry's default), ``method="auto"``, float32 (kernel K2D-dense on the
card)."""

from __future__ import annotations

import torch

from savgol_tpu_torch import Savgol2D, Savgol2DConfig


def make(cfg: dict, device) -> Savgol2D:
    """The filter module, its stencil on ``device``."""
    return Savgol2D.create(
        Savgol2DConfig(cfg["half_window_x"], cfg["half_window_y"],
                       cfg["poly_order"], deriv_x=cfg["deriv_x"],
                       deriv_y=cfg["deriv_y"], delta_x=cfg["delta_x"],
                       delta_y=cfg["delta_y"]),
        dtype=getattr(torch, cfg["dtype"]), device=device)


def call(program: Savgol2D, x: torch.Tensor) -> torch.Tensor:
    """One call, as a user makes it."""
    return program.apply(x)
