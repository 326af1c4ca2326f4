"""The program's entry for ``scipy_w25o4_mirror_f32``:
``savgol_tpu_torch.scipy_compat.savgol_filter(x, 25, 4, mode="mirror")``,
scipy's signature after an import swap: derivative 0, ``delta`` 1.0, the
last axis, ``method="auto"``, float32 (on the card: the reflect pad, kernel
K3, then the multiply by ``1/delta**deriv``)."""

from __future__ import annotations

import torch

from savgol_tpu_torch.scipy_compat import savgol_filter


def make(cfg: dict, device) -> dict:
    """The call's arguments past the data; scipy's entry holds no state
    (its weights are built anew in every call)."""
    return {"window_length": cfg["window_length"],
            "polyorder": cfg["polyorder"], "deriv": cfg["deriv"],
            "delta": cfg["delta"], "mode": cfg["mode"]}


def call(program: dict, x: torch.Tensor) -> torch.Tensor:
    """One call, as a user makes it."""
    return savgol_filter(x, program["window_length"], program["polyorder"],
                         deriv=program["deriv"], delta=program["delta"],
                         mode=program["mode"])
