"""1D filter module: precomputed weights as buffers + apply methods
(counterpart of ``savgol_tpu.models.filter1d``)."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from savgol_tpu_torch.config import BoundaryMode, SavgolConfig
from savgol_tpu_torch.ops.apply import savgol_apply, savgol_apply_valid
from savgol_tpu_torch.ops.weights import savgol_weights_np

__all__ = ["Savgol1D"]


class Savgol1D(nn.Module):
    """Savitzky-Golay filter with precomputed weights.

    The counterpart of the reference's ``SavgolFilter``: built once, then
    read-only. The center stencil (2n+1,), the edge rows (n, 2n+1) and
    ``dt_inv`` are buffers, so ``.to()`` and ``state_dict()`` carry them.
    Applying the module to a tensor on another device raises.

    Build with :meth:`create` (host f64 weights, then cast and placed) or
    :meth:`from_jax` (the leaves of a ``savgol_tpu.Savgol1D``).

    :meth:`apply` filters data, as in ``savgol_tpu``; it shadows
    ``nn.Module.apply(fn)``, which this module, having no submodules, does
    not need.
    """

    def __init__(self, config: SavgolConfig, center_weights: torch.Tensor,
                 edge_weights: torch.Tensor, dt_inv: torch.Tensor):
        super().__init__()
        self.config = config
        self.register_buffer("center_weights", center_weights)
        self.register_buffer("edge_weights", edge_weights)
        self.register_buffer("dt_inv", dt_inv)

    # -- lifecycle ----------------------------------------------------------

    @classmethod
    def create(cls, config: SavgolConfig, dtype=torch.float32, *,
               device) -> "Savgol1D":
        """Precompute weights in f64 on the host; cast and place them on
        ``device`` (reference ``savgol_create``, src/savgolFilter.c:688-718;
        validation is raised by the config constructor)."""
        center, edge = savgol_weights_np(config, dtype=np.float64)
        dt_scale = config.dt_scale
        dt_inv = 1.0 / dt_scale if dt_scale != 0.0 else 1.0
        return cls(
            config,
            torch.as_tensor(center, dtype=dtype, device=device),
            torch.as_tensor(edge, dtype=dtype, device=device),
            torch.as_tensor(dt_inv, dtype=dtype, device=device),
        )

    @classmethod
    def from_jax(cls, config: SavgolConfig, arrays: Sequence[np.ndarray], *,
                 device) -> "Savgol1D":
        """The port's module from a JAX ``Savgol1D``'s leaves, given as
        numpy arrays in pytree order: ``(center_weights, edge_weights,
        dt_inv)`` (``jax.tree_util.tree_leaves``). Dtypes are kept."""
        # np.array copies: arrays handed over from JAX are read-only
        center, edge, dt_inv = (np.array(a) for a in arrays)
        return cls(config,
                   torch.as_tensor(center, device=device),
                   torch.as_tensor(edge, device=device),
                   torch.as_tensor(dt_inv, device=device))

    # -- properties ---------------------------------------------------------

    @property
    def half_window(self) -> int:
        return self.config.half_window

    @property
    def window_size(self) -> int:
        return self.config.window_size

    def extra_repr(self) -> str:
        return repr(self.config)

    # -- application --------------------------------------------------------

    def apply(self, x: torch.Tensor, *, axis: int = -1,
              boundary: Optional[BoundaryMode] = None,
              reference_edge_sign: bool = False,
              method: str = "auto") -> torch.Tensor:
        """Filter ``axis`` of ``x``; same-shape output (reference
        ``savgol_apply``, src/savgolFilter.c:743-804).

        ``reference_edge_sign=True`` reproduces the C's sign-flipped
        leading-edge values for odd derivatives (see
        ``savgol_tpu_torch.ops.apply``)."""
        b = boundary if boundary is not None else self.config.boundary
        return savgol_apply(
            x, self.center_weights, self.edge_weights,
            half_window=self.config.half_window, boundary=b,
            dt_inv=self.dt_inv, derivative=self.config.derivative,
            reference_edge_sign=reference_edge_sign, axis=axis,
            method=method)

    def apply_valid(self, x: torch.Tensor, *, axis: int = -1,
                    method: str = "auto") -> torch.Tensor:
        """VALID-mode filter: output shorter by 2*half_window (reference
        ``savgol_apply_valid``, src/savgolFilter.c:821-850)."""
        return savgol_apply_valid(
            x, self.center_weights, half_window=self.config.half_window,
            dt_inv=self.dt_inv, axis=axis, method=method)

    def forward(self, x: torch.Tensor, **kw) -> torch.Tensor:
        return self.apply(x, **kw)
