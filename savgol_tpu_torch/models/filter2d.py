"""2D filter module: precomputed stencil as a buffer + apply methods
(counterpart of ``savgol_tpu.models.filter2d``)."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from savgol_tpu_torch.config import Boundary2D, Savgol2DConfig
from savgol_tpu_torch.ops.apply2d import _prime_factors, savgol2d_apply
from savgol_tpu_torch.ops.weights import savgol2d_weights_np

__all__ = ["Savgol2D"]


class Savgol2D(nn.Module):
    """True-2D polynomial least-squares filter.

    The counterpart of the reference's ``Savgol2DFilter``: the (H, W)
    stencil is one row of pinv(design matrix), precomputed in f64 on the
    host. The stencil and ``scale`` = 1 / (delta_x**dx * delta_y**dy) are
    buffers, so ``.to()`` and ``state_dict()`` carry them. Rectangular
    windows are supported.

    Build with :meth:`create` or :meth:`from_jax` (the leaves of a
    ``savgol_tpu.Savgol2D``). :meth:`apply` shadows ``nn.Module.apply(fn)``,
    as in :class:`savgol_tpu_torch.Savgol1D`.
    """

    def __init__(self, config: Savgol2DConfig, weights: torch.Tensor,
                 scale: torch.Tensor):
        super().__init__()
        self.config = config
        self.register_buffer("weights", weights)
        self.register_buffer("scale", scale)

    @classmethod
    def create(cls, config: Savgol2DConfig, dtype=torch.float32, *,
               device) -> "Savgol2D":
        """Host f64 stencil, cast and placed on ``device`` (reference
        ``savgol2d_create``, src/savgol2d.c:304-342), its separable factors
        cached from the host values (``_prime_factors``)."""
        w = torch.as_tensor(savgol2d_weights_np(config, dtype=np.float64),
                            dtype=dtype)
        return cls._placed(config, w, torch.as_tensor(config.scale,
                                                      dtype=dtype), device)

    @classmethod
    def from_jax(cls, config: Savgol2DConfig, arrays: Sequence[np.ndarray],
                 *, device) -> "Savgol2D":
        """The port's module from a JAX ``Savgol2D``'s leaves, given as
        numpy arrays in pytree order: ``(weights, scale)``
        (``jax.tree_util.tree_leaves``). Dtypes are kept."""
        # np.array copies: arrays handed over from JAX are read-only
        weights, scale = (torch.as_tensor(np.array(a)) for a in arrays)
        return cls._placed(config, weights, scale, device)

    @classmethod
    def _placed(cls, config: Savgol2DConfig, weights: torch.Tensor,
                scale: torch.Tensor, device) -> "Savgol2D":
        """The module with host ``weights`` and ``scale`` placed on
        ``device``, the stencil's factors cached from its host values, so
        that the route reads its rank with no copy from the card."""
        placed = weights.to(device)
        _prime_factors(placed, weights.double().numpy())
        return cls(config, placed, scale.to(device))

    def valid_size(self, rows: int, cols: int):
        """Output dims for VALID mode (savgol2d.h:250-256)."""
        return (rows - 2 * self.config.half_window_y,
                cols - 2 * self.config.half_window_x)

    def extra_repr(self) -> str:
        return repr(self.config)

    def apply(self, x: torch.Tensor, *,
              boundary: Boundary2D = Boundary2D.CONSTANT,
              method: str = "auto") -> torch.Tensor:
        """Filter the last two axes of ``x`` (ref: savgol2d_apply,
        src/savgol2d.c:398-456)."""
        return savgol2d_apply(x, self.weights, boundary=boundary,
                              scale=self.scale, method=method)

    def apply_valid(self, x: torch.Tensor, *,
                    method: str = "auto") -> torch.Tensor:
        """VALID-mode 2D filter (ref: savgol2d_apply_valid,
        src/savgol2d.c:356-396)."""
        return savgol2d_apply(x, self.weights, boundary=Boundary2D.VALID,
                              scale=self.scale, method=method)

    def forward(self, x: torch.Tensor, **kw) -> torch.Tensor:
        return self.apply(x, **kw)
