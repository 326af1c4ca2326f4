"""Filter banks: several Savitzky-Golay filters over one window, one pass
(counterpart of ``savgol_tpu.models.bank``).

The reference computes each derivative with a separate create/apply cycle.
A bank stacks the stencils of all requested filters (same half_window and
boundary) and evaluates them over one read of the input: smooth + velocity
+ acceleration cost one data pass instead of three (kernel K4,
``csrc/corr1d_bank.cu``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

from savgol_tpu_torch.config import PAD_MODE, BoundaryMode, SavgolConfig
from savgol_tpu_torch.ops.apply import (_check_device, _compute_dtype,
                                        _move_axis_last, correlate_bank,
                                        savgol_apply_core)
from savgol_tpu_torch.ops.cuda_conv import scale_of
from savgol_tpu_torch.ops.sweep import edge_blocks, fit_edges
from savgol_tpu_torch.ops.weights import savgol_weights_np

__all__ = ["SavgolBank"]

_METHODS = ("auto", "xla", "pallas")


class SavgolBank(nn.Module):
    """K filters sharing a window, applied in one pass.

    All configs must share ``half_window`` and ``boundary``; ``poly_order``,
    ``derivative`` and ``time_step`` may differ per filter. The stencils
    ``center_weights`` (K, 2n+1), the edge rows ``edge_weights`` (K, n,
    2n+1), ``dt_inv`` (K,) and the odd-derivative leading-edge signs
    ``lead_signs`` (K,) are buffers, in the JAX bank's pytree order.

    :meth:`apply` filters data, as in ``savgol_tpu``; it shadows
    ``nn.Module.apply(fn)``, which this module, having no submodules, does
    not need.
    """

    def __init__(self, configs: Tuple[SavgolConfig, ...],
                 center_weights: torch.Tensor, edge_weights: torch.Tensor,
                 dt_inv: torch.Tensor, lead_signs: torch.Tensor):
        super().__init__()
        self.configs = tuple(configs)
        self.register_buffer("center_weights", center_weights)
        self.register_buffer("edge_weights", edge_weights)
        self.register_buffer("dt_inv", dt_inv)
        self.register_buffer("lead_signs", lead_signs)

    # -- lifecycle ----------------------------------------------------------

    @classmethod
    def create(cls, configs: Sequence[SavgolConfig], dtype=torch.float32, *,
               device) -> "SavgolBank":
        """Host f64 weights of every config, stacked, cast and placed on
        ``device``."""
        configs = tuple(configs)
        if not configs:
            raise ValueError("bank needs at least one config")
        n = configs[0].half_window
        b = configs[0].boundary
        for c in configs[1:]:
            if c.half_window != n or c.boundary != b:
                raise ValueError(
                    "all bank configs must share half_window and boundary")
        cws, ews, dts, signs = [], [], [], []
        for c in configs:
            cw, ew = savgol_weights_np(c, dtype=np.float64)
            cws.append(cw)
            ews.append(ew)
            dt = c.dt_scale
            dts.append(1.0 / dt if dt != 0.0 else 1.0)
            signs.append(-1.0 if c.derivative % 2 else 1.0)

        def put(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
        return cls(configs, put(np.stack(cws)), put(np.stack(ews)), put(dts),
                   put(signs))

    @classmethod
    def smooth_and_derivatives(cls, half_window: int, poly_order: int,
                               max_derivative: int = 2,
                               time_step: float = 1.0, dtype=torch.float32,
                               *, device) -> "SavgolBank":
        """Convenience: [smooth, d1, ..., d_max] over one window."""
        cfgs = [SavgolConfig(half_window, poly_order, d, time_step)
                for d in range(max_derivative + 1)]
        return cls.create(cfgs, dtype=dtype, device=device)

    @classmethod
    def from_jax(cls, configs: Sequence[SavgolConfig],
                 arrays: Sequence[np.ndarray], *, device) -> "SavgolBank":
        """The port's bank from a JAX ``SavgolBank``'s leaves, given as numpy
        arrays in pytree order: ``(center_weights, edge_weights, dt_inv,
        lead_signs)`` (``jax.tree_util.tree_leaves``). Dtypes are kept."""
        # np.array copies: arrays handed over from JAX are read-only
        cw, ew, dt, signs = (torch.as_tensor(np.array(a), device=device)
                             for a in arrays)
        return cls(tuple(configs), cw, ew, dt, signs)

    # -- properties ---------------------------------------------------------

    @property
    def half_window(self) -> int:
        return self.configs[0].half_window

    def extra_repr(self) -> str:
        return repr(self.configs)

    # -- application --------------------------------------------------------

    def apply(self, x: torch.Tensor, *, axis: int = -1,
              reference_edge_sign: bool = False,
              method: str = "auto") -> torch.Tensor:
        """Apply all K filters; output shape (K,) + x.shape.

        ``method="auto"`` runs the shared center pass as one K-stencil bank
        (kernel K4 on a CUDA tensor, its plain version on the CPU), one
        input read for all K filters; ``"pallas"`` asks for K4 and needs a
        CUDA tensor; ``"xla"`` applies each filter on its own, in plain
        PyTorch."""
        if method not in _METHODS:
            raise ValueError(
                f"method must be 'auto', 'xla' or 'pallas', got {method!r}")
        if method == "pallas" and x.device.type != "cuda":
            raise ValueError(
                f"method='pallas' runs the CUDA kernel and needs a CUDA "
                f"tensor, got one on {x.device}")
        xl, moved = _move_axis_last(x, axis)
        if method == "xla":
            out = self._apply_each(xl, reference_edge_sign)
        elif xl.is_complex():
            # real-linear: real and imaginary parts as one extra batch pair
            y = self._apply_bank(torch.stack([xl.real, xl.imag]),
                                 reference_edge_sign)
            out = torch.complex(y[:, 0], y[:, 1])
        else:
            out = self._apply_bank(xl, reference_edge_sign)
        if moved is not None:
            # out has a leading K axis, so positive source positions shift
            # by one; negative positions still index from the end.
            out = out.movedim(-1, axis + 1 if axis >= 0 else axis)
        return out

    def _apply_each(self, x: torch.Tensor,
                    reference_edge_sign: bool) -> torch.Tensor:
        """Each filter through the plain apply (the JAX bank's vmapped
        ``"xla"`` route), its leading edge signed per filter."""
        n = self.half_window
        boundary = self.configs[0].boundary
        outs = []
        for k in range(len(self.configs)):
            y = savgol_apply_core(
                x, self.center_weights[k], self.edge_weights[k], n, boundary,
                self.dt_inv[k], derivative=0, reference_edge_sign=True,
                method="xla")
            if boundary is BoundaryMode.POLYNOMIAL and not reference_edge_sign:
                s = self.lead_signs[k].to(y.dtype)
                y = torch.cat([y[..., :n] * s, y[..., n:]], dim=-1)
            outs.append(y)
        return torch.stack(outs)

    def _apply_bank(self, x: torch.Tensor,
                    reference_edge_sign: bool) -> torch.Tensor:
        """One bank correlation of every stencil, ``dt_inv`` folded in, over
        the row padded by n in the boundary's mode (zeros for POLYNOMIAL,
        whose 2n edge outputs a row are then fitted by small plain ops on
        their slices); kernel K4 through ``correlate_bank``."""
        n = self.half_window
        ws = 2 * n + 1
        N = x.shape[-1]
        if N < ws:
            raise ValueError(
                f"data length ({N}) must be >= window size ({ws})")
        _check_device(x, self.center_weights, self.edge_weights)
        if not x.is_floating_point():
            x = x.to(self.center_weights.dtype)
        # half inputs compute in f32; restored on output below
        x, restore = _compute_dtype(x)
        dt = scale_of(self.dt_inv, x)
        wdt = self.center_weights.to(x.dtype)
        if dt is not None:
            wdt = wdt * dt[:, None]
        boundary = self.configs[0].boundary
        if boundary is not BoundaryMode.POLYNOMIAL:
            y = correlate_bank(x, wdt, n, PAD_MODE[boundary], kernel=True)
            return y.to(restore) if restore is not None else y

        y = correlate_bank(x, wdt, n, kernel=True)        # (K, ..., N)
        # the sweep's edge fit with one n: edge row e weights x[..., ws-1-t]
        # by ew[e, t] at the lead and x[..., N-ws+t] at the trail
        ew = self.edge_weights.to(x.dtype)
        head, tail, reach = edge_blocks(
            self.center_weights.to(x.dtype), ew.flip(-1), ew,
            (n,) * wdt.shape[0], N, dt,
            None if reference_edge_sign else self.lead_signs.to(x.dtype))
        y = fit_edges(y, x, head, tail, reach)
        return y.to(restore) if restore is not None else y

    def forward(self, x: torch.Tensor, **kw) -> torch.Tensor:
        return self.apply(x, **kw)
