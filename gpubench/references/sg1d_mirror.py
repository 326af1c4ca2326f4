"""Plain reference of scipy's ``savgol_filter(x, window_length, polyorder,
deriv, delta, mode="mirror")`` along the last axis, and its inputs.

Each row is extended at both ends by ``half_window`` samples with numpy's
``"reflect"`` rule (scipy's ``mirror``: the edge sample is not repeated),
written here as folds of the index at the row's first and last sample, and
every output is the centre row of the f64 least-squares projection
(``references/sg1d.py``'s ``projection``, a ``numpy.linalg.lstsq`` fit of
degree ``polyorder`` over the window) over the window of the extended row
centred on it, over ``delta ** deriv``. Computed in float64 on the outputs'
device, a block of rows at a time. The inputs are ``sg1d``'s noisy sine.
Plain numpy and PyTorch; nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gpubench import layout, numerics, roofline

BLOCK_ROWS = 16

_SG1D = layout.reference("sg1d")
make_data = _SG1D.make_data


def projection(cfg: dict) -> np.ndarray:
    """(ws, ws) f64: row j gives the fit's value (``deriv``-th derivative
    over ``delta ** deriv``) at window point j from the window's
    samples."""
    return _SG1D.projection({"half_window": cfg["window_length"] // 2,
                             "poly_order": cfg["polyorder"],
                             "derivative": cfg["deriv"],
                             "time_step": cfg["delta"]})


def reflect_index(N: int, n: int) -> np.ndarray:
    """Source index of each sample of a row of ``N`` extended by ``n`` at
    each end by numpy's ``"reflect"`` rule, for any ``n``: an index is
    folded about 0 and about ``N - 1`` until it lies in the row."""
    i = np.arange(-n, N + n)
    if N == 1:
        return np.zeros_like(i)
    while True:
        i = np.abs(i)
        over = i > N - 1
        if not over.any():
            return i
        i = np.where(over, 2 * (N - 1) - i, i)


def _apply(x: torch.Tensor, c: torch.Tensor, n: int) -> torch.Tensor:
    """The filter of ``x`` (rows, N) by the centre row ``c``, in ``c``'s
    dtype."""
    N = x.shape[-1]
    idx = torch.as_tensor(reflect_index(N, n), device=x.device)
    xp = x.to(c.dtype)[:, idx]
    out = xp[:, 0:N] * c[0]
    for k in range(1, 2 * n + 1):
        out = out + xp[:, k:k + N] * c[k]
    return out


def bound(cfg: dict, call_shape) -> tuple[float, float]:
    """The call's function bound: ``(bytes, operations)``, each sample
    read and written once and an FMA a tap, whatever pads it."""
    *lead, N = call_shape
    return roofline.sg1d(math.prod(lead), N, cfg["window_length"])


def compare(pairs, cfg: dict) -> dict:
    """The numbers compared over ``pairs`` of (input, output) of calls:
    the largest absolute error against the f64 reference over the edge
    outputs (the ``half_window`` at each end of a row, whose windows reach
    into the reflection) and over the interior, and the count of outputs
    compared."""
    n = cfg["window_length"] // 2
    edge = interior = 0.0
    count = 0
    c = None
    for x, y in pairs:
        if c is None:
            c = torch.as_tensor(projection(cfg)[n], device=x.device)
        xr, yr = x.reshape(-1, x.shape[-1]), y.reshape(-1, y.shape[-1])
        if yr.shape != xr.shape:
            return {"edge_abs_err": math.inf, "interior_abs_err": math.inf,
                    "outputs_compared": count}
        for r in range(0, xr.shape[0], BLOCK_ROWS):
            want = _apply(xr[r:r + BLOCK_ROWS], c, n)
            got = yr[r:r + BLOCK_ROWS]
            edge = max(edge, numerics.max_abs(got[:, :n], want[:, :n]),
                       numerics.max_abs(got[:, -n:], want[:, -n:]))
            interior = max(interior, numerics.max_abs(got[:, n:-n],
                                                      want[:, n:-n]))
            count += got.numel()
    return {"edge_abs_err": edge, "interior_abs_err": interior,
            "outputs_compared": count}


def control_state(cfg: dict, device) -> torch.Tensor:
    """The control's taps: the centre row in TF32."""
    c = projection(cfg)[cfg["window_length"] // 2]
    return numerics.tf32(torch.as_tensor(c, dtype=torch.float32,
                                         device=device))


def control(state: torch.Tensor, x: torch.Tensor, cfg: dict
            ) -> torch.Tensor:
    """The reference put in the program's place one precision down: the
    configuration states exact float32 with TF32 off, so samples and taps
    are rounded to TF32 and the sums kept in float32, a block of rows at a
    time."""
    n = cfg["window_length"] // 2
    xr = x.reshape(-1, x.shape[-1])
    out = torch.cat([_apply(numerics.tf32(xr[r:r + BLOCK_ROWS]), state, n)
                     for r in range(0, xr.shape[0], BLOCK_ROWS)])
    return out.reshape(x.shape)
