"""Plain reference of the same-length 1D Savitzky-Golay filter with the
POLYNOMIAL boundary (MATLAB ``sgolayfilt``'s edges), and the benchmark's
1D inputs.

The weights are worked out again from the configuration, not taken from
the program: an f64 least-squares fit of degree ``poly_order`` over the
``2 half_window + 1`` points of a window (``numpy.linalg.lstsq``), whose
projection ``P`` maps the window's samples to the fit's values (or its
``derivative``-th derivative, over ``time_step``) at each point. An
interior output is row ``half_window`` of ``P`` over the window centred on
it; the ``half_window`` leading outputs are rows ``0 .. half_window - 1``
over the first window and the trailing ones rows ``half_window + 1 ..``
over the last. Computed in float64 on the outputs' device, a block of rows
at a time. Plain numpy and PyTorch; nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gpubench import numerics, roofline

BLOCK_ROWS = 16


def projection(cfg: dict) -> np.ndarray:
    """(ws, ws) f64: row j gives the fit's value (derivative) at window
    point j from the window's samples."""
    n, m = cfg["half_window"], cfg["poly_order"]
    d = cfg.get("derivative", 0)
    t = np.arange(-n, n + 1, dtype=np.float64)
    A = np.vander(t, m + 1, increasing=True)
    coef = np.linalg.lstsq(A, np.eye(2 * n + 1), rcond=None)[0]
    D = np.zeros_like(A)                 # d-th derivative of each monomial
    for i in range(d, m + 1):
        D[:, i] = math.factorial(i) / math.factorial(i - d) * t ** (i - d)
    return D @ coef / cfg.get("time_step", 1.0) ** d


def make_data(shape, cfg: dict, seed: int, device) -> torch.Tensor:
    """The recording, made on ``device`` from ``seed``: each channel a
    sine of amplitude 1, a log-uniform period in ``[period_min,
    period_max]`` samples and a uniform phase, plus Gaussian noise of
    ``noise_std`` (the source's noisy sine; sizes in the configuration's
    ``data``)."""
    data = cfg["data"]
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    rows, n = shape
    x = torch.empty(shape, dtype=torch.float32, device=device)
    x.normal_(0.0, data["noise_std"], generator=g)
    lo, hi = math.log(data["period_min"]), math.log(data["period_max"])
    omega = (torch.empty(rows, 1, device=device).uniform_(lo, hi, generator=g)
             .exp_().reciprocal_().mul_(2 * math.pi))
    phase = torch.empty(rows, 1, device=device).uniform_(
        0.0, 2 * math.pi, generator=g)
    t = torch.arange(n, dtype=torch.float32, device=device)
    for r in range(0, rows, BLOCK_ROWS):
        s = slice(r, r + BLOCK_ROWS)
        x[s] += torch.sin(t * omega[s] + phase[s])
    return x


def bound(cfg: dict, call_shape) -> tuple[float, float]:
    """The call's function bound: ``(bytes, operations)``."""
    *lead, n = call_shape
    return roofline.sg1d(math.prod(lead), n, 2 * cfg["half_window"] + 1)


def _apply(x: torch.Tensor, P: torch.Tensor, n: int) -> torch.Tensor:
    """The filter of ``x`` (rows, N) in ``P``'s dtype."""
    ws = 2 * n + 1
    N = x.shape[-1]
    x = x.to(P.dtype)
    c = P[n]
    center = x[:, 0:N - ws + 1] * c[0]
    for k in range(1, ws):
        center = center + x[:, k:N - ws + 1 + k] * c[k]
    lead = (x[:, None, :ws] * P[:n]).sum(-1)
    trail = (x[:, None, N - ws:] * P[n + 1:]).sum(-1)
    return torch.cat([lead, center, trail], dim=-1)


def compare(pairs, cfg: dict) -> dict:
    """The numbers compared over ``pairs`` of (input, output) of calls:
    the largest absolute error against the f64 reference over the edge
    outputs (``half_window`` at each end of a row) and over the interior,
    and the count of outputs compared."""
    n = cfg["half_window"]
    edge = interior = 0.0
    count = 0
    P = None
    for x, y in pairs:
        if P is None:
            P = torch.as_tensor(projection(cfg), device=x.device)
        xr, yr = x.reshape(-1, x.shape[-1]), y.reshape(-1, y.shape[-1])
        if yr.shape != xr.shape:
            return {"edge_abs_err": math.inf, "interior_abs_err": math.inf,
                    "outputs_compared": count}
        for r in range(0, xr.shape[0], BLOCK_ROWS):
            want = _apply(xr[r:r + BLOCK_ROWS], P, n)
            got = yr[r:r + BLOCK_ROWS]
            edge = max(edge, numerics.max_abs(got[:, :n], want[:, :n]),
                       numerics.max_abs(got[:, -n:], want[:, -n:]))
            interior = max(interior, numerics.max_abs(got[:, n:-n],
                                                      want[:, n:-n]))
            count += got.numel()
    return {"edge_abs_err": edge, "interior_abs_err": interior,
            "outputs_compared": count}


def control_state(cfg: dict, device) -> torch.Tensor:
    """The control's taps: ``P`` in TF32."""
    return numerics.tf32(torch.as_tensor(projection(cfg),
                                         dtype=torch.float32, device=device))


def control(state: torch.Tensor, x: torch.Tensor, cfg: dict
            ) -> torch.Tensor:
    """The reference put in the program's place one precision down: the
    configuration states exact float32 with TF32 off, so samples and taps
    are rounded to TF32 and the sums kept in float32, a block of rows at a
    time."""
    xr = x.reshape(-1, x.shape[-1])
    out = torch.cat([_apply(numerics.tf32(xr[r:r + BLOCK_ROWS]), state,
                            cfg["half_window"])
                     for r in range(0, xr.shape[0], BLOCK_ROWS)])
    return out.reshape(x.shape)
