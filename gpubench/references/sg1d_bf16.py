"""Plain reference of ``method="bf16"`` on bf16 storage: the same-length 1D
Savitzky-Golay filter with the POLYNOMIAL boundary (``references/sg1d.py``)
of a recording held in bfloat16, and its inputs.

The filter is ``sg1d``'s f64 least-squares projection (``sg1d.py``'s
``projection``, a ``numpy.linalg.lstsq`` fit worked out again from the
configuration) applied in float64 to the bf16 samples, each upcast exactly,
a block of rows at a time on the outputs' device. The inputs are ``sg1d``'s
noisy sine, made a block of rows at a time straight into a bf16 tensor, so
that no float32 copy of the recording is ever whole. Plain numpy and
PyTorch; nothing of the program.
"""

from __future__ import annotations

import math

import torch

from gpubench import layout, numerics, roofline

BLOCK_ROWS = 16

_SG1D = layout.reference("sg1d")
projection = _SG1D.projection


def _rows(t: torch.Tensor, omega: torch.Tensor, phase: torch.Tensor,
          noise_std: float, g: torch.Generator) -> torch.Tensor:
    """float32 rows of the noisy sine: ``sin(t omega + phase)`` plus
    Gaussian noise of ``noise_std``, one row a frequency."""
    x = torch.empty(omega.shape[0], t.shape[0], dtype=torch.float32,
                    device=t.device)
    x.normal_(0.0, noise_std, generator=g)
    return x.add_(torch.sin(t * omega + phase))


def make_data(shape, cfg: dict, seed: int, device) -> torch.Tensor:
    """The recording in bfloat16, made on ``device`` from ``seed``: each
    channel a sine of amplitude 1, a log-uniform period in ``[period_min,
    period_max]`` samples and a uniform phase, plus Gaussian noise of
    ``noise_std`` (``sg1d``'s noisy sine; sizes in the configuration's
    ``data``), each block of ``BLOCK_ROWS`` rows made in float32 and
    rounded to bf16 into its place."""
    data = cfg["data"]
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    rows, n = shape
    lo, hi = math.log(data["period_min"]), math.log(data["period_max"])
    omega = (torch.empty(rows, 1, device=device).uniform_(lo, hi, generator=g)
             .exp_().reciprocal_().mul_(2 * math.pi))
    phase = torch.empty(rows, 1, device=device).uniform_(
        0.0, 2 * math.pi, generator=g)
    t = torch.arange(n, dtype=torch.float32, device=device)
    x = torch.empty(shape, dtype=torch.bfloat16, device=device)
    for r in range(0, rows, BLOCK_ROWS):
        s = slice(r, r + BLOCK_ROWS)
        x[s] = _rows(t, omega[s], phase[s], data["noise_std"], g)
    return x


def bound(cfg: dict, call_shape) -> tuple[float, float]:
    """The call's function bound: ``(bytes, operations)``, a bf16 sample
    read and a bf16 output written (2 B each), an FMA a tap a sample at
    the f32 rate, whatever computes it."""
    *lead, n = call_shape
    return roofline.sg1d(math.prod(lead), n, 2 * cfg["half_window"] + 1,
                         item_bytes=2)


def compare(pairs, cfg: dict) -> dict:
    """The numbers compared over ``pairs`` of (input, output) of calls:
    the largest error against the f64 reference over the edge outputs
    (``half_window`` at each end of a row) and over the interior, each
    over max(1, max |reference|) of its call, and the count of outputs
    compared. An output of another shape or dtype than its input reads
    +inf."""
    n = cfg["half_window"]
    edge = interior = 0.0
    count = 0
    P = None
    for x, y in pairs:
        if P is None:
            P = torch.as_tensor(projection(cfg), device=x.device)
        xr, yr = x.reshape(-1, x.shape[-1]), y.reshape(-1, y.shape[-1])
        if yr.shape != xr.shape or y.dtype != x.dtype:
            return {"edge_scaled_err": math.inf,
                    "interior_scaled_err": math.inf,
                    "outputs_compared": count}
        e_err = i_err = scale = 0.0
        for r in range(0, xr.shape[0], BLOCK_ROWS):
            want = _SG1D._apply(xr[r:r + BLOCK_ROWS], P, n)
            got = yr[r:r + BLOCK_ROWS]
            scale = max(scale, float(want.abs().max()))
            e_err = max(e_err, numerics.max_abs(got[:, :n], want[:, :n]),
                        numerics.max_abs(got[:, -n:], want[:, -n:]))
            i_err = max(i_err, numerics.max_abs(got[:, n:-n],
                                                want[:, n:-n]))
            count += got.numel()
        edge = max(edge, e_err / max(1.0, scale))
        interior = max(interior, i_err / max(1.0, scale))
    return {"edge_scaled_err": edge, "interior_scaled_err": interior,
            "outputs_compared": count}


def control_state(cfg: dict, device) -> torch.Tensor:
    """The control's taps: ``P`` rounded to bf16, held in float32."""
    P = torch.as_tensor(projection(cfg), dtype=torch.float32, device=device)
    return P.to(torch.bfloat16).float()


def _rounded_sum(parts) -> torch.Tensor:
    """The sum of the float32 ``parts`` in order, each partial sum
    rounded to bf16."""
    acc = None
    for p in parts:
        acc = (p if acc is None else acc + p).to(torch.bfloat16).float()
    return acc


def _apply_bf16_sums(x: torch.Tensor, P: torch.Tensor, n: int
                     ) -> torch.Tensor:
    """The filter of bf16 samples ``x`` (rows, N) by the bf16 taps ``P``
    with exact products and every partial sum rounded to bf16, in
    bf16."""
    ws = 2 * n + 1
    N = x.shape[-1]
    x = x.to(torch.bfloat16).float()
    center = _rounded_sum(x[:, k:N - ws + 1 + k] * P[n, k]
                          for k in range(ws))
    lead = _rounded_sum(x[:, k, None] * P[:n, k] for k in range(ws))
    trail = _rounded_sum(x[:, N - ws + k, None] * P[n + 1:, k]
                         for k in range(ws))
    return torch.cat([lead, center, trail], dim=-1).to(torch.bfloat16)


def control(state: torch.Tensor, x: torch.Tensor, cfg: dict
            ) -> torch.Tensor:
    """The reference put in the program's place one precision down: the
    configuration states bf16 samples and taps with exact products summed
    in float32, so here every partial sum is rounded to bf16 as well, a
    block of rows at a time."""
    xr = x.reshape(-1, x.shape[-1])
    out = torch.cat([_apply_bf16_sums(xr[r:r + BLOCK_ROWS], state,
                                      cfg["half_window"])
                     for r in range(0, xr.shape[0], BLOCK_ROWS)])
    return out.reshape(x.shape)
