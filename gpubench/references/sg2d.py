"""Plain reference of the true-2D Savitzky-Golay filter (a least-squares
fit of a polynomial of total degree ``poly_order`` over the window) with
the CONSTANT boundary (out-of-range pixels take the nearest edge pixel),
and the benchmark's 2D inputs.

The stencil is worked out again from the configuration, not taken from the
program: the row of the f64 least-squares solution (``numpy.linalg.lstsq``)
that gives the coefficient of ``x^deriv_x y^deriv_y``, times ``deriv_x!
deriv_y!`` over ``delta_x^deriv_x delta_y^deriv_y``, on a window whose rows
are y and whose columns are x. An output pixel is the stencil's sum over
the frame padded by its edge pixels. Computed in float64 on the outputs'
device, a few frames at a time. Plain numpy and PyTorch; nothing of the
program.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from gpubench import numerics, roofline

BLOCK_FRAMES = 2


def stencil(cfg: dict) -> np.ndarray:
    """(2 half_window_y + 1, 2 half_window_x + 1) f64 stencil."""
    nx, ny, order = cfg["half_window_x"], cfg["half_window_y"], \
        cfg["poly_order"]
    dx, dy = cfg.get("deriv_x", 0), cfg.get("deriv_y", 0)
    X, Y = np.meshgrid(np.arange(-nx, nx + 1, dtype=np.float64),
                       np.arange(-ny, ny + 1, dtype=np.float64))
    terms = [(i, tot - i) for tot in range(order + 1)
             for i in range(tot, -1, -1)]
    A = np.stack([X.ravel() ** i * Y.ravel() ** j for i, j in terms], 1)
    coef = np.linalg.lstsq(A, np.eye(A.shape[0]), rcond=None)[0]
    scale = (math.factorial(dx) * math.factorial(dy)
             / (cfg.get("delta_x", 1.0) ** dx * cfg.get("delta_y", 1.0) ** dy))
    return coef[terms.index((dx, dy))].reshape(X.shape) * scale


def rank(w: np.ndarray) -> int:
    """The stencil's separable rank: its singular values above 1e-9 of
    the largest."""
    s = np.linalg.svd(w, compute_uv=False)
    return int((s > 1e-9 * s[0]).sum())


def make_data(shape, cfg: dict, seed: int, device) -> torch.Tensor:
    """The frames, standard normal, made on ``device`` from ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    x = torch.empty(shape, dtype=torch.float32, device=device)
    return x.normal_(0.0, 1.0, generator=g)


def bound(cfg: dict, call_shape) -> tuple[float, float]:
    """The call's function bound: ``(bytes, operations)``."""
    w = stencil(cfg)
    return roofline.sg2d(math.prod(call_shape), w.shape[0], w.shape[1],
                         rank(w))


def _apply(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The filter of frames ``x`` (F, R, C) in ``w``'s dtype."""
    H, W = w.shape
    R, C = x.shape[-2:]
    xp = F.pad(x.to(w.dtype)[None], (W // 2, W // 2, H // 2, H // 2),
               mode="replicate")[0]
    out = xp[:, 0:R, 0:C] * w[0, 0]
    for a in range(H):
        for b in range(W):
            if a or b:
                out = out + xp[:, a:a + R, b:b + C] * w[a, b]
    return out


def compare(pairs, cfg: dict) -> dict:
    """The numbers compared over ``pairs`` of (input, output) of calls:
    the largest error against the f64 reference over the border pixels
    (within a half window of a frame's edge, where the CONSTANT boundary
    acts) and over the interior, each over max(1, max |reference|) of its
    call, and the count of pixels compared."""
    nx, ny = cfg["half_window_x"], cfg["half_window_y"]
    border = interior = 0.0
    count = 0
    w = None
    for x, y in pairs:
        if w is None:
            w = torch.as_tensor(stencil(cfg), device=x.device)
        R, C = x.shape[-2:]
        xr, yr = x.reshape(-1, R, C), y.reshape(-1, *y.shape[-2:])
        if yr.shape != xr.shape:
            return {"border_scaled_err": math.inf,
                    "interior_scaled_err": math.inf, "pixels_compared": count}
        inner = torch.zeros(R, C, dtype=torch.bool, device=x.device)
        inner[ny:R - ny, nx:C - nx] = True
        b_err = i_err = scale = 0.0
        for f in range(0, xr.shape[0], BLOCK_FRAMES):
            want = _apply(xr[f:f + BLOCK_FRAMES], w)
            got = yr[f:f + BLOCK_FRAMES]
            scale = max(scale, float(want.abs().max()))
            b_err = max(b_err, numerics.max_abs(got[:, ~inner],
                                                want[:, ~inner]))
            i_err = max(i_err, numerics.max_abs(got[:, inner],
                                                want[:, inner]))
            count += got.numel()
        border = max(border, b_err / max(1.0, scale))
        interior = max(interior, i_err / max(1.0, scale))
    return {"border_scaled_err": border, "interior_scaled_err": interior,
            "pixels_compared": count}


def control_state(cfg: dict, device) -> torch.Tensor:
    """The control's stencil in TF32."""
    return numerics.tf32(torch.as_tensor(stencil(cfg), dtype=torch.float32,
                                         device=device))


def control(state: torch.Tensor, x: torch.Tensor, cfg: dict
            ) -> torch.Tensor:
    """The reference put in the program's place one precision down: the
    configuration states exact float32 with TF32 off, so pixels and
    stencil are rounded to TF32 and the sums kept in float32, a few frames
    at a time."""
    R, C = x.shape[-2:]
    xr = x.reshape(-1, R, C)
    out = torch.cat([_apply(numerics.tf32(xr[f:f + BLOCK_FRAMES]), state)
                     for f in range(0, xr.shape[0], BLOCK_FRAMES)])
    return out.reshape(x.shape)
