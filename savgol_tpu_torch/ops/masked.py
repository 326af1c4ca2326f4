"""Missing-data (masked / NaN-robust) Savitzky-Golay filtering on tensors
(counterpart of ``savgol_tpu.ops.masked``).

Per output position the order-m polynomial is fitted to the valid samples
of the window only (a bool mask; a float mask gives nonnegative per-sample
weights), in an orthonormal basis of the full window, from the masked
normal equations

    G[a, b] = sum_j w_j phi_a(t_j) phi_b(t_j),
    r[a] = sum_j w_j phi_a(t_j) x_j,

one small SPD solve per position on the Gram ENTRY PLANES, and the
derivative row at the window center; positions with fewer than
``min_points`` positive-weight samples yield ``fill``. The host tables are
the JAX package's, computed by the same f64 numpy code.

Routing, decided from the configuration alone:

  * 1D ``solver="normal"``, ``method="auto"``: the fused kernel K9
    (``ops/cuda_masked.py``) on a CUDA tensor;
  * 1D ``solver="qr"``, ``method="auto"``: the double-word Gram and rhs
    (:func:`ops.lsq.correlate_valid_dd`, plain PyTorch, as the JAX package
    leaves them to XLA), then the double-word solve K8b;
  * 2D ``method="auto"`` within ``fused2d_supported``: the fused
    tensor-moment kernel K10 (``ops/cuda_masked2d.py``); outside it the
    K2D-dense bank correlations, then the solve K8a;
  * ``method="xla"``: the plain staged version on any device.

On a CPU tensor every kernel wrapper takes its plain version. Gradients: the
fused kernels run inside ``torch.autograd.Function``s whose backward is
autograd through the staged plain version, as the JAX package's custom VJPs
take the VJP of their jnp twins.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from savgol_tpu_torch.config import (PAD_MODE, Boundary2D, BoundaryMode,
                                     Savgol2DConfig, num_terms_2d)
from savgol_tpu_torch.ops.apply import (_compute_dtype, _grads_through,
                                        _move_axis_last, _restore_axis)
from savgol_tpu_torch.ops.apply2d import _PAD_MODE_2D, _Corr2dFn
from savgol_tpu_torch.ops.cuda_bank import bank_correlate_plain
from savgol_tpu_torch.ops.cuda_conv import pad_last
from savgol_tpu_torch.ops.cuda_conv2d import (correlate2d_valid_plain,
                                              pad2d_plain)
from savgol_tpu_torch.ops.cuda_masked import (extract_fill, masked1d_plain,
                                              savgol_masked1d_fused_cuda)
from savgol_tpu_torch.ops.cuda_masked2d import (fused2d_supported,
                                                savgol_masked2d_fused_cuda)
from savgol_tpu_torch.ops.cuda_solve import (plane_cholesky_solve,
                                             plane_cholesky_solve_dd)
from savgol_tpu_torch.ops.lsq import (cholesky_solve_planes,
                                      cholesky_solve_planes_dd,
                                      correlate_valid_dd)

__all__ = ["savgol_apply_masked", "savgol2d_apply_masked"]

TRUNCATE = "truncate"


@functools.lru_cache(maxsize=None)
def _masked_tables(half_window: int, poly_order: int):
    """Host-precomputed f64 tables for the masked fit.

    Returns ``(Q, Rinv, pair_w, pair_index)``:
      Q          (ws, m+1)  orthonormal basis sampled on the window,
      Rinv       (m+1, m+1) monomial coefficients of each basis column,
      pair_w     (Kp, ws)   pair-product stencils phi_a*phi_b, a<=b,
      pair_index (m+1, m+1) symmetric gather map into the Kp axis.
    """
    n = int(half_window)
    m = int(poly_order)
    ws = 2 * n + 1
    t = (np.arange(ws, dtype=np.float64) - n) / max(n, 1)
    V = np.vander(t, m + 1, increasing=True)            # V[j, q] = t_j^q
    Q, R = np.linalg.qr(V)                              # Q: (ws, m+1)
    # deterministic sign: positive leading coefficient per column
    s = np.sign(np.diag(R)).copy()
    s[s == 0] = 1.0
    Q = Q * s
    R = R * s[:, None]
    Rinv = np.linalg.solve(R, np.eye(m + 1))            # phi_a = sum_q Rinv[q,a] t^q
    pairs = []
    pair_index = np.zeros((m + 1, m + 1), dtype=np.int32)
    for a in range(m + 1):
        for b in range(a, m + 1):
            pair_index[a, b] = pair_index[b, a] = len(pairs)
            pairs.append(Q[:, a] * Q[:, b])
    pair_w = np.stack(pairs)                            # (Kp, ws)
    return Q, Rinv, pair_w, pair_index


def _prepare(x: torch.Tensor, mask):
    """Common input handling of both entry points: float promotion, the
    complex refusal, half precision computed in f32, the default mask and
    its shape check. Returns (x, mask, restore dtype)."""
    if not (x.is_floating_point() or x.is_complex()):
        x = x.to(torch.float32)
    if x.is_complex():
        raise NotImplementedError(
            "masked filtering of complex input: filter real/imag parts "
            "with an explicit shared mask")
    x, restore = _compute_dtype(x)
    if mask is None:
        mask = torch.isfinite(x)
    mask = torch.as_tensor(mask, device=x.device)
    if mask.shape != x.shape:
        raise ValueError(
            f"mask shape {tuple(mask.shape)} != data shape {tuple(x.shape)}")
    return x, mask, restore


def _weights(x: torch.Tensor, mask: torch.Tensor):
    """(weighted, sanitized values, weights): a bool mask marks validity,
    any other dtype is nonnegative per-sample weights (0 = missing)."""
    weighted = mask.dtype != torch.bool
    valid = mask > 0 if weighted else mask
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    wts = torch.where(valid, mask.to(x.dtype), zero) if weighted \
        else valid.to(x.dtype)
    return weighted, torch.where(valid, x, zero), wts


class _Masked1dFn(torch.autograd.Function):
    """Fused masked 1D fit (kernel K9 on CUDA) whose backward is autograd
    through ``masked1d_plain`` — the counterpart of
    ``savgol_tpu.ops.masked._masked1d_fused_diff``."""

    @staticmethod
    def forward(ctx, xzp, wp, tables, n, kmin, fill):
        ctx.save_for_backward(xzp, wp)
        ctx.args = tables, n, kmin, fill
        return savgol_masked1d_fused_cuda(xzp, wp, *tables, half_window=n,
                                          kmin=kmin, fill=fill)

    @staticmethod
    def backward(ctx, g):
        tables, n, kmin, fill = ctx.args

        def plain(xv, wv):
            return masked1d_plain(xv, wv, *tables, half_window=n, kmin=kmin,
                                  fill=fill)
        grads = _grads_through(plain, ctx.saved_tensors,
                               ctx.needs_input_grad[:2], g)
        return (*grads, None, None, None, None)


def savgol_apply_masked(
    x: torch.Tensor,
    *,
    half_window: int,
    poly_order: int,
    derivative: int = 0,
    time_step: float = 1.0,
    mask: Optional[torch.Tensor] = None,
    boundary: Union[str, BoundaryMode] = TRUNCATE,
    axis: int = -1,
    min_points: Optional[int] = None,
    fill: float = float("nan"),
    solver: str = "normal",
    method: str = "auto",
) -> torch.Tensor:
    """Savitzky-Golay filtering with missing samples, along ``axis``.

    A bool ``mask`` marks VALID samples (default ``isfinite(x)``); a float
    ``mask`` is nonnegative per-sample weights for a weighted fit (0 =
    missing). Positions whose window holds fewer than ``min_points``
    (default ``poly_order + 1``) positive-weight samples yield ``fill``.
    ``boundary="truncate"`` (default) treats out-of-range samples as
    missing; REFLECT / PERIODIC / CONSTANT pad the values and the validity
    with the same mode. ``solver="qr"`` forms the Gram and rhs in
    double-word arithmetic and solves in the double-word plane Cholesky.
    Differentiable in ``x`` (and a float ``mask``).
    """
    n = int(half_window)
    m = int(poly_order)
    d = int(derivative)
    ws = 2 * n + 1
    if n < 1:
        raise ValueError(f"half_window must be >= 1, got {n}")
    if not 0 <= m <= 2 * n:
        raise ValueError(
            f"poly_order must be in [0, 2*half_window], got {m}")
    if not 0 <= d <= m:
        raise ValueError(
            f"derivative must be in [0, poly_order], got {d}")
    dt = float(time_step)
    if dt <= 0.0:
        raise ValueError(f"time_step must be positive, got {time_step}")
    if solver not in ("normal", "qr"):
        raise ValueError(f"solver must be 'normal' or 'qr', got {solver!r}")
    if method not in ("auto", "xla"):
        raise ValueError(f"method must be 'auto' or 'xla', got {method!r}")
    kmin = m + 1 if min_points is None else int(min_points)
    if kmin < m + 1:
        raise ValueError(
            f"min_points must be >= poly_order + 1, got {kmin}")
    truncate = isinstance(boundary, str) and boundary.lower() == TRUNCATE
    if not truncate:
        boundary = BoundaryMode(boundary)
        if boundary is BoundaryMode.POLYNOMIAL:
            raise ValueError(
                "boundary='truncate' is the masked-fit analog of the "
                "POLYNOMIAL edge rule; POLYNOMIAL itself is pad-free")

    x, mask, restore = _prepare(x, mask)
    xl, moved = _move_axis_last(x, axis)
    ml, _ = _move_axis_last(mask, axis)
    if xl.shape[-1] < 1:
        raise ValueError("data length must be >= 1")

    Q, Rinv, pair_w, pair_index = _masked_tables(n, m)
    extract = Rinv[d, :] * math.factorial(d) / float(n * dt) ** d
    _, xz, wts = _weights(xl, ml)
    mode = None if truncate else PAD_MODE[boundary]
    xzp, wp = pad_last(xz, n, mode), pad_last(wts, n, mode)

    if solver == "qr":
        # double-word Gram and rhs, double-word solve (ops/lsq.py)
        # (a bool mask is the weights 0 and 1: x * w is exact)
        gram_hi, gram_lo = correlate_valid_dd(wp, pair_w)
        rhs_hi, rhs_lo = correlate_valid_dd(xzp * wp, Q.T)
        count = bank_correlate_plain((wp > 0).to(xl.dtype),
                                     np.ones((1, ws)))[0]
        solve = (plane_cholesky_solve_dd if method == "auto"
                 else cholesky_solve_planes_dd)
        coef, ok = solve(gram_hi, gram_lo, pair_index, rhs_hi, rhs_lo,
                         count >= (kmin - 0.5))
        y = extract_fill(coef, extract, ok, fill)
    elif method == "auto":
        y = _Masked1dFn.apply(xzp.contiguous(), wp.contiguous(),
                              (pair_w, pair_index, Q.T, extract), n, kmin,
                              float(fill))
    else:
        y = masked1d_plain(xzp, wp, pair_w, pair_index, Q.T, extract,
                           half_window=n, kmin=kmin, fill=fill)
    y = _restore_axis(y, moved)
    return y.to(restore) if restore is not None else y


# ---------------------------------------------------------------------------
# 2D: masked bivariate fits
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _masked_tables_2d(half_window_x: int, half_window_y: int,
                      poly_order: int):
    """Host-precomputed f64 tables for the masked 2D fit.

    Basis: QR-orthonormalized bivariate monomials x^i y^j (i + j <= m) on
    the window grid t = offset/half_window. Returns
    ``(Q3, Rinv, pair_w, pair_index, mono_index)``:
      Q3         (P, wy, wx)   orthonormal basis stencils,
      Rinv       (P, P)        monomial coefficients of each basis fn,
      pair_w     (Kp, wy, wx)  pair products phi_a*phi_b, a<=b,
      pair_index (P, P)        symmetric gather map into the Kp axis,
      mono_index dict (i, j) -> monomial row in Rinv.
    """
    nx, ny, m = int(half_window_x), int(half_window_y), int(poly_order)
    wx, wy = 2 * nx + 1, 2 * ny + 1
    tx = (np.arange(wx, dtype=np.float64) - nx) / max(nx, 1)
    ty = (np.arange(wy, dtype=np.float64) - ny) / max(ny, 1)
    monos = [(i, t - i) for t in range(m + 1) for i in range(t + 1)]
    mono_index = {ij: p for p, ij in enumerate(monos)}
    P = len(monos)
    TY, TX = np.meshgrid(ty, tx, indexing="ij")
    V = np.stack([(TX ** i * TY ** j).reshape(-1) for i, j in monos],
                 axis=1)                                 # (wy*wx, P)
    Q, R = np.linalg.qr(V)
    s = np.sign(np.diag(R)).copy()
    s[s == 0] = 1.0
    Q = Q * s
    R = R * s[:, None]
    Rinv = np.linalg.solve(R, np.eye(P))
    pairs = []
    pair_index = np.zeros((P, P), dtype=np.int32)
    for a in range(P):
        for b in range(a, P):
            pair_index[a, b] = pair_index[b, a] = len(pairs)
            pairs.append(Q[:, a] * Q[:, b])
    pair_w = np.stack(pairs).reshape(-1, wy, wx)         # (Kp, wy, wx)
    Q3 = Q.T.reshape(P, wy, wx)
    return Q3, Rinv, pair_w, pair_index, mono_index


def _corr2d_bank(x: torch.Tensor, w_stack, kernels: bool) -> torch.Tensor:
    """(..., Rp, Cp) x (K, wh, ww) -> (K, ..., R, C) VALID correlation,
    planes first: K2D-dense, all K stencils in one launch (``kernels``, its
    wrapper takes the plain version on a CPU tensor), or the plain
    version."""
    w = torch.as_tensor(np.asarray(w_stack), dtype=x.dtype, device=x.device)
    if kernels:
        out = _Corr2dFn.apply(x.contiguous(), w, None)
    else:
        out = correlate2d_valid_plain(x, w)
    return out.movedim(-3, 0)


def _masked2d_staged(xv: torch.Tensor, wp: torch.Tensor, *, nx: int, ny: int,
                     m: int, dx: int, dy: int, delta_x: float,
                     delta_y: float, kmin: int, fill, rcond: float,
                     weighted: bool, kernels: bool) -> torch.Tensor:
    """The staged masked 2D fit over boundary-padded ``xv`` (mask-sanitized
    values, times the weights when ``weighted``) and weights ``wp``,
    (..., R + 2ny, C + 2nx) -> (..., R, C): bank correlations with the
    joint-basis pair and basis stencils, the quorum, the plane solve with
    the ``rcond`` rule, the extraction and the fill. ``kernels``: K2D-dense
    and K8a (their wrappers take the plain versions on a CPU tensor);
    otherwise plain PyTorch throughout."""
    wx, wy = 2 * nx + 1, 2 * ny + 1
    Q3, Rinv, pair_w, pair_index, mono_index = _masked_tables_2d(nx, ny, m)
    gramP = _corr2d_bank(wp, pair_w, kernels)            # (Kp, ..., R, C)
    rhsP = _corr2d_bank(xv, Q3, kernels)                 # (P, ..., R, C)
    if weighted:
        # positive-weight count needs its own box correlation (the Gram's
        # phi_0 row carries the weight SUM, not the count)
        count = _corr2d_bank((wp > 0).to(xv.dtype), np.ones((1, wy, wx)),
                             kernels)[0]
    else:
        # phi_0 is the constant 1/sqrt(wy*wx): G[0,0] == count/(wy*wx)
        count = gramP[int(pair_index[0, 0])] * (wy * wx)
    solve = plane_cholesky_solve if kernels else cholesky_solve_planes
    coef, ok = solve(gramP, pair_index, rhsP, count >= (kmin - 0.5),
                     rcond=rcond)
    scale = (math.factorial(dx) * math.factorial(dy)
             / float(nx * delta_x) ** dx / float(ny * delta_y) ** dy)
    return extract_fill(coef, Rinv[mono_index[(dx, dy)], :] * scale, ok,
                        fill)


class _Masked2dFn(torch.autograd.Function):
    """Fused masked 2D fit (kernel K10 on CUDA) whose backward is autograd
    through the plain staged version — the counterpart of
    ``savgol_tpu.ops.masked._masked2d_fused_diff``."""

    @staticmethod
    def forward(ctx, xv, wp, args):
        ctx.save_for_backward(xv, wp)
        ctx.args = args
        return savgol_masked2d_fused_cuda(xv, wp, **args)

    @staticmethod
    def backward(ctx, g):
        a = ctx.args

        def plain(xv, wv):
            return _masked2d_staged(
                xv, wv, nx=a["half_window_x"], ny=a["half_window_y"],
                m=a["poly_order"], dx=a["deriv_x"], dy=a["deriv_y"],
                delta_x=a["delta_x"], delta_y=a["delta_y"], kmin=a["kmin"],
                fill=a["fill"], rcond=a["rcond"], weighted=a["weighted"],
                kernels=False)
        grads = _grads_through(plain, ctx.saved_tensors,
                               ctx.needs_input_grad[:2], g)
        return (*grads, None)


def savgol2d_apply_masked(
    x: torch.Tensor,
    *,
    half_window_x: int,
    half_window_y: int,
    poly_order: int,
    deriv_x: int = 0,
    deriv_y: int = 0,
    delta_x: float = 1.0,
    delta_y: float = 1.0,
    mask: Optional[torch.Tensor] = None,
    boundary: Union[str, Boundary2D] = TRUNCATE,
    min_points: Optional[int] = None,
    fill: float = float("nan"),
    rcond: Optional[float] = None,
    method: str = "auto",
) -> torch.Tensor:
    """2D Savitzky-Golay filtering with missing pixels (last two axes).

    The bivariate order-``poly_order`` polynomial is fitted per pixel to the
    valid samples of its window (bool ``mask``, default ``isfinite(x)``; a
    float ``mask`` is nonnegative weights). A pixel needs ``min_points``
    (default: the number of terms) valid samples and a Cholesky diagonal
    that clears ``rcond`` (default 1e-6 in f32, 1e-12 in f64), else it gets
    ``fill``. ``boundary="truncate"`` (default) treats out-of-range pixels
    as missing; CONSTANT / REFLECT / PERIODIC pad value and validity alike.
    Differentiable in ``x`` (and a float ``mask``).
    """
    cfg = Savgol2DConfig(half_window_x, half_window_y, poly_order,
                         deriv_x=deriv_x, deriv_y=deriv_y,
                         delta_x=delta_x, delta_y=delta_y)
    nx, ny, m = cfg.half_window_x, cfg.half_window_y, cfg.poly_order
    nterms = num_terms_2d(m)
    kmin = nterms if min_points is None else int(min_points)
    if kmin < nterms:
        raise ValueError(
            f"min_points must be >= the number of polynomial terms "
            f"({nterms}), got {kmin}")
    truncate = isinstance(boundary, str) and boundary.lower() == TRUNCATE
    if not truncate:
        boundary = Boundary2D(boundary)
        if boundary is Boundary2D.VALID:
            raise ValueError(
                "boundary='valid' is not offered on the masked 2D path: "
                "'truncate' generalizes it (crop the output if needed)")
    if x.is_complex():
        raise NotImplementedError(
            "masked 2D filtering of complex input: filter real/imag "
            "parts with an explicit shared mask")
    if x.dim() < 2:
        raise ValueError("2D filtering needs at least a 2D array")
    x, mask, restore = _prepare(x, mask)
    if method not in ("auto", "xla"):
        raise ValueError(f"method must be 'auto' or 'xla', got {method!r}")
    if rcond is None:
        rcond = 1e-6 if x.dtype == torch.float32 else 1e-12

    weighted, xz, wts = _weights(x, mask)
    if truncate:
        xzp = F.pad(xz, (nx, nx, ny, ny))
        wp = F.pad(wts, (nx, nx, ny, ny))
    else:
        mode = _PAD_MODE_2D[boundary]
        xzp, wp = pad2d_plain(xz, ny, nx, mode), pad2d_plain(wts, ny, nx, mode)
    xv = xzp * wp if weighted else xzp
    args = dict(half_window_x=nx, half_window_y=ny, poly_order=m,
                deriv_x=int(deriv_x), deriv_y=int(deriv_y),
                delta_x=float(delta_x), delta_y=float(delta_y), kmin=kmin,
                fill=float(fill), rcond=float(rcond), weighted=weighted)
    if method == "auto" and fused2d_supported(nx, ny, m):
        y = _Masked2dFn.apply(xv.contiguous(), wp.contiguous(), args)
    else:
        y = _masked2d_staged(xv, wp, nx=nx, ny=ny, m=m, dx=int(deriv_x),
                             dy=int(deriv_y), delta_x=float(delta_x),
                             delta_y=float(delta_y), kmin=kmin, fill=fill,
                             rcond=float(rcond), weighted=weighted,
                             kernels=method == "auto")
    return y.to(restore) if restore is not None else y
