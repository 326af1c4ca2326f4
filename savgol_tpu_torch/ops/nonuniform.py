"""Savitzky-Golay filtering of NON-UNIFORMLY sampled signals on tensors
(counterpart of ``savgol_tpu.ops.nonuniform``).

The order-m polynomial is fitted per output position in the samples' own
coordinates ``t`` (event data, gappy telemetry, variable-rate sensors) and
its derivative evaluated there: :func:`savgol_apply_nonuniform` at every
sample, :func:`savgol_resample` at arbitrary query positions. The window of
position p is its ``2n+1`` index-neighbours (edges truncate); offsets are
normalized per window by ``s = max|u|``, and the weighted normal equations,
a Hankel of ``2m+1`` moments, are formed and solved in double-word
arithmetic (``ops/cuda_nonuniform.py``). Positions whose window holds fewer
than ``min_points`` valid samples, or whose abscissae do not identify the
fit (the ``rcond`` rule), yield ``fill``.

Routing, decided from the device and the configuration:

  * ``savgol_apply_nonuniform``, ``method="auto"`` or ``"fused"``: kernel
    K11 on a CUDA tensor;
  * ``savgol_resample``, ``method="auto"``: K11 in its planes mode (K11p),
    then the gather-evaluate kernel K12 (``ops/cuda_resample.py``);
    ``torch.searchsorted`` finds the windows;
  * ``savgol_resample``, ``method="direct"``: the per-query moments in
    plain PyTorch, then the double-word plane solve K8b
    (``ops/cuda_solve.py``), as the JAX package's direct route takes its
    fused plane solve;
  * ``method="xla"`` (nonuniform): the plain staged version on any device.

On a CPU tensor every kernel wrapper takes its plain version. Unlike the
JAX package's ``"fused"``, the port's kernel takes ``t`` in its own dtype
(float32 or float64) and never downcasts it, so every route has the staged
semantics. Gradients: the kernels run inside ``torch.autograd.Function``s
whose backward is autograd through the plain version, as the JAX package's
custom VJPs take the VJP of their jnp twins; differentiable in ``x``, ``t``,
``t_query`` and a float ``mask``. These functions hold no parameters: they
are functions of the data alone.
"""

from __future__ import annotations

from typing import Optional

import torch

from savgol_tpu_torch.ops.apply import (_compute_dtype, _grads_through,
                                        _move_axis_last, _restore_axis)
from savgol_tpu_torch.ops.cuda_nonuniform import (
    _fit_taps, nonuniform_plain, nonuniform_planes_plain,
    savgol_nonuniform_fused_cuda, savgol_nonuniform_planes_cuda)
from savgol_tpu_torch.ops.cuda_resample import (resample_eval_cuda,
                                                resample_eval_plain)
from savgol_tpu_torch.ops.cuda_solve import plane_cholesky_solve_dd
from savgol_tpu_torch.ops.masked import _weights

__all__ = ["savgol_apply_nonuniform", "savgol_resample"]


def _validate(half_window, poly_order, derivative, min_points):
    """(n, m, d, kmin) after the checks both entry points share."""
    n, m, d = int(half_window), int(poly_order), int(derivative)
    if n < 1:
        raise ValueError(f"half_window must be >= 1, got {n}")
    if not 0 <= m <= 2 * n:
        raise ValueError(
            f"poly_order must be in [0, 2*half_window], got {m}")
    if not 0 <= d <= m:
        raise ValueError(
            f"derivative must be in [0, poly_order], got {d}")
    kmin = m + 1 if min_points is None else int(min_points)
    if kmin < m + 1:
        raise ValueError(
            f"min_points must be >= poly_order + 1, got {kmin}")
    return n, m, d, kmin


def _working(x: torch.Tensor, what: str):
    """Float promotion, the complex refusal and half precision computed in
    f32; returns (x, restore dtype)."""
    if not (x.is_floating_point() or x.is_complex()):
        x = x.to(torch.float32)
    if x.is_complex():
        raise NotImplementedError(
            f"{what} of complex input: filter real/imag parts with an "
            "explicit shared mask")
    return _compute_dtype(x)


def _default_rcond(dtype) -> float:
    return 1e-6 if dtype == torch.float32 else 1e-12


class _NonuniformFn(torch.autograd.Function):
    """Fused nonuniform fit (kernel K11 on CUDA) whose backward is autograd
    through ``nonuniform_plain`` — the counterpart of
    ``savgol_tpu.ops.nonuniform._nonuni_fused_diff``."""

    @staticmethod
    def forward(ctx, xz, wts, tl, args):
        ctx.save_for_backward(xz, wts, tl)
        ctx.args = args
        return savgol_nonuniform_fused_cuda(xz, wts, tl, **args)

    @staticmethod
    def backward(ctx, g):
        def plain(xv, wv, tv):
            return nonuniform_plain(xv, wv, tv, **ctx.args)
        grads = _grads_through(plain, ctx.saved_tensors,
                               ctx.needs_input_grad[:3], g)
        return (*grads, None)


class _PlanesFn(torch.autograd.Function):
    """The plane-stack fit (K11p on CUDA) whose backward is autograd
    through ``nonuniform_planes_plain`` — the counterpart of
    ``savgol_tpu.ops.nonuniform._nonuni_planes_diff``."""

    @staticmethod
    def forward(ctx, xz, wts, tl, args):
        ctx.save_for_backward(xz, wts, tl)
        ctx.args = args
        return savgol_nonuniform_planes_cuda(xz, wts, tl, **args)

    @staticmethod
    def backward(ctx, g):
        def plain(xv, wv, tv):
            return nonuniform_planes_plain(xv, wv, tv, **ctx.args)
        grads = _grads_through(plain, ctx.saved_tensors,
                               ctx.needs_input_grad[:3], g)
        return (*grads, None)


class _ResampleFn(torch.autograd.Function):
    """The gather-evaluate step (K12 on CUDA) whose backward is autograd
    through ``resample_eval_plain`` — the counterpart of
    ``savgol_tpu.ops.nonuniform._resample_eval_diff``."""

    @staticmethod
    def forward(ctx, planes, t, ctr, tq, args):
        ctx.save_for_backward(planes, t, ctr, tq)
        ctx.args = args
        return resample_eval_cuda(planes, t, ctr, tq, **args)

    @staticmethod
    def backward(ctx, g):
        def plain(pl, tv, cv, qv):
            return resample_eval_plain(pl, tv, cv, qv, **ctx.args)
        needs = (*ctx.needs_input_grad[:2], False, ctx.needs_input_grad[3])
        grads = _grads_through(plain, ctx.saved_tensors, needs, g)
        return (*grads, None)


def savgol_apply_nonuniform(
    x: torch.Tensor,
    t: torch.Tensor,
    *,
    half_window: int,
    poly_order: int,
    derivative: int = 0,
    mask: Optional[torch.Tensor] = None,
    axis: int = -1,
    min_points: Optional[int] = None,
    fill: float = float("nan"),
    rcond: Optional[float] = None,
    method: str = "auto",
) -> torch.Tensor:
    """Savitzky-Golay filtering at arbitrary sample positions ``t``.

    ``t`` holds each sample's abscissa, shaped like ``x`` or 1D of length
    ``x.shape[axis]`` (shared across the batch). The order-``poly_order``
    polynomial is fitted over each sample's ``2*half_window+1``
    index-neighbours in the sample's own coordinates, and its
    ``derivative``-th derivative returned at the sample, in the units of
    ``t``. Edges truncate; a bool ``mask`` marks valid samples (default
    ``isfinite(x) & isfinite(t)``), a float ``mask`` gives nonnegative
    per-sample weights (0 = missing). Positions with fewer than
    ``min_points`` (default ``poly_order + 1``) valid samples, or whose
    abscissae cannot identify the polynomial (the Cholesky diagonal against
    ``rcond``, default 1e-6 in f32 and 1e-12 in f64), yield ``fill``. ``t``
    need not be sorted. ``method``: "auto" and "fused" run kernel K11 on a
    CUDA tensor (any half window shared memory holds), "xla" the plain
    staged version. Differentiable in ``x``, ``t`` and a float ``mask``.
    """
    if method not in ("auto", "xla", "fused"):
        raise ValueError(
            f"method must be 'auto', 'xla' or 'fused', got {method!r}")
    n, m, d, kmin = _validate(half_window, poly_order, derivative,
                              min_points)
    x, restore = _working(x, "non-uniform filtering")
    t = torch.as_tensor(t, device=x.device)
    if not t.is_floating_point():
        t = t.to(x.dtype)
    tb = t
    if t.dim() == 1 and x.dim() > 1 and t.shape[0] == x.shape[axis]:
        shape = [1] * x.dim()
        shape[axis] = -1
        tb = t.reshape(shape).expand(x.shape)
    shared = tb is not t
    if tb.shape != x.shape:
        raise ValueError(
            f"t shape {tuple(t.shape)} is neither x's shape {tuple(x.shape)}"
            f" nor (x.shape[axis],)")
    if mask is None:
        mask = torch.isfinite(x) & torch.isfinite(tb)
    mask = torch.as_tensor(mask, device=x.device)
    if mask.shape != x.shape:
        raise ValueError(
            f"mask shape {tuple(mask.shape)} != data shape {tuple(x.shape)}")

    xl, moved = _move_axis_last(x, axis)
    ml, _ = _move_axis_last(mask, axis)
    # a shared row stays one row for the kernel; the plain version expands
    tl = t if shared else _move_axis_last(tb, axis)[0]
    if xl.shape[-1] < 1:
        raise ValueError("data length must be >= 1")
    if rcond is None:
        rcond = _default_rcond(xl.dtype)
    _, xz, wts = _weights(xl, ml)
    args = dict(half_window=n, poly_order=m, derivative=d, kmin=kmin,
                fill=float(fill), rcond=float(rcond))
    if method == "xla":
        y = nonuniform_plain(xz, wts, tl, **args)
    else:
        y = _NonuniformFn.apply(xz.contiguous(), wts.contiguous(),
                                tl.contiguous(), args)
    y = _restore_axis(y, moved)
    return y.to(restore) if restore is not None else y


def savgol_resample(
    x: torch.Tensor,
    t: torch.Tensor,
    t_query: torch.Tensor,
    *,
    half_window: int,
    poly_order: int,
    derivative: int = 0,
    mask: Optional[torch.Tensor] = None,
    min_points: Optional[int] = None,
    fill: float = float("nan"),
    rcond: Optional[float] = None,
    method: str = "auto",
) -> torch.Tensor:
    """Savitzky-Golay smoothing evaluated at arbitrary query positions.

    For each query q in ``t_query`` the order-``poly_order`` polynomial is
    fitted to the ``2*half_window+1`` samples around ``searchsorted(t, q)``
    (clipped inside the data) and its ``derivative``-th derivative returned
    at q; queries outside ``[t[0], t[-1]]`` extrapolate the nearest window's
    fit. ``t`` is 1D of length ``x.shape[-1]``, sorted ascending and finite;
    ``x`` may carry leading batch axes sharing it. ``mask`` (shaped like
    ``x`` or 1D of length N; default ``isfinite(x)``), ``min_points``,
    ``fill`` and ``rcond`` act as in :func:`savgol_apply_nonuniform`.

    ``method``: "auto" fits every data window once as coefficient planes
    (K11p on a CUDA tensor) and evaluates each query at its window's centre
    (K12): the same window and fit as "direct", expressed in the centre's
    normalized basis instead of the query's, so the two agree to the
    solver's rounding. "direct" fits one window per query: the moments in
    plain PyTorch, the solve on K8b on a CUDA tensor.
    Differentiable in ``x``, ``t``, ``t_query`` and a float ``mask``.
    """
    if method not in ("auto", "direct"):
        raise ValueError(
            f"method must be 'auto' or 'direct', got {method!r}")
    n, m, d, kmin = _validate(half_window, poly_order, derivative,
                              min_points)
    ws = 2 * n + 1
    x, restore = _working(x, "resampling")
    t = torch.as_tensor(t, device=x.device)
    tq = torch.as_tensor(t_query, device=x.device)
    if not t.is_floating_point():
        t = t.to(x.dtype)
    if not tq.is_floating_point():
        tq = tq.to(t.dtype)
    N = x.shape[-1]
    if t.dim() != 1 or t.shape[0] != N:
        raise ValueError(
            f"t must be 1D of length x.shape[-1]={N}, got {tuple(t.shape)}")
    if tq.dim() != 1:
        raise ValueError(
            f"t_query must be 1D, got shape {tuple(tq.shape)}")
    if N < ws:
        raise ValueError(
            f"data length {N} is shorter than the window {ws}")
    if mask is None:
        mask = torch.isfinite(x)
    mask = torch.as_tensor(mask, device=x.device)
    if mask.dim() == 1:
        if mask.shape[0] != N:
            raise ValueError(
                f"1D mask length {mask.shape[0]} != data length {N}")
        mask = mask.expand(x.shape)
    if mask.shape != x.shape:
        raise ValueError(
            f"mask shape {tuple(mask.shape)} != data shape {tuple(x.shape)}")
    if rcond is None:
        rcond = _default_rcond(x.dtype)
    _, xz, wts = _weights(x, mask)

    # the window of query q: the ws index-neighbours of its insertion point
    # (left side, as jnp.searchsorted), clipped inside the data
    common = torch.promote_types(t.dtype, tq.dtype)
    ins = torch.searchsorted(t.to(common).contiguous(),
                             tq.to(common).contiguous())
    start = torch.clamp(ins - n, 0, N - ws)

    if method == "auto":
        fit = dict(half_window=n, poly_order=m, kmin=kmin,
                   rcond=float(rcond))
        planes = _PlanesFn.apply(xz.contiguous(), wts.contiguous(),
                                 t.contiguous(), fit)
        # the query offset in the promoted dtype of t and t_query, as the
        # staged route subtracts them
        y = _ResampleFn.apply(planes, t.to(common).contiguous(), start + n,
                              tq.to(common).contiguous(),
                              dict(poly_order=m, derivative=d,
                                   fill=float(fill)))
        return y.to(restore) if restore is not None else y

    # method="direct": one window per query, its taps gathered as planes,
    # the per-query solve on K8b (as the JAX package's _fit_coeffs takes
    # its fused dd plane solve)
    def tap(j):
        idx = start + j
        x_j = xz.index_select(-1, idx)
        w_j = wts.index_select(-1, idx)
        # offsets in t's own dtype first (epoch-scale abscissae)
        return x_j, w_j, (t[idx] - tq).expand(x_j.shape)

    y = _fit_taps(tap, ws, m, d, kmin, rcond, fill, x.dtype,
                  solve=plane_cholesky_solve_dd)
    return y.to(restore) if restore is not None else y
