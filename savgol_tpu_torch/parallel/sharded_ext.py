"""Multi-rank masked / nonuniform Savitzky-Golay: overlap-save sharding
(counterpart of ``savgol_tpu.parallel.sharded_ext``).

:mod:`savgol_tpu_torch.parallel.sharded` shards the uniform stencil paths;
this module extends the same decomposition to the paths whose fit depends
on runtime data. The halo carries everything the local fit needs:

  * masked 1D / 2D: (values, weights), ``half_window`` samples (rows) of
    each over one exchange each; the rank then runs the single-device
    pipeline (kernels K9 / K10 for CUDA tensors) with
    ``boundary="truncate"`` on the halo-extended block and keeps the
    interior;
  * nonuniform: (values, weights, abscissae), the offsets formed locally
    from the raw ``t`` halo; the outer ranks' zeroed halo weights make the
    wrapped abscissae unreachable (K11 for CUDA tensors).

Global boundaries compose with the ring as in the uniform module:
``"truncate"`` (default) zeroes the outer halo weights; PERIODIC rides the
ring; CONSTANT / REFLECT (masked paths) synthesize the edge / symmetric pads
of the sanitized (values, weights) pair locally.

As in the JAX package these paths exchange by point-to-point sends only
(``_halo_exchange``), never kernel K13: they run wherever the group's
backend can send the tensors, ``gloo`` for CPU tensors and NCCL for a group
with one card a rank. All are differentiable through the exchange and equal
the single-device call on the gathered input.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from savgol_tpu_torch.config import Boundary2D, BoundaryMode
from savgol_tpu_torch.ops.apply2d import _PAD_MODE_2D
from savgol_tpu_torch.ops.cuda_conv import pad_last
from savgol_tpu_torch.ops.masked import (savgol2d_apply_masked,
                                         savgol_apply_masked)
from savgol_tpu_torch.ops.nonuniform import savgol_apply_nonuniform
from savgol_tpu_torch.parallel.sharded import _halo_exchange, mesh_axis
from savgol_tpu_torch.parallel.sharded2d import _halo_rows

__all__ = ["masked_apply_sharded", "masked2d_apply_sharded",
           "nonuniform_apply_sharded"]

TRUNCATE = "truncate"


def _norm_boundary(boundary, enum, path: str):
    """'truncate' stays a string token; everything else coerces to the
    enum (a string typo would otherwise silently mean CONSTANT)."""
    if isinstance(boundary, str) and boundary.lower() == TRUNCATE:
        return TRUNCATE
    b = enum(boundary)
    if b.name in ("POLYNOMIAL", "VALID"):
        raise ValueError(
            f"boundary={b.name.lower()!r} is not offered on the {path} "
            "path (same rule as the single-device API)")
    return b


def _sanitize(x, mask, extra_finite=None):
    """(xz, wts) in x's dtype: invalid samples -> value 0 / weight 0, as
    the single-device masked / nonuniform paths sanitize, so the local call
    (which receives ``wts`` as its float mask) fits the same weighted
    problem."""
    if mask is None:
        mask = torch.isfinite(x)
        if extra_finite is not None:
            mask = mask & torch.isfinite(extra_finite)
    if mask.shape != x.shape:
        raise ValueError(f"mask shape {tuple(mask.shape)} != data shape "
                         f"{tuple(x.shape)}")
    weighted = mask.dtype != torch.bool
    valid = (mask > 0) if weighted else mask
    wts = (torch.where(valid, mask.to(x.dtype), 0) if weighted
           else valid.to(x.dtype))
    xz = torch.where(valid, x, torch.zeros((), dtype=x.dtype,
                                           device=x.device))
    return xz, wts


def _edge_virtuals(z, n, boundary, dim=-1):
    """The outer ranks' halos, matching the pad the single-device masked
    path applies globally (CONSTANT -> 'edge', REFLECT -> 'symmetric');
    truncate -> zeros (weight 0 IS out-of-range)."""
    shape = list(z.shape)
    shape[dim] = n
    if boundary == TRUNCATE:
        zero = z.new_zeros(shape)
        return zero, zero
    L = z.shape[dim]
    if boundary in (BoundaryMode.REFLECT, Boundary2D.REFLECT):
        return z.narrow(dim, 0, n).flip(dim), z.narrow(dim, L - n, n).flip(dim)
    return (z.narrow(dim, 0, 1).expand(shape),
            z.narrow(dim, L - 1, 1).expand(shape))


def _extend(z, n, boundary, ring, dim=-1, periodic=False):
    """``z`` halo-extended by ``n`` on both sides of ``dim`` (-1 or -2) over
    the ring; the outer ranks substitute boundary virtuals unless
    periodic."""
    group, idx, size = ring
    if dim in (-1, z.dim() - 1):
        left, right = _halo_exchange(z, n, group)
    else:
        left, right = _halo_rows(z, n, group)
    if not periodic:
        vleft, vright = _edge_virtuals(z, n, boundary, dim)
        left = vleft if idx == 0 else left
        right = vright if idx == size - 1 else right
    return torch.cat([left, z, right], dim=dim)


def _check_local(nloc, n, what):
    if nloc < max(2 * n + 1, n):
        raise ValueError(
            f"local {what} length ({nloc}) must be >= the window size "
            f"({2 * n + 1}); use fewer shards or longer input")


def masked_apply_sharded(
    x: torch.Tensor,
    *,
    half_window: int,
    poly_order: int,
    derivative: int = 0,
    time_step: float = 1.0,
    mask: Optional[torch.Tensor] = None,
    boundary: Union[str, BoundaryMode] = TRUNCATE,
    mesh,
    seq_axis: str = "seq",
    batch_axis: Optional[str] = "batch",
    min_points: Optional[int] = None,
    fill: float = float("nan"),
    solver: str = "normal",
    method: str = "auto",
) -> torch.Tensor:
    """:func:`savgol_tpu_torch.savgol_apply_masked` (filter axis LAST) of
    this rank's block ``x`` of a global array whose sample axis is cut over
    ``mesh[seq_axis]``; nothing crosses ``batch_axis``.

    The halo carries ``half_window`` samples of (sanitized values,
    weights) each way; the rank then runs the single-device masked
    pipeline on its extended block. Results equal the single-device call.
    """
    del batch_axis
    boundary = _norm_boundary(boundary, BoundaryMode, "masked")
    n = int(half_window)
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None, :]
        if mask is not None and mask.dim() == 1:
            mask = mask[None, :]
    ring = mesh_axis(mesh, seq_axis)
    _check_local(x.shape[-1], n, "shard")
    xz, wts = _sanitize(x, mask)
    periodic = boundary is BoundaryMode.PERIODIC
    xp = _extend(xz, n, boundary, ring, periodic=periodic)
    wp = _extend(wts, n, boundary, ring, periodic=periodic)
    y = savgol_apply_masked(
        xp, half_window=n, poly_order=poly_order, derivative=derivative,
        time_step=time_step, mask=wp, boundary=TRUNCATE,
        min_points=min_points, fill=fill, solver=solver, method=method)
    y = y[..., n:y.shape[-1] - n]
    return y[0] if squeeze else y


def nonuniform_apply_sharded(
    x: torch.Tensor,
    t: torch.Tensor,
    *,
    half_window: int,
    poly_order: int,
    derivative: int = 0,
    mask: Optional[torch.Tensor] = None,
    mesh,
    seq_axis: str = "seq",
    batch_axis: Optional[str] = "batch",
    min_points: Optional[int] = None,
    fill: float = float("nan"),
    rcond: Optional[float] = None,
    method: str = "auto",
) -> torch.Tensor:
    """:func:`savgol_tpu_torch.savgol_apply_nonuniform` (filter axis LAST)
    of this rank's blocks ``x`` and ``t`` (shaped like ``x``, or its
    (N_local,) slice of a shared abscissa row).

    The halo carries (values, weights, raw abscissae); the outer ranks
    zero their halo weights (truncate semantics), so the wrapped abscissae
    need no fixup. Each rank runs the single-device pipeline on its
    extended block.
    """
    del batch_axis
    n = int(half_window)
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None, :]
    t = torch.as_tensor(t, device=x.device)
    if not t.is_floating_point():
        t = t.to(x.dtype)
    if t.dim() == 1 and t.shape[0] == x.shape[-1]:
        t = t.expand(x.shape)
    if t.shape != x.shape:
        raise ValueError(
            f"t shape {tuple(t.shape)} is neither x's shape "
            f"{tuple(x.shape)} nor (x.shape[-1],)")
    if mask is not None and squeeze and mask.dim() == 1:
        mask = mask[None, :]
    ring = mesh_axis(mesh, seq_axis)
    _check_local(x.shape[-1], n, "shard")
    xz, wts = _sanitize(x, mask, extra_finite=t)
    xp = _extend(xz, n, TRUNCATE, ring)
    wp = _extend(wts, n, TRUNCATE, ring)
    # halo abscissae ride RAW; the outer ranks' zeroed halo weights make
    # the wrapped values unreachable
    tp = _extend(t, n, TRUNCATE, ring, periodic=True)
    y = savgol_apply_nonuniform(
        xp, tp, half_window=n, poly_order=poly_order, derivative=derivative,
        mask=wp, min_points=min_points, fill=fill, rcond=rcond,
        method=method)
    y = y[..., n:y.shape[-1] - n]
    return y[0] if squeeze else y


def masked2d_apply_sharded(
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
    mesh,
    row_axis: str = "rows",
    batch_axis: Optional[str] = None,
    min_points: Optional[int] = None,
    fill: float = float("nan"),
    rcond: Optional[float] = None,
    method: str = "auto",
) -> torch.Tensor:
    """:func:`savgol_tpu_torch.savgol2d_apply_masked` of this rank's block
    ``x`` of a global image whose rows (axis -2) are cut over
    ``mesh[row_axis]``.

    The halo carries ``half_window_y`` rows of (values, weights) each way;
    columns are local, so non-truncate boundaries pad them locally with the
    edge / symmetric / wrap mode the single-device path applies globally,
    and the row ring supplies the row pads (the outer ranks synthesize
    theirs, PERIODIC wraps).
    """
    del batch_axis
    boundary = _norm_boundary(boundary, Boundary2D, "masked 2D")
    nx, ny = int(half_window_x), int(half_window_y)
    ring = mesh_axis(mesh, row_axis)
    _check_local(x.shape[-2], ny, "row-shard")
    xz, wts = _sanitize(x, mask)
    periodic = boundary is Boundary2D.PERIODIC
    if boundary != TRUNCATE:
        # local column pads FIRST, so the row halos (and the outer ranks'
        # row virtuals) carry column-padded rows: sequential edge /
        # symmetric / wrap padding equals np.pad's joint corners
        mode = _PAD_MODE_2D[boundary]
        xz, wts = pad_last(xz, nx, mode), pad_last(wts, nx, mode)
    xp = _extend(xz, ny, boundary, ring, dim=-2, periodic=periodic)
    wp = _extend(wts, ny, boundary, ring, dim=-2, periodic=periodic)
    y = savgol2d_apply_masked(
        xp, half_window_x=nx, half_window_y=ny, poly_order=poly_order,
        deriv_x=deriv_x, deriv_y=deriv_y, delta_x=delta_x, delta_y=delta_y,
        mask=wp, boundary=TRUNCATE, min_points=min_points, fill=fill,
        rcond=rcond, method=method)
    y = y[..., ny:y.shape[-2] - ny, :]
    return y[..., nx:y.shape[-1] - nx] if boundary != TRUNCATE else y
