"""Multi-rank 2D Savitzky-Golay: row-sharded and (rows x cols)-tiled
overlap-save (counterpart of ``savgol_tpu.parallel.sharded2d``).

Each rank holds a block of the image rows (and, with ``col_axis``, of the
columns); it exchanges ``half_window_y`` halo rows (and ``half_window_x``
halo columns) with its ring neighbours and then runs the dense local
stencil (kernel K2D-dense for a CUDA tensor) in VALID mode over the
extended block. The outermost ranks synthesize virtual rows / columns by the
boundary mode (CONSTANT clamps, REFLECT mirrors with the edge duplicated);
PERIODIC keeps the exchanged ring halo (under two-axis tiling the mesh is a
torus). In the tiled layout the column exchange runs FIRST and the row
exchange ships the column-extended tile, so each corner arrives from the
diagonal neighbour with no message of its own.
"""

from __future__ import annotations

from typing import Optional

import torch

from savgol_tpu_torch.config import Boundary2D
from savgol_tpu_torch.ops.apply import _check_device, _compute_dtype
from savgol_tpu_torch.ops.apply2d import (_PAD_MODE_2D, _correlate, _promote,
                                          _resolve_method2d)
from savgol_tpu_torch.ops.cuda_conv import pad_last, scale_of
from savgol_tpu_torch.ops.cuda_halo import halo_exchange_plain
from savgol_tpu_torch.parallel.ici_halo import (exchange_rows,
                                                halo_exchange_rdma,
                                                halo_exchange_rdma_rows)
from savgol_tpu_torch.parallel.sharded import (_HALOS, _halo_exchange,
                                               mesh_axis)

__all__ = ["apply2d_sharded"]


def _halo_rows(x_local, ny: int, group):
    """``(top_halo, bottom_halo)``, each (..., ny, C), by point-to-point
    sends (wrap-around)."""
    return exchange_rows(x_local, ny, group, halo_exchange_plain)


def _exchange_rows(x_local, ny, group, halo):
    if halo == "rdma":
        return halo_exchange_rdma_rows(x_local, ny, group)
    return _halo_rows(x_local, ny, group)


def _exchange_cols(x_local, nx, group, halo):
    if halo == "rdma":
        # K13 on the last axis: the (..., R, nx) column blocks go as one
        # contiguous (R, nx) block each way, so no transposed copy of the
        # tile is needed (the JAX package transposes for its row kernel)
        return halo_exchange_rdma(x_local, nx, group)
    # column halos are the last axis' exchange (the JAX package's
    # _halo_cols)
    return _halo_exchange(x_local, nx, group)


def _virtual(z, n: int, boundary: Boundary2D, dim: int):
    """The outer ranks' (before, after) halos along ``dim``: REFLECT
    mirrors with the edge duplicated, CONSTANT (and VALID, whose halo
    outputs are trimmed) clamps to the edge."""
    L = z.shape[dim]
    if boundary is Boundary2D.REFLECT:
        return z.narrow(dim, 0, n).flip(dim), z.narrow(dim, L - n, n).flip(dim)
    shape = list(z.shape)
    shape[dim] = n
    return (z.narrow(dim, 0, 1).expand(shape),
            z.narrow(dim, L - 1, 1).expand(shape))


def _extend(z, n, boundary, ring, dim, halos):
    """``z`` with the ring's halos of width ``n`` on both sides of ``dim``,
    the outer ranks' replaced by virtual ones unless PERIODIC."""
    _, idx, size = ring
    before, after = halos
    if boundary is not Boundary2D.PERIODIC:
        vbefore, vafter = _virtual(z, n, boundary, dim)
        before = vbefore if idx == 0 else before
        after = vafter if idx == size - 1 else after
    return torch.cat([before, z, after], dim=dim)


def _local2d_tiled(x_local, weights, scale, boundary, rows, cols, route,
                   halo):
    """Local compute of the (rows x cols)-tiled layout: column halos first
    on the raw tile, then the rows of the column-extended tile, so the
    corners ride along; then the VALID stencil over the extended tile."""
    H, W = weights.shape[-2:]
    ny, nx = (H - 1) // 2, (W - 1) // 2
    rloc, cloc = x_local.shape[-2:]
    if rloc < H:
        raise ValueError(
            f"local row count ({rloc}) must be >= window height ({H})")
    if cloc < W:
        raise ValueError(
            f"local column count ({cloc}) must be >= window width ({W})")
    xc = _extend(x_local, nx, boundary, cols, -1,
                 _exchange_cols(x_local, nx, cols[0], halo))
    xr = _extend(xc, ny, boundary, rows, -2,
                 _exchange_rows(xc, ny, rows[0], halo))
    return _correlate(xr, weights, scale_of(scale, xr, xr.dtype), None,
                      route)


def _local2d(x_local, weights, scale, boundary, rows, route, halo):
    """Local compute of the row-sharded layout: halo rows over the ring,
    columns padded locally by the boundary mode (none for VALID), then the
    VALID stencil."""
    H, W = weights.shape[-2:]
    ny, nx = (H - 1) // 2, (W - 1) // 2
    rloc = x_local.shape[-2]
    if rloc < H:
        raise ValueError(
            f"local row count ({rloc}) must be >= window height ({H})")
    xr = _extend(x_local, ny, boundary, rows, -2,
                 _exchange_rows(x_local, ny, rows[0], halo))
    if boundary is not Boundary2D.VALID:
        xr = pad_last(xr, nx, _PAD_MODE_2D[boundary])
    return _correlate(xr, weights, scale_of(scale, xr, xr.dtype), None,
                      route)


def _trim(y, n: int, ring, dim: int):
    """Drop the ``n`` outputs the outer ranks computed against synthesized
    halos (the global VALID trim)."""
    _, idx, size = ring
    lo = n if idx == 0 else 0
    hi = y.shape[dim] - (n if idx == size - 1 else 0)
    return y.narrow(dim, lo, hi - lo)


def apply2d_sharded(
    x: torch.Tensor,
    weights: torch.Tensor,
    *,
    mesh,
    boundary: Boundary2D = Boundary2D.CONSTANT,
    scale: float | torch.Tensor = 1.0,
    seq_axis: str = "seq",
    batch_axis: Optional[str] = "batch",
    col_axis: Optional[str] = None,
    method: str = "auto",
    halo: str = "ppermute",
) -> torch.Tensor:
    """2D filter of this rank's block ``x`` ((..., R_local, C_local) or 2D)
    of a global image whose rows are cut over ``mesh[seq_axis]`` and, when
    ``col_axis`` names a second mesh dimension, whose columns are cut over
    it. Nothing crosses ``batch_axis``.

    Semantics identical to ``savgol2d_apply`` on the global image: VALID
    trims the global edges, so the outer ranks' blocks come back shorter.
    ``halo`` selects the exchange: ``"ppermute"`` (point-to-point sends) or
    ``"rdma"`` (kernel K13, see :mod:`savgol_tpu_torch.parallel.ici_halo`);
    both give identical results. Differentiable in ``x``, the stencil and a
    tensor ``scale``.
    """
    del batch_axis     # a rank already holds its batch block
    if halo not in _HALOS:
        raise ValueError(f"halo must be 'ppermute' or 'rdma', got {halo!r}")
    if halo == "rdma" and col_axis is not None and x.device.type != "cuda":
        # parity with the JAX package, whose interpret mode cannot
        # discharge remote DMA on a two-axis mesh off the TPU
        raise NotImplementedError(
            "halo='rdma' with two-axis tiling runs kernel K13 and needs CUDA "
            "tensors; use halo='ppermute' for CPU tensors")
    route = _resolve_method2d(method, x)
    if not isinstance(boundary, Boundary2D):
        boundary = Boundary2D(boundary)
    _check_device(x, weights)
    H, W = weights.shape[-2:]
    ny, nx = (H - 1) // 2, (W - 1) // 2
    squeeze = x.dim() == 2
    if squeeze:
        x = x[None]
    x, restore = _compute_dtype(_promote(x, weights), route == "bf16")
    rows = mesh_axis(mesh, seq_axis)
    if col_axis is not None:
        cols = mesh_axis(mesh, col_axis)
        y = _local2d_tiled(x, weights, scale, boundary, rows, cols, route,
                           halo)
    else:
        y = _local2d(x, weights, scale, boundary, rows, route, halo)
    if boundary is Boundary2D.VALID:
        # outputs computed against synthesized halos at the global edges
        # are not valid; drop them to match the unsharded VALID output
        y = _trim(y, ny, rows, -2)
        if col_axis is not None:
            y = _trim(y, nx, cols, -1)
    if restore is not None:
        y = y.to(restore)
    return y[0] if squeeze else y
