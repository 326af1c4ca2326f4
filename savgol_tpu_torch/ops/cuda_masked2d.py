"""The fused masked 2D kernel of the port (K10, ``csrc/masked2d.cu``), its
host tables and its launch count (counterpart of
``savgol_tpu.ops.pallas_masked2d``).

In a tensor-product orthonormal basis B_(i,j)(x, y) = phi_i(x) psi_j(y)
(1D QR bases per axis, i + j <= m) every masked Gram entry is a fixed
combination ``comb`` of tensor moments T[s, t] = sum w phi_s(x) psi_t(y)
(host f64, exact grid-function expansions), so the kernel builds the Gram
from a few vertical profiles and horizontal correlations instead of Kp
dense pair stencils. :func:`tensor_tables_2d` and :func:`_extract_row` are
the JAX package's tables by the same numpy code.

:func:`savgol_masked2d_fused_cuda` launches K10 on a CUDA tensor; a CPU
tensor takes the plain staged version (``ops.masked._masked2d_staged``,
the joint-basis twin the JAX package differentiates through).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from savgol_tpu_torch._build import library
from savgol_tpu_torch.ops.cuda_conv import (_check_cuda_input,
                                            _plain_or_cuda, _raise_on_error)
from savgol_tpu_torch.ops.cuda_masked import SMEM_LIMIT
from savgol_tpu_torch.ops.cuda_solve import LOCAL_KMAX

__all__ = ["LAUNCHES", "reset_launches", "fused2d_supported",
           "tensor_tables_2d", "savgol_masked2d_fused_cuda"]

# Kernel launches since the last reset_launches(). Only the line that
# launches the kernel adds to its count.
LAUNCHES = {"masked2d": 0}

_TR, _TC = 8, 32            # masked2d.cu output tile (the runtime instance)
# comb entries at or under this size are rounding noise of the host
# expansions (products of exactly-zero grid inner products, ~1e-35; the
# meaningful ones are ~1e-2): tensor_tables_2d drops a moment no entry
# passes it, and the kernel's tables drop the entries (119 of 1,409 kept at
# 11x11, order 3), which moves a Gram entry by ~1e-33 of itself
_COMB_ZERO = 1e-13


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _ortho_1d(w: int, dmax: int):
    """Orthonormal degree-graded 1D polynomial basis on the centered grid
    t = (arange(w) - n) / n, as (Phi (w, dmax+1), Rinv (dmax+1, dmax+1))
    with positive leading coefficients (host f64)."""
    n = (w - 1) // 2
    t = (np.arange(w, dtype=np.float64) - n) / max(n, 1)
    V = np.vander(t, dmax + 1, increasing=True)
    Q, R = np.linalg.qr(V)
    s = np.sign(np.diag(R)).copy()
    s[s == 0] = 1.0
    Q = Q * s
    R = R * s[:, None]
    Rinv = np.linalg.solve(R, np.eye(dmax + 1))
    return Q, Rinv


def fused2d_supported(half_window_x: int, half_window_y: int,
                      poly_order: int) -> bool:
    """The tensor basis needs per-axis degree ``poly_order`` to be
    representable: m <= 2 * half_window per axis."""
    return (poly_order <= 2 * half_window_x
            and poly_order <= 2 * half_window_y)


@functools.lru_cache(maxsize=None)
def tensor_tables_2d(half_window_x: int, half_window_y: int,
                     poly_order: int):
    """Host f64 tables for the tensor-moment masked 2D fit.

    Returns a dict with:
      PhiX (wx, Sx), PhiY (wy, Sy): per-axis orthonormal bases up to
          degree min(2m, w-1) — moment profiles; columns <= m are the
          fit-basis profiles.
      RinvX, RinvY: monomial coefficients of the basis columns.
      basis: list of (i, j) per fit-basis function, i + j <= m.
      pair_index (P, P): symmetric map into the Kp gram-plane axis.
      moments: list of (s, t) tensor-moment indices actually used.
      comb (Kp, M): gram[k] = sum_mi comb[k, mi] * T[moments[mi]].
      idx00: moment index of (0, 0) (count = T00 * sqrt(wx*wy)).
    """
    nx, ny, m = int(half_window_x), int(half_window_y), int(poly_order)
    wx, wy = 2 * nx + 1, 2 * ny + 1
    dmx, dmy = min(2 * m, wx - 1), min(2 * m, wy - 1)
    if m > dmx or m > dmy:
        raise ValueError(
            f"tensor basis needs poly_order <= 2*half_window per axis "
            f"(got m={m}, windows {wx}x{wy})")
    PhiX, RinvX = _ortho_1d(wx, dmx)
    PhiY, RinvY = _ortho_1d(wy, dmy)

    basis = [(i, t - i) for t in range(m + 1) for i in range(t + 1)]
    P = len(basis)
    pair_index = np.zeros((P, P), dtype=np.int32)
    kp = 0
    pairs = []
    for a in range(P):
        for b in range(a, P):
            pair_index[a, b] = pair_index[b, a] = kp
            pairs.append((a, b))
            kp += 1
    Kp = len(pairs)

    # exact grid-function expansions of the 1D basis products: products of
    # degree <= 2m lie in span(Phi) because Phi spans grid polynomials up
    # to degree min(2m, w-1) and on a w-point grid degree w-1 is everything
    gxx = np.einsum("ws,wi,wk->sik", PhiX, PhiX[:, :m + 1], PhiX[:, :m + 1])
    gyy = np.einsum("wt,wj,wl->tjl", PhiY, PhiY[:, :m + 1], PhiY[:, :m + 1])

    comb_full = np.zeros((Kp, dmx + 1, dmy + 1))
    for k, (a, b) in enumerate(pairs):
        i, j = basis[a]
        kx, ly = basis[b]
        comb_full[k] = np.outer(gxx[:, i, kx], gyy[:, j, ly])
    # keep only moments some gram entry (or the count) actually reads
    used = np.abs(comb_full).max(axis=0) > 1e-13
    used[0, 0] = True
    moments = [(s, t) for s in range(dmx + 1) for t in range(dmy + 1)
               if used[s, t]]
    comb = np.stack([comb_full[:, s, t] for (s, t) in moments], axis=1)
    idx00 = moments.index((0, 0))
    return dict(PhiX=PhiX, PhiY=PhiY, RinvX=RinvX, RinvY=RinvY,
                basis=basis, pair_index=pair_index, moments=moments,
                comb=comb, idx00=idx00)


def _extract_row(tables, deriv_x, deriv_y, delta_x, delta_y,
                 half_window_x, half_window_y):
    """(P,) f64 derivative-extraction row: for basis (i, j) the fitted
    surface's (dx, dy) mixed partial at the window center is
    dx! RinvX[dx, i] * dy! RinvY[dy, j] / (nx dx_step)^dx / (ny dy_step)^dy."""
    dx, dy = int(deriv_x), int(deriv_y)
    sx = math.factorial(dx) / float(half_window_x * delta_x) ** dx
    sy = math.factorial(dy) / float(half_window_y * delta_y) ** dy
    return np.asarray([tables["RinvX"][dx, i] * tables["RinvY"][dy, j]
                       for (i, j) in tables["basis"]]) * (sx * sy)


@functools.lru_cache(maxsize=64)
def _kernel_tables(nx: int, ny: int, m: int, dx: int, dy: int,
                   delta_x: float, delta_y: float, device):
    """The kernel's (ftab, itab, (P, Sx, Sy, M, nnz)) on the device: PhiX^T,
    PhiY^T, the nonzero comb entries as CSR rows in the packed lower order
    of the Gram, the extraction row and the same entries by moment (CSC, the
    rows ascending within a moment), in float64 (the kernel's arithmetic for
    either input dtype); the moment and basis indices, the CSR offsets and
    columns and the CSC offsets and rows; entries under ``_COMB_ZERO`` are
    left out. Uploaded once per configuration."""
    t = tensor_tables_2d(nx, ny, m)
    basis, pi, comb = t["basis"], t["pair_index"], t["comb"]
    P = len(basis)
    offs, cols, vals = [0], [], []
    for a in range(P):
        for b in range(a + 1):
            row = comb[pi[a, b]]
            nz = np.flatnonzero(np.abs(row) > _COMB_ZERO)
            cols.extend(nz.tolist())
            vals.extend(row[nz].tolist())
            offs.append(len(cols))
    rows = np.repeat(np.arange(len(offs) - 1), np.diff(offs))
    by_moment = np.lexsort((rows, cols))
    moff = np.searchsorted(np.asarray(cols)[by_moment],
                           np.arange(len(t["moments"]) + 1))
    extract = _extract_row(t, dx, dy, delta_x, delta_y, nx, ny)
    ftab = np.concatenate([t["PhiX"].T.ravel(), t["PhiY"].T.ravel(),
                           np.asarray(vals, np.float64), extract,
                           np.asarray(vals, np.float64)[by_moment]])
    mom = np.asarray(t["moments"], np.int32).reshape(-1, 2)
    bas = np.asarray(basis, np.int32).reshape(-1, 2)
    itab = np.concatenate([mom[:, 0], mom[:, 1], bas[:, 0], bas[:, 1],
                           np.asarray(offs, np.int32),
                           np.asarray(cols, np.int32), moff,
                           rows[by_moment]]).astype(np.int32)
    dims = (P, t["PhiX"].shape[1], t["PhiY"].shape[1], len(t["moments"]),
            len(cols))
    return (torch.as_tensor(ftab, dtype=torch.float64, device=device),
            torch.as_tensor(itab, device=device), dims)


def savgol_masked2d_fused_cuda(
        xv: torch.Tensor, wp: torch.Tensor, *, half_window_x: int,
        half_window_y: int, poly_order: int, deriv_x: int = 0,
        deriv_y: int = 0, delta_x: float = 1.0, delta_y: float = 1.0,
        kmin: int, fill: float, rcond: float,
        weighted: bool = False) -> torch.Tensor:
    """Fused masked 2D fit on BOUNDARY-PADDED inputs: ``xv`` (..., R + 2ny,
    C + 2nx) mask-sanitized values (times the weights when ``weighted``),
    ``wp`` the matching weights (0 = missing). Returns the (..., R, C)
    filtered output with ``fill`` at under-quorum or unidentifiable pixels.

    CUDA tensors: kernel K10 on the current stream, no synchronisation; it
    computes in float64 for either dtype and rounds only the output. CPU
    tensors: the plain staged version."""
    name = "savgol_masked2d_fused_cuda"
    nx, ny, m = int(half_window_x), int(half_window_y), int(poly_order)
    if not _plain_or_cuda(xv, name):
        from savgol_tpu_torch.ops.masked import _masked2d_staged
        return _masked2d_staged(
            xv, wp, nx=nx, ny=ny, m=m, dx=int(deriv_x), dy=int(deriv_y),
            delta_x=float(delta_x), delta_y=float(delta_y), kmin=int(kmin),
            fill=fill, rcond=float(rcond), weighted=weighted, kernels=False)
    _check_cuda_input(xv, name)
    _check_cuda_input(wp, name)
    if wp.shape != xv.shape or wp.dtype != xv.dtype \
            or wp.device != xv.device or xv.dim() < 2:
        raise ValueError(f"{name}: values {tuple(xv.shape)} {xv.dtype} and "
                         f"weights {tuple(wp.shape)} {wp.dtype} differ")
    if not fused2d_supported(nx, ny, m):
        raise ValueError(f"{name}: poly_order {m} passes 2 * half window "
                         f"({nx}, {ny}); the tensor basis cannot hold it")
    Rp, Cp = xv.shape[-2:]
    R, C = Rp - 2 * ny, Cp - 2 * nx
    if R < 1 or C < 1:
        raise ValueError(f"{name}: image smaller than the boundary pad")
    if Rp * Cp >= 2 ** 31:
        raise ValueError(f"{name}: an image of {Rp} x {Cp} samples passes "
                         "the kernel's 32-bit in-image indices")
    ftab, itab, (P, Sx, Sy, M, nnz) = _kernel_tables(
        nx, ny, m, int(deriv_x), int(deriv_y), float(delta_x),
        float(delta_y), xv.device)
    if P > LOCAL_KMAX:
        raise ValueError(f"{name}: {P} polynomial terms pass the kernel's "
                         f"{LOCAL_KMAX}")
    sc = _TC + 2 * nx
    smem = 8 * (2 * (_TR + 2 * ny) * sc + (Sy + m + 2) * _TR * sc)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{name}: the staged tile needs {smem} bytes of "
                         f"shared memory, past the {SMEM_LIMIT} a block "
                         "may use")
    out = torch.empty(xv.shape[:-2] + (R, C), dtype=xv.dtype,
                      device=xv.device)
    B = xv.numel() // (Rp * Cp)
    if B == 0:
        return out
    lib = library()
    fn = lib.masked2d_f32 if xv.dtype == torch.float32 else lib.masked2d_f64
    with torch.cuda.device(xv.device):
        err = fn(xv.data_ptr(), wp.data_ptr(), out.data_ptr(), B, Rp, Cp, nx,
                 ny, m, P, Sx, Sy, M, nnz, ftab.data_ptr(), itab.data_ptr(),
                 int(kmin), float(fill), 1, math.sqrt(rcond),
                 torch.cuda.current_stream().cuda_stream)
    _raise_on_error(err, name)
    LAUNCHES["masked2d"] += 1
    return out
