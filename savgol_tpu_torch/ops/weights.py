"""Savitzky-Golay weight generation on the host, in numpy float64, and on
the device, in the working dtype (counterpart of
``savgol_tpu.ops.weights``).

The host generators run the same three-term Gram polynomial recurrence
over whole vectors, so the tables are bit-identical to the JAX package's
f64 host tables (``tests/test_torch_config_weights.py``). They are computed
once per filter and then cast and placed on the device by
:class:`savgol_tpu_torch.Savgol1D`. The device generators
(:func:`savgol_weights`, :func:`savgol_all_weights`,
:func:`savgol2d_weights`) run the same constructions on tensors in the
working dtype, for pipelines that generate their weights where they use
them. They form every sum as elementwise products and ``.sum()``, never
``matmul`` or ``einsum``, so no TF32 setting of the card can change a bit
(the JAX package pins ``Precision.HIGHEST`` for the same reason).

Math (reference src/savgolFilter.c:207-218, 312-318):

  F_0^{(d)}(i)  = [d == 0]
  F_1^{(d)}(i)  = (1/n) * (i * F_0^{(d)}(i) + d * F_0^{(d-1)}(i))
  F_k^{(d)}(i)  = a_k * (i * F_{k-1}^{(d)}(i) + d * F_{k-1}^{(d-1)}(i))
                  - g_k * F_{k-2}^{(d)}(i)
      a_k = (4k - 2) / (k (2n - k + 1))
      g_k = (k - 1)(2n + k) / (k (2n - k + 1))

  w(i, t) = sum_{k=0..m} (2k+1) * GenFact(2n, k) / GenFact(2n+k+1, k+1)
                         * F_k^{(0)}(i) * F_k^{(d)}(t)

where GenFact(a, b) = a (a-1) ... (a-b+1) is the falling factorial.

The 2D stencil (:func:`savgol2d_weights_np`) is one row of the
pseudo-inverse of the window's monomial design matrix, solved in f64 with
the same singular-geometry rule as the JAX package.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from savgol_tpu_torch._device import card_unless_named
from savgol_tpu_torch.config import Savgol2DConfig, SavgolConfig

__all__ = [
    "genfact",
    "gram_poly_table",
    "savgol_weights_np",
    "savgol_weights",
    "savgol_all_weights_np",
    "savgol_all_weights",
    "monomial_index",
    "savgol2d_weights_np",
    "savgol2d_weights",
]


def genfact(a: int, b: int) -> float:
    """Falling factorial GenFact(a, b) = a! / (a-b)! as an exact f64.

    Matches the reference's table entries (src/savgolFilter.c:151-176):
    empty product is 1, and b > a yields 0.
    """
    if b > a:
        return 0.0
    out = 1.0
    for j in range(a - b + 1, a + 1):
        out *= float(j)
    return out


def _norm_factors(n: int, m: int) -> np.ndarray:
    """(2k+1) * GenFact(2n,k) / GenFact(2n+k+1,k+1) for k = 0..m, f64."""
    return np.array(
        [(2 * k + 1) * genfact(2 * n, k) / genfact(2 * n + k + 1, k + 1)
         for k in range(m + 1)],
        dtype=np.float64,
    )


@functools.cache
def _factors(n: int, m: int) -> tuple:
    """:func:`_norm_factors` as Python floats, kept per (n, m) for the
    device generators (a tuple: no caller can write into it)."""
    return tuple(_norm_factors(n, m).tolist())


def _gram_table(points, n: int, m: int, dmax: int, xp=np):
    """Gram polynomial table G[k, d, :] = F_k^{(d)}(points).

    ``points`` is a 1D array of evaluation points and ``xp`` its module,
    numpy or torch (the same statements for both). Returns an array of
    shape (m+1, dmax+1, len(points)).
    """
    i = points
    zeros = xp.zeros_like(i)
    ones = xp.ones_like(i)

    # rows[k][d] : F_k^{(d)} over all points
    row0 = [ones] + [zeros] * dmax
    rows = [row0]
    if m >= 1:
        inv_n = 1.0 / n
        row1 = [inv_n * (i * row0[0])]
        for d in range(1, dmax + 1):
            row1.append(inv_n * (i * row0[d] + d * row0[d - 1]))
        rows.append(row1)
    for k in range(2, m + 1):
        denom = k * (2.0 * n - k + 1.0)
        alpha = (4.0 * k - 2.0) / denom
        gamma = ((k - 1.0) * (2.0 * n + k)) / denom
        prev1, prev2 = rows[k - 1], rows[k - 2]
        curr = [alpha * (i * prev1[0]) - gamma * prev2[0]]
        for d in range(1, dmax + 1):
            curr.append(alpha * (i * prev1[d] + d * prev1[d - 1])
                        - gamma * prev2[d])
        rows.append(curr)
    return xp.stack([xp.stack(r) for r in rows])


def gram_poly_table(n: int, m: int, dmax: int, dtype=np.float64) -> np.ndarray:
    """Gram table over the window: shape (m+1, dmax+1, 2n+1), evaluated at
    integer points i = -n..n."""
    pts = np.arange(-n, n + 1, dtype=np.float64)
    return _gram_table(pts, n, m, dmax).astype(dtype)


def _weights_from_table(G: np.ndarray, factors: np.ndarray, n: int, d: int):
    """Combine a Gram table into (center, edge) weight arrays.

    Targets: t = 0 for the center stencil (src/savgolFilter.c:368-378) and
    t = n - e for edge row e (src/savgolFilter.c:394-409). Point t maps to
    table column t + n.
    """
    basis = G[:, 0, :]                       # (m+1, 2n+1)
    center_t = G[:, d, n]                    # F_k^{(d)}(0)
    center = np.einsum("k,ki->i", factors * center_t, basis)
    edge_cols = G[:, d, :][:, ::-1][:, : n]  # edge_cols[k, e] = F_k^{(d)}(n - e)
    edge = np.einsum("ke,ki->ei", factors[:, None] * edge_cols, basis)
    return center, edge


def savgol_weights_np(config: SavgolConfig, dtype=np.float32):
    """Reference-parity weights in full f64, cast at the end.

    Returns ``(center, edge)`` with shapes ``(2n+1,)`` and ``(n, 2n+1)``.
    ``center[idx]`` weights input point i = idx - n; ``edge[e]`` is the row
    used for output position e (leading, data reversed) and position
    N-1-e (trailing, data forward) — see src/savgolFilter.c:769-784.
    """
    n, m, d = config.half_window, config.poly_order, config.derivative
    G = gram_poly_table(n, m, d)
    factors = _norm_factors(n, m)
    center, edge = _weights_from_table(G, factors, n, d)
    return center.astype(dtype), edge.astype(dtype)


def savgol_weights(half_window: int, poly_order: int, derivative: int = 0,
                   dtype=torch.float32, *, device=None):
    """The weights of :func:`savgol_weights_np`, generated on ``device`` in
    ``dtype``: ``(center (2n+1,), edge (n, 2n+1))``.

    The Gram recurrence runs over a tensor of the window's points; the
    normalisation factors are computed in f64 on the host and cast to
    ``dtype``. ``device=None`` means the card, and raises without one.
    Every call returns new tensors, which the caller may write into.
    """
    n, m, d = half_window, poly_order, derivative
    device = card_unless_named(device, "savgol_weights")
    pts = torch.arange(-n, n + 1, dtype=dtype, device=device)
    G = _gram_table(pts, n, m, d, torch)         # (m+1, d+1, 2n+1)
    factors = torch.tensor(_factors(n, m), dtype=dtype, device=device)
    basis = G[:, 0, :]
    center = ((factors * G[:, d, n])[:, None] * basis).sum(0)
    edge_cols = G[:, d, n + 1:].flip(-1)   # [k, e] = F_k^{(d)}(n - e)
    edge = ((factors[:, None] * edge_cols)[:, :, None]
            * basis[:, None, :]).sum(0)
    return center, edge


def savgol_all_weights_np(config: SavgolConfig, dtype=np.float32):
    """Stacked (n+1, 2n+1) weight matrix: row 0 = center, rows 1..n = edges."""
    c, e = savgol_weights_np(config, dtype)
    return np.concatenate([c[None, :], e], axis=0)


def savgol_all_weights(half_window: int, poly_order: int, derivative: int = 0,
                       dtype=torch.float32, *, device=None):
    """:func:`savgol_weights` stacked as (n+1, 2n+1): row 0 = center, rows
    1..n = edges."""
    c, e = savgol_weights(half_window, poly_order, derivative, dtype,
                          device=device)
    return torch.cat([c[None, :], e], dim=0)


# ---------------------------------------------------------------------------
# 2D weights: design matrix + normal equations
# (reference src/savgol2d.c:57-265)
# ---------------------------------------------------------------------------


def monomial_index(i: int, j: int) -> int:
    """Index of x^i y^j in the degree-major monomial ordering
    (1; x, y; x^2, xy, y^2; ...) — reference src/savgol2d.c:57-65."""
    total = i + j
    return total * (total + 1) // 2 + j


def _design_matrix_np(nx: int, ny: int, order: int) -> np.ndarray:
    """Design matrix A: rows = window points (y-major, x fastest), columns =
    monomials x^i y^j with i+j <= order, f64.
    (reference src/savgol2d.c:77-105)."""
    xs = np.arange(-nx, nx + 1, dtype=np.float64)
    ys = np.arange(-ny, ny + 1, dtype=np.float64)
    X, Y = np.meshgrid(xs, ys)               # (H, W), y-major rows
    x = X.ravel()
    y = Y.ravel()
    nterms = (order + 1) * (order + 2) // 2
    A = np.empty((x.size, nterms), dtype=np.float64)
    for tot in range(order + 1):
        for j in range(tot + 1):
            i = tot - j
            A[:, monomial_index(i, j)] = x**i * y**j
    return A


def savgol2d_weights_np(config: Savgol2DConfig, dtype=np.float32) -> np.ndarray:
    """2D convolution weights, shape (window_height, window_width).

    weights = A @ (A^T A)^{-1} e_k * dx! * dy!, i.e. the row of pinv(A)
    selecting the coefficient of monomial x^dx y^dy, scaled so that the
    polynomial coefficient becomes the derivative value
    (reference src/savgol2d.c:188-265). Solved in f64 via Cholesky
    (the normal matrix is SPD for valid configs), cast to ``dtype``.
    """
    nx, ny = config.half_window_x, config.half_window_y
    order = config.poly_order
    dx, dy = config.deriv_x, config.deriv_y
    A = _design_matrix_np(nx, ny, order)
    k = monomial_index(dx, dy)
    # Degenerate window geometries make monomial columns coincide on the
    # grid (e.g. half_window_y=1 with order 3: y^3 == y on {-1,0,1}), so
    # the polynomial FIT is ambiguous — but the weights w = A c are
    # invariant across the solution family of a CONSISTENT singular
    # system (two solutions differ by a null vector of A, which A
    # annihilates), so the FILTER is still well-defined whenever e_k is
    # orthogonal to the null space, i.e. the requested coefficient does
    # not mix into the ambiguity (e.g. half_window_x=1 order 3 target
    # x*y^2: only x vs x^3 are ambiguous). Those configs solve via the
    # truncated pseudo-inverse (min-norm, deterministic — no Cholesky
    # pivot luck). Only when the target coefficient itself lies in the
    # null space (d/dy with y^3 == y: c_y vs c_{y^3} indistinguishable)
    # is the functional ill-posed — reject. Neither a Cholesky failure
    # nor an unnormalized solve residual detects that case reliably:
    # LAPACK can factor the singular normal matrix by rounding luck and
    # the huge column scales hide the residual (observed: (8,1,order 3,
    # dy=1) returned d/dy weights off by 10x with residual 4e-14). All
    # decisions use the column-normalized design (scale-invariant;
    # measured gap: full-rank geometries have sigma_min/sigma_max
    # >= 4.5e-3, degenerate ones <= 2e-16).
    norms = np.linalg.norm(A, axis=0)
    s, Vt = np.linalg.svd(A / norms, compute_uv=True)[1:]
    deficient = s <= 1e-8 * s[0]
    if deficient.any():
        if np.linalg.norm(Vt[deficient][:, k]) > 1e-6:
            raise np.linalg.LinAlgError(
                f"ill-posed 2D window: the coefficient of "
                f"x^{dx} y^{dy} is not identifiable at order {order} on a "
                f"{config.window_height}x{config.window_width} grid "
                "(coincident monomial columns include the target); "
                "increase the half-windows or lower poly_order")
        keep = ~deficient
        e_n = np.zeros(A.shape[1], dtype=np.float64)
        e_n[k] = 1.0 / norms[k]
        # min-norm b solving (An^T An) b = e/D_k, then c = D^{-1} b
        b = Vt[keep].T @ ((Vt[keep] @ e_n) / s[keep] ** 2)
        c = b / norms
    else:
        ata = A.T @ A
        e = np.zeros(A.shape[1], dtype=np.float64)
        e[k] = 1.0
        try:
            L = np.linalg.cholesky(ata)
            c = np.linalg.solve(L.T, np.linalg.solve(L, e))
        except np.linalg.LinAlgError as err:
            raise np.linalg.LinAlgError(
                f"2D normal matrix not factorable in f64 for order {order} "
                f"on a {config.window_height}x{config.window_width} grid"
            ) from err
    scale = math.factorial(dx) * math.factorial(dy)
    w = (A @ c) * scale
    return w.reshape(config.window_height, config.window_width).astype(dtype)


def _check_design_rank(A: np.ndarray, wh: int, ww: int, order: int) -> None:
    """Reject rank-deficient monomial bases for the device generator (its
    Cholesky cannot take the min-norm pseudo-inverse route the host
    generator uses for rank-deficient-but-well-posed targets)."""
    An = A / np.linalg.norm(A, axis=0, keepdims=True)
    s = np.linalg.svd(An, compute_uv=False)
    if s[-1] <= 1e-8 * s[0]:
        raise np.linalg.LinAlgError(
            f"degenerate 2D window for the on-device generator: the "
            f"order-{order} monomial basis is rank-deficient on a "
            f"{wh}x{ww} grid (coincident monomial columns); increase the "
            "half-windows or lower poly_order — well-posed derivative "
            "targets on such grids are served by the host generator "
            "savgol2d_weights_np")


@functools.lru_cache(maxsize=None)
def _validate_2d_geometry(nx: int, ny: int, order: int,
                          np_dtype=np.float32) -> None:
    """The device generator's degeneracy check, on the host before any
    tensor is made.

    Whether a Cholesky factorization in the working dtype can factor the
    normal matrix is a function of the geometry (nx, ny, order) and the
    dtype only; without the check, a singular system would give NaN
    weights. Rejects (a) geometries with coincident monomial columns
    (rank-deficient, e.g. half_window_y=1 with order 3, where y^3 == y on
    {-1,0,1}; the reference also refuses these, src/savgol2d.c:144-148)
    and (b) systems whose working-dtype factorization fails even though
    f64 LAPACK would cope — for those, use the host generator
    ``savgol2d_weights_np``."""
    A = _design_matrix_np(nx, ny, order)
    # scale-invariant rank test (a raw matrix_rank of the huge-entry normal
    # matrix falsely rejects valid large configs, e.g. (16,16,order 6),
    # whose f64 solve is exact) ...
    _check_design_rank(A, 2 * ny + 1, 2 * nx + 1, order)
    # ... then predict working-dtype factorability of the actual system
    try:
        np.linalg.cholesky((A.T @ A).astype(np_dtype))
    except np.linalg.LinAlgError:
        raise np.linalg.LinAlgError(
            f"2D window not factorable in the working dtype for the "
            f"on-device generator: order-{order} normal matrix on a "
            f"{2 * ny + 1}x{2 * nx + 1} grid; use a wider dtype or the "
            "host generator savgol2d_weights_np")


def savgol2d_weights(half_window_x: int, half_window_y: int, poly_order: int,
                     deriv_x: int = 0, deriv_y: int = 0, dtype=torch.float32,
                     *, device=None) -> torch.Tensor:
    """The 2D stencil of :func:`savgol2d_weights_np`, generated on
    ``device`` in ``dtype``: shape (2 half_window_y + 1, 2 half_window_x +
    1).

    The same normal equations as the host generator, formed in the
    working dtype and solved by a Cholesky factorization. Degenerate
    window geometries raise ``numpy.linalg.LinAlgError`` before any tensor
    is made (the singularity is knowable from the arguments alone).
    ``device=None`` means the card, and raises without one.
    """
    nx, ny, order = half_window_x, half_window_y, poly_order
    np_dtype = np.float64 if dtype.itemsize >= 8 else np.float32
    _validate_2d_geometry(nx, ny, order, np_dtype)
    device = card_unless_named(device, "savgol2d_weights")
    A = torch.tensor(_design_matrix_np(nx, ny, order), dtype=dtype,
                     device=device)                  # (points, terms)
    ata = (A[:, :, None] * A[:, None, :]).sum(0)
    e = torch.zeros((A.shape[1], 1), dtype=dtype, device=device)
    e[monomial_index(deriv_x, deriv_y)] = 1.0
    c = torch.cholesky_solve(e, torch.linalg.cholesky(ata))[:, 0]
    scale = float(math.factorial(deriv_x) * math.factorial(deriv_y))
    w = (A * c).sum(1) * scale
    return w.reshape(2 * ny + 1, 2 * nx + 1)
