"""Savitzky-Golay weight generation on the host, in numpy float64.

The host half of ``savgol_tpu.ops.weights``: the same three-term Gram
polynomial recurrence run over whole vectors, so the tables are
bit-identical to the JAX package's f64 host tables
(``tests/test_torch_config_weights.py``). The weights are computed once per
filter and then cast and placed on the device by
:class:`savgol_tpu_torch.Savgol1D`.

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

import math

import numpy as np

from savgol_tpu_torch.config import Savgol2DConfig, SavgolConfig

__all__ = [
    "genfact",
    "gram_poly_table",
    "savgol_weights_np",
    "savgol_all_weights_np",
    "monomial_index",
    "savgol2d_weights_np",
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


def _gram_table(points: np.ndarray, n: int, m: int, dmax: int) -> np.ndarray:
    """Gram polynomial table G[k, d, :] = F_k^{(d)}(points).

    Returns an array of shape (m+1, dmax+1, len(points)).
    """
    i = points
    zeros = np.zeros_like(i)
    ones = np.ones_like(i)

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
    return np.stack([np.stack(r) for r in rows])


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


def savgol_all_weights_np(config: SavgolConfig, dtype=np.float32):
    """Stacked (n+1, 2n+1) weight matrix: row 0 = center, rows 1..n = edges."""
    c, e = savgol_weights_np(config, dtype)
    return np.concatenate([c[None, :], e], axis=0)


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
