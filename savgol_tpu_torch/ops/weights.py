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
"""

from __future__ import annotations

import numpy as np

from savgol_tpu_torch.config import SavgolConfig

__all__ = [
    "genfact",
    "gram_poly_table",
    "savgol_weights_np",
    "savgol_all_weights_np",
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
