"""Per-position small SPD solves on Gram entry planes, in plain PyTorch
(counterpart of ``savgol_tpu.ops.lsq``).

The masked paths solve one tiny k x k system per output position. The Gram
arrives as a stack of its k(k+1)/2 unique ENTRY PLANES, (Kp, ...), the
layout the bank correlations produce, and the factorization runs as
elementwise ops over the position axes. These functions are the plain
versions of kernels K8a (:func:`cholesky_solve_planes`) and K8b
(:func:`cholesky_solve_planes_dd`), the CPU path of every masked route and
the functions whose autograd gives the gradients.

The double-word helpers carry ~2x working precision in (hi, lo) pairs
[Dekker 1971; Hida/Li/Bailey QD]; ``solver="qr"`` forms its Gram and rhs
with them (:func:`correlate_valid_dd`). No op here is a matmul or a
convolution, so TF32 cannot enter them on the card.

``sliding_windows`` and ``cholqr_lstsq`` are not ported: no masked or
nonuniform path uses them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["cholesky_solve_planes", "cholesky_solve_planes_dd",
           "correlate_valid_dd"]


def _split_const(dtype) -> float:
    return float(2 ** 27 + 1) if dtype == torch.float64 else float(2 ** 12 + 1)


def _two_sum(a, b):
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _quick_two_sum(a, b):
    # requires |a| >= |b|
    s = a + b
    return s, b - (s - a)


def _two_prod(a, b, c):
    p = a * b
    ac = a * c
    ahi = ac - (ac - a)
    alo = a - ahi
    bc = b * c
    bhi = bc - (bc - b)
    blo = b - bhi
    e = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo
    return p, e


def _dd_add(x, y):
    s, e = _two_sum(x[0], y[0])
    e = e + (x[1] + y[1])
    return _quick_two_sum(s, e)


def _dd_sub(x, y):
    return _dd_add(x, (-y[0], -y[1]))


def _dd_mul(x, y, c):
    p, e = _two_prod(x[0], y[0], c)
    e = e + (x[0] * y[1] + x[1] * y[0])
    return _quick_two_sum(p, e)


def _dd_div(x, y, c):
    q1 = x[0] / y[0]
    r = _dd_sub(x, _dd_mul((q1, torch.zeros_like(q1)), y, c))
    q2 = r[0] / y[0]
    r = _dd_sub(r, _dd_mul((q2, torch.zeros_like(q2)), y, c))
    q3 = r[0] / y[0]
    s, e = _quick_two_sum(q1, q2)
    return _quick_two_sum(s, e + q3)


def _dd_sqrt(x, c):
    t = torch.sqrt(x[0])
    p, e = _two_prod(t, t, c)
    d = (((x[0] - p) - e) + x[1]) / (2.0 * t)
    return _quick_two_sum(t, d)


def _identifiable(diag: torch.Tensor, quorum: torch.Tensor,
                  rcond: float) -> torch.Tensor:
    """The per-position identifiability rule: quorate, a finite Cholesky
    diagonal, and its smallest entry above ``sqrt(rcond)`` times its
    largest magnitude."""
    dmax = diag.abs().amax(dim=0)
    floor = torch.full((), 1e-30, dtype=diag.dtype, device=diag.device)
    return (quorum & torch.isfinite(diag).all(dim=0)
            & (diag.amin(dim=0) > math.sqrt(rcond) * torch.maximum(dmax,
                                                                   floor)))


def cholesky_solve_planes(gram: torch.Tensor, pair_index, rhs: torch.Tensor,
                          quorum: torch.Tensor, rcond: float | None = None):
    """Batched SPD solve ``G c = r`` from Gram entry planes.

    gram: (Kp, ...) unique Gram entries; pair_index: (k, k) host int array
    mapping (i, j) to a plane; rhs: (k, ...); quorum: (...) bool. Positions
    under quorum are solved against the identity (coef = rhs there). The
    unshifted factor is kept wherever it is finite, the factor of G shifted
    by 2k(k+1) eps tr(G) elsewhere; one step of refinement with a
    compensated (TwoProd/TwoSum) residual follows. With ``rcond``, positions
    whose Cholesky diagonal collapses below ``sqrt(rcond) * max|diag|`` (or
    is not finite) are identity-substituted too and reported not ok.

    Returns ``(coef, ok)``: (k, ...) and (...) bool.
    """
    pi = np.asarray(pair_index)
    k = pi.shape[0]
    dtype = gram.dtype
    one = torch.ones((), dtype=dtype, device=gram.device)
    zero = torch.zeros((), dtype=dtype, device=gram.device)

    def g(i, j):
        return torch.where(quorum, gram[int(pi[i, j])],
                           one if i == j else zero)

    eps = float(torch.finfo(dtype).eps)
    tr = gram[int(pi[0, 0])]
    for j in range(1, k):
        tr = tr + gram[int(pi[j, j])]
    shift = torch.where(quorum, (2.0 * k * (k + 1) * eps) * tr.abs(), zero)

    def factor(use_shift):
        L = [[None] * k for _ in range(k)]
        dinv = [None] * k
        for j in range(k):
            s = g(j, j) + shift if use_shift else g(j, j)
            for p in range(j):
                s = s - L[j][p] * L[j][p]
            L[j][j] = torch.sqrt(s)
            dinv[j] = one / L[j][j]
            for i in range(j + 1, k):
                s = g(i, j)
                for p in range(j):
                    s = s - L[i][p] * L[j][p]
                L[i][j] = s * dinv[j]
        return L, dinv

    L0, dinv0 = factor(False)
    L1, dinv1 = factor(True)
    finite0 = torch.isfinite(torch.stack(dinv0)).all(dim=0)
    L = [[None] * k for _ in range(k)]
    dinv = [None] * k
    for j in range(k):
        dinv[j] = torch.where(finite0, dinv0[j], dinv1[j])
        for i in range(j, k):
            L[i][j] = torch.where(finite0, L0[i][j], L1[i][j])

    if rcond is not None:
        ok = _identifiable(torch.stack([L[j][j] for j in range(k)]), quorum,
                           rcond)
        for j in range(k):
            for i in range(j + 1, k):
                L[i][j] = torch.where(ok, L[i][j], zero)
            dinv[j] = torch.where(ok, dinv[j], one)
    else:
        ok = quorum

    def solve(r):
        # forward substitution L z = r, then back substitution L^T c = z
        z = [None] * k
        for i in range(k):
            s = r[i]
            for j in range(i):
                s = s - L[i][j] * z[j]
            z[i] = s * dinv[i]
        c = [None] * k
        for i in reversed(range(k)):
            s = z[i]
            for j in range(i + 1, k):
                s = s - L[j][i] * c[j]
            c[i] = s * dinv[i]
        return c

    c = solve(rhs)
    split_c = _split_const(dtype)
    res = []
    for i in range(k):
        s, comp = rhs[i], zero
        for j in range(k):
            p, pe = _two_prod(g(i, j), -c[j], split_c)
            s, se = _two_sum(s, p)
            comp = comp + (pe + se)
        res.append(s + comp)
    dc = solve(res)
    return torch.stack([ci + di for ci, di in zip(c, dc)]), ok


def correlate_valid_dd(x: torch.Tensor, w64) -> tuple[torch.Tensor,
                                                       torch.Tensor]:
    """K-stencil VALID correlation with double-word accumulation.

    ``x``: (..., Npad) data; ``w64``: host (K, ws) float64 stencils, split
    tap-wise into (hi, lo) pairs of ``x``'s dtype. Returns ``(hi, lo)``,
    each (K, ..., Npad - ws + 1).
    """
    w64 = np.asarray(w64, dtype=np.float64)
    K, ws = w64.shape
    np_work = np.float64 if x.dtype == torch.float64 else np.float32
    w_hi = w64.astype(np_work)
    w_lo = (w64 - w_hi).astype(np_work)
    c = _split_const(x.dtype)
    n_out = x.shape[-1] - ws + 1

    def const(v):
        return torch.full((), float(v), dtype=x.dtype, device=x.device)

    his, los = [], []
    for k in range(K):
        acc = None
        for t in range(ws):
            if w_hi[k, t] == 0.0 and w_lo[k, t] == 0.0:
                continue
            xt = x[..., t:t + n_out]
            p, e = _two_prod(const(w_hi[k, t]), xt, c)
            e = e + const(w_lo[k, t]) * xt
            acc = (p, e) if acc is None else _dd_add(acc, (p, e))
        if acc is None:
            z = torch.zeros(x.shape[:-1] + (n_out,), dtype=x.dtype,
                            device=x.device)
            acc = (z, z)
        his.append(acc[0])
        los.append(acc[1])
    return torch.stack(his), torch.stack(los)


def cholesky_solve_planes_dd(gram_hi, gram_lo, pair_index, rhs_hi, rhs_lo,
                             quorum, rcond: float | None = None):
    """Double-word plane Cholesky ``G c = r`` from (hi, lo) Gram and rhs
    planes: the factorization and both substitutions in double-word
    arithmetic, a single unshifted factor, ``ok`` = quorate with a finite
    diagonal (and identifiable, with ``rcond``). Returns ``(coef, ok)``
    with coef = hi + lo in working precision."""
    pi = np.asarray(pair_index)
    k = pi.shape[0]
    dtype = gram_hi.dtype
    c = _split_const(dtype)
    one = torch.ones((), dtype=dtype, device=gram_hi.device)
    zero = torch.zeros((), dtype=dtype, device=gram_hi.device)

    def g(i, j):
        hi = torch.where(quorum, gram_hi[int(pi[i, j])],
                         one if i == j else zero)
        lo = torch.where(quorum, gram_lo[int(pi[i, j])], zero)
        return hi, lo

    L = [[None] * k for _ in range(k)]
    dinv = [None] * k
    for j in range(k):
        s = g(j, j)
        for p in range(j):
            s = _dd_sub(s, _dd_mul(L[j][p], L[j][p], c))
        L[j][j] = _dd_sqrt(s, c)
        dinv[j] = _dd_div((one, zero), L[j][j], c)
        for i in range(j + 1, k):
            s = g(i, j)
            for p in range(j):
                s = _dd_sub(s, _dd_mul(L[i][p], L[j][p], c))
            L[i][j] = _dd_mul(s, dinv[j], c)

    diag = torch.stack([L[j][j][0] for j in range(k)])
    if rcond is not None:
        ok = _identifiable(diag, quorum, rcond)
    else:
        ok = quorum & torch.isfinite(diag).all(dim=0)
    for j in range(k):
        for i in range(j + 1, k):
            L[i][j] = tuple(torch.where(ok, w, zero) for w in L[i][j])
        dinv[j] = (torch.where(ok, dinv[j][0], one),
                   torch.where(ok, dinv[j][1], zero))

    z = [None] * k
    for i in range(k):
        s = (rhs_hi[i], rhs_lo[i])
        for j in range(i):
            s = _dd_sub(s, _dd_mul(L[i][j], z[j], c))
        z[i] = _dd_mul(s, dinv[i], c)
    co = [None] * k
    for i in reversed(range(k)):
        s = z[i]
        for j in range(i + 1, k):
            s = _dd_sub(s, _dd_mul(L[j][i], co[j], c))
        co[i] = _dd_mul(s, dinv[i], c)
    return torch.stack([ci[0] + ci[1] for ci in co]), ok
