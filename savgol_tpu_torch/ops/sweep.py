"""(n, m) parameter sweeps: every configuration over one read of the data
(counterpart of ``savgol_tpu.ops.sweep``).

:func:`savgol_weights_masked` generates the weights of a whole tensor of
configurations at once on the device, padded to the reference's limits
(window 65, order 10, savgolFilter.h:38-48), with invalid lanes zeroed.
:func:`savgol_apply_sweep` then runs the centred stencils of all C
configurations as ONE K-stencil bank pass over the input padded by 32
(kernel K4 on a CUDA tensor: one read of the data, no padded copy) and fits
the POLYNOMIAL edges with small batched ops on the first and last 32
outputs. PyTorch traces nothing, so the JAX package's traced and
specialised routes are one route here: the configurations are read as
Python ints and their weights cached per tuple.

Masking invariants (why no NaNs escape):

  * the Gram recurrence divides by k(2n-k+1), which is positive for every
    k <= m < 2n+1 (valid configs); rows k > m are force-zeroed each
    iteration so NaN/Inf from invalid denominators never propagates;
  * weights outside the true window |i| > n are zeroed, so the fixed
    65-tap correlation over a 32-padded input computes exactly the
    2n+1-tap result;
  * boundary pad values for symmetric/edge/wrap do not depend on the pad
    width, so padding by 32 instead of n is semantics-preserving.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from savgol_tpu_torch._device import card_unless_named
from savgol_tpu_torch.config import (MAX_HALF_WINDOW, MAX_POLY_ORDER,
                                     PAD_MODE, BoundaryMode)
from savgol_tpu_torch.ops.apply import _compute_dtype, correlate_bank
from savgol_tpu_torch.ops.cuda_conv import scale_of

__all__ = ["savgol_weights_masked", "savgol_apply_sweep"]

_M = MAX_HALF_WINDOW           # 32
_K = MAX_POLY_ORDER            # 10
_W = 2 * _M + 1                # 65

_METHODS = ("auto", "xla", "pallas", "mxu", "mxu_bank")


def _genfact_ratio(two_n: torch.Tensor, k: int) -> torch.Tensor:
    """(2k+1) * GenFact(2n, k) / GenFact(2n+k+1, k+1) for a tensor of 2n
    and a static k — the normalization of src/savgolFilter.c:343-346."""
    num = torch.ones_like(two_n)
    for j in range(k):                      # GenFact(2n, k)
        num = num * (two_n - j)
    den = torch.ones_like(two_n)
    for j in range(k + 1):                  # GenFact(2n+k+1, k+1)
        den = den * (two_n + k + 1 - j)
    return (2 * k + 1) * num / den


def _gram_masked(points: torch.Tensor, n: torch.Tensor, m: torch.Tensor,
                 dmax: int, dtype) -> torch.Tensor:
    """Gram table F_k^{(d)}(points) for every configuration of the (C,)
    tensors n, m; rows k > m zeroed. Returns (K+1, C, dmax+1, P).

    The recurrence runs over whole (C, dmax+1, P) blocks: the d*F^{(d-1)}
    term is a one-row shift along the derivative axis times d."""
    i = points.to(dtype)[None, None, :]                  # (1, 1, P)
    nf = n.to(dtype)[:, None, None]                      # (C, 1, 1)
    mc = m[:, None, None]
    C, P, D = n.shape[0], points.shape[0], dmax + 1
    dvec = torch.arange(D, dtype=dtype, device=points.device)[None, :, None]
    zero = torch.zeros((), dtype=dtype, device=points.device)

    def dshift(r):
        # rows shifted down one derivative order: [0; r[0]; ...; r[D-2]]
        return torch.cat([torch.zeros_like(r[:, :1]), r[:, :-1]], dim=1)

    row0 = torch.zeros((C, D, P), dtype=dtype, device=points.device)
    row0[:, 0] = 1.0
    rows = [row0]
    inv_n = 1.0 / nf
    r1 = inv_n * (i * row0 + dvec * dshift(row0))
    rows.append(torch.where(1 <= mc, r1, zero))
    for k in range(2, _K + 1):
        denom = k * (2.0 * nf - k + 1.0)
        denom = torch.where(denom != 0, denom, 1.0)   # guard invalid k > m
        alpha = (4.0 * k - 2.0) / denom
        gamma = ((k - 1.0) * (2.0 * nf + k)) / denom
        prev1, prev2 = rows[k - 1], rows[k - 2]
        curr = alpha * (i * prev1 + dvec * dshift(prev1)) - gamma * prev2
        rows.append(torch.where(k <= mc, curr, zero))
    return torch.stack(rows)                             # (K+1, C, D, P)


def savgol_weights_masked(n, m, derivative: int = 0, dtype=torch.float32, *,
                          device=None):
    """Weights of the configurations (n, m) (ints, or equal-length integer
    tensors / sequences for a whole sweep): center (65,), lead (32, 65),
    trail (32, 65) each, padded and masked, with a leading (C,) axis for a
    sequence. Computed in ``dtype`` on ``device``: by default the device of
    ``n`` or ``m`` where either is a tensor, else the card (raising without
    one; pass ``device="cpu"`` to compute on the CPU).

    * ``center[_M + i]`` weights x[j+i] for |i| <= n, zero outside.
    * ``trail[e]`` is the reference edge row (target t = n - e,
      src/savgolFilter.c:401) over window coords [_M + i]; rows e >= n
      are zero.
    * ``lead[e]`` evaluates at target t = e - n (the *correct-sign* leading
      edge; see ``savgol_tpu_torch.ops.apply`` on the reference's
      odd-derivative sign flip).
    """
    if device is None:
        held = [v.device for v in (n, m) if isinstance(v, torch.Tensor)]
        device = held[0] if held else card_unless_named(
            None, "savgol_weights_masked")
    n = torch.as_tensor(n, device=device)
    m = torch.as_tensor(m, device=device)
    scalar = n.dim() == 0
    n, m = n.reshape(-1).long(), m.reshape(-1).long()
    device = n.device
    d = int(derivative)
    pts = torch.arange(-_M, _M + 1, dtype=dtype, device=device)
    G = _gram_masked(pts, n, m, d, dtype)                # (K+1, C, d+1, 65)

    two_n = (2 * n).to(dtype)
    zero = torch.zeros((), dtype=dtype, device=device)
    factors = torch.stack(
        [torch.where(k <= m, _genfact_ratio(two_n, k), zero)
         for k in range(_K + 1)])                        # (K+1, C)

    basis = G[:, :, 0, :]                         # F_k^{(0)}(i), (K+1, C, 65)
    offs = torch.arange(-_M, _M + 1, device=device)
    win_mask = (offs.abs()[None, :] <= n[:, None]).to(dtype)    # (C, 65)

    # -- center: target t = 0 (table column _M); sums as products, no
    # matmul, so TF32 cannot enter on the card --
    center = ((factors * G[:, :, d, _M])[..., None] * basis).sum(0) \
        * win_mask

    # -- edge rows: the table at the targets of each row --
    e = torch.arange(_M, device=device)
    Gd = G[:, :, d, :]                                   # (K+1, C, 65)

    def rows_at(cols):
        g = Gd.gather(2, cols.clamp(0, _W - 1).expand(_K + 1, -1, -1))
        return ((factors[:, :, None] * g)[..., None]
                * basis[:, :, None, :]).sum(0)          # (C, 32, 65)
    row_mask = (e[None, :] < n[:, None]).to(dtype)[..., None]
    trail = rows_at(_M + n[:, None] - e) * win_mask[:, None] * row_mask
    lead = rows_at(_M + e - n[:, None]) * win_mask[:, None] * row_mask
    if scalar:
        return center[0], lead[0], trail[0]
    return center, lead, trail


@functools.lru_cache(maxsize=128)
def _edge_plan(half_windows: tuple, M: int, length: int, device):
    """Where each entry of :func:`edge_blocks`' two blocks, stacked as (C,
    2 wp, L), comes from, for concrete half windows: the row of the table
    [lead rows 0..M-1; trail rows 0..M-1; centred stencil] (expanded to
    (C, 2 wp, W) for a gather), the tap of that row, and whether the tap
    lies inside the row. Built on the host once, so a call pays no index
    arithmetic."""
    W, N = 2 * M + 1, length
    wp, L = min(N, M), min(N, W)
    n = torch.tensor(half_windows)[:, None]                       # (C, 1)
    p = torch.cat([torch.arange(wp), torch.arange(N - wp, N)])[None, :]
    lo = torch.cat([torch.zeros(wp, dtype=torch.long),
                    torch.full((wp,), N - L)])[None, :]        # x[lo:lo+L]
    is_lead, is_trail = p < n, p >= N - n                         # (C, 2wp)
    row = torch.where(is_lead, p.clamp(max=M - 1),
                      torch.where(is_trail, M + (N - 1 - p).clamp(0, M - 1),
                                  2 * M))
    x0 = torch.where(is_lead, n - M,                 # x index of tap 0
                     torch.where(is_trail, N - 1 - n - M, p - M))
    tap = lo[..., None] + torch.arange(L) - x0[..., None]         # (C, 2wp, L)
    inside = (tap >= 0) & (tap < W)
    return (row[..., None].expand(-1, -1, W).to(device),
            tap.clamp(0, W - 1).to(device), inside.to(device))


def edge_blocks(center: torch.Tensor, lead: torch.Tensor,
                trail: torch.Tensor, half_windows: tuple, length: int,
                dt: torch.Tensor = None, lead_sign: torch.Tensor = None):
    """The POLYNOMIAL edge fit after a same-length bank pass, as two weight
    blocks (C, wp, L): the head gives outputs [0, wp) from x[..., :L], the
    tail outputs [N - wp, N) from x[..., N - L:], wp = min(N, M), L =
    min(N, W), N = ``length``.

    ``center`` (C, W), ``lead`` and ``trail`` (C, M, W) are in window
    coordinates, W = 2M + 1: tap M + i weights x[p + i], zero outside the
    config's window |i| <= n_c (``half_windows``, C ints). ``lead[c, e]``
    gives output p = e, ``trail[c, e]`` output p = N - 1 - e. Each row is
    the config's lead row (p < n_c), trail row (p >= N - n_c) or its
    centred stencil moved to p, with ``dt`` (C,) folded into every row and
    ``lead_sign`` (C,) into the lead rows. Short rows, whose blocks overlap,
    get the same values from both; rows of W samples or more all get the
    blocks of 2W, where the two cannot meet. The third value, ``reach``
    (C, 2 wp, L) booleans, marks the samples inside each row's window of W
    taps (head rows, then tail rows). :func:`fit_edges` applies them."""
    C, M, W = lead.shape
    if length >= W:
        length = 2 * W
    row, tap, inside = _edge_plan(tuple(half_windows), M, length,
                                  center.device)
    if lead_sign is not None:
        lead = lead * lead_sign.reshape(C, 1, 1)
    table = torch.cat([lead, trail, center[:, None]], dim=1)   # (C, 2M+1, W)
    blocks = table.gather(1, row).gather(2, tap) * inside
    if dt is not None:
        blocks = blocks * dt.reshape(C, 1, 1)
    wp = row.shape[1] // 2
    return blocks[:, :wp], blocks[:, wp:], inside


def fit_edges(y: torch.Tensor, x: torch.Tensor, head: torch.Tensor,
              tail: torch.Tensor, reach: torch.Tensor) -> torch.Tensor:
    """Overwrite the edge outputs of a bank result ``y`` (C, ..., N) with
    :func:`edge_blocks`' fit of ``x`` (..., N): two product-sums over each
    row's ``reach`` and two slice copies. A sample outside a row's window
    adds nothing, not even its product with a zero tap, so a NaN or inf
    spreads to the outputs whose W-tap window holds it, as the bank pass
    and the JAX package spread it."""
    C, wp, L = head.shape
    N = x.shape[-1]
    shape = (C,) + (1,) * (x.dim() - 1) + (wp, L)

    def fit(block, inside, win):
        prod = win.unsqueeze(-2) * block.reshape(shape)
        return torch.where(inside.reshape(shape), prod, 0).sum(-1)

    y[..., :wp] = fit(head, reach[:, :wp], x[..., :L])
    y[..., N - wp:] = fit(tail, reach[:, wp:], x[..., N - L:])
    return y


@functools.lru_cache(maxsize=128)
def _sweep_weights_cached(hw_key: tuple, po_key: tuple, derivative: int,
                          dtype, device, length: int, dt_inv,
                          flip_lead: bool):
    """The weights of a CONCRETE config tuple, generated on the device
    once: the centred stencils (C, 65) and :func:`edge_blocks`' blocks
    for rows of ``length`` samples (any length >= 65 gives the same
    blocks), the number ``dt_inv`` folded in (:func:`scale_of`) and the
    lead rows negated under ``flip_lead``."""
    center, lead, trail = savgol_weights_masked(hw_key, po_key, derivative,
                                                dtype, device=device)
    C = len(hw_key)
    dt = scale_of(dt_inv, center, dtype)
    if dt is not None:
        dt = dt.expand(C)
    sign = (torch.full((C,), -1.0, dtype=dtype, device=device) if flip_lead
            else None)
    head, tail, reach = edge_blocks(center, lead, trail, hw_key, length,
                                    dt, sign)
    if dt is not None:
        center = center * dt[:, None]
    return center, head, tail, reach


def _configs(v) -> tuple:
    if isinstance(v, torch.Tensor):
        return tuple(int(a) for a in v.reshape(-1).tolist())
    return tuple(int(a) for a in np.asarray(v).reshape(-1))


def savgol_apply_sweep(
    x: torch.Tensor,
    half_windows,
    poly_orders,
    *,
    derivative: int = 0,
    boundary: BoundaryMode = BoundaryMode.POLYNOMIAL,
    dt_inv=1.0,
    dtype=torch.float32,
    method: str = "auto",
    reference_edge_sign: bool = False,
) -> torch.Tensor:
    """Filter ``x`` (..., N) under EVERY config (half_windows[c],
    poly_orders[c]); returns (C, ..., N).

    The weights of the sweep are generated on ``x``'s device in ``dtype``
    once per config tuple (:func:`savgol_weights_masked`). ``method``:
    "auto" runs the center pass on kernel K4 for a CUDA tensor and its
    plain version for a CPU tensor; "pallas", "mxu" and "mxu_bank" (the
    JAX package's TPU engines, one Hopper kernel here) ask for K4 and need a
    CUDA tensor; "xla" is the plain version. The leading edge defaults to
    the correct-sign convention; ``reference_edge_sign=True`` reproduces
    the C's reversed-data flip (src/savgolFilter.c:773-777).

    The data must cover every window: ``N >= 2*max(half_windows) + 1``.
    """
    if method not in _METHODS:
        raise ValueError(
            f"method must be 'auto', 'xla', 'pallas', 'mxu' or "
            f"'mxu_bank', got {method!r}")
    if method not in ("auto", "xla") and x.device.type != "cuda":
        raise ValueError(
            f"method={method!r} runs the CUDA kernel and needs a CUDA "
            f"tensor, got one on {x.device}")
    if not isinstance(boundary, BoundaryMode):
        boundary = BoundaryMode(boundary)
    hw, po = _configs(half_windows), _configs(poly_orders)
    if not hw or len(hw) != len(po):
        raise ValueError(f"need one poly_order a half_window, got {len(hw)} "
                         f"half windows and {len(po)} orders")
    for n, m in zip(hw, po):
        if not 1 <= n <= _M or not 0 <= m <= min(2 * n, _K):
            raise ValueError(f"invalid sweep config (n={n}, m={m}): need "
                             f"1 <= n <= {_M}, 0 <= m <= min(2n, {_K})")
    if not (x.is_floating_point() or x.is_complex()):
        # promote int/bool input to the sweep's working dtype (casting the
        # float weights DOWN to an int dtype would truncate them to zero)
        x = x.to(dtype)
    N = x.shape[-1]
    max_n = max(hw)
    if N < 2 * max_n + 1:
        raise ValueError(
            f"data length ({N}) must be >= the widest window "
            f"(2*{max_n}+1 = {2 * max_n + 1})")
    x, restore = _compute_dtype(x)
    d = int(derivative)
    # a number is folded into the cached weights; a tensor dt_inv
    # multiplies them a call, so that it stays differentiable
    number = not isinstance(dt_inv, torch.Tensor)
    center, head, tail, reach = _sweep_weights_cached(
        hw, po, d, dtype, x.device, min(N, _W),
        float(dt_inv) if number else 1.0,
        reference_edge_sign and d % 2 == 1)
    center, head, tail = (a.to(x.dtype) for a in (center, head, tail))
    s = None if number else scale_of(dt_inv, x)
    if s is not None:
        center, head, tail = (a * s for a in (center, head, tail))
    kernel = method != "xla"
    if boundary is not BoundaryMode.POLYNOMIAL:
        y = correlate_bank(x, center, _M, PAD_MODE[boundary], kernel=kernel)
        return y.to(restore) if restore is not None else y
    y = correlate_bank(x, center, _M, kernel=kernel)
    # the POLYNOMIAL edges (the batched edge fix of savgol_tpu.ops.sweep)
    y = fit_edges(y, x, head, tail, reach)
    return y.to(restore) if restore is not None else y
