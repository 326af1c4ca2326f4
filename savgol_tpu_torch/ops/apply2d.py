"""2D Savitzky-Golay application on tensors (counterpart of
``savgol_tpu.ops.apply2d``).

Semantics match the JAX package exactly (reference src/savgol2d.c:356-456):

  * VALID: output shrinks by 2*half_window in each dimension;
  * CONSTANT: out-of-range taps clamp to the nearest edge pixel (numpy pad
    mode 'edge'); REFLECT: mirrored with the edge pixel duplicated
    ('symmetric'); PERIODIC: wrap-around ('wrap');
  * outputs scaled by 1 / (delta_x**dx * delta_y**dy), folded into the
    (tiny) stencil on the device before the correlation.

The gradient / Hessian / Laplacian conveniences stack their derivative
stencils and run them as one correlation (reference src/savgol2d.c:462-618).

``method`` keeps the JAX package's values. "auto": the CUDA kernels for a
CUDA tensor, their plain PyTorch versions for a CPU tensor. "xla": the
plain version (dense). "pallas": the kernels, which need a CUDA tensor.
"sep": the separable kernel K2D-sep. "bf16": the throughput mode, K2D-dense
in its bf16 mode for every stencil it takes, sides up to 33 (its bf16
plain version for a CPU tensor): image and stencil rounded to bf16, f32 sums; f32 input gets the
f32 sums unrounded, other dtypes (a bf16 image, read as it is) the sums
rounded to bf16; ``scale`` (scales) multiplied after, in the output's
dtype, not folded into the stencil; a stack reads the image once for all
its stencils; within the documented ~5e-3 relative contract. Under "auto"
and "pallas" a stencil wider than 17 taps takes K2D-sep (r * (H + W) taps
instead of H * W), every other K2D-dense; a stack goes to K2D-dense in one
launch that reads the image once. K2D-sep takes a stencil's rank factors,
found by an SVD in f64 on the host once per stencil tensor (see
``_factors``); the derivative conveniences keep their stencils on the
device between calls.

Gradients: the kernels run forward inside ``torch.autograd.Function``s
whose backward is autograd through the plain version, as the JAX package's
custom VJPs take the VJP of their XLA twins. K2D-dense is differentiable in
the image and the stencils, K2D-sep in the image only: a stencil that
requires a gradient is routed to K2D-dense, as the JAX package routes a
traced stencil away from its separable kernel.
"""

from __future__ import annotations

import functools
import weakref
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from savgol_tpu_torch.config import Boundary2D, Savgol2DConfig
from savgol_tpu_torch.ops.apply import (_check_device, _complex_split,
                                        _compute_dtype, _exact_twin,
                                        _grads_through)
from savgol_tpu_torch.ops.cuda_conv import scalar_like
from savgol_tpu_torch.ops.cuda_conv2d import (_svd_stencil_np,
                                              correlate2d_sep_cuda,
                                              correlate2d_sep_plain,
                                              correlate2d_valid_bf16_cuda,
                                              correlate2d_valid_cuda,
                                              correlate2d_valid_plain)
from savgol_tpu_torch.ops.weights import savgol2d_weights_np

__all__ = [
    "correlate2d_valid",
    "savgol2d_apply",
    "savgol2d_apply_stack",
    "savgol2d_gradient",
    "savgol2d_hessian",
    "savgol2d_laplacian",
]

_PAD_MODE_2D = {
    Boundary2D.CONSTANT: "edge",
    Boundary2D.REFLECT: "symmetric",
    Boundary2D.PERIODIC: "wrap",
}

_METHODS = ("auto", "xla", "pallas", "sep", "bf16")

# Stencils wider than this take the separable kernel under "auto"/"pallas":
# the JAX package's rule (pallas_conv.py:1401-1406, 1443-1448), which is
# about arithmetic (r * (H + W) taps instead of H * W), not the TPU's VMEM.
_SEP_MIN_TAPS = 17


def correlate2d_valid(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Valid 2D cross-correlation over the last two axes, in plain PyTorch.

    ``x``: (..., R, C); ``w``: (K, H, W) stack of stencils or (H, W) single.
    Output: (..., K, R-H+1, C-W+1) (or without K for a 2D ``w``).
    """
    if not (x.is_floating_point() or x.is_complex()):
        x = x.to(w.dtype)
    return correlate2d_valid_plain(x, w)


def _resolve_method2d(method: str, x: torch.Tensor) -> str:
    """'auto' -> 'pallas' (the kernel wrappers, which take their plain
    versions for a CPU tensor; so does 'bf16'); raises for unknown methods
    and for 'pallas' on a tensor that is not on the card."""
    if method not in _METHODS:
        raise ValueError(
            f"method must be 'auto', 'xla', 'pallas', 'sep' or 'bf16', "
            f"got {method!r}")
    if method == "pallas" and x.device.type != "cuda":
        raise ValueError(
            f"method='pallas' runs the CUDA kernel and needs a CUDA tensor, "
            f"got one on {x.device}")
    return "pallas" if method == "auto" else method


def _promote(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Integer/bool images compute in result_type(weights, float32): the
    kernels cast the stencil to the image's dtype, and a fractional stencil
    cast to an integer dtype would truncate to zero."""
    if not (x.is_floating_point() or x.is_complex()):
        return x.to(torch.promote_types(w.dtype, torch.float32))
    return x


def _scale_tensor(scale, x: torch.Tensor) -> Optional[torch.Tensor]:
    """``scale`` as a 0-dim tensor of ``x``'s dtype and device, or None for
    a Python scale of exactly 1.0. A tensor scale is never read on the host
    (that would synchronise the stream)."""
    if not isinstance(scale, torch.Tensor) and float(scale) == 1.0:
        return None
    return scalar_like(scale, x)


class _Corr2dFn(torch.autograd.Function):
    """Dense 2D correlation (kernel K2D-dense on CUDA, in its bf16 mode for
    ``bf16``) whose backward is autograd through the exact
    ``correlate2d_valid_plain`` — the counterpart of the JAX package's
    ``_pallas_rowmxu_same_exact_diff`` / ``_pallas_rowmxu_exact_diff`` /
    ``_pallas_corr2d_diff`` and, for ``bf16``,
    ``_pallas_rowmxu_bf16_diff`` / ``_pallas_rowmxu_same_bf16_diff`` /
    ``_pallas_rowmxu_stack_bf16_diff``."""

    @staticmethod
    def forward(ctx, x, w, pad_mode, bf16: bool = False):
        ctx.save_for_backward(x, w)
        ctx.pad_mode = pad_mode
        fn = correlate2d_valid_bf16_cuda if bf16 else correlate2d_valid_cuda
        return fn(x, w, pad_mode)

    @staticmethod
    def backward(ctx, g):
        def plain(x, w):
            return _exact_twin(correlate2d_valid_plain, x, w, ctx.pad_mode)
        grads = _grads_through(plain, ctx.saved_tensors,
                               ctx.needs_input_grad[:2], g)
        return (*grads, None, None)


class _CorrSepFn(torch.autograd.Function):
    """Separable 2D correlation (kernel K2D-sep on CUDA), differentiable in
    the image only — the counterpart of ``_pallas_sep_diff``."""

    @staticmethod
    def forward(ctx, x, u, v, pad_mode):
        ctx.save_for_backward(x, u, v)
        ctx.pad_mode = pad_mode
        return correlate2d_sep_cuda(x, u, v, pad_mode)

    @staticmethod
    def backward(ctx, g):
        def plain(x, u, v):
            return correlate2d_sep_plain(x, u, v, ctx.pad_mode)
        gx = _grads_through(plain, ctx.saved_tensors,
                            (ctx.needs_input_grad[0], False, False), g)[0]
        return gx, None, None, None


def _rank_rtol(*dtypes) -> float:
    """The share of a stencil's largest singular value below which the
    others are rounding noise: 4 ulps of the coarsest float dtype the
    stencil passed through, never below the JAX package's 1e-9. A float32
    Savitzky-Golay stencil factored at 1e-9 keeps its rounding noise as
    rank (6 to 13 instead of 2 at 11x11 to 33x33); over every window up to
    33x33 and order 6 that noise stays below 3.1e-8, and the structural
    singular values above 0.069, of the largest."""
    eps = max(torch.finfo(d).eps for d in dtypes if d.is_floating_point)
    return max(1e-9, 4 * eps)


# Rank factors of the stencils that took K2D-sep:
# (id(stencil), dtype, device) -> (weak reference, in-place version, factors).
# An entry goes when its stencil tensor does.
_FACTORS: dict = {}


def _factors(w: torch.Tensor, dtype, device) -> list:
    """[(u, v)] for each stencil of ``w`` (H, W) or (K, H, W), in ``dtype``
    on ``device``. Factored in f64 on the host the first time a stencil
    tensor takes the separable route, and again only after it changes in
    place: a CUDA stencil's copy to the host synchronises the stream, so a
    module or a derivative stack that calls again with the same tensor
    pays for it once. An inference tensor keeps no version counter, so an
    in-place change to one inside ``torch.inference_mode`` goes unseen."""
    key = (id(w), dtype, device)
    version = None if w.is_inference() else w._version
    hit = _FACTORS.get(key)
    if hit is not None and hit[0]() is w and hit[1] == version:
        return hit[2]
    rtol = _rank_rtol(w.dtype, dtype)
    w_host = w.detach().to("cpu", torch.float64).numpy()
    factors = [tuple(torch.as_tensor(f, dtype=dtype, device=device)
                     for f in _svd_stencil_np(wk, rtol))
               for wk in (w_host if w.dim() == 3 else w_host[None])]
    ref = weakref.ref(w, lambda _, k=key: _FACTORS.pop(k, None))
    _FACTORS[key] = (ref, version, factors)
    return factors


def _sep(x: torch.Tensor, w: torch.Tensor, s: Optional[torch.Tensor],
         pad_mode) -> torch.Tensor:
    """K2D-sep over each stencil of ``w`` (H, W) or (K, H, W), each scaled
    by ``s`` (None, 0-dim or (K,)) through its first factor on the
    device."""
    def one(k, u, v):
        if s is not None:
            u = u * (s if s.dim() == 0 else s[k])
        return _CorrSepFn.apply(x, u, v, pad_mode)

    ys = [one(k, u, v)
          for k, (u, v) in enumerate(_factors(w, x.dtype, x.device))]
    return ys[0] if w.dim() == 2 else torch.stack(ys, dim=-3)


def _correlate(x: torch.Tensor, w: torch.Tensor, s: Optional[torch.Tensor],
               pad_mode, method: str) -> torch.Tensor:
    """The correlation route of a resolved ``method`` for the stencil(s)
    ``w`` scaled by ``s`` (None, 0-dim, or (K,) for a stack). The exact
    dense routes fold ``s`` into the (tiny) stencil on the device instead
    of paying a full output read + write; "bf16" multiplies after, as the
    JAX package's bf16 routes do (a bf16 stencil times a bf16 scale would
    round twice)."""
    if method == "bf16":
        y = _Corr2dFn.apply(x.contiguous(), w, pad_mode, True)
        if s is None:
            return y
        return y * (s[..., None, None] if s.dim() else s)
    needs_grad = torch.is_grad_enabled() and (
        w.requires_grad or (s is not None and s.requires_grad))
    if method != "xla" and not needs_grad and (
            method == "sep" or max(w.shape[-2:]) > _SEP_MIN_TAPS):
        return _sep(x.contiguous(), w, s, pad_mode)
    ws = w.to(x.dtype)
    if s is not None:
        ws = ws * s[..., None, None]
    if method == "xla":
        return correlate2d_valid_plain(x, ws, pad_mode)
    return _Corr2dFn.apply(x.contiguous(), ws, pad_mode)


def savgol2d_apply(
    x: torch.Tensor,
    weights: torch.Tensor,
    *,
    boundary: Boundary2D = Boundary2D.CONSTANT,
    scale: float | torch.Tensor = 1.0,
    method: str = "auto",
) -> torch.Tensor:
    """Apply a (H, W) 2D stencil over the last two axes of ``x``.

    VALID shrinks the output; CONSTANT/REFLECT/PERIODIC keep the input
    shape. Mirrors ``savgol2d_apply`` / ``savgol2d_apply_valid``
    (reference src/savgol2d.c:356-456). Differentiable in ``x``, the
    weights and a tensor ``scale``.
    """
    route = _resolve_method2d(method, x)
    if not isinstance(boundary, Boundary2D):
        boundary = Boundary2D(boundary)
    _check_device(x, weights)
    if x.is_complex():
        # real-linear filter: real/imag parts as one extra batch pair
        return _complex_split(
            lambda v: savgol2d_apply(v, weights, boundary=boundary,
                                     scale=scale, method=method), x)
    x, restore = _compute_dtype(_promote(x, weights), route == "bf16")
    pad_mode = (None if boundary is Boundary2D.VALID
                else _PAD_MODE_2D[boundary])
    y = _correlate(x, weights, _scale_tensor(scale, x), pad_mode, route)
    return y.to(restore) if restore is not None else y


def savgol2d_apply_stack(
    x: torch.Tensor,
    weight_stack: torch.Tensor,
    *,
    boundary: Boundary2D = Boundary2D.CONSTANT,
    scales: Optional[torch.Tensor] = None,
    method: str = "auto",
) -> torch.Tensor:
    """Apply K stencils (K, H, W) in one pass; output (..., K, R', C')."""
    route = _resolve_method2d(method, x)
    if not isinstance(boundary, Boundary2D):
        boundary = Boundary2D(boundary)
    _check_device(x, weight_stack)
    if x.is_complex():
        return _complex_split(
            lambda v: savgol2d_apply_stack(v, weight_stack,
                                           boundary=boundary, scales=scales,
                                           method=method), x)
    x, restore = _compute_dtype(_promote(x, weight_stack), route == "bf16")
    # the output's dtype, never an integer input's: fractional derivative
    # scales must not truncate
    s = (None if scales is None
         else torch.as_tensor(scales, dtype=x.dtype, device=x.device))
    pad_mode = (None if boundary is Boundary2D.VALID
                else _PAD_MODE_2D[boundary])
    y = _correlate(x, weight_stack, s, pad_mode, route)
    return y.to(restore) if restore is not None else y


def _stencil_stack(half_window_x: int, half_window_y: int, poly_order: int,
                   derivs: Sequence[Tuple[int, int]],
                   delta_x: float, delta_y: float, dtype=np.float64):
    """Build a (K, H, W) stack of derivative stencils + their 1/dt scales."""
    ws, scales = [], []
    for dx, dy in derivs:
        cfg = Savgol2DConfig(half_window_x, half_window_y, poly_order,
                             deriv_x=dx, deriv_y=dy,
                             delta_x=delta_x, delta_y=delta_y)
        ws.append(savgol2d_weights_np(cfg, dtype=dtype))
        scales.append(cfg.scale)
    return np.stack(ws), np.asarray(scales, dtype=dtype)


@functools.lru_cache(maxsize=64)
def _device_stencils(half_window_x, half_window_y, poly_order, derivs,
                     delta_x, delta_y, device, fuse):
    """The f64 stencil stack of ``derivs`` and its scales on ``device``, or
    with ``fuse`` their scaled sum as one stencil and None. Built and
    uploaded once per geometry and device, so a repeated call neither
    rebuilds nor copies them, and keeps the same stencil tensor, whose
    separable factors stay cached (``_factors``)."""
    W, s = _stencil_stack(half_window_x, half_window_y, poly_order, derivs,
                          delta_x, delta_y)
    if fuse:
        return torch.as_tensor((W * s[:, None, None]).sum(0),
                               device=device), None
    return (torch.as_tensor(W, device=device),
            torch.as_tensor(s, device=device))


def _apply_stencil_stack(x, derivs, half_window_x, half_window_y,
                         poly_order, delta_x, delta_y, boundary, method):
    W, s = _device_stencils(half_window_x, half_window_y, poly_order,
                            tuple(derivs), delta_x, delta_y, x.device, False)
    y = savgol2d_apply_stack(x, W, boundary=boundary, scales=s,
                             method=method)
    return tuple(y[..., k, :, :] for k in range(len(derivs)))


def savgol2d_gradient(
    x: torch.Tensor, half_window_x: int, half_window_y: int,
    poly_order: int, *, delta_x: float = 1.0, delta_y: float = 1.0,
    boundary: Boundary2D = Boundary2D.CONSTANT,
    method: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dI/dx, dI/dy) via one stacked pass (ref: src/savgol2d.c:462-499)."""
    return _apply_stencil_stack(x, [(1, 0), (0, 1)], half_window_x,
                                half_window_y, poly_order, delta_x, delta_y,
                                boundary, method)


def savgol2d_hessian(
    x: torch.Tensor, half_window_x: int, half_window_y: int,
    poly_order: int, *, delta_x: float = 1.0, delta_y: float = 1.0,
    boundary: Boundary2D = Boundary2D.CONSTANT,
    method: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(d2I/dx2, d2I/dxdy, d2I/dy2); requires poly_order >= 2
    (ref: src/savgol2d.c:501-558)."""
    if poly_order < 2:
        raise ValueError("hessian requires poly_order >= 2")
    return _apply_stencil_stack(x, [(2, 0), (1, 1), (0, 2)], half_window_x,
                                half_window_y, poly_order, delta_x, delta_y,
                                boundary, method)


def savgol2d_laplacian(
    x: torch.Tensor, half_window_x: int, half_window_y: int,
    poly_order: int, *, delta_x: float = 1.0, delta_y: float = 1.0,
    boundary: Boundary2D = Boundary2D.CONSTANT,
    method: str = "auto",
) -> torch.Tensor:
    """Laplacian d2I/dx2 + d2I/dy2; both stencils share the window, so the
    sum is folded into ONE stencil on the host in f64 — one pass instead of
    the reference's two applies + elementwise add (src/savgol2d.c:560-618)."""
    if poly_order < 2:
        raise ValueError("laplacian requires poly_order >= 2")
    fused, _ = _device_stencils(half_window_x, half_window_y, poly_order,
                                ((2, 0), (0, 2)), delta_x, delta_y, x.device,
                                True)
    return savgol2d_apply(x, fused, boundary=boundary, method=method)
