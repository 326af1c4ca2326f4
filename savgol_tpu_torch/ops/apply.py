"""1D Savitzky-Golay application on tensors (counterpart of
``savgol_tpu.ops.apply``).

Semantics match the JAX package exactly (region layout of the reference,
src/savgolFilter.c:743-804):

  * center region (output j in [n, N-n)): correlation with the centered
    stencil;
  * POLYNOMIAL boundary: the n leading outputs come from the edge-weight
    matrix applied to the *reversed* first window, the n trailing outputs
    from the same rows applied forward to the last window;
  * REFLECT / PERIODIC / CONSTANT boundaries: the centered stencil over
    the row extended by virtual samples (symmetric / wrap / edge), which
    the kernel maps while it stages its edge tiles (no padded copy);
  * derivative outputs scaled by ``dt_inv`` = 1 / time_step**derivative;
  * odd derivatives take the mathematically correct leading-edge sign
    unless ``reference_edge_sign=True`` reproduces the C's flipped one.

``method`` keeps the JAX package's values. "auto": the CUDA kernels for a
CUDA tensor, their plain PyTorch versions for a CPU tensor. "xla": the
plain versions. "pallas" / "mxu": the kernels, which need a CUDA tensor.
"bf16": the throughput mode, the same kernels in their bf16 mode (their
bf16 plain versions for a CPU tensor, which the JAX package runs too, in
interpret mode): samples and taps rounded to bf16 (the taps after
``dt_inv`` is folded in, as ``bf16(bf16(w) * bf16(dt_inv))``), products
exact and summed in f32, each output rounded to bf16 and returned in the
caller's dtype, within the documented ~5e-3 relative contract. A bf16
caller's samples go to the kernels as they are (2 B a sample each way)
and come back bf16; f16 computes from f32, as on the exact path. Every
length N >= 2n + 1 runs in bf16, where the JAX package falls back to its
exact path at lengths no TPU block width admits (a tiling artefact; e.g.
N = 12289). The padded boundaries take the TPU's fused route (``dt_inv``
in the taps); ``apply_valid`` multiplies by ``dt_inv`` after, in the
compute dtype, as the JAX package does. Every route resolves ``dt_inv``
once (``cuda_conv.scale_of``) and does nothing with an exact 1 that needs
no gradient, since ``y * 1`` is ``y``. Dispatch is by the tensor's device
only: a CUDA tensor reaches a kernel or an error, never the plain version
by fallback.

Gradients: the kernels run forward inside ``torch.autograd.Function``s
whose backward is autograd through the exact plain version, as the JAX
package's custom VJPs take the VJP of their XLA twins (for "bf16" too: the
exact f32 twin, a bf16 caller's samples promoted to f32 for it).
"""

from __future__ import annotations

from typing import Optional

import torch

from savgol_tpu_torch import tracing
from savgol_tpu_torch.config import PAD_MODE, BoundaryMode
from savgol_tpu_torch.ops.cuda_bank import (bank_correlate_plain,
                                            correlate_valid_bank_cuda)
from savgol_tpu_torch.ops.cuda_conv import (correlate_valid_bf16_cuda,
                                            correlate_valid_cuda,
                                            correlate_valid_plain,
                                            savgol_padded_bf16_cuda,
                                            savgol_padded_cuda,
                                            savgol_padded_plain,
                                            savgol_polynomial_bf16_cuda,
                                            savgol_polynomial_cuda,
                                            savgol_polynomial_plain,
                                            scale_of)

__all__ = [
    "correlate_bank",
    "savgol_apply_core",
    "savgol_apply",
    "savgol_apply_valid",
]

_METHODS = ("auto", "xla", "pallas", "mxu", "bf16")


def _use_kernel(method: str, x: torch.Tensor) -> bool:
    """Whether ``method`` routes through the kernel wrappers (which pick
    the plain version for a CPU tensor themselves; "bf16" always does) or
    straight to the plain version."""
    if method not in _METHODS:
        raise ValueError(
            f"method must be 'auto', 'xla', 'pallas', 'mxu' or 'bf16', "
            f"got {method!r}")
    if method in ("pallas", "mxu") and x.device.type != "cuda":
        raise ValueError(
            f"method={method!r} runs the CUDA kernel and needs a CUDA "
            f"tensor, got one on {x.device}")
    return method != "xla"


def _check_device(x: torch.Tensor, *weights) -> None:
    for w in weights:
        if w is not None and w.device != x.device:
            raise ValueError(
                f"filter weights are on {w.device} but the input is on "
                f"{x.device}")


def _ensure_float(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Promote integer/bool inputs to the weights' floating dtype (casting
    the weights down to an int dtype would truncate them to zero)."""
    if not (x.is_floating_point() or x.is_complex()):
        return x.to(w.dtype)
    return x


def _compute_dtype(x: torch.Tensor, bf16: bool = False):
    """Half-precision inputs compute in f32 (quantizing the weights to
    bf16/f16 would cost ~1e-2 accuracy); returns (x_f32, restore_dtype).
    With ``bf16`` (method="bf16") a bf16 input stays as it is: the kernels
    read and write bf16 storage and round to bf16 all the same."""
    if bf16 and x.dtype == torch.bfloat16:
        return x, None
    if x.dtype in (torch.bfloat16, torch.float16):
        return x.to(torch.float32), x.dtype
    return x, None


def _exact_twin(plain, x: torch.Tensor, *args):
    """``plain(x, *args)`` in ``x``'s compute dtype, returned in ``x``'s
    dtype: the exact function whose autograd gives a route's gradients (a
    bf16 input is promoted to f32 for it, as the JAX package's is)."""
    if x.dtype == torch.bfloat16:
        return plain(x.float(), *args).to(x.dtype)
    return plain(x, *args)


def _complex_split(fn, x: torch.Tensor) -> torch.Tensor:
    """Apply a real-linear filter to complex data: real and imaginary parts
    stacked as one extra batch pair (one kernel pass), then recombined."""
    y = fn(torch.stack([x.real, x.imag]))
    return torch.complex(y[0], y[1])


def _move_axis_last(x: torch.Tensor, axis: int):
    axis = axis % x.dim()
    if axis == x.dim() - 1:
        return x, None
    return x.movedim(axis, -1), axis


def _restore_axis(y: torch.Tensor, axis):
    if axis is None:
        return y
    return y.movedim(-1, axis)


def _grads_through(plain, saved, needs, g):
    """Gradients of ``plain(*saved)`` against cotangent ``g`` for the
    inputs flagged in ``needs`` (None for the others). The others go in as
    they were saved (a scale None among them), so a scale tensor stays the
    one :func:`scale_of` has already read."""
    inputs = [t.detach().requires_grad_() if need else t
              for t, need in zip(saved, needs)]
    wanted = [t for t, need in zip(inputs, needs) if need]
    if not wanted:
        return [None] * len(saved)
    with torch.enable_grad():
        y = plain(*inputs)
    grads = iter(torch.autograd.grad(y, wanted, g))
    return [next(grads) if need else None for need in needs]


class _SavgolPolyFn(torch.autograd.Function):
    """Fused POLYNOMIAL apply (kernel K1 on CUDA, in its bf16 mode for
    ``bf16``) whose backward is autograd through the exact
    ``savgol_polynomial_plain`` — the counterpart of
    ``savgol_tpu.ops.apply._pallas_poly_diff``."""

    @staticmethod
    def forward(ctx, x, cw, ew, dt_inv, n: int, lead_sign: float,
                bf16: bool):
        ctx.save_for_backward(x, cw, ew, dt_inv)
        ctx.n, ctx.lead_sign = n, lead_sign
        fn = savgol_polynomial_bf16_cuda if bf16 else savgol_polynomial_cuda
        return fn(x, cw, ew, n, dt_inv, lead_sign)

    @staticmethod
    def backward(ctx, g):
        def plain(x, cw, ew, dt):
            return _exact_twin(savgol_polynomial_plain, x, cw, ew, ctx.n, dt,
                               ctx.lead_sign)
        grads = _grads_through(plain, ctx.saved_tensors,
                               ctx.needs_input_grad[:4], g)
        return (*grads, None, None, None)


class _CorrValidFn(torch.autograd.Function):
    """VALID correlation (kernel K3 on CUDA, in its bf16 mode for ``bf16``)
    whose backward is autograd through the exact ``correlate_valid_plain``
    — the counterpart of ``savgol_tpu.ops.apply._pallas_corr_diff``."""

    @staticmethod
    def forward(ctx, x, w, bf16: bool):
        ctx.save_for_backward(x, w)
        return (correlate_valid_bf16_cuda if bf16 else
                correlate_valid_cuda)(x, w)

    @staticmethod
    def backward(ctx, g):
        def plain(x, w):
            return _exact_twin(correlate_valid_plain, x, w)
        grads = _grads_through(plain, ctx.saved_tensors,
                               ctx.needs_input_grad[:2], g)
        return (*grads, None)


class _SavgolPadFn(torch.autograd.Function):
    """Fused REFLECT / PERIODIC / CONSTANT apply (kernel K2 on CUDA, in its
    bf16 mode for ``bf16``) whose backward is autograd through the exact
    ``savgol_padded_plain`` — the counterpart of
    ``savgol_tpu.ops.apply._pallas_pad_diff``."""

    @staticmethod
    def forward(ctx, x, cw, dt_inv, n: int, pad_mode: str, bf16: bool):
        ctx.save_for_backward(x, cw, dt_inv)
        ctx.n, ctx.pad_mode = n, pad_mode
        fn = savgol_padded_bf16_cuda if bf16 else savgol_padded_cuda
        return fn(x, cw, pad_mode, n, dt_inv)

    @staticmethod
    def backward(ctx, g):
        def plain(x, cw, dt):
            return _exact_twin(savgol_padded_plain, x, cw, ctx.pad_mode,
                               ctx.n, dt)
        grads = _grads_through(plain, ctx.saved_tensors,
                               ctx.needs_input_grad[:3], g)
        return (*grads, None, None, None)


class _BankFn(torch.autograd.Function):
    """K-stencil bank correlation (kernel K4 on CUDA) whose backward is
    autograd through ``bank_correlate_plain``."""

    @staticmethod
    def forward(ctx, x, w, pad: int, pad_mode):
        ctx.save_for_backward(x, w)
        ctx.pad, ctx.pad_mode = pad, pad_mode
        return correlate_valid_bank_cuda(x, w, pad, pad_mode)

    @staticmethod
    def backward(ctx, g):
        def plain(x, w):
            return bank_correlate_plain(x, w, ctx.pad, ctx.pad_mode)
        grads = _grads_through(plain, ctx.saved_tensors,
                               ctx.needs_input_grad[:2], g)
        return (*grads, None, None)


def _padded(x: torch.Tensor, center_w: torch.Tensor,
            dt: Optional[torch.Tensor], n: int, pad_mode: str, kernel: bool,
            bf16: bool = False):
    """Same-length apply over the row padded in ``pad_mode``, ``dt`` (None:
    no scale) folded into the taps: kernel K2 (in its bf16 mode for
    ``bf16``) through :class:`_SavgolPadFn`, or the exact plain version
    (``kernel`` False)."""
    if kernel:
        return _SavgolPadFn.apply(x.contiguous(), center_w, dt, n, pad_mode,
                                  bf16)
    return savgol_padded_plain(x, center_w, pad_mode, n, dt)


def _correlate(x: torch.Tensor, w: torch.Tensor, kernel: bool,
               bf16: bool = False):
    """VALID correlation: kernel K3 (in its bf16 mode for ``bf16``) through
    :class:`_CorrValidFn`, or the exact plain version (``kernel`` False,
    which "bf16" never is)."""
    if kernel:
        return _CorrValidFn.apply(x.contiguous(), w, bf16)
    return correlate_valid_plain(x, w)


def correlate_bank(x: torch.Tensor, w: torch.Tensor, pad: int = 0,
                   pad_mode=None, *, kernel: bool) -> torch.Tensor:
    """(K, ..., N + 2 pad - ws + 1) bank correlation of ``x`` padded by
    ``pad`` (zeros or ``pad_mode``): kernel K4 through :class:`_BankFn`
    (the plain version for a CPU tensor), or the plain version."""
    if kernel:
        return _BankFn.apply(x.contiguous(), w, int(pad), pad_mode)
    return bank_correlate_plain(x, w, pad, pad_mode)


def savgol_apply_core(
    x: torch.Tensor,
    center_w: torch.Tensor,
    edge_w: Optional[torch.Tensor],
    half_window: int,
    boundary: BoundaryMode,
    dt_inv: float | torch.Tensor = 1.0,
    *,
    derivative: int = 0,
    reference_edge_sign: bool = False,
    method: str = "auto",
) -> torch.Tensor:
    """Filter the last axis of ``x``; same-length output.

    ``center_w``: (2n+1,) stencil; ``edge_w``: (n, 2n+1) edge rows (required
    for POLYNOMIAL boundary, ignored otherwise). Differentiable in ``x``,
    the weights and a tensor ``dt_inv``.
    """
    if not isinstance(boundary, BoundaryMode):
        boundary = BoundaryMode(boundary)
    n = int(half_window)
    ws = 2 * n + 1
    kernel = _use_kernel(method, x)
    N = x.shape[-1]
    if N < ws:
        raise ValueError(
            f"data length ({N}) must be >= window size ({ws})")
    _check_device(x, center_w, edge_w)
    if x.is_complex():
        return _complex_split(
            lambda v: savgol_apply_core(
                v, center_w, edge_w, half_window, boundary, dt_inv,
                derivative=derivative,
                reference_edge_sign=reference_edge_sign, method=method), x)
    bf16 = method == "bf16"
    x = _ensure_float(x, center_w)
    x, restore = _compute_dtype(x, bf16)
    dt = scale_of(dt_inv, x)

    if boundary is BoundaryMode.POLYNOMIAL:
        lead_sign = 1.0
        if not reference_edge_sign and int(derivative) % 2 == 1:
            lead_sign = -1.0
        if kernel:
            y = _SavgolPolyFn.apply(x.contiguous(), center_w, edge_w, dt, n,
                                    lead_sign, bf16)
        else:
            y = savgol_polynomial_plain(x, center_w, edge_w, n, dt,
                                        lead_sign)
    else:
        y = _padded(x, center_w, dt, n, PAD_MODE[boundary], kernel, bf16)
    return y.to(restore) if restore is not None else y


def savgol_apply(
    x: torch.Tensor,
    center_w: torch.Tensor,
    edge_w: Optional[torch.Tensor] = None,
    *,
    half_window: int,
    boundary: BoundaryMode = BoundaryMode.POLYNOMIAL,
    dt_inv: float | torch.Tensor = 1.0,
    derivative: int = 0,
    reference_edge_sign: bool = False,
    axis: int = -1,
    method: str = "auto",
) -> torch.Tensor:
    """Apply a precomputed Savitzky-Golay filter along ``axis`` of ``x``
    (reference ``savgol_apply``, src/savgolFilter.c:743, generalized to ND
    tensors; ``axis`` replaces ``savgol_apply_strided``). The body is a
    ``savgol.apply`` span."""
    span = tracing.begin("savgol.apply") if tracing.on() else None
    try:
        xl, moved = _move_axis_last(x, axis)
        y = savgol_apply_core(
            xl, center_w, edge_w, half_window, boundary, dt_inv,
            derivative=derivative, reference_edge_sign=reference_edge_sign,
            method=method)
        return _restore_axis(y, moved)
    finally:
        tracing.end(span)


def savgol_apply_valid(
    x: torch.Tensor,
    center_w: torch.Tensor,
    *,
    half_window: int,
    dt_inv: float | torch.Tensor = 1.0,
    axis: int = -1,
    method: str = "auto",
) -> torch.Tensor:
    """VALID-mode apply: only positions with a full window; output length
    N - 2*half_window (reference src/savgolFilter.c:821-850). The body is
    a ``savgol.apply`` span."""
    span = tracing.begin("savgol.apply") if tracing.on() else None
    try:
        ws = 2 * int(half_window) + 1
        xl, moved = _move_axis_last(x, axis)
        kernel = _use_kernel(method, xl)
        if xl.shape[-1] < ws:
            raise ValueError(
                f"data length ({xl.shape[-1]}) must be >= window size "
                f"({ws})")
        _check_device(xl, center_w)
        if xl.is_complex():
            y = _complex_split(
                lambda v: savgol_apply_valid(
                    v, center_w, half_window=half_window, dt_inv=dt_inv,
                    method=method), xl)
            return _restore_axis(y, moved)
        bf16 = method == "bf16"
        xl = _ensure_float(xl, center_w)
        xl, restore = _compute_dtype(xl, bf16)
        y = _correlate(xl, center_w, kernel, bf16)
        s = scale_of(dt_inv, xl)
        if s is not None:
            y = y * s
        if restore is not None:
            y = y.to(restore)
        return _restore_axis(y, moved)
    finally:
        tracing.end(span)
