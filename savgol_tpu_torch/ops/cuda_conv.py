"""The same-length and VALID 1D kernels of the port, their plain PyTorch
versions and their launch counts, and the pad-index rule and host pad
(:func:`pad_last`, counted in ``PADS``) every padded plain version uses;
K2's pads mapped in the kernel count in ``MAPPED``.

``savgol_polynomial_cuda`` (kernel K1, ``csrc/sg1d_poly.cu``),
``savgol_padded_cuda`` (kernel K2, the same source) and
``correlate_valid_cuda`` (kernel K3, ``csrc/corr1d_valid.cu``) are the
counterparts of the single-stencil 1D half of
``savgol_tpu.ops.pallas_conv``. Each wrapper dispatches on the device of the
tensor it is given: a CPU tensor takes the plain version, a CUDA tensor
launches the kernel or raises. Nothing falls back from the kernel to the
plain version.

The plain versions are a tap loop over shifted slices plus elementwise edge
sums: no matmul and no convolution, so TF32 cannot enter them on the card.
They are the CPU path, the reference the kernels are held against, and the
functions whose autograd gives the gradients (``ops.apply``).

``method="bf16"`` has its own wrappers and plain versions
(``savgol_polynomial_bf16_cuda`` / ``_plain`` and the padded and VALID
pairs): the same kernels in their bf16 mode (K1 and K2 on the tensor cores,
``csrc/sg1d_bf16.cuh``: a block of 16 outputs is a product with the taps'
band, ``cuda_conv2d.row_bands`` of a 1 x ws stencil), the counterparts of
the Pallas wrappers on bf16 operands at single-pass MXU precision. Samples and
taps are rounded to bf16 (the taps as ``bf16(bf16(w) * bf16(dt_inv))``, on
the host side by :func:`bf16_taps` for both versions, so both get the same
bits), products are exact in f32, sums are f32, and each output is rounded
to bf16. The kernels read and write the caller's f32 or bf16 storage;
other dtypes are rounded to bf16 first and get their dtype back. They count
their launches under the same kernel names, and their roundings of taps and
of storage in ``ROUNDED``.
"""

from __future__ import annotations

import weakref
from typing import Optional

import torch
import torch.nn.functional as F

from savgol_tpu_torch import tracing
from savgol_tpu_torch._build import library

__all__ = [
    "LAUNCHES",
    "MAPPED",
    "MODE_CODE",
    "PADS",
    "ROUNDED",
    "reset_launches",
    "scale_of",
    "pad_index",
    "pad_last",
    "savgol_polynomial_cuda",
    "savgol_polynomial_plain",
    "savgol_padded_cuda",
    "savgol_padded_plain",
    "correlate_valid_cuda",
    "correlate_valid_plain",
    "bf16_taps",
    "bf16_ulp_gate",
    "savgol_polynomial_bf16_cuda",
    "savgol_polynomial_bf16_plain",
    "savgol_padded_bf16_cuda",
    "savgol_padded_bf16_plain",
    "correlate_valid_bf16_cuda",
    "correlate_valid_bf16_plain",
]

# Kernel launches since the last reset_launches(), one count per wrapper.
# Only the line that launches a kernel adds to its count.
LAUNCHES = {"sg1d_poly": 0, "sg1d_pad": 0, "corr1d_valid": 0}

# Pads made outside a kernel (:func:`pad_last`) since the process started,
# one count per mode, and the bytes of the padded tensors they wrote. Only
# a pad that succeeded adds to them.
PADS = {"reflect": 0, "edge": 0, "wrap": 0, "symmetric": 0, "zeros": 0,
        "constant": 0, "bytes": 0}

# The kernels' shared tap buffer (csrc/stencil_tile.cuh kMaxWs): the JAX
# package's Pallas cap of _LANES + 1 taps, past SavgolConfig's 65, which
# scipy_compat and the raw savgol_apply* calls reach.
_MAX_WS = 129

# pad mode -> the kernels' mode code (csrc/stencil_tile.cuh, PadMode); None
# pads with zeros
MODE_CODE = {None: 0, "edge": 1, "symmetric": 2, "wrap": 3}

# K2's pad modes and codes: MODE_CODE's and numpy's "reflect" (kReflect,
# scipy_compat's mode="mirror"), which only K2 maps
_K2_CODE = {"edge": 1, "symmetric": 2, "wrap": 3, "reflect": 4}

# Pads mapped inside K2 while it stages (no padded copy) since the process
# started, one count per mode: the in-kernel twin of PADS. Only a K2 launch
# that succeeded adds to them.
MAPPED = dict.fromkeys(_K2_CODE, 0)

# method="bf16"'s roundings since the process started: ``taps``, the tap
# tensors :func:`bf16_taps` rounds (both versions; two a POLYNOMIAL call);
# ``storage``, the inputs :func:`_bf16_storage` rounds to bf16 storage on
# the kernel route (an f64 caller's: f32 and bf16 go to the kernel as they
# are, and ``ops.apply`` promotes f16 to f32 first).
ROUNDED = {"taps": 0, "storage": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _version(t: torch.Tensor):
    """``t``'s in-place version; None for an inference tensor, which keeps
    no version counter (an in-place change to one inside
    ``torch.inference_mode`` goes unseen)."""
    return None if t.is_inference() else t._version


def _memo_get(memo: dict, key, t: torch.Tensor):
    """What :func:`_memo_put` stored in ``memo`` under ``key`` for ``t``,
    while ``t`` is unchanged in place since; else None."""
    hit = memo.get(key)
    if hit is not None and hit[0]() is t and hit[1] == _version(t):
        return hit[2]
    return None


def _memo_put(memo: dict, key, t: torch.Tensor, value):
    """Store ``value`` in ``memo`` under ``key`` for ``t`` at its in-place
    version, until ``t`` goes; returns ``value``."""
    ref = weakref.ref(t, lambda _, k=key: memo.pop(k, None))
    memo[key] = (ref, _version(t), value)
    return value


# Scale tensors scale_of has decided, by id: whether every element is
# exactly 1
_SCALES: dict = {}


def _is_one(v: torch.Tensor) -> bool:
    """Whether every element of ``v`` is exactly 1, read on the host once
    per tensor and in-place version; a view is read as its base (a base of
    ones holds only ones)."""
    t = v if v._base is None else v._base
    one = _memo_get(_SCALES, id(t), t)
    if one is None:
        one = _memo_put(_SCALES, id(t), t, bool((t == 1).all()))
    return one


def scale_of(v, x: torch.Tensor, dtype=None) -> Optional[torch.Tensor]:
    """The derivative scale ``v`` (``dt_inv`` in 1D, ``scale`` in 2D) as it
    reaches a result computed from ``x``: None ("no scale") where it is
    exactly 1 and needs no gradient, so that no route multiplies by 1, else
    a tensor in ``dtype`` (default ``x``'s; float32 for bf16 storage) on
    ``x``'s device. The one rule of every route:

    * None, or a Python number equal to 1: None, with no device operation;
    * any other Python number: a 0-dim fill on the device
      (``torch.as_tensor`` would copy it from the host and synchronise the
      stream);
    * a tensor that requires grad, an inference or a meta tensor: that
      tensor, never read on the host;
    * any other tensor (a module's buffer): read on the host once per
      tensor and in-place version (:func:`_is_one`), so that a ``.to()``, a
      ``load_state_dict`` or an in-place write is seen and no later call
      pays a sync; None where every element is 1.

    A tensor this returns counts as read, so a route that is handed it and
    asks again pays no read."""
    if v is None:
        return None
    if dtype is None:
        dtype = torch.float32 if x.dtype == torch.bfloat16 else x.dtype
    if not isinstance(v, torch.Tensor):
        if float(v) == 1.0:
            return None
        s = torch.full((), float(v), dtype=dtype, device=x.device)
    elif v.requires_grad or v.is_inference() or v.is_meta:
        return v.to(dtype=dtype, device=x.device)
    elif _is_one(v):
        return None
    else:
        s = v.to(dtype=dtype, device=x.device)
    if s is not v:
        _memo_put(_SCALES, id(s), s, False)
    return s


def pad_index(n: int, lo: int, hi: int, pad_mode: str,
              device) -> torch.Tensor:
    """Source indices of an axis of length n padded by (lo, hi), by numpy's
    rules for any pad width: edge clamps, wrap is i mod n, symmetric
    reflects with the edge sample duplicated (period 2n), reflect without
    it (period 2n - 2). The host twin of ``csrc/stencil_tile.cuh``
    ``map_index``."""
    i = torch.arange(-lo, n + hi, device=device)
    if pad_mode == "edge":
        return i.clamp(0, n - 1)
    if pad_mode == "wrap":
        return i.remainder(n)
    if pad_mode == "symmetric":
        j = i.remainder(2 * n)
        return torch.where(j < n, j, 2 * n - 1 - j)
    if pad_mode == "reflect":
        if n == 1:
            return torch.zeros_like(i)
        j = i.remainder(2 * n - 2)
        return torch.where(j < n, j, 2 * n - 2 - j)
    raise ValueError(f"unsupported pad mode {pad_mode!r}")


def pad_last(x: torch.Tensor, n: int, pad_mode: Optional[str],
             cval: float = 0.0) -> torch.Tensor:
    """The last axis padded by n on each side: zeros (``pad_mode`` None),
    ``cval`` (``"constant"``) or ``jnp.pad``'s ``pad_mode`` for any pad
    width. The pad is a ``savgol.pad`` span and is counted in
    :data:`PADS`."""
    span = tracing.begin("savgol.pad") if tracing.on() else None
    try:
        if pad_mode is None:
            y = F.pad(x, (n, n))
        elif pad_mode == "constant":
            y = F.pad(x, (n, n), value=float(cval))
        else:
            y = x.index_select(-1, pad_index(x.shape[-1], n, n, pad_mode,
                                             x.device))
        PADS[pad_mode or "zeros"] += 1
        PADS["bytes"] += y.numel() * y.element_size()
        return y
    finally:
        tracing.end(span)


def correlate_valid_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``out[..., j] = sum_k w[k] * x[..., j + k]`` along the last axis;
    output length N - len(w) + 1 (counterpart of
    ``savgol_tpu.ops.apply.correlate_valid``)."""
    ws = w.shape[-1]
    n_out = x.shape[-1] - ws + 1
    w = w.to(x.dtype)
    out = x[..., 0:n_out] * w[0]
    for k in range(1, ws):
        out = out + x[..., k:k + n_out] * w[k]
    return out


def _edge_sums(ew: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """``out[..., e] = sum_k ew[e, k] * win[..., k]`` as a product and a
    sum (a matmul could run in TF32 on the card)."""
    return (win.unsqueeze(-2) * ew).sum(-1)


def savgol_polynomial_plain(x: torch.Tensor, center_w: torch.Tensor,
                            edge_w: torch.Tensor, n: int, dt_inv=1.0,
                            lead_sign: float = 1.0) -> torch.Tensor:
    """Same-length POLYNOMIAL apply along the last axis (counterpart of
    ``xla_poly`` in ``savgol_tpu.ops.apply._pallas_poly_diff``): the valid
    center, then the n leading outputs from the reversed first window and
    the n trailing ones from the last window, then ``* dt_inv``
    (:func:`scale_of`)."""
    ws = 2 * n + 1
    N = x.shape[-1]
    center = correlate_valid_plain(x, center_w)
    ew = edge_w.to(x.dtype)
    lead = _edge_sums(ew, x[..., :ws].flip(-1)) * lead_sign
    trail = _edge_sums(ew, x[..., N - ws:]).flip(-1)
    y = torch.cat([lead, center, trail], dim=-1)
    s = scale_of(dt_inv, x)
    return y if s is None else y * s


def savgol_padded_plain(x: torch.Tensor, center_w: torch.Tensor,
                        pad_mode: str, n: int, dt_inv=1.0) -> torch.Tensor:
    """Same-length REFLECT / PERIODIC / CONSTANT apply along the last axis
    (counterpart of ``xla_twin`` in ``savgol_tpu.ops.apply._pallas_pad_diff``),
    or scipy's ``mirror``: pad by n in ``pad_mode`` ("symmetric" / "wrap" /
    "edge", or numpy's "reflect"), the VALID correlation, then
    ``* dt_inv`` (:func:`scale_of`)."""
    if pad_mode not in _K2_CODE:
        raise ValueError(f"unsupported pad mode {pad_mode!r}")
    y = correlate_valid_plain(pad_last(x, int(n), pad_mode), center_w)
    s = scale_of(dt_inv, x)
    return y if s is None else y * s


def _check_cuda_input(x: torch.Tensor, name: str) -> None:
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: the kernel takes float32 or float64, "
                        f"got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: the kernel needs a contiguous input")
    if x.dim() < 1:
        raise ValueError(f"{name}: input must have at least one axis")


def _check_bf16_input(x: torch.Tensor, name: str) -> None:
    if not x.is_floating_point():
        raise TypeError(f"{name}: the kernel takes floating input, got "
                        f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: the kernel needs a contiguous input")
    if x.dim() < 1:
        raise ValueError(f"{name}: input must have at least one axis")


def _same_device(w: torch.Tensor, x: torch.Tensor, name: str) -> None:
    if w.device != x.device:
        raise ValueError(f"{name}: weights on {w.device}, input on "
                         f"{x.device}")


def _weights_on(w: torch.Tensor, x: torch.Tensor, name: str) -> torch.Tensor:
    _same_device(w, x, name)
    return w.to(x.dtype)


def _raise_on_error(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError_t "
                           f"{err}")


def _plain_or_cuda(x: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (take the plain version); raises for any other device."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel and no plain path for device "
                     f"{x.device}")


def _operands(x: torch.Tensor, taps, dt_inv, bf16: bool, name: str):
    """(storage the kernel reads, its taps, dtype to restore or None) for
    either mode, after the taps' device check. Exact: ``x`` as it is, the
    taps in its dtype times ``dt_inv`` (:func:`scale_of`; with no scale,
    the caller's own taps where they are already in ``x``'s dtype and
    contiguous). bf16: :func:`_bf16_storage` and :func:`bf16_taps`. The
    taps are prepared in a ``savgol.taps`` span."""
    for t in taps:
        _same_device(t, x, name)
    xs, restore = _bf16_storage(x) if bf16 else (x, None)
    span = tracing.begin("savgol.taps") if tracing.on() else None
    try:
        if bf16:
            ws = [bf16_taps(t, dt_inv) for t in taps]
        else:
            ws = [t.to(x.dtype) for t in taps]
            s = scale_of(dt_inv, x)
            if s is not None:
                ws = [t * s for t in ws]
        return xs, [t.contiguous() for t in ws], restore
    finally:
        tracing.end(span)


def _enqueue(name: str, counts: dict, key: str, device: torch.device,
             symbol: str, *args) -> None:
    """Launch the library's ``extern "C"`` entry ``symbol`` with ``args``
    and the current stream of ``device``, without synchronising, inside a
    ``savgol.launch`` span; raises on a launch error, else counts one
    launch in ``counts[key]``. Every kernel launch of the port's paths
    comes through here, so each is both counted and spanned."""
    span = tracing.begin("savgol.launch") if tracing.on() else None
    try:
        fn = getattr(library(), symbol)
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
        _raise_on_error(err, name)
        counts[key] += 1
    finally:
        tracing.end(span)


def _launch(name: str, counts: dict, key: str, base: str, xs: torch.Tensor,
            bf16: bool, *args) -> None:
    """:func:`_enqueue` of the entry for ``xs``'s storage, ``base``_f32 or
    ``base``_f64, or ``base``_bf16 with its storage flag (1 for bf16, 0 for
    f32), on ``xs``'s card."""
    if bf16:
        symbol = base + "_bf16"
        args += (int(xs.dtype == torch.bfloat16),)
    else:
        symbol = base + ("_f32" if xs.dtype == torch.float32 else "_f64")
    _enqueue(name, counts, key, xs.device, symbol, *args)


def _check_half_window(name: str, n: int) -> None:
    if n < 1 or 2 * n + 1 > _MAX_WS:
        raise ValueError(f"{name}: half window must be in [1, "
                         f"{_MAX_WS // 2}], got {n}")


def _check_length(N: int, ws: int) -> None:
    if N < ws:
        raise ValueError(f"data length ({N}) must be >= window size ({ws})")


def _k1(name: str, x: torch.Tensor, center_w: torch.Tensor,
        edge_w: torch.Tensor, n: int, dt_inv, lead_sign: float,
        bf16: bool) -> torch.Tensor:
    """K1's checks and launch in either mode, ``dt_inv`` folded into the
    taps."""
    (_check_bf16_input if bf16 else _check_cuda_input)(x, name)
    n = int(n)
    ws = 2 * n + 1
    N = x.shape[-1]
    _check_half_window(name, n)
    if tuple(center_w.shape) != (ws,) or tuple(edge_w.shape) != (n, ws):
        raise ValueError(f"{name}: weights of shape {tuple(center_w.shape)} "
                         f"and {tuple(edge_w.shape)} do not match n={n}")
    _check_length(N, ws)
    xs, (w, ew), restore = _operands(x, (center_w, edge_w), dt_inv, bf16,
                                     name)
    out = torch.empty_like(xs)
    B = xs.numel() // N
    if B > 0:
        _launch(name, LAUNCHES, "sg1d_poly", "sg1d_poly", xs, bf16,
                xs.data_ptr(), w.data_ptr(), ew.data_ptr(), out.data_ptr(),
                B, N, n, float(lead_sign))
    return out if restore is None else out.to(restore)


def _k2(name: str, x: torch.Tensor, center_w: torch.Tensor, pad_mode: str,
        n: int, dt_inv, bf16: bool) -> torch.Tensor:
    """K2's checks and launch in either mode, ``dt_inv`` folded into the
    taps; ``pad_mode`` "symmetric", "wrap", "edge" or "reflect", mapped
    while the kernel stages and counted in :data:`MAPPED`."""
    (_check_bf16_input if bf16 else _check_cuda_input)(x, name)
    n = int(n)
    ws = 2 * n + 1
    N = x.shape[-1]
    if pad_mode not in _K2_CODE:
        raise ValueError(f"{name}: unsupported pad mode {pad_mode!r}")
    _check_half_window(name, n)
    if tuple(center_w.shape) != (ws,):
        raise ValueError(f"{name}: weights of shape {tuple(center_w.shape)} "
                         f"do not match n={n}")
    _check_length(N, ws)
    xs, (w,), restore = _operands(x, (center_w,), dt_inv, bf16, name)
    out = torch.empty_like(xs)
    B = xs.numel() // N
    if B > 0:
        _launch(name, LAUNCHES, "sg1d_pad", "sg1d_pad", xs, bf16,
                xs.data_ptr(), w.data_ptr(), out.data_ptr(), B, N, n,
                _K2_CODE[pad_mode])
        MAPPED[pad_mode] += 1
    return out if restore is None else out.to(restore)


def _k3(name: str, x: torch.Tensor, w: torch.Tensor,
        bf16: bool) -> torch.Tensor:
    """K3's checks and launch in either mode."""
    (_check_bf16_input if bf16 else _check_cuda_input)(x, name)
    if w.dim() != 1 or not 1 <= w.shape[0] <= _MAX_WS:
        raise ValueError(f"{name}: taps must be 1D with 1..{_MAX_WS} "
                         f"entries, got shape {tuple(w.shape)}")
    ws = w.shape[0]
    N = x.shape[-1]
    _check_length(N, ws)
    xs, (wc,), restore = _operands(x, (w,), None, bf16, name)
    out = torch.empty(xs.shape[:-1] + (N - ws + 1,), dtype=xs.dtype,
                      device=x.device)
    B = xs.numel() // N
    if B > 0:
        _launch(name, LAUNCHES, "corr1d_valid", "corr1d_valid", xs, bf16,
                xs.data_ptr(), wc.data_ptr(), out.data_ptr(), B, N, ws)
    return out if restore is None else out.to(restore)


def savgol_polynomial_cuda(x: torch.Tensor, center_w: torch.Tensor,
                           edge_w: torch.Tensor, n: int, dt_inv=1.0,
                           lead_sign: float = 1.0) -> torch.Tensor:
    """Same-length POLYNOMIAL apply along the last axis of ``x`` (..., N).

    CUDA tensor: kernel K1 (``csrc/sg1d_poly.cu``), launched on the current
    stream without synchronising, with ``dt_inv`` folded into the weights
    as ``savgol_polynomial_pallas_mxu`` does (a sub-ulp difference from
    multiplying after). CPU tensor: :func:`savgol_polynomial_plain`.
    """
    name = "savgol_polynomial_cuda"
    if not _plain_or_cuda(x, name):
        return savgol_polynomial_plain(x, center_w, edge_w, n, dt_inv,
                                       lead_sign)
    return _k1(name, x, center_w, edge_w, n, dt_inv, lead_sign, False)


def savgol_padded_cuda(x: torch.Tensor, center_w: torch.Tensor,
                       pad_mode: str, n: int, dt_inv=1.0) -> torch.Tensor:
    """Same-length REFLECT / PERIODIC / CONSTANT apply along the last axis
    of ``x`` (..., N), ``pad_mode`` "symmetric" / "wrap" / "edge", or
    scipy's ``mirror``, numpy's "reflect" (the edge sample not repeated).

    CUDA tensor: kernel K2 (``csrc/sg1d_poly.cu``, the counterpart of
    ``savgol_padded_pallas_mxu``), which maps the virtual samples while it
    stages its edge tiles, so no padded copy is made (counted in
    :data:`MAPPED`); ``dt_inv`` folded into the taps as K1 does. There is
    no fallback: any B >= 1, N >= ws and 1 <= n <= 64 launches. CPU
    tensor: :func:`savgol_padded_plain`.
    """
    name = "savgol_padded_cuda"
    if not _plain_or_cuda(x, name):
        return savgol_padded_plain(x, center_w, pad_mode, n, dt_inv)
    return _k2(name, x, center_w, pad_mode, n, dt_inv, False)


def correlate_valid_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """VALID correlation along the last axis of ``x`` (..., N); output
    (..., N - len(w) + 1).

    CUDA tensor: kernel K3 (``csrc/corr1d_valid.cu``) on the current stream,
    no synchronisation. CPU tensor: :func:`correlate_valid_plain`.
    """
    name = "correlate_valid_cuda"
    if not _plain_or_cuda(x, name):
        return correlate_valid_plain(x, w)
    return _k3(name, x, w, False)


# -- method="bf16" -------------------------------------------------------------


def bf16_taps(w: torch.Tensor, dt_inv=None) -> torch.Tensor:
    """The taps of ``method="bf16"`` as float32 holding bf16 values:
    ``bf16(w)``, or ``bf16(bf16(w) * bf16(dt_inv))`` with ``dt_inv`` (the
    product of two bf16 values rounded once, as ``pallas_conv.py:723-726``
    forms them; no product where :func:`scale_of` finds no scale). The
    kernels and the plain versions take them from here, each call counted
    in ``ROUNDED["taps"]``."""
    t = w.to(torch.bfloat16)
    s = scale_of(dt_inv, t, torch.bfloat16)
    t = (t if s is None else t * s).float()
    ROUNDED["taps"] += 1
    return t


def bf16_ulp_gate(want: torch.Tensor) -> torch.Tensor:
    """The gate a bf16-mode result is held to against another computation
    of the same bf16 sums in another order: one bf16 ulp of each reference
    value, ``2**-8 * 2**e`` for ``|want|`` in ``[2**(e-1), 2**e)`` (an
    output whose sum crosses a rounding boundary moves by one ulp), plus
    ``1e-6 * max|want|`` for the f32 order differences of outputs near
    zero; elementwise, in float64."""
    want = want.double()
    ulp = torch.ldexp(torch.ones_like(want), torch.frexp(want.abs())[1] - 8)
    return torch.where(want == 0, 0.0, ulp) + 1e-6 * want.abs().max()


def _bf16_operand(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16 and held in float32."""
    return x.to(torch.bfloat16).float()


def _bf16_storage(x: torch.Tensor):
    """(storage the bf16 kernels take, dtype to return): f32 and bf16 as
    they are; any other dtype rounded to bf16 first (counted in
    ``ROUNDED["storage"]``) and restored after."""
    if x.dtype in (torch.float32, torch.bfloat16):
        return x, None
    xs = x.to(torch.bfloat16)
    ROUNDED["storage"] += 1
    return xs, x.dtype


def _bf16_result(y: torch.Tensor, dtype) -> torch.Tensor:
    """A float32 sum rounded to bf16, in ``dtype``."""
    return y.to(torch.bfloat16).to(dtype)


def savgol_polynomial_bf16_plain(x: torch.Tensor, center_w: torch.Tensor,
                                 edge_w: torch.Tensor, n: int, dt_inv=1.0,
                                 lead_sign: float = 1.0) -> torch.Tensor:
    """``method="bf16"`` same-length POLYNOMIAL apply (counterpart of
    ``savgol_polynomial_pallas_mxu`` on bf16 operands at DEFAULT precision):
    :func:`savgol_polynomial_plain` in float32 on bf16 samples and
    :func:`bf16_taps` with ``dt_inv`` folded in, each output rounded to bf16;
    returned in ``x``'s dtype."""
    y = savgol_polynomial_plain(_bf16_operand(x),
                                bf16_taps(center_w, dt_inv),
                                bf16_taps(edge_w, dt_inv), n, None, lead_sign)
    return _bf16_result(y, x.dtype)


def savgol_padded_bf16_plain(x: torch.Tensor, center_w: torch.Tensor,
                             pad_mode: str, n: int,
                             dt_inv=1.0) -> torch.Tensor:
    """``method="bf16"`` same-length REFLECT / PERIODIC / CONSTANT apply
    (counterpart of ``savgol_padded_pallas_mxu`` on bf16 operands):
    :func:`savgol_padded_plain` as :func:`savgol_polynomial_bf16_plain`
    rounds."""
    y = savgol_padded_plain(_bf16_operand(x), bf16_taps(center_w, dt_inv),
                            pad_mode, n, None)
    return _bf16_result(y, x.dtype)


def correlate_valid_bf16_plain(x: torch.Tensor,
                               w: torch.Tensor) -> torch.Tensor:
    """``method="bf16"`` VALID correlation (counterpart of
    ``correlate_valid_pallas_mxu`` on bf16 operands): bf16 samples and taps,
    float32 sums, outputs rounded to bf16, in ``x``'s dtype."""
    y = correlate_valid_plain(_bf16_operand(x), bf16_taps(w))
    return _bf16_result(y, x.dtype)


def savgol_polynomial_bf16_cuda(x: torch.Tensor, center_w: torch.Tensor,
                                edge_w: torch.Tensor, n: int, dt_inv=1.0,
                                lead_sign: float = 1.0) -> torch.Tensor:
    """``method="bf16"`` same-length POLYNOMIAL apply along the last axis.

    CUDA tensor: kernel K1 in its bf16 mode (``sg1d_poly_bf16``, the band
    products on the tensor cores), one launch that reads and writes f32 or
    bf16 storage (other dtypes go through bf16 and come back); any length
    N >= 2n + 1 and any alignment of the rows runs, where the TPU kernel
    needs an admissible block width. CPU tensor:
    :func:`savgol_polynomial_bf16_plain`.
    """
    name = "savgol_polynomial_bf16_cuda"
    if not _plain_or_cuda(x, name):
        return savgol_polynomial_bf16_plain(x, center_w, edge_w, n, dt_inv,
                                            lead_sign)
    return _k1(name, x, center_w, edge_w, n, dt_inv, lead_sign, True)


def savgol_padded_bf16_cuda(x: torch.Tensor, center_w: torch.Tensor,
                            pad_mode: str, n: int,
                            dt_inv=1.0) -> torch.Tensor:
    """``method="bf16"`` same-length REFLECT / PERIODIC / CONSTANT apply.

    CUDA tensor: kernel K2 in its bf16 mode (``sg1d_pad_bf16``), the pad
    mapped while staging and ``dt_inv`` folded into the bf16 taps, as the
    TPU's fused-pad kernel does. CPU tensor:
    :func:`savgol_padded_bf16_plain`.
    """
    name = "savgol_padded_bf16_cuda"
    if not _plain_or_cuda(x, name):
        return savgol_padded_bf16_plain(x, center_w, pad_mode, n, dt_inv)
    return _k2(name, x, center_w, pad_mode, n, dt_inv, True)


def correlate_valid_bf16_cuda(x: torch.Tensor,
                              w: torch.Tensor) -> torch.Tensor:
    """``method="bf16"`` VALID correlation along the last axis; output
    (..., N - len(w) + 1).

    CUDA tensor: kernel K3 in its bf16 mode (``corr1d_valid_bf16``). CPU
    tensor: :func:`correlate_valid_bf16_plain`.
    """
    name = "correlate_valid_bf16_cuda"
    if not _plain_or_cuda(x, name):
        return correlate_valid_bf16_plain(x, w)
    return _k3(name, x, w, True)
