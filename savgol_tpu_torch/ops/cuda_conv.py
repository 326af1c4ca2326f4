"""The same-length and VALID 1D kernels of the port, their plain PyTorch
versions and their launch counts, and the pad-index rule every padded
plain version uses.

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
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from savgol_tpu_torch._build import library

__all__ = [
    "LAUNCHES",
    "MODE_CODE",
    "reset_launches",
    "pad_index",
    "pad_last",
    "savgol_polynomial_cuda",
    "savgol_polynomial_plain",
    "savgol_padded_cuda",
    "savgol_padded_plain",
    "correlate_valid_cuda",
    "correlate_valid_plain",
]

# Kernel launches since the last reset_launches(), one count per wrapper.
# Only the line that launches a kernel adds to its count.
LAUNCHES = {"sg1d_poly": 0, "sg1d_pad": 0, "corr1d_valid": 0}

# The kernels' shared tap buffer (csrc/stencil_tile.cuh kMaxWs): the JAX
# package's Pallas cap of _LANES + 1 taps, past SavgolConfig's 65, which
# scipy_compat and the raw savgol_apply* calls reach.
_MAX_WS = 129

# pad mode -> the kernels' mode code (csrc/stencil_tile.cuh, PadMode); None
# pads with zeros
MODE_CODE = {None: 0, "edge": 1, "symmetric": 2, "wrap": 3}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def scalar_like(v, x: torch.Tensor) -> torch.Tensor:
    """``v`` as a 0-dim tensor of ``x``'s dtype and device. A Python number
    becomes a fill on the device: ``torch.as_tensor`` would copy it from
    the host and synchronise the stream."""
    if isinstance(v, torch.Tensor):
        return v.to(dtype=x.dtype, device=x.device)
    return torch.full((), float(v), dtype=x.dtype, device=x.device)


def pad_index(n: int, lo: int, hi: int, pad_mode: str,
              device) -> torch.Tensor:
    """Source indices of an axis of length n padded by (lo, hi), by numpy's
    rules for any pad width: edge clamps, wrap is i mod n, symmetric
    reflects with the edge sample duplicated (period 2n), reflect without
    it (period 2n - 2). The host twin of ``csrc/stencil_tile.cuh``
    ``map_index``, which has no reflect: that mode is only ever padded on
    the host (``scipy_compat``'s ``mode="mirror"``)."""
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


def pad_last(x: torch.Tensor, n: int, pad_mode: Optional[str]) -> torch.Tensor:
    """The last axis padded by n on each side: zeros (``pad_mode`` None) or
    ``jnp.pad``'s ``pad_mode`` for any pad width."""
    if pad_mode is None:
        return F.pad(x, (n, n))
    return x.index_select(-1, pad_index(x.shape[-1], n, n, pad_mode,
                                        x.device))


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
    the n trailing ones from the last window, then ``* dt_inv``."""
    ws = 2 * n + 1
    N = x.shape[-1]
    center = correlate_valid_plain(x, center_w)
    ew = edge_w.to(x.dtype)
    lead = _edge_sums(ew, x[..., :ws].flip(-1)) * lead_sign
    trail = _edge_sums(ew, x[..., N - ws:]).flip(-1)
    y = torch.cat([lead, center, trail], dim=-1)
    return y * scalar_like(dt_inv, x)


def savgol_padded_plain(x: torch.Tensor, center_w: torch.Tensor,
                        pad_mode: str, n: int, dt_inv=1.0) -> torch.Tensor:
    """Same-length REFLECT / PERIODIC / CONSTANT apply along the last axis
    (counterpart of ``xla_twin`` in ``savgol_tpu.ops.apply._pallas_pad_diff``):
    pad by n in ``pad_mode`` ("symmetric" / "wrap" / "edge"), the VALID
    correlation, then ``* dt_inv``."""
    if pad_mode not in ("symmetric", "wrap", "edge"):
        raise ValueError(f"unsupported pad mode {pad_mode!r}")
    y = correlate_valid_plain(pad_last(x, int(n), pad_mode), center_w)
    return y * scalar_like(dt_inv, x)


def _check_cuda_input(x: torch.Tensor, name: str) -> None:
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: the kernel takes float32 or float64, "
                        f"got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: the kernel needs a contiguous input")
    if x.dim() < 1:
        raise ValueError(f"{name}: input must have at least one axis")


def _weights_on(w: torch.Tensor, x: torch.Tensor, name: str) -> torch.Tensor:
    if w.device != x.device:
        raise ValueError(f"{name}: weights on {w.device}, input on "
                         f"{x.device}")
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
    _check_cuda_input(x, name)
    n = int(n)
    ws = 2 * n + 1
    N = x.shape[-1]
    if n < 1 or ws > _MAX_WS:
        raise ValueError(f"{name}: half window must be in [1, "
                         f"{_MAX_WS // 2}], got {n}")
    if tuple(center_w.shape) != (ws,) or tuple(edge_w.shape) != (n, ws):
        raise ValueError(f"{name}: weights of shape {tuple(center_w.shape)} "
                         f"and {tuple(edge_w.shape)} do not match n={n}")
    if N < ws:
        raise ValueError(f"data length ({N}) must be >= window size ({ws})")
    dt = scalar_like(dt_inv, x)
    w = (_weights_on(center_w, x, name) * dt).contiguous()
    ew = (_weights_on(edge_w, x, name) * dt).contiguous()
    out = torch.empty_like(x)
    B = x.numel() // N
    if B == 0:
        return out
    lib = library()
    fn = lib.sg1d_poly_f32 if x.dtype == torch.float32 else lib.sg1d_poly_f64
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), ew.data_ptr(), out.data_ptr(),
                 B, N, n, float(lead_sign),
                 torch.cuda.current_stream().cuda_stream)
    _raise_on_error(err, name)
    LAUNCHES["sg1d_poly"] += 1
    return out


def savgol_padded_cuda(x: torch.Tensor, center_w: torch.Tensor,
                       pad_mode: str, n: int, dt_inv=1.0) -> torch.Tensor:
    """Same-length REFLECT / PERIODIC / CONSTANT apply along the last axis
    of ``x`` (..., N), ``pad_mode`` "symmetric" / "wrap" / "edge".

    CUDA tensor: kernel K2 (``csrc/sg1d_poly.cu``, the counterpart of
    ``savgol_padded_pallas_mxu``), which maps the virtual samples while it
    stages its edge tiles, so no padded copy is made; ``dt_inv`` folded
    into the taps as K1 does. There is no fallback: any B >= 1, N >= ws and
    1 <= n <= 64 launches. CPU tensor: :func:`savgol_padded_plain`.
    """
    name = "savgol_padded_cuda"
    if not _plain_or_cuda(x, name):
        return savgol_padded_plain(x, center_w, pad_mode, n, dt_inv)
    _check_cuda_input(x, name)
    n = int(n)
    ws = 2 * n + 1
    N = x.shape[-1]
    if pad_mode not in ("symmetric", "wrap", "edge"):
        raise ValueError(f"{name}: unsupported pad mode {pad_mode!r}")
    if n < 1 or ws > _MAX_WS:
        raise ValueError(f"{name}: half window must be in [1, "
                         f"{_MAX_WS // 2}], got {n}")
    if tuple(center_w.shape) != (ws,):
        raise ValueError(f"{name}: weights of shape {tuple(center_w.shape)} "
                         f"do not match n={n}")
    if N < ws:
        raise ValueError(f"data length ({N}) must be >= window size ({ws})")
    w = (_weights_on(center_w, x, name) * scalar_like(dt_inv, x)).contiguous()
    out = torch.empty_like(x)
    B = x.numel() // N
    if B == 0:
        return out
    lib = library()
    fn = lib.sg1d_pad_f32 if x.dtype == torch.float32 else lib.sg1d_pad_f64
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), B, N, n,
                 MODE_CODE[pad_mode], torch.cuda.current_stream().cuda_stream)
    _raise_on_error(err, name)
    LAUNCHES["sg1d_pad"] += 1
    return out


def correlate_valid_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """VALID correlation along the last axis of ``x`` (..., N); output
    (..., N - len(w) + 1).

    CUDA tensor: kernel K3 (``csrc/corr1d_valid.cu``) on the current stream,
    no synchronisation. CPU tensor: :func:`correlate_valid_plain`.
    """
    name = "correlate_valid_cuda"
    if not _plain_or_cuda(x, name):
        return correlate_valid_plain(x, w)
    _check_cuda_input(x, name)
    if w.dim() != 1 or not 1 <= w.shape[0] <= _MAX_WS:
        raise ValueError(f"{name}: taps must be 1D with 1..{_MAX_WS} "
                         f"entries, got shape {tuple(w.shape)}")
    ws = w.shape[0]
    N = x.shape[-1]
    if N < ws:
        raise ValueError(f"data length ({N}) must be >= window size ({ws})")
    wc = _weights_on(w, x, name).contiguous()
    out = torch.empty(x.shape[:-1] + (N - ws + 1,), dtype=x.dtype,
                      device=x.device)
    B = x.numel() // N
    if B == 0:
        return out
    lib = library()
    fn = (lib.corr1d_valid_f32 if x.dtype == torch.float32
          else lib.corr1d_valid_f64)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), wc.data_ptr(), out.data_ptr(), B, N, ws,
                 torch.cuda.current_stream().cuda_stream)
    _raise_on_error(err, name)
    LAUNCHES["corr1d_valid"] += 1
    return out
