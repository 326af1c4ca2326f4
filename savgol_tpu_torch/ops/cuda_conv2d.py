"""The 2D kernels of the port, their plain PyTorch versions and their
launch counts.

``correlate2d_valid_cuda`` (kernel K2D-dense, ``csrc/corr2d_valid.cu``) and
``correlate2d_sep_cuda`` (kernel K2D-sep, ``csrc/corr2d_sep.cu``) are the
counterparts of the 2D half of ``savgol_tpu.ops.pallas_conv``. Both compute
a VALID 2D correlation over the last two axes, either of the image as it is
or of the image extended by the boundary mode (``pad_mode`` "edge",
"symmetric" or "wrap", numpy's names for CONSTANT, REFLECT and PERIODIC).
The kernels map an out-of-range source index themselves while they stage a
tile, so the same-size route makes no padded copy of the image.

As in 1D, each wrapper dispatches on the device of the tensor it is given:
a CPU tensor takes the plain version, a CUDA tensor launches the kernel or
raises. The plain versions are tap loops over shifted slices of an image
padded by ``index_select`` (no ``conv2d``, whose f32 path on the card runs
in TF32, and no ``F.pad``, which has no numpy "symmetric" mode).
"""

from __future__ import annotations

import numpy as np
import torch

from savgol_tpu_torch._build import library
from savgol_tpu_torch.ops.cuda_conv import (MODE_CODE, _check_cuda_input,
                                            _plain_or_cuda, _raise_on_error,
                                            _weights_on, pad_index)

__all__ = [
    "LAUNCHES",
    "reset_launches",
    "pad2d_plain",
    "correlate2d_valid_plain",
    "correlate2d_valid_cuda",
    "correlate2d_sep_plain",
    "correlate2d_sep_cuda",
]

# Kernel launches since the last reset_launches(), one count per wrapper.
# Only the line that launches a kernel adds to its count.
LAUNCHES = {"corr2d_valid": 0, "corr2d_sep": 0}

_MAX_TAPS = 33      # 2 * MAX_HALF_WINDOW_2D + 1: the kernels' staged halo


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _svd_stencil_np(w, rtol: float = 1e-9):
    """(H, W) stencil -> (u (r, H), v (r, W)) with w ~= sum_k outer(u_k, v_k)
    exactly to f64 rounding (r = numerical rank <= order+1)."""
    U, s, Vt = np.linalg.svd(np.asarray(w, dtype=np.float64))
    r = int(np.sum(s > rtol * s[0])) if s[0] > 0 else 1
    r = max(1, r)
    sq = np.sqrt(s[:r])
    return (U[:, :r] * sq).T, (Vt[:r, :] * sq[:, None])


def _out_size(x: torch.Tensor, H: int, W: int, pad_mode) -> tuple[int, int]:
    """Output (rows, cols) of the correlation; raises for what neither
    version takes."""
    if pad_mode not in MODE_CODE:
        raise ValueError(f"unsupported pad mode {pad_mode!r}")
    if x.dim() < 2:
        raise ValueError(f"2D correlation needs an input of at least two "
                         f"axes, got shape {tuple(x.shape)}")
    R, C = x.shape[-2:]
    if pad_mode is not None:
        if R < 1 or C < 1:
            raise ValueError(f"cannot pad an empty image of shape {(R, C)}")
        return R, C
    if R < H or C < W:
        raise ValueError(f"image ({R}, {C}) is smaller than the stencil "
                         f"({H}, {W})")
    return R - H + 1, C - W + 1


def pad2d_plain(x: torch.Tensor, ny: int, nx: int,
                pad_mode: str) -> torch.Tensor:
    """``x`` (..., R, C) extended by ny rows and nx columns on each side,
    equal to ``jnp.pad(x, ..., mode=pad_mode)`` for any pad width."""
    R, C = x.shape[-2:]
    x = x.index_select(-2, pad_index(R, ny, ny, pad_mode, x.device))
    return x.index_select(-1, pad_index(C, nx, nx, pad_mode, x.device))


def _padded(x: torch.Tensor, H: int, W: int, pad_mode) -> torch.Tensor:
    if pad_mode is None:
        return x
    return pad2d_plain(x, (H - 1) // 2, (W - 1) // 2, pad_mode)


def correlate2d_valid_plain(x: torch.Tensor, w: torch.Tensor,
                            pad_mode=None) -> torch.Tensor:
    """``out[..., k, r, c] = sum_{y, x} w[k, y, x] * X[..., r + y, c + x]``
    where X is ``x`` (VALID) or ``x`` padded by ((H-1)/2, (W-1)/2) in
    ``pad_mode`` (counterpart of ``savgol_tpu.ops.apply2d.correlate2d_valid``
    after ``_pad2d``). ``w``: (K, H, W), output (..., K, R', C'); or (H, W),
    output (..., R', C')."""
    H, W = w.shape[-2:]
    Ro, Co = _out_size(x, H, W, pad_mode)
    xp = _padded(x, H, W, pad_mode)
    taps = w.to(x.dtype)
    if w.dim() == 3:                 # taps[y, c]: (K, 1, 1) over (..., 1, R, C)
        xp = xp.unsqueeze(-3)
        taps = taps.permute(1, 2, 0)[..., None, None]
    out = None
    for y in range(H):
        for c in range(W):
            term = xp[..., y:y + Ro, c:c + Co] * taps[y, c]
            out = term if out is None else out + term
    return out


def correlate2d_sep_plain(x: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                          pad_mode=None) -> torch.Tensor:
    """``sum_k colcorr(rowcorr(X, v[k]), u[k])`` for the rank factors ``u``
    (r, H) and ``v`` (r, W) of a stencil (``_svd_stencil_np``), X as in
    :func:`correlate2d_valid_plain`; output (..., R', C')."""
    H, W = u.shape[1], v.shape[1]
    Ro, Co = _out_size(x, H, W, pad_mode)
    xp = _padded(x, H, W, pad_mode)
    u, v = u.to(x.dtype), v.to(x.dtype)
    out = None
    for k in range(u.shape[0]):
        row = xp[..., :, 0:Co] * v[k, 0]
        for c in range(1, W):
            row = row + xp[..., :, c:c + Co] * v[k, c]
        col = row[..., 0:Ro, :] * u[k, 0]
        for y in range(1, H):
            col = col + row[..., y:y + Ro, :] * u[k, y]
        out = col if out is None else out + col
    return out


def _geometry(x: torch.Tensor, H: int, W: int, pad_mode, name: str):
    """(B, R, C, R', C') for a kernel launch; raises for what the kernels
    do not take."""
    _check_cuda_input(x, name)
    if not (H % 2 == 1 and W % 2 == 1 and 1 <= H <= _MAX_TAPS
            and 1 <= W <= _MAX_TAPS):
        raise ValueError(f"{name}: stencil sides must be odd and in "
                         f"[1, {_MAX_TAPS}], got ({H}, {W})")
    Ro, Co = _out_size(x, H, W, pad_mode)
    R, C = x.shape[-2:]
    if R * C >= 2 ** 31:
        raise ValueError(f"{name}: an image of {R} x {C} samples passes the "
                         "kernels' 32-bit in-image indices")
    return x.numel() // (R * C), R, C, Ro, Co


def correlate2d_valid_cuda(x: torch.Tensor, w: torch.Tensor,
                           pad_mode=None) -> torch.Tensor:
    """Dense 2D correlation of ``x`` (..., R, C) with ``w`` (K, H, W) or
    (H, W), as :func:`correlate2d_valid_plain` lays it out.

    CUDA tensor: kernel K2D-dense (``csrc/corr2d_valid.cu``), one launch that
    reads the image once for all K stencils, on the current stream without
    synchronising. CPU tensor: :func:`correlate2d_valid_plain`.
    """
    name = "correlate2d_valid_cuda"
    if not _plain_or_cuda(x, name):
        return correlate2d_valid_plain(x, w, pad_mode)
    if w.dim() not in (2, 3):
        raise ValueError(f"{name}: stencils must be (H, W) or (K, H, W), "
                         f"got shape {tuple(w.shape)}")
    K = 1 if w.dim() == 2 else w.shape[0]
    H, W = w.shape[-2:]
    B, R, C, Ro, Co = _geometry(x, H, W, pad_mode, name)
    ws = _weights_on(w, x, name).contiguous()
    stack = (K,) if w.dim() == 3 else ()
    out = torch.empty(x.shape[:-2] + stack + (Ro, Co), dtype=x.dtype,
                      device=x.device)
    if B == 0 or K == 0:
        return out
    lib = library()
    fn = (lib.corr2d_valid_f32 if x.dtype == torch.float32
          else lib.corr2d_valid_f64)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), ws.data_ptr(), out.data_ptr(), B, R, C, K, H,
                 W, MODE_CODE[pad_mode],
                 torch.cuda.current_stream().cuda_stream)
    _raise_on_error(err, name)
    LAUNCHES["corr2d_valid"] += 1
    return out


def correlate2d_sep_cuda(x: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                         pad_mode=None) -> torch.Tensor:
    """Separable 2D correlation of ``x`` (..., R, C) with the stencil
    ``sum_k outer(u[k], v[k])``, ``u`` (r, H) and ``v`` (r, W); output
    (..., R', C').

    CUDA tensor: kernel K2D-sep (``csrc/corr2d_sep.cu``) on the current
    stream, no synchronisation. CPU tensor: :func:`correlate2d_sep_plain`.
    """
    name = "correlate2d_sep_cuda"
    if not _plain_or_cuda(x, name):
        return correlate2d_sep_plain(x, u, v, pad_mode)
    if (u.dim() != 2 or v.dim() != 2 or u.shape[0] != v.shape[0]
            or not 1 <= u.shape[0] <= _MAX_TAPS):
        raise ValueError(f"{name}: factors must be (r, H) and (r, W) with "
                         f"1 <= r <= {_MAX_TAPS}, got {tuple(u.shape)} and "
                         f"{tuple(v.shape)}")
    rank, H, W = u.shape[0], u.shape[1], v.shape[1]
    B, R, C, Ro, Co = _geometry(x, H, W, pad_mode, name)
    uc = _weights_on(u, x, name).contiguous()
    vc = _weights_on(v, x, name).contiguous()
    out = torch.empty(x.shape[:-2] + (Ro, Co), dtype=x.dtype,
                      device=x.device)
    if B == 0:
        return out
    lib = library()
    fn = (lib.corr2d_sep_f32 if x.dtype == torch.float32
          else lib.corr2d_sep_f64)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), uc.data_ptr(), vc.data_ptr(), out.data_ptr(),
                 B, R, C, rank, H, W, MODE_CODE[pad_mode],
                 torch.cuda.current_stream().cuda_stream)
    _raise_on_error(err, name)
    LAUNCHES["corr2d_sep"] += 1
    return out
