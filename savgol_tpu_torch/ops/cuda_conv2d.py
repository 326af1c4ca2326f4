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

``correlate2d_valid_bf16_cuda`` / ``_plain`` are ``method="bf16"``: K2D-dense
in its bf16 mode (``csrc/corr2d_bf16_mma.cu``, on the tensor cores), the
counterpart of the row-banded MXU kernels on bf16 operands at single-pass
precision. Samples and taps are rounded to bf16, products are exact and
summed in f32; f32 input gets the f32 sums unrounded, any other dtype the
sums rounded to bf16 (in its own dtype), as the JAX package's wrappers emit
them. :func:`row_bands` states the band matrices that kernel multiplies.
The bf16 kernel counts its launches under ``corr2d_valid``.

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
from savgol_tpu_torch.ops.cuda_conv import (MODE_CODE, _bf16_operand,
                                            _check_bf16_input,
                                            _check_cuda_input, _launch,
                                            _operands, _plain_or_cuda,
                                            bf16_taps, pad_index)

__all__ = [
    "LAUNCHES",
    "reset_launches",
    "pad2d_plain",
    "correlate2d_valid_plain",
    "correlate2d_valid_cuda",
    "correlate2d_sep_plain",
    "correlate2d_sep_cuda",
    "correlate2d_valid_bf16_plain",
    "correlate2d_valid_bf16_cuda",
    "row_bands",
    "sep_instance",
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
    # C order, so that the kernel takes them without a copy a call
    return (np.ascontiguousarray((U[:, :r] * sq).T),
            np.ascontiguousarray(Vt[:r, :] * sq[:, None]))


def _out_size(x: torch.Tensor, H: int, W: int, pad_mode) -> tuple[int, int]:
    """Output (rows, cols) of the correlation; raises for what neither
    version takes. A VALID image smaller than the stencil on an axis has no
    output along it (0 rows or columns), as in the JAX package."""
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
    return max(0, R - H + 1), max(0, C - W + 1)


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


def _geometry(x: torch.Tensor, H: int, W: int, pad_mode, name: str,
              check=_check_cuda_input):
    """(B, R, C, R', C') for a kernel launch; raises for what the kernels
    do not take (``check``: the input's dtype and layout)."""
    check(x, name)
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


def _k2d_dense(name: str, x: torch.Tensor, w: torch.Tensor, pad_mode,
               bf16: bool) -> torch.Tensor:
    """K2D-dense's checks and launch in either mode."""
    if w.dim() not in (2, 3):
        raise ValueError(f"{name}: stencils must be (H, W) or (K, H, W), "
                         f"got shape {tuple(w.shape)}")
    K = 1 if w.dim() == 2 else w.shape[0]
    H, W = w.shape[-2:]
    B, R, C, Ro, Co = _geometry(x, H, W, pad_mode, name,
                                _check_bf16_input if bf16
                                else _check_cuda_input)
    xs, (wc,), restore = _operands(x, (w,), None, bf16, name)
    stack = (K,) if w.dim() == 3 else ()
    out = torch.empty(x.shape[:-2] + stack + (Ro, Co), dtype=xs.dtype,
                      device=x.device)
    if B > 0 and K > 0 and Ro > 0 and Co > 0:
        _launch(name, LAUNCHES, "corr2d_valid", "corr2d_valid", xs, bf16,
                xs.data_ptr(), wc.data_ptr(), out.data_ptr(), B, R, C, K, H,
                W, MODE_CODE[pad_mode])
    return out if restore is None else out.to(restore)


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
    return _k2d_dense(name, x, w, pad_mode, False)


def sep_instance(H: int, W: int, rank: int, dtype=torch.float32) -> str:
    """Which K2D-sep instance a launch of an H x W stencil of this rank
    runs, as ``csrc/corr2d_sep.cu`` decides it (``corr2d_sep_instance``):
    ``"tile"`` (the 64 x 64 tiles), ``"sweep"`` (the column-strip sweep at
    runtime widths) or ``"sweep HxW"`` (a compile-time width). Builds the
    kernel library."""
    code = library().corr2d_sep_instance(
        int(H), int(W), int(rank), torch.empty((), dtype=dtype).element_size())
    if code < 0:
        raise ValueError(f"sep_instance: K2D-sep takes no {H} x {W} stencil "
                         f"of rank {rank} in {dtype}")
    return {0: "tile", 1: "sweep"}.get(code, f"sweep {code}x{code}")


def correlate2d_sep_cuda(x: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                         pad_mode=None) -> torch.Tensor:
    """Separable 2D correlation of ``x`` (..., R, C) with the stencil
    ``sum_k outer(u[k], v[k])``, ``u`` (r, H) and ``v`` (r, W); output
    (..., R', C').

    CUDA tensor: kernel K2D-sep (``csrc/corr2d_sep.cu``, the instance
    :func:`sep_instance` names) on the current stream, no
    synchronisation. CPU tensor: :func:`correlate2d_sep_plain`.
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
    _, (uc, vc), _ = _operands(x, (u, v), None, False, name)
    out = torch.empty(x.shape[:-2] + (Ro, Co), dtype=x.dtype,
                      device=x.device)
    if B > 0 and Ro > 0 and Co > 0:
        _launch(name, LAUNCHES, "corr2d_sep", "corr2d_sep", x, False,
                x.data_ptr(), uc.data_ptr(), vc.data_ptr(), out.data_ptr(),
                B, R, C, rank, H, W, MODE_CODE[pad_mode])
    return out


def correlate2d_valid_bf16_plain(x: torch.Tensor, w: torch.Tensor,
                                 pad_mode=None) -> torch.Tensor:
    """``method="bf16"`` dense 2D correlation, laid out as
    :func:`correlate2d_valid_plain` (counterpart of
    ``correlate2d_valid_pallas_rowmxu`` / ``savgol2d_same_pallas_rowmxu`` /
    ``correlate2d_valid_pallas_rowmxu_stack`` on bf16 operands at DEFAULT
    precision): bf16 samples and taps, float32 sums; f32 input gets the
    sums, any other dtype the sums rounded to bf16, in its dtype."""
    y = correlate2d_valid_plain(_bf16_operand(x), bf16_taps(w), pad_mode)
    if x.dtype == torch.float32:
        return y
    return y.to(torch.bfloat16).to(x.dtype)


def row_bands(w: torch.Tensor, depth: int) -> torch.Tensor:
    """The band matrices of the bf16 tensor-core kernel: for stencils ``w``
    (..., H, W), ``B[..., y, q, p] = w[..., y, q - p]`` where ``0 <= q - p <
    W``, else 0, for ``q < depth`` and ``p < 16``; shape (..., H, depth, 16).
    A 16-column block of outputs at (r, c) is then ``sum_y X[r + y : r + y
    + 16, c : c + depth] @ B[..., y]`` (``csrc/corr2d_bf16_mma.cu``; the
    first ``depth`` rows and 16 columns of ``savgol_tpu.ops.pallas_conv.
    _rowband_matrices``)."""
    W = w.shape[-1]
    d = (torch.arange(depth, device=w.device)[:, None]
         - torch.arange(16, device=w.device)[None, :])
    inside = (d >= 0) & (d < W)
    bands = w[..., d.clamp(0, W - 1)]
    return torch.where(inside, bands, torch.zeros((), dtype=w.dtype,
                                                  device=w.device))


def band_depth(W: int) -> int:
    """The kernel's band depth for a stencil ``W`` wide: whole 16-column
    chunks holding the 15 + W input columns of 16 outputs."""
    return 16 * ((W + 30) // 16)


def correlate2d_valid_bf16_cuda(x: torch.Tensor, w: torch.Tensor,
                                pad_mode=None) -> torch.Tensor:
    """``method="bf16"`` dense 2D correlation of ``x`` (..., R, C) with
    ``w`` (K, H, W) or (H, W).

    CUDA tensor: kernel K2D-dense in its bf16 mode (``corr2d_valid_bf16``,
    ``csrc/corr2d_bf16_mma.cu``: ``mma.sync`` on :func:`row_bands`), one
    launch that reads f32 or bf16 storage once for all K stencils (other
    dtypes go through bf16 and come back). CPU tensor:
    :func:`correlate2d_valid_bf16_plain`.
    """
    name = "correlate2d_valid_bf16_cuda"
    if not _plain_or_cuda(x, name):
        return correlate2d_valid_bf16_plain(x, w, pad_mode)
    return _k2d_dense(name, x, w, pad_mode, True)
