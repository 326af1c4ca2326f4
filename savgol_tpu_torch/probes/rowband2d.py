"""P2: attribution of the bf16 dense 2D correlation (kernel K2D-dense in
its bf16 mode), the counterpart of ``benchmarks/probe_rowmxu.py``.

The TPU probe's variants each removed one cost term of its row-banded
matrix-unit kernel. Each variant here keeps its purpose, removing one cost
term of K2D-dense-bf16:

  * ``A_lib``: K2D-dense-bf16 itself (``correlate2d_valid_bf16_cuda``, the
    row-band products on the tensor cores, ``csrc/corr2d_bf16_mma.cu``);
  * ``B_alignctl``: the CUDA-core tiles, staging and FMAs that the bf16
    mode ran on before its tensor-core kernel, with every stencil row
    reading the output's own staged row, ``out[r, c] = sum_y sum_x w[y, x]
    * X[r, c + x]`` (``csrc/probe_rowband2d.cu``): wrong values by design,
    the cost of walking the H staged rows removed. Against ``A_lib`` it now
    compares two designs, not one kernel with and without a cost;
  * ``C_inshift``: ``A_lib`` on this card, where the kernel already shifts
    on the input side (``ldmatrix`` row addresses); no kernel of its own;
  * ``C_wh1``: ``A_lib`` on the stencil's first row alone (1 x W), the same
    tiles with 1/H of the products: the per-tile fixed cost.

X is the image (VALID) or the image extended by the pad mode, as in
K2D-dense. :func:`variant_cuda` runs one on a CUDA tensor;
:func:`variant_plain` states its values in plain PyTorch. :func:`measure`
holds each against its plain version and times it beside ``F.conv2d`` on
bf16 and its bound.

    python -m savgol_tpu_torch.probes.rowband2d [--quick]

runs :func:`measure` at the 2D headline, (16, 2048, 2048) bf16 images, the
11 x 11 order-3 stencil, CONSTANT (``--quick``: 2 images), on the card.
"""

from __future__ import annotations

import argparse
import json

import torch

from savgol_tpu_torch._build import library
from savgol_tpu_torch.ops.cuda_conv import (MODE_CODE, _bf16_operand,
                                            _bf16_storage, _check_bf16_input,
                                            _raise_on_error, bf16_taps,
                                            bf16_ulp_gate)
from savgol_tpu_torch.ops.cuda_conv2d import (_geometry, _padded,
                                              correlate2d_valid_bf16_cuda,
                                              correlate2d_valid_bf16_plain)

__all__ = ["LAUNCHES", "VARIANTS", "reset_launches", "alignctl_cuda",
           "alignctl_plain", "variant_cuda", "variant_plain", "measure"]

LAUNCHES = {"probe_rowband2d": 0}
VARIANTS = ("A_lib", "B_alignctl", "C_inshift", "C_wh1")


def reset_launches() -> None:
    LAUNCHES["probe_rowband2d"] = 0


def alignctl_plain(x: torch.Tensor, w: torch.Tensor,
                   pad_mode=None) -> torch.Tensor:
    """``B_alignctl``'s values: ``out[..., r, c] = sum_y sum_x w[y, x] *
    X[..., r, c + x]`` with X the bf16 image as K2D-dense extends it, bf16
    taps, f32 sums; out as ``correlate2d_valid_bf16_plain`` shapes and
    rounds it."""
    H, W = w.shape
    xp = _padded(_bf16_operand(x), H, W, pad_mode)
    Ro = xp.shape[-2] - H + 1
    Co = xp.shape[-1] - W + 1
    taps = bf16_taps(w)
    out = None
    for y in range(H):
        for c in range(W):
            term = xp[..., 0:Ro, c:c + Co] * taps[y, c]
            out = term if out is None else out + term
    if x.dtype == torch.float32:
        return out
    return out.to(torch.bfloat16).to(x.dtype)


def alignctl_cuda(x: torch.Tensor, w: torch.Tensor,
                  pad_mode=None) -> torch.Tensor:
    """``B_alignctl`` on a CUDA tensor ``x`` (..., R, C), f32 or bf16
    storage (other dtypes through bf16), ``w`` (H, W); one launch. Raises
    for a tensor that is not on the card."""
    name = "alignctl_cuda"
    if x.device.type != "cuda":
        raise ValueError(f"{name}: the probes measure the card; got a "
                         f"tensor on {x.device}")
    if w.dim() != 2:
        raise ValueError(f"{name}: one (H, W) stencil, got "
                         f"{tuple(w.shape)}")
    H, W = w.shape
    B, R, C, Ro, Co = _geometry(x, H, W, pad_mode, name, _check_bf16_input)
    wc = bf16_taps(w.to(x.device)).contiguous()
    xs, restore = _bf16_storage(x)
    out = torch.empty(x.shape[:-2] + (Ro, Co), dtype=xs.dtype,
                      device=x.device)
    if B > 0:
        with torch.cuda.device(x.device):
            err = library().probe_rowband2d(
                xs.data_ptr(), wc.data_ptr(), out.data_ptr(), B, R, C, H, W,
                MODE_CODE[pad_mode], int(xs.dtype == torch.bfloat16),
                torch.cuda.current_stream().cuda_stream)
        _raise_on_error(err, name)
        LAUNCHES["probe_rowband2d"] += 1
    return out if restore is None else out.to(restore)


def _check(name: str) -> None:
    if name not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {name!r}")


def variant_cuda(name: str, x: torch.Tensor, w: torch.Tensor,
                 pad_mode=None) -> torch.Tensor:
    """Variant ``name`` on the card (A_lib, C_inshift and C_wh1 launch
    K2D-dense-bf16, B_alignctl the probe kernel)."""
    _check(name)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: the probes measure the card; got a "
                         f"tensor on {x.device}")
    if name == "B_alignctl":
        return alignctl_cuda(x, w, pad_mode)
    return correlate2d_valid_bf16_cuda(x, w[:1] if name == "C_wh1" else w,
                                       pad_mode)


def variant_plain(name: str, x: torch.Tensor, w: torch.Tensor,
                  pad_mode=None) -> torch.Tensor:
    """The plain version of variant ``name``."""
    _check(name)
    if name == "B_alignctl":
        return alignctl_plain(x, w, pad_mode)
    return correlate2d_valid_bf16_plain(x, w[:1] if name == "C_wh1" else w,
                                        pad_mode)


def measure(x: torch.Tensor, w: torch.Tensor, pad_mode="edge") -> list:
    """A_lib, B_alignctl and C_wh1 (C_inshift is A_lib here) against their
    plain versions on the first image (f32 output within 2e-6 scaled, bf16
    output within one bf16 ulp: B_alignctl sums in another order) and their
    times on the whole batch ``x`` (B, R, C), with ``F.conv2d`` on bf16
    (cuDNN, zero padding, timed only, as :func:`cudnn_ms` times it: the
    least time as ``library_ms``, the default pick's as
    ``library_default_ms``) beside ``A_lib``. The bound counts the FMAs at
    the bf16 tensor-core peak; ``cuda_core_ms`` is the same FMAs at the
    f32 peak of the CUDA cores, which ``B_alignctl`` runs on. Returns one
    record a variant."""
    from savgol_tpu_torch.utils.roofline import speed_of_light_2d
    from savgol_tpu_torch.utils.timing import cudnn_ms, device_ms

    H, W = w.shape
    wb = bf16_taps(w.to(x.device)).to(torch.bfloat16)
    x4 = x.to(torch.bfloat16).unsqueeze(1)
    w4 = wb.view(1, 1, H, W)
    cl = torch.channels_last
    x4c, w4c = (t.contiguous(memory_format=cl) for t in (x4, w4))
    lib = cudnn_ms(
        lambda: torch.nn.functional.conv2d(x4, w4, padding=(H // 2, W // 2)),
        lambda: torch.nn.functional.conv2d(x4c, w4c,
                                           padding=(H // 2, W // 2)))
    del x4c
    recs = []
    for name in ("A_lib", "B_alignctl", "C_wh1"):
        got = variant_cuda(name, x[:1], w, pad_mode).double()
        want = variant_plain(name, x[:1], w, pad_mode).double()
        diff = (got - want).abs()
        gate = (2e-6 * max(1.0, want.abs().max().item())
                if x.dtype == torch.float32 else bf16_ulp_gate(want))
        err = diff.max().item()
        if not bool((diff <= gate).all()):
            raise RuntimeError(f"P2 {name} disagrees with its plain version:"
                               f" {err:.3e}")
        # C_wh1 runs the stencil's first row only
        rows = 1 if name == "C_wh1" else H
        tensor_cores = speed_of_light_2d(rows, shape=x.shape, dtype=x.dtype,
                                         method="bf16", window_w=W)
        cuda_cores = speed_of_light_2d(rows, shape=x.shape, dtype=x.dtype,
                                       window_w=W)
        recs.append({
            "name": name, "max_abs_err": err,
            "ms": device_ms(lambda: variant_cuda(name, x, w, pad_mode)),
            "plain_ms": device_ms(
                lambda: variant_plain(name, x, w, pad_mode), warmup=1,
                reps=3),
            **tensor_cores.fields,
            "cuda_core_ms": cuda_cores.ops_bound_s * 1e3,
            "library_ms": lib["best"] if name == "A_lib" else None,
            "library_default_ms": (lib["default"] if name == "A_lib"
                                   else None)})
    return recs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="2 images instead of 16")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("the probes time the card: no CUDA device")
    import numpy as np

    from savgol_tpu_torch.config import Savgol2DConfig
    from savgol_tpu_torch.ops.weights import savgol2d_weights_np
    B = 2 if args.quick else 16
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(B, 2048, 2048, generator=g, device="cuda").to(
        torch.bfloat16)
    w = torch.from_numpy(savgol2d_weights_np(Savgol2DConfig(5, 5, 3),
                                             np.float64)).cuda()
    print(torch.cuda.get_device_name(0))
    for r in measure(x, w):
        print(json.dumps(r))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
