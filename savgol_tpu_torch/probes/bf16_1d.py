"""P3: attribution of K3-bf16, the bf16 VALID 1D correlation on the
tensor-core tile of ``csrc/sg1d_bf16.cuh`` (``corr1d_valid_bf16`` on bf16
storage), the counterpart of ``benchmarks/probe_bf16_1d.py``.

Three bf16-in / bf16-out kernels (``csrc/probe_bf16_1d.cu``), each K3-bf16's
kernel on its own schedule and pieces with one cost term removed:

  * ``copy``: stage a tile's own samples, no halo, and store them back
    (``out = x``): the staging ring's bytes and the store path;
  * ``shift_only``: stage a tile and its halo as K3-bf16 does and store
    ``out[j] = x[j + n]`` over the VALID length (n = ws // 2) straight from
    the staging buffer: staging, halo and shifted stores, no products;
  * ``taps_only``: K3-bf16's tensor-core products and their round trip
    through shared memory with the halo not loaded; its slots hold the
    tile's own first samples, so
    ``out[j] = sum_k w[k] * x[t0 + ((j - t0 + k) mod T)]`` for the tile of
    width T = :data:`TILE` that starts at t0 (samples past N are zero). The
    values are wrong by design and the cost is right, as the TPU probe's
    ``mm_only``.

So K3-bf16 - ``taps_only`` is the halo's loads, ``taps_only`` -
``shift_only`` the products and the round trip, ``shift_only`` - ``copy``
the halo and the shifted stores, and ``copy`` against the bound the ring's
floor.

The probes take finite input (a tile's non-finite flag is computed as in
K3-bf16, but no tile is recomputed from its windows) and rows that start
on 16-byte boundaries (N a multiple of 8, an aligned base), so that each
row's tiles start at multiples of T.

:func:`probe_cuda` launches one on a CUDA tensor (and raises for any other
device); :func:`probe_plain` states each variant's values in plain
PyTorch. :func:`measure` holds each kernel against its plain version at a
shape and times it beside K3-bf16, its bound and the PyTorch call that
computes the same function, and traces one ``apply_valid(method="bf16")``
call, naming the device operations around K3-bf16.

    python -m savgol_tpu_torch.probes.bf16_1d [--quick]

runs :func:`measure` at the 1D headline, (128, 1,048,576) bf16 samples and
the 25 taps of ``SavgolConfig(12, 4)`` (``--quick``: 16 rows), on the card.
"""

from __future__ import annotations

import argparse
import json
import tempfile

import torch

from savgol_tpu_torch._build import BUILD_DIR, library
from savgol_tpu_torch.ops.cuda_conv import (_enqueue, bf16_taps,
                                            bf16_ulp_gate)

__all__ = ["LAUNCHES", "TILE", "VARIANTS", "reset_launches", "probe_cuda",
           "probe_plain", "device_ops", "measure"]

LAUNCHES = {"probe_bf16_1d": 0}
VARIANTS = ("copy", "shift_only", "taps_only")
# The probes' tile width, K3-bf16's (csrc/sg1d_bf16.cuh kTile = 256 kMT
# kWarps); the wrapper checks it against the library's before a launch
TILE = 8192
_MAX_WS = 129     # K3-bf16's windows (csrc/stencil_tile.cuh kMaxWs)


def reset_launches() -> None:
    LAUNCHES["probe_bf16_1d"] = 0


def _n_out(N: int, ws: int, variant: str) -> int:
    return N if variant == "copy" else N - ws + 1


def probe_plain(x: torch.Tensor, w: torch.Tensor, variant: str,
                tile: int = TILE) -> torch.Tensor:
    """The values of ``variant`` for ``x`` (..., N) and taps ``w`` (ws,),
    as the kernel computes them: bf16 samples and taps, float32 sums in tap
    order, outputs rounded to bf16; in bf16."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got "
                         f"{variant!r}")
    xs = x.to(torch.bfloat16)
    ws = w.shape[-1]
    N = xs.shape[-1]
    if variant == "copy":
        return xs.clone()
    n_out = _n_out(N, ws, variant)
    if variant == "shift_only":
        n = ws // 2
        return xs[..., n:n + n_out].clone()
    j = torch.arange(n_out, device=x.device)
    t0 = j // tile * tile
    xf = torch.nn.functional.pad(xs.float(), (0, tile))   # zeros past N
    taps = bf16_taps(w)
    out = None
    for k in range(ws):
        src = torch.minimum(t0 + (j - t0 + k) % tile,
                            torch.full_like(j, N))       # N reads a zero
        term = xf[..., src] * taps[k]
        out = term if out is None else out + term
    return out.to(torch.bfloat16)


def probe_cuda(x: torch.Tensor, w: torch.Tensor,
               variant: str) -> torch.Tensor:
    """``variant`` on a contiguous bf16 CUDA tensor ``x`` (..., N) whose
    rows start on 16-byte boundaries, with taps ``w`` (ws <= 129, read by
    ``taps_only``), one launch on the current stream; raises for anything
    else (there is no CPU route: the probes measure the card)."""
    name = "probe_bf16_1d"
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got "
                         f"{variant!r}")
    N = x.shape[-1]
    if N % 8 or x.data_ptr() % 16:
        raise ValueError(f"{name}: rows must start on 16-byte boundaries (N "
                         f"a multiple of 8, an aligned base); got N = {N} "
                         f"at {x.data_ptr():#x}")
    if x.device.type != "cuda" or x.dtype != torch.bfloat16 \
            or not x.is_contiguous():
        raise ValueError(f"{name}: needs a contiguous bf16 CUDA tensor, got "
                         f"{x.dtype} on {x.device}")
    ws = w.shape[-1]
    if w.dim() != 1 or not 1 <= ws <= _MAX_WS or N < ws:
        raise ValueError(f"{name}: taps must be 1D with 1..{_MAX_WS} "
                         f"entries, at most N = {N}; got {tuple(w.shape)}")
    lib = library()
    if lib.probe_bf16_1d_tile() != TILE:
        raise RuntimeError(f"{name}: the library's tile is "
                           f"{lib.probe_bf16_1d_tile()}, not {TILE}")
    wc = bf16_taps(w.to(x.device)).contiguous()
    out = torch.empty(x.shape[:-1] + (_n_out(N, ws, variant),),
                      dtype=x.dtype, device=x.device)
    B = x.numel() // N
    if B == 0:
        return out
    _enqueue(name, LAUNCHES, name, x.device, "probe_bf16_1d", x.data_ptr(),
             wc.data_ptr(), out.data_ptr(), B, N, ws, VARIANTS.index(variant))
    return out


def device_ops(call) -> list:
    """``call()`` once more after one untimed call, traced with
    ``utils.profiling.trace_events``: [name, ms] of each operation the card
    ran for it (kernels, copies, fills), in the order they started."""
    from savgol_tpu_torch.utils.profiling import device_events, trace_events

    def run():
        call()
        torch.cuda.synchronize()

    run()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as log:
        events, _ = trace_events(run, log)
    return [[e["name"], e["dur"] / 1e3] for e in device_events(events)]


def measure(x: torch.Tensor, w: torch.Tensor) -> list:
    """Each variant against :func:`probe_plain` (``copy`` and
    ``shift_only`` bit for bit, ``taps_only`` within one bf16 ulp: the
    tensor cores sum in another order) and its time, with K3-bf16
    (``correlate_valid_bf16_cuda``) beside them, on the bf16 CUDA tensor
    ``x`` (B, N). ``library_ms`` is the one PyTorch call that computes the
    same function, timed only: ``Tensor.clone`` for ``copy``, the
    contiguous copy of the shifted slice for ``shift_only``, none for
    ``taps_only`` and, for K3-bf16, ``F.conv1d`` on bf16 (cuDNN) as
    :func:`cudnn_ms` times it, the 1D correlation also as a (1, ws)
    ``F.conv2d`` on channels_last tensors (the least time; the default
    pick's as ``library_default_ms``). K3-bf16's record also carries
    ``apply_valid_ops``: :func:`device_ops` of one
    ``savgol_apply_valid(x, w, method="bf16")`` call with ``dt_inv`` a
    0-dim f32 tensor of 1, as ``Savgol1D.apply_valid`` makes it, each
    printed. Returns one record a kernel."""
    from savgol_tpu_torch.ops.apply import savgol_apply_valid
    from savgol_tpu_torch.ops.cuda_conv import (correlate_valid_bf16_cuda,
                                                correlate_valid_bf16_plain)
    from savgol_tpu_torch.utils.roofline import (speed_of_light_1d,
                                                 speed_of_light_valid_1d)
    from savgol_tpu_torch.utils.timing import cudnn_ms, device_ms

    B, N = x.shape
    ws = w.shape[0]
    n, n_out = ws // 2, N - ws + 1
    runs = {v: (lambda v=v: probe_cuda(x, w, v),
                lambda v=v: probe_plain(x, w, v)) for v in VARIANTS}
    runs["K3-bf16"] = (lambda: correlate_valid_bf16_cuda(x, w),
                       lambda: correlate_valid_bf16_plain(x, w))
    # the copy writes every sample, the others their VALID outputs; bytes
    # bound all four (a copy's bound is a same-length apply's)
    lims = {v: (speed_of_light_1d if v == "copy" else speed_of_light_valid_1d)(
        x.shape, dtype=x.dtype, method="bf16", half_window=n).fields
        for v in runs}
    x3 = x.view(B, 1, N)
    w3 = bf16_taps(w.to(x.device)).to(torch.bfloat16).view(1, 1, ws)
    cl = torch.channels_last
    x4 = x3.unsqueeze(2).contiguous(memory_format=cl)
    w4 = w3.unsqueeze(2).contiguous(memory_format=cl)
    conv = cudnn_ms(lambda: torch.nn.functional.conv1d(x3, w3),
                    lambda: torch.nn.functional.conv2d(x4, w4))
    del x4
    lib = {"copy": device_ms(x.clone),
           "shift_only": device_ms(
               lambda: x[..., n:n + n_out].contiguous()),
           "taps_only": None, "K3-bf16": conv["best"]}
    recs = []
    for name, (kernel, plain) in runs.items():
        got, want = kernel().double(), plain().double()
        err = (got - want).abs()
        ok = bool((err <= bf16_ulp_gate(want)).all())
        if name in ("copy", "shift_only"):
            ok = ok and bool(torch.equal(got, want))
        del got, want
        if not ok:
            raise RuntimeError(f"P3 {name} disagrees with its plain version: "
                               f"max {err.max().item():.3e}")
        recs.append({"name": name, "max_abs_err": err.max().item(),
                     "ms": device_ms(kernel),
                     "plain_ms": device_ms(plain, warmup=1, reps=3),
                     **lims[name], "library_ms": lib[name],
                     "library_default_ms": (conv["default"]
                                            if name == "K3-bf16" else None)})
        del err
    dt = torch.ones((), dtype=torch.float32, device=x.device)
    ops = device_ops(lambda: savgol_apply_valid(
        x, w, half_window=n, dt_inv=dt, method="bf16"))
    for op, ms in ops:
        print(f"apply_valid(method='bf16') device op: {ms:.4f} ms "
              f"{op[:160]}")
    recs[-1]["apply_valid_ops"] = ops
    return recs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="16 rows instead of 128")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("the probes time the card: no CUDA device")
    import numpy as np

    from savgol_tpu_torch.config import SavgolConfig
    from savgol_tpu_torch.ops.weights import savgol_weights_np
    B, N = (16 if args.quick else 128), 1 << 20
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(B, N, generator=g, device="cuda").to(torch.bfloat16)
    w = torch.from_numpy(savgol_weights_np(SavgolConfig(12, 4),
                                           np.float64)[0]).cuda()
    print(torch.cuda.get_device_name(0))
    for r in measure(x, w):
        print(json.dumps(r))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
