"""P1: the VALID 1D correlation on a double-buffered pipeline, the
counterpart of ``benchmarks/probe_dma1d.py``.

``corr1d_dma_cuda(x, w, rows=, cols=, n_out=)`` computes
``out[b, j] = sum_k w[k] * x[b, j + k]`` for ``j < n_out`` on a hand-written
kernel (``csrc/probe_dma1d.cu``) that keeps the next tile of ``cols``
outputs in flight by ``cp.async`` while the taps run on the current one: the
TPU probe's question, whether overlapping loads with the taps moves a VALID
correlation toward its byte bound, asked of K3 (``csrc/corr1d_valid.cu``),
which overlaps nothing inside a block. It keeps K3's tap loop and order, so
its outputs are bit-equal to K3's on the same input. ``rows`` and ``cols``
are the JAX call's parameters (``csrc/probe_dma1d.cu`` says how they map to
the grid); ``n_out`` may be less than ``N - ws + 1``.

A CUDA tensor launches the kernel or raises; a CPU tensor takes
:func:`corr1d_dma_plain`, the same function in plain PyTorch. Both check the
JAX call's shape rules (``probe_dma1d.py:159-176``). :func:`measure` holds
the kernel against its plain version and K3 and times it beside K3,
``F.conv1d`` and its bound.

    python -m savgol_tpu_torch.probes.dma1d [--quick]

runs :func:`measure` on the card at the JAX bench's geometry,
(128, 1,048,576 + 128) float32 samples, n_out = 1,048,576 and the 25 taps
of ``SavgolConfig(12, 4)``, with its (rows, cols) variants, then at N =
1,048,576 + 173 (``--quick``: 16 rows).
"""

from __future__ import annotations

import argparse
import json

import torch

from savgol_tpu_torch.ops.cuda_conv import (_MAX_WS, _enqueue,
                                            _plain_or_cuda,
                                            correlate_valid_plain)

__all__ = ["LAUNCHES", "reset_launches", "corr1d_dma_cuda",
           "corr1d_dma_plain", "measure", "GEOMETRIES"]

LAUNCHES = {"corr1d_dma": 0}

# the (rows, cols, B) variants of the JAX bench (probe_dma1d.py:268-269)
GEOMETRIES = ((128, 2048, 128), (128, 4096, 128), (64, 2048, 128),
              (256, 2048, 256))
_LANES = 128
_MAX_COLS = 8192


def reset_launches() -> None:
    LAUNCHES["corr1d_dma"] = 0


def _check(x: torch.Tensor, w: torch.Tensor, rows: int, cols: int,
           n_out: int) -> None:
    if x.dim() != 2:
        raise ValueError(f"corr1d_dma: x must be (B, N), got shape "
                         f"{tuple(x.shape)}")
    B, N = x.shape
    if rows < 1 or B < rows or B % rows != 0:
        raise ValueError(f"B={B} must be a positive multiple of rows={rows}")
    if not (_LANES <= cols <= _MAX_COLS and cols % _LANES == 0):
        raise ValueError(f"cols must be a multiple of {_LANES} in "
                         f"[{_LANES}, {_MAX_COLS}], got {cols}")
    if w.dim() != 1 or not 1 <= w.shape[0] <= _MAX_WS:
        raise ValueError(f"corr1d_dma: taps must be 1D with 1..{_MAX_WS} "
                         f"entries, got shape {tuple(w.shape)}")
    ws = w.shape[0]
    if not 1 <= n_out <= N - ws + 1:
        raise ValueError(f"input too short for n_out={n_out}: N={N} and "
                         f"{ws} taps give at most {N - ws + 1} outputs")


def corr1d_dma_plain(x: torch.Tensor, w: torch.Tensor, *, rows: int,
                     cols: int, n_out: int) -> torch.Tensor:
    """The first ``n_out`` outputs of the VALID correlation of ``x`` (B, N)
    with ``w``: ``correlate_valid_plain(x, w)[:, :n_out]``, after the JAX
    call's checks."""
    _check(x, w, rows, cols, n_out)
    return correlate_valid_plain(x[:, :n_out + w.shape[0] - 1], w)


def corr1d_dma_cuda(x: torch.Tensor, w: torch.Tensor, *, rows: int,
                    cols: int, n_out: int) -> torch.Tensor:
    """P1 on a contiguous float32 CUDA tensor ``x`` (B, N): one launch of
    ``csrc/probe_dma1d.cu`` on the current stream, no synchronisation;
    (B, n_out) out. A CPU tensor takes :func:`corr1d_dma_plain`."""
    name = "corr1d_dma_cuda"
    if not _plain_or_cuda(x, name):
        return corr1d_dma_plain(x, w, rows=rows, cols=cols, n_out=n_out)
    _check(x, w, rows, cols, n_out)
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"{name}: needs a contiguous float32 tensor, got "
                         f"{x.dtype}")
    if w.device != x.device:
        raise ValueError(f"{name}: taps on {w.device}, input on {x.device}")
    wc = w.to(torch.float32).contiguous()
    B, N = x.shape
    out = torch.empty((B, n_out), dtype=x.dtype, device=x.device)
    _enqueue(name, LAUNCHES, "corr1d_dma", x.device, "corr1d_dma_f32",
             x.data_ptr(), wc.data_ptr(), out.data_ptr(), B, N, wc.shape[0],
             n_out, rows, cols)
    return out


def measure(x: torch.Tensor, w: torch.Tensor, n_out: int,
            geometries=((128, 2048),)) -> list:
    """For each (rows, cols): P1 on the float32 CUDA tensor ``x`` (B, N)
    against :func:`corr1d_dma_plain` (within 2e-6 of max(1, max|y|), the
    K1-K4 gate) and bit for bit against K3's first ``n_out`` outputs,
    then its time
    beside the plain version's, K3's (all N - ws + 1 outputs) and
    ``F.conv1d``'s (TF32 off; timed only), and its bound: the B (n_out + ws
    - 1) samples it must read and the B n_out it writes. Returns one record
    a geometry."""
    from savgol_tpu_torch.ops.cuda_conv import correlate_valid_cuda
    from savgol_tpu_torch.utils.roofline import speed_of_light_valid_1d
    from savgol_tpu_torch.utils.timing import device_ms

    B, N = x.shape
    ws = w.shape[0]
    k3_out = correlate_valid_cuda(x, w)[:, :n_out]
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        x3, w3 = x.view(B, 1, N), w.to(x.dtype).view(1, 1, ws)
        lib_ms = device_ms(lambda: torch.nn.functional.conv1d(x3, w3))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    k3_ms = device_ms(lambda: correlate_valid_cuda(x, w))
    lim = speed_of_light_valid_1d((B, n_out + ws - 1),
                                  half_window=ws // 2).fields
    recs = []
    for rows, cols in geometries:
        def run(rows=rows, cols=cols):
            return corr1d_dma_cuda(x, w, rows=rows, cols=cols, n_out=n_out)

        def plain(rows=rows, cols=cols):
            return corr1d_dma_plain(x, w, rows=rows, cols=cols, n_out=n_out)

        got = run()
        want = plain()
        err = (got.double() - want.double()).abs().max().item()
        scale = max(1.0, want.abs().max().item())
        if err > 2e-6 * scale:
            raise RuntimeError(f"P1 rows={rows} cols={cols} B={B} N={N}: "
                               f"{err:.3e} from its plain version")
        if not torch.equal(got, k3_out):
            raise RuntimeError(f"P1 rows={rows} cols={cols} B={B} N={N}: "
                               f"not bit-equal to K3")
        recs.append({"rows": rows, "cols": cols, "B": B, "N": N,
                     "n_out": n_out, "max_abs_err": err, "k3_equal": True,
                     "ms": device_ms(run),
                     "plain_ms": device_ms(plain, warmup=1, reps=3),
                     "k3_ms": k3_ms, **lim, "library_ms": lib_ms})
    return recs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="16 rows instead of 128")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("the probe times the card: no CUDA device")
    import numpy as np

    from savgol_tpu_torch.config import SavgolConfig
    from savgol_tpu_torch.ops.weights import savgol_weights_np
    B = 16 if args.quick else 128
    n_out = 1 << 20
    g = torch.Generator(device="cuda").manual_seed(0)
    w = torch.from_numpy(savgol_weights_np(SavgolConfig(12, 4),
                                           np.float64)[0]).cuda()
    print(torch.cuda.get_device_name(0))
    # the bench's variants at B (rows capped at B), B doubled, unaligned N
    rows128 = list(dict.fromkeys((min(r, B), c) for r, c, b in GEOMETRIES
                                 if b == 128))
    for N, Bx, geoms in ((n_out + 128, B, rows128),
                         (n_out + 128, 2 * B, [(2 * B, 2048)]),
                         (n_out + 173, B, [(B, 2048)])):
        x = torch.randn(Bx, N, generator=g, device="cuda")
        for r in measure(x, w, n_out, geoms):
            print(json.dumps(r))
        del x
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
