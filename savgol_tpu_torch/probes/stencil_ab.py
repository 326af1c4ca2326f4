"""Times the stencil kernels K4 and K2D-dense of one checkout of this package
on the card, so that two checkouts can be compared in one call, in turns
(parent, change, change, parent):

    python savgol_tpu_torch/probes/stencil_ab.py [--root DIR]

imports ``savgol_tpu_torch`` from DIR (default: the checkout this file is
in), builds its kernels and prints one JSON record: the card's name and
power limit, the root, a checksum of each kernel's output and CUDA-event
medians in ms (L2 flushed) of

- K4 (``csrc/corr1d_bank.cu``): ``SavgolBank``'s smooth + d1 + d2 bank
  (K = 3, 25 taps, pad 12) on the 1D headline's (128, 1,048,576) in f32 and
  f64, and the sweep's six 65-tap stencils (pad 32) on 4,194,304 samples and
  on the headline batch;
- K2D-dense at the 2D headline, (16, 2048, 2048), 11 x 11 order 3,
  CONSTANT: its bf16 mode in bf16 and f32 storage with one stencil and
  with the Hessian's three, and the exact f32 instance with one and three,
  and with one row of the stencil (1 x 11: the staging and per-tile cost
  of the same tiles with 1/11 of the FMAs, as P2's ``C_wh1`` splits the
  bf16 mode), and at 15 x 15 order 3 with one stencil and the Hessian's
  three (a width that ``Savgol2D.apply(method="auto")`` also sends to this
  kernel);
- K7 (``csrc/corr2d_sep.cu``) on the same image and stencil, with the
  path's rank-2 factors and with the rank-6 factors of the float32 stencil.

It uses only the wrappers' public signatures, which every checkout since
the bf16 mode was ported shares.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    here = pathlib.Path(__file__).resolve().parents[2]
    ap.add_argument("--root", default=str(here))
    args = ap.parse_args()
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import numpy as np
    import torch

    import savgol_tpu_torch as sgt
    from savgol_tpu_torch.ops import cuda_bank as cb
    from savgol_tpu_torch.ops import cuda_conv2d as c2
    from savgol_tpu_torch.ops.sweep import savgol_weights_masked
    from savgol_tpu_torch.ops.weights import savgol2d_weights_np
    from savgol_tpu_torch.probes.masked_ab import card
    from savgol_tpu_torch.utils.timing import cuda_time_ms

    if not torch.cuda.is_available():
        raise SystemExit("stencil_ab needs a CUDA device")
    if pathlib.Path(sgt.__file__).resolve().parents[1] != root:
        raise SystemExit(f"imported {sgt.__file__}, not from {root}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1010)
    ms, sums = {}, {}

    def run(name, fn, **kw):
        sums[name] = fn().double().sum().item()
        ms[name] = cuda_time_ms(fn, **kw)

    # -- K4 --
    x = torch.randn(128, 1 << 20, generator=gen, device=dev)
    bank = sgt.SavgolBank.smooth_and_derivatives(12, 4, 2, device=dev)
    wdt = bank.center_weights * bank.dt_inv[:, None]
    center = savgol_weights_masked([4, 8, 12, 16, 24, 32], [2, 3, 4, 4, 5, 6],
                                   0, torch.float32, device=dev)[0]
    run("K4 bank K=3", lambda: cb.correlate_valid_bank_cuda(x, wdt, 12))
    run("K4 sweep 128x1M", lambda: cb.correlate_valid_bank_cuda(x, center, 32),
        warmup=2, reps=7)
    xs = x.reshape(-1)[:4_194_304].clone()
    run("K4 sweep 4M", lambda: cb.correlate_valid_bank_cuda(xs, center, 32))
    xd, wd = x.double(), wdt.double()
    del x
    run("K4 bank K=3 f64", lambda: cb.correlate_valid_bank_cuda(xd, wd, 12))
    del xd

    # -- K2D-dense and K7 at the 2D headline --
    img = torch.randn(16, 2048, 2048, generator=gen, device=dev)
    imgb = img.to(torch.bfloat16)
    cfg = sgt.Savgol2DConfig(5, 5, 3)
    w1 = torch.from_numpy(savgol2d_weights_np(cfg, np.float64)).to(
        dev, torch.float32)
    w3 = torch.from_numpy(np.stack([savgol2d_weights_np(
        sgt.Savgol2DConfig(5, 5, 3, deriv_x=dx, deriv_y=dy), np.float64)
        for dx, dy in ((2, 0), (1, 1), (0, 2))])).to(dev, torch.float32)
    for k, w in (("K=1", w1), ("K=3", w3)):
        run(f"K2D-dense-bf16 {k}",
            lambda: c2.correlate2d_valid_bf16_cuda(imgb, w, "edge"))
        run(f"K2D-dense-bf16 {k} f32 storage",
            lambda: c2.correlate2d_valid_bf16_cuda(img, w, "edge"))
        run(f"K2D-dense f32 {k}",
            lambda: c2.correlate2d_valid_cuda(img, w, "edge"))
    w1row = w1[5:6].contiguous()
    run("K2D-dense f32 1x11", lambda: c2.correlate2d_valid_cuda(img, w1row,
                                                                "edge"))
    w15 = torch.from_numpy(np.stack([savgol2d_weights_np(
        sgt.Savgol2DConfig(7, 7, 3, deriv_x=dx, deriv_y=dy), np.float64)
        for dx, dy in ((0, 0), (2, 0), (1, 1), (0, 2))])).to(dev,
                                                             torch.float32)
    for k, w in (("K=1", w15[0]), ("K=3", w15[1:])):
        run(f"K2D-dense f32 15x15 {k}",
            lambda: c2.correlate2d_valid_cuda(img, w, "edge"))
    # K7 with the path's factors (rank 2: the f64 stencil, as
    # Savgol2D.apply(method="sep") factors it), and with the rank 6 that the
    # float32 stencil's rounding noise gives at _svd_stencil_np's default
    # cutoff (the factors this probe used to time as "K7")
    u, v = (torch.from_numpy(a).to(dev, torch.float32)
            for a in c2._svd_stencil_np(savgol2d_weights_np(cfg, np.float64)))
    run("K7", lambda: c2.correlate2d_sep_cuda(img, u, v, "edge"))
    u6, v6 = (torch.from_numpy(a).to(dev, torch.float32)
              for a in c2._svd_stencil_np(w1.double().cpu().numpy()))
    run(f"K7 rank {u6.shape[0]}",
        lambda: c2.correlate2d_sep_cuda(img, u6, v6, "edge"))

    print(json.dumps({"card": card(), "root": str(root), "ms": ms,
                      "sums": sums}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
