"""Times the stencil kernels K1-K3, K4, K2D-dense, K7 and the bf16 1D
kernels of one checkout of this package on the card, so that two checkouts
can be compared in one call, in turns (parent, change, change, parent):

    python savgol_tpu_torch/probes/stencil_ab.py [--root DIR]
        [--only exact|bf16|sep]

imports ``savgol_tpu_torch`` from DIR (default: the checkout this file is
in), builds its kernels and prints one JSON record: the card's name and
power limit, the root, a checksum of each kernel's output (``sums``, the
sum of its values) and, for K1-K3, the bf16 kernels (K1-bf16, K2-bf16,
K3-bf16, K2D-dense-bf16) and their entry points, a digest of its bits
(``digests``: the sum of each output's raw bits times 2 i + 1, i its
flat index, in wrapping 64-bit integers, so that two checkouts' outputs
are compared bit for bit), and CUDA-event medians in ms (L2 flushed) of

- the exact 1D kernels (f32 and f64) at the 1D headline's (128,
  1,048,576) with scipy's windows of 25 and 101 taps (order 4): K1
  (``sg1d_poly`` in ``csrc/sg1d_poly.cu``), K2 (``sg1d_pad``) in its edge,
  wrap and symmetric modes, and K3 (``corr1d_valid`` in
  ``csrc/corr1d_valid.cu``), and the entry points ``Savgol1D.apply`` and
  ``Savgol1D.apply_valid`` (``SavgolConfig(12, 4)``, f32) with the host's
  work (``utils.timing.cuda_time_ms``), and the host's time for the small
  calls that a launch's set-up bounds (``host``): K3's wrapper on (8, 4096)
  (``utils.timing.host_ms``, chip_smoke.py's host line) and streaming's 64
  chunks of 8,192 and of 65,536 samples, one K3 launch a chunk (ms a
  chunk, host clock with the card synchronised, median of five, as
  chip_smoke.py's phase 38 times one); ``--only exact`` times these alone,
  and ``--clocks`` adds the card's SM clock, power draw, temperature and
  throttle reasons while K1 (f32, 25 and 101 taps) runs back to back for
  two seconds after ten idle ones (``utils.timing.clocks_during``);
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
  path's rank-2 factors (in the four boundaries, and in f64) and with the
  rank-6 factors of the float32 stencil, and with the factors
  ``Savgol2D.apply(method="auto")`` takes for 21 x 21 order 4 (rank 3),
  33 x 33 order 6 (rank 4) and the rectangle 17 x 25 order 4 (rank 3),
  which are wider than the dense kernel's widths, each with its bits'
  digest, and its entry point ``Savgol2D.apply`` with the host's work;
  ``--only sep`` times these alone;
- the bf16 1D tile (``csrc/sg1d_bf16.cuh``) at the 1D headline, (128,
  1,048,576), n = 12, m = 4: K1-bf16 (``sg1d_poly_bf16`` in
  ``csrc/sg1d_poly.cu``) in bf16 and f32 storage, K2-bf16
  (``sg1d_pad_bf16``) in each pad mode (bf16 storage, and wrap in f32
  storage), and K3-bf16 (``corr1d_valid_bf16`` in ``csrc/corr1d_valid.cu``,
  25 taps) in bf16 and f32 storage, and its entry point
  ``Savgol1D.apply_valid(method="bf16")`` on the bf16 batch, in device
  time and with the host's work (``utils.timing.cuda_time_ms``);
  ``--only bf16`` times these and K2D-dense's bf16 mode alone.

It uses only the wrappers' public signatures, which every checkout since
the bf16 mode was ported shares, and times every checkout with this
checkout's ``utils.timing.device_ms`` (device time: the card is kept
busy while the host enqueues each timed call).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import sys
import time

# the kernels --clocks reads the card's clock beside
_CLOCKED = ("K1 f32 ws=25", "K1 f32 ws=101")


def _own_timing(here: pathlib.Path):
    """``utils/timing.py`` of the checkout this file is in, loaded by path
    (it imports only torch and the standard library)."""
    path = here / "savgol_tpu_torch" / "utils" / "timing.py"
    spec = importlib.util.spec_from_file_location("_stencil_ab_timing", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    here = pathlib.Path(__file__).resolve().parents[2]
    ap.add_argument("--root", default=str(here))
    ap.add_argument("--only", choices=("exact", "bf16", "sep"),
                    help="time only the exact 1D kernels and their entry "
                         "points, or only the bf16 kernels (1D and "
                         "K2D-dense's) and apply_valid(method='bf16'), or "
                         "only K7 and Savgol2D.apply")
    ap.add_argument("--clocks", action="store_true",
                    help="sample the SM clock and power during the f32 "
                         "exact 1D kernels")
    args = ap.parse_args()
    root = pathlib.Path(args.root).resolve()
    # one timing rule for every checkout compared: this checkout's
    timing = _own_timing(here)
    sys.path.insert(0, str(root))

    import numpy as np
    import torch

    import savgol_tpu_torch as sgt
    from savgol_tpu_torch.ops import cuda_bank as cb
    from savgol_tpu_torch.ops import cuda_conv as cc
    from savgol_tpu_torch.ops import cuda_conv2d as c2
    from savgol_tpu_torch.ops.apply2d import _factors
    from savgol_tpu_torch.ops.sweep import savgol_weights_masked
    from savgol_tpu_torch.ops.weights import savgol2d_weights_np
    from savgol_tpu_torch.probes.masked_ab import card
    from savgol_tpu_torch.scipy_compat import _compat_weights_np

    if not torch.cuda.is_available():
        raise SystemExit("stencil_ab needs a CUDA device")
    if pathlib.Path(sgt.__file__).resolve().parents[1] != root:
        raise SystemExit(f"imported {sgt.__file__}, not from {root}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1010)
    ms, sums, digests, clocks, host = {}, {}, {}, {}, {}

    def digest(t):
        bits = t.contiguous().view({2: torch.int16, 4: torch.int32,
                                    8: torch.int64}[t.element_size()]
                                   ).reshape(-1)
        i = torch.arange(bits.numel(), device=dev, dtype=torch.int64)
        return int((bits.to(torch.int64) * (2 * i + 1)).sum().item())

    def run(name, fn, bits=False, **kw):
        out = fn()
        sums[name] = out.double().sum().item()
        if bits:
            digests[name] = digest(out)
        del out
        ms[name] = timing.device_ms(fn, **kw)
        if args.clocks and name in _CLOCKED:
            time.sleep(10)   # let the card cool from the calls before
            clocks[name] = timing.clocks_during(fn)

    x = torch.randn(128, 1 << 20, generator=gen, device=dev)
    img = torch.randn(16, 2048, 2048, generator=gen, device=dev)
    cfg = sgt.Savgol2DConfig(5, 5, 3)
    w1 = torch.from_numpy(savgol2d_weights_np(cfg, np.float64)).to(
        dev, torch.float32)
    w3 = torch.from_numpy(np.stack([savgol2d_weights_np(
        sgt.Savgol2DConfig(5, 5, 3, deriv_x=dx, deriv_y=dy), np.float64)
        for dx, dy in ((2, 0), (1, 1), (0, 2))])).to(dev, torch.float32)

    def exact_1d():
        """K1, K2 and K3 at the 1D headline, f32 and f64, 25 and 101 taps,
        their entry points, and the host time of short launches."""
        for dt in (torch.float32, torch.float64):
            xx = x.to(dt)
            tag = "f32" if dt == torch.float32 else "f64"
            for n in (12, 50):
                cw, ew = (torch.from_numpy(a).to(dev, dt)
                          for a in _compat_weights_np(n, 4, 0))
                where = f"{tag} ws={2 * n + 1}"
                run(f"K1 {where}", lambda: cc.savgol_polynomial_cuda(
                    xx, cw, ew, n), bits=True)
                for mode in ("edge", "wrap", "symmetric"):
                    run(f"K2 {mode} {where}", lambda: cc.savgol_padded_cuda(
                        xx, cw, mode, n), bits=True)
                run(f"K3 {where}", lambda: cc.correlate_valid_cuda(xx, cw),
                    bits=True)
            del xx
        f1 = sgt.Savgol1D.create(sgt.SavgolConfig(12, 4), device=dev)
        for name, fn in (("Savgol1D.apply", lambda: f1.apply(x)),
                         ("Savgol1D.apply_valid", lambda: f1.apply_valid(x))):
            out = fn()
            digests[name] = digest(out)
            sums[name] = out.double().sum().item()
            del out
            ms[name + " with host"] = timing.cuda_time_ms(fn)
        from savgol_tpu_torch import stream as ts
        xsm = x[:8, :4096].contiguous()
        host["K3 wrapper (8, 4096)"] = timing.host_ms(
            lambda: cc.correlate_valid_cuda(xsm, f1.center_weights))
        for C in (8192, 65_536):
            chunks = torch.randn(64, C, generator=gen, device=dev)

            def chunked():
                st = ts.chunk_init(12, device=dev)
                for ch in chunks:
                    st, _, _ = ts.stream_process_chunk(
                        st, ch, f1.center_weights, f1.edge_weights, f1.dt_inv)
            chunked()
            per = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                chunked()
                torch.cuda.synchronize()
                per.append((time.perf_counter() - t0) / 64 * 1e3)
            host[f"stream chunk of {C}"] = sorted(per)[2]

    def bank():
        """K4: the derivative bank in f32 and f64, and the sweep."""
        sb = sgt.SavgolBank.smooth_and_derivatives(12, 4, 2, device=dev)
        wdt = sb.center_weights * sb.dt_inv[:, None]
        center = savgol_weights_masked([4, 8, 12, 16, 24, 32],
                                       [2, 3, 4, 4, 5, 6], 0, torch.float32,
                                       device=dev)[0]
        run("K4 bank K=3", lambda: cb.correlate_valid_bank_cuda(x, wdt, 12))
        run("K4 sweep 128x1M",
            lambda: cb.correlate_valid_bank_cuda(x, center, 32),
            warmup=2, reps=7)
        xs = x.reshape(-1)[:4_194_304].clone()
        run("K4 sweep 4M", lambda: cb.correlate_valid_bank_cuda(xs, center, 32))
        xd, wd = x.double(), wdt.double()
        run("K4 bank K=3 f64", lambda: cb.correlate_valid_bank_cuda(xd, wd, 12))

    def bf16_1d():
        """K1-bf16, K2-bf16 and K3-bf16 at the 1D headline, and
        apply_valid(method="bf16")."""
        xb = x.to(torch.bfloat16)
        cw, ew = (torch.from_numpy(a).to(dev, torch.float32)
                  for a in _compat_weights_np(12, 4, 0))
        one = torch.tensor(1.0, device=dev)
        for tag, xx in (("bf16", xb), ("f32 storage", x)):
            run(f"K1-bf16 {tag}", lambda: cc.savgol_polynomial_bf16_cuda(
                xx, cw, ew, 12, one, 1.0), bits=True)
            run(f"K3-bf16 {tag}", lambda: cc.correlate_valid_bf16_cuda(xx, cw),
                bits=True)
        f = sgt.Savgol1D.create(sgt.SavgolConfig(12, 4), device=dev)
        run("apply_valid bf16", lambda: f.apply_valid(xb, method="bf16"),
            bits=True)
        ms["apply_valid bf16 with host"] = timing.cuda_time_ms(
            lambda: f.apply_valid(xb, method="bf16"))
        for mode in ("symmetric", "wrap", "edge"):
            run(f"K2-bf16 {mode} bf16", lambda: cc.savgol_padded_bf16_cuda(
                xb, cw, mode, 12, one), bits=True)
        run("K2-bf16 wrap f32 storage", lambda: cc.savgol_padded_bf16_cuda(
            x, cw, "wrap", 12, one), bits=True)

    def bf16_2d():
        """K2D-dense-bf16 at the 2D headline, K = 1 and 3, bf16 and f32
        storage."""
        imgb = img.to(torch.bfloat16)
        for k, w in (("K=1", w1), ("K=3", w3)):
            for tag, im in (("", imgb), (" f32 storage", img)):
                run(f"K2D-dense-bf16 {k}{tag}",
                    lambda: c2.correlate2d_valid_bf16_cuda(im, w, "edge"),
                    bits=True)

    def exact_2d():
        """The exact K2D-dense at the 2D headline."""
        for k, w in (("K=1", w1), ("K=3", w3)):
            run(f"K2D-dense f32 {k}",
                lambda: c2.correlate2d_valid_cuda(img, w, "edge"))
        w1row = w1[5:6].contiguous()
        run("K2D-dense f32 1x11",
            lambda: c2.correlate2d_valid_cuda(img, w1row, "edge"))
        w15 = torch.from_numpy(np.stack([savgol2d_weights_np(
            sgt.Savgol2DConfig(7, 7, 3, deriv_x=dx, deriv_y=dy), np.float64)
            for dx, dy in ((0, 0), (2, 0), (1, 1), (0, 2))])).to(
                dev, torch.float32)
        for k, w in (("K=1", w15[0]), ("K=3", w15[1:])):
            run(f"K2D-dense f32 15x15 {k}",
                lambda: c2.correlate2d_valid_cuda(img, w, "edge"))

    def sep_2d():
        """K7 at the 2D headline and its wide windows, bit digests, and
        Savgol2D.apply with the host's work."""
        # K7 with the path's factors (rank 2: the f64 stencil, as
        # Savgol2D.apply(method="sep") factors it), and with the rank 6 that
        # the float32 stencil's rounding noise gives at _svd_stencil_np's
        # default cutoff (the factors this probe used to time as "K7")
        u, v = (torch.from_numpy(a).to(dev, torch.float32)
                for a in c2._svd_stencil_np(savgol2d_weights_np(
                    cfg, np.float64)))
        run("K7", lambda: c2.correlate2d_sep_cuda(img, u, v, "edge"),
            bits=True)
        for mode in (None, "symmetric", "wrap"):
            run(f"K7 {mode or 'valid'}",
                lambda: c2.correlate2d_sep_cuda(img, u, v, mode), bits=True)
        img64, u64, v64 = img.double(), u.double(), v.double()
        run("K7 f64", lambda: c2.correlate2d_sep_cuda(img64, u64, v64,
                                                      "edge"), bits=True)
        del img64
        u6, v6 = (torch.from_numpy(a).to(dev, torch.float32)
                  for a in c2._svd_stencil_np(w1.double().cpu().numpy()))
        run(f"K7 rank {u6.shape[0]}",
            lambda: c2.correlate2d_sep_cuda(img, u6, v6, "edge"), bits=True)
        # the wide windows method="auto" sends to K7, with its factors
        for nx, ny, m in ((10, 10, 4), (16, 16, 6), (12, 8, 4)):
            f2 = sgt.Savgol2D.create(sgt.Savgol2DConfig(nx, ny, m),
                                     device=dev)
            (uw, vw), = _factors(f2.weights, torch.float32, dev)
            run(f"K7 {2 * ny + 1}x{2 * nx + 1} rank {uw.shape[0]}",
                lambda: c2.correlate2d_sep_cuda(img, uw, vw, "edge"),
                bits=True)
        f2 = sgt.Savgol2D.create(cfg, device=dev)
        out = f2.apply(img)
        digests["Savgol2D.apply"] = digest(out)
        del out
        ms["Savgol2D.apply with host"] = timing.cuda_time_ms(
            lambda: f2.apply(img))

    # each section with the --only groups it belongs to (none: the whole
    # run only)
    for section, groups in ((exact_1d, ("exact",)), (bank, ()),
                            (bf16_1d, ("bf16",)), (bf16_2d, ("bf16",)),
                            (exact_2d, ()), (sep_2d, ("sep",))):
        if args.only is None or args.only in groups:
            section()
    print(json.dumps({"card": card(), "root": str(root), "ms": ms,
                      "host": host, "sums": sums, "digests": digests,
                      "clocks": clocks}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
