"""Times the masked kernels of one checkout of this package on the card, so
that two checkouts can be compared in one call, in turns (parent, change,
change, parent):

    python savgol_tpu_torch/probes/masked_ab.py [--root DIR] [--k8a]

imports ``savgol_tpu_torch`` from DIR (default: the checkout this file is
in), builds its kernels and prints one JSON record: the card's name and
power limit, the root, a checksum of each masked kernel's output and
CUDA-event medians in ms (L2 flushed) of

- K9 (``csrc/masked1d.cu``) at the masked 1D path's shape, (64, 131,072),
  n = 12, m = 4, 20% holes, and alone at the 1D headline's (128, 1,048,576);
- K10 (``csrc/masked2d.cu``) at the masked 2D path's 1024 x 1024, 11 x 11,
  order 3 (P = 10), at order 4 (P = 15), at 23 x 23, order 4 (P = 15 on the
  runtime instance: the fixed one needs more shared memory than a block
  has, as ``instance_2d`` shows) and alone at the 2D headline's
  (16, 2048, 2048);
- ``savgol_apply_masked`` and ``savgol2d_apply_masked`` at the path's shapes;
- K8a, K8b (``csrc/plane_solve.cu``) and K11 (``csrc/nonuniform.cu``), which
  share the solve routine ``csrc/plane_chol.cuh``, at ``chip_smoke.py``'s
  shapes; K8a also on the planes of the staged route's 3 x 11 window at
  orders 4, 5 and 6 (P = 15, 21, 28) in f32 and at orders 3 and 4 in
  f64, and ``savgol2d_apply_masked`` on that route (3 x 11, order 3);
- K8b on the qr route's planes (8 x 131,072 positions) at k = 5 and 3 in
  f32 pairs and k = 5 in f64 pairs, and at k = 10 (its runtime form in
  every checkout since the masked path was ported);
- K11 at the nonuniform path's (8, 131,072), n = 12, m = 4, f32 and f64,
  its planes mode K11p, and the entry points ``savgol_apply_nonuniform``
  and ``savgol_resample`` there;
- K12 (``csrc/resample.cu``) alone at the resample row, on K11p's planes of
  those 8 rows and the path's 131,072 centres: m = 4 (the path), m = 7 and
  m = 9 (past the compile-time m) in f32, and m = 4 in f64, on
  ``utils.timing.device_ms`` (device time), and ``savgol_resample`` again
  on that timer.

``--k8a`` times K8a through its wrapper alone on the 2D path's planes, 31
reps, and the host time of a call (``utils.timing.host_ms``): the quick
A/B of the wrapper's own work, run many times in alternating order.

Beside the checksums, a digest of each K8b, K11 and K12 output's bytes
shows whether two checkouts give the same bits.

It uses only the wrappers' public signatures, which every checkout since the
masked path was ported shares.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import subprocess
import sys


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def instance_2d(nx: int, ny: int, m: int) -> str:
    """Which K10 instance runs a configuration of this checkout, and the
    shared memory its compile-time instance would take: masked2d.cu's
    fixed_smem (G, with L at P = 15, by thread; the tables; the tile and
    its profiles) against sgtlaunch::kSmemMax."""
    from savgol_tpu_torch.ops import cuda_masked2d as c10
    _, _, (P, Sx, Sy, M, nnz) = c10._kernel_tables(nx, ny, m, 0, 0, 1.0,
                                                   1.0, "cpu")
    if P not in (1, 3, 6, 10, 15):
        return f"runtime (P = {P})"
    rows, shared_l = (4, False) if P <= 10 else (3, True)
    wx, wy = 2 * nx + 1, 2 * ny + 1
    sr, sc = rows + wy - 1, 32 + wx - 1
    doubles = ((2 if shared_l else 1) * P * (P + 1) // 2 * rows * 32
               + Sx * wx + Sy * wy + nnz + P + 2 * sr * sc
               + (Sy + m + 2) * rows * sc)
    smem = 8 * doubles + 4 * (3 * M + 2 * P + 1 + nnz)
    return (f"{'fixed' if smem <= 232448 else 'runtime'} (P = {P}, fixed "
            f"instance {smem} B of 232448)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    here = pathlib.Path(__file__).resolve().parents[2]
    ap.add_argument("--root", default=str(here))
    ap.add_argument("--k8a", action="store_true")
    args = ap.parse_args()
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import numpy as np
    import torch
    import torch.nn.functional as F

    import savgol_tpu_torch as sgt
    from savgol_tpu_torch.ops import cuda_masked as c9
    from savgol_tpu_torch.ops import cuda_masked2d as c10
    from savgol_tpu_torch.ops import cuda_nonuniform as c11
    from savgol_tpu_torch.ops import cuda_solve as cs
    from savgol_tpu_torch.ops import lsq
    from savgol_tpu_torch.ops import masked as mk
    from savgol_tpu_torch.ops import cuda_resample as c12
    from savgol_tpu_torch.utils.timing import cuda_time_ms, device_ms, host_ms

    if not torch.cuda.is_available():
        raise SystemExit("masked_ab needs a CUDA device")
    if pathlib.Path(sgt.__file__).resolve().parents[1] != root:
        raise SystemExit(f"imported {sgt.__file__}, not from {root}")
    dev = torch.device("cuda")
    rng = np.random.default_rng(1002)

    def holed(shape):
        x = rng.standard_normal(shape).astype(np.float32)
        valid = rng.random(shape) >= 0.2
        return (torch.from_numpy(x).to(dev), torch.from_numpy(valid).to(dev))

    ms, sums, digests = {}, {}, {}

    def k8a_planes(img, valid2):
        """K8a's arguments on the 2D path's planes (11 x 11, order 3,
        P = 10)."""
        xv2 = F.pad(torch.where(valid2, img, 0.0), (5,) * 4)
        wp2 = F.pad(valid2.float(), (5,) * 4)
        Q3, _, pw2, pi2, _ = mk._masked_tables_2d(5, 5, 3)
        gram2 = mk._corr2d_bank(wp2, pw2, True)
        return (gram2, pi2, mk._corr2d_bank(xv2, Q3, True),
                gram2[int(pi2[0, 0])] * 121 >= 9.5, 1e-6)

    if args.k8a:
        a = k8a_planes(*holed((1024, 1024)))
        ms["K8a"] = cuda_time_ms(lambda: cs.plane_solve_cuda(*a), reps=31)
        ms["K8a host"] = host_ms(lambda: cs.plane_solve_cuda(*a))
        print(json.dumps({"card": card(), "root": str(root), "ms": ms}))
        return 0

    def digest(name, out):
        digests[name] = hashlib.sha1(
            out.contiguous().cpu().numpy().tobytes()).hexdigest()[:16]

    # -- K9 and the masked 1D entry point --
    x, valid = holed((64, 131_072))
    Q, Rinv, pair_w, pair_index = mk._masked_tables(12, 4)
    tabs = (pair_w, pair_index, Q.T, Rinv[0, :])
    xzp = F.pad(torch.where(valid, x, 0.0), (12, 12))
    wp = F.pad(valid.float(), (12, 12))
    k9 = dict(half_window=12, kmin=5, fill=0.0)
    sums["K9"] = c9.savgol_masked1d_fused_cuda(xzp, wp, *tabs, **k9).double(
        ).sum().item()
    ms["K9"] = cuda_time_ms(lambda: c9.savgol_masked1d_fused_cuda(
        xzp, wp, *tabs, **k9))
    ms["savgol_apply_masked"] = cuda_time_ms(lambda: sgt.savgol_apply_masked(
        x, half_window=12, poly_order=4, mask=valid, fill=0.0))
    # K8b on the qr route's planes (8 rows): k = 5 f32 and f64 pairs, k = 3,
    # and k = 10 (the runtime form)
    for m, dt, tag in ((4, torch.float32, "K8b"), (4, torch.float64,
                                                   "K8b f64 pairs"),
                       (2, torch.float32, "K8b k=3"),
                       (9, torch.float32, "K8b k=10 (runtime form)")):
        Qm, _, pwm, pim = mk._masked_tables(12, m)
        ghi, glo = lsq.correlate_valid_dd(wp[:8].to(dt), pwm)
        rhi, rlo = lsq.correlate_valid_dd(xzp[:8].to(dt), Qm.T)
        quorum_q = ghi[int(pim[0, 0])] * 25 >= m + 0.5
        coef, ok = cs.plane_solve_dd_cuda(ghi, glo, pim, rhi, rlo, quorum_q)
        sums[tag] = coef.double().nan_to_num().sum().item()
        digest(tag, coef)
        digest(tag + " ok", ok)
        ms[tag] = cuda_time_ms(lambda: cs.plane_solve_dd_cuda(
            ghi, glo, pim, rhi, rlo, quorum_q))
        del ghi, glo, rhi, rlo

    # -- K10 and the masked 2D entry point --
    img, valid2 = holed((1024, 1024))
    xv2 = F.pad(torch.where(valid2, img, 0.0), (5,) * 4)
    wp2 = F.pad(valid2.float(), (5,) * 4)
    k10 = dict(half_window_x=5, half_window_y=5, poly_order=3, kmin=10,
               fill=0.0, rcond=1e-6)
    k10_4 = {**k10, "poly_order": 4, "kmin": 15}
    k10_23 = {**k10_4, "half_window_x": 11, "half_window_y": 11}
    xv23 = F.pad(torch.where(valid2, img, 0.0), (11,) * 4)
    wp23 = F.pad(valid2.float(), (11,) * 4)
    sums["K10"] = c10.savgol_masked2d_fused_cuda(xv2, wp2, **k10).double(
        ).sum().item()
    sums["K10 P=15"] = c10.savgol_masked2d_fused_cuda(
        xv2, wp2, **k10_4).double().sum().item()
    sums["K10 23x23 P=15"] = c10.savgol_masked2d_fused_cuda(
        xv23, wp23, **k10_23).double().sum().item()
    ms["K10"] = cuda_time_ms(lambda: c10.savgol_masked2d_fused_cuda(
        xv2, wp2, **k10))
    ms["K10 P=15"] = cuda_time_ms(lambda: c10.savgol_masked2d_fused_cuda(
        xv2, wp2, **k10_4))
    ms["K10 23x23 P=15"] = cuda_time_ms(lambda: c10.savgol_masked2d_fused_cuda(
        xv23, wp23, **k10_23))
    del xv23, wp23
    ms["savgol2d_apply_masked"] = cuda_time_ms(
        lambda: sgt.savgol2d_apply_masked(img, half_window_x=5,
                                          half_window_y=5, poly_order=3,
                                          mask=valid2, fill=0.0))
    # K8a on the 2D path's planes (P = 10)
    a8 = k8a_planes(img, valid2)
    ms["K8a"] = cuda_time_ms(lambda: cs.plane_solve_cuda(*a8))
    del a8
    # K8a on the staged route's planes: a 3 x 11 window, orders 3-6
    xv3 = F.pad(torch.where(valid2, img, 0.0), (1, 1, 5, 5))
    wp3 = F.pad(valid2.float(), (1, 1, 5, 5))
    for m, dts in ((3, (torch.float64,)), (4, (torch.float32, torch.float64)),
                   (5, (torch.float32,)), (6, (torch.float32,))):
        Qm, _, pwm, pim, _ = mk._masked_tables_2d(1, 5, m)
        P = Qm.shape[0]
        for dt in dts:
            gm = mk._corr2d_bank(wp3.to(dt), pwm, True)
            rm = mk._corr2d_bank(xv3.to(dt), Qm, True)
            qm = gm[int(pim[0, 0])] * 33 >= P - 0.5
            name = f"K8a 3x11 P={P}" + (" f64" if dt == torch.float64 else "")
            sums[name] = cs.plane_solve_cuda(gm, pim, rm, qm, 1e-6)[0].double(
                ).nan_to_num().sum().item()
            ms[name] = cuda_time_ms(lambda: cs.plane_solve_cuda(
                gm, pim, rm, qm, 1e-6), warmup=2, reps=7)
            del gm, rm
    del xv3, wp3
    ms["savgol2d_apply_masked 3x11"] = cuda_time_ms(
        lambda: sgt.savgol2d_apply_masked(img, half_window_x=1,
                                          half_window_y=5, poly_order=3,
                                          mask=valid2, fill=0.0))

    # -- K11 at (8, 131,072), n = 12, m = 4 --
    gen = torch.Generator(device=dev).manual_seed(1004)
    tn = torch.cumsum(torch.rand((8, 131_072), generator=gen, device=dev)
                      + 0.5, -1)
    xn = torch.randn((8, 131_072), generator=gen, device=dev)
    ku = dict(half_window=12, poly_order=4, kmin=5, rcond=1e-6,
              derivative=0, fill=0.0)
    kp = dict(half_window=12, poly_order=4, kmin=5, rcond=1e-6)
    for dt, tag in ((torch.float32, "K11"), (torch.float64, "K11 f64")):
        x_, t_ = xn.to(dt), tn.to(dt)
        w_ = torch.ones_like(x_)
        y = c11.savgol_nonuniform_fused_cuda(x_, w_, t_, **ku)
        sums[tag] = y.double().sum().item()
        digest(tag, y)
        ms[tag] = cuda_time_ms(lambda: c11.savgol_nonuniform_fused_cuda(
            x_, w_, t_, **ku))
    wn = torch.ones_like(xn)
    yp = c11.savgol_nonuniform_planes_cuda(xn, wn, tn, **kp)
    sums["K11p"] = yp.double().sum().item()
    digest("K11p", yp)
    ms["K11p"] = cuda_time_ms(lambda: c11.savgol_nonuniform_planes_cuda(
        xn, wn, tn, **kp))
    ms["savgol_apply_nonuniform"] = cuda_time_ms(
        lambda: sgt.savgol_apply_nonuniform(xn, tn, half_window=12,
                                            poly_order=4))
    # resample as chip_smoke.py drives it: a shared t row, N queries
    t1 = tn[0].contiguous()
    tq1 = torch.linspace(t1[0].item(), t1[-1].item(), t1.numel(), device=dev)
    ms["savgol_resample"] = cuda_time_ms(
        lambda: sgt.savgol_resample(xn, t1, tq1, half_window=12,
                                    poly_order=4, fill=0.0))
    ms["savgol_resample device"] = device_ms(
        lambda: sgt.savgol_resample(xn, t1, tq1, half_window=12,
                                    poly_order=4, fill=0.0))
    del yp
    # K12 alone on the resample row's planes and centres
    ctr = torch.clamp(torch.searchsorted(t1, tq1) - 12, 0,
                      t1.numel() - 25) + 12
    for m, dt in ((4, torch.float32), (7, torch.float32), (9, torch.float32),
                  (4, torch.float64)):
        x_, t_, q_ = xn.to(dt), t1.to(dt), tq1.to(dt)
        pk = c11.savgol_nonuniform_planes_cuda(
            x_, torch.ones_like(x_), t_, half_window=12, poly_order=m,
            kmin=m + 1, rcond=1e-6 if dt == torch.float32 else 1e-12)
        ke = dict(poly_order=m, derivative=0, fill=0.0)
        tag = f"K12 m={m}" + (" f64" if dt == torch.float64 else "")
        y = c12.resample_eval_cuda(pk, t_, ctr, q_, **ke)
        sums[tag] = y.double().sum().item()
        digest(tag, y)
        ms[tag] = device_ms(lambda: c12.resample_eval_cuda(pk, t_, ctr, q_,
                                                           **ke))
        del pk, y

    # -- K9 and K10 alone at the headline shapes --
    xh, vh = holed((128, 1_048_576))
    xh, wh = (F.pad(a, (12, 12)) for a in (torch.where(vh, xh, 0.0),
                                           vh.float()))
    del vh
    ms["K9 alone (128, 1048576)"] = cuda_time_ms(
        lambda: c9.savgol_masked1d_fused_cuda(xh, wh, *tabs, **k9),
        warmup=1, reps=5)
    del xh, wh
    gen.manual_seed(5)
    ih = torch.randn((16, 2048, 2048), generator=gen, device=dev)
    iwh = (torch.rand((16, 2048, 2048), generator=gen, device=dev)
           >= 0.2).float()
    ih, iwh = (F.pad(a, (5,) * 4) for a in (ih * iwh, iwh))
    ms["K10 alone (16, 2048, 2048)"] = cuda_time_ms(
        lambda: c10.savgol_masked2d_fused_cuda(ih, iwh, **k10),
        warmup=1, reps=5)
    del ih, iwh

    # instance_2d reads this file's checkout's masked2d.cu
    instances = {f"{nx}x{ny}x{m}": instance_2d(nx, ny, m)
                 for nx, ny, m in ((5, 5, 3), (5, 5, 4), (11, 11, 4),
                                   (16, 16, 6))} if root == here else None
    print(json.dumps({"card": card(), "root": str(root), "ms": ms,
                      "sums": sums, "digests": digests,
                      "K10 instances": instances}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
