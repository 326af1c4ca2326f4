"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Builds the CUDA kernels from ``savgol_tpu_torch/csrc`` into
``build/savgol_tpu_torch/``, holds each kernel against its plain PyTorch
version on the card, runs ``Savgol1D.create(SavgolConfig(12, 4)).apply`` and
``.apply_valid`` on a (128, 1,048,576) float32 batch, checks the result
against a float64 reference and scipy, checks gradients, and times the
kernels and their plain versions with CUDA events. Then the same for the 2D
path: a grid of windows, boundaries, stencil stacks, images and dtypes
through the dense and separable kernels, ``Savgol2D.create(Savgol2DConfig(5,
5, 3)).apply`` and the derivative stacks on a (16, 2048, 2048) float32
batch against a float64 reference, gradients, and timings. Then the masked
(missing-data) path: the plane solves K8a/K8b, the fused masked kernels K9
(1D) and K10 (2D) against their plain versions over grids of orders,
masks, boundaries, shapes and dtypes; ``savgol_apply_masked`` (normal and
``solver="qr"``) on a (64, 131,072) float32 batch and
``savgol2d_apply_masked`` on a 1024 x 1024 image, 20% holes, against
float64, with each entry point's kernel launches counted; K8b's
compile-time instances (k <= 8) bit for bit against its runtime form on
the same planes; K8a bit for bit
against its plain version on that image's planes (k = 6, 10, 15; f32 and
f64; NaN and inf Gram entries at some positions); gradients; and
timings, K9 and K10 also at the headline batches. Then the irregular-sampling
path: the fused nonuniform fit K11 (and its planes mode K11p) and the
resample gather-evaluate K12 against their plain versions over grids of
orders, shapes, x and t dtypes (epoch-scale time stamps included), masks
and query sets; ``savgol_apply_nonuniform`` and ``savgol_resample`` at
``bench.py``'s (8, 131,072) rows against float64, with each entry point's
launches counted; gradients; and timings, K11 also at the 1D headline
batch. Then the padded-boundary and filter-bank paths: the fused-pad apply
K2 and the K-stencil bank K4 against their plain versions over grids of
windows, pad modes, bank sizes, shapes and dtypes (K4 also on rows with NaN
and inf samples, whose pattern must match exactly); the padded
``Savgol1D.apply``, ``SavgolBank.smooth_and_derivatives(12, 4, 2)`` and the
(n, m) sweep at full size against float64, ``scipy_compat.savgol_filter`` in
all five modes against scipy, each entry point's launches counted (and
the scipy modes' host pads, ``ops.cuda_conv.PADS``, K2's mapped ones,
``ops.cuda_conv.MAPPED``, and a warm call's held weights,
``scipy_compat.WEIGHTS``);
gradients; and timings beside the route the padded modes took before K2.
Then K1, K2 and K3 at window 101 against their plain versions and
``scipy_compat.savgol_filter`` on a numpy array at window 101 against scipy.
Then the sharded paths, on one pool of four ranks that share the card
(``savgol_tpu_torch.parallel.launch``, a ``gloo`` group): the ring
halo-exchange kernel K13 bit for bit against the neighbours' slices and its
plain version over rows, halo widths, dtypes and ring sizes, 50 exchanges
back to back, on the stream route the ranks take and on the SM route; K13
in one process with four ring members on four streams (no time-slicer) on
both routes; ``apply_sharded(..., halo="rdma")`` on the 1D headline split
four ways against the single-device apply and float64, and
``apply2d_sharded`` on the 2D headline by rows and by 2 x 2 tiles, each
call's launches counted on every rank; float64 gradients through K13; and
timings by rank; the same four ranks with ``method="bf16"``.
Then ``method="bf16"``: K1, K2, K3 and K2D-dense in their bf16 mode (on
the tensor cores: ``csrc/sg1d_bf16.cuh`` in 1D, ``csrc/corr2d_bf16_mma.cu``
in 2D) against their bf16 plain versions over grids of windows (to 129 taps
in 1D, K3 also at one tap and even windows; 33 x 33 in 2D), batches,
lengths, boundaries, stacks and f32 / bf16 storage (one
bf16 ulp; 2D f32 sums 2e-6 scaled, 1e-5 at random stencils); every stencil
kernel (K1-K3 and their bf16 modes, K2D-dense with one stencil and three,
K7, K2D-dense's bf16 mode) on input holding NaN, +inf and -inf, whose
pattern must equal the plain version's exactly; the 1D and 2D
headlines in bf16 through
``Savgol1D.apply`` / ``apply_valid`` (all four boundaries), ``Savgol2D.apply``
and ``savgol2d_hessian``, each one launch, within ``bench.py``'s 5e-3
contract of float64; ``scipy_compat`` in bf16 against scipy; f64 gradients;
times beside the bounds and ``F.conv1d`` / ``F.conv2d`` on bf16. Then the
attribution probes P3 (``probes/bf16_1d.py``) and P2
(``probes/rowband2d.py``), each variant K3-bf16 or K6a-bf16 with one cost
term removed, at the headlines against their plain versions, with their
times, the split of K3-bf16's and K6a-bf16's times they give, and the
device operations of one ``apply_valid(method="bf16")`` call. Then P1 (``probes/dma1d.py``), the double-buffered VALID
correlation, against its plain version and bit for bit against K3 over the
JAX probe's geometries, windows, N of each residue mod 4 and short
``n_out``, and at the JAX bench's geometry (128 x (2^20 + 128), its (rows,
cols) variants, B = 256, N = 2^20 + 173) timed beside K3, ``F.conv1d`` and
its bound. Then streaming on the card (``SavgolConfig(12, 4)``, f32 and
f64): the push protocol over 8,192 samples against ``Savgol1D.apply`` and
its host time a push, ``stream_apply`` (one K3 launch) against float64, 64
chunks of 8,192 and of 65,536 samples (one K3 launch a chunk) against the
batch apply with their throughput, and checkpoints resumed bit for bit.
Then the modules with no kernel of their own (phase 39): the weight
generators on the card (``savgol_weights``, ``savgol2d_weights``) against
the host float64 tables and bit for bit with TF32 allowed,
``Savgol1D.create_on_device(...).apply`` at the 1D headline (one K1 launch),
the host C++ engine (``savgol_tpu_torch.native``) against the card's 1D and
2D applies, ``utils.profiling.benchmark_chained`` beside K1's device time,
and the device idle share of one headline apply and of one stream chunk
(and of 20 of each back to back) from ``utils.profiling.trace_events``.
Beside each kernel's time it prints its bound (bytes or operations
at the data sheet's rates) and, where one PyTorch call computes the same
function, that call's time. Every phase prints one line; any failure raises
and the script exits nonzero. The last line is the JSON device record; the
line before it lists the kernels.

Exits nonzero without a CUDA device. Imports nothing of JAX.
"""

from __future__ import annotations

import itertools
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

# every bound printed beside a kernel's time: the least time the card could
# take for its work (bytes at the memory rate, operations at the data
# sheet's peak of their type)
from savgol_tpu_torch.utils.roofline import (
    nonuniform_dd_flops, nonuniform_flops, speed_of_light_1d,
    speed_of_light_2d, speed_of_light_bank_1d, speed_of_light_bank_2d,
    speed_of_light_halo, speed_of_light_masked_1d, speed_of_light_masked_2d,
    speed_of_light_nonuniform, speed_of_light_nonuniform_dd,
    speed_of_light_nonuniform_planes, speed_of_light_plane_solve,
    speed_of_light_plane_solve_dd, speed_of_light_resample,
    speed_of_light_separable_2d, speed_of_light_valid_1d)

B_FULL, N_FULL = 128, 1 << 20
F32_TOL = 2e-6      # scaled by max(1, max|ref|): summation order, dt folding
F64_TOL = 1e-12
GATE_ABS = 1e-6     # BASELINE.md contract: max abs error vs the f64 oracle

IMG_FULL = (16, 2048, 2048)    # bench.py's 2D batch, 11x11 order 3 window
# the JAX package's exact-2D gate (tests/test_2d.py:387, bench.py:471),
# scaled by max(1, max|ref|)
F32_TOL_2D = 1e-5
WINDOWS_2D = ((3, 3), (5, 3), (11, 11), (7, 13), (15, 17), (23, 23),
              (33, 33), (17, 25))
# wide windows at the orders whose f32 smoothing stencils factor to ranks 3
# and 4 (Savgol2D's auto route sends them to K2D-sep; 17 x 25 runs its
# runtime-width sweep): (H, W, order)
RANKED_2D = ((21, 21, 4), (33, 33, 6), (17, 25, 4))
# the last image is shorter than the pad of every window but 3 x 3
IMAGES_2D = ((1, 2047, 2049), (3, 37, 29), (2, 3, 5))
BOUNDARIES_2D = ("valid", "constant", "reflect", "periodic")
DERIVS_2D = ([(1, 1)], [(1, 0), (0, 1)], [(2, 0), (1, 1), (0, 2)])


# the masked (missing-data) path: bench.py:581-633's rows, holes at 20%
MASK_FRAC = 0.2
MASKED_1D = (64, 131_072)      # n = 12, m = 4, fill 0; "qr" on 8 rows
MASKED_2D = (1024, 1024)       # 11x11, order 3, fill 0
MASKED_1D_HEAD = (B_FULL, N_FULL)   # K9 timed alone at the 1D headline batch
# gates: tests/test_fused_masked.py (K9 vs its plain version, 2e-5 scaled),
# bench.py:601-605 (2e-4 abs vs f64 on windows >= 18 of 25 valid),
# tests/test_masked.py:240 (qr 5e-5 scaled vs f64), and
# tests/test_masked2d_fused.py:60-81 (K10 5e-5 scaled vs f64)
K9_TOL, K9_SLICE_ABS, QR_TOL, K10_TOL = 2e-5, 2e-4, 5e-5, 5e-5
MASKED_F64_TOL = 1e-9
WELL = 0.7                     # "well covered": >= 70% of a window valid
BOUNDARIES_MASKED = ("truncate", "constant", "reflect", "periodic")
# every compile-time instance of K8b (k <= 8) and of K8a (10, 15), then
# the runtime forms (21 and 28 in local arrays, 33 in device scratch)
K8_KS = (1, 2, 3, 4, 5, 6, 7, 8, 10, 15, 21, 28, 33)
# (n, m, d): m up to 2n, k past the local arrays at m = 40; k = m + 1 from
# 1 to 8 on the compile-time instances (n = 12 fixes the window too), k = 9
# on the runtime one
K9_CONFIGS = ((2, 2, 0), (2, 4, 1), (4, 2, 2), (12, 4, 1), (32, 6, 0),
              (64, 3, 1), (64, 40, 0), (3, 0, 0), (5, 1, 1), (12, 5, 2),
              (12, 7, 0), (16, 8, 1))
K9_GRID_FRAC = 0.12            # holes in the K9 and K10 grids
# (nx, ny, m): 3x3, 5x5, 11x11, 7x13 and 23x23 windows, orders 2-4 (5x5
# order 4 is left out: 15 terms in 25 samples, nearly determined under
# holes), then order 6 (P = 28) at 23x23 and the largest window, 33x33;
# then orders 1 and 0 (P = 3, 1) and order 5 (P = 21, the runtime instance
# next to the compile-time P = 15)
K10_CONFIGS = ((1, 1, 2), (2, 2, 2), (2, 2, 3), (5, 5, 2),
               (5, 5, 3), (5, 5, 4), (3, 6, 2), (3, 6, 3), (3, 6, 4),
               (11, 11, 2), (11, 11, 3), (11, 11, 4), (11, 11, 6),
               (16, 16, 6), (2, 2, 1), (4, 4, 0), (8, 8, 5))
K10_DERIVS = ((0, 0), (1, 0), (0, 1), (1, 1), (2, 0))

# the irregular-sampling path: bench.py:635-661's rows, uncut (n = 12, m = 4,
# fill 0, f32; t = cumsum(U(0, 1) + 0.5)), nonuniform also with 20% holes;
# K11 also timed alone at the 1D headline batch
NONUNI = (8, 131_072)
# (n, m, d): up to 2n = 200 (past the TPU kernel's 2n <= 128), k = m + 1
# from 1 to 8 (every compile-time instance; 7 and 8 keep L in shared
# memory); and (n, m) with k = m + 1 = 41, past the compile-time instances
# (device scratch)
K11_CONFIGS = ((2, 1, 0), (3, 2, 2), (12, 4, 0), (12, 4, 1), (32, 6, 2),
               (100, 3, 1), (3, 0, 0), (12, 5, 1), (12, 7, 2))
K11_SCRATCH = (24, 40)
# (x dtype, t dtype, offset of t): epoch-scale f64 time stamps included
K11_TYPES = ((torch.float32, torch.float32, 0.0),
             (torch.float32, torch.float64, 0.0),
             (torch.float32, torch.float64, 1.6e9),
             (torch.float64, torch.float64, 0.0),
             (torch.float64, torch.float64, 1.6e9))
K11_HOLES = (0.0, 0.1, 0.5)
# gates: tests/test_hw_parity.py:499-503 (the on-chip planes gate, 1e-5
# scaled) for kernel vs plain in f32, and :519 / :460 (1e-4 scaled) for the
# bench rows against f64 and auto against direct
NONUNI_F32_TOL, NONUNI_F64_TOL, NONUNI_SLICE_TOL = 1e-5, 1e-12, 1e-4

def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def max_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max abs error, max(1, max|want|)) in float64."""
    got, want = got.double(), want.double()
    return ((got - want).abs().max().item(),
            max(1.0, want.abs().max().item()))


def grid_2d(sgt, c2, dev) -> str:
    """Every window x boundary x stack x image x dtype through "auto" and
    "sep", each against the plain dense version (method="xla")."""
    from savgol_tpu_torch.ops.apply2d import _factors, _stencil_stack
    rng = np.random.default_rng(3)
    worst = {"corr2d_valid": 0.0, "corr2d_sep": 0.0}
    cases, ranks = 0, set()
    c2.reset_launches()
    windows = [(H, W, 2 if min(H, W) == 3 else 3) for H, W in WINDOWS_2D]
    for dtype, tol in ((torch.float32, F32_TOL_2D), (torch.float64, F64_TOL)):
        for shape in IMAGES_2D:
            x = torch.from_numpy(rng.standard_normal(shape)).to(dev, dtype)
            for H, W, order in windows + list(RANKED_2D):
                smooth = ([(0, 0)],) if (H, W, order) in RANKED_2D else ()
                for derivs in DERIVS_2D + smooth:
                    ws, s = (torch.from_numpy(a).to(dev) for a in
                             _stencil_stack((W - 1) // 2, (H - 1) // 2,
                                            order, derivs, 0.5, 0.25))
                    ranks.update(u.shape[0] for u, _ in
                                 _factors(ws, dtype, dev))
                    for bnd in BOUNDARIES_2D:
                        if bnd == "valid" and (shape[1] < H or shape[2] < W):
                            continue
                        for method in ("xla", "auto", "sep"):
                            if len(derivs) == 1:
                                y = sgt.savgol2d_apply(
                                    x, ws[0], boundary=bnd, scale=s[0],
                                    method=method)
                            else:
                                y = sgt.savgol2d_apply_stack(
                                    x, ws, boundary=bnd, scales=s,
                                    method=method)
                            if method == "xla":
                                want = y
                                continue
                            e, sc = max_err(y, want)
                            require(e <= tol * sc, f"2D {method} {dtype} "
                                    f"{shape} {H}x{W} K={len(derivs)} "
                                    f"{bnd}: {e:.3e} (scale {sc:.3e})")
                            kernel = ("corr2d_sep" if method == "sep"
                                      or max(H, W) > 17 else "corr2d_valid")
                            worst[kernel] = max(worst[kernel], e / sc)
                            cases += 1
    torch.cuda.synchronize()
    launches = dict(c2.LAUNCHES)
    require(all(v > 0 for v in launches.values()),
            f"2D grid did not reach every kernel: {launches}")
    require({1, 2, 3, 4} <= ranks, f"2D grid reached ranks {sorted(ranks)}")
    return (f"2D grid: {cases} cases (K2D-sep ranks {sorted(ranks)}), "
            f"worst scaled error "
            f"dense={worst['corr2d_valid']:.3e} sep={worst['corr2d_sep']:.3e}"
            f" (tol f32 {F32_TOL_2D}, f64 {F64_TOL}), launches {launches}")


# -- the masked path ---------------------------------------------------------


def kernel_modules():
    from savgol_tpu_torch.ops import (cuda_bank, cuda_conv, cuda_conv2d,
                                      cuda_halo, cuda_masked, cuda_masked2d,
                                      cuda_nonuniform, cuda_resample,
                                      cuda_solve)
    from savgol_tpu_torch.probes import bf16_1d, dma1d, rowband2d
    return (cuda_conv, cuda_bank, cuda_conv2d, cuda_solve, cuda_masked,
            cuda_masked2d, cuda_nonuniform, cuda_resample, cuda_halo,
            bf16_1d, rowband2d, dma1d)


def counted_all(run, want: dict, what: str):
    """run() with every kernel's launch count zeroed just before and read
    just after; kernels not named in ``want`` must not launch."""
    mods = kernel_modules()
    torch.cuda.synchronize()
    for mod in mods:
        mod.reset_launches()
    out = run()
    torch.cuda.synchronize()
    got = {}
    for mod in mods:
        got.update(mod.LAUNCHES)
    expect = {k: want.get(k, 0) for k in got}
    require(got == expect, f"{what} launched {got}, expected {expect}")
    return out, got


def nz(launches: dict) -> dict:
    """The kernels of a launch count that ran."""
    return {k: v for k, v in launches.items() if v}


def holed(rng, shape, frac):
    """float32 values with NaN holes (as float64) and their validity."""
    x = rng.standard_normal(shape).astype(np.float32).astype(np.float64)
    valid = rng.random(shape) >= frac
    x[~valid] = np.nan
    return x, valid


def coverage(valid: torch.Tensor, boundary: str, nx: int, ny=None):
    """Share of each output's window samples that are valid, the window
    extended by the boundary's padding as the masked path pads (1D when
    ``ny`` is None)."""
    import torch.nn.functional as F
    from savgol_tpu_torch.config import PAD_MODE, Boundary2D, BoundaryMode
    from savgol_tpu_torch.ops.apply2d import _PAD_MODE_2D
    from savgol_tpu_torch.ops.cuda_conv import correlate_valid_plain, pad_last
    from savgol_tpu_torch.ops.cuda_conv2d import (correlate2d_valid_plain,
                                                  pad2d_plain)
    ind = valid.to(torch.float64)
    trunc = boundary == "truncate"
    if ny is None:
        p = pad_last(ind, nx, None if trunc
                     else PAD_MODE[BoundaryMode(boundary)])
        ones = torch.ones(2 * nx + 1, dtype=ind.dtype, device=ind.device)
        return correlate_valid_plain(p, ones) / (2 * nx + 1)
    p = (F.pad(ind, (nx, nx, ny, ny)) if trunc else
         pad2d_plain(ind, ny, nx, _PAD_MODE_2D[Boundary2D(boundary)]))
    area = (2 * nx + 1) * (2 * ny + 1)
    ones = torch.ones(2 * ny + 1, 2 * nx + 1, dtype=ind.dtype,
                      device=ind.device)
    return correlate2d_valid_plain(p, ones) / area


def masked_err(got, want, tol, where, what, decided=None):
    """Scaled max error of ``got`` against ``want`` on the outputs finite in
    both and in ``where``; finiteness must agree on ``decided`` (everywhere
    by default). Returns (scaled error, finiteness mismatches elsewhere)."""
    got, want = got.double(), want.double()
    fg, fw = torch.isfinite(got), torch.isfinite(want)
    differ = fg != fw
    if decided is None:
        decided = torch.ones_like(differ)
    bad = int((differ & decided).sum())
    require(bad == 0, f"{what}: finiteness differs at {bad} decided outputs")
    sel = fg & fw & where
    if not bool(sel.any()):
        return 0.0, int(differ.sum())
    scale = max(1.0, want[sel].abs().max().item())
    err = (got - want)[sel].abs().max().item() / scale
    require(err <= tol, f"{what}: scaled error {err:.3e} > {tol:.1e}")
    return err, int(differ.sum())


def spd_planes(rng, k: int, pos: int):
    """Random SPD Gram planes for the K8 checks: (gram (Kp, pos), pair
    table, rhs (k, pos), noise for the lo words, quorum (90%), scaled
    (5%: one column 1e-5, rejected by rcond), rank-one (5%: a shifted
    factor))."""
    A = rng.standard_normal((pos, 3 * k + 2, k))
    scaled = rng.random(pos) < 0.05
    A[scaled, :, -1] *= 1e-5
    G = np.einsum("pwi,pwj->pij", A, A) / (3 * k + 2)
    v = rng.standard_normal((pos, k))
    rank_one = (rng.random(pos) < 0.05) & ~scaled
    G[rank_one] = np.einsum("pi,pj->pij", v, v)[rank_one]
    pi = np.zeros((k, k), np.int32)
    iu = [(a, b) for a in range(k) for b in range(a, k)]
    for e, (a, b) in enumerate(iu):
        pi[a, b] = pi[b, a] = e
    gram = np.stack([G[:, a, b] for a, b in iu])
    rhs = rng.standard_normal((k, pos))
    lo_noise = rng.standard_normal(gram.shape)
    quorum = rng.random(pos) < 0.9
    return gram, pi, rhs, lo_noise, quorum, scaled, rank_one


# f32 and f64 pairs: (dtype, tolerance, rcond, lo words' scale)
K8_TYPES = ((torch.float32, 1e-5, 1e-6, 2.0 ** -30),
            (torch.float64, 1e-12, 1e-8, 2.0 ** -60))


def k8_grid(dev) -> str:
    """K8a and K8b against their plain versions over k, dtype and rcond on
    random SPD planes with under-quorum, badly scaled (rcond-rejected) and
    rank-one (shifted-factor) positions."""
    from savgol_tpu_torch.ops import cuda_solve as cs
    from savgol_tpu_torch.ops import lsq
    rng = np.random.default_rng(8)
    worst = {"K8a": 0.0, "K8b": 0.0}
    cases = 0
    cs.reset_launches()
    for k in K8_KS:
        pos = 20_000 if k <= 10 else 3_000
        gram, pi, rhs, lo_noise, quorum, scaled, rank_one = spd_planes(
            rng, k, pos)
        quorum = torch.from_numpy(quorum).to(dev)
        good = torch.from_numpy(~scaled & ~rank_one).to(dev)
        # where ok must agree: off the rank-one Grams, whose factor is
        # rounding noise; in f32 also off the scaled ones (cond 1e10, past
        # 1/eps); in f64 rcond 1e-8 rejects those on both sides
        decided = {torch.float32: good,
                   torch.float64: torch.from_numpy(~rank_one).to(dev)}
        for dtype, tol, rc, ulp in K8_TYPES:
            g = torch.from_numpy(gram).to(dev, dtype)
            r = torch.from_numpy(rhs).to(dev, dtype)
            # lo words below half an ulp of the hi words
            glo = (g.double() * torch.from_numpy(lo_noise).to(dev) * ulp
                   ).to(dtype)
            rlo = torch.zeros_like(r)
            for rcond in (None, rc):
                for name in ("K8a", "K8b"):
                    if name == "K8a":
                        got, ok = cs.plane_solve_cuda(g, pi, r, quorum, rcond)
                        want, wok = lsq.cholesky_solve_planes(g, pi, r, quorum,
                                                              rcond)
                    else:
                        got, ok = cs.plane_solve_dd_cuda(g, glo, pi, r, rlo,
                                                         quorum, rcond)
                        want, wok = lsq.cholesky_solve_planes_dd(
                            g, glo, pi, r, rlo, quorum, rcond)
                    what = f"{name} k={k} {dtype} rcond={rcond}"
                    sel = decided[dtype]
                    require(torch.equal(ok[sel], wok[sel]),
                            f"{what}: ok differs")
                    e, s = max_err(got[:, good], want[:, good])
                    require(e <= tol * s, f"{what}: {e:.3e} (scale {s:.3e})")
                    worst[name] = max(worst[name], e / s)
                    cases += 1
    torch.cuda.synchronize()
    launches = dict(cs.LAUNCHES)
    require(all(v > 0 for v in launches.values()),
            f"K8 grid did not reach every kernel: {launches}")
    return (f"K8 grid: {cases} cases (k {K8_KS}, f32/f64, rcond off/on), "
            f"worst scaled error K8a={worst['K8a']:.3e} "
            f"K8b={worst['K8b']:.3e} (tol f32 1e-5, f64 1e-12), ok "
            f"identical where decided, launches {launches}")


def k8b_forms(dev) -> str:
    """K8b's compile-time instances (dd_chol_solve<K>, k <= 8) against its
    runtime form (``runtime_form=True``) on the same stored planes: the
    coefficients bit for bit and ok identical at every position, under-
    quorum, rcond-rejected and rank-one ones included, for f32 and f64
    pairs, rcond off and on."""
    from savgol_tpu_torch.ops import cuda_solve as cs
    rng = np.random.default_rng(12)
    cases = 0
    for k in range(1, 9):
        gram, pi, rhs, lo_noise, quorum, _, _ = spd_planes(rng, k, 20_000)
        quorum = torch.from_numpy(quorum).to(dev)
        for dtype, _, rc, ulp in K8_TYPES:
            g = torch.from_numpy(gram).to(dev, dtype)
            glo = (g.double() * torch.from_numpy(lo_noise).to(dev) * ulp
                   ).to(dtype)
            r = torch.from_numpy(rhs).to(dev, dtype)
            rlo = (r.double() * ulp / 3).to(dtype)
            for rcond in (None, rc):
                got, ok = cs.plane_solve_dd_cuda(g, glo, pi, r, rlo, quorum,
                                                 rcond)
                want, wok = cs.plane_solve_dd_cuda(g, glo, pi, r, rlo, quorum,
                                                   rcond, runtime_form=True)
                what = f"K8b k={k} {dtype} rcond={rcond}"
                bits = torch.int32 if dtype == torch.float32 else torch.int64
                require(torch.equal(got.view(bits), want.view(bits)),
                        f"{what}: dd_chol_solve<{k}> differs from the "
                        "runtime form")
                require(torch.equal(ok, wok), f"{what}: ok differs from the "
                        "runtime form's")
                cases += 1
    torch.cuda.synchronize()
    return (f"K8b forms: dd_chol_solve<K> bit-equal to the runtime form, ok "
            f"identical everywhere, {cases} cases (k 1-8, f32/f64 pairs, "
            "rcond off/on; under-quorum, rcond-rejected and rank-one "
            "positions)")


def k9_cases(n: int, m: int):
    """(shape, dtype, weighted, boundary, hole share) for the K9 grid."""
    f32, f64 = torch.float32, torch.float64
    if m > 10:
        # 861 pair stencils: the plain version takes ~1 s a call. A degree-40
        # fit over 129 samples gives a window's end samples a leverage of ~1,
        # so one hole there leaves G singular for any solver: hole-free,
        # every window whole (reflect)
        return [((3, 131), f64, False, "reflect", 0.0),
                ((3, 131), f32, True, "reflect", 0.0)]
    cases = [(shape, dt, w, b, K9_GRID_FRAC)
             for shape in ((1, 2 * n + 1), (3, 131), (3, 4099))
             for dt in (f32, f64) for w in (False, True)
             for b in BOUNDARIES_MASKED]
    # the bench shape once a dtype, the boundary turning with n
    cases += [(MASKED_1D, dt, bool(i), BOUNDARIES_MASKED[(n + i) % 4],
               K9_GRID_FRAC) for i, dt in enumerate((f32, f64))]
    return cases


def k9_grid(sgt, dev) -> str:
    """K9 (savgol_apply_masked, solver="normal") against the plain staged
    version on the card over n, m, d, shapes, dtypes, masks and boundaries,
    then the JAX package's two K9 gates that its moment-form kernel misses
    (fault R1)."""
    from savgol_tpu_torch.ops import cuda_masked as c9
    rng = np.random.default_rng(9)
    worst = {torch.float32: 0.0, torch.float64: 0.0}
    cases = 0
    c9.reset_launches()
    for n, m, d in K9_CONFIGS:
        for shape, dtype, weighted, bnd, frac in k9_cases(n, m):
            x_np, valid_np = holed(rng, shape, frac)
            x = torch.from_numpy(x_np).to(dev, dtype)
            valid = torch.from_numpy(valid_np).to(dev)
            mask = valid
            if weighted:
                mask = torch.from_numpy(np.where(
                    valid_np, rng.uniform(0.2, 2.0, shape), 0.0).astype(
                    np.float32)).to(dev, dtype)
            kw = dict(half_window=n, poly_order=m, derivative=d,
                      time_step=0.5, mask=mask, boundary=bnd)
            got = sgt.savgol_apply_masked(x, **kw)
            want = sgt.savgol_apply_masked(x, method="xla", **kw)
            tol = K9_TOL if dtype == torch.float32 else MASKED_F64_TOL
            well = coverage(valid, bnd, n) >= WELL
            e, _ = masked_err(got, want, tol, well,
                              f"K9 n={n} m={m} d={d} {shape} {dtype} "
                              f"weighted={weighted} {bnd}")
            worst[dtype] = max(worst[dtype], e)
            cases += 1
    # tests/test_fused_masked.py::test_weighted and
    # ::test_odd_length_partial_block, their data and gates, on the card
    named = {}
    for name, seed, shape, n, m, weighted in (
            ("test_weighted", 7, (2, 400), 6, 3, True),
            ("test_odd_length_partial_block", 13, (1, 131), 4, 2, False)):
        r = np.random.default_rng(seed)
        x_np = r.standard_normal(shape).astype(np.float32)
        valid_np = r.random(shape) > 0.15
        x_np[~valid_np] = np.nan
        mask = torch.from_numpy(valid_np).to(dev)
        if weighted:
            mask = torch.from_numpy(np.where(
                valid_np, r.uniform(0.2, 2.0, shape), 0.0).astype(
                np.float32)).to(dev)
        x = torch.from_numpy(x_np).to(dev)
        kw = dict(half_window=n, poly_order=m, mask=mask)
        got = sgt.savgol_apply_masked(x, **kw)
        want = sgt.savgol_apply_masked(x, method="xla", **kw)
        fin = torch.isfinite(want)
        require(torch.equal(torch.isfinite(got), fin), f"K9 {name}: fill")
        err = (got - want)[fin].abs().max().item()
        gate = K9_TOL * (max(1.0, want[fin].abs().max().item())
                         if weighted else 1.0)
        require(err <= gate, f"K9 {name}: {err:.3e} > {gate:.3e}")
        named[name] = err
    torch.cuda.synchronize()
    require(c9.LAUNCHES["masked1d"] == cases + 2,
            f"K9 grid launched {c9.LAUNCHES}, expected {cases + 2}")
    return (f"K9 grid: {cases} cases, worst scaled error on windows >= "
            f"{WELL:.0%} valid f32={worst[torch.float32]:.3e} "
            f"f64={worst[torch.float64]:.3e} (tol {K9_TOL}, "
            f"{MASKED_F64_TOL}), finiteness identical everywhere; "
            + ", ".join(f"{k} {v:.3e}" for k, v in named.items())
            + f" (gate {K9_TOL}); launches {dict(c9.LAUNCHES)}")


def k10_grid(sgt, dev) -> str:
    """K10 (savgol2d_apply_masked, method="auto") in f32 and f64 against the
    plain staged version in f64 over windows, orders, derivatives, masks,
    boundaries and the images of IMAGES_2D. The two use different bases (a
    tensor-product basis for the Gram moments, a joint QR basis), so the
    rcond rule may decide differently where the window's samples barely
    determine the fit: finiteness must agree on windows >= 70% valid, and
    the mismatches elsewhere are counted."""
    from savgol_tpu_torch.ops import cuda_masked2d as c10
    rng = np.random.default_rng(10)
    worst = {torch.float32: 0.0, torch.float64: 0.0}
    cases = loose = 0
    c10.reset_launches()
    for ci, (nx, ny, m) in enumerate(K10_CONFIGS):
        dx, dy = K10_DERIVS[ci % len(K10_DERIVS)]
        if dx + dy > m:
            dx, dy = 0, 0
        for si, shape in enumerate(IMAGES_2D):
            x_np, valid_np = holed(rng, shape, K9_GRID_FRAC)
            x64 = torch.from_numpy(x_np).to(dev)
            valid = torch.from_numpy(valid_np).to(dev)
            w64 = torch.from_numpy(np.where(
                valid_np, rng.uniform(0.2, 2.0, shape), 0.0).astype(
                np.float32).astype(np.float64)).to(dev)
            for weighted in (False, True):
                for bi, bnd in enumerate(BOUNDARIES_MASKED):
                    # the 4 M pixel image once a configuration up to order
                    # 4 (the plain version's 406 order-6 Gram planes would
                    # take 14 GB a copy there)
                    if si == 0 and (m > 4 or bi != ci % 4
                                    or weighted != bool(ci % 2)):
                        continue
                    kw = dict(half_window_x=nx, half_window_y=ny,
                              poly_order=m, deriv_x=dx, deriv_y=dy,
                              delta_x=0.5, delta_y=2.0, boundary=bnd)
                    mask64 = w64 if weighted else valid
                    want = sgt.savgol2d_apply_masked(
                        x64, mask=mask64, method="xla", **kw)
                    well = coverage(valid, bnd, nx, ny) >= WELL
                    for dtype in (torch.float32, torch.float64):
                        mask = mask64.to(dtype) if weighted else valid
                        got = sgt.savgol2d_apply_masked(
                            x64.to(dtype), mask=mask, **kw)
                        tol = (K10_TOL if dtype == torch.float32
                               else MASKED_F64_TOL)
                        e, nloose = masked_err(
                            got, want, tol, well,
                            f"K10 {nx}x{ny} m={m} d=({dx},{dy}) {shape} "
                            f"{dtype} weighted={weighted} {bnd}",
                            decided=well)
                        worst[dtype] = max(worst[dtype], e)
                        loose += nloose
                        cases += 1
    torch.cuda.synchronize()
    require(c10.LAUNCHES["masked2d"] == cases,
            f"K10 grid launched {c10.LAUNCHES}, expected {cases}")
    return (f"K10 grid: {cases} cases vs f64 plain, worst scaled error on "
            f"windows >= {WELL:.0%} valid f32={worst[torch.float32]:.3e} "
            f"f64={worst[torch.float64]:.3e} (tol {K10_TOL}, "
            f"{MASKED_F64_TOL}); {loose} outputs on thinner windows decided "
            f"differently by rcond; launches {dict(c10.LAUNCHES)}")


# positions (row, col) of the masked 2D slice where K8a's Gram planes are
# made non-finite: a NaN through every plane, +inf and -inf in one plane
K8A_BAD_AT = ((100, 100, "nan"), (200, 300, "inf"), (511, 7, "-inf"))


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal values and NaN in the same places."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(torch.where(na, 0, a),
                                               torch.where(nb, 0, b))


def k8a_planes_bit_equal(mk, cs, lsq, img, valid) -> str:
    """K8a against ``lsq.cholesky_solve_planes`` bit for bit (coefficients
    and ok) on the masked 2D slice's own planes: the fused route's 11 x 11
    order 3 (P = 10) and the staged route's 3 x 11 order 4 (P = 15), in f32
    and f64, with non-finite Gram entries at ``K8A_BAD_AT``; and at 3 x 11
    order 2 (P = 6, the runtime instance)."""
    import torch.nn.functional as F
    done = []
    for nx, ny, m in ((5, 5, 3), (1, 5, 4), (1, 5, 2)):
        Qm, _, pwm, pim, _ = mk._masked_tables_2d(nx, ny, m)
        P, area = Qm.shape[0], (2 * nx + 1) * (2 * ny + 1)
        xv = F.pad(torch.where(valid, img, 0.0), (nx, nx, ny, ny))
        wp = F.pad(valid.float(), (nx, nx, ny, ny))
        for dtype in (torch.float32, torch.float64):
            gram = mk._corr2d_bank(wp.to(dtype), pwm, True)
            rhs = mk._corr2d_bank(xv.to(dtype), Qm, True)
            quorum = gram[int(pim[0, 0])] * area >= P - 0.5
            for i, (r, c, v) in enumerate(K8A_BAD_AT):
                if i == 0:
                    gram[:, r, c] = float(v)
                else:
                    gram[i, r, c] = float(v)
            got, ok = cs.plane_solve_cuda(gram, pim, rhs, quorum, 1e-6)
            want, wok = lsq.cholesky_solve_planes(gram, pim, rhs, quorum,
                                                  1e-6)
            what = f"K8a {2 * nx + 1}x{2 * ny + 1} order {m} (P = {P}) {dtype}"
            require(same_bits(got, want), f"{what}: coefficients differ")
            require(torch.equal(ok, wok), f"{what}: ok differs")
            require(not bool(torch.isfinite(got[:, 100, 100]).any()),
                    f"{what}: a NaN Gram gave finite coefficients")
            done.append(f"P={P} {str(dtype)[6:]}")
    return ", ".join(done)


def masked_slice(sgt, dev, card) -> list:
    """The masked path at the bench sizes through the user's entry points:
    launch counts per entry point, accuracy against f64, gradients, and
    CUDA-event timings of each kernel and its plain version. Returns the
    masked kernels' records for the {"kernels": ...} line."""
    from savgol_tpu_torch.ops import cuda_masked as c9
    from savgol_tpu_torch.ops import cuda_masked2d as c10
    from savgol_tpu_torch.ops import cuda_solve as cs
    from savgol_tpu_torch.ops import lsq
    from savgol_tpu_torch.ops import masked as mk
    from savgol_tpu_torch.utils.timing import cuda_time_ms, device_ms

    rng = np.random.default_rng(1002)
    x_np, valid_np = holed(rng, MASKED_1D, MASK_FRAC)
    x = torch.from_numpy(x_np).to(dev, torch.float32)
    valid = torch.from_numpy(valid_np).to(dev)
    kw1 = dict(half_window=12, poly_order=4, mask=valid, fill=0.0)
    # -- launch counts, one zeroed window an entry point --
    y1, l_normal = counted_all(lambda: sgt.savgol_apply_masked(x, **kw1),
                               {"masked1d": 1}, "savgol_apply_masked")
    yq, l_qr = counted_all(
        lambda: sgt.savgol_apply_masked(x[:8], solver="qr", **{
            **kw1, "mask": valid[:8]}),
        {"plane_solve_dd": 1}, "savgol_apply_masked(solver='qr')")
    rng2 = np.random.default_rng(1003)
    img_np, valid2_np = holed(rng2, MASKED_2D, MASK_FRAC)
    img = torch.from_numpy(img_np).to(dev, torch.float32)
    valid2 = torch.from_numpy(valid2_np).to(dev)
    kw2 = dict(half_window_x=5, half_window_y=5, poly_order=3, mask=valid2,
               fill=0.0)
    y2, l_2d = counted_all(lambda: sgt.savgol2d_apply_masked(img, **kw2),
                           {"masked2d": 1}, "savgol2d_apply_masked")
    # outside fused2d_supported: two K2D-dense banks (the weights with the
    # pair stencils, the values with the basis stencils), then K8a
    y2u, l_2du = counted_all(
        lambda: sgt.savgol2d_apply_masked(
            img[:256, :256], half_window_x=1, half_window_y=5,
            poly_order=3, mask=valid2[:256, :256], fill=0.0),
        {"corr2d_valid": 2, "plane_solve": 1},
        "savgol2d_apply_masked(3x11 window, order 3)")

    # -- accuracy: f32 results against the same data in f64, plain staged --
    counts1 = coverage(valid, "truncate", 12) * 25
    ref1 = sgt.savgol_apply_masked(x.double(), method="xla", **kw1)
    require(y1.shape == x.shape and bool(torch.isfinite(y1).all()),
            "masked 1D output shape or finiteness")
    # the fill (0) wherever the reference fills; the check that every other
    # 0 is a computed value follows K9 at fill=NaN below
    z1, zr = y1 == 0, ref1 == 0
    require(torch.equal(z1 & zr, zr), "masked 1D fill pattern")
    require(torch.equal(zr, counts1 < 4.5), "masked 1D quorum")
    e1 = (y1.double() - ref1)[counts1 >= 18].abs().max().item()
    require(e1 <= K9_SLICE_ABS, f"masked 1D vs f64: {e1:.3e}")
    eq, _ = masked_err(yq, ref1[:8], QR_TOL, torch.ones_like(valid[:8]),
                       "masked 1D qr vs f64")
    require(torch.equal(yq == 0, ref1[:8] == 0), "qr fill pattern")
    ref2 = sgt.savgol2d_apply_masked(img.double(), method="xla", **kw2)
    det = (ref2 != 0) & (y2 != 0)
    require(torch.equal(ref2 == 0, y2 == 0), "masked 2D fill pattern")
    e2, _ = masked_err(y2, ref2, K10_TOL, det, "masked 2D vs f64")
    ref2u = sgt.savgol2d_apply_masked(
        img[:256, :256].double(), half_window_x=1, half_window_y=5,
        poly_order=3, mask=valid2[:256, :256], fill=0.0, method="xla")
    e2u, _ = masked_err(y2u, ref2u, K10_TOL,
                        coverage(valid2[:256, :256], "truncate", 1, 5) >= WELL,
                        "masked 2D staged kernels vs f64",
                        decided=coverage(valid2[:256, :256], "truncate", 1,
                                         5) >= WELL)
    print(f"masked slice: savgol_apply_masked {MASKED_1D} f32 n=12 m=4 "
          f"launches {l_normal}; vs f64 max abs err {e1:.3e} on windows >= 18 "
          f"of 25 valid (gate {K9_SLICE_ABS}), filled where the f64 reference "
          f"fills ({int((z1 & ~zr).sum())} quorate outputs round to 0); "
          f"solver='qr' (8, {MASKED_1D[1]}) launches {l_qr}, scaled err "
          f"{eq:.3e} (gate {QR_TOL}); savgol2d_apply_masked {MASKED_2D} 11x11 "
          f"order 3 launches {l_2d}, scaled err {e2:.3e} on determined pixels "
          f"(gate {K10_TOL}); 3x11 window order 3 (staged kernels) launches "
          f"{l_2du}, scaled err {e2u:.3e}")

    # -- each kernel's wrapper against its plain version at the path's shape --
    Q, Rinv, pair_w, pair_index = mk._masked_tables(12, 4)
    ex1 = Rinv[0, :]
    xz = torch.where(valid, x, torch.zeros((), device=dev))
    xzp = torch.nn.functional.pad(xz, (12, 12))
    wp = torch.nn.functional.pad(valid.float(), (12, 12))
    tabs = (pair_w, pair_index, Q.T, ex1)
    k9 = c9.savgol_masked1d_fused_cuda(xzp, wp, *tabs, half_window=12, kmin=5,
                                       fill=0.0)
    k9p = c9.masked1d_plain(xzp, wp, *tabs, half_window=12, kmin=5, fill=0.0)
    # a quorate output may round to 0 in f32 (one of these 8.4 M does: its
    # f64 value is 2.5e-8), so the fill pattern is read at fill=NaN: K9
    # fills exactly the windows the reference fills, and elsewhere equals
    # the path's call to the bit
    k9n = c9.savgol_masked1d_fused_cuda(xzp, wp, *tabs, half_window=12,
                                        kmin=5, fill=float("nan"))
    filled = torch.isnan(k9n)
    require(torch.equal(filled, zr), "masked 1D fill pattern at fill=NaN")
    require(torch.equal(k9, y1) and torch.equal(
        torch.where(filled, 0.0, k9n), k9),
        "masked 1D: K9 at fill=0 or NaN differs from the path's call")
    k9_err, _ = masked_err(k9, k9p, K9_TOL, counts1 >= 18, "K9 vs plain")
    k9_abs = (k9 - k9p)[counts1 >= 18].abs().max().item()
    # K8a on the 2D slice's planes (P = 10), K8b on the qr slice's (k = 5)
    xv2 = torch.nn.functional.pad(torch.where(valid2, img, 0.0), (5,) * 4)
    wp2 = torch.nn.functional.pad(valid2.float(), (5,) * 4)
    Q3, _, pw2, pi2, _ = mk._masked_tables_2d(5, 5, 3)
    gram2 = mk._corr2d_bank(wp2, pw2, True)
    rhs2 = mk._corr2d_bank(xv2, Q3, True)
    quorum2 = gram2[int(pi2[0, 0])] * 121 >= 9.5
    well2 = coverage(valid2, "truncate", 5, 5) >= WELL
    k8a, ok8a = cs.plane_solve_cuda(gram2, pi2, rhs2, quorum2, 1e-6)
    k8ap, ok8ap = lsq.cholesky_solve_planes(gram2, pi2, rhs2, quorum2, 1e-6)
    require(torch.equal(ok8a, ok8ap), "K8a ok at the 2D slice")
    k8a_err, k8a_s = max_err(k8a[:, well2], k8ap[:, well2])
    require(k8a_err <= 1e-5 * k8a_s, f"K8a vs plain: {k8a_err:.3e}")
    k8a_bits = k8a_planes_bit_equal(mk, cs, lsq, img, valid2)
    # K8b solves in FP64 double-word, its plain version in float32 pairs
    # (eps 2^-48): compare where cond(G) leaves the plain version exact
    xq, wq = xzp[:8], wp[:8]
    ghi, glo = lsq.correlate_valid_dd(wq, pair_w)
    rhi, rlo = lsq.correlate_valid_dd(xq, Q.T)
    quorum_q = ghi[int(pair_index[0, 0])] * 25 >= 4.5
    k8b, ok8b = cs.plane_solve_dd_cuda(ghi, glo, pair_index, rhi, rlo,
                                       quorum_q)
    k8bp, ok8bp = lsq.cholesky_solve_planes_dd(ghi, glo, pair_index, rhi,
                                               rlo, quorum_q)
    require(torch.equal(ok8b, ok8bp), "K8b ok at the qr slice")
    well_q = counts1[:8] >= 18
    k8b_err, k8b_s = max_err(k8b[:, well_q], k8bp[:, well_q])
    require(k8b_err <= 1e-5 * k8b_s, f"K8b vs plain: {k8b_err:.3e}")
    k10_args = dict(half_window_x=5, half_window_y=5, poly_order=3, kmin=10,
                    fill=0.0, rcond=1e-6)
    k10 = c10.savgol_masked2d_fused_cuda(xv2, wp2, **k10_args)
    k10p = mk._masked2d_staged(xv2, wp2, nx=5, ny=5, m=3, dx=0, dy=0,
                               delta_x=1.0, delta_y=1.0, kmin=10, fill=0.0,
                               rcond=1e-6, weighted=False, kernels=False)
    k10_err, _ = masked_err(k10, k10p, K10_TOL, well2, "K10 vs plain",
                            decided=well2)
    k10_abs = (k10 - k10p)[well2].abs().max().item()
    print(f"masked kernels vs plain at the slice's shapes: K9 {k9_abs:.3e} "
          f"abs ({k9_err:.3e} scaled, windows >= 18 of 25); K8a (P=10, "
          f"{MASKED_2D}) {k8a_err:.3e}; K8b (k=5, 8 x {MASKED_1D[1]}) "
          f"{k8b_err:.3e}; K10 {k10_abs:.3e} abs on windows >= {WELL:.0%} "
          f"valid (f32 basis difference, gate {K10_TOL} scaled); K8a bit-equal "
          f"to its plain version, coefficients and ok, with non-finite Gram "
          f"planes at {len(K8A_BAD_AT)} positions, at {k8a_bits}")

    # -- gradients at a small size: each kernel route against the plain one --
    gr = np.random.default_rng(16)
    g_np, gv_np = holed(gr, (3, 700), 0.15)
    gw = torch.from_numpy(np.where(gv_np, gr.uniform(0.2, 2.0, gv_np.shape),
                                   0.0)).to(dev)
    gx = torch.from_numpy(g_np).to(dev)
    i_np, iv_np = holed(gr, (2, 48, 64), 0.15)
    iw = torch.from_numpy(np.where(iv_np, gr.uniform(0.2, 2.0, iv_np.shape),
                                   0.0)).to(dev)
    ix = torch.from_numpy(i_np).to(dev)
    grad_err = {}
    for what, run, inputs in (
            ("K9", lambda v, w, meth: sgt.savgol_apply_masked(
                v, half_window=6, poly_order=2, derivative=1, mask=w,
                fill=0.0, method=meth), (gx, gw)),
            ("qr", lambda v, w, meth: sgt.savgol_apply_masked(
                v, half_window=6, poly_order=3, mask=w, fill=0.0,
                solver="qr", method=meth), (gx, gw)),
            ("K10", lambda v, w, meth: sgt.savgol2d_apply_masked(
                v, half_window_x=2, half_window_y=3, poly_order=2,
                deriv_y=1, mask=w, fill=0.0, method=meth), (ix, iw))):
        grads = {}
        for meth in ("auto", "xla"):
            v, w = (t.float().clone().requires_grad_() for t in inputs)
            loss = run(v, w, meth).square().sum()
            grads[meth] = torch.autograd.grad(loss, [v, w])
        grad_err[what] = 0.0
        for got, want in zip(grads["auto"], grads["xla"]):
            e, s = max_err(got, want)
            require(e <= 1e-4 * s, f"{what} gradient {e:.3e} (scale {s:.3e})")
            grad_err[what] = max(grad_err[what], e / s)
    print("masked gradients (x and float weights) vs the plain routes: "
          + ", ".join(f"{k} {v:.3e}" for k, v in grad_err.items())
          + " scaled (tol 1e-4)")

    # -- timings: each kernel and its plain version, then the entry points --
    t = {
        "K9": (device_ms(lambda: c9.savgol_masked1d_fused_cuda(
            xzp, wp, *tabs, half_window=12, kmin=5, fill=0.0)),
               device_ms(lambda: c9.masked1d_plain(
                   xzp, wp, *tabs, half_window=12, kmin=5, fill=0.0),
                   warmup=1, reps=5)),
        "K8a": (device_ms(lambda: cs.plane_solve_cuda(
            gram2, pi2, rhs2, quorum2, 1e-6)),
                device_ms(lambda: lsq.cholesky_solve_planes(
                    gram2, pi2, rhs2, quorum2, 1e-6), warmup=1, reps=5)),
        "K8b": (device_ms(lambda: cs.plane_solve_dd_cuda(
            ghi, glo, pair_index, rhi, rlo, quorum_q)),
                device_ms(lambda: lsq.cholesky_solve_planes_dd(
                    ghi, glo, pair_index, rhi, rlo, quorum_q), warmup=1,
                    reps=5)),
        "K10": (device_ms(lambda: c10.savgol_masked2d_fused_cuda(
            xv2, wp2, **k10_args)),
                device_ms(lambda: mk._masked2d_staged(
                    xv2, wp2, nx=5, ny=5, m=3, dx=0, dy=0, delta_x=1.0,
                    delta_y=1.0, kmin=10, fill=0.0, rcond=1e-6,
                    weighted=False, kernels=False), warmup=1, reps=5)),
        "savgol_apply_masked": (
            cuda_time_ms(lambda: sgt.savgol_apply_masked(x, **kw1)),
            cuda_time_ms(lambda: sgt.savgol_apply_masked(
                x, method="xla", **kw1), warmup=1, reps=5)),
        "savgol_apply_masked qr": (
            cuda_time_ms(lambda: sgt.savgol_apply_masked(
                x[:8], solver="qr", **{**kw1, "mask": valid[:8]})),
            cuda_time_ms(lambda: sgt.savgol_apply_masked(
                x[:8], solver="qr", method="xla",
                **{**kw1, "mask": valid[:8]}), warmup=1, reps=5)),
        "savgol2d_apply_masked": (
            cuda_time_ms(lambda: sgt.savgol2d_apply_masked(img, **kw2)),
            cuda_time_ms(lambda: sgt.savgol2d_apply_masked(
                img, method="xla", **kw2), warmup=1, reps=5)),
    }
    sizes = {"K9": x.numel(), "K8a": img.numel(), "K8b": 8 * MASKED_1D[1],
             "K10": img.numel(), "savgol_apply_masked": x.numel(),
             "savgol_apply_masked qr": 8 * MASKED_1D[1],
             "savgol2d_apply_masked": img.numel()}
    for name, (k, p) in t.items():
        print(f"time {name} ({sizes[name]} outputs) f32: kernel {k:.4f} ms = "
              f"{sizes[name] / k / 1e6:.3f} G/s; plain {p:.4f} ms = "
              f"{sizes[name] / p / 1e6:.3f} G/s [{card}]")
    # the kernels alone at the headline batches (the plain staged versions
    # there would need tens of GB of planes)
    gen = torch.Generator(device=dev).manual_seed(5)
    xh = torch.randn(MASKED_1D_HEAD, generator=gen, device=dev)
    wh = (torch.rand(MASKED_1D_HEAD, generator=gen, device=dev)
          >= MASK_FRAC).float()
    xh, wh = (torch.nn.functional.pad(a, (12, 12)) for a in (xh * wh, wh))
    k9_head = device_ms(lambda: c9.savgol_masked1d_fused_cuda(
        xh, wh, *tabs, half_window=12, kmin=5, fill=0.0), warmup=1, reps=5)
    del xh, wh
    ih = torch.randn(IMG_FULL, generator=gen, device=dev)
    iwh = (torch.rand(IMG_FULL, generator=gen, device=dev) >= MASK_FRAC
           ).float()
    ih, iwh = (torch.nn.functional.pad(a, (5,) * 4) for a in (ih * iwh, iwh))
    k10_head = device_ms(lambda: c10.savgol_masked2d_fused_cuda(
        ih, iwh, **k10_args), warmup=1, reps=5)
    del ih, iwh
    n1, n2 = MASKED_1D_HEAD[0] * MASKED_1D_HEAD[1], int(np.prod(IMG_FULL))
    print(f"time K9 alone {MASKED_1D_HEAD} f32 n=12 m=4: {k9_head:.4f} ms = "
          f"{n1 / k9_head / 1e6:.3f} Gs/s; K10 alone {IMG_FULL} 11x11 order "
          f"3: {k10_head:.4f} ms = {n2 / k10_head / 1e3:.1f} Mpix/s [{card}]")

    # -- yardsticks: one batched torch.linalg call for each K8 solve (LU; no
    # quorum and no rcond rule), timed here only, and each kernel's bound --
    G2 = gram2[torch.as_tensor(pi2.reshape(-1).astype(np.int64), device=dev)]
    G2 = G2.reshape(10, 10, -1).permute(2, 0, 1).contiguous()
    r2 = rhs2.reshape(10, -1).t().unsqueeze(-1).contiguous()
    lib_k8a = device_ms(lambda: torch.linalg.solve_ex(G2, r2))
    del G2, r2
    Gq = (ghi.double() + glo.double())[torch.as_tensor(
        pair_index.reshape(-1).astype(np.int64), device=dev)]
    Gq = Gq.reshape(5, 5, -1).permute(2, 0, 1).contiguous()
    rq = (rhi.double() + rlo.double()).reshape(5, -1).t().unsqueeze(-1)
    lib_k8b = device_ms(lambda: torch.linalg.solve_ex(Gq, rq.contiguous()))
    del Gq, rq
    pos_a, pos_b = img.numel(), 8 * MASKED_1D[1]
    b8a = speed_of_light_plane_solve(10, positions=pos_a).fields
    b8b = speed_of_light_plane_solve_dd(5, positions=pos_b).fields
    b9 = speed_of_light_masked_1d(4, shape=MASKED_1D).fields
    b10 = speed_of_light_masked_2d(11, 11, 3, shape=tuple(img.shape)).fields
    print(f"library: torch.linalg.solve_ex (P=10, {pos_a} f32 systems) "
          f"{lib_k8a:.4f} ms, (k=5, {pos_b} f64) {lib_k8b:.4f} ms; bounds: "
          + ", ".join(f"{k} {b['bound_ms']:.4f} ms ({b['bound_by']})"
                      for k, b in (("K8a", b8a), ("K8b", b8b), ("K9", b9),
                                   ("K10", b10))) + f" [{card}]")

    kernels = [
        {"name": "plane_solve", "route": "cuda",
         "source": "savgol_tpu_torch/csrc/plane_solve.cu",
         "replaces": "savgol_tpu/ops/pallas_solve.py:55",
         "launches": l_qr["plane_solve_dd"] + l_2du["plane_solve"],
         "max_abs_err": max(k8a_err, k8b_err),
         "ms": t["K8a"][0], "plain_ms": t["K8a"][1], **b8a,
         "library_ms": lib_k8a, "dd_ms": t["K8b"][0],
         "dd_plain_ms": t["K8b"][1], "dd_bound_ms": b8b["bound_ms"],
         "dd_library_ms": lib_k8b},
        {"name": "masked1d", "route": "cuda",
         "source": "savgol_tpu_torch/csrc/masked1d.cu",
         "replaces": "savgol_tpu/ops/pallas_masked.py:56",
         "launches": l_normal["masked1d"], "max_abs_err": k9_abs,
         "ms": t["K9"][0], "plain_ms": t["K9"][1], **b9, "library_ms": None,
         "headline_ms": k9_head},
        {"name": "masked2d", "route": "cuda",
         "source": "savgol_tpu_torch/csrc/masked2d.cu",
         "replaces": "savgol_tpu/ops/pallas_masked2d.py:205",
         "launches": l_2d["masked2d"], "max_abs_err": k10_abs,
         "ms": t["K10"][0], "plain_ms": t["K10"][1], **b10,
         "library_ms": None, "headline_ms": k10_head},
    ]
    return kernels


# -- the irregular-sampling path ---------------------------------------------


def k11_grid(sgt, dev) -> str:
    """K11 (savgol_apply_nonuniform, method="auto") against the plain staged
    version (method="xla") on the card over (n, m, d), shapes, x and t
    dtypes (epoch-scale f64 t included), bool and float masks and hole
    shares, and K11p (the planes mode) against its plain version on every
    third case: finiteness (the fill pattern), s and ok identical
    everywhere, values within the gates everywhere in f64 and on windows >=
    70% valid in f32. The f32 plain version accumulates in float32 pairs
    (eps 2^-48), the kernel in FP64 pairs, on the same rounded design; a
    window the rcond rule still accepts may have cond(G) near 1e12 (a
    truncated edge window, or one thinned by holes), where the plain
    version's own error passes the gate: those outputs are counted, and
    their largest difference printed. So every f32 window, thin ones
    included, is also held, fill pattern and values, to a witness without
    that error: the plain version on the same float32 design with the
    moments and the solve in double-word float64 (``acc=torch.float64``),
    the kernel's own arithmetic. Each (config, type) pair runs one
    shape, the shapes taken in turn so that every config and every type
    meets all three: a plain call costs up to ~1 s of small launches."""
    from savgol_tpu_torch.ops import cuda_nonuniform as c11
    rng = np.random.default_rng(11)
    worst = {torch.float32: 0.0, torch.float64: 0.0}
    cases = planes = thin = 0
    thin_err = worst_wit = 0.0
    c11.reset_launches()
    for ci, (n, m, d) in enumerate(K11_CONFIGS):
        shapes = ((1, 2 * n + 1), (3, 1000), (8, 8192))
        for ti, (xd, td, off) in enumerate(K11_TYPES):
            i = len(K11_TYPES) * ci + ti
            shape = shapes[(ci + ti) % 3]
            frac, weighted = K11_HOLES[i % 3], i // 3 % 2 == 1
            t_np = off + np.cumsum(rng.uniform(0.5, 1.5, shape), -1)
            x_np = rng.standard_normal(shape)
            valid_np = rng.random(shape) >= frac
            x_np[~valid_np] = np.nan
            x = torch.from_numpy(x_np).to(dev, xd)
            t = torch.from_numpy(t_np).to(dev, td)
            mask = None
            if weighted:
                mask = torch.from_numpy(np.where(
                    valid_np, rng.uniform(0.2, 2.0, shape), 0.0)).to(dev, xd)
            kw = dict(half_window=n, poly_order=m, derivative=d, mask=mask)
            got = sgt.savgol_apply_nonuniform(x, t, **kw)
            want = sgt.savgol_apply_nonuniform(x, t, method="xla", **kw)
            tol = NONUNI_F32_TOL if xd == torch.float32 else NONUNI_F64_TOL
            what = (f"K11 n={n} m={m} d={d} {shape} x {xd} t {td} +{off:g} "
                    f"holes {frac} weighted={weighted}")
            valid = torch.from_numpy(valid_np).to(dev)
            xz = torch.where(valid, x, 0.0)
            w = mask if weighted else valid.to(xd)
            rcond = 1e-6 if xd == torch.float32 else 1e-12
            well = torch.ones_like(valid)
            if xd == torch.float32:
                well = coverage(valid, "truncate", n) >= WELL
                both = torch.isfinite(got) & torch.isfinite(want) & ~well
                thin += int(both.sum())
                if bool(both.any()):
                    thin_err = max(thin_err,
                                   max_err(got[both], want[both])[0])
                # every window, thin ones included, against the witness
                wit = c11.nonuniform_plain(
                    xz, w, t, half_window=n, poly_order=m, derivative=d,
                    kmin=m + 1, fill=float("nan"), rcond=rcond,
                    acc=torch.float64)
                e, _ = masked_err(got, wit, tol, torch.ones_like(valid),
                                  what + " vs the FP64-pair witness")
                worst_wit = max(worst_wit, e)
            e, _ = masked_err(got, want, tol, well, what)
            worst[xd] = max(worst[xd], e)
            cases += 1
            if i % 3:
                continue
            kwp = dict(half_window=n, poly_order=m, kmin=m + 1, rcond=rcond)
            gp = c11.savgol_nonuniform_planes_cuda(xz, w, t, **kwp)
            wp = c11.nonuniform_planes_plain(xz, w, t, **kwp)
            require(torch.equal(gp[m + 1:], wp[m + 1:]),
                    f"{what}: K11p s or ok differ")
            e, _ = masked_err(gp[:m + 1], wp[:m + 1], tol,
                              well.expand_as(gp[:m + 1]), what + " K11p")
            worst[xd] = max(worst[xd], e)
            planes += 1

    # k = 41 (device scratch), float32 (the on-card test lane holds
    # float64): a degree-40 monomial fit is never identified, so K11p's
    # planes (s, ok and the raw rhs the solve leaves) are held against the
    # plain ones, and K11's fill pattern against their ok. The plain solve
    # alone is ~250 k small launches.
    n, m = K11_SCRATCH
    t = torch.from_numpy(np.cumsum(rng.uniform(0.5, 1.5, (2, 100)), -1)).to(
        dev, torch.float32)
    x = torch.from_numpy(rng.standard_normal((2, 100))).to(dev, torch.float32)
    kwp = dict(half_window=n, poly_order=m, kmin=m + 1, rcond=1e-6)
    gp = c11.savgol_nonuniform_planes_cuda(x, torch.ones_like(x), t, **kwp)
    wp = c11.nonuniform_planes_plain(x, torch.ones_like(x), t, **kwp)
    what = f"K11p n={n} m={m} (2, 100) f32"
    require(torch.equal(gp[m + 1:], wp[m + 1:]), f"{what}: s or ok differ")
    e, _ = masked_err(gp[:m + 1], wp[:m + 1], NONUNI_F32_TOL,
                      torch.ones_like(gp[:m + 1], dtype=torch.bool), what)
    worst[torch.float32] = max(worst[torch.float32], e)
    y = sgt.savgol_apply_nonuniform(x, t, half_window=n, poly_order=m)
    require(torch.equal(torch.isfinite(y), wp[m + 2] > 0.5),
            f"K11 n={n} m={m}: fill pattern against the plain planes' ok")
    cases += 1
    planes += 1

    # the largest n whose staged tile fits a block, m = 4 and 7: the tile
    # and L pass the limit there, so the K = 0 instance on device scratch
    # runs; on a 64-sample row every window spans the row, so it must give
    # the bits of n = 63 (the compile-time instance, held above)
    big = []
    for xd in (torch.float32, torch.float64):
        size = torch.empty((), dtype=xd).element_size()
        n = (c11.SMEM_LIMIT // 3 // 16 * 16 // size - 128) // 2
        t = torch.from_numpy(np.cumsum(rng.uniform(0.5, 1.5, (1, 64)),
                                       -1)).to(dev, xd)
        x = torch.from_numpy(rng.standard_normal((1, 64))).to(dev, xd)
        for m in (4, 7):
            smem, work, _ = c11.nonuniform_layout(n, m, xd, xd)
            require(smem <= c11.SMEM_LIMIT and work > 0,
                    f"K11 n={n} m={m}: layout {smem} B, {work} scratch")
            y, y63 = (sgt.savgol_apply_nonuniform(
                x, t, half_window=h, poly_order=m, derivative=1)
                for h in (n, 63))
            require(torch.equal(y.isnan(), y63.isnan()) and
                    torch.equal(y.nan_to_num(), y63.nan_to_num()),
                    f"K11 n={n} m={m} {xd}: differs from n=63")
            cases += 2
        big.append(n)
    torch.cuda.synchronize()
    require(c11.LAUNCHES["nonuniform"] == cases + planes,
            f"K11 grid launched {c11.LAUNCHES}, expected {cases + planes}")
    return (f"K11 grid: {cases} cases + {planes} K11p cases vs plain, worst "
            f"scaled error f32={worst[torch.float32]:.3e} (windows >= "
            f"{WELL:.0%} valid) f64={worst[torch.float64]:.3e} (tol "
            f"{NONUNI_F32_TOL}, {NONUNI_F64_TOL}), fill pattern, s and ok "
            f"identical; f32 outputs on thinner windows {thin}, largest abs "
            f"difference to plain there {thin_err:.3e}; f32 on every window "
            f"vs the FP64-pair witness {worst_wit:.3e} scaled (tol "
            f"{NONUNI_F32_TOL}, fill pattern identical); n = {big} (the "
            f"largest tiles, K = 0 on scratch) bit-equal to n = 63 at m = 4 "
            f"and 7; launches {dict(c11.LAUNCHES)}")


# K12's grid: m = 4 and 7 (compile-time) and 9 (runtime m); batches of one,
# three, eight and seventeen rows (a thread takes two rows at compile-time m
# and four past it) with the share of holes in the fitted data
K12_MS = (4, 7, 9)
K12_BATCHES = ((1, 0.2), (3, 0.5), (8, 0.2), (17, 0.5))


def k12_grid(dev) -> str:
    """K12 against its plain version on K11p's planes over sorted,
    shuffled, sparse, extrapolating and dense queries (Nq < N and > N),
    every derivative d = 0..m (K = 1 at d = m) at m = 4 and 7 (compile-time
    instances) and 9 (the runtime one), 1, 3, 8 and 17 rows (3 and 17: a
    partial group of the kernel's rows), and the x and t dtypes."""
    from savgol_tpu_torch.ops import cuda_nonuniform as c11
    from savgol_tpu_torch.ops import cuda_resample as c12
    rng = np.random.default_rng(12)
    worst = {torch.float32: 0.0, torch.float64: 0.0}
    cases = 0
    n, N = 6, 5000
    c12.reset_launches()
    for xd, td, m in itertools.product(
            (torch.float32, torch.float64), (torch.float32, torch.float64),
            K12_MS):
        if (xd, td) == (torch.float64, torch.float32):
            continue
        for B, frac in K12_BATCHES:
            t_np = np.cumsum(rng.uniform(0.5, 1.5, N))
            t = torch.from_numpy(t_np).to(dev, td)
            valid = torch.from_numpy(rng.random((B, N)) >= frac).to(dev)
            x = torch.from_numpy(rng.standard_normal((B, N))).to(dev, xd)
            planes = c11.savgol_nonuniform_planes_cuda(
                torch.where(valid, x, 0.0), valid.to(xd), t, half_window=n,
                poly_order=m, kmin=m + 1,
                rcond=1e-6 if xd == torch.float32 else 1e-12)
            lo, hi = t_np[0], t_np[-1]
            queries = {
                "sorted": np.sort(rng.uniform(lo, hi, 3000)),
                "shuffled": rng.uniform(lo, hi, 3000),
                "sparse": np.sort(rng.uniform(lo, hi, 40)),
                "extrapolated": np.sort(rng.uniform(lo - 50, hi + 50, 2000)),
                "dense": np.sort(rng.uniform(lo, hi, 9000))}
            for qname, tq_np in queries.items():
                tq = torch.from_numpy(tq_np).to(dev, td)
                ctr = torch.clamp(torch.searchsorted(t, tq) - n, 0,
                                  N - 2 * n - 1) + n
                for d in range(m + 1):
                    kw = dict(poly_order=m, derivative=d, fill=-3.0)
                    got = c12.resample_eval_cuda(planes, t, ctr, tq, **kw)
                    want = c12.resample_eval_plain(planes, t, ctr, tq, **kw)
                    tol = NONUNI_F32_TOL if xd == torch.float32 else \
                        NONUNI_F64_TOL
                    what = f"K12 {qname} m={m} B={B} d={d} x {xd} t {td}"
                    require(torch.equal(got == -3.0, want == -3.0),
                            f"{what}: fill pattern")
                    e, _ = masked_err(got, want, tol,
                                      torch.ones_like(got, dtype=torch.bool),
                                      what)
                    worst[xd] = max(worst[xd], e)
                    cases += 1
    torch.cuda.synchronize()
    require(c12.LAUNCHES["resample"] == cases,
            f"K12 grid launched {c12.LAUNCHES}, expected {cases}")
    return (f"K12 grid: {cases} cases (m = {K12_MS}, B = "
            f"{[b for b, _ in K12_BATCHES]}) vs plain, worst scaled error "
            f"f32={worst[torch.float32]:.3e} f64={worst[torch.float64]:.3e} "
            f"(tol {NONUNI_F32_TOL}, {NONUNI_F64_TOL}), fill pattern "
            f"identical; launches {dict(c12.LAUNCHES)}")


def nonuniform_slice(sgt, dev, card) -> list:
    """The irregular-sampling path at the bench sizes through the user's
    entry points: launch counts per entry point, accuracy against f64,
    each kernel against its plain version, gradients, and CUDA-event
    timings. Returns K11's, K11p's and K12's records for the {"kernels":
    ...} line, and the K8b launches of the direct route."""
    from savgol_tpu_torch.ops import cuda_nonuniform as c11
    from savgol_tpu_torch.ops import cuda_resample as c12
    from savgol_tpu_torch.ops import cuda_solve as cs
    from savgol_tpu_torch.ops import lsq
    from savgol_tpu_torch.ops import nonuniform as nu
    from savgol_tpu_torch.utils.timing import cuda_time_ms, device_ms

    B, N = NONUNI
    gen = torch.Generator(device=dev).manual_seed(1004)
    tn = torch.cumsum(torch.rand(NONUNI, generator=gen, device=dev) + 0.5, -1)
    xn = torch.randn(NONUNI, generator=gen, device=dev)
    xh = torch.where(torch.rand(NONUNI, generator=gen, device=dev)
                     < MASK_FRAC, float("nan"), xn)
    t1 = torch.cumsum(torch.rand(N, generator=gen, device=dev) + 0.5, 0)
    tq1 = torch.linspace(t1[0].item(), t1[-1].item(), N, device=dev)
    xr = torch.randn(NONUNI, generator=gen, device=dev)
    kw = dict(half_window=12, poly_order=4, fill=0.0)

    # -- launch counts, one zeroed window an entry point --
    y, l_nu = counted_all(lambda: sgt.savgol_apply_nonuniform(xn, tn, **kw),
                          {"nonuniform": 1}, "savgol_apply_nonuniform")
    yh, l_nuh = counted_all(
        lambda: sgt.savgol_apply_nonuniform(xh, tn, **kw), {"nonuniform": 1},
        "savgol_apply_nonuniform (20% holes)")
    yx, l_xla = counted_all(
        lambda: sgt.savgol_apply_nonuniform(xn, tn, method="xla", **kw), {},
        "savgol_apply_nonuniform(method='xla')")
    yr, l_rs = counted_all(lambda: sgt.savgol_resample(xr, t1, tq1, **kw),
                           {"nonuniform": 1, "resample": 1},
                           "savgol_resample")
    yd, l_dir = counted_all(
        lambda: sgt.savgol_resample(xr, t1, tq1, method="direct", **kw),
        {"plane_solve_dd": 1}, "savgol_resample(method='direct')")

    # -- accuracy: f32 results against the same data in f64, plain --
    errs = {}
    for name, got, want in (
            ("nonuniform", y, sgt.savgol_apply_nonuniform(
                xn.double(), tn.double(), method="xla", **kw)),
            ("nonuniform 20% holes", yh, sgt.savgol_apply_nonuniform(
                xh.double(), tn.double(), method="xla", **kw)),
            ("resample auto", yr, sgt.savgol_resample(
                xr.double(), t1.double(), tq1.double(), method="direct",
                **kw)),
            ("resample auto vs direct f32", yr, yd)):
        require(got.shape == want.shape and bool(torch.isfinite(got).all()),
                f"{name}: shape or finiteness")
        require(torch.equal(got == 0, want == 0), f"{name}: fill pattern")
        errs[name], _ = masked_err(got, want, NONUNI_SLICE_TOL,
                                   torch.ones_like(got, dtype=torch.bool),
                                   name)
    e_xla, _ = masked_err(y, yx, NONUNI_F32_TOL,
                          torch.ones_like(y, dtype=torch.bool),
                          "nonuniform K11 route vs xla route")
    print(f"nonuniform slice: savgol_apply_nonuniform {NONUNI} f32 n=12 m=4 "
          f"launches {nz(l_nu)}, 20% holes {nz(l_nuh)}, method='xla' "
          f"{nz(l_xla)}; savgol_resample {NONUNI} -> {N} queries launches "
          f"{nz(l_rs)}, method='direct' {nz(l_dir)}; scaled errors "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (gate {NONUNI_SLICE_TOL}), fill patterns identical; K11 route"
          f" vs xla route {e_xla:.3e}")

    # -- each kernel's wrapper against its plain version at the path's
    # shapes --
    valid = torch.isfinite(xh)
    xz, w = torch.where(valid, xh, 0.0), valid.float()
    kf = dict(half_window=12, poly_order=4, kmin=5, rcond=1e-6)
    k11 = c11.savgol_nonuniform_fused_cuda(xz, w, tn, derivative=0, fill=0.0,
                                           **kf)
    k11p_ = c11.nonuniform_plain(xz, w, tn, derivative=0, fill=0.0, **kf)
    k11_abs = (k11 - k11p_).abs().max().item()
    ones = torch.ones_like(xr)
    pk = c11.savgol_nonuniform_planes_cuda(xr, ones, t1, **kf)
    pp = c11.nonuniform_planes_plain(xr, ones, t1, **kf)
    require(torch.equal(pk[5:], pp[5:]), "K11p s or ok at the resample row")
    kp_abs = (pk - pp).abs().max().item()
    ctr = torch.clamp(torch.searchsorted(t1, tq1) - 12, 0, N - 25) + 12
    ke = dict(poly_order=4, derivative=0, fill=0.0)
    k12 = c12.resample_eval_cuda(pk, t1, ctr, tq1, **ke)
    k12_abs = (k12 - c12.resample_eval_plain(pk, t1, ctr, tq1, **ke)
               ).abs().max().item()
    # K8b on the direct route's own Hankel planes (2m+1 moment planes a
    # query), held as the route hands them to the solve
    held = []

    def hold(*args, **kws):
        held.append((args, kws))
        return cs.plane_cholesky_solve_dd(*args, **kws)
    nu.plane_cholesky_solve_dd = hold
    sgt.savgol_resample(xr, t1, tq1, method="direct", **kw)
    nu.plane_cholesky_solve_dd = cs.plane_cholesky_solve_dd
    (ghi, glo, hank, rhi, rlo, quo), kws = held[0]
    c8, ok8 = cs.plane_solve_dd_cuda(ghi, glo, hank, rhi, rlo, quo, **kws)
    p8, okp8 = lsq.cholesky_solve_planes_dd(ghi, glo, hank, rhi, rlo, quo,
                                            **kws)
    require(torch.equal(ok8, okp8), "K8b ok on the direct route's planes")
    k8_abs = (c8 - p8)[:, ok8].abs().max().item()
    for name, e in (("K11", k11_abs), ("K11p", kp_abs), ("K12", k12_abs),
                    ("K8b (direct)", k8_abs)):
        require(e <= NONUNI_F32_TOL * 10, f"{name} vs plain: {e:.3e}")
    print(f"nonuniform kernels vs plain at the slice's shapes (max abs): K11 "
          f"{k11_abs:.3e} (20% holes), K11p {kp_abs:.3e}, K12 {k12_abs:.3e}, "
          f"K8b on the direct route's {tuple(ghi.shape)} Hankel planes "
          f"{k8_abs:.3e} (ok identical)")
    del ghi, glo, rhi, rlo, c8, p8, held

    # -- gradients at a small size: K11 route against the plain route, the
    # card's resample route against the CPU's --
    gr = np.random.default_rng(18)
    gt = np.cumsum(gr.uniform(0.5, 1.5, (3, 700)), -1)
    gx = gr.standard_normal((3, 700))
    gw = np.where(gr.random((3, 700)) > 0.15, gr.uniform(0.2, 2, (3, 700)), 0)
    grads = {}
    for meth in ("auto", "xla"):
        v, tt, ww = (torch.from_numpy(a).to(dev).requires_grad_()
                     for a in (gx, gt, gw))
        loss = sgt.savgol_apply_nonuniform(
            v, tt, half_window=6, poly_order=3, derivative=1, mask=ww,
            fill=0.0, method=meth).square().sum()
        grads[meth] = torch.autograd.grad(loss, [v, tt, ww])
    gq = np.sort(gr.uniform(gt[0, 3], gt[0, -4], 500))
    for where_ in (dev, torch.device("cpu")):
        v, tt, qq, ww = (torch.from_numpy(a).to(where_).requires_grad_()
                         for a in (gx, gt[0], gq, gw))
        loss = sgt.savgol_resample(v, tt, qq, half_window=6, poly_order=3,
                                   derivative=1, mask=ww,
                                   fill=0.0).square().sum()
        grads[where_.type] = torch.autograd.grad(loss, [v, tt, qq, ww])
    grad_err = {}
    for what, a, b in (("nonuniform", "auto", "xla"),
                       ("resample", dev.type, "cpu")):
        grad_err[what] = 0.0
        for got, want in zip(grads[a], grads[b]):
            require(bool(torch.isfinite(got).all()), f"{what} gradient")
            e, s_ = max_err(got.cpu(), want.cpu())
            require(e <= 1e-8 * s_, f"{what} gradient {e:.3e} ({s_:.3e})")
            grad_err[what] = max(grad_err[what], e / s_)
    print("nonuniform gradients (f64: x, t, t_query, float weights), finite; "
          + ", ".join(f"{k} {v:.3e}" for k, v in grad_err.items())
          + " scaled (tol 1e-8) against the plain route / the CPU")

    # -- timings: each kernel and its plain version, then the entry points --
    ku = dict(derivative=0, fill=0.0, **kf)
    won = torch.ones_like(xn)
    t = {
        "K11": (device_ms(lambda: c11.savgol_nonuniform_fused_cuda(
            xn, won, tn, **ku)),
                device_ms(lambda: c11.nonuniform_plain(xn, won, tn, **ku),
                             warmup=1, reps=3)),
        "K11 20% holes": (
            device_ms(lambda: c11.savgol_nonuniform_fused_cuda(
                xz, w, tn, **ku)),
            device_ms(lambda: c11.nonuniform_plain(xz, w, tn, **ku),
                         warmup=1, reps=3)),
        "K11p": (device_ms(lambda: c11.savgol_nonuniform_planes_cuda(
            xr, ones, t1, **kf)),
                 device_ms(lambda: c11.nonuniform_planes_plain(
                     xr, ones, t1, **kf), warmup=1, reps=3)),
        "K12": (device_ms(lambda: c12.resample_eval_cuda(
            pk, t1, ctr, tq1, **ke)),
                device_ms(lambda: c12.resample_eval_plain(
                    pk, t1, ctr, tq1, **ke), warmup=1, reps=5)),
        "savgol_apply_nonuniform": (
            cuda_time_ms(lambda: sgt.savgol_apply_nonuniform(xn, tn, **kw)),
            cuda_time_ms(lambda: sgt.savgol_apply_nonuniform(
                xn, tn, method="xla", **kw), warmup=1, reps=3)),
        "savgol_resample": (
            cuda_time_ms(lambda: sgt.savgol_resample(xr, t1, tq1, **kw)),
            cuda_time_ms(lambda: sgt.savgol_resample(
                xr, t1, tq1, method="direct", **kw), warmup=1, reps=3)),
    }
    for name, (k, p) in t.items():
        other = ("method='direct' (K8b solve)" if name == "savgol_resample"
                 else "plain")
        print(f"time {name} {NONUNI} f32 n=12 m=4: kernel {k:.4f} ms = "
              f"{B * N / k / 1e6:.3f} Gs/s; {other} {p:.4f} ms [{card}]")
    # K11 alone at the 1D headline batch (its plain version there would
    # hold ~40 GB of double-word planes)
    xh1 = torch.randn(B_FULL, N_FULL, generator=gen, device=dev)
    th1 = torch.cumsum(torch.rand(B_FULL, N_FULL, generator=gen, device=dev)
                       + 0.5, -1)
    wh1 = torch.ones_like(xh1)
    k11_head = device_ms(lambda: c11.savgol_nonuniform_fused_cuda(
        xh1, wh1, th1, **ku), warmup=1, reps=3)
    del xh1, th1, wh1
    head = B_FULL * N_FULL
    fl = nonuniform_flops(12, 4)
    b11 = speed_of_light_nonuniform(12, 4, shape=(B, N)).fields
    b11p = speed_of_light_nonuniform_planes(12, 4, shape=(B, N)).fields
    uniq = int(torch.unique(ctr).numel())
    b12 = speed_of_light_resample(4, rows=B, queries=N, centres=uniq).fields
    b11h = speed_of_light_nonuniform(12, 4, shape=(B_FULL, N_FULL)).fields
    # the FP64 floor of the double-word work K11 chose (not its bound)
    fdd = nonuniform_dd_flops(12, 4)
    floor11 = speed_of_light_nonuniform_dd(12, 4, shape=(B, N)
                                           ).fields["bound_ms"]
    print(f"time K11 alone ({B_FULL}, {N_FULL}) f32 n=12 m=4: {k11_head:.4f} "
          f"ms = {head / k11_head / 1e6:.3f} Gs/s, {fdd} FP64 flops a sample "
          f"spent (double-word) = {fdd * head / k11_head / 1e9:.2f} TFLOP/s; "
          f"bounds (the float32 contract: {fl['f64']} FP64 and {fl['f32']} "
          f"f32 operations a sample) K11 {b11['bound_ms']:.4f} ms "
          f"({b11['bound_by']}; its double-word work at the FP64 peak "
          f"{floor11:.4f} ms), K11p {b11p['bound_ms']:.4f}, K12 "
          f"{b12['bound_ms']:.4f} ({b12['bound_by']}), K11 alone "
          f"{b11h['bound_ms']:.3f} ms [{card}]")
    src = "savgol_tpu_torch/csrc/nonuniform.cu"
    return l_dir["plane_solve_dd"], [
        {"name": "nonuniform", "route": "cuda", "source": src,
         "replaces": "savgol_tpu/ops/pallas_nonuniform.py:75",
         "launches": l_nu["nonuniform"], "max_abs_err": k11_abs,
         "ms": t["K11"][0], "plain_ms": t["K11"][1], **b11,
         "library_ms": None, "headline_ms": k11_head},
        {"name": "nonuniform_planes", "route": "cuda", "source": src,
         "replaces": "savgol_tpu/ops/pallas_nonuniform.py:75",
         "launches": l_rs["nonuniform"], "max_abs_err": kp_abs,
         "ms": t["K11p"][0], "plain_ms": t["K11p"][1], **b11p,
         "library_ms": None},
        {"name": "resample", "route": "cuda",
         "source": "savgol_tpu_torch/csrc/resample.cu",
         "replaces": "savgol_tpu/ops/pallas_resample.py:62",
         "launches": l_rs["resample"], "max_abs_err": k12_abs,
         "ms": t["K12"][0], "plain_ms": t["K12"][1], **b12,
         "library_ms": None},
    ]

# -- the padded-boundary and filter-bank paths -------------------------------

PAD_MODES = {"reflect": "symmetric", "periodic": "wrap", "constant": "edge"}
K2_BATCHES = (1, 16, 128)
K4_KS = (1, 3, 6, 17, 40)
K4_WS = (3, 25, 65)
# (B, N): a row shorter than the sweep's pad of 32, an odd length, a wide one
K4_SHAPES = ((1, 20), (3, 4099), (16, 65_537))
# non-finite samples: a row's first, mid-tile, both sides of a tile border
# (K4's tiles are 1024 outputs), its last
K4_BAD_AT = (0, 511, 1023, 1024, 2560, 4098)
# bench.py:671-673's sweep row
SWEEP_X = (4_194_304,)
SWEEP_NS, SWEEP_MS = [4, 8, 12, 16, 24, 32], [2, 3, 4, 4, 5, 6]
# bench.py:496 and :504-515 (sweep_vs_xla, bank_vs_xla), the sweep's scaled
SWEEP_F64_TOL, BANK_GATE = 2e-5, 2e-5
SCIPY_LAUNCHES = {"interp": {"sg1d_poly": 1}, "wrap": {"sg1d_pad": 1},
                  "nearest": {"sg1d_pad": 1}, "mirror": {"sg1d_pad": 1},
                  "constant": {"corr1d_valid": 1}}
# method="bf16" pads mirror on the host and runs K3, as the JAX package does
SCIPY_BF16_LAUNCHES = {**SCIPY_LAUNCHES, "mirror": {"corr1d_valid": 1}}
# the host pad (ops.cuda_conv.pad_last, counted in PADS) each scipy mode
# makes before its kernel: one for the mode K3 takes, none for K1 and K2
SCIPY_PADS = {"constant": "constant"}
# the pad K2 maps while it stages (counted in MAPPED), a mode K2 takes
SCIPY_MAPPED = {"wrap": "wrap", "nearest": "edge", "mirror": "reflect"}


def k2_grid(sgt, dev) -> str:
    """K2 (``Savgol1D.apply`` with a pad boundary, d = 1, dt folded) against
    the plain version (method="xla") over n x mode x B x N x dtype, plus
    axis=0; every launch must be K2's."""
    from savgol_tpu_torch.ops import cuda_conv as cc
    gen = torch.Generator(device=dev).manual_seed(21)
    worst = {torch.float32: 0.0, torch.float64: 0.0}
    cases = 0
    cc.reset_launches()
    for dtype, tol in ((torch.float32, F32_TOL), (torch.float64, F64_TOL)):
        for n in (1, 12, 32):
            ws = 2 * n + 1
            f = sgt.Savgol1D.create(
                sgt.SavgolConfig(n, min(4, 2 * n), 1, time_step=0.01),
                dtype=dtype, device=dev)
            for B in K2_BATCHES:
                for N in (ws, ws + 1, 4099, 262_147):
                    x = torch.randn(B, N, generator=gen, device=dev,
                                    dtype=dtype)
                    for bnd in PAD_MODES:
                        e, sc = max_err(f.apply(x, boundary=bnd),
                                        f.apply(x, boundary=bnd,
                                                method="xla"))
                        require(e <= tol * sc, f"K2 {bnd} n={n} B={B} N={N} "
                                f"{dtype}: {e:.3e} (scale {sc:.3e})")
                        worst[dtype] = max(worst[dtype], e / sc)
                        cases += 1
            xt = torch.randn(4099, 16, generator=gen, device=dev, dtype=dtype)
            for bnd in PAD_MODES:
                e, sc = max_err(f.apply(xt, axis=0, boundary=bnd),
                                f.apply(xt, axis=0, boundary=bnd,
                                        method="xla"))
                require(e <= tol * sc, f"K2 axis=0 {bnd} n={n} {dtype}")
                cases += 1
    torch.cuda.synchronize()
    want = {"sg1d_poly": 0, "sg1d_pad": cases, "corr1d_valid": 0}
    require(cc.LAUNCHES == want, f"K2 grid launched {cc.LAUNCHES}, "
            f"expected {want}")
    return (f"K2 grid: {cases} cases (n 1/12/32 x 3 pad modes x B "
            f"{K2_BATCHES} x N ws/ws+1/4099/262147 x f32/f64, axis=0), worst "
            f"scaled error f32={worst[torch.float32]:.3e} "
            f"f64={worst[torch.float64]:.3e} (tol {F32_TOL}, {F64_TOL}), "
            f"launches {dict(cc.LAUNCHES)}")


def k4_grid(dev) -> str:
    """K4 against its plain version over K x ws x staging (VALID, zeros,
    edge, symmetric and wrap by the half window, symmetric by the sweep's
    32) x (B, N) x dtype; then rows with NaN and inf samples through the
    sweep's stacks and stencils with zero taps at their ends (a tile with a
    non-finite sample runs every tap, as the plain version does)."""
    from savgol_tpu_torch.ops import cuda_bank as cb
    gen = torch.Generator(device=dev).manual_seed(22)
    worst = {torch.float32: 0.0, torch.float64: 0.0}
    cases = bad = 0
    cb.reset_launches()
    for dtype, tol in ((torch.float32, F32_TOL), (torch.float64, F64_TOL)):
        xs = [torch.randn(shape, generator=gen, device=dev, dtype=dtype)
              for shape in K4_SHAPES]
        x_bad = k4_nonfinite_input(gen, dev, dtype)
        for K in K4_KS:
            for ws in K4_WS:
                h = (ws - 1) // 2
                w = torch.randn(K, ws, generator=gen, device=dev,
                                dtype=dtype)
                for x in xs:
                    N = x.shape[-1]
                    for pad, mode in ((0, None), (h, None), (h, "edge"),
                                      (h, "symmetric"), (h, "wrap"),
                                      (32, "symmetric")):
                        if N + 2 * pad < ws:
                            continue
                        e, sc = max_err(
                            cb.correlate_valid_bank_cuda(x, w, pad, mode),
                            cb.bank_correlate_plain(x, w, pad, mode))
                        require(e <= tol * sc, f"K4 K={K} ws={ws} "
                                f"{tuple(x.shape)} pad={pad} {mode} "
                                f"{dtype}: {e:.3e}")
                        worst[dtype] = max(worst[dtype], e / sc)
                        cases += 1
        for w in k4_nonfinite_stacks(gen, dev, dtype):
            for pad, mode in ((32, None), (32, "symmetric"), (0, None)):
                e, sc = k4_nonfinite_check(
                    cb.correlate_valid_bank_cuda(x_bad, w, pad, mode),
                    cb.bank_correlate_plain(x_bad, w, pad, mode),
                    f"K4 non-finite K={w.shape[0]} pad={pad} {mode} {dtype}")
                require(e <= tol * sc, f"K4 non-finite K={w.shape[0]} "
                        f"pad={pad} {mode} {dtype}: {e:.3e}")
                worst[dtype] = max(worst[dtype], e / sc)
                cases += 1
                bad += 1
    torch.cuda.synchronize()
    require(cb.LAUNCHES["corr1d_bank"] == cases,
            f"K4 grid launched {cb.LAUNCHES}, expected {cases}")
    return (f"K4 grid: {cases} cases (K {K4_KS} x ws {K4_WS} x 6 stagings x "
            f"{K4_SHAPES} x f32/f64; {bad} with NaN / inf samples at "
            f"{K4_BAD_AT}, the sweep's stack and {K4_KS[-1]} random 65-tap "
            f"stencils with zeroed ends: non-finite pattern exact), worst "
            f"scaled error f32={worst[torch.float32]:.3e} "
            f"f64={worst[torch.float64]:.3e} (tol {F32_TOL}, {F64_TOL}), "
            f"launches {dict(cb.LAUNCHES)}")


def k4_nonfinite_input(gen, dev, dtype) -> torch.Tensor:
    """Rows of 4099 random samples, each but the last with one non-finite
    sample (NaN, +inf or -inf) at one of ``K4_BAD_AT``; the last holds +inf
    and -inf 10 samples apart, whose sum is NaN."""
    vals = (float("nan"), float("inf"), float("-inf"))
    x = torch.randn(len(K4_BAD_AT) * len(vals) + 1, 4099, generator=gen,
                    device=dev, dtype=dtype)
    for i, (j, v) in enumerate((j, v) for j in K4_BAD_AT for v in vals):
        x[i, j] = v
    x[-1, 1500], x[-1, 1510] = float("inf"), float("-inf")
    return x


def k4_nonfinite_stacks(gen, dev, dtype) -> list:
    """The sweep's centred stencils (zero outside each window) and
    ``K4_KS[-1]`` random 65-tap stencils whose first and last taps are
    zeroed, by how many the stencil's index says."""
    from savgol_tpu_torch.ops.sweep import savgol_weights_masked
    center = savgol_weights_masked(SWEEP_NS, SWEEP_MS, 1, dtype,
                                   device=dev)[0]
    K = K4_KS[-1]
    w = torch.randn(K, 65, generator=gen, device=dev, dtype=dtype)
    t = torch.arange(65, device=dev)
    k = torch.arange(K, device=dev)[:, None]
    return [center, torch.where((t < k % 33) | (t >= 65 - k % 17), 0.0, w)]


def k4_nonfinite_check(got, want, what) -> tuple[float, float]:
    """NaN, +inf and -inf exactly where the plain version has them; the
    (max abs error, scale) of the finite outputs."""
    for name, f in (("NaN", torch.isnan), ("+inf", torch.isposinf),
                    ("-inf", torch.isneginf)):
        require(torch.equal(f(got), f(want)), f"{what}: {name} pattern "
                f"differs in {int((f(got) != f(want)).sum())} outputs")
    fin = torch.isfinite(want)
    require(int(fin.sum()) < want.numel(), f"{what}: nothing non-finite")
    return max_err(got[fin], want[fin])


def cat_pad(x: torch.Tensor, n: int, mode: str) -> torch.Tensor:
    """The host-side pad the padded modes took before K2 (``torch.cat`` of
    two strips and the row), kept here only to time that route."""
    if mode == "symmetric":
        left, right = x[..., :n].flip(-1), x[..., -n:].flip(-1)
    elif mode == "wrap":
        left, right = x[..., -n:], x[..., :n]
    else:
        shape = x.shape[:-1] + (n,)
        left, right = x[..., :1].expand(shape), x[..., -1:].expand(shape)
    return torch.cat([left, x, right], dim=-1)


def bank_slice(sgt, dev, card) -> list:
    """The padded-boundary and filter-bank paths at full size through the
    user's entry points: padded ``Savgol1D.apply``, ``SavgolBank``, the
    sweep and ``scipy_compat.savgol_filter``, each counted in its own zeroed
    window, against float64 and scipy; gradients; CUDA-event timings beside
    the bounds and the library yardsticks. Returns K2's and K4's records."""
    from scipy.signal import savgol_filter as sp_filter

    from savgol_tpu_torch import scipy_compat as tsc
    from savgol_tpu_torch.ops import cuda_bank as cb
    from savgol_tpu_torch.ops import cuda_conv as cc
    from savgol_tpu_torch.ops.sweep import (savgol_apply_sweep,
                                            savgol_weights_masked)
    from savgol_tpu_torch.ops.weights import savgol_weights_np
    from savgol_tpu_torch.utils.timing import cuda_time_ms, device_ms, host_ms

    cfg = sgt.SavgolConfig(12, 4)
    f = sgt.Savgol1D.create(cfg, device=dev)
    x_np = np.random.default_rng(0).standard_normal((B_FULL, N_FULL),
                                                   dtype=np.float32)
    x = torch.from_numpy(x_np).to(dev)
    rows = [0, 1, 64, 127]
    x64 = x[rows].double()
    w = f.center_weights
    c64, _ = (torch.from_numpy(a).to(dev)
              for a in savgol_weights_np(cfg, np.float64))

    # -- padded Savgol1D.apply: launches, f64 gate, K2 vs plain --
    l_pad, e_pad, k2_abs = {}, {}, 0.0
    for bnd, mode in PAD_MODES.items():
        y, l_pad[bnd] = counted_all(lambda: f.apply(x, boundary=bnd),
                                    {"sg1d_pad": 1},
                                    f"Savgol1D.apply(boundary={bnd!r})")
        require(y.shape == x.shape and bool(torch.isfinite(y).all()),
                f"padded apply {bnd}: shape or finiteness")
        ref = cc.savgol_padded_plain(x64, c64, mode, 12)
        e_pad[bnd] = (y[rows].double() - ref).abs().max().item()
        require(e_pad[bnd] <= GATE_ABS, f"padded {bnd} vs f64: "
                f"{e_pad[bnd]:.3e}")
        e, sc = max_err(cc.savgol_padded_cuda(x, w, mode, 12),
                        cc.savgol_padded_plain(x, w, mode, 12))
        require(e <= F32_TOL * sc, f"K2 {mode} vs plain at full size: "
                f"{e:.3e}")
        k2_abs = max(k2_abs, e)
    del y, ref
    print(f"padded slice ({B_FULL}, {N_FULL}) f32 n=12: launches "
          + ", ".join(f"{b} {l_pad[b]['sg1d_pad']} sg1d_pad" for b in l_pad)
          + " (nothing else); max abs err vs f64 "
          + ", ".join(f"{b} {e:.3e}" for b, e in e_pad.items())
          + f" (gate {GATE_ABS}); K2 vs plain {k2_abs:.3e}")

    # -- SavgolBank: smooth + d1 + d2 in one launch --
    bank = sgt.SavgolBank.smooth_and_derivatives(12, 4, 2, device=dev)
    yb, l_bank = counted_all(lambda: bank.apply(x), {"corr1d_bank": 1},
                             "SavgolBank.apply")
    require(yb.shape == (3,) + x.shape and bool(torch.isfinite(yb).all()),
            "bank shape or finiteness")
    e_bank = 0.0
    for d in range(3):
        f64 = sgt.Savgol1D.create(sgt.SavgolConfig(12, 4, d),
                                  dtype=torch.float64, device=dev)
        ref = f64.apply(x64, method="xla")
        e_bank = max(e_bank, (yb[d, rows].double() - ref).abs().max().item())
    require(e_bank <= GATE_ABS, f"bank vs three f64 applies: {e_bank:.3e}")
    xbk = x[:8, :8192]
    ybk = bank.apply(xbk)
    e_gate = max((ybk[d] - sgt.Savgol1D.create(
        sgt.SavgolConfig(12, 4, d), device=dev).apply(
        xbk, method="xla")).abs().max().item() for d in range(3))
    require(e_gate <= BANK_GATE, f"bank_vs_xla gate: {e_gate:.3e}")
    wdt = bank.center_weights * bank.dt_inv[:, None]
    e, sc = max_err(cb.correlate_valid_bank_cuda(x, wdt, 12),
                    cb.bank_correlate_plain(x, wdt, 12))
    require(e <= F32_TOL * sc, f"K4 vs plain at the bank's shape: {e:.3e}")
    k4_abs = e
    del yb
    print(f"bank slice: SavgolBank.smooth_and_derivatives(12, 4, 2).apply "
          f"({B_FULL}, {N_FULL}) f32 launches {nz(l_bank)}; max abs err vs "
          f"three f64 Savgol1D applies {e_bank:.3e} (gate {GATE_ABS}); "
          f"bench.py bank_vs_xla (8, 8192) {e_gate:.3e} (gate {BANK_GATE}); "
          f"K4 vs plain {k4_abs:.3e}")

    # -- the sweep at bench.py's row and at the headline batch --
    gen = torch.Generator(device=dev).manual_seed(23)
    xs = torch.randn(SWEEP_X, generator=gen, device=dev)
    ys, l_sw = counted_all(lambda: savgol_apply_sweep(xs, SWEEP_NS,
                                                      SWEEP_MS),
                           {"corr1d_bank": 1}, "savgol_apply_sweep")
    e_sw, sc_sw = max_err(ys, savgol_apply_sweep(xs, SWEEP_NS, SWEEP_MS,
                                                 method="xla"))
    require(e_sw <= F32_TOL * sc_sw, f"sweep vs plain: {e_sw:.3e}")
    e64 = 0.0
    for c, (n, m) in enumerate(zip(SWEEP_NS, SWEEP_MS)):
        f64 = sgt.Savgol1D.create(sgt.SavgolConfig(n, m),
                                  dtype=torch.float64, device=dev)
        e, sc = max_err(ys[c], f64.apply(xs.double(), method="xla"))
        e64 = max(e64, e / sc)
    require(e64 <= SWEEP_F64_TOL, f"sweep vs per-config f64: {e64:.3e}")
    ysh, l_swh = counted_all(lambda: savgol_apply_sweep(x, SWEEP_NS,
                                                        SWEEP_MS),
                             {"corr1d_bank": 1},
                             f"savgol_apply_sweep ({B_FULL}, {N_FULL})")
    e_swh, sc_swh = max_err(ysh[:, [0, 127]], savgol_apply_sweep(
        x[[0, 127]], SWEEP_NS, SWEEP_MS, method="xla"))
    require(e_swh <= F32_TOL * sc_swh, f"sweep at the headline batch vs "
            f"plain: {e_swh:.3e}")
    del ysh
    print(f"sweep slice: savgol_apply_sweep {SWEEP_X} x 6 configs "
          f"(ns {SWEEP_NS}) f32 launches {nz(l_sw)}, vs plain {e_sw:.3e} "
          f"abs ({e_sw / sc_sw:.3e} scaled, tol {F32_TOL}), vs per-config "
          f"f64 Savgol1D {e64:.3e} scaled (gate {SWEEP_F64_TOL}); at "
          f"({B_FULL}, {N_FULL}) launches {nz(l_swh)}, rows 0 and 127 vs "
          f"plain {e_swh:.3e}")

    # -- scipy_compat: the five modes on two full-length rows --
    x2 = x[[0, 127]]
    e_sc, l_sc = {}, {}
    for mode, want in SCIPY_LAUNCHES.items():
        pads, mapped = dict(cc.PADS), dict(cc.MAPPED)
        y, l_sc[mode] = counted_all(
            lambda: tsc.savgol_filter(x2, 25, 4, mode=mode), want,
            f"scipy_compat.savgol_filter(mode={mode!r})")
        pads = {k: v - pads[k] for k, v in cc.PADS.items() if v != pads[k]}
        want_pads = ({SCIPY_PADS[mode]: 1, "bytes": 2 * (N_FULL + 24) * 4}
                     if mode in SCIPY_PADS else {})
        require(pads == want_pads, f"scipy_compat {mode} made host pads "
                f"{pads}, expected {want_pads}")
        mapped = {k: v - mapped[k] for k, v in cc.MAPPED.items()
                  if v != mapped[k]}
        want_mapped = ({SCIPY_MAPPED[mode]: 1} if mode in SCIPY_MAPPED
                       else {})
        require(mapped == want_mapped, f"scipy_compat {mode} mapped pads "
                f"{mapped} in K2, expected {want_mapped}")
        yh = y.cpu().numpy().astype(np.float64)
        e_sc[mode] = max(float(np.abs(yh[i] - sp_filter(
            x_np[r].astype(np.float64), 25, 4, mode=mode)).max())
            for i, r in enumerate((0, 127)))
        require(e_sc[mode] <= GATE_ABS, f"scipy_compat {mode} vs scipy: "
                f"{e_sc[mode]:.3e}")
        # the import swap: a numpy array is computed on the card by the
        # same kernel and comes back as a numpy array, as scipy returns it;
        # a warm call, so its weights are the ones the tensor call left
        weights = dict(tsc.WEIGHTS)
        yn, _ = counted_all(
            lambda: tsc.savgol_filter(x_np[[0, 127]], 25, 4, mode=mode),
            want, f"scipy_compat.savgol_filter(numpy, mode={mode!r})")
        require(isinstance(yn, np.ndarray)
                and np.array_equal(yn, y.cpu().numpy()),
                f"scipy_compat {mode} on numpy input: {type(yn)} or values "
                f"differ from the tensor call")
        weights = {k: v - weights[k] for k, v in tsc.WEIGHTS.items()}
        require(weights == {"hit": 1, "built": 0}, f"scipy_compat {mode}'s "
                f"warm call counted {weights} in WEIGHTS, expected one hit")
    print(f"scipy_compat.savgol_filter(x, 25, 4) on 2 x {N_FULL} f32: "
          + ", ".join(f"{m} {nz(l_sc[m])} {e_sc[m]:.3e}" for m in l_sc)
          + f" max abs err vs scipy f64 (gate {GATE_ABS}); one host pad a "
          f"call for {sorted(SCIPY_PADS)}, one pad mapped in K2 for "
          f"{sorted(SCIPY_MAPPED)}, none for interp; numpy input: "
          f"the same launches on the card and the same values, as numpy, "
          f"its weights held (one WEIGHTS hit a mode)")

    # -- gradients through K2 and K4 against method="xla" --
    xg_np = np.random.default_rng(24).standard_normal((24, 4099)).astype(
        np.float32)
    grad_err = {}
    for what in ("K2", "K4"):
        grads = {}
        for method in ("auto", "xla"):
            xg = torch.from_numpy(xg_np).to(dev).requires_grad_()
            if what == "K2":
                mod = sgt.Savgol1D.create(sgt.deriv1(12, 4, dt=0.01),
                                          device=dev)
                bufs = [mod.center_weights, mod.dt_inv]   # edge rows unused
                kw = dict(boundary="reflect")
            else:
                mod = sgt.SavgolBank.smooth_and_derivatives(
                    12, 4, 2, time_step=0.01, device=dev)
                bufs, kw = list(mod.buffers()), {}
            for b in bufs:
                b.requires_grad_()
            loss = mod.apply(xg, method=method, **kw).square().sum()
            grads[method] = torch.autograd.grad(loss, [xg, *bufs])
        grad_err[what] = 0.0
        for got, want in zip(grads["auto"], grads["xla"]):
            e, sc = max_err(got, want)
            require(e <= 2e-5 * sc, f"{what} gradient {e:.3e} ({sc:.3e})")
            grad_err[what] = max(grad_err[what], e / sc)
    xs_g = torch.from_numpy(xg_np[0]).to(dev).requires_grad_()
    gs = [torch.autograd.grad(savgol_apply_sweep(
        xs_g, SWEEP_NS, SWEEP_MS, method=m).square().sum(), xs_g)[0]
        for m in ("auto", "xla")]
    e, sc = max_err(*gs)
    require(e <= 2e-5 * sc, f"sweep gradient {e:.3e}")
    grad_err["sweep (K4)"] = e / sc
    print("padded/bank gradients (24, 4099) f32 d1 vs method='xla': "
          + ", ".join(f"{k} {v:.3e}" for k, v in grad_err.items())
          + " scaled (tol 2e-5) for x and every float buffer")

    # -- timings: kernels, plain versions, entry points, the old route --
    one = torch.ones((), device=dev)
    t = {}
    for bnd, mode in PAD_MODES.items():
        t[f"K2 {mode}"] = (
            device_ms(lambda: cc.savgol_padded_cuda(x, w, mode, 12)),
            device_ms(lambda: cc.savgol_padded_plain(x, w, mode, 12),
                         warmup=1, reps=5))
        t[f"Savgol1D.apply {bnd}"] = (
            cuda_time_ms(lambda: f.apply(x, boundary=bnd)),
            # before K2: host torch.cat pad, K3, then the dt pass
            cuda_time_ms(lambda: cc.correlate_valid_cuda(
                cat_pad(x, 12, mode), w) * one))
    t["K1 (same run)"] = (
        device_ms(lambda: cc.savgol_polynomial_cuda(x, w,
                                                       f.edge_weights, 12)),
        float("nan"))
    t["K4 bank K=3"] = (
        device_ms(lambda: cb.correlate_valid_bank_cuda(x, wdt, 12)),
        device_ms(lambda: cb.bank_correlate_plain(x, wdt, 12), warmup=1,
                     reps=3))
    # f64: the instance with its own launch bounds (bytes double, so the
    # bound does too); no plain time at this size
    xd, wdt64 = x.double(), wdt.double()
    t["K4 bank K=3 f64"] = (
        device_ms(lambda: cb.correlate_valid_bank_cuda(xd, wdt64, 12)),
        float("nan"))
    del xd
    fs = [sgt.Savgol1D.create(sgt.SavgolConfig(12, 4, d), device=dev)
          for d in range(3)]
    t["SavgolBank.apply"] = (
        cuda_time_ms(lambda: bank.apply(x)),
        cuda_time_ms(lambda: [fd.apply(x) for fd in fs]))
    center = savgol_weights_masked(SWEEP_NS, SWEEP_MS, 0, torch.float32,
                                   device=dev)[0]
    for name, xv in (("4M", xs), ("128x1M", x)):
        t[f"K4 sweep {name}"] = (
            device_ms(lambda: cb.correlate_valid_bank_cuda(xv, center,
                                                              32)),
            device_ms(lambda: cb.bank_correlate_plain(xv, center, 32),
                         warmup=1, reps=3) if name == "4M" else float("nan"))
        t[f"savgol_apply_sweep {name}"] = (
            cuda_time_ms(lambda: savgol_apply_sweep(xv, SWEEP_NS, SWEEP_MS)),
            cuda_time_ms(lambda: savgol_apply_sweep(
                xv, SWEEP_NS, SWEEP_MS, method="xla"), warmup=1, reps=3)
            if name == "4M" else float("nan"))
    for name, (k, p) in t.items():
        other = ("host pad + K3 (before)" if name.startswith("Savgol1D")
                 else "three K1 applies" if name == "SavgolBank.apply"
                 else "plain")
        where = (f"{SWEEP_X}, 6 configs" if name.endswith("4M") else
                 f"({B_FULL}, {N_FULL})" + (", 6 configs" if "sweep" in name
                                             else ", n=12"))
        label = name if "f64" in name else f"{name} f32"
        print(f"time {label} {where}: kernel route {k:.4f} ms; {other} "
              f"{p:.4f} ms [{card}]")

    # host enqueue a call: what bounds an entry point whose device work is
    # shorter (the 4M sweep)
    xsm = x[:8, :4096].contiguous()
    hosts = {"savgol_apply_sweep 4M": lambda: savgol_apply_sweep(
                 xs, SWEEP_NS, SWEEP_MS),
             "SavgolBank.apply": lambda: bank.apply(x),
             "K4 wrapper (8, 4096)": lambda: cb.correlate_valid_bank_cuda(
                 xsm, center, 32),
             "K3 wrapper (8, 4096)": lambda: cc.correlate_valid_cuda(xsm, w),
             "torch.add (8, 4096)": lambda: xsm.add(1.0)}
    print("host enqueue a call (no synchronisation between calls): "
          + ", ".join(f"{k} {host_ms(fn):.4f} ms" for k, fn in hosts.items())
          + f" [{card}]")

    # -- yardsticks (one PyTorch call each, TF32 off, never called by the
    # port) and bounds --
    import torch.nn.functional as F
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    x3 = x.view(B_FULL, 1, N_FULL)
    lib = {}
    for mode, pm in (("wrap", "circular"), ("edge", "replicate")):
        conv = torch.nn.Conv1d(1, 1, 25, padding=12, padding_mode=pm,
                               bias=False).to(dev)
        with torch.no_grad():
            conv.weight.copy_(w.view(1, 1, 25))
            lib[mode] = device_ms(lambda: conv(x3))
    with torch.no_grad():
        lib["bank"] = device_ms(lambda: F.conv1d(
            x3, wdt.view(3, 1, 25), padding=12))
        lib["sweep"] = device_ms(lambda: F.conv1d(
            xs.view(1, 1, -1), center.view(6, 1, 65), padding=32))
        lib["sweep 128x1M"] = device_ms(lambda: F.conv1d(
            x3, center.view(6, 1, 65), padding=32), warmup=1, reps=5)
    torch.backends.cudnn.allow_tf32 = tf32
    taps = sum(2 * n + 1 for n in SWEEP_NS)
    b2 = speed_of_light_1d((B_FULL, N_FULL)).fields
    b4 = speed_of_light_bank_1d((12,) * 3, shape=(B_FULL, N_FULL)).fields
    b4_64 = speed_of_light_bank_1d((12,) * 3, shape=(B_FULL, N_FULL),
                                   dtype="float64").fields
    b_sw = speed_of_light_bank_1d(SWEEP_NS, shape=SWEEP_X).fields
    b_swh = speed_of_light_bank_1d(SWEEP_NS, shape=(B_FULL, N_FULL)).fields
    print(f"library: nn.Conv1d circular {lib['wrap']:.4f} ms, replicate "
          f"{lib['edge']:.4f} ms (symmetric: none); F.conv1d 3 channels "
          f"{lib['bank']:.4f} ms, 6 x 65 taps on {SWEEP_X} {lib['sweep']:.4f} "
          f"ms; bounds K2 {b2['bound_ms']:.4f} ms ({b2['bound_by']}), K4 bank "
          f"{b4['bound_ms']:.4f} ({b4['bound_by']}; f64 "
          f"{b4_64['bound_ms']:.4f} {b4_64['bound_by']}), sweep {SWEEP_X} "
          f"{b_sw['bound_ms']:.4f} ({b_sw['bound_by']}; {taps} taps a "
          f"sample), sweep ({B_FULL}, {N_FULL}) {b_swh['bound_ms']:.4f} "
          f"({b_swh['bound_by']}; F.conv1d 6 x 65 taps there "
          f"{lib['sweep 128x1M']:.4f} ms) [{card}]")
    return [
        {"name": "sg1d_pad", "route": "cuda",
         "source": "savgol_tpu_torch/csrc/sg1d_poly.cu",
         "replaces": "savgol_tpu/ops/pallas_conv.py:775",
         "launches": sum(v["sg1d_pad"] for v in l_pad.values()),
         "max_abs_err": k2_abs,
         "ms": t["K2 wrap"][0], "plain_ms": t["K2 wrap"][1], **b2,
         "library_ms": lib["wrap"],
         "ms_by_mode": {m: t[f"K2 {m}"][0] for m in PAD_MODES.values()},
         "before_ms": {b: t[f"Savgol1D.apply {b}"][1] for b in PAD_MODES},
         "library_replicate_ms": lib["edge"]},
        {"name": "corr1d_bank", "route": "cuda",
         "source": "savgol_tpu_torch/csrc/corr1d_bank.cu",
         "replaces": "savgol_tpu/ops/pallas_conv.py:2109",
         "launches": (l_bank["corr1d_bank"] + l_sw["corr1d_bank"]
                      + l_swh["corr1d_bank"]),
         "max_abs_err": k4_abs,
         "ms": t["K4 bank K=3"][0], "plain_ms": t["K4 bank K=3"][1], **b4,
         "library_ms": lib["bank"],
         "f64_ms": t["K4 bank K=3 f64"][0], "f64_bound_ms": b4_64["bound_ms"],
         "sweep_ms": t["K4 sweep 4M"][0],
         "sweep_plain_ms": t["K4 sweep 4M"][1],
         "sweep_bound_ms": b_sw["bound_ms"], "sweep_library_ms": lib["sweep"],
         "sweep_headline_ms": t["K4 sweep 128x1M"][0],
         "sweep_headline_bound_ms": b_swh["bound_ms"],
         "sweep_headline_library_ms": lib["sweep 128x1M"]},
    ]


# -- 25. the 1D tile kernels at window 101 -----------------------------------

# the exact 1D tile (csrc/sg1d_exact.cuh): windows of both instances (101
# compile-time, the rest the runtime-width loop), K1 and K2 at the odd ones
# of 3 taps or more
EXACT_WINDOWS = (1, 2, 3, 25, 65, 101, 128, 129)


def exact_grid(dev) -> str:
    """K1, K2 (each pad mode) and K3 on the exact tile against their plain
    versions over its windows (compile-time and runtime widths), outputs
    ending around its tile boundaries (every residue mod 4), the shortest
    rows (N = ws), row offsets 0-3 (rows whose first sample is 0-3 elements
    past a 16-byte boundary) and B in {1, 3, 130} (f64: 1, 3), one launch a
    call; K3 bit for bit against P1 (f32) on the same rows."""
    from savgol_tpu_torch.ops import cuda_conv as cc
    from savgol_tpu_torch.probes import dma1d

    rng = np.random.default_rng(25)
    worst = {torch.float32: 0.0, torch.float64: 0.0}
    cases = p1_equal = 0
    for dtype, tol in ((torch.float32, F32_TOL), (torch.float64, F64_TOL)):
        # outputs a tile: 256 threads of 12 (f64 10) (sg1d_exact.cuh)
        tile = 256 * (12 if dtype == torch.float32 else 10)
        for ws in EXACT_WINDOWS:
            n = ws // 2
            w = torch.from_numpy(rng.standard_normal(ws)).to(dev, dtype)
            ew = torch.from_numpy(rng.standard_normal((n, ws))).to(dev, dtype)
            odd = ws % 2 == 1 and ws >= 3
            for N in (ws, ws + 1, tile + ws - 2, tile + ws + 1,
                      2 * tile + ws - 1, 2 * tile + ws):
                batches = (1, 3, 130) if dtype == torch.float32 else (1, 3)
                for B in batches if N < 4 * tile else (1, 3):
                    flat = torch.from_numpy(rng.standard_normal(
                        B * N + 3)).to(dev, dtype)
                    for base in range(4):
                        x = flat[base:base + B * N].view(B, N)
                        runs = [("K3", "corr1d_valid",
                                 lambda: cc.correlate_valid_cuda(x, w),
                                 lambda: cc.correlate_valid_plain(x, w))]
                        if odd:
                            runs.append(("K1", "sg1d_poly",
                                         lambda: cc.savgol_polynomial_cuda(
                                             x, w, ew, n, 1.0, -1.0),
                                         lambda: cc.savgol_polynomial_plain(
                                             x, w, ew, n, 1.0, -1.0)))
                            runs += [(f"K2 {m}", "sg1d_pad",
                                      lambda m=m: cc.savgol_padded_cuda(
                                          x, w, m, n),
                                      lambda m=m: cc.savgol_padded_plain(
                                          x, w, m, n))
                                     for m in ("edge", "symmetric", "wrap")]
                        for name, key, kernel, plain in runs:
                            got, _ = counted_all(kernel, {key: 1},
                                                 f"{name} ws={ws} N={N}")
                            e, sc = max_err(got, plain())
                            require(e <= tol * sc, f"{name} ws={ws} B={B} "
                                    f"N={N} offset {base} {dtype}: {e:.3e}")
                            worst[dtype] = max(worst[dtype], e / sc)
                            cases += 1
                            if name == "K3" and dtype == torch.float32:
                                p1 = dma1d.corr1d_dma_cuda(
                                    x, w, rows=1, cols=1024,
                                    n_out=N - ws + 1)
                                require(torch.equal(got, p1),
                                        f"K3 ws={ws} B={B} N={N} offset "
                                        f"{base}: not bit-equal to P1")
                                p1_equal += 1
    torch.cuda.synchronize()
    return (f"exact tile grid: {cases} cases (K1, K2 x 3 modes, K3; ws "
            f"{EXACT_WINDOWS}; N = ws, ws + 1 and outputs ending around the "
            f"1st and 2nd tile boundaries; row offsets 0-3; B 1/3/130), "
            f"worst scaled error f32={worst[torch.float32]:.3e} "
            f"f64={worst[torch.float64]:.3e} (tol {F32_TOL}, {F64_TOL}), one "
            f"launch each; K3 bit-equal to P1 in {p1_equal} f32 cases")


WIDE_N = 50    # window 101: past SavgolConfig's 65, inside K1-K3's 129 taps
SCIPY_MODES = ("interp", "mirror", "nearest", "wrap", "constant")


def wide_window(dev, card) -> dict:
    """K1, K2 and K3 at window 101 against their plain versions at the 1D
    headline batch, ``scipy_compat.savgol_filter`` on a numpy array at
    window 101 in all five modes against scipy (each call counted in its
    own zeroed window), and the times, K1 at window 25 in the same run."""
    from scipy.signal import savgol_filter as sp_filter

    from savgol_tpu_torch import scipy_compat as tsc
    from savgol_tpu_torch.ops import cuda_conv as cc
    from savgol_tpu_torch.utils.timing import device_ms

    n, ws = WIDE_N, 2 * WIDE_N + 1
    cw, ew = (torch.from_numpy(a).to(dev, torch.float32)
              for a in tsc._compat_weights_np(n, 4, 0))
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(B_FULL, N_FULL, generator=g, device=dev)
    routes = {
        "K1": (lambda: cc.savgol_polynomial_cuda(x, cw, ew, n),
               lambda: cc.savgol_polynomial_plain(x, cw, ew, n)),
        "K2 symmetric": (lambda: cc.savgol_padded_cuda(x, cw, "symmetric", n),
                         lambda: cc.savgol_padded_plain(x, cw, "symmetric",
                                                        n)),
        "K3": (lambda: cc.correlate_valid_cuda(x, cw),
               lambda: cc.correlate_valid_plain(x, cw)),
    }
    errs = {}
    for name, (kernel, plain) in routes.items():
        e, s = max_err(kernel(), plain())
        require(e <= F32_TOL * s, f"{name} ws={ws} vs plain: {e:.3e}")
        errs[name] = e
    row = np.random.default_rng(6).standard_normal(N_FULL).astype(np.float32)
    sp_err = 0.0
    for mode in SCIPY_MODES:
        got, _ = counted_all(
            lambda: tsc.savgol_filter(row, ws, 4, mode=mode, cval=0.5),
            SCIPY_LAUNCHES[mode], f"savgol_filter(numpy, {ws}, 4, {mode})")
        require(isinstance(got, np.ndarray), "numpy in, numpy out")
        err = float(np.abs(got - sp_filter(row.astype(np.float64), ws, 4,
                                           mode=mode, cval=0.5)).max())
        require(err <= GATE_ABS, f"savgol_filter {ws} {mode} vs scipy "
                f"{err:.3e}")
        sp_err = max(sp_err, err)
    c25, e25 = (torch.from_numpy(a).to(dev, torch.float32)
                for a in tsc._compat_weights_np(12, 4, 0))
    t = {name: (device_ms(kernel),
                device_ms(plain, warmup=1, reps=3))
         for name, (kernel, plain) in routes.items()}
    t["K1 ws=25"] = (device_ms(
        lambda: cc.savgol_polynomial_cuda(x, c25, e25, 12)), float("nan"))
    # yardstick: one cuDNN correlation of the same rows at 101 taps, TF32
    # off (timed here only; the port never calls it)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    x3, w3 = x.view(B_FULL, 1, N_FULL), cw.view(1, 1, -1)
    lib101 = device_ms(lambda: torch.nn.functional.conv1d(x3, w3))
    torch.backends.cudnn.allow_tf32 = tf32
    # f64: the same kernels at 101 taps (FP64 operations bound them)
    xd, cwd, ewd = x.double(), cw.double(), ew.double()
    del x
    t64 = {"K1 f64": device_ms(lambda: cc.savgol_polynomial_cuda(
               xd, cwd, ewd, n)),
           "K3 f64": device_ms(lambda: cc.correlate_valid_cuda(xd, cwd))}
    del xd
    b101 = speed_of_light_1d((B_FULL, N_FULL), half_window=ws // 2).fields
    b25 = speed_of_light_1d((B_FULL, N_FULL)).fields
    b101_64 = speed_of_light_1d((B_FULL, N_FULL), dtype="float64",
                                half_window=ws // 2).fields
    print(f"window {ws}: K1 / K2 / K3 vs plain at ({B_FULL}, {N_FULL}) "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (tol {F32_TOL} scaled); scipy_compat numpy in all five modes "
          f"vs scipy {sp_err:.3e} (gate {GATE_ABS}), one launch each; bound "
          f"at ws={ws} {b101['bound_ms']:.4f} ms ({b101['bound_by']}); "
          f"F.conv1d (TF32 off) at ws={ws} {lib101:.4f} ms [{card}]")
    for name, (k, p) in t.items():
        where, b = ("", b25) if "25" in name else (f" ws={ws}", b101)
        print(f"time {name}{where} ({B_FULL}, {N_FULL}) f32: kernel {k:.4f} "
              f"ms, plain {p:.4f} ms, bound {b['bound_ms']:.4f} ms "
              f"({b['bound_by']}) [{card}]")
    for name, k in t64.items():
        print(f"time {name} ws={ws} ({B_FULL}, {N_FULL}): kernel {k:.4f} ms, "
              f"bound {b101_64['bound_ms']:.4f} ms ({b101_64['bound_by']}) "
              f"[{card}]")
    return {"errs": errs, "t": t, "bound": b101, "library_ms": lib101,
            "t64": t64, "bound64": b101_64}


# -- 26-29. the sharded paths: a ring of ranks sharing the card --------------
#
# The functions named rank_* run on every rank of a launch.Pool (spawned
# processes that import this script as a module), each on its own block.

RING = 4


def _rank_mesh(names, shape, dev):
    from savgol_tpu_torch.parallel.launch import mesh
    return mesh(names, shape, dev.type)


def _time(dev, fn, **kw):
    """cuda_time_ms on the card; NaN on the CPU (a rehearsal of a phase
    there has no device time)."""
    from savgol_tpu_torch.utils.timing import cuda_time_ms
    return cuda_time_ms(fn, **kw) if dev.type == "cuda" else float("nan")


def _host(dev, fn):
    """host_ms (enqueue only, 100 calls back to back) on the card; NaN on
    the CPU."""
    from savgol_tpu_torch.utils.timing import host_ms
    return host_ms(fn, warmup=10, reps=100) if dev.type == "cuda" \
        else float("nan")


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _rank_counted(dev, run, want: dict, what: str):
    """run() on this rank with every launch count zeroed just before and
    read just after; on the card they must equal ``want`` exactly (CPU
    tensors take the plain versions, which count nothing)."""
    _sync(dev)
    for mod in kernel_modules():
        mod.reset_launches()
    out = run()
    _sync(dev)
    got = {}
    for mod in kernel_modules():
        got.update(mod.LAUNCHES)
    require(dev.type != "cuda" or nz(got) == want,
            f"{what} launched {nz(got)}, expected {want}")
    return out, nz(got)


def _same_everywhere(t: torch.Tensor) -> None:
    """Every rank generated the same global input (a checksum)."""
    import torch.distributed as dist
    sums = [None] * dist.get_world_size()
    dist.all_gather_object(sums, float(t.double().sum()))
    require(len(set(sums)) == 1, f"ranks made different inputs: {sums}")


def _alone(rank0: bool, fn):
    """fn() timed on rank 0 while the other ranks wait at a barrier on the
    host, so it has the card to itself; None elsewhere."""
    import torch.distributed as dist
    dist.barrier()
    out = fn() if rank0 else None
    dist.barrier()
    return out


def rank_k13_grid(dev_type: str = "cuda"):
    """K13 against the neighbours' slices of a global input and against its
    plain version (through the host), bit for bit, over rows x n x dtype x
    ring size, the row form over ny x C, the ring of one (no launch), and
    50 exchanges back to back (the epoch's two slots), on each route: the
    one the ranks take (the stream route: they share the card) and the SM
    route (``cuda_halo.ROUTE = "sms"``, a rank with a card to itself),
    with each route's launches counted."""
    from savgol_tpu_torch.ops import cuda_halo as ch
    from savgol_tpu_torch.parallel import halo_exchange_rdma_rows
    from savgol_tpu_torch.parallel.sharded import mesh_axis

    dev = torch.device(dev_type)
    cases = 0
    back = 0
    for route, recv in ((None, 1), ("sms", 0)):
        ch.ROUTE = route
        _sync(dev)
        ch.reset_launches()
        cases = 0
        for P, shape in ((2, (2, 2)), (4, (1, RING))):
            group, idx, _ = mesh_axis(
                _rank_mesh(("batch", "seq"), shape, dev), "seq")
            for dtype in (torch.float32, torch.float64):
                g = torch.Generator(device=dev).manual_seed(P)
                for rows in (1, 3, 128):
                    for n in (1, 12, 32):
                        L = 2 * n + 7
                        x = torch.randn(rows, P * L, generator=g,
                                        device=dev, dtype=dtype)
                        lo = ((idx - 1) % P) * L + L - n
                        ro = ((idx + 1) % P) * L
                        blk = x[:, idx * L:(idx + 1) * L]
                        tail = blk[:, -n:].contiguous()
                        head = blk[:, :n].contiguous()
                        left, right = ch.halo_exchange_cuda(tail, head, group)
                        pl, pr = ch.halo_exchange_plain(tail.cpu(),
                                                        head.cpu(), group)
                        require(torch.equal(left, x[:, lo:lo + n])
                                and torch.equal(right, x[:, ro:ro + n])
                                and torch.equal(pl, left.cpu())
                                and torch.equal(pr, right.cpu()),
                                f"K13 {route} P={P} rows={rows} n={n} "
                                f"{dtype} rank {idx}")
                        cases += 1
                for ny in (1, 5):
                    for C in (5, 2048):
                        R = 2 * ny + 3
                        x = torch.randn(2, P * R, C, generator=g, device=dev,
                                        dtype=dtype)
                        lo = ((idx - 1) % P) * R + R - ny
                        ro = ((idx + 1) % P) * R
                        top, bot = halo_exchange_rdma_rows(
                            x[:, idx * R:(idx + 1) * R].contiguous(), ny,
                            group)
                        require(torch.equal(top, x[:, lo:lo + ny])
                                and torch.equal(bot, x[:, ro:ro + ny]),
                                f"K13 {route} rows P={P} ny={ny} C={C} "
                                f"{dtype} rank {idx}")
                        cases += 1
        _sync(dev)
        launched = dict(ch.LAUNCHES)
        require(dev.type != "cuda" or launched == {
            "halo_send": cases, "halo_recv": recv * cases},
            f"K13 grid ({route}) launched {launched} for {cases} exchanges")
        group1, _, size1 = mesh_axis(
            _rank_mesh(("batch", "seq"), (RING, 1), dev), "seq")
        t = torch.randn(3, 12, device=dev)
        left, right = ch.halo_exchange_cuda(t, t + 1, group1)
        require(size1 == 1 and ch.LAUNCHES == launched
                and torch.equal(left, t) and torch.equal(right, t + 1),
                "a ring of one must return its own blocks without a launch")
        group, idx, _ = mesh_axis(
            _rank_mesh(("batch", "seq"), (1, RING), dev), "seq")
        x = torch.randn(B_FULL, RING * 64, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(9))
        lo, ro = ((idx - 1) % RING) * 64 + 52, ((idx + 1) % RING) * 64
        blk = x[:, idx * 64:(idx + 1) * 64]
        outs = [ch.halo_exchange_cuda(blk[:, -12:] + i, blk[:, :12] + i,
                                      group) for i in range(50)]
        _sync(dev)
        for i, (left, right) in enumerate(outs):
            require(torch.equal(left, x[:, lo:lo + 12] + i)
                    and torch.equal(right, x[:, ro:ro + 12] + i),
                    f"exchange {i} of 50 back to back ({route}), rank {idx}")
        back += len(outs)
    ch.ROUTE = None
    return cases, back


def rank_sharded_1d(dev_type: str = "cuda", shape=(B_FULL, N_FULL)):
    """The 1D headline split 4 ways along the samples, ``halo="rdma"``:
    launches of the main-path call, every boundary against the
    single-device ``Savgol1D.apply`` on the same card, POLYNOMIAL against
    the f64 oracle, K13 at the headline's halos against its plain version,
    and the times."""
    import savgol_tpu_torch as sgt
    from savgol_tpu_torch.ops import cuda_conv as cc
    from savgol_tpu_torch.ops import cuda_halo as ch
    from savgol_tpu_torch.ops.weights import savgol_weights_np
    from savgol_tpu_torch.parallel import apply_sharded, shard
    from savgol_tpu_torch.parallel.sharded import mesh_axis

    dev = torch.device(dev_type)
    m = _rank_mesh(("batch", "seq"), (1, RING), dev)
    group, idx, _ = mesh_axis(m, "seq")
    x = torch.randn(shape, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0))
    _same_everywhere(x)
    xl = shard(x, m, (None, "seq"))
    cols = slice(idx * xl.shape[-1], (idx + 1) * xl.shape[-1])
    cfg = sgt.SavgolConfig(12, 4)
    f = sgt.Savgol1D.create(cfg, device=dev)
    args = (xl, f.center_weights, f.edge_weights)
    kw = dict(half_window=12, mesh=m, dt_inv=f.dt_inv, halo="rdma")
    y, launches = _rank_counted(dev, lambda: apply_sharded(*args, **kw),
                                {"halo_send": 1, "halo_recv": 1,
                                 "corr1d_valid": 1},
                                "apply_sharded(halo='rdma')")
    require(y.shape == xl.shape and bool(torch.isfinite(y).all()),
            "sharded output shape / finiteness")
    errs = {}
    e, s = max_err(y, f.apply(x)[:, cols])
    require(e <= F32_TOL * s, f"sharded polynomial vs single: {e:.3e}")
    errs["polynomial"] = e / s
    c64, e64 = (torch.from_numpy(a).to(dev)
                for a in savgol_weights_np(cfg, np.float64))
    rows = sorted({0, 1, shape[0] // 2, shape[0] - 1})
    ref = cc.savgol_polynomial_plain(x[rows].double(), c64, e64, 12)[:, cols]
    err_f64 = (y[rows].double() - ref).abs().max().item()
    require(err_f64 <= GATE_ABS, f"sharded vs f64: {err_f64:.3e}")
    for bnd in ("periodic", "reflect", "constant"):
        e, s = max_err(apply_sharded(*args, boundary=bnd, **kw),
                       f.apply(x, boundary=bnd)[:, cols])
        require(e <= F32_TOL * s, f"sharded {bnd} vs single: {e:.3e}")
        errs[bnd] = e / s
    tail, head = xl[:, -12:].contiguous(), xl[:, :12].contiguous()
    kl, kr = ch.halo_exchange_cuda(tail, head, group)
    pl, pr = ch.halo_exchange_plain(tail.cpu(), head.cpu(), group)
    k13_err = max((kl.cpu() - pl).abs().max().item(),
                  (kr.cpu() - pr).abs().max().item())
    require(k13_err == 0.0, f"K13 vs plain at the headline: {k13_err}")

    def plain_staged():
        left, right = ch.halo_exchange_plain(tail.cpu(), head.cpu(), group)
        return left.to(dev), right.to(dev)

    t = {"K13": _time(dev, lambda: ch.halo_exchange_cuda(tail, head,
                                                           group), reps=50),
         "K13 host": _host(dev, lambda: ch.halo_exchange_cuda(tail, head,
                                                              group)),
         "K13 plain": _time(dev, plain_staged, reps=20),
         "apply_sharded": _time(dev, lambda: apply_sharded(*args, **kw))}
    t["Savgol1D.apply alone"] = _alone(idx == 0, lambda: _time(
        dev, lambda: f.apply(x)))
    return {"rank": idx, "launches": launches, "errs": errs,
            "err_f64": err_f64, "k13_err": k13_err, "t": t}


def rank_sharded_2d(dev_type: str = "cuda", shape=IMG_FULL):
    """The 2D headline, rows split 4 ways and a 2 x 2 tiling, ``halo=
    "rdma"``, against the single-device ``Savgol2D.apply``: launches of each
    call, errors, times."""
    import savgol_tpu_torch as sgt
    from savgol_tpu_torch.ops import cuda_halo as ch
    from savgol_tpu_torch.parallel import apply2d_sharded, shard
    from savgol_tpu_torch.parallel.sharded import mesh_axis

    dev = torch.device(dev_type)
    x = torch.randn(shape, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1))
    _same_everywhere(x)
    f2 = sgt.Savgol2D.create(sgt.Savgol2DConfig(5, 5, 3), device=dev)
    ref = f2.apply(x)
    out = {}
    # a rank's block, (16, 512, 2048) or (16, 1024, 1024) at the headline,
    # fills the card's K2D-sep slots: the cached rank-2 stencil takes it
    for name, names, shape, spec, extra, want in (
            ("rows", ("batch", "seq"), (1, RING), (None, "seq", None), {},
             {"halo_send": 1, "halo_recv": 1, "corr2d_sep": 1}),
            ("tiled", ("seq", "cols"), (2, 2), (None, "seq", "cols"),
             {"col_axis": "cols"},
             {"halo_send": 2, "halo_recv": 2, "corr2d_sep": 1})):
        m = _rank_mesh(names, shape, dev)
        xl = shard(x, m, spec)
        # (a CPU rehearsal tiles by point-to-point sends: K13 needs CUDA
        # tensors there)
        kw = dict(mesh=m, boundary="constant", scale=f2.scale,
                  halo="rdma" if dev.type == "cuda" else "ppermute", **extra)
        y, launches = _rank_counted(
            dev, lambda: apply2d_sharded(xl, f2.weights, **kw), want,
            f"apply2d_sharded {name}")
        _, ri, _ = mesh_axis(m, "seq")
        R, C = xl.shape[-2:]
        ci = mesh_axis(m, "cols")[1] if extra else 0
        e, s = max_err(y, ref[:, ri * R:(ri + 1) * R, ci * C:(ci + 1) * C])
        require(e <= F32_TOL_2D * s, f"2D {name} vs single: {e:.3e}")
        out[name] = {"launches": launches, "err": e / s,
                     "ms": _time(dev, lambda: apply2d_sharded(
                         xl, f2.weights, **kw))}
    m = _rank_mesh(("batch", "seq"), (1, RING), dev)
    group, idx, _ = mesh_axis(m, "seq")
    xl = shard(x, m, (None, "seq", None))
    tail = xl[:, -5:, :].reshape(-1, shape[-1])
    head = xl[:, :5, :].reshape(-1, shape[-1])
    out["K13 rows"] = _time(dev, lambda: ch.halo_exchange_cuda(
        tail, head, group), reps=50)
    out["Savgol2D.apply alone"] = _alone(idx == 0, lambda: _time(
        dev, lambda: f2.apply(x)))
    return out


def rank_sharded_grads(dev_type: str = "cuda"):
    """f64 gradients of sum(y ** 2) through K13 (forward and backward, one
    exchange each: halo_send and halo_recv) against the single-device ones:
    1D POLYNOMIAL and PERIODIC, 2D rows REFLECT."""
    import savgol_tpu_torch as sgt
    from savgol_tpu_torch.ops import cuda_halo as ch
    from savgol_tpu_torch.parallel import apply2d_sharded, apply_sharded, shard
    from savgol_tpu_torch.parallel.sharded import mesh_axis

    dev = torch.device(dev_type)
    m = _rank_mesh(("batch", "seq"), (1, RING), dev)
    idx = mesh_axis(m, "seq")[1]
    gen = torch.Generator(device=dev).manual_seed(2)
    worst = 0.0
    x = torch.randn(4, 4096, generator=gen, device=dev, dtype=torch.float64)
    f = sgt.Savgol1D.create(sgt.deriv1(6, 3, dt=0.5), dtype=torch.float64,
                            device=dev)
    img = torch.randn(2, 256, 64, generator=gen, device=dev,
                      dtype=torch.float64)
    f2 = sgt.Savgol2D.create(sgt.Savgol2DConfig(3, 3, 2, deriv_x=1),
                             dtype=torch.float64, device=dev)
    cases = [("1D " + b, x, (None, "seq"),
              lambda v, b=b: apply_sharded(
                  v, f.center_weights, f.edge_weights, half_window=6,
                  mesh=m, boundary=b, dt_inv=f.dt_inv, derivative=1,
                  halo="rdma"),
              lambda v, b=b: f.apply(v, boundary=b))
             for b in ("polynomial", "periodic")]
    cases.append(("2D rows reflect", img, (None, "seq", None),
                  lambda v: apply2d_sharded(v, f2.weights, mesh=m,
                                            boundary="reflect",
                                            scale=f2.scale, halo="rdma"),
                  lambda v: f2.apply(v, boundary="reflect")))
    for name, xg, spec, sharded, single in cases:
        xl = shard(xg, m, spec).requires_grad_()
        before = dict(ch.LAUNCHES)
        g, = torch.autograd.grad(sharded(xl).square().sum(), xl)
        _sync(dev)
        require(dev.type != "cuda" or all(
            ch.LAUNCHES[k] == before[k] + 2 for k in before),
            f"{name}: K13 must run once forward and once backward")
        xs = xg.clone().requires_grad_()
        gs, = torch.autograd.grad(single(xs).square().sum(), xs)
        e = (g - shard(gs, m, spec)).abs().max().item()
        require(e <= F64_TOL, f"{name} gradient vs single: {e:.3e}")
        worst = max(worst, e)
    return {"rank": idx, "worst": worst}


def sharded_phases(card, dev_type: str = "cuda", shape1d=(B_FULL, N_FULL),
                   shape2d=IMG_FULL) -> dict:
    """Phases 26-29 on one pool of RING ranks sharing the card: the K13
    grid, the 1D and 2D headlines sharded with ``halo="rdma"``, the
    gradients and bf16; then phase 29b, K13 in one process. Returns K13's
    record for the kernels line."""
    from savgol_tpu_torch.parallel.launch import Pool

    t0 = time.perf_counter()
    with Pool(RING, device=dev_type) as pool:
        cases, back = pool.run(rank_k13_grid, dev_type)[0]
        print(f"K13 grid: {cases} cases a rank and route (rows 1/3/128 x n "
              f"1/12/32 x f32/f64 on rings of 2 and {RING}; row blocks ny "
              f"1/5 x C 5/2048) on the stream route (halo_send + halo_recv) "
              f"and the SM route (halo_send), bit for bit against the "
              f"neighbours' slices and the plain version; a ring of one "
              f"launches nothing; {back} exchanges back to back, each exact "
              f"({RING} ranks on one card)")
        r1 = pool.run(rank_sharded_1d, dev_type, shape1d)
        t_1d = time.perf_counter()
        errs = {b: max(r["errs"][b] for r in r1) for b in r1[0]["errs"]}
        print(f"sharded 1D {shape1d} f32 n=12 m=4 over {RING} ranks "
              f"(halo='rdma'): launches a rank {r1[0]['launches']}; vs the "
              f"single-device Savgol1D.apply, scaled "
              + ", ".join(f"{b} {e:.3e}" for b, e in errs.items())
              + f" (tol {F32_TOL}); POLYNOMIAL vs f64 "
              f"{max(r['err_f64'] for r in r1):.3e} (gate {GATE_ABS}); K13 "
              f"vs plain at the headline halos "
              f"{max(r['k13_err'] for r in r1):.1f}")
        t1 = {k: [r["t"][k] for r in r1] for k in r1[0]["t"]}
        for k, v in t1.items():
            shown = [x for x in v if x is not None]
            print(f"time {k} (1D headline, {RING} ranks sharing the card; "
                  f"by rank): " + ", ".join(f"{x:.4f}" for x in shown)
                  + f" ms [{card}]")
        r2 = pool.run(rank_sharded_2d, dev_type, shape2d)
        t_2d = time.perf_counter()
        for name in ("rows", "tiled"):
            print(f"sharded 2D {shape2d} f32 11x11 order 3 CONSTANT {name} "
                  f"(halo='rdma'): launches a rank {r2[0][name]['launches']}"
                  f"; vs Savgol2D.apply scaled "
                  f"{max(r[name]['err'] for r in r2):.3e} (tol {F32_TOL_2D})"
                  f"; time by rank " + ", ".join(
                      f"{r[name]['ms']:.4f}" for r in r2) + f" ms [{card}]")
        print("time K13 exchange at the 2D rows halos (by rank): "
              + ", ".join(f"{r['K13 rows']:.4f}" for r in r2)
              + f" ms; Savgol2D.apply alone on the card "
              f"{r2[0]['Savgol2D.apply alone']:.4f} ms [{card}]")
        rg = pool.run(rank_sharded_grads, dev_type)
        print(f"sharded gradients (f64; 1D polynomial / periodic, 2D rows "
              f"reflect; K13 forward and backward): worst abs error vs the "
              f"single-device gradient {max(r['worst'] for r in rg):.3e} "
              f"(tol {F64_TOL})")
        t_grads = time.perf_counter()
        rb = pool.run(rank_sharded_bf16, dev_type, shape1d, shape2d)
        e1, u1, e2, s2 = (max(r["errs"][i] for r in rb) for i in range(4))
        print(f"sharded bf16 (halo='rdma', {RING} ranks): launches a rank 1D "
              f"{rb[0]['launches'][0]}, 2D rows {rb[0]['launches'][1]}; vs "
              f"f64 scaled 1D {e1:.3e}, 2D {e2:.3e} (contract "
              f"{BF16_CONTRACT}); vs the single-device bf16 apply 1D {u1:.3e}"
              f" (one bf16 ulp, outer n samples left out), 2D {s2:.3e} (tol "
              f"{F32_TOL_2D} scaled); time by rank 1D "
              + ", ".join(f"{r['t']['1D']:.4f}" for r in rb) + " ms, 2D rows "
              + ", ".join(f"{r['t']['2D rows']:.4f}" for r in rb)
              + f" ms [{card}]")
    t_one = time.perf_counter()
    one = one_process_phase(card) if dev_type == "cuda" else None
    t_end = time.perf_counter()
    print(f"wall time sharded phases: pool start, K13 grid and 1D "
          f"{t_1d - t0:.1f} s, 2D {t_2d - t_1d:.1f} s, gradients "
          f"{t_grads - t_2d:.1f} s, bf16 and shutdown {t_one - t_grads:.1f} "
          f"s, one process {t_end - t_one:.1f} s")
    per_exchange = {k: v for k, v in r1[0]["launches"].items()
                    if k.startswith("halo_")}
    rec = {"name": "halo_ring", "route": "cuda",
           "source": "savgol_tpu_torch/csrc/halo_ring.cu",
           "replaces": "savgol_tpu/parallel/ici_halo.py:39",
           "launches": per_exchange.get("halo_send", 0),
           "launches_per_exchange": per_exchange,
           "max_abs_err": max(r["k13_err"] for r in r1),
           "ms": t1["K13"][0], "plain_ms": t1["K13 plain"][0],
           **speed_of_light_halo(RING, (shape1d[0], 12)).fields,
           "library_ms": None,
           "ms_by_rank": t1["K13"], "ranks_sharing_one_card": RING,
           "rows_2d_ms": r2[0]["K13 rows"],
           "rows_2d_ms_by_rank": [r["K13 rows"] for r in r2],
           "rows_2d_bound_ms": speed_of_light_halo(
               RING, (shape2d[0], 5, shape2d[2])).fields["bound_ms"]}
    if one is not None:
        rec.update(one_process_ms=one["b"]["1d"]["ms"],
                   one_process_rows_2d_ms=one["b"]["rows"]["ms"],
                   one_process_stream_route_ms=one["b stream route"]["1d"][
                       "ms"],
                   one_process_stream_route_rows_2d_ms=one[
                       "b stream route"]["rows"]["ms"])
    return rec


def one_process_phase(card) -> dict:
    """Phase 29b: K13 in one process and one context, four ring members on
    four streams (``probes/halo_ab.py --only b``, in a process of its own so
    that its streams get hardware queues of their own): the exchange's time
    without the time-slicer, on the SM route (a rank with a card to itself)
    and on the stream route, at the 1D headline and 2D rows halos, every
    member's outputs bit for bit the neighbours' slices over 20 exchanges
    back to back."""
    probe = (pathlib.Path(__file__).resolve().parent / "savgol_tpu_torch"
             / "probes" / "halo_ab.py")
    done = subprocess.run([sys.executable, str(probe), "--only", "b"],
                          capture_output=True, text=True, timeout=600)
    require(done.returncode == 0,
            f"halo_ab.py --only b exited {done.returncode}: "
            f"{done.stderr[-3000:]}")
    rec = json.loads(done.stdout.strip().splitlines()[-1])
    for route in ("b", "b stream route"):
        for size, r in rec[route].items():
            require(r["exact"], f"K13 one process {route} {size}: outputs "
                                "are not the neighbours' slices")
    print("time K13 exchange in one process, 4 members on 4 streams (no "
          "time-slicer; outputs bit for bit over 20 back to back): SM route "
          + ", ".join(f"{k} {v['ms']:.4f}" for k, v in rec["b"].items())
          + " ms; stream route " + ", ".join(
              f"{k} {v['ms']:.4f}" for k, v in rec["b stream route"].items())
          + f" ms [{card}]")
    return rec


# -- 30-35. method="bf16" and the attribution probes P2, P3 -------------------
#
# K1, K2, K3 and K2D-dense in their bf16 mode (bf16 samples and taps, f32
# sums, outputs rounded to bf16; K2D-dense's f32 storage keeps the f32 sums)
# against their bf16 plain versions, then through the entry points at full
# size against float64, then P3 and P2.

# bench.py:439 and :566: the bf16 mode's contract, max abs error against the
# exact result <= 5e-3 * max(1, max|y|); here against float64
BF16_CONTRACT = 5e-3
BF16_HALVES = (1, 12, 32, 50, 64)        # windows 3, 25, 65, 101, 129
BF16_BATCHES = (1, 16, 24, 128)
BF16_STORAGE = (torch.float32, torch.bfloat16)
# K3-bf16 windows past K1's odd ones >= 3: one tap, even windows
K3_BF16_WINDOWS = (1, 2, 4, 24, 128)


def ulp_check(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """``got`` within one bf16 ulp of ``want`` elementwise (plus 1e-6 of
    max|want|: ``cuda_conv.bf16_ulp_gate``); returns the max abs error."""
    from savgol_tpu_torch.ops.cuda_conv import bf16_ulp_gate
    got, want = got.double(), want.double()
    err = (got - want).abs()
    require(bool((err <= bf16_ulp_gate(want)).all()),
            f"{what}: {int((err > bf16_ulp_gate(want)).sum())} outputs past "
            f"one bf16 ulp, max {err.max().item():.3e}")
    return err.max().item()


def f32_check(got: torch.Tensor, want: torch.Tensor, what: str,
              tol: float = F32_TOL) -> float:
    e, s = max_err(got, want)
    require(e <= tol * s, f"{what}: {e:.3e} (scale {s:.3e})")
    return e


def bf16_grid_1d(dev) -> str:
    """K1, K2 (three pad modes) and K3 in their bf16 mode against their
    plain versions: windows 3 / 25 / 65 / 101 / 129, B 1 / 16 / 24 / 128, N
    ws / ws + 1 / 4099 / 262,147, f32 and bf16 storage, derivatives 0-2
    (dt_inv 100^d folded into the taps), both edge signs; the first
    derivative on rows that start 1-7 samples past a 16-byte boundary (a
    view into a larger buffer); then K3-bf16 at one tap and even windows
    (``K3_BF16_WINDOWS``), B 1 / 3 / 130 / 16 and N from ws to 3 x 8192 +
    5, rows aligned and misaligned."""
    from savgol_tpu_torch import scipy_compat as tsc
    from savgol_tpu_torch.ops import cuda_conv as cc
    rng = np.random.default_rng(11)
    worst = {"sg1d_poly": 0.0, "sg1d_pad": 0.0, "corr1d_valid": 0.0}
    cases = 0
    cc.reset_launches()
    for storage in BF16_STORAGE:
        for n in BF16_HALVES:
            ws = 2 * n + 1
            for B in BF16_BATCHES:
                for N in (ws, ws + 1, 4099, 262_147):
                    x0 = torch.from_numpy(rng.standard_normal(
                        (B, N), dtype=np.float32)).to(dev, storage)
                    off = 1 + (B + N) % 7
                    xm = torch.empty(B * N + 8, dtype=storage, device=dev)
                    xm = xm[off:off + B * N].view(B, N)
                    xm.copy_(x0)
                    for d in (0, 1, 2):
                        x = xm if d == 1 else x0
                        cw, ew = (torch.from_numpy(a).to(dev, torch.float32)
                                  for a in tsc._compat_weights_np(
                                      n, min(4, 2 * n), d))
                        dt = torch.tensor(100.0 ** d, device=dev)
                        where = (f"n={n} B={B} N={N} d={d} {storage}"
                                 + (f" offset {off}" if d == 1 else ""))
                        for sign in (1.0, -1.0):
                            e = ulp_check(
                                cc.savgol_polynomial_bf16_cuda(x, cw, ew, n,
                                                               dt, sign),
                                cc.savgol_polynomial_bf16_plain(x, cw, ew, n,
                                                                dt, sign),
                                f"K1-bf16 {where} sign={sign}")
                            worst["sg1d_poly"] = max(worst["sg1d_poly"], e)
                        for mode in PAD_MODES.values():
                            e = ulp_check(
                                cc.savgol_padded_bf16_cuda(x, cw, mode, n, dt),
                                cc.savgol_padded_bf16_plain(x, cw, mode, n,
                                                            dt),
                                f"K2-bf16 {mode} {where}")
                            worst["sg1d_pad"] = max(worst["sg1d_pad"], e)
                        e = ulp_check(cc.correlate_valid_bf16_cuda(x, cw),
                                      cc.correlate_valid_bf16_plain(x, cw),
                                      f"K3-bf16 {where}")
                        worst["corr1d_valid"] = max(worst["corr1d_valid"], e)
                        cases += 6
    # K3-bf16 at the windows only the VALID correlation brings to the
    # tensor-core tile (one tap: a band of one chunk; even windows), with
    # output rows of any alignment and rows 0 or 1-7 samples past a 16-byte
    # boundary
    k3 = 0
    for storage in BF16_STORAGE:
        for ws in K3_BF16_WINDOWS:
            w = torch.from_numpy(rng.standard_normal(
                ws, dtype=np.float32)).to(dev)
            for B, N in ((1, ws), (3, ws + 7), (130, 8195 + ws),
                         (16, 3 * 8192 + 5)):
                x0 = torch.from_numpy(rng.standard_normal(
                    B * N + 8, dtype=np.float32)).to(dev, storage)
                for off in (0, 1 + (B + N) % 7):
                    x = x0[off:off + B * N].view(B, N)
                    e = ulp_check(cc.correlate_valid_bf16_cuda(x, w),
                                  cc.correlate_valid_bf16_plain(x, w),
                                  f"K3-bf16 ws={ws} B={B} N={N} {storage} "
                                  f"offset {off}")
                    worst["corr1d_valid"] = max(worst["corr1d_valid"], e)
                    k3 += 1
    torch.cuda.synchronize()
    launches = dict(cc.LAUNCHES)
    require(all(v > 0 for v in launches.values()),
            f"bf16 1D grid did not reach every kernel: {launches}")
    return (f"bf16 1D grid: {cases} cases (windows 3/25/65/101/129, f32 "
            f"and bf16 storage, misaligned rows) and {k3} K3-bf16 cases "
            f"(windows {K3_BF16_WINDOWS}), each within one bf16 ulp "
            f"of its plain version; "
            f"max abs error " + ", ".join(f"{k} {v:.3e}"
                                          for k, v in worst.items())
            + f"; launches {launches}")


def bf16_grid_2d(dev) -> str:
    """K2D-dense in its bf16 mode against its plain version over every 2D
    window up to 33 x 33, the four boundaries, stacks K = 1 and 3, three
    images and both storages (f32 output within 2e-6 scaled, bf16 output
    one bf16 ulp); then random stencils of every window on the first image,
    f32 output within F32_TOL_2D."""
    from savgol_tpu_torch.ops import cuda_conv2d as c2
    from savgol_tpu_torch.ops.apply2d import _stencil_stack
    rng = np.random.default_rng(12)
    modes = {"valid": None, **{b: PAD_MODES[b] for b in
                               ("constant", "reflect", "periodic")}}
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    cases = 0
    c2.reset_launches()
    for storage in BF16_STORAGE:
        for shape in IMAGES_2D:
            x = torch.from_numpy(rng.standard_normal(
                shape, dtype=np.float32)).to(dev, storage)
            for H, W in WINDOWS_2D:
                order = 2 if min(H, W) == 3 else 3
                for derivs in ([(1, 1)], [(2, 0), (1, 1), (0, 2)]):
                    ws, _ = _stencil_stack((W - 1) // 2, (H - 1) // 2, order,
                                           derivs, 0.5, 0.25)
                    w = torch.from_numpy(ws).to(dev)
                    w = w[0] if len(derivs) == 1 else w
                    for bnd, pm in modes.items():
                        if pm is None and (shape[1] < H or shape[2] < W):
                            continue
                        got = c2.correlate2d_valid_bf16_cuda(x, w, pm)
                        want = c2.correlate2d_valid_bf16_plain(x, w, pm)
                        what = (f"K2D-dense-bf16 {storage} {shape} {H}x{W} "
                                f"K={len(derivs)} {bnd}")
                        e = (f32_check(got, want, what)
                             if storage == torch.float32
                             else ulp_check(got, want, what))
                        worst[storage] = max(worst[storage], e)
                        cases += 1
    # random N(0, 1) stencils: partial sums far above the result, where the
    # tensor cores' f32 sums meet F32_TOL_2D (tests/test_torch_bf16_2d.py)
    x = torch.from_numpy(rng.standard_normal(IMAGES_2D[0],
                                             dtype=np.float32)).to(dev)
    rand_worst = {}
    for H, W in WINDOWS_2D:
        w = torch.from_numpy(rng.standard_normal(
            (H, W), dtype=np.float32)).to(dev)
        for bnd, pm in modes.items():
            got = c2.correlate2d_valid_bf16_cuda(x, w, pm)
            want = c2.correlate2d_valid_bf16_plain(x, w, pm)
            e, sc = max_err(got, want)
            require(e <= F32_TOL_2D * sc, f"K2D-dense-bf16 random {H}x{W} "
                    f"{bnd}: {e:.3e} (scale {sc:.3e})")
            rand_worst[f"{H}x{W}"] = max(rand_worst.get(f"{H}x{W}", 0.0),
                                         e / sc)
            cases += 1
    torch.cuda.synchronize()
    require(c2.LAUNCHES["corr2d_valid"] == cases and
            c2.LAUNCHES["corr2d_sep"] == 0,
            f"bf16 2D grid launched {c2.LAUNCHES} for {cases} cases")
    return (f"bf16 2D grid: {cases} cases (windows 3x3-33x33, K = 1 / 3, "
            f"four boundaries); max abs error f32 output "
            f"{worst[torch.float32]:.3e} (tol {F32_TOL} scaled), bf16 output "
            f"{worst[torch.bfloat16]:.3e} (one bf16 ulp); random stencils, "
            f"f32 output, worst scaled error by window "
            + ", ".join(f"{k} {v:.3e}" for k, v in rand_worst.items())
            + f" (tol {F32_TOL_2D})")


# -- NaN / inf patterns of every stencil kernel -------------------------------

NONFINITE_2D_AT = ((0, 150, 200, "nan"), (0, 20, 3, "inf"), (0, 64, 128, "nan"),
                   (1, 299, 516, "-inf"), (1, 100, 100, "inf"),
                   (1, 100, 104, "-inf"), (1, 0, 0, "nan"))


def nonfinite_image(gen, dev, dtype) -> torch.Tensor:
    """(2, 300, 517) random samples with NaN, +inf and -inf at
    ``NONFINITE_2D_AT``: inside a tile, at edges and corners (which the pad
    modes reflect), on a 64 x 128 tile corner, and +inf and -inf inside one
    window, whose sum is NaN."""
    x = torch.randn(2, 300, 517, generator=gen, device=dev, dtype=dtype)
    for b, r, c, v in NONFINITE_2D_AT:
        x[b, r, c] = float(v)
    return x


def k3_bf16_window_tiles(x: torch.Tensor, ws: int) -> tuple[int, int]:
    """(tiles of K3-bf16 on ``x`` (B, N) that stage an inf or a NaN and so
    compute every output from its window on the CUDA cores, those of them
    whose stored outputs read no such sample): the tiles of
    ``csrc/corr1d_valid.cu`` (8192 outputs from t0, staged to t0 + 8192 + 16
    KC - 16 with KC = (ws + 30) // 16; bf16 storage shifts a row's tiles by
    the row's misalignment in samples, ``sg1d_bf16.cuh`` first_output)."""
    tile, B, N = 8192, x.shape[0], x.shape[-1]
    n_out, staged = N - ws + 1, 8192 + 16 * ((ws + 30) // 16) - 16
    shifted = x.dtype == torch.bfloat16
    bad = ~torch.isfinite(x.to(torch.bfloat16)).cpu()
    flagged = stray = 0
    for b in range(B):
        where = torch.nonzero(bad[b]).flatten().tolist()
        if not where:
            continue
        e = (x[b].data_ptr() // 2) % 8 if shifted else 0
        for t in range(-(-(n_out + 7 * shifted) // tile)):
            t0 = t * tile - e
            if t0 >= n_out:
                continue
            lo, hi = max(t0, 0), min(t0 + tile, n_out)
            if any(t0 <= j < t0 + staged for j in where):
                flagged += 1
                stray += not any(lo <= j < hi + ws - 1 for j in where)
    return flagged, stray


def nonfinite_grid(dev) -> str:
    """Every stencil kernel on input holding NaN, +inf and -inf against its
    plain version: the NaN, +inf and -inf outputs exactly where the plain
    version has them (k4_nonfinite_check), the finite ones within the
    kernel's own gate. K1, K2 (three pad modes) and K3 and their bf16 modes
    (f32 and bf16 storage) on K4's rows; the exact K2D-dense with one
    stencil and three, K7 and K2D-dense's bf16 mode (both storages, one
    stencil and three) on ``nonfinite_image`` over windows 3 x 3 to 33 x 33
    and the four boundaries, K7 also at ranks 3 and 4 (``RANKED_2D``). K4
    has its own cases (k4_grid) and K8a its own (masked_slice)."""
    from savgol_tpu_torch import scipy_compat as tsc
    from savgol_tpu_torch.ops import cuda_conv as cc
    from savgol_tpu_torch.ops import cuda_conv2d as c2
    from savgol_tpu_torch.ops.apply2d import _factors, _stencil_stack
    gen = torch.Generator(device=dev).manual_seed(39)
    cases = {}

    def check(kernel, case, got, want, gate):
        what = f"{kernel} non-finite {case}"
        e, sc = k4_nonfinite_check(got, want, what)
        if gate == "ulp":
            fin = torch.isfinite(want)
            ulp_check(got[fin], want[fin], what)
        else:
            require(e <= gate * sc, f"{what}: {e:.3e} (scale {sc:.3e})")
        cases[kernel] = cases.get(kernel, 0) + 1

    for dtype, tol in ((torch.float32, F32_TOL), (torch.float64, F64_TOL)):
        x = k4_nonfinite_input(gen, dev, dtype)
        for n in (3, 12):
            cw, ew = (torch.from_numpy(a).to(dev, dtype)
                      for a in tsc._compat_weights_np(n, 4 if n > 3 else 2, 1))
            for sign in (1.0, -1.0):
                check("K1", f"n={n} {dtype} sign={sign}",
                      cc.savgol_polynomial_cuda(x, cw, ew, n, 2.0, sign),
                      cc.savgol_polynomial_plain(x, cw, ew, n, 2.0, sign),
                      tol)
            for mode in PAD_MODES.values():
                check("K2", f"n={n} {mode} {dtype}",
                      cc.savgol_padded_cuda(x, cw, mode, n, 2.0),
                      cc.savgol_padded_plain(x, cw, mode, n, 2.0), tol)
            check("K3", f"n={n} {dtype}", cc.correlate_valid_cuda(x, cw),
                  cc.correlate_valid_plain(x, cw), tol)
    x = k4_nonfinite_input(gen, dev, torch.float32)
    for storage in BF16_STORAGE:
        xs = x.to(storage)
        for n in (3, 12, 64):
            cw, ew = (torch.from_numpy(a).to(dev, torch.float32)
                      for a in tsc._compat_weights_np(n, 4, 1))
            dt = torch.tensor(2.0, device=dev)
            where = f"n={n} {storage}"
            check("K1-bf16", where,
                  cc.savgol_polynomial_bf16_cuda(xs, cw, ew, n, dt, -1.0),
                  cc.savgol_polynomial_bf16_plain(xs, cw, ew, n, dt, -1.0),
                  "ulp")
            for mode in PAD_MODES.values():
                check("K2-bf16", f"{where} {mode}",
                      cc.savgol_padded_bf16_cuda(xs, cw, mode, n, dt),
                      cc.savgol_padded_bf16_plain(xs, cw, mode, n, dt), "ulp")
            check("K3-bf16", where, cc.correlate_valid_bf16_cuda(xs, cw),
                  cc.correlate_valid_bf16_plain(xs, cw), "ulp")
    # K3-bf16 on rows of three tiles whose NaN / inf samples sit just past a
    # tile's last window (staged by that tile, read by none of its stored
    # outputs) or inside: how often a tile takes window_tile for a sample it
    # only stages
    tiles = [0, 0]
    xl = torch.randn(3, 3 * 8192 + 5, generator=gen, device=dev)
    for storage in BF16_STORAGE:
        for ws in (7, 24, 25):
            xs = xl.clone()
            xs[0, 8192 + ws], xs[1, 2 * 8192 + ws] = float("nan"), float("inf")
            xs[2, 5000] = float("-inf")
            xs = xs.to(storage)
            w = torch.from_numpy(np.random.default_rng(ws).standard_normal(
                ws, dtype=np.float32)).to(dev)
            check("K3-bf16", f"ws={ws} {storage} past a tile's windows",
                  cc.correlate_valid_bf16_cuda(xs, w),
                  cc.correlate_valid_bf16_plain(xs, w), "ulp")
            for i, v in enumerate(k3_bf16_window_tiles(xs, ws)):
                tiles[i] += v

    modes = {"valid": None, **{b: PAD_MODES[b] for b in
                               ("constant", "reflect", "periodic")}}
    for dtype, tol in ((torch.float32, F32_TOL_2D), (torch.float64, F64_TOL)):
        img = nonfinite_image(gen, dev, dtype)
        for H, W in WINDOWS_2D:
            order = 2 if min(H, W) == 3 else 3
            ws, s = _stencil_stack((W - 1) // 2, (H - 1) // 2, order,
                                   [(2, 0), (1, 1), (0, 2)], 1.0, 1.0)
            w3 = torch.from_numpy(ws * s[:, None, None]).to(dev, dtype)
            u, v = (torch.from_numpy(f).to(dev, dtype)
                    for f in c2._svd_stencil_np(ws[1]))
            for bnd, pm in modes.items():
                where = f"{H}x{W} {bnd} {dtype}"
                for K, w in ((1, w3[1]), (3, w3)):
                    check("K2D-dense", f"K={K} {where}",
                          c2.correlate2d_valid_cuda(img, w, pm),
                          c2.correlate2d_valid_plain(img, w, pm), tol)
                check("K7", where, c2.correlate2d_sep_cuda(img, u, v, pm),
                      c2.correlate2d_sep_plain(img, u, v, pm), tol)
        # K7 at the ranks of the wide smoothing stencils (its sweep)
        for H, W, order in RANKED_2D:
            w0 = torch.from_numpy(_stencil_stack(
                (W - 1) // 2, (H - 1) // 2, order, [(0, 0)], 1.0, 1.0)[0][0])
            (u, v), = _factors(w0, dtype, dev)
            for bnd, pm in modes.items():
                check("K7", f"{H}x{W} rank {u.shape[0]} {bnd} {dtype}",
                      c2.correlate2d_sep_cuda(img, u, v, pm),
                      c2.correlate2d_sep_plain(img, u, v, pm), tol)
    img = nonfinite_image(gen, dev, torch.float32)
    for storage in BF16_STORAGE:
        xs = img.to(storage)
        for H, W in WINDOWS_2D:
            order = 2 if min(H, W) == 3 else 3
            ws, _ = _stencil_stack((W - 1) // 2, (H - 1) // 2, order,
                                   [(2, 0), (1, 1), (0, 2)], 0.5, 0.25)
            w3 = torch.from_numpy(ws).to(dev, torch.float32)
            for bnd, pm in modes.items():
                for K, w in ((1, w3[1]), (3, w3)):
                    check("K2D-dense-bf16", f"K={K} {H}x{W} {bnd} {storage}",
                          c2.correlate2d_valid_bf16_cuda(xs, w, pm),
                          c2.correlate2d_valid_bf16_plain(xs, w, pm),
                          F32_TOL if storage == torch.float32 else "ulp")
    torch.cuda.synchronize()
    return (f"non-finite grid: NaN / +inf / -inf patterns equal to the plain "
            f"versions' in " + ", ".join(f"{k} {v}" for k, v in
                                          cases.items())
            + " cases; finite outputs within each kernel's gate; K3-bf16 on "
            f"rows of three tiles: {tiles[0]} tiles through window_tile, "
            f"{tiles[1]} of them for a sample none of their stored outputs "
            f"reads")


def _contract(got, ref, what) -> float:
    """max |got - ref| <= BF16_CONTRACT * max(1, max|ref|); returns the
    scaled error."""
    e, s = max_err(got, ref)
    require(e <= BF16_CONTRACT * s, f"{what} vs f64: {e:.3e} (scale {s:.3e},"
            f" contract {BF16_CONTRACT})")
    return e / s


def bf16_slice_1d(sgt, dev, card) -> list:
    """The 1D headline in bf16 through the user's entry points: ``apply``
    on bf16 and on f32 storage, ``apply_valid`` and the three pad
    boundaries, each counted in its own zeroed window (its launches, and
    the tap tensors and storage it rounds, ``cuda_conv.ROUNDED``) and held
    to the contract against float64; each kernel against its plain version
    at the headline; f64 gradients through the bf16 routes; times. Returns the
    bf16 modes' records."""
    from savgol_tpu_torch.ops import cuda_conv as cc
    from savgol_tpu_torch.ops.weights import savgol_weights_np
    from savgol_tpu_torch.utils.timing import cuda_time_ms, cudnn_ms, device_ms

    cfg = sgt.SavgolConfig(12, 4)
    f = sgt.Savgol1D.create(cfg, device=dev)
    x32 = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (B_FULL, N_FULL), dtype=np.float32)).to(dev)
    xb = x32.to(torch.bfloat16)
    c64, e64 = (torch.from_numpy(a).to(dev)
                for a in savgol_weights_np(cfg, np.float64))
    rows = sorted({0, 1, B_FULL // 2, B_FULL - 1})
    runs = {
        "apply bf16": (lambda: f.apply(xb, method="bf16"), {"sg1d_poly": 1},
                       xb, lambda v: cc.savgol_polynomial_plain(
                           v, c64, e64, 12)),
        "apply f32": (lambda: f.apply(x32, method="bf16"), {"sg1d_poly": 1},
                      x32, lambda v: cc.savgol_polynomial_plain(
                          v, c64, e64, 12)),
        "apply_valid bf16": (lambda: f.apply_valid(xb, method="bf16"),
                             {"corr1d_valid": 1}, xb,
                             lambda v: cc.correlate_valid_plain(v, c64)),
    }
    for bnd, mode in PAD_MODES.items():
        runs[f"apply {bnd} bf16"] = (
            lambda b=bnd: f.apply(xb, boundary=b, method="bf16"),
            {"sg1d_pad": 1}, xb,
            lambda v, m=mode: cc.savgol_padded_plain(v, c64, m, 12))
    launches, errs = {}, {}
    for name, (run, want, inp, oracle) in runs.items():
        before = dict(cc.ROUNDED)
        y, launches[name] = counted_all(run, want, f"Savgol1D {name}")
        # K1 rounds its centre and edge taps, K2 and K3 their one stencil;
        # f32 and bf16 storage go to the kernel unrounded
        rounded = {k: cc.ROUNDED[k] - before[k] for k in before}
        taps = 2 if "sg1d_poly" in want else 1
        require(rounded == {"taps": taps, "storage": 0},
                f"{name}: rounded {rounded}, expected {taps} tap tensors "
                f"and no storage")
        require(y.dtype == inp.dtype and bool(torch.isfinite(y).all()),
                f"{name}: dtype {y.dtype} or non-finite output")
        require(torch.equal(y, y.to(torch.bfloat16).to(y.dtype)),
                f"{name}: outputs not bf16-rounded (not the bf16 mode)")
        errs[name] = _contract(y[rows], oracle(inp[rows].double()), name)
        del y
    w, ew = f.center_weights, f.edge_weights
    kern = {
        "K1-bf16": (lambda: cc.savgol_polynomial_bf16_cuda(xb, w, ew, 12),
                    lambda: cc.savgol_polynomial_bf16_plain(xb, w, ew, 12)),
        "K1-bf16 f32 storage": (
            lambda: cc.savgol_polynomial_bf16_cuda(x32, w, ew, 12),
            lambda: cc.savgol_polynomial_bf16_plain(x32, w, ew, 12)),
        **{f"K2-bf16 {m}": (
            lambda m=m: cc.savgol_padded_bf16_cuda(xb, w, m, 12),
            lambda m=m: cc.savgol_padded_bf16_plain(xb, w, m, 12))
           for m in ("symmetric", "wrap", "edge")},
        "K3-bf16": (lambda: cc.correlate_valid_bf16_cuda(xb, w),
                    lambda: cc.correlate_valid_bf16_plain(xb, w)),
        "K3-bf16 f32 storage": (
            lambda: cc.correlate_valid_bf16_cuda(x32, w),
            lambda: cc.correlate_valid_bf16_plain(x32, w)),
    }
    kerr = {k: ulp_check(a(), b(), f"{k} vs plain at the headline")
            for k, (a, b) in kern.items()}

    # f64 gradients through the bf16 routes against one cotangent: the
    # exact route's (the backward is the exact plain version), K1 / K2 / K3
    # launched once forward
    xg = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (24, 4099))).to(dev)
    fg = sgt.Savgol1D.create(sgt.deriv1(12, 4, dt=0.01), dtype=torch.float64,
                             device=dev)
    grad_err = 0.0
    for name, call in (("polynomial", lambda v, m: fg.apply(v, method=m)),
                       ("reflect", lambda v, m: fg.apply(v, boundary="reflect",
                                                         method=m)),
                       ("valid", lambda v, m: fg.apply_valid(v, method=m))):
        gs = []
        for method in ("bf16", "xla"):
            v = xg.clone().requires_grad_()
            before = sum(cc.LAUNCHES.values())
            y = call(v, method)
            require(method == "xla" or sum(cc.LAUNCHES.values()) == before + 1,
                    f"bf16 {name} gradient run: one launch forward")
            g = torch.randn(y.shape, dtype=y.dtype, device=dev,
                            generator=torch.Generator(device=dev).manual_seed(7))
            gs.append(torch.autograd.grad(y, v, g)[0])
        grad_err = max(grad_err, (gs[0] - gs[1]).abs().max().item())
    require(grad_err <= F64_TOL, f"bf16 backward vs exact: {grad_err:.3e}")

    samples = B_FULL * N_FULL
    t = {k: (device_ms(a), device_ms(b, warmup=1, reps=3))
         for k, (a, b) in kern.items()}
    t["Savgol1D.apply bf16"] = (cuda_time_ms(lambda: f.apply(
        xb, method="bf16")), float("nan"))
    x3 = xb.view(B_FULL, 1, N_FULL)
    w3 = cc.bf16_taps(w).to(torch.bfloat16).view(1, 1, -1)
    x4, w4 = (v.unsqueeze(2).contiguous(memory_format=torch.channels_last)
              for v in (x3, w3))
    lib = cudnn_ms(lambda: torch.nn.functional.conv1d(x3, w3),
                   lambda: torch.nn.functional.conv2d(x4, w4))
    del x4
    # K2-bf16's wrap and edge modes: one nn.Conv1d on bf16 with the same
    # bf16 taps, circular / replicate padding (symmetric has none)
    lib_pad = {}
    for mode, pm in (("wrap", "circular"), ("edge", "replicate")):
        conv = torch.nn.Conv1d(1, 1, 25, padding=12, padding_mode=pm,
                               bias=False, device=dev, dtype=torch.bfloat16)
        with torch.no_grad():
            conv.weight.copy_(w3)
            lib_pad[mode] = device_ms(lambda: conv(x3))
    b_bf = speed_of_light_1d((B_FULL, N_FULL), dtype="bfloat16",
                             method="bf16").fields
    b_f32 = speed_of_light_1d((B_FULL, N_FULL), method="bf16").fields
    b3 = speed_of_light_valid_1d((B_FULL, N_FULL), dtype="bfloat16",
                                 method="bf16").fields
    b3f = speed_of_light_valid_1d((B_FULL, N_FULL), method="bf16").fields
    print(f"bf16 1D slice ({B_FULL}, {N_FULL}) n=12 m=4: launches "
          + ", ".join(f"{k} {nz(v)}" for k, v in launches.items())
          + "; vs f64 scaled " + ", ".join(f"{k} {v:.3e}"
                                           for k, v in errs.items())
          + f" (contract {BF16_CONTRACT}); kernels vs plain at the headline "
          + ", ".join(f"{k} {v:.3e}" for k, v in kerr.items())
          + f" (one bf16 ulp); f64 gradients vs the exact route "
          f"{grad_err:.3e} (tol {F64_TOL})")
    print("library: F.conv1d on bf16 " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in lib.items())
          + " (channels_last: a (1, 25) F.conv2d); bounds bf16 storage "
          f"{b_bf['bound_ms']:.4f} ms ({b_bf['bound_by']}), f32 storage "
          f"{b_f32['bound_ms']:.4f} ms, K3-bf16 {b3['bound_ms']:.4f} ms "
          f"(f32 storage {b3f['bound_ms']:.4f}); "
          f"nn.Conv1d on bf16 circular {lib_pad['wrap']:.4f} ms, replicate "
          f"{lib_pad['edge']:.4f} ms [{card}]")
    for name, (k, p) in t.items():
        print(f"time {name} ({B_FULL}, {N_FULL}): kernel {k:.4f} ms = "
              f"{samples / k / 1e6:.2f} Gsamples/s; plain {p:.4f} ms "
              f"[{card}]")
    rec = {"route": "cuda", "library_ms": None}
    return [
        {"name": "sg1d_poly_bf16", **rec,
         "source": "savgol_tpu_torch/csrc/sg1d_poly.cu",
         "replaces": "savgol_tpu/ops/pallas_conv.py:659",
         "launches": launches["apply bf16"]["sg1d_poly"],
         "max_abs_err": kerr["K1-bf16"], "ms": t["K1-bf16"][0],
         "plain_ms": t["K1-bf16"][1], **b_bf,
         "f32_storage_ms": t["K1-bf16 f32 storage"][0],
         "f32_storage_bound_ms": b_f32["bound_ms"],
         "entry_ms": t["Savgol1D.apply bf16"][0]},
        {"name": "sg1d_pad_bf16", **rec,
         "source": "savgol_tpu_torch/csrc/sg1d_poly.cu",
         "replaces": "savgol_tpu/ops/pallas_conv.py:830",
         "launches": launches["apply reflect bf16"]["sg1d_pad"],
         "max_abs_err": kerr["K2-bf16 symmetric"],
         "ms": t["K2-bf16 symmetric"][0],
         "plain_ms": t["K2-bf16 symmetric"][1], **b_bf,
         "ms_by_mode": {m: t[f"K2-bf16 {m}"][0]
                        for m in ("symmetric", "wrap", "edge")},
         "library_wrap_ms": lib_pad["wrap"],
         "library_replicate_ms": lib_pad["edge"]},
        {"name": "corr1d_valid_bf16", **rec,
         "source": "savgol_tpu_torch/csrc/corr1d_valid.cu",
         "replaces": "savgol_tpu/ops/pallas_conv.py:1098",
         "launches": launches["apply_valid bf16"]["corr1d_valid"],
         "max_abs_err": kerr["K3-bf16"], "ms": t["K3-bf16"][0],
         "plain_ms": t["K3-bf16"][1], **b3, "library_ms": lib["best"],
         "library_default_ms": lib["default"],
         "f32_storage_ms": t["K3-bf16 f32 storage"][0],
         "f32_storage_bound_ms": b3f["bound_ms"]},
    ]


def bf16_slice_2d(sgt, dev, card) -> list:
    """The 2D headline in bf16: ``Savgol2D.apply`` on a bf16 and an f32
    batch and the Hessian stack (K = 3), each one launch in its own zeroed
    window, against float64 within the contract; K2D-dense-bf16 against its
    plain version at the headline; f64 gradients; times beside the bound
    and ``F.conv2d`` on bf16. Returns the records."""
    from savgol_tpu_torch.ops import cuda_conv as cc
    from savgol_tpu_torch.ops import cuda_conv2d as c2
    from savgol_tpu_torch.ops.weights import savgol2d_weights_np
    from savgol_tpu_torch.utils.timing import cuda_time_ms, cudnn_ms, device_ms

    cfg2 = sgt.Savgol2DConfig(5, 5, 3)
    f2 = sgt.Savgol2D.create(cfg2, device=dev)
    img32 = torch.from_numpy(np.random.default_rng(0).standard_normal(
        IMG_FULL, dtype=np.float32)).to(dev)
    imgb = img32.to(torch.bfloat16)
    w64 = torch.from_numpy(savgol2d_weights_np(cfg2, np.float64)).to(dev)
    sub = [0, IMG_FULL[0] - 1]
    errs, launches = {}, {}
    for name, inp in (("apply bf16", imgb), ("apply f32", img32)):
        y, launches[name] = counted_all(lambda: f2.apply(inp, method="bf16"),
                                        {"corr2d_valid": 1},
                                        f"Savgol2D.apply {name}")
        require(y.dtype == inp.dtype and y.shape == inp.shape
                and bool(torch.isfinite(y).all()), f"2D {name} output")
        errs[name] = _contract(y[sub], c2.correlate2d_valid_plain(
            inp[sub].double(), w64, "edge"), f"Savgol2D.apply {name}")
        del y
    hess, launches["hessian bf16"] = counted_all(
        lambda: sgt.savgol2d_hessian(imgb, 5, 5, 3, method="bf16"),
        {"corr2d_valid": 1}, "savgol2d_hessian(method='bf16')")
    want = sgt.savgol2d_hessian(imgb[sub].double(), 5, 5, 3, method="xla")
    errs["hessian bf16"] = max(_contract(h[sub], r, "savgol2d_hessian bf16")
                               for h, r in zip(hess, want))
    del hess, want
    w2 = f2.weights
    w3 = torch.from_numpy(np.stack([savgol2d_weights_np(
        sgt.Savgol2DConfig(5, 5, 3, deriv_x=dx, deriv_y=dy), np.float64)
        for dx, dy in ((2, 0), (1, 1), (0, 2))])).to(dev, torch.float32)
    kern = {
        "K2D-dense-bf16": (
            lambda: c2.correlate2d_valid_bf16_cuda(imgb, w2, "edge"),
            lambda: c2.correlate2d_valid_bf16_plain(imgb, w2, "edge")),
        "K2D-dense-bf16 f32 storage": (
            lambda: c2.correlate2d_valid_bf16_cuda(img32, w2, "edge"),
            lambda: c2.correlate2d_valid_bf16_plain(img32, w2, "edge")),
        "K2D-dense-bf16 K=3": (
            lambda: c2.correlate2d_valid_bf16_cuda(imgb, w3, "edge"),
            lambda: c2.correlate2d_valid_bf16_plain(imgb, w3, "edge")),
    }
    kerr = {}
    for k, (a, b) in kern.items():
        kerr[k] = (f32_check(a(), b(), k) if "f32" in k
                   else ulp_check(a(), b(), f"{k} vs plain at the headline"))

    # f64 gradients through the bf16 route, image and stencil
    xg = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 256, 320))).to(dev)
    fg = sgt.Savgol2D.create(sgt.Savgol2DConfig(5, 5, 3, deriv_x=1,
                                                delta_x=0.5),
                             dtype=torch.float64, device=dev)
    g = torch.randn_like(xg)
    gs = []
    for method in ("bf16", "xla"):
        v = xg.clone().requires_grad_()
        fg.weights.requires_grad_()
        before = c2.LAUNCHES["corr2d_valid"]
        gs.append(torch.autograd.grad(fg.apply(v, boundary="reflect",
                                               method=method), [v, fg.weights],
                                      g))
        require(method == "xla" or c2.LAUNCHES["corr2d_valid"] == before + 1,
                "2D bf16 gradient run: one K2D-dense launch forward")
    grad_err = max((a - b).abs().max().item() for a, b in zip(*gs))
    require(grad_err <= F64_TOL, f"2D bf16 backward vs exact: {grad_err:.3e}")

    pix = img32.numel()
    t = {k: (device_ms(a), device_ms(b, warmup=1, reps=3))
         for k, (a, b) in kern.items()}
    t["Savgol2D.apply bf16"] = (cuda_time_ms(lambda: f2.apply(
        imgb, method="bf16")), float("nan"))
    img4 = imgb.unsqueeze(1)
    wb = cc.bf16_taps(w2).to(torch.bfloat16).view(1, 1, 11, 11)
    wb3 = cc.bf16_taps(w3).to(torch.bfloat16).view(3, 1, 11, 11)
    cl = torch.channels_last
    img4c, wbc, wb3c = (v.contiguous(memory_format=cl)
                        for v in (img4, wb, wb3))
    conv = torch.nn.functional.conv2d
    lib = cudnn_ms(lambda: conv(img4, wb, padding=5),
                   lambda: conv(img4c, wbc, padding=5))
    lib3 = cudnn_ms(lambda: conv(img4, wb3, padding=5),
                    lambda: conv(img4c, wb3c, padding=5))
    del img4c
    # the FMAs at the bf16 tensor-core peak bound the function; the same
    # FMAs at the f32 peak of the CUDA cores, which the exact K2D-dense runs
    # on (the bf16 mode runs on the tensor cores), are kept beside it as
    # cuda_core_ms
    b_bf = speed_of_light_2d(11, shape=IMG_FULL, dtype="bfloat16",
                             method="bf16").fields
    b_f32 = speed_of_light_2d(11, shape=IMG_FULL, method="bf16").fields
    b_k3 = speed_of_light_bank_2d(11, 3, shape=IMG_FULL, dtype="bfloat16",
                                  method="bf16").fields
    core = {"cuda_core_ms": speed_of_light_2d(
        11, shape=IMG_FULL, dtype="bfloat16").ops_bound_s * 1e3}
    core3 = {"cuda_core_ms": speed_of_light_bank_2d(
        11, 3, shape=IMG_FULL, dtype="bfloat16").ops_bound_s * 1e3}
    print(f"bf16 2D slice {IMG_FULL} 11x11 order 3 CONSTANT: launches "
          + ", ".join(f"{k} {nz(v)}" for k, v in launches.items())
          + "; vs f64 scaled " + ", ".join(f"{k} {v:.3e}"
                                           for k, v in errs.items())
          + f" (contract {BF16_CONTRACT}); kernels vs plain "
          + ", ".join(f"{k} {v:.3e}" for k, v in kerr.items())
          + f"; f64 gradients vs the exact route {grad_err:.3e}")
    print("library: F.conv2d on bf16 (zero padding) " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in lib.items()) + "; 3 output channels "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in lib3.items())
          + f"; bounds bf16 storage {b_bf['bound_ms']:.4f} ms "
          f"({b_bf['bound_by']}), f32 storage {b_f32['bound_ms']:.4f} ms "
          f"({b_f32['bound_by']}), K=3 {b_k3['bound_ms']:.4f} ms "
          f"({b_k3['bound_by']}); the FMAs on CUDA cores "
          f"{core['cuda_core_ms']:.4f} ms, K=3 {core3['cuda_core_ms']:.4f} "
          f"ms [{card}]")
    for name, (k, p) in t.items():
        print(f"time {name} {IMG_FULL} 11x11: kernel {k:.4f} ms = "
              f"{pix / k / 1e6:.2f} Gpix/s; plain {p:.4f} ms [{card}]")
    rec = {"route": "cuda",
           "source": "savgol_tpu_torch/csrc/corr2d_bf16_mma.cu"}
    return [
        {"name": "corr2d_valid_bf16", **rec,
         "replaces": "savgol_tpu/ops/pallas_conv.py:1547",
         "launches": launches["apply bf16"]["corr2d_valid"],
         "max_abs_err": kerr["K2D-dense-bf16"], "ms": t["K2D-dense-bf16"][0],
         "plain_ms": t["K2D-dense-bf16"][1], **b_bf, **core,
         "library_ms": lib["best"], "library_default_ms": lib["default"],
         "f32_storage_ms": t["K2D-dense-bf16 f32 storage"][0],
         "f32_storage_bound_ms": b_f32["bound_ms"],
         "entry_ms": t["Savgol2D.apply bf16"][0]},
        {"name": "corr2d_valid_bf16_stack", **rec,
         "replaces": "savgol_tpu/ops/pallas_conv.py:1716",
         "launches": launches["hessian bf16"]["corr2d_valid"],
         "max_abs_err": kerr["K2D-dense-bf16 K=3"],
         "ms": t["K2D-dense-bf16 K=3"][0],
         "plain_ms": t["K2D-dense-bf16 K=3"][1], **b_k3, **core3,
         "library_ms": lib3["best"], "library_default_ms": lib3["default"]},
    ]


def bf16_scipy(dev) -> str:
    """``scipy_compat.savgol_filter(..., method="bf16")`` on a numpy batch
    in all five modes, each one launch, within the contract of scipy."""
    from scipy.signal import savgol_filter as sp_filter

    from savgol_tpu_torch import scipy_compat as tsc
    rows = np.random.default_rng(6).standard_normal(
        (16, N_FULL)).astype(np.float32)
    errs = {}
    for mode in SCIPY_MODES:
        got, _ = counted_all(
            lambda: tsc.savgol_filter(rows, 25, 4, mode=mode, cval=0.5,
                                      method="bf16", device=dev),
            SCIPY_BF16_LAUNCHES[mode], f"savgol_filter(bf16, {mode})")
        require(isinstance(got, np.ndarray), "numpy in, numpy out")
        ref = sp_filter(rows.astype(np.float64), 25, 4, mode=mode, cval=0.5)
        errs[mode] = _contract(torch.from_numpy(got), torch.from_numpy(ref),
                               f"savgol_filter bf16 {mode}")
    return (f"bf16 scipy_compat (16, {N_FULL}) numpy, window 25 order 4: vs "
            f"scipy scaled " + ", ".join(f"{k} {v:.3e}"
                                         for k, v in errs.items())
            + f" (contract {BF16_CONTRACT}), one launch each")


def rank_sharded_bf16(dev_type: str = "cuda", shape1d=(B_FULL, N_FULL),
                      shape2d=IMG_FULL):
    """``method="bf16"`` sharded 4 ways with ``halo="rdma"``: the 1D
    headline (K13, then K3-bf16) and the 2D headline by rows (K13, then
    K2D-dense-bf16), launches, the contract against float64, the
    single-device bf16 apply (1D within one bf16 ulp away from the outer n
    samples, whose edge rows the sharded route fits exactly; 2D f32 sums
    within 2e-6 scaled), times."""
    import savgol_tpu_torch as sgt
    from savgol_tpu_torch.ops import cuda_conv as cc
    from savgol_tpu_torch.ops import cuda_conv2d as c2
    from savgol_tpu_torch.ops.weights import (savgol2d_weights_np,
                                              savgol_weights_np)
    from savgol_tpu_torch.parallel import apply2d_sharded, apply_sharded, shard
    from savgol_tpu_torch.parallel.sharded import mesh_axis

    dev = torch.device(dev_type)
    m = _rank_mesh(("batch", "seq"), (1, RING), dev)
    _, idx, _ = mesh_axis(m, "seq")
    x = torch.randn(shape1d, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0))
    xl = shard(x, m, (None, "seq"))
    L = xl.shape[-1]
    cols = slice(idx * L, (idx + 1) * L)
    cfg = sgt.SavgolConfig(12, 4)
    f = sgt.Savgol1D.create(cfg, device=dev)
    kw = dict(half_window=12, mesh=m, dt_inv=f.dt_inv, halo="rdma",
              method="bf16")
    args = (xl, f.center_weights, f.edge_weights)
    y, l1 = _rank_counted(dev, lambda: apply_sharded(*args, **kw),
                          {"halo_send": 1, "halo_recv": 1,
                           "corr1d_valid": 1},
                          "apply_sharded(method='bf16')")
    c64, e64 = (torch.from_numpy(a).to(dev)
                for a in savgol_weights_np(cfg, np.float64))
    rows = [0, 1, shape1d[0] // 2, shape1d[0] - 1]
    e1 = _contract(y[rows], cc.savgol_polynomial_plain(
        x[rows].double(), c64, e64, 12)[:, cols], "sharded bf16 1D")
    lo = 12 if idx == 0 else 0
    hi = L - (12 if idx == RING - 1 else 0)
    single = f.apply(x, method="bf16")[:, cols]
    u1 = ulp_check(y[:, lo:hi], single[:, lo:hi],
                   "sharded bf16 1D vs single-device bf16")
    del single, y
    img = torch.randn(shape2d, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(1))
    f2 = sgt.Savgol2D.create(sgt.Savgol2DConfig(5, 5, 3), device=dev)
    il = shard(img, m, (None, "seq", None))
    R = il.shape[-2]
    kw2 = dict(mesh=m, boundary="constant", scale=f2.scale, method="bf16",
               halo="rdma" if dev.type == "cuda" else "ppermute")
    y2, l2 = _rank_counted(dev, lambda: apply2d_sharded(il, f2.weights,
                                                        **kw2),
                           {"halo_send": 1, "halo_recv": 1,
                            "corr2d_valid": 1},
                           "apply2d_sharded(method='bf16')")
    w64 = torch.from_numpy(savgol2d_weights_np(
        sgt.Savgol2DConfig(5, 5, 3), np.float64)).to(dev)
    rr = slice(idx * R, (idx + 1) * R)
    e2 = _contract(y2[:1], c2.correlate2d_valid_plain(
        img[:1].double(), w64, "edge")[:, rr], "sharded bf16 2D")
    s2 = f32_check(y2, f2.apply(img, method="bf16")[:, rr],
                   "sharded bf16 2D vs single-device bf16", F32_TOL_2D)
    t = {"1D": _time(dev, lambda: apply_sharded(*args, **kw)),
         "2D rows": _time(dev, lambda: apply2d_sharded(il, f2.weights,
                                                       **kw2))}
    return {"rank": idx, "launches": (l1, l2), "errs": (e1, u1, e2, s2),
            "t": t}


def probes_phase(dev, card) -> list:
    """P3 at the 1D headline (bf16, 25 taps) and P2 at the 2D headline
    (bf16, 11 x 11, CONSTANT): each variant once in its own zeroed window
    (one launch) against its plain version on the whole batch (P3's
    ``copy`` and ``shift_only`` bit for bit, ``taps_only`` and P2 within one
    bf16 ulp), then ``measure`` (the same checks, times, bounds, library
    calls, and the device operations of one ``apply_valid(method="bf16")``
    call). Prints each variant beside K3-bf16 / K6a-bf16 and the split of
    their times. Returns the probes' records."""
    import savgol_tpu_torch as sgt
    from savgol_tpu_torch.ops.weights import (savgol2d_weights_np,
                                              savgol_weights_np)
    from savgol_tpu_torch.probes import bf16_1d as p3
    from savgol_tpu_torch.probes import rowband2d as p2

    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(B_FULL, N_FULL, generator=g, device=dev).to(torch.bfloat16)
    w = torch.from_numpy(savgol_weights_np(sgt.SavgolConfig(12, 4), np.float64)[0]
                         ).to(dev)
    l3 = {}
    for v in p3.VARIANTS:
        got, l3[v] = counted_all(lambda: p3.probe_cuda(x, w, v),
                                 {"probe_bf16_1d": 1}, f"P3 {v}")
        want = p3.probe_plain(x, w, v)
        if v == "taps_only":
            ulp_check(got, want, f"P3 {v}")
        else:
            require(torch.equal(got, want), f"P3 {v}: not bit-equal to its "
                    "plain version")
        del got, want
    r3 = p3.measure(x, w)
    del x
    img = torch.randn(IMG_FULL, generator=g, device=dev).to(torch.bfloat16)
    w2 = torch.from_numpy(savgol2d_weights_np(sgt.Savgol2DConfig(5, 5, 3),
                                              np.float64)).to(dev)
    want2 = {"A_lib": {"corr2d_valid": 1}, "B_alignctl": {"probe_rowband2d": 1},
             "C_wh1": {"corr2d_valid": 1}}
    l2 = {}
    for v, want in want2.items():
        got, counts = counted_all(lambda: p2.variant_cuda(v, img, w2, "edge"),
                                  want, f"P2 {v}")
        l2[v] = sum(counts.values())
        ulp_check(got, p2.variant_plain(v, img, w2, "edge"), f"P2 {v}")
        del got
    r2 = p2.measure(img, w2, "edge")
    for r in r3 + r2:
        print(f"time probe {r['name']}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), vs plain {r['max_abs_err']:.3e}"
              + (f", library {r['library_ms']:.4f} ms"
                 if r["library_ms"] is not None else "") + f" [{card}]")
    t3 = {r["name"]: r["ms"] for r in r3}
    t2 = {r["name"]: r["ms"] for r in r2}
    print(f"P3 split of K3-bf16 {t3['K3-bf16']:.4f} ms (bound "
          f"{r3[-1]['bound_ms']:.4f}): copy {t3['copy']:.4f} (the ring's "
          f"floor, {r3[0]['bound_ms'] / t3['copy']:.1%} of its bound), halo "
          f"and shifted stores {t3['shift_only'] - t3['copy']:+.4f}, products "
          f"and round trip {t3['taps_only'] - t3['shift_only']:+.4f}, halo "
          f"loads {t3['K3-bf16'] - t3['taps_only']:+.4f}; P2 input-side "
          f"shift (B_alignctl - A_lib) {t2['B_alignctl'] - t2['A_lib']:+.4f}"
          f" of K6a-bf16 {t2['A_lib']:.4f}, one stencil row (C_wh1) "
          f"{t2['C_wh1']:.4f} [{card}]")
    p3_lines = {"copy": 152, "shift_only": 135, "taps_only": 119}
    out = []
    for r in r3:
        if r["name"] not in p3_lines:
            continue                 # K3-bf16, timed beside the variants
        out.append({**r, "name": f"probe_bf16_1d {r['name']}",
                    "route": "cuda",
                    "source": "savgol_tpu_torch/csrc/probe_bf16_1d.cu",
                    "replaces": f"benchmarks/probe_bf16_1d.py:"
                                f"{p3_lines[r['name']]}",
                    "launches": l3[r["name"]]["probe_bf16_1d"],
                    "k3_ms": t3["K3-bf16"]})
    for r in r2:
        out.append({**r, "name": f"probe_rowband2d {r['name']}",
                    "route": "cuda",
                    "source": "savgol_tpu_torch/csrc/corr2d_bf16_mma.cu",
                    "replaces": "benchmarks/probe_rowmxu.py:101",
                    "launches": l2[r["name"]], "k6a_ms": t2["A_lib"]})
    return out



# -- P1 and streaming ---------------------------------------------------------

# the JAX probe's correctness geometries (B, N, ws, cols), rows 8
# (benchmarks/probe_dma1d.py:214-215)
P1_JAX_GEOMS = ((16, 4096, 25, 2048), (8, 5000, 25, 2048),
                (16, 4333, 13, 1024), (8, 2100, 25, 1024))
P1_N_OUT = 1 << 20             # the JAX bench: N = n_out + 128, aligned
STREAM_T = 8192                # bench.py:713-716
CHUNKS = ((64, 8192), (64, 65_536))   # run_benchmarks.py:146-150, README:347


def p1_grid(dev) -> str:
    """P1 against its plain version and bit for bit against K3 over the JAX
    probe's geometries and ws in {3, 25, 65} x N of each residue mod 4 x
    n_out full and shorter, one launch a call."""
    from savgol_tpu_torch.ops import cuda_conv as cc
    from savgol_tpu_torch.probes import dma1d

    rng = np.random.default_rng(36)
    cases = [(B, N, ws, cols, 8) for B, N, ws, cols in P1_JAX_GEOMS]
    cases += [(12, 4096 + r, ws, cols, 4) for r in range(4)
              for ws in (3, 25, 65, 101) for cols in (1024, 2048)]
    worst, count = 0.0, 0
    for i, (B, N, ws, cols, rows) in enumerate(cases):
        # every fourth case on rows whose first sample is 1-3 elements past
        # a 16-byte boundary
        base = i % 4
        flat = torch.from_numpy(rng.standard_normal(B * N + 3)).to(
            dev, torch.float32)
        x = flat[base:base + B * N].view(B, N)
        w = torch.from_numpy(rng.standard_normal(ws)).to(dev, torch.float32)
        for short in (0, 333):
            n_out = N - ws + 1 - short
            got, _ = counted_all(
                lambda: dma1d.corr1d_dma_cuda(x, w, rows=rows, cols=cols,
                                              n_out=n_out),
                {"corr1d_dma": 1}, f"P1 B={B} N={N} ws={ws}")
            want = dma1d.corr1d_dma_plain(x, w, rows=rows, cols=cols,
                                          n_out=n_out)
            e, sc = max_err(got, want)
            require(e <= F32_TOL * sc, f"P1 B={B} N={N} ws={ws} cols={cols} "
                    f"n_out={n_out}: {e:.3e} from plain")
            require(torch.equal(got, cc.correlate_valid_cuda(x, w)[:, :n_out]),
                    f"P1 B={B} N={N} ws={ws} cols={cols} n_out={n_out}: not "
                    f"bit-equal to K3")
            worst = max(worst, e / sc)
            count += 1
    return (f"P1 grid: {count} cases (the JAX probe's 4 geometries; ws 3, 25, "
            f"65, 101 x N mod 4 = 0..3 x cols 1024, 2048; n_out full and "
            f"-333; row offsets 0-3), "
            f"worst scaled error vs plain {worst:.3e} (tol {F32_TOL}), all "
            f"bit-equal to K3, 1 launch each")


def p1_headline(dev, card) -> dict:
    """P1 at the JAX bench's geometry (128 x (2^20 + 128) float32, n_out =
    2^20, 25 taps) with its (rows, cols) variants, (256, 2048) at B = 256,
    and N = 2^20 + 173, each held to its plain version and K3 and timed
    beside K3, F.conv1d and the bound. Returns P1's kernel record."""
    import savgol_tpu_torch as sgt
    from savgol_tpu_torch.ops.weights import savgol_weights_np
    from savgol_tpu_torch.probes import dma1d

    g = torch.Generator(device=dev).manual_seed(37)
    w = torch.from_numpy(savgol_weights_np(sgt.SavgolConfig(12, 4),
                                           np.float64)[0]).to(dev,
                                                              torch.float32)
    x = torch.randn(B_FULL, P1_N_OUT + 128, generator=g, device=dev)
    _, got = counted_all(lambda: dma1d.corr1d_dma_cuda(
        x, w, rows=128, cols=2048, n_out=P1_N_OUT), {"corr1d_dma": 1},
        "P1 headline")
    recs = dma1d.measure(x, w, P1_N_OUT, [(r, c) for r, c, b in
                                          dma1d.GEOMETRIES if b == B_FULL])
    del x
    x = torch.randn(2 * B_FULL, P1_N_OUT + 128, generator=g, device=dev)
    recs += dma1d.measure(x, w, P1_N_OUT, [(256, 2048)])
    del x
    x = torch.randn(B_FULL, P1_N_OUT + 173, generator=g, device=dev)
    recs += dma1d.measure(x, w, P1_N_OUT, [(128, 2048)])
    del x
    for r in recs:
        print(f"time P1 rows={r['rows']} cols={r['cols']} ({r['B']}, "
              f"{r['N']}) n_out={r['n_out']}: kernel {r['ms']:.4f} ms, K3 "
              f"{r['k3_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), F.conv1d (TF32 "
              f"off) {r['library_ms']:.4f} ms; vs plain "
              f"{r['max_abs_err']:.3e}, bit-equal to K3 [{card}]")
    head = recs[0]
    return {"name": "corr1d_dma", "route": "cuda",
            "source": "savgol_tpu_torch/csrc/probe_dma1d.cu",
            "replaces": "benchmarks/probe_dma1d.py:185",
            "launches": got["corr1d_dma"],
            **{k: head[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms",
                                    "k3_ms")},
            "variants": [{k: r[k] for k in ("rows", "cols", "B", "N", "ms",
                                            "k3_ms", "bound_ms")}
                         for r in recs]}


def _resumed(state, run, tail):
    """``run(state, tail)``'s emissions against the same run on ``state``
    after torch.save / torch.load, bit for bit."""
    import io
    buf = io.BytesIO()
    torch.save(state, buf)
    buf.seek(0)
    back = torch.load(buf, weights_only=False)
    require(type(back) is type(state), "checkpoint type")
    require(back[0].device == state[0].device, "checkpoint device")
    require(torch.equal(run(state, tail), run(back, tail)),
            f"{type(state).__name__} resumed differently after torch.save")


def stream_phase(dev, card) -> str:
    """Streaming on the card at the JAX benchmarks' sizes, SavgolConfig(12,
    4): the push protocol over 8,192 samples in f32 and f64 against
    Savgol1D.apply (conservation, no module kernel a push) and its host time
    a push; ``stream_apply`` over 8,192 samples (one K3 launch) against
    float64; 64 chunks of 8,192 and of 65,536 samples (one K3 launch a
    chunk) against the batch apply, with throughput; checkpoints of both
    states resumed bit for bit."""
    import savgol_tpu_torch as sgt
    from savgol_tpu_torch import stream as ts
    from savgol_tpu_torch.ops import cuda_conv as cc
    from savgol_tpu_torch.ops.weights import savgol_weights_np
    from savgol_tpu_torch.utils.timing import cuda_time_ms, host_ms

    cfg = sgt.SavgolConfig(12, 4)
    n = cfg.half_window
    rng = np.random.default_rng(38)
    x_np = rng.standard_normal(STREAM_T)
    parts = []
    for dtype, tol in ((torch.float32, F32_TOL), (torch.float64, 1e-10)):
        s = sgt.SavgolStream(cfg, dtype, device=dev)
        x = torch.from_numpy(x_np).to(dev, dtype)
        vals = x_np.astype(np.float32 if dtype == torch.float32 else
                           np.float64).tolist()
        t0 = time.perf_counter()
        outs, _ = counted_all(
            lambda: [s.push_full(v) for v in vals] + [s.flush()], {},
            f"push_full {dtype}")
        wall = time.perf_counter() - t0
        y = torch.cat(outs)
        require(y.numel() == STREAM_T == s.samples_output,
                f"push {dtype}: {y.numel()} outputs for {STREAM_T} inputs")
        e, sc = max_err(y, s.filter.apply(x))
        require(e <= tol * sc, f"push {dtype} vs Savgol1D.apply: {e:.3e}")
        hot = sgt.SavgolStream(cfg, dtype, device=dev)
        for v in vals[:2 * n + 1]:
            hot.push_full(v)
        push = host_ms(lambda: hot.push_full(0.5), warmup=10, reps=100)
        parts.append(f"{dtype}: {STREAM_T} pushes in {wall:.2f} s, vs apply "
                     f"{e:.3e} (tol {tol} x {sc:.2f}), host {push:.4f} ms a "
                     f"push_full")

    # stream_apply: one K3 launch, against float64
    f = sgt.Savgol1D.create(cfg, device=dev)
    x = torch.from_numpy(x_np).to(dev, torch.float32)

    def apply():
        return ts.stream_apply(x, f.center_weights, f.edge_weights,
                               half_window=n, dt_inv=f.dt_inv)

    y, _ = counted_all(apply, {"corr1d_valid": 1}, "stream_apply")
    c64, e64 = (torch.from_numpy(a).to(dev)
                for a in savgol_weights_np(cfg, np.float64))
    ref = cc.savgol_polynomial_plain(x.double()[None], c64, e64, n)[0]
    e_apply = (y.double() - ref).abs().max().item()
    require(y.shape == x.shape and e_apply <= GATE_ABS,
            f"stream_apply vs f64: {e_apply:.3e}")
    parts.append(f"stream_apply ({STREAM_T},) f32: 1 corr1d_valid, vs f64 "
                 f"{e_apply:.3e} (gate {GATE_ABS}), "
                 f"{cuda_time_ms(apply):.4f} ms device, "
                 f"{host_ms(apply, reps=100):.4f} ms host")

    # chunked: 64 chunks of C samples, one K3 launch a chunk
    cw, ew, dt = f.center_weights, f.edge_weights, f.dt_inv
    for k, C in CHUNKS:
        chunks = torch.from_numpy(rng.standard_normal((k, C))).to(
            dev, torch.float32)

        def run(st, chs):
            outs = []
            for ch in chs:
                st, o, c = ts.stream_process_chunk(st, ch, cw, ew, dt)
                outs.append(o[:c])
            return st, outs

        st0 = ts.chunk_init(n, device=dev)
        (st, outs), _ = counted_all(lambda: run(st0, chunks),
                                    {"corr1d_valid": k},
                                    f"{k} chunks of {C}")
        counted_all(lambda: run(st0, chunks[:1]), {"corr1d_valid": 1},
                    "one chunk")
        got = torch.cat(outs)
        flat = chunks.reshape(-1)
        require(got.numel() == flat.numel() - n,
                f"chunks of {C}: {got.numel()} outputs before the flush")
        want = f.apply(flat)
        e_chunk = (got - want[:flat.numel() - n]).abs().max().item()
        require(e_chunk <= 1e-5, f"chunks of {C} vs batch: {e_chunk:.3e}")
        _, tail, c = ts.stream_flush_chunked(st, ew, dt)
        e_tail = (tail[:c] - want[-n:]).abs().max().item()
        require(c == n and e_tail <= 1e-5, f"chunked flush: {e_tail:.3e}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(st0, chunks)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        parts.append(f"{k} chunks of {C}: 1 corr1d_valid a chunk, vs batch "
                     f"{e_chunk:.3e} (gate 1e-5), "
                     f"{k * C / sec / 1e6:.1f} Msamples/s, "
                     f"{sec / k * 1e3:.4f} ms a chunk")

    # checkpoints on the card, mid-stream
    st = ts.stream_init(n, device=dev)
    for v in x_np[:100].tolist():
        st, _, _ = ts.stream_push_full(st, v, cw, ew, dt)

    def pushes(state, vals):
        outs = []
        for v in vals:
            state, o, c = ts.stream_push_full(state, v, cw, ew, dt)
            outs.append(o[:c])
        return torch.cat(outs)

    _resumed(st, pushes, x_np[100:150].tolist())
    cs, _ = run(ts.chunk_init(n, device=dev), chunks[:3])
    _resumed(cs, lambda state, chs: torch.cat(run(state, chs)[1]),
             chunks[3:6])
    parts.append("StreamState and ChunkState resumed bit for bit after "
                 "torch.save / torch.load on the card")
    return "stream: " + "; ".join(parts) + f" [{card}]"

# phase 39, the host-side modules: the on-device weight generators at (n, m,
# d) and (nx, ny, order, dx, dy); the last 2D geometry in f64 only, as
# tests/test_weights.py:308-313 runs it (its f32 normal matrix is too
# ill-conditioned); (5, 1, 3) is degenerate (y^3 == y on {-1, 0, 1})
W1D = ((2, 2, 0), (12, 4, 0), (12, 4, 1), (12, 4, 2), (32, 10, 4))
W2D = ((5, 5, 3, 0, 0), (4, 3, 3, 1, 1), (8, 8, 4, 0, 1), (3, 3, 2, 0, 0))
W2D_F64_ONLY = ((16, 16, 6, 1, 0),)
W2D_DEGENERATE = (5, 1, 3)
# gates against the host f64 tables: tests/test_weights.py:230-235 (f32 1D
# center 2e-6, edges 2e-5), f64 1e-12; 2D f32 1e-5 and f64 1e-9, both
# scaled by the table's largest weight
W1D_CENTER_F32, W1D_EDGE_F32, W2D_F32, W2D_F64 = 2e-6, 2e-5, 1e-5, 1e-9
NATIVE_ROWS = 8                # the headline's rows the host engine filters
STREAM_TRACED = 65_536         # the stream chunk traced (CHUNKS' larger)


def tf32_bit_equal(make, what: str) -> None:
    """make() again with TF32 allowed for matmuls: every tensor the same
    bits (the generators form their sums without matmul)."""
    base = make()
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        again = make()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag
    for key, b in base.items():
        for u, v in zip(b if isinstance(b, tuple) else (b,),
                        again[key] if isinstance(b, tuple) else (again[key],)):
            require(torch.equal(u, v), f"{what} {key}: TF32 changed bits")


def idle_share(ev: list) -> tuple[float, list, float]:
    """From a ``profiling.trace``'s events holding calls under
    ``record_function("traced call")`` (which ends after a synchronise):
    the share of that window in which the card ran nothing, the names of
    the kernels launched in it, and the window in ms. The window runs from
    the first call's start on the host to the synchronise's end; the card
    is busy in the union of the kernel, memcpy and memset events launched
    in it (``profiling.device_events``, matched by launch)."""
    from savgol_tpu_torch.utils.profiling import device_events

    call = next(e for e in ev if e.get("name") == "traced call"
                and e.get("cat") == "user_annotation")
    t0, t1 = call["ts"], call["ts"] + call["dur"]
    ops = device_events(ev, (t0, t1))
    busy, end = 0.0, t0
    for e in ops:
        a, b = max(e["ts"], t0, end), min(e["ts"] + e["dur"], t1)
        if b > a:
            busy, end = busy + b - a, b
    kernels = [e["name"] for e in ops if e["cat"] == "kernel"]
    return 1.0 - busy / (t1 - t0), kernels, (t1 - t0) / 1e3


def host_modules_phase(sgt, dev, card) -> dict:
    """Phase 39, the modules with no kernel of their own on the card: (a)
    ``savgol_weights`` in f32 and f64 against the host f64 tables, and bit
    for bit with TF32 allowed; (b) ``Savgol1D.create_on_device(...).apply``
    at the 1D headline, one K1 launch, against the f64 apply of the same
    weights, timed beside ``create(...).apply``; (c) ``savgol2d_weights``
    likewise, and a degenerate geometry raising before any tensor is made;
    (d) the host engine (``savgol_tpu_torch.native``) against the card's
    ``Savgol1D`` / ``Savgol2D`` at the headlines; (e) ``benchmark_chained``
    on ``Savgol1D.apply`` at the headline beside K1's device time, and the
    device idle share of one headline apply and of one stream chunk, and of
    20 of each back to back, from ``profiling.trace``."""
    import os
    import tempfile
    from savgol_tpu_torch import _build, native
    from savgol_tpu_torch import stream as ts
    from savgol_tpu_torch.ops import cuda_conv as cc
    from savgol_tpu_torch.ops import weights as tw
    from savgol_tpu_torch.utils import profiling
    from savgol_tpu_torch.utils.timing import cuda_time_ms, device_ms

    parts = []
    dtypes = (torch.float32, torch.float64)

    # (a) 1D weights on the card
    def weights_1d():
        return {(cfg, dt): tw.savgol_weights(*cfg, dt, device=dev)
                for cfg in W1D for dt in dtypes}

    worst = dict.fromkeys(dtypes, 0.0)
    for (cfg, dt), (c, e) in weights_1d().items():
        ch, eh = (torch.from_numpy(a) for a in tw.savgol_weights_np(
            sgt.SavgolConfig(*cfg), np.float64))
        ec = (c.cpu().double() - ch).abs().max().item()
        ee = (e.cpu().double() - eh).abs().max().item()
        tc, te = ((F64_TOL, F64_TOL) if dt == torch.float64
                  else (W1D_CENTER_F32, W1D_EDGE_F32))
        require(c.is_cuda and c.dtype == dt and e.shape == eh.shape
                and ec <= tc and ee <= te,
                f"savgol_weights{cfg} {dt}: center {ec:.3e}, edges {ee:.3e}")
        worst[dt] = max(worst[dt], ec, ee)
    tf32_bit_equal(weights_1d, "savgol_weights")
    parts.append(f"(a) savgol_weights {len(W1D)} configs vs host f64: f32 "
                 f"{worst[torch.float32]:.3e} (gates {W1D_CENTER_F32} / "
                 f"{W1D_EDGE_F32}), f64 {worst[torch.float64]:.3e} (gate "
                 f"{F64_TOL}); bit-equal with TF32 allowed")

    # (b) create_on_device at the 1D headline: one K1 launch
    cfg = sgt.SavgolConfig(12, 4)
    f_dev = sgt.Savgol1D.create_on_device(cfg, device=dev)
    f_host = sgt.Savgol1D.create(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(39)
    x = torch.randn(B_FULL, N_FULL, generator=gen, device=dev)
    y, got = counted_all(lambda: f_dev.apply(x), {"sg1d_poly": 1},
                         "Savgol1D.create_on_device(...).apply")
    launches = got["sg1d_poly"]
    f64 = sgt.Savgol1D(cfg, f_dev.center_weights.double(),
                       f_dev.edge_weights.double(), f_dev.dt_inv.double())
    e_dev = (y.double() - f64.apply(x.double())).abs().max().item()
    require(y.shape == x.shape and bool(torch.isfinite(y).all())
            and e_dev <= GATE_ABS,
            f"create_on_device apply vs f64 of its weights: {e_dev:.3e}")
    del y
    t_dev = cuda_time_ms(lambda: f_dev.apply(x))
    t_host = cuda_time_ms(lambda: f_host.apply(x))
    parts.append(f"(b) Savgol1D.create_on_device(SavgolConfig(12, 4)).apply "
                 f"({B_FULL}, {N_FULL}) f32: {launches} sg1d_poly, vs "
                 f"the f64 apply of its weights {e_dev:.3e} (gate "
                 f"{GATE_ABS}), {t_dev:.4f} ms; create(...).apply "
                 f"{t_host:.4f} ms")

    # (c) 2D weights on the card
    def weights_2d():
        return {(g, dt): tw.savgol2d_weights(*g, dtype=dt, device=dev)
                for g in W2D + W2D_F64_ONLY for dt in dtypes
                if dt == torch.float64 or g not in W2D_F64_ONLY}

    worst = dict.fromkeys(dtypes, 0.0)
    for (g, dt), w in weights_2d().items():
        wh = torch.from_numpy(tw.savgol2d_weights_np(
            sgt.Savgol2DConfig(*g), np.float64))
        e = (w.cpu().double() - wh).abs().max().item() / wh.abs().max().item()
        tol = W2D_F64 if dt == torch.float64 else W2D_F32
        require(w.is_cuda and w.shape == wh.shape and e <= tol,
                f"savgol2d_weights{g} {dt}: {e:.3e} scaled")
        worst[dt] = max(worst[dt], e)
    tf32_bit_equal(weights_2d, "savgol2d_weights")
    held = torch.cuda.memory_allocated(dev)
    try:
        tw.savgol2d_weights(*W2D_DEGENERATE, device=dev)
        raised = False
    except np.linalg.LinAlgError:
        raised = True
    require(raised and torch.cuda.memory_allocated(dev) == held,
            f"savgol2d_weights{W2D_DEGENERATE} must raise LinAlgError "
            "before any tensor is made")
    parts.append(f"(c) savgol2d_weights {len(W2D)} geometries f32 "
                 f"{worst[torch.float32]:.3e} scaled (gate {W2D_F32}), "
                 f"+{W2D_F64_ONLY[0]} f64 {worst[torch.float64]:.3e} (gate "
                 f"{W2D_F64}) vs host f64; bit-equal with TF32 allowed; "
                 f"{W2D_DEGENERATE} raises LinAlgError, nothing allocated")

    # (d) the host engine against the card
    t0 = time.perf_counter()
    native.load_library()
    t_build = time.perf_counter() - t0
    rows = x[:NATIVE_ROWS]
    got = native.HostSavgol1D(cfg).apply_batch(rows.cpu().numpy(),
                                               n_threads=0)
    want = f_host.apply(rows).cpu().numpy()
    e1 = float(np.abs(got - want).max())
    s1 = max(1.0, float(np.abs(want).max()))
    require(e1 <= GATE_ABS * s1, f"HostSavgol1D vs Savgol1D.apply: {e1:.3e}")
    cfg2 = sgt.Savgol2DConfig(5, 5, 3)
    img = torch.randn(IMG_FULL[1:], generator=gen, device=dev)
    got2 = native.HostSavgol2D(cfg2).apply(img.cpu().numpy())
    want2 = sgt.Savgol2D.create(cfg2, device=dev).apply(img).cpu().numpy()
    e2 = float(np.abs(got2 - want2).max())
    s2 = max(1.0, float(np.abs(want2).max()))
    require(e2 <= F32_TOL_2D * s2, f"HostSavgol2D vs Savgol2D.apply: {e2:.3e}")
    del img
    parts.append(f"(d) native built in {t_build:.1f} s; HostSavgol1D on "
                 f"{NATIVE_ROWS} headline rows vs Savgol1D.apply {e1:.3e} "
                 f"(gate {GATE_ABS} x {s1:.2f}), HostSavgol2D 11x11 order 3 "
                 f"on {IMG_FULL[1:]} vs Savgol2D.apply {e2:.3e} (gate "
                 f"{F32_TOL_2D} x {s2:.2f})")

    # (e) the chained k-difference beside K1's device time; idle shares
    k1_ms = device_ms(lambda: cc.savgol_polynomial_cuda(
        x, f_host.center_weights, f_host.edge_weights, 12))
    per, ratio, _ = profiling.benchmark_chained(
        lambda v: f_host.apply(v), x, iters=5, k=4,
        feedback=lambda y, template: y, return_info=True)
    lo, hi = profiling.RATIO_BAND
    require(lo <= ratio <= hi, f"benchmark_chained ratio {ratio:.3f} outside "
            f"{profiling.RATIO_BAND}")
    st = ts.chunk_init(cfg.half_window, device=dev)
    chunk = torch.randn(STREAM_TRACED, generator=gen, device=dev)
    cw, ew, dt = f_host.center_weights, f_host.edge_weights, f_host.dt_inv
    calls = {"apply": lambda: f_host.apply(x),
             "chunk": lambda: ts.stream_process_chunk(st, chunk, cw, ew, dt)}
    idle, takes = {}, {}

    def traced(call, reps):
        call()   # the profiler's start-up falls outside the window
        torch.cuda.synchronize()
        with torch.profiler.record_function("traced call"):
            for _ in range(reps):
                call()
            torch.cuda.synchronize()

    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        # one call, as a caller waits for it; and 20 back to back, where
        # the host enqueues while the card runs
        for (name, call), reps in itertools.product(calls.items(), (1, 20)):
            ev, takes[name, reps] = profiling.trace_events(
                lambda: traced(call, reps), os.path.join(tmp, f"{name}{reps}"))
            idle[name, reps] = idle_share(ev)
            require(idle[name, reps][1], f"trace of {name} x {reps}: no "
                    f"kernel launched in the window ({takes[name, reps]} "
                    "takes)")
    parts.append(
        f"(e) benchmark_chained Savgol1D.apply ({B_FULL}, {N_FULL}): "
        f"{per * 1e3:.4f} ms a step, ratio {ratio:.3f} (band "
        f"{profiling.RATIO_BAND}), K1 device_ms {k1_ms:.4f}; device idle "
        f"share (profiling.trace, after a first call in the same trace) "
        + ", ".join(f"{what} x {r} {idle[k, r][0]:.4f} of "
                    f"{idle[k, r][2]:.4f} ms ({len(idle[k, r][1])} kernels"
                    f", {takes[k, r]} take{'s' * (takes[k, r] > 1)})"
                    for k, what in (("apply", "headline apply"),
                                    ("chunk", f"stream chunk of "
                                              f"{STREAM_TRACED}"))
                    for r in (1, 20)))
    return {"line": "host modules: " + "; ".join(parts) + f" [{card}]",
            "create_on_device_launches": launches}


def main() -> int:
    # -- 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    print(f"device: {torch.cuda.get_device_name(0)} count="
          f"{torch.cuda.device_count()} torch={torch.__version__} "
          f"cuda={torch.version.cuda}")

    import savgol_tpu_torch as sgt
    from savgol_tpu_torch import _build
    from savgol_tpu_torch.ops import cuda_conv as cc
    from savgol_tpu_torch.ops.weights import savgol_weights_np
    from savgol_tpu_torch.utils.timing import cuda_time_ms, device_ms

    dev = torch.device("cuda")

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {lib_path}")

    # -- 3/4. kernels vs plain over the grid --------------------------------
    rng = np.random.default_rng(1)
    worst = {"sg1d_poly": 0.0, "corr1d_valid": 0.0}
    cases = 0
    cc.reset_launches()
    for dtype, tol in ((torch.float32, F32_TOL), (torch.float64, F64_TOL)):
        for n in (1, 12, 32):
            ws = 2 * n + 1
            for B in (1, 16, 24, 128):
                for N in (ws, ws + 1, 4099, 262_147):
                    x = torch.from_numpy(rng.standard_normal((B, N))).to(
                        dev, dtype)
                    for d in (0, 1, 2):
                        f = sgt.Savgol1D.create(
                            sgt.SavgolConfig(n, min(4, 2 * n), d,
                                             time_step=0.01),
                            dtype=dtype, device=dev)
                        for sign in (False, True):
                            got = f.apply(x, reference_edge_sign=sign)
                            want = f.apply(x, reference_edge_sign=sign,
                                           method="xla")
                            e, s = max_err(got, want)
                            require(e <= tol * s, f"K1 n={n} d={d} B={B} "
                                    f"N={N} {dtype} sign={sign}: {e:.3e}")
                            worst["sg1d_poly"] = max(worst["sg1d_poly"], e / s)
                            cases += 1
                        got = f.apply_valid(x)
                        e, s = max_err(got, f.apply_valid(x, method="xla"))
                        require(e <= tol * s, f"K3 n={n} d={d} B={B} N={N} "
                                f"{dtype}: {e:.3e}")
                        worst["corr1d_valid"] = max(worst["corr1d_valid"],
                                                    e / s)
                        if N == 4099:
                            # the pad boundaries run K2 (sg1d_pad)
                            for bnd in ("reflect", "periodic", "constant"):
                                e, s = max_err(
                                    f.apply(x, boundary=bnd),
                                    f.apply(x, boundary=bnd, method="xla"))
                                require(e <= tol * s,
                                        f"K2 {bnd} n={n} B={B}: {e:.3e}")
                    # non-last axis: (N, B) filtered along axis 0
                    xt = x.t().contiguous()
                    e, s = max_err(f.apply(xt, axis=0),
                                   f.apply(xt, axis=0, method="xla"))
                    require(e <= tol * s, f"K1 axis=0 n={n} B={B} N={N}")
    torch.cuda.synchronize()
    grid_launches = dict(cc.LAUNCHES)
    require(all(v > 0 for v in grid_launches.values()),
            f"grid did not reach every kernel: {grid_launches}")
    print(f"grid: {cases} K1 cases, worst scaled error "
          f"K1={worst['sg1d_poly']:.3e} K3={worst['corr1d_valid']:.3e} "
          f"(tol f32 {F32_TOL}, f64 {F64_TOL}), K2 on the pad boundaries at "
          f"N = 4099, launches {grid_launches}")

    # -- 5. the slice at full size ------------------------------------------
    cfg = sgt.SavgolConfig(12, 4)
    f = sgt.Savgol1D.create(cfg, device=dev)
    x_np = np.random.default_rng(0).standard_normal(
        (B_FULL, N_FULL), dtype=np.float32)
    x = torch.from_numpy(x_np).to(dev)
    torch.cuda.synchronize()
    cc.reset_launches()
    y = f.apply(x)
    yv = f.apply_valid(x)
    torch.cuda.synchronize()
    launches = dict(cc.LAUNCHES)
    require(launches["sg1d_poly"] >= 1 and launches["corr1d_valid"] >= 1,
            f"main path did not launch every kernel: {launches}")
    require(y.shape == x.shape and y.dtype == torch.float32, "apply shape")
    require(yv.shape == (B_FULL, N_FULL - 24), "apply_valid shape")
    require(bool(torch.isfinite(y).all()) and bool(torch.isfinite(yv).all()),
            "non-finite output")
    # f64 oracle on 4 rows: plain version in float64 with f64 host weights
    c64, e64 = (torch.from_numpy(a).to(dev)
                for a in savgol_weights_np(cfg, np.float64))
    rows = [0, 1, 64, 127]
    x64 = x[rows].double()
    ref = cc.savgol_polynomial_plain(x64, c64, e64, 12)
    err_f64 = (y[rows].double() - ref).abs().max().item()
    refv = cc.correlate_valid_plain(x64, c64)
    err_f64_valid = (yv[rows].double() - refv).abs().max().item()
    require(err_f64 <= GATE_ABS, f"apply vs f64: {err_f64:.3e}")
    require(err_f64_valid <= GATE_ABS, f"apply_valid vs f64: "
            f"{err_f64_valid:.3e}")
    from scipy.signal import savgol_filter
    err_scipy = 0.0
    y_host = y[[0, 127]].cpu().numpy().astype(np.float64)
    for i, r in enumerate((0, 127)):
        sp = savgol_filter(x_np[r].astype(np.float64), 25, 4, mode="interp")
        err_scipy = max(err_scipy, float(np.abs(y_host[i] - sp).max()))
    require(err_scipy <= GATE_ABS, f"apply vs scipy: {err_scipy:.3e}")
    # each kernel's wrapper against its plain version at the main path's shape
    w, ew = f.center_weights, f.edge_weights
    k1_err, k1_s = max_err(cc.savgol_polynomial_cuda(x, w, ew, 12),
                           cc.savgol_polynomial_plain(x, w, ew, 12))
    k3_err, k3_s = max_err(cc.correlate_valid_cuda(x, w),
                           cc.correlate_valid_plain(x, w))
    require(k1_err <= F32_TOL * k1_s and k3_err <= F32_TOL * k3_s,
            f"kernel vs plain at full size: K1 {k1_err:.3e} K3 {k3_err:.3e}")
    print(f"slice ({B_FULL}, {N_FULL}) f32 n=12 m=4: launches {launches}; "
          f"max abs err apply vs f64 {err_f64:.3e}, apply_valid vs f64 "
          f"{err_f64_valid:.3e}, vs scipy interp {err_scipy:.3e} "
          f"(gate {GATE_ABS}); K1 vs plain {k1_err:.3e}, K3 vs plain "
          f"{k3_err:.3e}")
    del y, yv, x64, ref, refv

    # -- 6. gradient --------------------------------------------------------
    xg_np = np.random.default_rng(2).standard_normal((24, 4099)).astype(
        np.float32)
    grads = {}
    for method in ("auto", "xla"):
        fg = sgt.Savgol1D.create(sgt.deriv1(12, 4, dt=0.01), device=dev)
        xg = torch.from_numpy(xg_np).to(dev).requires_grad_()
        params = [xg, fg.center_weights, fg.edge_weights, fg.dt_inv]
        for p in params[1:]:
            p.requires_grad_()
        before = cc.LAUNCHES["sg1d_poly"]
        loss = fg.apply(xg, method=method).square().sum()
        grads[method] = torch.autograd.grad(loss, params)
        if method == "auto":
            require(cc.LAUNCHES["sg1d_poly"] == before + 1,
                    "gradient run did not go through K1")
    grad_err = 0.0
    for got, want in zip(grads["auto"], grads["xla"]):
        e, s = max_err(got, want)
        require(e <= 2e-5 * s, f"gradient mismatch {e:.3e} (scale {s:.3e})")
        grad_err = max(grad_err, e / s)
    print(f"gradient (24, 4099) deriv1: worst scaled error {grad_err:.3e} "
          f"(tol 2e-5) for x, center, edge, dt_inv")

    # -- 7. timing ----------------------------------------------------------
    timings = {}
    for B in (128, 16, 1):
        xb = x[:B].contiguous()
        k = device_ms(lambda: cc.savgol_polynomial_cuda(xb, w, ew, 12))
        p = device_ms(lambda: cc.savgol_polynomial_plain(xb, w, ew, 12),
                         warmup=1, reps=5)
        timings[("K1", B)] = (k, p)
    k = device_ms(lambda: cc.correlate_valid_cuda(x, w))
    p = device_ms(lambda: cc.correlate_valid_plain(x, w), warmup=1,
                     reps=5)
    timings[("K3", B_FULL)] = (k, p)
    # f64 at 25 taps (16 B a sample: bytes bound it)
    xd, wd, ewd = x.double(), w.double(), ew.double()
    t64 = {"K1 f64": device_ms(lambda: cc.savgol_polynomial_cuda(
               xd, wd, ewd, 12)),
           "K3 f64": device_ms(lambda: cc.correlate_valid_cuda(xd, wd))}
    del xd
    # yardstick: one cuDNN correlation of the same rows, TF32 off (timed
    # here only; the port never calls it)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    x3, w3d = x.view(B_FULL, 1, N_FULL), w.view(1, 1, -1)
    lib_k3 = device_ms(lambda: torch.nn.functional.conv1d(x3, w3d))
    torch.backends.cudnn.allow_tf32 = tf32
    b1 = speed_of_light_1d((B_FULL, N_FULL)).fields
    r3 = speed_of_light_valid_1d((B_FULL, N_FULL))
    b3 = r3.fields
    print(f"library: F.conv1d (TF32 off) {lib_k3:.4f} ms; bounds K1 "
          f"{b1['bound_ms']:.4f} ms ({b1['bound_by']}), K3 "
          f"{b3['bound_ms']:.4f} ms ({b3['bound_by']}) [{card}]")
    # the slice end to end: the entry point a user calls, kernel vs plain
    k = cuda_time_ms(lambda: f.apply(x))
    p = cuda_time_ms(lambda: f.apply(x, method="xla"), warmup=1, reps=5)
    timings[("Savgol1D.apply", B_FULL)] = (k, p)
    for (name, B), (k, p) in timings.items():
        samples = B * N_FULL
        r = r3 if name == "K3" else speed_of_light_1d((B, N_FULL))
        b = r.fields
        print(f"time {name} ({B}, {N_FULL}) f32 n=12: kernel {k:.4f} ms = "
              f"{samples / k / 1e6:.2f} Gsamples/s, "
              f"{r.hbm_bytes / k / 1e6:.1f} GB/s effective; plain "
              f"{p:.4f} ms = {samples / p / 1e6:.2f} Gsamples/s; bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']}) [{card}]")
    b64 = speed_of_light_1d((B_FULL, N_FULL), dtype="float64").fields
    for name, k in t64.items():
        print(f"time {name} ({B_FULL}, {N_FULL}) n=12: kernel {k:.4f} ms; "
              f"bound {b64['bound_ms']:.4f} ms ({b64['bound_by']}) [{card}]")

    del x

    # -- 8. 2D kernels vs plain over the grid -------------------------------
    from savgol_tpu_torch.ops import cuda_conv2d as c2
    from savgol_tpu_torch.ops.apply2d import _factors
    from savgol_tpu_torch.ops.weights import savgol2d_weights_np
    print(grid_2d(sgt, c2, dev))

    # -- 9. the 2D slice at full size ---------------------------------------
    cfg2 = sgt.Savgol2DConfig(5, 5, 3)
    f2 = sgt.Savgol2D.create(cfg2, device=dev)
    img = torch.from_numpy(np.random.default_rng(0).standard_normal(
        IMG_FULL, dtype=np.float32)).to(dev)
    img0 = img[:1]

    def counted(run, want: dict, what: str):
        """run() with the launch counts zeroed just before and read just
        after; they must equal want exactly."""
        torch.cuda.synchronize()
        c2.reset_launches()
        out = run()
        torch.cuda.synchronize()
        got = dict(c2.LAUNCHES)
        require(got == want, f"{what} launched {got}, expected {want}")
        return out, got

    # the main path: Savgol2D.apply, CONSTANT, method="auto" -> K2D-sep (a
    # rank-2 stencil whose factors Savgol2D.create cached, on a batch that
    # fills the card: apply2d._sep_cheaper)
    staged = dict(c2.STAGING)
    y2, launches2 = counted(lambda: f2.apply(img),
                            {"corr2d_valid": 0, "corr2d_sep": 1},
                            "Savgol2D.apply")
    # ... staged through K2D-sep's input ring (aligned 2048-sample rows)
    require(c2.STAGING == {**staged, "ring": staged["ring"] + 1},
            f"Savgol2D.apply staged {c2.STAGING} (before {staged}), "
            "expected one ring")
    y2_sep, launches_sep = counted(lambda: f2.apply(img, method="sep"),
                                   {"corr2d_valid": 0, "corr2d_sep": 1},
                                   "Savgol2D.apply(method='sep')")
    # one frame: the stacks take K2D-dense, and so does the fused
    # Laplacian, whose K2D-sep blocks would fill a quarter of the card
    derived, launches_der = counted(
        lambda: {name: getattr(sgt, name)(img0, 5, 5, 3) for name in
                 ("savgol2d_gradient", "savgol2d_hessian",
                  "savgol2d_laplacian")},
        {"corr2d_valid": 3, "corr2d_sep": 0},
        "savgol2d_gradient + _hessian + _laplacian")
    # the whole batch: the fused Laplacian (rank 2, cached) takes K2D-sep
    lap, launches_lap = counted(
        lambda: sgt.savgol2d_laplacian(img, 5, 5, 3),
        {"corr2d_valid": 0, "corr2d_sep": 1}, "savgol2d_laplacian")
    require(y2.shape == img.shape and y2.dtype == torch.float32, "2D shape")
    require(bool(torch.isfinite(y2).all()) and
            bool(torch.isfinite(y2_sep).all()), "non-finite 2D output")
    # f64 oracle on images 0 and 15: plain version, f64 host weights
    w64 = torch.from_numpy(savgol2d_weights_np(cfg2, np.float64)).to(dev)
    ref2 = c2.correlate2d_valid_plain(img[[0, 15]].double(), w64, "edge")
    e_apply, s_apply = max_err(y2[[0, 15]], ref2)
    e_sep, _ = max_err(y2_sep[[0, 15]], ref2)
    require(e_apply <= F32_TOL_2D * s_apply and e_sep <= F32_TOL_2D * s_apply,
            f"Savgol2D.apply vs f64: {e_apply:.3e}, sep {e_sep:.3e}")
    e_lap, s_lap = max_err(lap[[0, 15]], sgt.savgol2d_laplacian(
        img[[0, 15]].double(), 5, 5, 3, method="xla"))
    require(e_lap <= F32_TOL_2D * s_lap,
            f"savgol2d_laplacian (K2D-sep) vs f64: {e_lap:.3e}")
    e_derived = {}
    for name, got in derived.items():
        want = getattr(sgt, name)(img0.double(), 5, 5, 3, method="xla")
        got, want = ((got,), (want,)) if name.endswith("laplacian") else (
            got, want)
        e_derived[name] = 0.0
        for g, w in zip(got, want):
            e, s = max_err(g, w)
            require(e <= F32_TOL_2D * s, f"{name} vs f64: {e:.3e}")
            e_derived[name] = max(e_derived[name], e / s)
    # each kernel's wrapper against its plain version at the slice's shape
    w2 = f2.weights
    u2, v2 = (torch.from_numpy(a).to(dev, torch.float32) for a in
              c2._svd_stencil_np(w64.cpu().numpy()))
    kd_err, kd_s = max_err(c2.correlate2d_valid_cuda(img, w2, "edge"),
                           c2.correlate2d_valid_plain(img, w2, "edge"))
    ks_err, ks_s = max_err(c2.correlate2d_sep_cuda(img, u2, v2, "edge"),
                           c2.correlate2d_sep_plain(img, u2, v2, "edge"))
    require(kd_err <= F32_TOL_2D * kd_s and ks_err <= F32_TOL_2D * ks_s,
            f"2D kernels vs plain at full size: dense {kd_err:.3e} sep "
            f"{ks_err:.3e}")
    print(f"2D slice {IMG_FULL} f32 11x11 order 3 CONSTANT: launches "
          f"apply {launches2} (staged by the ring), apply(method='sep') "
          f"{launches_sep}, "
          f"gradient + hessian + laplacian {launches_der}, laplacian of "
          f"the batch {launches_lap}; max abs err "
          f"apply vs f64 {e_apply:.3e}, "
          f"method='sep' vs f64 {e_sep:.3e} (gate {F32_TOL_2D} x "
          f"{s_apply:.3f}); gradient/hessian/laplacian vs f64 scaled "
          + ", ".join(f"{e:.3e}" for e in e_derived.values())
          + f", laplacian of the batch {e_lap / s_lap:.3e}; K2D-dense vs "
          f"plain {kd_err:.3e}, K2D-sep vs plain {ks_err:.3e} (rank "
          f"{u2.shape[0]})")
    del y2, y2_sep, derived, lap, ref2

    # -- 10. 2D gradient ----------------------------------------------------
    xg_np = np.random.default_rng(4).standard_normal((2, 256, 320)).astype(
        np.float32)
    grads = {}
    for method in ("auto", "xla"):
        fg = sgt.Savgol2D.create(
            sgt.Savgol2DConfig(5, 5, 3, deriv_x=1, delta_x=0.5), device=dev)
        xg = torch.from_numpy(xg_np).to(dev).requires_grad_()
        fg.weights.requires_grad_()
        before = c2.LAUNCHES["corr2d_valid"]
        loss = fg.apply(xg, boundary="reflect", method=method).square().sum()
        grads[method] = torch.autograd.grad(loss, [xg, fg.weights])
        if method == "auto":
            require(c2.LAUNCHES["corr2d_valid"] == before + 1,
                    "2D gradient run did not go through K2D-dense")
    grad_err = 0.0
    for got, want in zip(grads["auto"], grads["xla"]):
        e, s = max_err(got, want)
        require(e <= 1e-4 * s, f"2D gradient mismatch {e:.3e} (scale "
                f"{s:.3e})")
        grad_err = max(grad_err, e / s)
    print(f"2D gradient (2, 256, 320) 11x11 d/dx REFLECT: worst scaled error "
          f"{grad_err:.3e} (tol 1e-4) for x and the stencil")

    # -- 11. 2D timing --------------------------------------------------------
    w3 = torch.from_numpy(np.stack([savgol2d_weights_np(
        sgt.Savgol2DConfig(5, 5, 3, deriv_x=dx, deriv_y=dy), np.float64)
        for dx, dy in ((2, 0), (1, 1), (0, 2))])).to(dev, torch.float32)
    t2 = {
        "K2D-dense": (
            device_ms(lambda: c2.correlate2d_valid_cuda(img, w2, "edge")),
            device_ms(lambda: c2.correlate2d_valid_plain(img, w2, "edge"),
                         warmup=1, reps=5)),
        "K2D-dense K=3 (Hessian stack)": (
            device_ms(lambda: c2.correlate2d_valid_cuda(img, w3, "edge")),
            device_ms(lambda: c2.correlate2d_valid_plain(img, w3, "edge"),
                         warmup=1, reps=3)),
        "K2D-sep": (
            device_ms(lambda: c2.correlate2d_sep_cuda(img, u2, v2,
                                                         "edge")),
            device_ms(lambda: c2.correlate2d_sep_plain(img, u2, v2,
                                                          "edge"),
                         warmup=1, reps=5)),
        "Savgol2D.apply": (
            cuda_time_ms(lambda: f2.apply(img)),
            cuda_time_ms(lambda: f2.apply(img, method="xla"), warmup=1,
                         reps=5)),
        "Savgol2D.apply method='sep'": (
            cuda_time_ms(lambda: f2.apply(img, method="sep")),
            cuda_time_ms(lambda: f2.apply(img, method="xla"), warmup=1,
                         reps=5)),
    }
    pix = img.numel()
    # yardstick: one cuDNN 2D correlation of the batch, TF32 off, zero
    # padding where the kernels map the edge (timed here only)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    img4, w4 = img.unsqueeze(1), w2.reshape(1, 1, 11, 11)
    lib_2d = device_ms(lambda: torch.nn.functional.conv2d(img4, w4,
                                                             padding=5))
    w34 = w3.reshape(3, 1, 11, 11)
    lib_2d3 = device_ms(lambda: torch.nn.functional.conv2d(img4, w34,
                                                              padding=5))
    # K2D-sep at the wide windows method="auto" sends it (ranks 3 and 4 of
    # the f32 stencils, square and 17 x 25) and at the rank 6 of the f32
    # 11 x 11 stencil, with
    # the instance each runs, its plain version and one F.conv2d of the
    # same stencil
    sep_wide = {}
    for H, W, order in ((11, 11, 0),) + RANKED_2D:
        if order:
            fw = sgt.Savgol2D.create(sgt.Savgol2DConfig(
                (W - 1) // 2, (H - 1) // 2, order), device=dev)
            (uw, vw), = _factors(fw.weights, torch.float32, dev)
            ww = fw.weights
        else:
            uw, vw = (torch.from_numpy(a).to(dev, torch.float32) for a in
                      c2._svd_stencil_np(w2.double().cpu().numpy()))
            ww = w2
        r = uw.shape[0]
        e, sc = max_err(c2.correlate2d_sep_cuda(img, uw, vw, "edge"),
                        c2.correlate2d_sep_plain(img, uw, vw, "edge"))
        require(e <= F32_TOL_2D * sc, f"K2D-sep {H}x{W} rank {r} vs plain: "
                f"{e:.3e}")
        torch.backends.cudnn.allow_tf32 = False
        lib_w = device_ms(lambda: torch.nn.functional.conv2d(
            img4, ww.reshape(1, 1, H, W), padding=(H // 2, W // 2)),
            warmup=1, reps=3)
        torch.backends.cudnn.allow_tf32 = tf32
        sep_wide[f"{H}x{W} rank {r}"] = {
            "instance": c2.sep_instance(H, W, r),
            "ms": device_ms(lambda: c2.correlate2d_sep_cuda(
                img, uw, vw, "edge")),
            "plain_ms": device_ms(lambda: c2.correlate2d_sep_plain(
                img, uw, vw, "edge"), warmup=1, reps=3),
            "max_abs_err": e, **speed_of_light_separable_2d(
                H, r, shape=img.shape, window_w=W).fields,
            "library_ms": lib_w}
    b2d = speed_of_light_2d(11, shape=img.shape).fields
    b2d3 = speed_of_light_bank_2d(11, 3, shape=img.shape).fields
    b2s = speed_of_light_separable_2d(11, u2.shape[0], shape=img.shape
                                      ).fields
    print(f"library: F.conv2d (TF32 off, zero padding) {lib_2d:.4f} ms, "
          f"3 output channels (Hessian stack) {lib_2d3:.4f} ms; bounds "
          f"K2D-dense {b2d['bound_ms']:.4f} ms ({b2d['bound_by']}), K=3 "
          f"{b2d3['bound_ms']:.4f} ms ({b2d3['bound_by']}), K2D-sep "
          f"{b2s['bound_ms']:.4f} ms ({b2s['bound_by']}) [{card}]")
    for name, rec in sep_wide.items():
        print(f"time K2D-sep {name} {IMG_FULL} ({rec['instance']}): kernel "
              f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, bound "
              f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), F.conv2d "
              f"{rec['library_ms']:.4f} ms; vs plain {rec['max_abs_err']:.3e}"
              f" [{card}]")
    for name, (k, p) in t2.items():
        print(f"time {name} {IMG_FULL} f32 11x11: kernel {k:.4f} ms = "
              f"{pix / k / 1e6:.2f} Gpix/s; plain {p:.4f} ms = "
              f"{pix / p / 1e6:.2f} Gpix/s [{card}]")
    del img, img0

    # -- 12-17. the masked path ---------------------------------------------
    t_masked = time.perf_counter()
    print(k8_grid(dev))
    print(k8b_forms(dev))
    print(k9_grid(sgt, dev))
    print(k10_grid(sgt, dev))
    masked_kernels = masked_slice(sgt, dev, card)

    # -- 18-20. the irregular-sampling path ---------------------------------
    t_nonuni = time.perf_counter()
    print(k11_grid(sgt, dev))
    t_k12 = time.perf_counter()
    print(k12_grid(dev))
    t_slice = time.perf_counter()
    direct_solves, nonuniform_kernels = nonuniform_slice(sgt, dev, card)
    # the direct resample route's per-query solve is K8b's launch too
    next(k for k in masked_kernels
         if k["name"] == "plane_solve")["launches"] += direct_solves

    # -- 21-24. the padded-boundary and filter-bank paths --------------------
    t_bank = time.perf_counter()
    print(k2_grid(sgt, dev))
    t_k4 = time.perf_counter()
    print(k4_grid(dev))
    t_bank_slice = time.perf_counter()
    bank_kernels = bank_slice(sgt, dev, card)

    # -- 25. the exact 1D tile's grid; the 1D tile kernels at window 101 ----
    t_wide = time.perf_counter()
    print(exact_grid(dev))
    t_wide101 = time.perf_counter()
    wide = wide_window(dev, card)
    # -- 26-29. the sharded paths on a ring of ranks sharing the card -------
    t_ring = time.perf_counter()
    halo_kernel = sharded_phases(card)
    # -- 30-35. method="bf16" and the attribution probes --------------------
    t_bf16 = time.perf_counter()
    print(bf16_grid_1d(dev))
    print(bf16_grid_2d(dev))
    print(nonfinite_grid(dev))
    t_bf16_slice = time.perf_counter()
    bf16_kernels = (bf16_slice_1d(sgt, dev, card)
                    + bf16_slice_2d(sgt, dev, card))
    print(bf16_scipy(dev))
    t_probes = time.perf_counter()
    probe_kernels = probes_phase(dev, card)
    # -- 36-38. P1 and streaming --------------------------------------------
    t_p1 = time.perf_counter()
    print(p1_grid(dev))
    p1_kernel = p1_headline(dev, card)
    t_stream = time.perf_counter()
    print(stream_phase(dev, card))
    # -- 39. the host-side modules ------------------------------------------
    t_host_mods = time.perf_counter()
    host_mods = host_modules_phase(sgt, dev, card)
    print(host_mods["line"])
    t_end = time.perf_counter()
    print(f"wall time: build and phases 3-11 {t_masked - t0:.1f} s, masked "
          f"phases 12-17 {t_nonuni - t_masked:.1f} s, irregular-sampling "
          f"phases 18-20 {t_bank - t_nonuni:.1f} s (K11 grid "
          f"{t_k12 - t_nonuni:.1f}, K12 grid {t_slice - t_k12:.1f}, slice "
          f"{t_bank - t_slice:.1f}), padded/bank phases 21-24 "
          f"{t_wide - t_bank:.1f} s (K2 grid {t_k4 - t_bank:.1f}, K4 grid "
          f"{t_bank_slice - t_k4:.1f}, slice {t_wide - t_bank_slice:.1f}), "
          f"exact tile and window-101 phase 25 {t_ring - t_wide:.1f} s "
          f"(grid {t_wide101 - t_wide:.1f}), sharded phases "
          f"26-29 {t_bf16 - t_ring:.1f} s, bf16 phases 30-34 "
          f"{t_probes - t_bf16:.1f} s (grids {t_bf16_slice - t_bf16:.1f}), "
          f"probes phase 35 {t_p1 - t_probes:.1f} s, P1 phases 36-37 "
          f"{t_stream - t_p1:.1f} s, streaming phase 38 "
          f"{t_host_mods - t_stream:.1f} s, host-side modules phase 39 "
          f"{t_end - t_host_mods:.1f} s")

    kernels = [
        {"name": "sg1d_poly", "route": "cuda",
         "source": "savgol_tpu_torch/csrc/sg1d_poly.cu",
         "replaces": "savgol_tpu/ops/pallas_conv.py:564",
         "launches": launches["sg1d_poly"], "max_abs_err": k1_err,
         "ms": timings[("K1", B_FULL)][0],
         "plain_ms": timings[("K1", B_FULL)][1], **b1, "library_ms": None,
         "f64_ms": t64["K1 f64"], "f64_bound_ms": b64["bound_ms"],
         "create_on_device_launches":
             host_mods["create_on_device_launches"]},
        {"name": "corr1d_valid", "route": "cuda",
         "source": "savgol_tpu_torch/csrc/corr1d_valid.cu",
         "replaces": "savgol_tpu/ops/pallas_conv.py:1049",
         "launches": launches["corr1d_valid"], "max_abs_err": k3_err,
         "ms": timings[("K3", B_FULL)][0],
         "plain_ms": timings[("K3", B_FULL)][1], **b3,
         "library_ms": lib_k3, "f64_ms": t64["K3 f64"],
         "f64_bound_ms": b64["bound_ms"]},
        {"name": "corr2d_valid", "route": "cuda",
         "source": "savgol_tpu_torch/csrc/corr2d_valid.cu",
         "replaces": "savgol_tpu/ops/pallas_conv.py:1501",
         "launches": launches_der["corr2d_valid"], "max_abs_err": kd_err,
         "ms": t2["K2D-dense"][0], "plain_ms": t2["K2D-dense"][1], **b2d,
         "library_ms": lib_2d,
         "stack3_ms": t2["K2D-dense K=3 (Hessian stack)"][0],
         "stack3_plain_ms": t2["K2D-dense K=3 (Hessian stack)"][1],
         "stack3_bound_ms": b2d3["bound_ms"], "stack3_library_ms": lib_2d3},
        {"name": "corr2d_sep", "route": "cuda",
         "source": "savgol_tpu_torch/csrc/corr2d_sep.cu",
         "replaces": "savgol_tpu/ops/pallas_conv.py:1814",
         "launches": launches2["corr2d_sep"], "max_abs_err": ks_err,
         "ms": t2["K2D-sep"][0], "plain_ms": t2["K2D-sep"][1], **b2s,
         "library_ms": lib_2d,
         "instance": c2.sep_instance(11, 11, u2.shape[0]),
         "wide": sep_wide},
    ] + (masked_kernels + nonuniform_kernels + bank_kernels + [halo_kernel]
         + bf16_kernels + probe_kernels + [p1_kernel])
    for rec in kernels:
        key = {"sg1d_poly": "K1", "sg1d_pad": "K2 symmetric",
               "corr1d_valid": "K3"}.get(rec["name"])
        if key is not None:
            rec.update(ws101_ms=wide["t"][key][0],
                       ws101_plain_ms=wide["t"][key][1],
                       ws101_max_abs_err=wide["errs"][key],
                       ws101_bound_ms=wide["bound"]["bound_ms"])
            f64_key = {"K1": "K1 f64", "K3": "K3 f64"}.get(key)
            if f64_key:
                rec.update(ws101_f64_ms=wide["t64"][f64_key],
                           ws101_f64_bound_ms=wide["bound64"]["bound_ms"])
            if key == "K3":
                rec["ws101_library_ms"] = wide["library_ms"]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
