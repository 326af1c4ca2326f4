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
batch against a float64 reference, gradients, and timings. Every phase
prints one line; any failure raises and the script exits nonzero. The last
line is the JSON device record; the line before it lists the kernels.

Exits nonzero without a CUDA device. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

B_FULL, N_FULL = 128, 1 << 20
F32_TOL = 2e-6      # scaled by max(1, max|ref|): summation order, dt folding
F64_TOL = 1e-12
GATE_ABS = 1e-6     # BASELINE.md contract: max abs error vs the f64 oracle

IMG_FULL = (16, 2048, 2048)    # bench.py's 2D batch, 11x11 order 3 window
# the JAX package's exact-2D gate (tests/test_2d.py:387, bench.py:471),
# scaled by max(1, max|ref|)
F32_TOL_2D = 1e-5
WINDOWS_2D = ((3, 3), (5, 3), (11, 11), (7, 13), (23, 23), (33, 33))
# the last image is shorter than the pad of every window but 3 x 3
IMAGES_2D = ((1, 2047, 2049), (3, 37, 29), (2, 3, 5))
BOUNDARIES_2D = ("valid", "constant", "reflect", "periodic")
DERIVS_2D = ([(1, 1)], [(1, 0), (0, 1)], [(2, 0), (1, 1), (0, 2)])


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
    from savgol_tpu_torch.ops.apply2d import _stencil_stack
    rng = np.random.default_rng(3)
    worst = {"corr2d_valid": 0.0, "corr2d_sep": 0.0}
    cases = 0
    c2.reset_launches()
    for dtype, tol in ((torch.float32, F32_TOL_2D), (torch.float64, F64_TOL)):
        for shape in IMAGES_2D:
            x = torch.from_numpy(rng.standard_normal(shape)).to(dev, dtype)
            for H, W in WINDOWS_2D:
                order = 2 if min(H, W) == 3 else 3
                for derivs in DERIVS_2D:
                    ws, s = (torch.from_numpy(a).to(dev) for a in
                             _stencil_stack((W - 1) // 2, (H - 1) // 2,
                                            order, derivs, 0.5, 0.25))
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
    return (f"2D grid: {cases} cases, worst scaled error "
            f"dense={worst['corr2d_valid']:.3e} sep={worst['corr2d_sep']:.3e}"
            f" (tol f32 {F32_TOL_2D}, f64 {F64_TOL}), launches {launches}")


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
    from savgol_tpu_torch.utils.timing import cuda_time_ms

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
                            for bnd in ("reflect", "periodic", "constant"):
                                e, s = max_err(
                                    f.apply(x, boundary=bnd),
                                    f.apply(x, boundary=bnd, method="xla"))
                                require(e <= tol * s,
                                        f"K3 {bnd} n={n} B={B}: {e:.3e}")
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
          f"(tol f32 {F32_TOL}, f64 {F64_TOL}), launches {grid_launches}")

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
        k = cuda_time_ms(lambda: cc.savgol_polynomial_cuda(xb, w, ew, 12))
        p = cuda_time_ms(lambda: cc.savgol_polynomial_plain(xb, w, ew, 12),
                         warmup=1, reps=5)
        timings[("K1", B)] = (k, p)
    k = cuda_time_ms(lambda: cc.correlate_valid_cuda(x, w))
    p = cuda_time_ms(lambda: cc.correlate_valid_plain(x, w), warmup=1,
                     reps=5)
    timings[("K3", B_FULL)] = (k, p)
    # the slice end to end: the entry point a user calls, kernel vs plain
    k = cuda_time_ms(lambda: f.apply(x))
    p = cuda_time_ms(lambda: f.apply(x, method="xla"), warmup=1, reps=5)
    timings[("Savgol1D.apply", B_FULL)] = (k, p)
    for (name, B), (k, p) in timings.items():
        samples = B * N_FULL
        print(f"time {name} ({B}, {N_FULL}) f32 n=12: kernel {k:.4f} ms = "
              f"{samples / k / 1e6:.2f} Gsamples/s, "
              f"{8 * samples / k / 1e6:.1f} GB/s effective; plain "
              f"{p:.4f} ms = {samples / p / 1e6:.2f} Gsamples/s "
              f"[{card}]")

    del x

    # -- 8. 2D kernels vs plain over the grid -------------------------------
    from savgol_tpu_torch.ops import cuda_conv2d as c2
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

    # the main path: Savgol2D.apply, CONSTANT, method="auto" -> K2D-dense
    y2, launches2 = counted(lambda: f2.apply(img),
                            {"corr2d_valid": 1, "corr2d_sep": 0},
                            "Savgol2D.apply")
    y2_sep, launches_sep = counted(lambda: f2.apply(img, method="sep"),
                                   {"corr2d_valid": 0, "corr2d_sep": 1},
                                   "Savgol2D.apply(method='sep')")
    derived, launches_der = counted(
        lambda: {name: getattr(sgt, name)(img0, 5, 5, 3) for name in
                 ("savgol2d_gradient", "savgol2d_hessian",
                  "savgol2d_laplacian")},
        {"corr2d_valid": 3, "corr2d_sep": 0},
        "savgol2d_gradient + _hessian + _laplacian")
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
          f"apply {launches2}, apply(method='sep') {launches_sep}, "
          f"gradient + hessian + laplacian {launches_der}; max abs err "
          f"apply vs f64 {e_apply:.3e}, "
          f"method='sep' vs f64 {e_sep:.3e} (gate {F32_TOL_2D} x "
          f"{s_apply:.3f}); gradient/hessian/laplacian vs f64 scaled "
          + ", ".join(f"{e:.3e}" for e in e_derived.values())
          + f"; K2D-dense vs plain {kd_err:.3e}, K2D-sep vs plain "
          f"{ks_err:.3e} (rank {u2.shape[0]})")
    del y2, y2_sep, derived, ref2

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
            cuda_time_ms(lambda: c2.correlate2d_valid_cuda(img, w2, "edge")),
            cuda_time_ms(lambda: c2.correlate2d_valid_plain(img, w2, "edge"),
                         warmup=1, reps=5)),
        "K2D-dense K=3 (Hessian stack)": (
            cuda_time_ms(lambda: c2.correlate2d_valid_cuda(img, w3, "edge")),
            cuda_time_ms(lambda: c2.correlate2d_valid_plain(img, w3, "edge"),
                         warmup=1, reps=3)),
        "K2D-sep": (
            cuda_time_ms(lambda: c2.correlate2d_sep_cuda(img, u2, v2,
                                                         "edge")),
            cuda_time_ms(lambda: c2.correlate2d_sep_plain(img, u2, v2,
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
    for name, (k, p) in t2.items():
        print(f"time {name} {IMG_FULL} f32 11x11: kernel {k:.4f} ms = "
              f"{pix / k / 1e6:.2f} Gpix/s; plain {p:.4f} ms = "
              f"{pix / p / 1e6:.2f} Gpix/s [{card}]")

    kernels = [
        {"name": "sg1d_poly", "route": "cuda",
         "source": "savgol_tpu_torch/csrc/sg1d_poly.cu",
         "replaces": "savgol_tpu/ops/pallas_conv.py:564",
         "launches": launches["sg1d_poly"], "max_abs_err": k1_err,
         "ms": timings[("K1", B_FULL)][0],
         "plain_ms": timings[("K1", B_FULL)][1]},
        {"name": "corr1d_valid", "route": "cuda",
         "source": "savgol_tpu_torch/csrc/corr1d_valid.cu",
         "replaces": "savgol_tpu/ops/pallas_conv.py:1049",
         "launches": launches["corr1d_valid"], "max_abs_err": k3_err,
         "ms": timings[("K3", B_FULL)][0],
         "plain_ms": timings[("K3", B_FULL)][1]},
        {"name": "corr2d_valid", "route": "cuda",
         "source": "savgol_tpu_torch/csrc/corr2d_valid.cu",
         "replaces": "savgol_tpu/ops/pallas_conv.py:1501",
         "launches": launches2["corr2d_valid"], "max_abs_err": kd_err,
         "ms": t2["K2D-dense"][0], "plain_ms": t2["K2D-dense"][1]},
        {"name": "corr2d_sep", "route": "cuda",
         "source": "savgol_tpu_torch/csrc/corr2d_sep.cu",
         "replaces": "savgol_tpu/ops/pallas_conv.py:1814",
         "launches": launches_sep["corr2d_sep"], "max_abs_err": ks_err,
         "ms": t2["K2D-sep"][0], "plain_ms": t2["K2D-sep"][1]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
