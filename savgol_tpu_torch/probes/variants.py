"""Times design alternatives of five kernels against the kernels as they
stand, in turns, in one process on the card:

    python -m savgol_tpu_torch.probes.variants [dense] [bf16] [k8a] [k11]
        [k8b] [census] [--root DIR] [--dry-run]

Each alternative is this checkout's source with a few lines replaced
(``VARIANTS``): the exact K2D-dense (``csrc/corr2d_valid.cu``) with four
output rows a thread instead of two, with and without a register cap that
asks for three blocks an SM, with two rows under that cap, and with every
stencil width on the runtime-width instance (no compile-time W);
K2D-dense's bf16 mode (``csrc/corr2d_bf16_mma.cu``) with the
non-finite tile's branch taken before the tensor-core products, and with
no finiteness flag at all (the kernel before the F11 repair); K8a
(``csrc/plane_solve.cu``) with L in shared memory at k = 15 in f32, and on
its runtime instance only; K11 (``csrc/nonuniform.cu``) with its moment
pass alone (the solve replaced by c = r) and with its solve alone (moments
set from the centre sample, no tap loop), and K8b (the double-word
``plane_solve_dd_*`` of ``plane_solve.cu``) with its solve alone (Gram and
rhs made in registers, no plane loads). Those three are attribution, not
alternatives: their outputs differ from the kernel's by design, so no
checksum holds them. Each is built with ``nvcc -shared -Xptxas -v``
with the package's own nvcc flags into ``build/variants/<kernel>/<name>/``,
loaded with ctypes, required to give the as-is build's checksum (the
alternatives compute the same sums in the same order), and timed with CUDA
events (L2 flushed) in four rounds whose order alternates, at the paths'
shapes: the 2D headline (16 x 2048^2, 11 x 11, 5 x 5, 15 x 15 and one
1 x 11 row,
CONSTANT, one stencil and the Hessian's three) and K8a on the masked 2D
slice's planes (1024^2; 11 x 11 order 3, k = 10; 3 x 11 order 4, k = 15),
K11 at the nonuniform path's (8, 131,072), n = 12, m = 4, f32 and f64, and
K8b on the qr route's planes (8 x 131,072 positions, k = 5, f32 and f64
pairs). An alternative whose lines the source no longer has is reported
as stale and not built.

``census`` builds every source of the checkout to a cubin with ``-Xptxas
-v`` and reads ``cuobjdump -sass``: each kernel's registers, stack and
spill, its SASS instruction count and its DFMA, DADD and DMUL. ``--root
DIR`` takes the sources (and the C signatures) of the checkout at DIR, so
that another tree's census is read with this script; the timed cases call
this checkout's entry points and edit its kernels. Prints one JSON
record: the card, each build's registers, stack and spill by kernel, and
each case's times (min, median, max). ``--dry-run`` only applies the edits
(no card).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import shutil
import statistics
import subprocess

_CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
_OUT = pathlib.Path(__file__).resolve().parents[2] / "build" / "variants"

_DENSE_CAP = ("__global__ void __launch_bounds__(kThreadsD)\n"
              "corr2d_valid_kernel")


def _cap(blocks: int):
    """The f32 instances asked to fit `blocks` blocks an SM (a register
    cap); f64 left as it is."""
    return [(_DENSE_CAP, _DENSE_CAP.replace(
        "(kThreadsD)", f"(kThreadsD, sizeof(T) == 4 ? {blocks} : 1)"))]


_ROWS4 = [("constexpr int kQR = 2; ", "constexpr int kQR = 4; ")]
_WIDTHS = "".join(
    f"    case {w}: return run<T, {w}>(x, w, out, B, r, c, Ro, Co, k, h, wd, "
    "mode, s);\n" for w in (3, 5, 7, 9, 11, 13, 15, 17))

VARIANTS = {
    "dense": ("corr2d_valid.cu", {
        "as_is": [],
        "rows4": _ROWS4,
        "rows4_3blocks": _ROWS4 + _cap(3),
        "rows2_3blocks": _cap(3),
        "runtime_width": [(_WIDTHS, "")],
    }),
    "bf16": ("corr2d_bf16_mma.cu", {
        "as_is": [],
        "branch_first": [
            ("  if (__syncthreads_or(bad))\n"
             "    window_tile(xs, w, out, b, r0, c0, Ro, Co, K, H, W, L);\n",
             ""),
            ("  for (int i = threadIdx.x; i < H * 16 * L.SB / 8; i += kThreadsM)"
             "\n    reinterpret_cast<uint4*>(bands)[i] = make_uint4(0u, 0u, 0u, "
             "0u);\n",
             "  if (__syncthreads_or(bad)) {\n"
             "    window_tile(xs, w, out, b, r0, c0, Ro, Co, K, H, W, L);\n"
             "    return;\n  }\n"
             "  for (int i = threadIdx.x; i < H * 16 * L.SB / 8; i += kThreadsM)"
             "\n    reinterpret_cast<uint4*>(bands)[i] = make_uint4(0u, 0u, 0u, "
             "0u);\n")],
        "no_flag": [
            ("  if (__syncthreads_or(bad))\n"
             "    window_tile(xs, w, out, b, r0, c0, Ro, Co, K, H, W, L);\n",
             "  (void)bad;\n")],
    }),
    "k8a": ("plane_solve.cu", {
        "as_is": [],
        "l_shared_at_15": [("shared_l = K > 10 && sizeof(T) == 8;",
                            "shared_l = K > 10;")],
        "runtime_only": [("  if (k == 10) return run_fixed<T, 10>(a, s);\n"
                          "  if (k == 15) return run_fixed<T, 15>(a, s);\n",
                          "")],
    }),
    # K11 and K8b: L's place at the compile-time instances, and attribution
    "k11": ("nonuniform.cu", {
        "as_is": [],
        "l_regs_to_6": [("constexpr int kNonuniRegsK = 4;",
                         "constexpr int kNonuniRegsK = 6;")],
        "l_regs_to_8": [("constexpr int kNonuniRegsK = 4;",
                         "constexpr int kNonuniRegsK = 8;")],
        # the solve replaced by c = r, every moment kept alive by one
        # product with 0 added to c_0
        "moments_only": [
            ("        const bool ok = dd_chol_solve<K>(K, quorum, true, "
             "sqrt_rcond, wk);\n",
             "#pragma unroll\n"
             "        for (int q = 0; q < 2 * K - 1; ++q)\n"
             "          wk.vh[0] += 0.0 * (wk.sh[q] + wk.sl[q]);\n"
             "        const bool ok = quorum;\n")],
        "solve_only": [
            ("        window_moments<K>(K, ws, tt, xt, wt, tc, sinv, wk.sh, "
             "wk.sl, wk.vh,\n                          wk.vl);\n",
             "#pragma unroll\n"
             "        for (int q = 0; q < 2 * K - 1; ++q) {\n"
             "          wk.sh[q] = static_cast<double>(wt[n]) / (q + 1);\n"
             "          wk.sl[q] = 0.0;\n"
             "          if (q < K) {\n"
             "            wk.vh[q] = xt[n] + q;\n"
             "            wk.vl[q] = 0.0;\n"
             "          }\n"
             "        }\n")],
    }),
    "k8b": ("plane_solve.cu", {
        "as_is": [],
        "l_shared_from_5": [("shared_l = sizeof(T) == 8 && K > 7;",
                             "shared_l = K > 4;")],
        "no_loads": [
            ("      const long long src = plane_of[e] * a.pos + p;\n"
             "      wk.lh[e] = a.ghi[src];\n"
             "      wk.ll[e] = a.glo[src];\n",
             "      wk.lh[e] = ([](int f) { int i = 0; while (tri(i + 1, 0) "
             "<= f) ++i; return f == tri(i, i); }(e) ? 4.0 : 0.0) + 1.0 / "
             "(e + 2) + 1e-9 * p;\n"
             "      wk.ll[e] = 0.0;\n"),
            ("      wk.vh[i] = a.rhi[i * a.pos + p];\n"
             "      wk.vl[i] = a.rlo[i * a.pos + p];\n",
             "      wk.vh[i] = i + 1e-9 * p;\n"
             "      wk.vl[i] = 0.0;\n")],
    }),
}

# variants whose outputs differ from the kernel's by design
ATTRIBUTION = {"moments_only", "solve_only", "no_loads"}


def _edited(text: str, edits) -> str | None:
    """``text`` with the edits applied, or None where a target is missing."""
    if not all(old in text for old, _ in edits):
        return None
    for old, new in edits:
        text = text.replace(old, new)
    return text


def sources(kernel: str, root: pathlib.Path = _OUT,
            csrc: pathlib.Path = _CSRC) -> tuple[dict, list]:
    """({variant: path of its edited source} under ``root``/kernel/, the
    variants whose edit targets the source in ``csrc`` lacks)."""
    fname, variants = VARIANTS[kernel]
    text = (csrc / fname).read_text()
    out, stale = {}, []
    for name, edits in variants.items():
        s = _edited(text, edits)
        if s is None:
            stale.append(name)
            continue
        d = root / kernel / name
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for header in csrc.glob("*.cuh"):
            shutil.copy(header, d)
        (d / fname).write_text(s)
        out[name] = d / fname
    return out, stale


def _build(paths: dict, signatures: dict) -> tuple[dict, dict]:
    """(libraries, ptxas summary by variant), all built in parallel."""
    from savgol_tpu_torch._build import _FLAGS, _nvcc
    procs = {
        name: subprocess.Popen(
            [_nvcc(), *_FLAGS, "-shared", "-Xptxas", "-v", str(p), "-o",
             str(p.with_suffix(".so"))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, p in paths.items()}
    libs, regs = {}, {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{out[-4000:]}")
        regs[name] = _ptxas(out)
        lib = ctypes.CDLL(str(paths[name].with_suffix(".so")))
        for fn, args in signatures.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = args
                getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs, regs


def _ptxas(text: str) -> dict:
    """{kernel: 'R regs, S B stack, P B spill'} from nvcc -Xptxas -v."""
    out, fn, frame = {}, None, ""
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(.*?)'", line)
        if m:
            fn = subprocess.run(["c++filt"], input=m.group(1),
                                capture_output=True, text=True).stdout
            fn = fn.replace("(anonymous namespace)::", "").replace(
                "void ", "").strip().split("(")[0]
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                      line)
        if m:
            frame = f"{m.group(1)} B stack, {m.group(2)} B spill"
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out[fn] = f"{m.group(1)} regs, {frame}"
    return out


def _sass(cubin: pathlib.Path) -> dict:
    """{kernel: {"sass": instructions but NOPs, "DFMA": n, "DADD": n,
    "DMUL": n}} from ``cuobjdump -sass``."""
    from savgol_tpu_torch._build import _nvcc
    tool = pathlib.Path(_nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(cubin)], check=True,
                          capture_output=True, text=True).stdout
    out, fn = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1)
            out[fn] = {"sass": 0, "DFMA": 0, "DADD": 0, "DMUL": 0}
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)",
                     line)
        if m and fn and m.group(1) != "NOP":
            out[fn]["sass"] += 1
            if m.group(1) in ("DFMA", "DADD", "DMUL"):
                out[fn][m.group(1)] += 1
    names = subprocess.run(["c++filt"], input="\n".join(out),
                           capture_output=True, text=True).stdout.split("\n")
    return {n.replace("(anonymous namespace)::", "").replace(
        "void ", "").strip().split("(")[0]: v
        for n, v in zip(names, out.values())}


def census(csrc: pathlib.Path, out: pathlib.Path) -> dict:
    """Every source of ``csrc`` built to a cubin (in parallel): {source:
    {kernel: registers, stack, spill, SASS counts}}."""
    from savgol_tpu_torch._build import _FLAGS, _nvcc
    out.mkdir(parents=True, exist_ok=True)
    procs = {
        src.name: subprocess.Popen(
            [_nvcc(), *_FLAGS, "-cubin", "-Xptxas", "-v", str(src), "-o",
             str(out / (src.stem + ".cubin"))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src in sorted(csrc.glob("*.cu"))}
    record = {}
    for name, proc in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{text[-4000:]}")
        frames = _ptxas(text)
        counts = _sass(out / (pathlib.Path(name).stem + ".cubin"))
        record[name] = {fn: f"{frames.get(fn, '?')}, " + ", ".join(
            f"{k} {v}" for k, v in c.items()) for fn, c in counts.items()}
    return record


def _signatures(root: pathlib.Path) -> dict:
    """The C signatures of the checkout at ``root`` (its ``_build.py``)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "_variants_build", root / "savgol_tpu_torch" / "_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._SIGNATURES


def _in_turns(cases: dict, libs: dict, rounds: int = 4) -> dict:
    from savgol_tpu_torch.utils.timing import cuda_time_ms
    times = {}
    for r in range(rounds):
        order = list(libs) if r % 2 == 0 else list(libs)[::-1]
        for name in order:
            for case, run in cases.items():
                times.setdefault(case, {}).setdefault(name, []).append(
                    cuda_time_ms(lambda: run(libs[name])))
    return {case: {name: [min(t), statistics.median(t), max(t)]
                   for name, t in by.items()} for case, by in times.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernels", nargs="*", default=list(VARIANTS))
    ap.add_argument("--root", default=str(_CSRC.parents[1]))
    ap.add_argument("--dry-run", action="store_true")
    args = ap.parse_args()
    root = pathlib.Path(args.root).resolve()
    csrc = root / "savgol_tpu_torch" / "csrc"
    out_root = _OUT / ("this" if root == _CSRC.parents[1] else root.name)
    kernels = [k for k in args.kernels if k != "census"]
    if args.dry_run:
        for kernel in kernels:
            paths, stale = sources(kernel, out_root, csrc)
            print(kernel, sorted(paths), "stale:", stale)
        return 0

    import numpy as np
    import torch
    import torch.nn.functional as F

    import savgol_tpu_torch as sgt
    from savgol_tpu_torch.ops import lsq
    from savgol_tpu_torch.ops import masked as mk
    from savgol_tpu_torch.ops.cuda_conv import bf16_taps
    from savgol_tpu_torch.ops.weights import savgol2d_weights_np
    from savgol_tpu_torch.probes.masked_ab import card

    if not torch.cuda.is_available():
        raise SystemExit("variants needs a CUDA device")
    dev = torch.device("cuda")

    def stream():
        return torch.cuda.current_stream().cuda_stream

    gen = torch.Generator(device=dev).manual_seed(1010)
    img = torch.randn(16, 2048, 2048, generator=gen, device=dev)
    w1 = torch.from_numpy(savgol2d_weights_np(sgt.Savgol2DConfig(5, 5, 3),
                                              np.float64)).to(dev,
                                                              torch.float32)
    w3 = torch.from_numpy(np.stack([savgol2d_weights_np(
        sgt.Savgol2DConfig(5, 5, 3, deriv_x=dx, deriv_y=dy), np.float64)
        for dx, dy in ((2, 0), (1, 1), (0, 2))])).to(dev, torch.float32)
    out3 = torch.empty(16, 3, 2048, 2048, device=dev)
    record = {"card": card(), "root": str(root), "ptxas": {}, "ms": {},
              "sums": {}, "stale": {}}
    if "census" in args.kernels:
        record["census"] = census(csrc, out_root / "census")
    signatures = _signatures(root)

    def checked(kernel, libs, run, out):
        for name, lib in libs.items():
            run(lib)
            record["sums"][f"{kernel} {name}"] = out.double().nan_to_num(
                ).sum().item()
        want = record["sums"][f"{kernel} as_is"]
        for name in libs:
            if record["sums"][f"{kernel} {name}"] != want:
                raise SystemExit(f"{kernel}/{name}: checksum "
                                 f"{record['sums'][f'{kernel} {name}']!r} "
                                 f"!= as-is {want!r}")

    for kernel in kernels:
        paths, record["stale"][kernel] = sources(kernel, out_root, csrc)
        libs, regs = _build(paths, signatures)
        record["ptxas"][kernel] = regs
        if kernel == "dense":
            row = w1[5:6].contiguous()

            w5, w15 = (torch.from_numpy(savgol2d_weights_np(
                sgt.Savgol2DConfig(n, n, 3), np.float64)).to(dev,
                                                             torch.float32)
                for n in (2, 7))

            def dense(w, K, H, W=11):
                return lambda L: L.corr2d_valid_f32(
                    img.data_ptr(), w.data_ptr(), out3.data_ptr(), 16, 2048,
                    2048, K, H, W, 1, stream())
            cases = {"11x11 K=1": dense(w1, 1, 11),
                     "11x11 K=3": dense(w3, 3, 11), "1x11": dense(row, 1, 1),
                     "5x5 K=1": dense(w5, 1, 5, 5),
                     "15x15 K=1": dense(w15, 1, 15, 15)}
            checked(kernel, libs, cases["11x11 K=3"], out3)
            checked(kernel, libs, cases["5x5 K=1"], out3)
        elif kernel == "bf16":
            imgb = img.to(torch.bfloat16)
            outb = torch.empty(out3.shape, device=dev, dtype=torch.bfloat16)
            t1, t3 = bf16_taps(w1).contiguous(), bf16_taps(w3).contiguous()

            def bf16(x, w, K, out, storage):
                return lambda L: L.corr2d_valid_bf16(
                    x.data_ptr(), w.data_ptr(), out.data_ptr(), 16, 2048, 2048,
                    K, 11, 11, 1, storage, stream())
            cases = {"K=1 bf16": bf16(imgb, t1, 1, outb, 1),
                     "K=3 bf16": bf16(imgb, t3, 3, outb, 1),
                     "K=1 f32 storage": bf16(img, t1, 1, out3, 0),
                     "K=3 f32 storage": bf16(img, t3, 3, out3, 0)}
            checked(kernel, libs, cases["K=3 f32 storage"], out3)
        elif kernel == "k11":
            cases = {}
            gen.manual_seed(1004)
            tn = torch.cumsum(torch.rand((8, 131_072), generator=gen,
                                         device=dev) + 0.5, -1)
            xn = torch.randn((8, 131_072), generator=gen, device=dev)
            outs = {}
            for dt, tag, m in ((torch.float32, "f32", 4),
                               (torch.float64, "f64", 4),
                               (torch.float32, "f32", 7)):
                x, t = xn.to(dt), tn.to(dt)
                w, o = torch.ones_like(x), torch.empty_like(x)
                outs[tag, m] = (x, t, w, o)
                cases[f"K11 {tag} (8, 131072) n=12 m={m}"] = (
                    lambda x=x, t=t, w=w, o=o, tag=tag, m=m: lambda L: getattr(
                        L, f"nonuniform_{tag}_t{tag[1:]}")(
                        x.data_ptr(), w.data_ptr(), t.data_ptr(),
                        o.data_ptr(), 8, 131_072, 131_072, 12, m, 0, m + 1,
                        0.0, 1e-6, 0, None, 0, stream()))()
            same = {n: v for n, v in libs.items() if n not in ATTRIBUTION}
            checked(kernel, same, cases["K11 f32 (8, 131072) n=12 m=4"],
                    outs["f32", 4][3])
            checked(kernel + " m=7", same,
                    cases["K11 f32 (8, 131072) n=12 m=7"], outs["f32", 7][3])
        elif kernel == "k8b":
            rng = np.random.default_rng(1002)
            xq = torch.from_numpy(rng.standard_normal((8, 131_072)).astype(
                np.float32)).to(dev)
            vq = torch.from_numpy(rng.random((8, 131_072)) >= 0.2).to(dev)
            cases, keep = {}, []
            for dt, tag, m in ((torch.float32, "f32", 4),
                               (torch.float64, "f64", 4),
                               (torch.float32, "f32", 7),
                               (torch.float64, "f64", 7)):
                Q, _, pair_w, pair_index = mk._masked_tables(12, m)
                pit = torch.from_numpy(np.ascontiguousarray(
                    pair_index.astype(np.int32))).to(dev)
                xzp = F.pad(torch.where(vq, xq, 0.0), (12, 12)).to(dt)
                wp = F.pad(vq.float(), (12, 12)).to(dt)
                ghi, glo = lsq.correlate_valid_dd(wp, pair_w)
                rhi, rlo = lsq.correlate_valid_dd(xzp, Q.T)
                q = (ghi[int(pair_index[0, 0])] * 25 >= m + 0.5).contiguous()
                co = torch.empty_like(rhi)
                ok = torch.empty(q.shape, dtype=torch.bool, device=dev)
                keep.append((ghi, glo, rhi, rlo, q, co, ok, pit))
                cases[f"K8b {tag} pairs k={m + 1} 8x131072"] = (
                    lambda a=keep[-1], tag=tag, k=m + 1: lambda L: getattr(
                        L, f"plane_solve_dd_{tag}")(
                        *[v.data_ptr() for v in a[:5]], a[7].data_ptr(),
                        a[5].data_ptr(), a[6].data_ptr(), k, a[4].numel(),
                        1, 1e-3, None, 0, 0, stream()))()
            same = {n: v for n, v in libs.items() if n not in ATTRIBUTION}
            checked(kernel, same, cases["K8b f32 pairs k=5 8x131072"],
                    keep[0][5])
            checked(kernel + " k=8", same,
                    cases["K8b f32 pairs k=8 8x131072"], keep[2][5])
        else:
            rng = np.random.default_rng(1003)
            im = torch.from_numpy(rng.standard_normal((1024, 1024)).astype(
                np.float32)).to(dev)
            valid = torch.from_numpy(rng.random((1024, 1024)) >= 0.2).to(dev)
            cases, keep = {}, []
            for nx, ny, m in ((5, 5, 3), (1, 5, 4)):
                Q, _, pw, pi, _ = mk._masked_tables_2d(nx, ny, m)
                P, area = Q.shape[0], (2 * nx + 1) * (2 * ny + 1)
                xv = F.pad(torch.where(valid, im, 0.0), (nx, nx, ny, ny))
                wp = F.pad(valid.float(), (nx, nx, ny, ny))
                g, r = mk._corr2d_bank(wp, pw, True), mk._corr2d_bank(xv, Q,
                                                                      True)
                q = (g[int(pi[0, 0])] * area >= P - 0.5).contiguous()
                pit = torch.from_numpy(np.ascontiguousarray(
                    pi.astype(np.int32))).to(dev)
                co = torch.empty_like(r)
                ok = torch.empty(q.shape, dtype=torch.bool, device=dev)
                keep += [g, r, q, pit, co, ok]
                cases[f"{2 * nx + 1}x{2 * ny + 1} k={P}"] = (
                    lambda g=g, r=r, q=q, pit=pit, co=co, ok=ok, P=P:
                    lambda L: L.plane_solve_f32(
                        g.data_ptr(), r.data_ptr(), q.data_ptr(),
                        pit.data_ptr(), co.data_ptr(), ok.data_ptr(), P,
                        q.numel(), 1, 1e-3, None, 0, stream()))()
            checked(kernel, libs, cases["3x11 k=15"], keep[-2])
        record["ms"][kernel] = _in_turns(cases, libs)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
