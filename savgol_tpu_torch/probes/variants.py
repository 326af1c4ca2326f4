"""Times design alternatives of three kernels against the kernels as they
stand, in turns, in one process on the card:

    python -m savgol_tpu_torch.probes.variants [dense] [bf16] [k8a] [--dry-run]

Each alternative is this checkout's source with a few lines replaced
(``VARIANTS``): the exact K2D-dense (``csrc/corr2d_valid.cu``) with four
output rows a thread instead of two, with and without a register cap that
asks for three blocks an SM, with two rows under that cap, and with every
stencil width on the runtime-width instance (no compile-time W);
K2D-dense's bf16 mode (``csrc/corr2d_bf16_mma.cu``) with the
non-finite tile's branch taken before the tensor-core products, and with
no finiteness flag at all (the kernel before the F11 repair); K8a
(``csrc/plane_solve.cu``) with L in shared memory at k = 15 in f32, and on
its runtime instance only. Each is built with ``nvcc -shared -Xptxas -v``
with the package's own nvcc flags into ``build/variants/<kernel>/<name>/``,
loaded with ctypes, required to give the as-is build's checksum (the
alternatives compute the same sums in the same order), and timed with CUDA
events (L2 flushed) in four rounds whose order alternates, at the paths'
shapes: the 2D headline (16 x 2048^2, 11 x 11, 5 x 5, 15 x 15 and one
1 x 11 row,
CONSTANT, one stencil and the Hessian's three) and K8a on the masked 2D
slice's planes (1024^2; 11 x 11 order 3, k = 10; 3 x 11 order 4, k = 15).
An alternative whose lines this checkout no longer has is reported as
stale and not built. Prints one JSON record: the card, each build's
registers, stack and spill by kernel, and each case's times (min, median,
max). ``--dry-run`` only applies the edits (no card).
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
}


def sources(kernel: str, root: pathlib.Path = _OUT) -> tuple[dict, list]:
    """({variant: path of its edited source} under ``root``/kernel/, the
    variants whose edit targets this checkout's source lacks)."""
    fname, variants = VARIANTS[kernel]
    text = (_CSRC / fname).read_text()
    out, stale = {}, []
    for name, edits in variants.items():
        if not all(old in text for old, _ in edits):
            stale.append(name)
            continue
        d = root / kernel / name
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for header in _CSRC.glob("*.cuh"):
            shutil.copy(header, d)
        s = text
        for old, new in edits:
            s = s.replace(old, new)
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
    ap.add_argument("--dry-run", action="store_true")
    args = ap.parse_args()
    if args.dry_run:
        for kernel in args.kernels:
            paths, stale = sources(kernel)
            print(kernel, sorted(paths), "stale:", stale)
        return 0

    import numpy as np
    import torch
    import torch.nn.functional as F

    import savgol_tpu_torch as sgt
    from savgol_tpu_torch._build import _SIGNATURES
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
    record = {"card": card(), "ptxas": {}, "ms": {}, "sums": {}, "stale": {}}

    def checked(kernel, libs, run, out):
        for name, lib in libs.items():
            run(lib)
            record["sums"][f"{kernel} {name}"] = out.double().sum().item()
        want = record["sums"][f"{kernel} as_is"]
        for name in libs:
            if record["sums"][f"{kernel} {name}"] != want:
                raise SystemExit(f"{kernel}/{name}: checksum "
                                 f"{record['sums'][f'{kernel} {name}']!r} "
                                 f"!= as-is {want!r}")

    for kernel in args.kernels:
        paths, record["stale"][kernel] = sources(kernel)
        libs, regs = _build(paths, _SIGNATURES)
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
