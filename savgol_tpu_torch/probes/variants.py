"""Times design alternatives of seven kernels against the kernels as they
stand, in turns, in one process on the card:

    python -m savgol_tpu_torch.probes.variants [dense] [bf16] [k8a] [k11]
        [k8b] [sg1d] [sep] [census] [--root DIR] [--only NAME ...]
        [--dry-run]

Each alternative is this checkout's source with a few lines replaced
(``VARIANTS``; an edit may name a header the source includes): the exact
K2D-dense (``csrc/corr2d_valid.cu``) with four output rows a thread
instead of two, with and without a register cap that asks for three
blocks an SM, with two rows under that cap, and with every stencil width
on the runtime-width instance (no compile-time W); K2D-dense's bf16 mode
(``csrc/corr2d_bf16_mma.cu``) with the non-finite tile's branch taken
before the tensor-core products, and with no finiteness flag at all (the
kernel before the F11 repair); K8a (``csrc/plane_solve.cu``) with L in
shared memory at k = 15 in f32, and on its runtime instance only; K11
(``csrc/nonuniform.cu``) with L in registers to k = 6 and 8; K8b with L in
shared memory from k = 5; the bf16 1D tile (``csrc/sg1d_poly.cu``,
``csrc/sg1d_bf16.cuh``) with bf16 storage on the one-tile-a-block kernel
instead of the ``cp.async`` one, other register caps and 4096-output
tiles; K7 (``csrc/corr2d_sep.cu``) with every window on its
runtime-width sweep (no compile-time widths) or on its 64 x 64 tiles,
with rings past 113 KB on the tiles, with the runtime-width passes
unrolled less, without its L1 prefetch, with an L2 one, other register
caps and shorter bands. Attribution edits sit beside
them: K11's moment pass alone (the solve replaced by c = r) and its solve
alone (moments set from the centre sample, no tap loop), K8b's solve alone
(Gram and rhs made in registers, no plane loads), the bf16 1D tile with
its band products replaced by a copy (``stage_store``) or its device
loads by constants (``no_loads``), and K7 with its column pass cut to one
tap (``row_only``), its row pass to one group of four (``col_only``) or
both (``stage_store``): their outputs differ from the kernel's by design,
so no checksum holds them. Each is built with ``nvcc -shared -Xptxas -v``
with the package's own nvcc flags into ``build/variants/<kernel>/<name>/``,
loaded with ctypes, required to give the as-is build's checksum (the
alternatives compute the same sums in the same order), and timed with CUDA
events (L2 flushed; ``utils.timing.device_ms``) in four rounds whose
order alternates, at the paths' shapes: the 2D headline (16 x 2048^2,
11 x 11, 5 x 5, 15 x 15 and one 1 x 11 row, CONSTANT, one stencil and the
Hessian's three; K7 with the path's rank 2, the f32 stencils' noise ranks
6 and 7 at 11 x 11 to 15 x 15, the smoothing stencils' factors at every
square width 13-33 and at 17 x 25, and 11 x 11, 17 x 25, 27 x 27 and
33 x 33 in f64) and
K8a on the masked 2D slice's planes (1024^2; 11 x 11 order 3, k = 10;
3 x 11 order 4, k = 15), K11 at the nonuniform path's (8, 131,072), n =
12, m = 4, f32 and f64, K8b on the qr route's planes (8 x 131,072
positions, k = 5, f32 and f64 pairs), and the bf16 1D tile at the 1D
headline (128, 1,048,576), n = 12 (K1-bf16 both storages, K2-bf16
symmetric in bf16 and wrap in f32 storage). An alternative whose lines
the source no longer has is reported as stale and not built.

``census`` builds every source of the checkout to a cubin with ``-Xptxas
-v`` and reads ``cuobjdump -sass``: each kernel's registers, stack and
spill, its SASS instruction count and its DFMA, DADD, DMUL and HMMA
(tensor-core products). ``--root
DIR`` takes the sources (and the C signatures) of the checkout at DIR, so
that another tree's census is read with this script; the timed cases call
this checkout's entry points and edit its kernels. Prints one JSON
record: the card, each build's registers, stack and spill by kernel, and
each case's times (min, median, max). ``--only`` builds and times only the
named alternatives beside ``as_is``; ``--dry-run`` only applies the edits
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

_SG1D_BOUNDS = "(sg1b::kThreads, KC < 9 ? 5 : 4)"
_SEP_COL_ONE_TAP = ("  for (int i = 0; i < kQRS + H - 1; ++i) {",
                    "  for (int i = 0; i < kQRS; ++i) {")
_SEP_ROW_FOUR_TAPS = ("  for (int q = 0; q < (W + 3) / 4; ++q) {",
                      "  for (int q = 0; q < 1; ++q) {")

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
    # the bf16 1D tile on the tensor cores (sg1d_bf16.cuh): bf16 storage
    # without the cp.async instance (one tile a block, as f32 storage
    # runs), registers capped for 4 and for 6 blocks an SM, tiles of 4096
    # outputs; attribution: the band
    # products replaced by a copy of the staged samples (stage_store), the
    # device loads of the staging by constants (no_loads)
    "sg1d": ("sg1d_poly.cu", {
        "as_is": [],
        "no_async": [("    if constexpr (sizeof(In) == 2)",
                      "    if constexpr (false)")],
        "blocks_4": [(_SG1D_BOUNDS, "(sg1b::kThreads, 4)")],
        "blocks_6": [(_SG1D_BOUNDS, "(sg1b::kThreads, 6)")],
        "tile_4096": [("sg1d_bf16.cuh", "constexpr int kMT = 4;",
                       "constexpr int kMT = 2;")],
        "stage_store": [
            ("    sg1b::mma_tile<KC>(s.xs, s.taps, ws, s.ys);\n",
             "    for (int i = threadIdx.x; i < sg1b::kTile; "
             "i += sg1b::kThreads)\n      s.ys[i] = s.xs[i];\n"),
            ("      sg1b::mma_tile<KC>(s.xs[buf], s.taps, ws, s.ys);\n",
             "      for (int i = threadIdx.x; i < sg1b::kTile; "
             "i += sg1b::kThreads)\n        s.ys[i] = s.xs[buf][i];\n")],
        "no_loads": [
            ("sg1d_bf16.cuh", "      v = sgmma::load8(xrow + g);\n",
             "      v = make_uint4(0x3f803f80u, 0x3f803f80u, 0x3f803f80u, "
             "0x3f803f80u + static_cast<unsigned>(g & 63));\n"),
            ("sg1d_bf16.cuh",
             '      asm volatile("cp.async.cg.shared.global [%0], [%1], '
             '16;\\n"\n                   :: "r"(sgmma::smem_addr(dst)), '
             '"l"(xrow + g));\n',
             "      *reinterpret_cast<uint4*>(dst) = make_uint4(0x3f803f80u, "
             "0x3f803f80u, 0x3f803f80u, 0x3f803f80u + "
             "static_cast<unsigned>(g & 63));\n")],
    }),
    # K7's sweep: every stencil whose ring fits on the runtime-width sweep
    # (no compile-time widths), every stencil on the 64 x 64 tiles, rings
    # past 113 KB (one block an SM) on the tiles, the runtime-width passes
    # unrolled less (f64 spills 16 B), without
    # the L1 prefetch of the next chunk, with an L2 prefetch, every f32
    # width's registers capped for 3 and for 4 blocks an SM, bands of 8
    # chunks;
    # attribution: the column pass cut to one tap (row_only), the
    # row pass to one group of 4 taps (col_only), both (stage_store)
    "sep": ("corr2d_sep.cu", {
        "as_is": [],
        "runtime_width": [
            ("      case 11: case 19: case 21: case 23: case 25: case 27: "
             "case 29:\n      case 31: case 33:\n        return H;\n", "")],
        "tile": [("  if (sweep_smem<T>(H, W, rank) > kSweepSmemMax) return "
                  "kTileInstance;", "  return kTileInstance;")],
        "ring_113k": [("constexpr size_t kSweepSmemMax = 227 * 1024;",
                       "constexpr size_t kSweepSmemMax = 113 * 1024;")],
        "rt_row_unroll1": [("#pragma unroll 2\n  for (int q = 0; q < (W + 3) "
                            "/ 4; ++q) {", "#pragma unroll 1\n  for (int q "
                            "= 0; q < (W + 3) / 4; ++q) {")],
        "rt_col_unroll2": [("#pragma unroll 4\n  for (int y = 0; y < H; ++y)",
                            "#pragma unroll 2\n  for (int y = 0; y < H; "
                            "++y)")],
        "no_prefetch": [
            ("    if (c + 1 < nch)\n      prefetch_rows(",
             "    if (false)\n      prefetch_rows("),
            ("  prefetch_rows(img, R, C, r0 - oy + H - 1, kCH, c0 - ox, SW, "
             "mode);\n", "")],
        "prefetch_l2": [("prefetch.global.L1", "prefetch.global.L2")],
        "blocks_3": [("return sizeof(T) == 8 ? 2 : H <= 21 ? 4 : 3;",
                      "return sizeof(T) == 8 ? 2 : 3;")],
        "blocks_4": [("return sizeof(T) == 8 ? 2 : H <= 21 ? 4 : 3;",
                      "return sizeof(T) == 8 ? 2 : 4;")],
        "chunks_8": [("constexpr int kChunks = 16;",
                      "constexpr int kChunks = 8;")],
        "row_only": [_SEP_COL_ONE_TAP],
        "col_only": [_SEP_ROW_FOUR_TAPS],
        "stage_store": [_SEP_COL_ONE_TAP, _SEP_ROW_FOUR_TAPS],
    }),
}

# variants whose outputs differ from the kernel's by design
ATTRIBUTION = {"moments_only", "solve_only", "no_loads", "stage_store",
               "row_only", "col_only"}


def _edited(texts: dict, fname: str, edits) -> dict | None:
    """{file: text} with the edits applied, or None where a target is
    missing. An edit is (old, new) in the kernel's source ``fname`` or
    (file, old, new) in another file of ``texts`` (a header)."""
    texts = dict(texts)
    for edit in edits:
        f, old, new = edit if len(edit) == 3 else (fname, *edit)
        if old not in texts[f]:
            return None
        texts[f] = texts[f].replace(old, new)
    return texts


def sources(kernel: str, root: pathlib.Path = _OUT,
            csrc: pathlib.Path = _CSRC) -> tuple[dict, list]:
    """({variant: path of its edited source} under ``root``/kernel/, the
    variants whose edit targets the sources in ``csrc`` lack)."""
    fname, variants = VARIANTS[kernel]
    texts = {f.name: f.read_text() for f in csrc.glob("*.cuh")}
    texts[fname] = (csrc / fname).read_text()
    out, stale = {}, []
    for name, edits in variants.items():
        edited = _edited(texts, fname, edits)
        if edited is None:
            stale.append(name)
            continue
        d = root / kernel / name
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for f, text in edited.items():
            (d / f).write_text(text)
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
    "DMUL": n, "HMMA": n}} from ``cuobjdump -sass``."""
    from savgol_tpu_torch._build import _nvcc
    tool = pathlib.Path(_nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(cubin)], check=True,
                          capture_output=True, text=True).stdout
    out, fn = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1)
            out[fn] = {"sass": 0, "DFMA": 0, "DADD": 0, "DMUL": 0, "HMMA": 0}
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)",
                     line)
        if m and fn and m.group(1) != "NOP":
            out[fn]["sass"] += 1
            if m.group(1) in ("DFMA", "DADD", "DMUL", "HMMA"):
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
    from savgol_tpu_torch.utils.timing import device_ms
    times = {}
    for r in range(rounds):
        order = list(libs) if r % 2 == 0 else list(libs)[::-1]
        for name in order:
            for case, run in cases.items():
                times.setdefault(case, {}).setdefault(name, []).append(
                    device_ms(lambda: run(libs[name])))
    return {case: {name: [min(t), statistics.median(t), max(t)]
                   for name, t in by.items()} for case, by in times.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernels", nargs="*", default=list(VARIANTS))
    ap.add_argument("--root", default=str(_CSRC.parents[1]))
    ap.add_argument("--only", nargs="+", metavar="VARIANT",
                    help="build and time only these variants (and as_is)")
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
    from savgol_tpu_torch.ops import cuda_conv2d as c2
    from savgol_tpu_torch.ops.cuda_conv import bf16_taps
    from savgol_tpu_torch.ops.weights import savgol2d_weights_np
    from savgol_tpu_torch.probes.masked_ab import card
    from savgol_tpu_torch.scipy_compat import _compat_weights_np

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
        if args.only:
            paths = {n: p for n, p in paths.items()
                     if n == "as_is" or n in args.only}
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
        elif kernel == "sg1d":
            x1 = torch.randn(128, 1 << 20, generator=gen, device=dev)
            x1b = x1.to(torch.bfloat16)
            o1, o1b = torch.empty_like(x1), torch.empty_like(x1b)
            cw, ew = (bf16_taps(torch.from_numpy(a).to(dev, torch.float32))
                      .contiguous() for a in _compat_weights_np(12, 4, 0))

            def k1(x, out, storage):
                return lambda L: L.sg1d_poly_bf16(
                    x.data_ptr(), cw.data_ptr(), ew.data_ptr(),
                    out.data_ptr(), 128, 1 << 20, 12, 1.0, storage,
                    stream())

            def k2(x, out, storage, mode):
                return lambda L: L.sg1d_pad_bf16(
                    x.data_ptr(), cw.data_ptr(), out.data_ptr(), 128,
                    1 << 20, 12, mode, storage, stream())
            cases = {"K1-bf16 bf16": k1(x1b, o1b, 1),
                     "K1-bf16 f32 storage": k1(x1, o1, 0),
                     "K2-bf16 symmetric bf16": k2(x1b, o1b, 1, 2),
                     "K2-bf16 wrap f32 storage": k2(x1, o1, 0, 3)}
            same = {n: v for n, v in libs.items() if n not in ATTRIBUTION}
            checked(kernel, same, cases["K1-bf16 f32 storage"], o1)
            checked(kernel + " pad", same, cases["K2-bf16 wrap f32 storage"],
                    o1)
        elif kernel == "sep":
            from savgol_tpu_torch.ops.apply2d import _factors
            cases = {}
            img64 = img.double()
            out64 = torch.empty(16, 2048, 2048, device=dev,
                                dtype=torch.float64)
            # the path's widths (every square width method="auto" sends
            # here, 19-33, at its smoothing stencil's rank; f64 27 x 27 and
            # 33 x 33, whose rings pass 113 KB), and the widths of the
            # runtime-width sweep: 13 x 13 to 17 x 17 through
            # method="sep", 17 x 25 (rows x columns) a wide rectangular
            # window method="auto" sends here
            for nx, ny, m, dt in ((5, 5, 3, "f32"), (10, 10, 4, "f32"),
                                  (16, 16, 6, "f32"), (6, 6, 3, "f32"),
                                  (7, 7, 3, "f32"), (8, 8, 4, "f32"),
                                  (12, 8, 4, "f32"), (9, 9, 4, "f32"),
                                  (11, 11, 4, "f32"), (12, 12, 4, "f32"),
                                  (13, 13, 5, "f32"), (14, 14, 6, "f32"),
                                  (15, 15, 6, "f32"), (5, 5, 3, "f64"),
                                  (12, 8, 4, "f64"), (13, 13, 5, "f64"),
                                  (16, 16, 6, "f64")):
                f2 = sgt.Savgol2D.create(sgt.Savgol2DConfig(nx, ny, m),
                                         device=dev)
                ft = torch.float32 if dt == "f32" else torch.float64
                (u, v), = _factors(f2.weights, ft, dev)
                r, H, W = u.shape[0], u.shape[1], v.shape[1]
                xx, oo = (img, out3) if dt == "f32" else (img64, out64)
                tag = f"K7 {H}x{W} rank {r}" + ("" if dt == "f32" else
                                               " f64")
                cases[tag] = (
                    lambda u=u, v=v, r=r, H=H, W=W, xx=xx, oo=oo, dt=dt:
                    lambda L: getattr(L, f"corr2d_sep_{dt}")(
                        xx.data_ptr(), u.data_ptr(), v.data_ptr(),
                        oo.data_ptr(), 16, 2048, 2048, r, H, W, 1,
                        stream()))()
            # the ranks the float32 stencils' rounding noise gives at
            # _svd_stencil_np's default cutoff (11 x 11: 6, 13 x 13: 6,
            # 15 x 15: 7)
            for n in (5, 6, 7):
                wf = savgol2d_weights_np(sgt.Savgol2DConfig(n, n, 3),
                                         np.float64).astype(np.float32)
                uf, vf = (torch.from_numpy(a).to(dev, torch.float32) for a in
                          c2._svd_stencil_np(wf.astype(np.float64)))
                r, H = uf.shape
                cases[f"K7 {H}x{H} rank {r}"] = (
                    lambda uf=uf, vf=vf, r=r, H=H: lambda L: L.corr2d_sep_f32(
                        img.data_ptr(), uf.data_ptr(), vf.data_ptr(),
                        out3.data_ptr(), 16, 2048, 2048, r, H, H, 1,
                        stream()))()
            same = {n: v for n, v in libs.items() if n not in ATTRIBUTION}
            checked(kernel, same, cases["K7 33x33 rank 4"], out3)
            checked(kernel + " rank 2", same, cases["K7 11x11 rank 2"], out3)
            checked(kernel + " 17x25", same, cases["K7 17x25 rank 3"], out3)
            checked(kernel + " 17x25 f64", same,
                    cases["K7 17x25 rank 3 f64"], out64)
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
