"""Times design alternatives of nine kernels against the kernels as they
stand, in turns, in one process on the card:

    python -m savgol_tpu_torch.probes.variants [dense] [bf16] [k8a] [k11]
        [k8b] [sg1d] [sep] [k12] [k13] [census] [--root DIR]
        [--only NAME ...] [--dry-run]

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
unrolled less, with its input ring held to 1 stage (every chunk staged by
stage4, the sweep before the ring) or 2, with the ring at every f32 width
(no FMA cap), with chunks of 16 rows, other register caps and shorter
bands; K12 (``csrc/resample.cu``) with one, four or
eight rows a thread in its compile-time-m form and two in its runtime
one, blocks of 128 queries and no register cap; K13's stream route
(``csrc/halo_ring.cu``) with ``halo_send`` waiting 5 or 20 us on the SMs
before the stream's wait, and with 32-bit wait operations. Attribution
edits sit beside
them: K11's moment pass alone (the solve replaced by c = r) and its solve
alone (moments set from the centre sample, no tap loop), K8b's solve alone
(Gram and rhs made in registers, no plane loads), the bf16 1D tile with
its band products replaced by a copy (``stage_store``) or its device
loads by constants (``no_loads``), K12 with its plane loads replaced by
values made from the centre (``no_loads``) or every thread returning at
once (``empty``: the launch alone), K13's stream route without the
stream's wait (``no_wait``) or ``halo_recv``'s launch (``no_recv``) (and,
with exact outputs, without the watchdog's events, ``no_events``), and K7
with its column pass cut to one
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
symmetric in bf16 and wrap in f32 storage), and K12 at the resample row
(8 x 131,072 planes, 131,072 queries; m = 4, 7 and 9, B = 1, 8 and 17,
f32 and f64), and K13 in both harnesses of ``probes/halo_ab.py`` at its
1D headline and 2D rows halos: one process with four ring members on four
streams on the stream route (``device_ms``, every member's outputs checked
bit for bit but under the attribution edits), and
four spawned ranks that share the card, each loading every build and
timing it in turns on ``cuda_time_ms`` (``ms`` under ``k13 four ranks``,
the medians of four rounds by rank). An alternative whose lines
the source no longer has is reported as stale and not built.

``census`` builds every source of the checkout to a cubin with ``-Xptxas
-v`` and reads ``cuobjdump -sass``: each kernel's registers, stack and
spill, its SASS instruction count and its DFMA, DADD, DMUL and HMMA
(tensor-core products), and a digest of its SASS text, equal for two builds
that compiled to the same code. ``--root
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
import hashlib
import json
import os
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


def _k13_spin(ns: int) -> tuple:
    """K13's halo_send waiting at most ``ns`` on the SMs on the stream
    route."""
    return ("constexpr long long kStreamRouteSpinNs = 0;",
            f"constexpr long long kStreamRouteSpinNs = {ns};")


_SEP_COL_ONE_TAP = ("  for (int i = 0; i < kQRS + H - 1; ++i) {",
                    "  for (int i = 0; i < kQRS; ++i) {")
_SEP_ROW_FOUR_TAPS = ("  for (int q = 0; q < (W + 3) / 4; ++q) {",
                      "  for (int q = 0; q < 1; ++q) {")

# K7's ring with every stage copied row by row (no tensor-map boxes)
_SEP_NO_BOX = ("  if (box != nullptr && row0 >= 0", "  if (false && row0 >= 0")
# ... and without its copies (each stage's arrival announces no bytes, so
# the passes run on whatever the stages hold): the block's own work alone
_SEP_NO_COPIES = [
    _SEP_NO_BOX,
    ("    if (lane == 0) sgb::bar_arrive(bar, __popc(copied) * bytes);",
     "    if (lane == 0) sgb::bar_arrive(bar, 0u * copied * bytes);"),
    ("    if (gr >= 0) {\n      sgb::proxy_fence();",
     "    if (false) {\n      sgb::proxy_fence();")]
# K7 with its outputs computed and not stored (a store only of a value the
# sums never take keeps them live)
_SEP_NO_STORES = ("  if (ocol < Co) {",
                  "  if (ocol < Co && acc[0][0] == T(1.25e-30)) {")
_SEP_S1 = ("constexpr int kMaxStages = 3;", "constexpr int kMaxStages = 1;")

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
    # the exact 1D tile (sg1d_exact.cuh) of K1 / K2 (sg1d_poly.cu) and K3
    # (corr1d_valid.cu, "exact_valid"): see _EXACT
    "exact": ("sg1d_poly.cu", None),
    "exact_valid": ("corr1d_valid.cu", None),
    # K7's sweep: every stencil whose ring fits on the runtime-width sweep
    # (no compile-time widths), every stencil on the 64 x 64 tiles, rings
    # past 113 KB (one block an SM) on the tiles, the runtime-width passes
    # unrolled less (f64 spills 16 B), the input ring held to 1 stage
    # (stage4 and its L1 prefetch everywhere: the sweep before the ring)
    # and to 2, the ring at every f32 width (no FMA cap), chunks of 16 rows
    # (bands of 32 chunks, so still 512 rows; windows past 17 rows then
    # take the tiles), every f32 width's registers capped for 3 and for 4
    # blocks an SM, bands of 8 chunks, the ring's stages copied row by row
    # (no tensor-map boxes); attribution: the column pass cut to one tap
    # (row_only), the row pass to one group of 4 taps (col_only), both
    # (stage_store, and with 1 stage), the ring's copies left out
    # (no_copies), the stores left out (no_stores, and with 1 stage)
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
        "stages_1": [_SEP_S1],
        "stages_2": [("constexpr int kMaxStages = 3;",
                      "constexpr int kMaxStages = 2;")],
        "ring_wide": [("constexpr int kRingMaxFma = 144;",
                       "constexpr int kRingMaxFma = 1 << 20;")],
        "chunk_16": [("constexpr int kCH = 32;", "constexpr int kCH = 16;"),
                     ("constexpr int kChunks = 16;",
                      "constexpr int kChunks = 32;")],
        "blocks_3": [("return sizeof(T) == 8 ? 2 : H <= 21 ? 4 : 3;",
                      "return sizeof(T) == 8 ? 2 : 3;")],
        "blocks_4": [("return sizeof(T) == 8 ? 2 : H <= 21 ? 4 : 3;",
                      "return sizeof(T) == 8 ? 2 : 4;")],
        "chunks_8": [("constexpr int kChunks = 16;",
                      "constexpr int kChunks = 8;")],
        "row_only": [_SEP_COL_ONE_TAP],
        "col_only": [_SEP_ROW_FOUR_TAPS],
        "stage_store": [_SEP_COL_ONE_TAP, _SEP_ROW_FOUR_TAPS],
        "row_copies": [_SEP_NO_BOX],
        "no_copies": _SEP_NO_COPIES,
        "no_stores": [_SEP_NO_STORES],
        "stage_store_s1": [_SEP_COL_ONE_TAP, _SEP_ROW_FOUR_TAPS, _SEP_S1],
        "no_stores_s1": [_SEP_NO_STORES, _SEP_S1],
    }),
    # K12: rows a thread in the compile-time m form (1, 4, 8) and in the
    # runtime one (2), blocks of 128 queries, no register cap below 255
    # (one block an SM asked for); attribution: the plane loads replaced by
    # values made from the centre (no_loads), every thread returning at
    # once (empty: the launch and the grid alone)
    "k12": ("resample.cu", {
        "as_is": [],
        "fixed_rows_1": [("kFixedRows = 2;", "kFixedRows = 1;")],
        "fixed_rows_4": [("kFixedRows = 2;", "kFixedRows = 4;")],
        "fixed_rows_8": [("kFixedRows = 2;", "kFixedRows = 8;")],
        "runtime_rows_2": [("kRuntimeRows = 4;", "kRuntimeRows = 2;")],
        "block_128": [("constexpr int kBlock = 256;",
                       "constexpr int kBlock = 128;")],
        "bounds_1": [("__launch_bounds__(kBlock)",
                      "__launch_bounds__(kBlock, 1)")],
        "no_loads": [("        p[r][k] = b0 + r < B && k >= d ? at[k * ps] "
                      ": T(0);",
                      "        p[r][k] = T(k + 1) + T(c & 7);")],
        "empty": [("  if (q >= Nq) return;", "  if (q >= 0) return;")],
    }),
    # K13's stream route: halo_send waiting 5 us or 20 us on the SMs before
    # the stream's wait (one look as it is); a 32-bit wait operation;
    # attribution: without the watchdog's two events (no_events, exact),
    # without the stream's wait (no_wait) or halo_recv's launch (no_recv).
    # Timed in both harnesses of probes/halo_ab.py.
    "k13": ("halo_ring.cu", {
        "as_is": [],
        "spin_5us": [_k13_spin(5000)],
        "spin_20us": [_k13_spin(20000)],
        "wait32": [
            ("  op.waitValue.operation = CU_STREAM_MEM_OP_WAIT_VALUE_64;",
             "  op.waitValue.operation = CU_STREAM_MEM_OP_WAIT_VALUE_32;"),
            ("  op.waitValue.value64 = value;",
             "  op.waitValue.value = static_cast<cuuint32_t>(value);")],
        "no_events": [
            ("  if (err == cudaSuccess) err = cudaEventRecord(p.waiting, s);\n",
             ""),
            ("  if (err == cudaSuccess) err = cudaEventRecord(p.done, s);\n",
             ""),
            ("  dog.watch(p);\n", "")],
        "no_wait": [
            ("  const int r = batch(reinterpret_cast<CUstream>(s), ops, "
             "kWords);\n", "  const int r = 0;\n")],
        "no_recv": [
            ("  halo_recv_kernel<<<blocks, kThreads, 0, s>>>(\n"
             "      static_cast<const char*>(my_buf), static_cast<char*>"
             "(out_left),\n"
             "      static_cast<char*>(out_right), nbytes, slot(epoch, 0, "
             "stride),\n"
             "      slot(epoch, 1, stride), chunk_of(nbytes, blocks), epoch, "
             "target);\n", "")],
    }),
}

# variants whose outputs differ from the kernel's by design
ATTRIBUTION = {"moments_only", "solve_only", "no_loads", "stage_store",
               "row_only", "col_only", "empty", "no_taps",
               "no_store", "no_lds", "no_wait", "no_recv", "no_copies",
               "no_stores", "stage_store_s1", "no_stores_s1"}

_X = "sg1d_exact.cuh"
_EXACT_Q = "constexpr int kQF32 = 12;\nconstexpr int kQF64 = 10;"
_EXACT_BLOCKS = ("template <typename T> constexpr int kBlocks = "
                 "sizeof(T) == 4 ? 4 : 3;")
_EXACT_STORE = "    store_warps<T, Q>(t.orow + t.o0, ob, acc);\n"
# the group loop with a prefetch: the next group's taps and samples loaded
# before this group's FMAs
_EXACT_PREFETCH = [(_X, '// G groups of 4 taps, w[0, 4 G), on the window r = row[0, Q + 4); leaves r\n// = row[4 G, 4 G + Q + 4).\ntemplate <typename T, int Q, int G>\n__device__ __forceinline__ void groups(const T* __restrict__ row,\n                                       const T* __restrict__ w, T (&r)[Q + 4],\n                                       T (&acc)[Q]) {\n#pragma unroll\n  for (int g = 0; g < G; ++g) {\n    T wv[4];\n    load<T, 4>(w + 4 * g, wv);\n#pragma unroll\n    for (int kk = 0; kk < 4; ++kk)\n#pragma unroll\n      for (int j = 0; j < Q; ++j) acc[j] = madd(wv[kk], r[j + kk], acc[j]);\n#pragma unroll\n    for (int i = 0; i < Q; ++i) r[i] = r[i + 4];\n    load<T, 4>(row + 4 * g + Q + 4, r + Q);\n  }\n}',
                    "// G groups of 4 taps, w[0, 4 G), on the window r = row[0, Q + 4); leaves r\n// = row[4 G, 4 G + Q + 4). The next group's taps and samples are loaded\n// before this group's FMAs.\ntemplate <typename T, int Q, int G>\n__device__ __forceinline__ void groups(const T* __restrict__ row,\n                                       const T* __restrict__ w, T (&r)[Q + 4],\n                                       T (&acc)[Q]) {\n  if constexpr (G > 0) {\n    T wv[4];\n    load<T, 4>(w, wv);\n#pragma unroll\n    for (int g = 0; g < G; ++g) {\n      T wn[4], next[4];\n      if (g + 1 < G) load<T, 4>(w + 4 * g + 4, wn);\n      load<T, 4>(row + 4 * g + Q + 4, next);\n#pragma unroll\n      for (int kk = 0; kk < 4; ++kk)\n#pragma unroll\n        for (int j = 0; j < Q; ++j) acc[j] = madd(wv[kk], r[j + kk], acc[j]);\n#pragma unroll\n      for (int i = 0; i < Q; ++i) r[i] = r[i + 4];\n#pragma unroll\n      for (int i = 0; i < 4; ++i) r[Q + i] = next[i];\n      if (g + 1 < G) {\n#pragma unroll\n        for (int kk = 0; kk < 4; ++kk) wv[kk] = wn[kk];\n      }\n    }\n  }\n}")]


def _exact_q(q32: int, q64: int) -> list:
    """The exact tile with q outputs a thread (f32, f64)."""
    return [(_X, _EXACT_Q, f"constexpr int kQF32 = {q32};\n"
                           f"constexpr int kQF64 = {q64};")]


def _exact_variants(kernel_name: str) -> dict:
    """The exact 1D tile's alternatives, as edits of sg1d_exact.cuh and of
    the kernel's source: each thread's outputs stored straight from its
    registers (registers: 16-byte stores where the row is aligned, else one
    at a time), Q outputs a thread (f32 4 and 20, f64 6 and 14; each an odd
    multiple of 16 bytes), ring depth (f32 2 stages; 4 in f32 and 3 in
    f64), blocks an SM (register caps; none at all, or none in f32), every
    window on the runtime-width loop (runtime_width: no compile-time 101),
    an unrolled instance at 25 taps too (unrolled_25), the group loop with a
    prefetch of the next group's taps and samples (prefetch), each block
    walking one run of consecutive tiles as P1 does (walk_runs) instead of
    every G-th, blocks of 128 threads (half the tile) with a cap for twice
    the blocks, interior tiles staged by 16-byte cp.async from every thread
    instead of one bulk copy (cp_async); attribution: the taps replaced by a
    copy of the staged samples (no_taps), the stores by one store a block
    that keeps the sums live (no_store), the tap loop's shared loads by
    register arithmetic (no_lds: the taps w[0, 4) held in registers, each
    group's 4 new samples made from the window and the sums, so the FMAs
    run without shared memory)."""
    kernel = (f"  const auto kernel =\n      ws == 101 ? {kernel_name}<T, "
              f"101> : {kernel_name}<T, 0>;")
    taps = ("  taps<T, Q, WS>(st + Q * threadIdx.x, w, WS > 0 ? WS : a.ws, "
            "acc);\n")
    store = "  const long long lo = a.edge, hi = a.n_out - a.edge;"
    return {
        "as_is": [],
        "registers": [(_X, _EXACT_STORE,
                       "    T* const p = t.orow + t.o0 + Q * threadIdx.x;\n"
                       "    if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) {\n"
                       "      for (int c = 0; c < Q; c += vec<T>()) "
                       "store16(p + c, acc + c);\n"
                       "    } else {\n"
                       "      for (int c = 0; c < Q; ++c) p[c] = acc[c];\n"
                       "    }\n")],
        "q4": _exact_q(4, 10),
        "q20": _exact_q(20, 10),
        "f64_q6": _exact_q(12, 6),
        "f64_q14": _exact_q(12, 14),
        "stages_2_2": [(_X, "constexpr int kStagesF32 = 3;",
                        "constexpr int kStagesF32 = 2;")],
        "stages_4_3": [(_X, "constexpr int kStagesF32 = 3;\n"
                            "constexpr int kStagesF64 = 2;",
                        "constexpr int kStagesF32 = 4;\n"
                        "constexpr int kStagesF64 = 3;")],
        "blocks_3_2": [(_X, _EXACT_BLOCKS,
                        _EXACT_BLOCKS.replace("? 4 : 3", "? 3 : 2"))],
        "blocks_5_4": [(_X, _EXACT_BLOCKS,
                        _EXACT_BLOCKS.replace("? 4 : 3", "? 5 : 4"))],
        "blocks_6": [(_X, _EXACT_BLOCKS,
                      _EXACT_BLOCKS.replace("? 4 : 3", "? 6 : 3"))],
        "no_cap": [("__launch_bounds__(sgx::kThreads, sgx::kBlocks<T>)",
                    "__launch_bounds__(sgx::kThreads)")],
        "uncapped_f32": [(_X, _EXACT_BLOCKS,
                          _EXACT_BLOCKS.replace("? 4 : 3", "? 1 : 3"))],
        "runtime_width": [(kernel, f"  const auto kernel = "
                                   f"{kernel_name}<T, 0>;")],
        "unrolled_25": [(kernel, kernel.replace(
            "ws == 101", f"ws == 25 ? {kernel_name}<T, 25> : ws == 101"))],
        "prefetch": _EXACT_PREFETCH,
        "walk_runs": [
            (_X, "  const long long step = gridDim.x;\n",
             "  const long long per = (a.total + gridDim.x - 1) / gridDim.x;\n"
             "  const long long first = blockIdx.x * per, step = 1;\n"
             "  const long long end = min(first + per, a.total);\n"),
            (_X, "    const long long id = blockIdx.x + s * step;\n"
                 "    if (id < a.total) {",
             "    const long long id = first + s * step;\n"
             "    if (id < end) {"),
            (_X, "  for (long long id = blockIdx.x; id < a.total; id += step) {",
             "  for (long long id = first; id < end; id += step) {"),
            (_X, "    if (ahead < a.total) {", "    if (ahead < end) {")],
        "threads_128": [
            (_X, "constexpr int kThreads = 256;", "constexpr int kThreads = 128;"),
            (_X, _EXACT_BLOCKS, _EXACT_BLOCKS.replace("? 4 : 3", "? 8 : 6"))],
        "cp_async": _EXACT_CP_ASYNC,
        "no_taps": [(_X, taps, "  for (int j = 0; j < Q; ++j) "
                     "acc[j] = st[Q * threadIdx.x + j];\n")],
        "no_store": [(_X, store, "  {\n    T sum = T(0);\n"
                      "    for (int j = 0; j < Q; ++j) sum += acc[j];\n"
                      "    if (sum == T(1.25e-30)) t.orow[0] = sum;\n"
                      "    return;\n  }\n" + store)],
        "no_lds": [(_X, "    load<T, 4>(w + 4 * g, wv);\n",
                    "#pragma unroll\n    for (int kk = 0; kk < 4; ++kk) "
                    "wv[kk] = w[(4 * g + kk) & 3];\n"),
                   (_X, "    load<T, 4>(row + 4 * g + Q + 4, r + Q);\n",
                    "#pragma unroll\n    for (int i = 0; i < 4; ++i) "
                    "r[Q + i] = r[i] + acc[i];\n")],
    }


# interior tiles staged by 16-byte cp.async from every thread instead of one
# bulk copy (thread 0 arrives on the stage's barrier with no bytes)
_EXACT_CP_ASYNC = [
    (_X, "  if (in0 >= 0 && in0 + n <= N) {   // interior: one bulk copy\n"
         "    if (threadIdx.x == 0)\n"
         "      bulk_copy(st, xrow + in0, static_cast<unsigned>(n * "
         "sizeof(T)), bar);\n"
         "    return;\n"
         "  }\n",
     "  if (in0 >= 0 && in0 + n <= N) {   // interior: 16-byte copies\n"
     "    if (threadIdx.x == 0) bar_arrive(bar, 0);\n"
     "    for (int c = threadIdx.x; c < chunks; c += kThreads)\n"
     "      copy16(st + V * c, xrow + in0 + V * c);\n"
     "    return;\n"
     "  }\n")]

VARIANTS["exact"] = ("sg1d_poly.cu", _exact_variants("sg1d_poly_kernel"))
VARIANTS["exact_valid"] = ("corr1d_valid.cu",
                           _exact_variants("corr1d_valid_kernel"))


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
    "DMUL": n, "HMMA": n, "digest": the first 12 hex digits of the SHA-1 of
    its instructions' text, NOPs included, without addresses and
    encodings}} from ``cuobjdump -sass``: two builds of a kernel whose
    digests agree compiled to the same code."""
    from savgol_tpu_torch._build import _nvcc
    tool = pathlib.Path(_nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(cubin)], check=True,
                          capture_output=True, text=True).stdout
    out, fn, code = {}, None, {}
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1)
            out[fn] = {"sass": 0, "DFMA": 0, "DADD": 0, "DMUL": 0, "HMMA": 0}
            code[fn] = hashlib.sha1()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)",
                     line)
        if m and fn:
            code[fn].update(line.split("*/", 1)[1].split("/*")[0].strip()
                            .encode() + b"\n")
        if m and fn and m.group(1) != "NOP":
            out[fn]["sass"] += 1
            if m.group(1) in ("DFMA", "DADD", "DMUL", "HMMA"):
                out[fn][m.group(1)] += 1
    for f, h in code.items():
        out[f]["digest"] = h.hexdigest()[:12]
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


def k13_rank(paths: dict, reps: int = 20, rounds: int = 4) -> dict:
    """Harness (a) for the K13 builds, a rank's body: each build at
    ``paths`` loaded with the package's C signatures and put under
    ``ops.cuda_halo`` (the rings, made anew) and ``ops.cuda_conv`` (the
    launches, ``_enqueue``) in turn, one exchange at each of
    ``probes.halo_ab.HALOS`` timed on ``cuda_time_ms``, in ``rounds``
    rounds whose order alternates. {case: {build: [ms a round]}}."""
    import torch
    import torch.distributed as dist

    from savgol_tpu_torch import _build
    from savgol_tpu_torch.ops import cuda_conv as cc
    from savgol_tpu_torch.ops import cuda_halo as ch
    from savgol_tpu_torch.probes.halo_ab import HALOS
    from savgol_tpu_torch.utils.timing import cuda_time_ms

    libs = {}
    for name, path in paths.items():
        lib = libs[name] = ctypes.CDLL(path)
        for fn, args in _build._SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = args
                getattr(lib, fn).restype = ctypes.c_int
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(dist.get_rank())
    halos = {n: [torch.randn(s, generator=gen, device=dev) for _ in "th"]
             for n, s in HALOS.items()}
    times: dict = {}
    try:
        for r in range(rounds):
            for name in list(libs) if r % 2 == 0 else list(libs)[::-1]:
                torch.cuda.synchronize()
                ch.release()
                dist.barrier()
                ch.library = cc.library = lambda lib=libs[name]: lib
                for size, (t, h) in halos.items():
                    times.setdefault(f"K13 {size} four ranks", {}).setdefault(
                        name, []).append(cuda_time_ms(
                            lambda: ch.halo_exchange_cuda(t, h, dist.group.WORLD),
                            reps=reps))
    finally:
        torch.cuda.synchronize()
        ch.release()
        ch.library = cc.library = _build.library
        dist.barrier()
    return times


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

    if "k13" in kernels:
        # before this process's first CUDA call: four ring members on four
        # streams need a hardware queue each (halo_ab.py)
        os.environ["CUDA_DEVICE_MAX_CONNECTIONS"] = "32"
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
        elif kernel in ("exact", "exact_valid"):
            # the 1D headline (128, 1,048,576), scipy's windows of 25 and
            # 101 taps (order 4), f32 and f64
            cases, outs = {}, {}
            x1 = torch.randn(128, 1 << 20, generator=gen, device=dev)
            for dt, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
                xx = x1.to(dt)
                o = torch.empty_like(xx)
                outs[tag] = o
                for n in (12, 50):
                    cw, ew = (torch.from_numpy(a).to(dev, dt).contiguous()
                              for a in _compat_weights_np(n, 4, 0))
                    if kernel == "exact":
                        cases[f"K1 {tag} ws={2 * n + 1}"] = (
                            lambda xx=xx, o=o, cw=cw, ew=ew, n=n, tag=tag:
                            lambda L: getattr(L, f"sg1d_poly_{tag}")(
                                xx.data_ptr(), cw.data_ptr(), ew.data_ptr(),
                                o.data_ptr(), 128, 1 << 20, n, 1.0,
                                stream()))()
                        cases[f"K2 symmetric {tag} ws={2 * n + 1}"] = (
                            lambda xx=xx, o=o, cw=cw, n=n, tag=tag:
                            lambda L: getattr(L, f"sg1d_pad_{tag}")(
                                xx.data_ptr(), cw.data_ptr(), o.data_ptr(),
                                128, 1 << 20, n, 2, stream()))()
                    else:
                        cases[f"K3 {tag} ws={2 * n + 1}"] = (
                            lambda xx=xx, o=o, cw=cw, tag=tag:
                            lambda L: getattr(L, f"corr1d_valid_{tag}")(
                                xx.data_ptr(), cw.data_ptr(), o.data_ptr(),
                                128, 1 << 20, cw.numel(), stream()))()
            del x1
            same = {n: v for n, v in libs.items() if n not in ATTRIBUTION}
            for name, run in cases.items():
                checked(f"{kernel} {name}", same, run, outs[name.split()[-2]])
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
                # the headline's stencil also in VALID, whose ring rows
                # start at the strip's first input column (no offset)
                for mode in (1, 0) if tag == "K7 11x11 rank 2" else (1,):
                    cases[tag + ("" if mode else " valid")] = (
                        lambda u=u, v=v, r=r, H=H, W=W, xx=xx, oo=oo, dt=dt,
                        mode=mode: lambda L: getattr(L, f"corr2d_sep_{dt}")(
                            xx.data_ptr(), u.data_ptr(), v.data_ptr(),
                            oo.data_ptr(), 16, 2048, 2048, r, H, W, mode,
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
        elif kernel == "k13":
            from savgol_tpu_torch.parallel.launch import Pool
            from savgol_tpu_torch.probes.halo_ab import HALOS, Members
            # the ranks take the default hardware queues, as in chip_smoke.py
            os.environ.pop("CUDA_DEVICE_MAX_CONNECTIONS", None)
            with Pool(4, device="cuda") as pool:
                ranks = pool.run(k13_rank, {
                    n: str(p.with_suffix(".so")) for n, p in paths.items()})
            record["ms"]["k13 four ranks"] = {
                case: {name: [statistics.median(r[case][name]) for r in ranks]
                       for name in by} for case, by in ranks[0].items()}
            names = {id(lib): name for name, lib in libs.items()}
            keep = {}
            for size, shape in HALOS.items():
                for name, lib in libs.items():
                    m = keep[(name, size)] = Members(lib, shape,
                                                     route="stream")
                    for _ in range(3):
                        m.exchange()
                    if name not in ATTRIBUTION and not m.exact():
                        raise SystemExit(f"k13/{name} {size}: outputs are "
                                         "not the neighbours' slices")
            cases = {f"K13 {size} one process":
                     (lambda size: lambda L: keep[(names[id(L)],
                                                   size)].exchange())(size)
                     for size in HALOS}
        elif kernel == "k12":
            # the resample row: (8, 131,072) planes, 131,072 sorted queries
            # over the span of t, centres clamped to full windows of 25
            # (chip_smoke.py's nonuniform slice); random coefficients, s in
            # [4, 5), ok everywhere but a fifth
            N = 131_072
            t1 = torch.cumsum(torch.rand(N, generator=gen, device=dev)
                              + 0.5, 0)
            tq1 = torch.linspace(t1[0].item(), t1[-1].item(), N, device=dev)
            ctr = torch.clamp(torch.searchsorted(t1, tq1) - 12, 0,
                              N - 25) + 12
            cases, keep = {}, {}
            for m, B, dt in ((4, 8, torch.float32), (4, 17, torch.float32),
                             (4, 1, torch.float32), (7, 8, torch.float32),
                             (7, 1, torch.float32), (9, 8, torch.float32),
                             (9, 1, torch.float32), (4, 8, torch.float64),
                             (4, 1, torch.float64)):
                pl = torch.randn(m + 3, B, N, generator=gen, device=dev,
                                 dtype=dt)
                pl[m + 1] = pl[m + 1].abs() + 4
                pl[m + 2] = (pl[m + 2] > -0.8).to(dt)
                tt, tq = (v.to(dt) for v in (t1, tq1))
                o = torch.empty(B, N, device=dev, dtype=dt)
                tag = "f32" if dt == torch.float32 else "f64"
                name = f"K12 {tag} m={m} B={B}"
                keep[name] = (pl, tt, tq, o)
                cases[name] = (
                    lambda a=keep[name], tag=tag, m=m, B=B: lambda L: getattr(
                        L, f"resample_{tag}_t{tag[1:]}")(
                        a[0].data_ptr(), a[1].data_ptr(), ctr.data_ptr(),
                        a[2].data_ptr(), a[3].data_ptr(), B, N, N, m, 0,
                        0.0, stream()))()
            same = {n: v for n, v in libs.items() if n not in ATTRIBUTION}
            for name in ("K12 f32 m=4 B=8", "K12 f32 m=9 B=8",
                         "K12 f64 m=4 B=8"):
                checked(f"{kernel} {name}", same, cases[name],
                        keep[name][3])
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
