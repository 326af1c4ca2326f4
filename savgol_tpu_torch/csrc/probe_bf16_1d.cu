// P3: attribution probes of K3-bf16 on bf16 storage (corr1d_valid.cu's
// corr1d_bf16_async_kernel, the VALID 1D correlation on the tensor-core
// tile of sg1d_bf16.cuh). Each variant is that kernel with one cost term
// removed: the same schedule (persistent blocks walking over the tiles of
// kTile = 8192 outputs, two staging buffers, the next tile's cp.async
// copies in flight while this one is computed and stored) built from the
// same pieces (stage_taps, first_output, start_copies, landed, mma_tile,
// store_tile), so the differences of their times split K3-bf16's:
//
//   copy       stage the tile's own samples, no halo, and write them back
//              through store_tile: out[j] = x[j], 0 <= j < N. The ring's
//              device-memory bytes and the store path; no products.
//   shift_only stage the tile and its halo as K3-bf16 does and write
//              out[j] = x[j + n] over the VALID length N - ws + 1
//              (n = ws / 2) straight from the staging buffer: the staging,
//              the halo and the shifted stores; no mma.sync.
//   taps_only  K3-bf16's mma_tile and its round trip through ys with the
//              halo not loaded from device memory: the halo slots hold the
//              tile's own first samples, so
//                out[j] = sum_k w[k] * x[t0 + ((j - t0 + k) mod kTile)]
//              (t0 the tile's first output, samples past N zero). Wrong
//              values by design and the right cost, as the TPU probe's
//              mm_only.
//
// So K3-bf16 - taps_only is the halo's loads, taps_only - shift_only the
// products and the round trip through ys, shift_only - copy the halo and
// the shifted stores, and copy against the bytes' bound the ring's floor.
//
// Rows start on 16-byte boundaries (N % 8 == 0, an aligned base; the
// wrapper checks, and this entry refuses others), so first_output puts
// tile t of every row at t kTile and a row has ceil(n_out / kTile) tiles.
// The input is finite: a tile's non-finite flag is computed and waited
// for as in K3-bf16, but no tile is sent to window_tile.
//
// They replace the TPU probes of benchmarks/probe_bf16_1d.py: copy_kernel
// [pl.pallas_call :152], shift_only_kernel [:135] and mm_only_kernel [:119]
// (the banded matmuls without the slab concat). The TPU split a tile's cost
// into matrix-unit work and lane relayouts; here it splits into the ring's
// bytes, the halo's staging and stores, the tensor-core products and the
// halo's loads.
#include <stdint.h>

#include "sg1d_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;

enum Variant : int { kCopy = 0, kShiftOnly = 1, kTapsOnly = 2 };

template <int V, int KC>
__global__ void __launch_bounds__(sg1b::kThreads, 3)
probe_kernel(const bf16* __restrict__ x, const float* __restrict__ w,
             bf16* __restrict__ out, long long N, long long n_out,
             long long tiles, long long total, int ws) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto& s = *reinterpret_cast<sg1b::AsyncSmem<KC>*>(smem);
  constexpr int kStagedUnits = sg1b::AsyncSmem<KC>::kStaged / 8;
  constexpr int kTileUnits = sg1b::kTile / 8;
  // shift_only stages the halo as K3-bf16 does; the others only the tile
  constexpr int kUnits = V == kShiftOnly ? kStagedUnits : kTileUnits;
  if (V == kTapsOnly) sg1b::stage_taps<KC>(w, ws, s.taps);
  long long id = blockIdx.x;
  if (id < total) {
    const bf16* xrow = x + id / tiles * N;
    sg1b::start_copies(xrow, N, sg1b::first_output(xrow, 0, id % tiles),
                       kUnits, sgt::kZero, s.xs[0]);
  }
  for (int buf = 0; id < total; id += gridDim.x, buf ^= 1) {
    const long long next = id + gridDim.x;
    if (next < total) {   // buffer buf ^ 1 was last read before the last sync
      const bf16* nrow = x + next / tiles * N;
      sg1b::start_copies(nrow, N, sg1b::first_output(nrow, 0, next % tiles),
                         kUnits, sgt::kZero, s.xs[buf ^ 1]);
    } else {
      asm volatile("cp.async.commit_group;\n" ::);
    }
    const bool bad = sg1b::landed(s.xs[buf], kUnits);
    // taps_only: the halo slots from the tile's first groups, each copied
    // by the thread that staged it (its copies landed for it)
    if (V == kTapsOnly && threadIdx.x < kStagedUnits - kTileUnits)
      reinterpret_cast<uint4*>(s.xs[buf] + sg1b::kTile)[threadIdx.x] =
          reinterpret_cast<const uint4*>(s.xs[buf])[threadIdx.x];
    const long long b = id / tiles;
    const bf16* __restrict__ xrow = x + b * N;
    bf16* __restrict__ orow = out + b * n_out;
    const long long t0 = sg1b::first_output(xrow, 0, id % tiles);
    __syncthreads_or(bad);   // every copy landed; finite input
    if (t0 >= n_out) continue;   // uniform
    if (V == kTapsOnly) {
      sg1b::mma_tile<KC>(s.xs[buf], s.taps, ws, s.ys);
      __syncthreads();
      sg1b::store_tile(orow, n_out, t0, s.ys);
    } else {
      // straight from the staging buffer, which holds 8 readable values
      // past the last one stored (the next member of AsyncSmem)
      sg1b::store_tile(orow, n_out, t0, s.xs[buf],
                       V == kShiftOnly ? ws / 2 : 0);
      __syncthreads();   // buffer buf takes the copies two tiles on
    }
  }
}

template <int V, int KC>
cudaError_t run(const bf16* x, const float* w, bf16* out, long long B,
                long long N, long long n_out, int ws, cudaStream_t stream) {
  const auto kernel = probe_kernel<V, KC>;
  const int smem = static_cast<int>(sizeof(sg1b::AsyncSmem<KC>));
  const long long tiles = (n_out + sg1b::kTile - 1) / sg1b::kTile;
  long long blocks = 0;
  const cudaError_t err =
      sg1b::resident_blocks(kernel, smem, B * tiles, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(static_cast<unsigned>(blocks)), sg1b::kThreads, smem,
           stream>>>(x, w, out, N, n_out, tiles, B * tiles, ws);
  return cudaGetLastError();
}

// K3-bf16's shared memory for the window (KC = chunks(ws), 1 to 9), so
// every variant keeps its blocks an SM.
template <int V>
cudaError_t launch(const bf16* x, const float* w, bf16* out, long long B,
                   long long N, long long n_out, int ws,
                   cudaStream_t stream) {
  switch (sg1b::chunks(ws)) {
#define PROBE_BF16_CASE(KC) \
  case KC:                  \
    return run<V, KC>(x, w, out, B, N, n_out, ws, stream);
    PROBE_BF16_CASE(1)
    PROBE_BF16_CASE(2)
    PROBE_BF16_CASE(3)
    PROBE_BF16_CASE(4)
    PROBE_BF16_CASE(5)
    PROBE_BF16_CASE(6)
    PROBE_BF16_CASE(7)
    PROBE_BF16_CASE(8)
    PROBE_BF16_CASE(9)
#undef PROBE_BF16_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// kTile: the tile width the plain version of taps_only needs.
extern "C" int probe_bf16_1d_tile() { return sg1b::kTile; }

// variant 0 copy (out: B x N), 1 shift_only, 2 taps_only (out: B x
// (N - ws + 1)); x and out bf16, x's rows 16-byte aligned (N % 8 == 0 and
// an aligned base), w (ws,) bf16 values held in f32 (taps_only).
extern "C" int probe_bf16_1d(const void* x, const float* w, void* out,
                             long long B, long long N, int ws, int variant,
                             void* stream) {
  if (ws < 1 || ws > sgt::kMaxWs || N < ws || N % 8 != 0 || B < 1 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || variant < kCopy ||
      variant > kTapsOnly)
    return cudaErrorInvalidValue;
  const auto* xb = static_cast<const bf16*>(x);
  auto* ob = static_cast<bf16*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  if (variant == kCopy) return launch<kCopy>(xb, w, ob, B, N, N, ws, st);
  const long long n_out = N - ws + 1;
  if (variant == kShiftOnly)
    return launch<kShiftOnly>(xb, w, ob, B, N, n_out, ws, st);
  return launch<kTapsOnly>(xb, w, ob, B, N, n_out, ws, st);
}
