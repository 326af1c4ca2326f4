// P3: attribution probes of the bf16 VALID 1D correlation on the CUDA-core
// tile (K3's exact tile with sgt::Bf16 staging, which K3-bf16 ran on before
// it moved to the tensor-core tile of sg1d_bf16.cuh), on bf16 storage at
// K3's tiles (stencil_tile.cuh: a block of kThreads threads, kTile outputs,
// kQ a thread). Each removes one cost term of that tile, so the difference
// of their times attributes its time:
//
//   copy       stage a tile and write it back: out[j] = x[j], 0 <= j < N.
//              Device-memory bytes alone at these tiles (2 B in, 2 B out).
//   shift_only stage a tile and its halo, write out[j] = x[j + n] over the
//              VALID length N - ws + 1 (n = ws / 2): staging and stores,
//              no FMAs.
//   taps_only  K3-bf16's tap loop with the halo NOT loaded: the halo slots
//              hold the tile's own first samples, so
//                out[j] = sum_k w[k] * x[t0 + ((j - t0 + k) mod kTile)]
//              (t0 the tile's first output, samples past N zero). Wrong
//              values by design and the right cost, as the TPU probe's
//              mm_only.
//
// They replace the TPU probes of benchmarks/probe_bf16_1d.py: copy_kernel
// [pl.pallas_call :152], shift_only_kernel [:135] and mm_only_kernel [:119]
// (the banded matmuls without the slab concat). The TPU split a tile's cost
// into matrix-unit work and lane relayouts; on CUDA cores it splits into
// device-memory bytes, the halo's staging, and the FMAs.
#include "stencil_tile.cuh"

namespace {

using sgt::kQ;
using sgt::kThreads;
using sgt::kTile;

constexpr int kMaxWs = sgt::kNarrowWs;
using Smem = sgt::TileSmem<float, kMaxWs>;

__global__ void __launch_bounds__(kThreads, sgt::kMinBlocks)
copy_kernel(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ out,
            long long N, long long tiles) {
  __shared__ Smem s;
  const long long b = blockIdx.x / tiles;
  const long long t0 = (blockIdx.x % tiles) * kTile;
  const __nv_bfloat16* __restrict__ xrow = x + b * N;
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const long long g = t0 + i;
    s.xs[i] = g < N ? sgt::Bf16::load(xrow[g]) : 0.0f;
  }
  __syncthreads();
  __nv_bfloat16* __restrict__ orow = out + b * N;
  for (int i = threadIdx.x; i < kTile && t0 + i < N; i += kThreads)
    sgt::Bf16::put(&orow[t0 + i], s.xs[i]);
}

__global__ void __launch_bounds__(kThreads, sgt::kMinBlocks)
shift_kernel(const __nv_bfloat16* __restrict__ x,
             __nv_bfloat16* __restrict__ out, long long N, long long n_out,
             long long tiles, int ws) {
  __shared__ Smem s;
  const long long b = blockIdx.x / tiles;
  const long long t0 = (blockIdx.x % tiles) * kTile;
  sgt::stage_row<sgt::Bf16>(x + b * N, N, t0, ws, sgt::kZero, s.xs);
  __syncthreads();
  __nv_bfloat16* __restrict__ orow = out + b * n_out;
  const int n = ws / 2;
  for (int i = threadIdx.x; i < kTile && t0 + i < n_out; i += kThreads)
    sgt::Bf16::put(&orow[t0 + i], s.xs[i + n]);
}

__global__ void __launch_bounds__(kThreads, sgt::kMinBlocks)
taps_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ w,
            __nv_bfloat16* __restrict__ out, long long N, long long n_out,
            long long tiles, int ws) {
  __shared__ Smem s;
  const long long b = blockIdx.x / tiles;
  const long long t0 = (blockIdx.x % tiles) * kTile;
  const __nv_bfloat16* __restrict__ xrow = x + b * N;
  const int stage = kTile + (ws & ~(kQ - 1)) + kQ;
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const long long g = t0 + i;
    s.xs[i] = g < N ? sgt::Bf16::load(xrow[g]) : 0.0f;
  }
  for (int k = threadIdx.x; k < sgt::ws_pad(kMaxWs); k += kThreads)
    s.w[k] = k < ws ? w[k] : 0.0f;
  __syncthreads();
  // the halo slots from the tile's own first samples: no device load
  for (int i = kTile + threadIdx.x; i < stage; i += kThreads)
    s.xs[i] = s.xs[i - kTile];
  __syncthreads();
  const int base = threadIdx.x * kQ;
  float acc[kQ] = {0.0f, 0.0f, 0.0f, 0.0f};
  sgt::row_taps4(&s.xs[base], s.w, ws, acc);
  __nv_bfloat16* __restrict__ orow = out + b * n_out;
#pragma unroll
  for (int q = 0; q < kQ; ++q)
    if (t0 + base + q < n_out) sgt::Bf16::put(&orow[t0 + base + q], acc[q]);
}

}  // namespace

// kTile: the tile width the plain version of taps_only needs.
extern "C" int probe_bf16_1d_tile() { return kTile; }

// variant 0 copy (out: B x N), 1 shift_only, 2 taps_only (out: B x
// (N - ws + 1)); x and out bf16, w (ws,) bf16 values held in f32 (taps_only).
extern "C" int probe_bf16_1d(const void* x, const float* w, void* out,
                             long long B, long long N, int ws, int variant,
                             void* stream) {
  if (ws < 1 || ws > kMaxWs || N < ws || variant < 0 || variant > 2)
    return cudaErrorInvalidValue;
  const long long n_out = variant == 0 ? N : N - ws + 1;
  dim3 grid;
  long long tiles;
  const cudaError_t err = sgt::grid_for(B, n_out, &grid, &tiles);
  if (err != cudaSuccess) return err;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  if (variant == 0)
    copy_kernel<<<grid, kThreads, 0, st>>>(xb, ob, N, tiles);
  else if (variant == 1)
    shift_kernel<<<grid, kThreads, 0, st>>>(xb, ob, N, n_out, tiles, ws);
  else
    taps_kernel<<<grid, kThreads, 0, st>>>(xb, w, ob, N, n_out, tiles, ws);
  return cudaGetLastError();
}
