// K4: 1D correlation of one row with a bank of K stencils, one read of the
// input:
//
//     out[k, b, j] = sum_{t < ws} w[k, t] * xv[b, j - pad + t],
//     0 <= k < K, 0 <= j < n_out = N + 2 pad - ws + 1,
//
// where xv is the row x[b] extended past [0, N) by the pad mode
// (stencil_tile.cuh map_index: zero, edge, symmetric or wrap, for any pad
// width). pad = 0 with zeros is the VALID bank of the TPU kernels; pad = n
// gives SavgolBank's same-length (K, B, N) output in one pass, pad = 32 the
// sweep's 65-tap stacks, so no padded copy of the input and no second pass
// over the K outputs is made.
//
// Replaces savgol_tpu/ops/pallas_conv.py::_bank_mxu_kernel
// (correlate_valid_bank_pallas_mxu: K stationary band matmuls a slab) and
// ::_bank_kernel (correlate_valid_bank_pallas: VPU tap loops). One function;
// the TPU split it by batch width because of its matrix unit.
//
// Bound: device-memory bytes. A sample is read once and K outputs are
// written for it: 4 + 4K bytes an f32 sample against 2 ws K flops, so at
// ws <= 65 the bytes dominate the card's FMA rate (3.35 TB/s against 67
// TFLOP/s, data sheet; derived, not measured). The design stages each tile
// of 1024 outputs (plus a halo of about ws samples) in shared memory once
// and runs every stencil over it from there: the taps of up to kGroup = 16
// stencils sit in shared memory at a time, and a larger bank loops over
// groups of stencils inside the block, reloading only the taps (16 x 68
// values from L2) and never the input. A grid dimension over groups would
// re-read the input once a group. Each thread writes its 4 outputs of a
// stencil as one 16-byte store where aligned: a warp writes 512 contiguous
// bytes.
#include <stdint.h>

#include "stencil_tile.cuh"

namespace {

constexpr int kGroup = 16;   // stencils whose taps sit in shared memory
// K4 keeps the 65-tap cap of the bank and the sweep (2 * MAX_HALF_WINDOW +
// 1) below the 1D tile kernels' 129: a wider tap buffer would double the
// taps each group reloads (16 x 132 values) and the f64 instance's shared
// memory, for windows no bank entry point builds.
constexpr int kBankMaxWs = sgt::kNarrowWs;
constexpr int kBankMaxWsPad = sgt::ws_pad(kBankMaxWs);
constexpr int kBankStage = sgt::kTile + kBankMaxWsPad + 4;

template <typename T> struct BankSmem {
  __align__(16) T xs[kBankStage];
  __align__(16) T w[kGroup][kBankMaxWsPad];
};

template <typename T>
__device__ __forceinline__ void store4(T* __restrict__ orow, long long j0,
                                       long long n_out, const T acc[sgt::kQ]) {
  T* p = orow + j0;
  if (j0 + sgt::kQ <= n_out && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    sgt::Vec4<T>::store(p, acc);
    return;
  }
#pragma unroll
  for (int q = 0; q < sgt::kQ; ++q)
    if (j0 + q < n_out) p[q] = acc[q];
}

// Blocks an SM keeps resident. kMinBlocks leaves 32 registers a thread;
// in f64, row_taps4's 8 staged samples, 4 taps and 4 sums alone take 32, so
// the f64 instance asks for half the blocks (64 registers) so that it does
// not spill.
template <typename T>
constexpr int kBankMinBlocks =
    sizeof(T) == 8 ? sgt::kMinBlocks / 2 : sgt::kMinBlocks;

template <typename T>
__global__ void __launch_bounds__(sgt::kThreads, kBankMinBlocks<T>)
corr1d_bank_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   T* __restrict__ out, long long B, long long N,
                   long long n_out, long long tiles, int K, int ws, int pad,
                   int mode) {
  __shared__ BankSmem<T> s;
  const long long b = blockIdx.x / tiles;
  const long long t0 = (blockIdx.x % tiles) * sgt::kTile;
  const T* __restrict__ xrow = x + b * N;   // 64-bit: B * N passes 2^31
  sgt::stage_row(xrow, N, t0 - pad, ws, mode, s.xs);

  const int base = threadIdx.x * sgt::kQ;
  const long long j0 = t0 + base;
  for (int g0 = 0; g0 < K; g0 += kGroup) {
    const int gk = K - g0 < kGroup ? K - g0 : kGroup;
    if (g0 > 0) __syncthreads();   // every thread is done with the last taps
    for (int i = threadIdx.x; i < gk * kBankMaxWsPad; i += sgt::kThreads) {
      const int k = i / kBankMaxWsPad, t = i % kBankMaxWsPad;
      s.w[k][t] = t < ws ? w[static_cast<long long>(g0 + k) * ws + t] : T(0);
    }
    __syncthreads();               // also covers the staged row, first time
    if (j0 >= n_out) continue;     // past the row's end: nothing to write
    for (int k = 0; k < gk; ++k) {
      T acc[sgt::kQ] = {T(0), T(0), T(0), T(0)};
      sgt::row_taps4(&s.xs[base], s.w[k], ws, acc);
      store4(out + (static_cast<long long>(g0 + k) * B + b) * n_out, j0,
             n_out, acc);
    }
  }
}

template <typename T>
int launch(const T* x, const T* w, T* out, long long B, long long N, int K,
           int ws, int pad, int mode, void* stream) {
  if (K < 1 || ws < 1 || ws > kBankMaxWs || pad < 0 || N < 1 ||
      mode < sgt::kZero || mode > sgt::kWrap)
    return cudaErrorInvalidValue;
  const long long n_out = N + 2LL * pad - ws + 1;
  if (n_out < 1) return cudaErrorInvalidValue;
  dim3 grid;
  long long tiles;
  const cudaError_t err = sgt::grid_for(B, n_out, &grid, &tiles);
  if (err != cudaSuccess) return err;
  corr1d_bank_kernel<T><<<grid, sgt::kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      x, w, out, B, N, n_out, tiles, K, ws, pad, mode);
  return cudaGetLastError();
}

}  // namespace

extern "C" int corr1d_bank_f32(const float* x, const float* w, float* out,
                               long long B, long long N, int K, int ws,
                               int pad, int mode, void* stream) {
  return launch<float>(x, w, out, B, N, K, ws, pad, mode, stream);
}

extern "C" int corr1d_bank_f64(const double* x, const double* w,
                               double* out, long long B, long long N, int K,
                               int ws, int pad, int mode, void* stream) {
  return launch<double>(x, w, out, B, N, K, ws, pad, mode, stream);
}
