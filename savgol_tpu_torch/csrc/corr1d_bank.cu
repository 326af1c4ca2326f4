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
// Bound: device-memory bytes for the bank (4 + 4K bytes an f32 sample
// against 2 ws K flops), and nearly so for the sweep's stacks at the FMA
// rate (3.35 TB/s against 67 TFLOP/s, data sheet; derived, not measured).
// The design:
//
// - Each block stages a tile of 1024 outputs (plus a halo of about ws
//   samples) in shared memory once, and a thread owns 4 consecutive outputs
//   of every stencil.
// - Per-stencil tap spans (f32). The sweep's 65-tap stencils are zero
//   outside their window |i| <= n (ops/sweep.py), so 198 of its 390 taps a
//   sample are live at its six configurations. The taps of a group of
//   stencils are scanned as they are staged, and each stencil runs only the
//   groups of 4 taps that meet [lo, hi), its leading and trailing runs of
//   zeros cut off (interior zeros stay): 213 taps a sample at the sweep's.
//   On finite data this is exact: the sum starts at +0, fma(0, x, +0) is +0
//   and a trailing product is a zero, so the result equals the full tap
//   loop's.
// - Non-finite input keeps the plain version's spread. There 0 * inf and
//   0 * NaN are NaN, so a NaN or inf sample turns every output within the
//   65 taps into NaN. A tile whose staged samples are not all finite
//   (checked in registers as they are staged, then __syncthreads_or) runs
//   every stencil over all ws taps.
// - The loop runs stencil by stencil, each over its span (row_taps4's
//   loop: one 16-byte load of the staged row and one broadcast 16-byte tap
//   load for 16 FMAs). The other order, each group of 4 staged samples
//   loaded once for every stencil with the sums of 6 stencils in registers,
//   halves the shared loads but branches on each stencil's span inside the
//   loop, and each branch waits on its tap load: on the H100 it was slower
//   at both the sweep's and the bank's shapes, and so was a ring of
//   cp.async stages over persistent blocks.
//
// Each thread writes its 4 outputs of a stencil as one 16-byte store where
// aligned: a warp writes 512 contiguous bytes.
#include <stdint.h>

#include "stencil_tile.cuh"

namespace {

// K4 keeps the 65-tap cap of the bank and the sweep (2 * MAX_HALF_WINDOW +
// 1) below the 1D tile kernels' 129: a wider tap buffer would double the
// taps each group reloads and the f64 instance's shared memory, for
// windows no bank entry point builds.
constexpr int kBankMaxWs = 65;
constexpr int kBankMaxWsPad = sgt::ws_pad(kBankMaxWs);
constexpr int kBankStage = sgt::kTile + kBankMaxWsPad + 4;

constexpr int kGroup = 16;   // stencils whose taps sit in shared memory
// Blocks an SM keeps resident: 6 x 256 threads leave 40 registers a
// thread, which the f32 loop needs without spilling (at 8 blocks and 32
// registers it spilled); the f64 instance's staged samples, taps and sums
// take twice the registers, so it keeps 4 blocks.
template <typename T>
constexpr int kBankMinBlocks = sizeof(T) == 8 ? 4 : 6;

// The f32 instance runs each stencil over its span; the f64 one over every
// tap. On the H100 the spans' bookkeeping (the finiteness check, the span
// loads) cost the f64 bank, whose stencils have no zero taps, more than
// the parent's spread, and no main path sweeps in f64.
template <typename T> constexpr bool kTrim = sizeof(T) == 4;

template <typename T> struct BankSmem {
  __align__(16) T xs[kBankStage];
  __align__(16) T w[kGroup][kBankMaxWsPad];
  int lo[kGroup], hi[kGroup];   // groups of 4 taps a stencil's span meets
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

// stencil_tile.cuh stage_row, which also tells whether every sample this
// thread staged is finite (checked in registers, as it is staged).
template <typename T>
__device__ __forceinline__ bool stage_row_finite(const T* __restrict__ xrow,
                                                 long long N, long long in0,
                                                 int ws, int mode,
                                                 T* __restrict__ xs) {
  const int stage = sgt::kTile + (ws & ~(sgt::kQ - 1)) + sgt::kQ;
  bool finite = true;
  for (int i = threadIdx.x; i < stage; i += sgt::kThreads) {
    const long long g = in0 + i;
    T v = T(0);
    if (g >= 0 && g < N)
      v = xrow[g];
    else if (mode != sgt::kZero)   // a pad mode maps every index into [0, N)
      v = xrow[sgt::map_index(g, N, mode)];
    finite &= isfinite(v);
    xs[i] = v;
  }
  return finite;
}

// Warp k of the block stages stencil g0 + k's taps (zero past ws) and the
// groups of 4 taps [lo, hi) that the span of its nonzero taps meets (none
// for a stencil of zeros). No barrier: the caller synchronises before, if
// the last taps are still read, and after.
template <typename T>
__device__ void stage_taps(const T* __restrict__ w, int g0, int gk, int ws,
                           BankSmem<T>& s) {
  const int lane = threadIdx.x & 31;
  for (int k = threadIdx.x >> 5; k < gk; k += sgt::kThreads / 32) {
    const T* __restrict__ wk = w + static_cast<long long>(g0 + k) * ws;
    unsigned nz[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int t = lane + 32 * c;
      const T v = t < ws ? wk[t] : T(0);
      if (t < kBankMaxWsPad) s.w[k][t] = v;
      nz[c] = __ballot_sync(0xffffffffu, v != T(0));
    }
    int lo = 0, hi = 0;
    if (nz[0] | nz[1] | nz[2]) {
      lo = nz[0] ? __ffs(nz[0]) - 1
                 : nz[1] ? 31 + __ffs(nz[1]) : 63 + __ffs(nz[2]);
      hi = nz[2] ? 96 - __clz(nz[2])
                 : nz[1] ? 64 - __clz(nz[1]) : 32 - __clz(nz[0]);
    }
    if (lane == 0) {
      s.lo[k] = lo / sgt::kQ;
      s.hi[k] = (hi + sgt::kQ - 1) / sgt::kQ;
    }
  }
}

// acc[j] += sum_t w[t] * row[j + t] over the groups of 4 taps [q, q_end):
// row_taps4's loop from group q on, the last ws mod 4 taps one at a time
// (a padding tap would multiply a sample outside the window, NaN if it is
// inf).
template <typename T>
__device__ __forceinline__ void span_taps(const T* __restrict__ row,
                                          const T* __restrict__ w, int ws,
                                          int q, int q_end, T acc[sgt::kQ]) {
  constexpr int Q = sgt::kQ;
  const int full = ws & ~(Q - 1), qfull = full / Q;
  T r[2 * Q];
  sgt::Vec4<T>::load(row + Q * q, r);
  for (const int q_stop = q_end < qfull ? q_end : qfull; q < q_stop; ++q) {
    const int g = Q * q;
    sgt::Vec4<T>::load(row + g + Q, r + Q);
    T wv[Q];
    sgt::Vec4<T>::load(w + g, wv);
#pragma unroll
    for (int kk = 0; kk < Q; ++kk)
#pragma unroll
      for (int j = 0; j < Q; ++j) acc[j] = sgt::madd(wv[kk], r[j + kk], acc[j]);
#pragma unroll
    for (int j = 0; j < Q; ++j) r[j] = r[j + Q];
  }
  if (q_end <= qfull) return;
  const int rem = ws - full;
  sgt::Vec4<T>::load(row + full + Q, r + Q);
#pragma unroll
  for (int kk = 0; kk < Q - 1; ++kk) {
    if (kk < rem) {
      const T wt = w[full + kk];
#pragma unroll
      for (int j = 0; j < Q; ++j) acc[j] = sgt::madd(wt, r[j + kk], acc[j]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(sgt::kThreads, kBankMinBlocks<T>)
corr1d_bank_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   T* __restrict__ out, long long B, long long N,
                   long long n_out, long long tiles, int K, int ws, int pad,
                   int mode) {
  constexpr int Q = sgt::kQ;
  __shared__ BankSmem<T> s;
  const long long b = blockIdx.x / tiles;
  const long long t0 = (blockIdx.x % tiles) * sgt::kTile;
  const T* __restrict__ xrow = x + b * N;   // 64-bit: B * N passes 2^31
  bool finite = false;   // f64: every tap
  if constexpr (kTrim<T>)
    finite = stage_row_finite(xrow, N, t0 - pad, ws, mode, s.xs);
  else
    sgt::stage_row(xrow, N, t0 - pad, ws, mode, s.xs);
  stage_taps(w, 0, K < kGroup ? K : kGroup, ws, s);
  if constexpr (kTrim<T>)
    finite = !__syncthreads_or(!finite);   // also publishes the row, taps
  else
    __syncthreads();

  const long long j0 = t0 + threadIdx.x * Q;
  const T* row = &s.xs[threadIdx.x * Q];
  const int groups = (ws + Q - 1) / Q;
  for (int g0 = 0; g0 < K; g0 += kGroup) {
    const int gk = K - g0 < kGroup ? K - g0 : kGroup;
    if (g0 > 0) {
      __syncthreads();   // every thread is done with the last taps
      stage_taps(w, g0, gk, ws, s);
      __syncthreads();
    }
    if (j0 >= n_out) continue;     // past the row's end: nothing to write
    for (int k = 0; k < gk; ++k) {
      T acc[Q] = {T(0), T(0), T(0), T(0)};
      const int lo = finite ? s.lo[k] : 0, hi = finite ? s.hi[k] : groups;
      if (lo < hi) span_taps(row, s.w[k], ws, lo, hi, acc);
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
