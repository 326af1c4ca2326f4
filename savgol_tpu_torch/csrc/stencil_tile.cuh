// The tap loop of a staged row (row_taps4: the 1D kernels and the row pass
// of corr2d_sep.cu), the pad-mode index map of every staging loop (1D and
// 2D), and the shared tile stencil of the 1D kernels (sg1d_poly.cu,
// corr1d_valid.cu, corr1d_bank.cu).
//
// One block computes TILE consecutive outputs of one row:
//
//     acc[i] = sum_{k < ws} w[k] * xv[in0 + i + k],   0 <= i < TILE
//
// where in0 is the input index of the tile's first tap (t0 - n for the
// same-length apply, t0 for the VALID correlation) and xv is the row
// extended past [0, N) by the pad mode: zeros, or the samples map_index
// names, so no padded copy of a row is ever made. The TILE + ws - 1 samples
// the tile needs (rounded up to whole 16-byte register loads) are staged
// once in shared memory, so each sample of a row is read from device memory
// once plus a halo of about ws samples per tile.
//
// Each thread owns Q = 4 consecutive outputs and runs row_taps4 over the
// staged span.
//
// The staging loops and the kernels' stores take a policy: AsStored (the
// exact kernels: samples, taps and sums in the storage type) or a bf16 mode
// (the JAX package's method="bf16": bf16 operands, f32 sums). A bf16 mode
// rounds each sample to bf16 in registers as it is staged (one load of 2
// or 4 bytes a sample) and stages it as f32, so the tap loops are the
// exact f32 ones; its taps are bf16 values held in f32, so every product
// is exact in f32. It reads and writes the caller's storage, f32 or bf16,
// so no cast pass runs before or after. K3-bf16 (corr1d_valid.cu) runs
// this way; K1-bf16 and K2-bf16 run their own tile on the tensor cores,
// staged by 16-byte loads (sg1d_bf16.cuh).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace sgt {

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The exact kernels: a sample staged and a sum written as they are.
struct AsStored {
  template <typename T> __device__ static T load(T v) { return v; }
  template <typename T> __device__ static void put(T* p, T v) { *p = v; }
};

// bf16 mode of the 1D kernels: samples rounded to bf16 and staged as f32;
// each output rounded to bf16, then written in the caller's storage (the
// JAX kernels emit bf16, which the caller casts back).
struct Bf16 {
  __device__ static float load(float v) { return bf16_round(v); }
  __device__ static float load(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static void put(float* p, float v) { *p = bf16_round(v); }
  __device__ static void put(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
};

// bf16 mode of K2D-dense: operands as Bf16; the f32 sum written unrounded
// into f32 storage and rounded into bf16 storage (the JAX kernel emits its
// f32 accumulator for f32 input).
struct Bf16Sum : Bf16 {
  using Bf16::load;
  using Bf16::put;
  __device__ static void put(float* p, float v) { *p = v; }
};

// The pad mode codes of savgol_tpu_torch/ops/cuda_conv.py (MODE_CODE).
enum PadMode : int { kZero = 0, kEdge = 1, kSymmetric = 2, kWrap = 3 };

// Source index of index i on an axis of n samples padded in `mode`, by
// numpy's rules for any pad width (a row may be shorter than the pad):
// edge clamps, wrap is i mod n, symmetric reflects with the edge sample
// duplicated (period 2n). -1 for a kZero sample outside [0, n), which reads
// as zero. I is int for the 2D kernels' axes and long long for 1D rows.
template <typename I>
__host__ __device__ __forceinline__ I map_index(I i, I n, int mode) {
  if (i >= 0 && i < n) return i;
  switch (mode) {
    case kEdge:
      return i < 0 ? I(0) : n - 1;
    case kWrap: {
      const I j = i % n;
      return j < 0 ? j + n : j;
    }
    case kSymmetric: {
      const I p = 2 * n;
      I j = i % p;
      if (j < 0) j += p;
      return j < n ? j : p - 1 - j;
    }
    default:
      return I(-1);
  }
}

constexpr int kThreads = 256;
constexpr int kQ = 4;
constexpr int kTile = kThreads * kQ;      // outputs per block
// Blocks per SM that __launch_bounds__ asks to keep resident: 8 x 256
// threads fill the SM's 2048 and cap registers at 32 a thread. The kernels
// wait on device memory, and more resident blocks keep more loads in flight.
constexpr int kMinBlocks = 8;
// The widest window: the JAX package's Pallas cap (_LANES + 1 taps,
// pallas_conv.py:50), which scipy_compat reaches past SavgolConfig's 65. K1's
// edge rows are read from device memory, so n <= 64 rows of them cost no
// shared memory. Windows up to kNarrowWs (2 * MAX_HALF_WINDOW + 1, every
// SavgolConfig) run an instance whose shared buffers are sized for them,
// so the common windows keep the smaller footprint; wider ones an instance
// sized for kMaxWs.
constexpr int kMaxWs = 129;
constexpr int kNarrowWs = 65;

// ws rounded up to kQ: the tap buffer of an instance for windows up to ws.
__host__ __device__ constexpr int ws_pad(int ws) {
  return (ws + kQ - 1) / kQ * kQ;
}

__device__ __forceinline__ float madd(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double madd(double a, double b, double c) {
  return ::fma(a, b, c);
}

template <typename T> struct Vec4;
template <> struct Vec4<float> {
  __device__ static void load(const float* p, float r[4]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
  }
  __device__ static void store(float* p, const float r[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
  }
};
template <> struct Vec4<double> {
  __device__ static void load(const double* p, double r[4]) {
    const double2 a = reinterpret_cast<const double2*>(p)[0];
    const double2 b = reinterpret_cast<const double2*>(p)[1];
    r[0] = a.x; r[1] = a.y; r[2] = b.x; r[3] = b.y;
  }
  __device__ static void store(double* p, const double r[4]) {
    reinterpret_cast<double2*>(p)[0] = make_double2(r[0], r[1]);
    reinterpret_cast<double2*>(p)[1] = make_double2(r[2], r[3]);
  }
};

// acc[j] += sum_{k < W} w[k] * row[j + k] for the 4 outputs j < 4 of one
// staged row. row and w are 16-byte aligned, w is zero-padded to a multiple
// of 4, and row[0, (W & ~3) + 8) is readable. A register window slides over
// the row: each group of 4 taps costs one 16-byte load of the row and one
// broadcast 16-byte load of the taps for 16 FMAs. The last W mod 4 taps run
// one at a time, so no padding tap reads a sample outside the window: an
// inf there would make the output NaN.
template <typename T>
__device__ __forceinline__ void row_taps4(const T* __restrict__ row,
                                          const T* __restrict__ w, int W,
                                          T acc[kQ]) {
  const int full = W & ~(kQ - 1);          // taps in whole groups of kQ
  T r[2 * kQ];
  Vec4<T>::load(row, r);
  for (int g = 0; g < full; g += kQ) {
    Vec4<T>::load(row + g + kQ, r + kQ);
    T wv[kQ];
    Vec4<T>::load(w + g, wv);
#pragma unroll
    for (int kk = 0; kk < kQ; ++kk)
#pragma unroll
      for (int j = 0; j < kQ; ++j) acc[j] = madd(wv[kk], r[j + kk], acc[j]);
#pragma unroll
    for (int j = 0; j < kQ; ++j) r[j] = r[j + kQ];
  }
  const int rem = W - full;
  if (rem == 0) return;
  Vec4<T>::load(row + full + kQ, r + kQ);
#pragma unroll
  for (int kk = 0; kk < kQ - 1; ++kk) {
    if (kk < rem) {
      const T wk = w[full + kk];
#pragma unroll
      for (int j = 0; j < kQ; ++j) acc[j] = madd(wk, r[j + kk], acc[j]);
    }
  }
}

// Shared buffers of one block of an instance for windows up to MaxWs. xs
// holds the staged input and, after the compute, the block's TILE outputs:
// the deepest staged index a thread reads is kTile + (ws & ~3) + 3, so a
// tile stages kTile + (ws & ~3) + 4 samples.
template <typename T, int MaxWs> struct TileSmem {
  __align__(16) T xs[kTile + ws_pad(MaxWs) + 4];
  __align__(16) T w[ws_pad(MaxWs)];
};

// Stages xv[in0, in0 + stage) of a row of N >= 1 samples into xs, the
// samples past [0, N) mapped by `mode`, each read through IO::load (no
// barrier). In is the storage type, T the staged one.
template <typename IO = AsStored, typename In, typename T>
__device__ __forceinline__ void stage_row(const In* __restrict__ xrow,
                                          long long N, long long in0, int ws,
                                          int mode, T* __restrict__ xs) {
  const int stage = kTile + (ws & ~(kQ - 1)) + kQ;
  for (int i = threadIdx.x; i < stage; i += kThreads) {
    const long long g = in0 + i;
    T v = T(0);
    if (g >= 0 && g < N)
      v = IO::load(xrow[g]);
    else if (mode != kZero)   // a pad mode maps every index into [0, N)
      v = IO::load(xrow[map_index(g, N, mode)]);
    xs[i] = v;
  }
}

// Stages xv[in0, in0 + stage) (see stage_row) and w, computes the tile, and
// leaves acc[i] in s.xs[i] for 0 <= i < kTile. Ends synchronised.
template <typename IO, typename In, typename T, int MaxWs>
__device__ void tile_correlate(const In* __restrict__ xrow, long long N,
                               long long in0, const T* __restrict__ w,
                               int ws, TileSmem<T, MaxWs>& s,
                               int mode = kZero) {
  const int tid = threadIdx.x;
  stage_row<IO>(xrow, N, in0, ws, mode, s.xs);
  for (int k = tid; k < ws_pad(MaxWs); k += kThreads)
    s.w[k] = k < ws ? w[k] : T(0);
  __syncthreads();

  const int base = tid * kQ;
  T acc[kQ] = {T(0), T(0), T(0), T(0)};
  row_taps4(&s.xs[base], s.w, ws, acc);
  __syncthreads();                       // every thread is done reading xs
  Vec4<T>::store(&s.xs[base], acc);
  __syncthreads();
}

// Blocks cover (row, tile) pairs flattened into gridDim.x, so any batch
// size launches (gridDim.y would cap B at 65,535).
inline cudaError_t grid_for(long long B, long long n_out, dim3* grid,
                            long long* tiles) {
  *tiles = (n_out + kTile - 1) / kTile;
  const long long blocks = B * *tiles;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  *grid = dim3(static_cast<unsigned>(blocks));
  return cudaSuccess;
}

}  // namespace sgt
