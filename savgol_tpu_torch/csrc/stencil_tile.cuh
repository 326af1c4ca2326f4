// The tap loop of a staged row (row_taps4: K4's stencils, the row pass of
// corr2d_sep.cu, P1), the pad-mode index map of every staging loop (1D and
// 2D), the bf16 operand load of the bf16 modes, and the tile of 1024
// outputs a block that K4 (corr1d_bank.cu) uses and P1's tap loop keeps.
// K1, K2 and K3 ran this tile until they moved to sg1d_exact.cuh, whose
// outputs are bit for bit row_taps4's.
//
// One block computes TILE consecutive outputs of one row:
//
//     acc[i] = sum_{k < ws} w[k] * xv[in0 + i + k],   0 <= i < TILE
//
// where in0 is the input index of the tile's first tap and xv is the row
// extended past [0, N) by the pad mode: zeros, or the samples map_index
// names, so no padded copy of a row is ever made. The TILE + ws - 1 samples
// the tile needs (rounded up to whole 16-byte register loads) are staged
// once in shared memory (stage_row), so each sample of a row is read from
// device memory once plus a halo of about ws samples per tile.
//
// Each thread owns Q = 4 consecutive outputs and runs row_taps4 over the
// staged span.
//
// The bf16 modes (the JAX package's method="bf16": bf16 operands, f32
// sums) run their own tiles on the tensor cores, staged by 16-byte loads
// (sg1d_bf16.cuh, corr2d_bf16_mma.cu); a group of samples that leaves the
// row or image is mapped one sample at a time and read through Bf16::load,
// which rounds an f32 sample to bf16 (held in f32) and widens a bf16 one.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace sgt {

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// A bf16 mode's operand: a sample rounded to bf16, held in f32.
struct Bf16 {
  __device__ static float load(float v) { return bf16_round(v); }
  __device__ static float load(__nv_bfloat16 v) { return __bfloat162float(v); }
};

// The pad mode codes of savgol_tpu_torch/ops/cuda_conv.py (MODE_CODE).
// kReflect reaches K2 alone (scipy's mode="mirror"); the 2D kernels and K4
// refuse it.
enum PadMode : int {
  kZero = 0, kEdge = 1, kSymmetric = 2, kWrap = 3, kReflect = 4
};

// Source index of index i on an axis of n samples padded in `mode`, by
// numpy's rules for any pad width (a row may be shorter than the pad):
// edge clamps, wrap is i mod n, symmetric reflects with the edge sample
// duplicated (period 2n), reflect without it (period 2n - 2; 0 where
// n == 1). -1 for a kZero sample outside [0, n), which reads as zero. I is
// int for the 2D kernels' axes and long long for 1D rows. The host twin:
// cuda_conv.py pad_index. Only a map with Reflect set holds the kReflect
// case: K2's staging (sg1d_exact.cuh, sg1d_bf16.cuh). The 2D kernels, K4
// and P1 never take the code, so their maps leave it out and keep their
// code as it was (with the case inlined, K7's sweep kernel compiled to 30%
// more instructions for sm_90a at the same registers).
template <bool Reflect = false, typename I>
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
      if constexpr (Reflect) {
        if (mode == kReflect) {
          if (n == 1) return I(0);
          const I p = 2 * n - 2;
          I j = i % p;
          if (j < 0) j += p;
          return j < n ? j : p - j;
        }
      }
      return I(-1);
  }
}

constexpr int kThreads = 256;
constexpr int kQ = 4;
constexpr int kTile = kThreads * kQ;      // outputs per block
// The widest window of K1-K3 (sg1d_exact.cuh, sg1d_bf16.cuh), P1 and P3:
// the JAX package's Pallas cap (_LANES + 1 taps, pallas_conv.py:50), which
// scipy_compat reaches past SavgolConfig's 65. K1's edge rows are read from
// device memory, so n <= 64 rows of them cost no shared memory.
constexpr int kMaxWs = 129;

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

// Stages xv[in0, in0 + stage) of a row of N >= 1 samples into xs, the
// samples past [0, N) mapped by `mode` (no barrier): the deepest staged
// index a thread's row_taps4 reads is kTile + (ws & ~3) + 3, so a tile
// stages kTile + (ws & ~3) + 4 samples.
template <typename T>
__device__ __forceinline__ void stage_row(const T* __restrict__ xrow,
                                          long long N, long long in0, int ws,
                                          int mode, T* __restrict__ xs) {
  const int stage = kTile + (ws & ~(kQ - 1)) + kQ;
  for (int i = threadIdx.x; i < stage; i += kThreads) {
    const long long g = in0 + i;
    T v = T(0);
    if (g >= 0 && g < N)
      v = xrow[g];
    else if (mode != kZero)   // a pad mode maps every index into [0, N)
      v = xrow[map_index(g, N, mode)];
    xs[i] = v;
  }
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
