// K2D-dense: dense 2D VALID correlation of K stencils over one read of the
// input,
//
//     out[b, k, r, c] = sum_{y < H, x < W} w[k, y, x] * X[b, r + y, c + x],
//
// where X is the (B, R, C) input as it is (VALID) or extended by
// (H - 1) / 2 rows and (W - 1) / 2 columns in a pad mode (edge = CONSTANT,
// symmetric = REFLECT, wrap = PERIODIC), mapped while a tile is staged, so
// no padded copy of the image exists. H and W are odd, at most 33. f32
// accumulates in f32 and f64 in f64, by FMA on the CUDA cores (no tensor
// cores, no TF32), taps in (y, x) order, every tap of the window: a NaN or
// inf reaches exactly the outputs whose window holds it, as in the plain
// version.
//
// Replaces the TPU kernels of savgol_tpu/ops/pallas_conv.py:
//   K5a _corr2d_kernel :1183 / _corr2d_call :1216 (runtime SMEM taps),
//   K5b _corr2d_const_call :1288 (taps baked as compile-time constants),
//   K6a _corr2d_rowmxu_kernel :1501 / _corr2d_rowmxu_call :1530 (row-banded
//       MXU matmuls),
//   K6b _corr2d_rowmxu_stack_kernel :1670 / _corr2d_rowmxu_stack_call :1702
//       (K stencils per input read).
// They compute one function; the TPU split it four ways for its VPU/MXU
// split and Mosaic's compile-time constants. Here one kernel serves one
// stencil or a stack (the stack reads the image once, which is what K6b was
// for).
//
// Bound: at 11 x 11 an f32 pixel costs 121 FMAs for 8 bytes of device memory
// (one read, one write). The H100 SXM data sheet's 67 TFLOP/s f32 (33.5
// TFMA/s) gives ~277 Gpix/s, below the 3.35 TB/s / 8 B = ~419 Gpix/s of the
// bytes (both derived, not measured): the kernel is bound by arithmetic
// from about 7 x 7 up, and by bytes below. An SM issues one instruction a
// cycle on each of its four schedulers and its shared memory serves 128
// bytes a cycle, so the design keeps both below the FMAs:
//
// - A block of 256 threads computes a 32 x 128 tile; a thread owns 2 rows
//   times two groups of 4 columns 64 apart (16 outputs), so that each
//   16-byte shared load of 4 samples feeds 4 taps x 2 output rows and each
//   broadcast 16-byte load of 4 taps feeds 4 taps x 8 columns: per 4-tap
//   group and staged row, 2 sample loads (a register window slides along
//   the row) and up to 2 tap loads for up to 64 FMAs. Two rows, not four:
//   at four a thread took 101 registers (f32, 11 x 11), two blocks an SM,
//   and a block's staging overlapped little else; at two it takes 64
//   registers with no spill, four blocks an SM, and is faster
//   (probes/variants.py).
// - The taps' width is a template parameter for every width that
//   Savgol2D's auto route sends here (W <= 17; wider ones go to K2D-sep,
//   apply2d.py's _SEP_MIN_TAPS), so the loop over a staged row unrolls
//   whole, the register window's shift is a renaming and the last W mod 4
//   taps need no test. On the runtime-width instance, which takes wider
//   stencils, 11 x 11 took 28% (one stencil) and 40% (three) longer and
//   5 x 5 17% (probes/variants.py, runtime_width). The staged rows split
//   into the first and last, whose output rows test the stencil row, and
//   the rest, which do not.
// - Staging moves 4 samples a thread at a time: 16-byte loads of the
//   caller's rows at their aligned addresses (any row length), shifted
//   into place in registers, one 16-byte shared store; only a group of 4
//   that leaves the image goes through the pad mode's index map. One
//   stencil row (1 x 11) on the same tiles, which is staging, stores and
//   per-tile cost, took more than half of the 11 x 11 time of the kernel
//   this one replaces (probes/stencil_ab.py); with the four blocks an SM
//   holds now, one block's staging overlaps the others' taps.
// - A stack runs all K stencils over the one staged tile, each stencil's
//   taps staged in turn.
// The 64 x 64 tiles and the staging of stencil2d.cuh stay K2D-sep's
// (corr2d_sep.cu).
//
// method="bf16" (corr2d_valid_bf16, the replacement of K6a/K6b on bf16
// operands) runs on the tensor cores in corr2d_bf16_mma.cu, with its own
// tile and staging; the instances here are the exact f32 and f64 ones.
#include <stdint.h>

#include "stencil2d.cuh"

namespace {

using sgt2d::map_index;
using sgt::madd;
using sgt::Vec4;

constexpr int kThreadsD = 256;
constexpr int kQR = 2;                 // output rows a thread
constexpr int kColThreads = 16;        // threads across a tile row
constexpr int kHalf = 4 * kColThreads; // a thread's second column group
constexpr int kDR = kQR * (kThreadsD / kColThreads);   // tile rows, 32
constexpr int kDC = 2 * kHalf;                          // tile columns, 128

// Staged row stride for a W-wide stencil: the kDC + W - 1 samples a tile
// row reads plus the lanes the last 16-byte loads fetch but never use, a
// multiple of 4.
__host__ __device__ inline int stage_cols(int W) { return kDC + (W & ~3) + 4; }
__host__ __device__ inline int pad4(int n) { return (n + 3) & ~3; }

// 4 samples p[0, 4) of a row, from 16-byte loads at the aligned addresses
// around them, shifted into place.
__device__ __forceinline__ void load4(const float* p, float r[4]) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const int m = static_cast<int>((a >> 2) & 3);    // samples past alignment
  const float4* v = reinterpret_cast<const float4*>(a & ~uintptr_t(15));
  const float4 v0 = __ldg(v);
  const float4 v1 = m ? __ldg(v + 1) : v0;
  float f[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
  if (m & 2) {
#pragma unroll
    for (int i = 0; i < 6; ++i) f[i] = f[i + 2];
  }
  if (m & 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = f[i + 1];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) r[i] = f[i];
}

__device__ __forceinline__ void load4(const double* p, double r[4]) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const int m = static_cast<int>((a >> 3) & 1);
  const double2* v = reinterpret_cast<const double2*>(a & ~uintptr_t(15));
  const double2 v0 = __ldg(v), v1 = __ldg(v + 1);
  const double2 v2 = m ? __ldg(v + 2) : v1;
  const double f[6] = {v0.x, v0.y, v1.x, v1.y, v2.x, v2.y};
#pragma unroll
  for (int i = 0; i < 4; ++i) r[i] = m ? f[i + 1] : f[i];
}

// Stages rows [row0, row0 + SR) x columns [col0, col0 + SW) of the padded
// image into xs (row stride SW), 4 samples a thread at a time.
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ img, int R, int C,
                                      int row0, int col0, int SR, int SW,
                                      int mode, T* __restrict__ xs) {
  const int groups = SW / 4;
  for (int e = threadIdx.x; e < SR * groups; e += kThreadsD) {
    const int i = e / groups, g = e - i * groups;
    const int gr = map_index(row0 + i, R, mode);
    const int gc = col0 + 4 * g;
    T v[4] = {T(0), T(0), T(0), T(0)};
    if (gr >= 0) {
      const T* __restrict__ src = img + static_cast<long long>(gr) * C;
      if (gc >= 0 && gc + 4 <= C) {
        load4(src + gc, v);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = map_index(gc + j, C, mode);
          if (c >= 0) v[j] = src[c];
        }
      }
    }
    Vec4<T>::store(xs + i * SW + 4 * g, v);
  }
}

// One staged row through the thread's kQR output rows: staged row rb + i
// feeds output row rb + q through stencil row i - q. CHECK: test that the
// stencil row exists (the first and last kQR - 1 staged rows).
template <bool CHECK, int WC, typename T>
__device__ __forceinline__ void row_step(const T* __restrict__ s0,
                                         const T* __restrict__ ws, int i,
                                         int H, int Wrt, int WP,
                                         T acc[2][kQR][4]) {
  const int W = WC > 0 ? WC : Wrt;
  const int full = W & ~3, rem = W - full;   // rem is 1 or 3: W is odd
  const T* __restrict__ s1 = s0 + kHalf;
  T r0[8], r1[8];
  Vec4<T>::load(s0, r0);
  Vec4<T>::load(s1, r1);
#pragma unroll
  for (int g = 0; g < full; g += 4) {
    Vec4<T>::load(s0 + g + 4, r0 + 4);
    Vec4<T>::load(s1 + g + 4, r1 + 4);
#pragma unroll
    for (int q = 0; q < kQR; ++q) {
      const int y = i - q;
      if (CHECK && (y < 0 || y >= H)) continue;
      T wv[4];
      Vec4<T>::load(ws + y * WP + g, wv);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[0][q][j] = madd(wv[kk], r0[j + kk], acc[0][q][j]);
          acc[1][q][j] = madd(wv[kk], r1[j + kk], acc[1][q][j]);
        }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      r0[j] = r0[j + 4];
      r1[j] = r1[j + 4];
    }
  }
  // the last rem taps one at a time: no padding tap meets a sample
  Vec4<T>::load(s0 + full + 4, r0 + 4);
  Vec4<T>::load(s1 + full + 4, r1 + 4);
#pragma unroll
  for (int q = 0; q < kQR; ++q) {
    const int y = i - q;
    if (CHECK && (y < 0 || y >= H)) continue;
    T wv[4];
    Vec4<T>::load(ws + y * WP + full, wv);
#pragma unroll
    for (int kk = 0; kk < 3; ++kk) {
      if (kk < rem) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[0][q][j] = madd(wv[kk], r0[j + kk], acc[0][q][j]);
          acc[1][q][j] = madd(wv[kk], r1[j + kk], acc[1][q][j]);
        }
      }
    }
  }
}

// A thread's kQR x 4 outputs at (r, c) of an (Ro, Co) plane, masked to the
// ragged edge; one 16-byte store a row where the row's 4 outputs are whole
// and aligned.
template <typename T>
__device__ __forceinline__ void store4x4(T* __restrict__ plane, int Ro,
                                         int Co, int r, int c,
                                         const T acc[kQR][4]) {
#pragma unroll
  for (int q = 0; q < kQR; ++q) {
    if (r + q >= Ro || c >= Co) return;
    T* __restrict__ p = plane + static_cast<long long>(r + q) * Co + c;
    if (c + 4 <= Co && reinterpret_cast<uintptr_t>(p) % 16 == 0) {
      Vec4<T>::store(p, acc[q]);
      continue;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c + j < Co) p[j] = acc[q][j];
  }
}

// WC: the stencil's width when it is a compile-time instance, else 0.
template <typename T, int WC>
__global__ void __launch_bounds__(kThreadsD)
corr2d_valid_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    T* __restrict__ out, int R, int C, int Ro, int Co, int K,
                    int H, int Wrt, int mode, int tiles_r, int tiles_c) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = WC > 0 ? WC : Wrt;
  const int SR = kDR + H - 1, SW = stage_cols(W), WP = pad4(W);
  T* xs = reinterpret_cast<T*>(smem);        // SR x SW staged samples
  T* ws = xs + SR * SW;                      // H x WP taps of one stencil
  const long long id = blockIdx.x;
  const long long rest = id / tiles_c;
  const long long b = rest / tiles_r;
  const int r0 = static_cast<int>(rest % tiles_r) * kDR;
  const int c0 = static_cast<int>(id % tiles_c) * kDC;
  const int oy = mode == sgt2d::kValid ? 0 : (H - 1) / 2;
  const int ox = mode == sgt2d::kValid ? 0 : (W - 1) / 2;
  stage(x + b * R * C, R, C, r0 - oy, c0 - ox, SR, SW, mode, xs);

  const int cb = (threadIdx.x % kColThreads) * 4;
  const int rb = (threadIdx.x / kColThreads) * kQR;
  const T* __restrict__ srow = xs + rb * SW + cb;
  const int head = min(kQR - 1, H + kQR - 1);   // staged rows that test y
  const int tail = max(kQR - 1, H);
  for (int k = 0; k < K; ++k) {
    if (k > 0) __syncthreads();              // all done with stencil k - 1
    const T* __restrict__ wk = w + static_cast<long long>(k) * H * W;
    for (int e = threadIdx.x; e < H * WP; e += kThreadsD) {
      const int y = e / WP, xx = e - y * WP;
      ws[e] = xx < W ? wk[y * W + xx] : T(0);
    }
    __syncthreads();                         // also publishes the tile

    T acc[2][kQR][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int q = 0; q < kQR; ++q)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[h][q][j] = T(0);
#pragma unroll 1
    for (int i = 0; i < head; ++i)
      row_step<true, WC>(srow + i * SW, ws, i, H, W, WP, acc);
#pragma unroll 1
    for (int i = kQR - 1; i < H; ++i)
      row_step<false, WC>(srow + i * SW, ws, i, H, W, WP, acc);
#pragma unroll 1
    for (int i = tail; i < H + kQR - 1; ++i)
      row_step<true, WC>(srow + i * SW, ws, i, H, W, WP, acc);
    T* plane = out + (b * K + k) * static_cast<long long>(Ro) * Co;
    store4x4(plane, Ro, Co, r0 + rb, c0 + cb, acc[0]);
    store4x4(plane, Ro, Co, r0 + rb, c0 + cb + kHalf, acc[1]);
  }
}

template <typename T, int WC>
cudaError_t run(const T* x, const T* w, T* out, long long B, int R, int C,
                int Ro, int Co, int K, int H, int W, int mode,
                cudaStream_t s) {
  const int tiles_r = (Ro + kDR - 1) / kDR, tiles_c = (Co + kDC - 1) / kDC;
  const long long blocks = B * tiles_r * tiles_c;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const size_t smem =
      sizeof(T) * ((kDR + H - 1) * stage_cols(W) + H * pad4(W));
  cudaError_t err = sgt2d::allow_smem(corr2d_valid_kernel<T, WC>, smem);
  if (err != cudaSuccess) return err;
  corr2d_valid_kernel<T, WC><<<dim3(static_cast<unsigned>(blocks)),
                               kThreadsD, smem, s>>>(
      x, w, out, R, C, Ro, Co, K, H, W, mode, tiles_r, tiles_c);
  return cudaGetLastError();
}

template <typename T>
int launch(const T* x, const T* w, T* out, long long B, long long R,
           long long C, long long K, long long H, long long W, int mode,
           void* stream) {
  int Ro, Co, tiles_r, tiles_c;
  dim3 grid;
  if (K < 1 || K > 0x7fffffffLL) return cudaErrorInvalidValue;
  // the 2D kernels' checks and output size; this kernel's own tiles
  cudaError_t err = sgt2d::grid_2d(B, R, C, H, W, mode, &Ro, &Co, &tiles_r,
                                   &tiles_c, &grid);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int r = static_cast<int>(R), c = static_cast<int>(C);
  const int k = static_cast<int>(K), h = static_cast<int>(H);
  const int wd = static_cast<int>(W);
  switch (wd) {
    case 3: return run<T, 3>(x, w, out, B, r, c, Ro, Co, k, h, wd, mode, s);
    case 5: return run<T, 5>(x, w, out, B, r, c, Ro, Co, k, h, wd, mode, s);
    case 7: return run<T, 7>(x, w, out, B, r, c, Ro, Co, k, h, wd, mode, s);
    case 9: return run<T, 9>(x, w, out, B, r, c, Ro, Co, k, h, wd, mode, s);
    case 11: return run<T, 11>(x, w, out, B, r, c, Ro, Co, k, h, wd, mode, s);
    case 13: return run<T, 13>(x, w, out, B, r, c, Ro, Co, k, h, wd, mode, s);
    case 15: return run<T, 15>(x, w, out, B, r, c, Ro, Co, k, h, wd, mode, s);
    case 17: return run<T, 17>(x, w, out, B, r, c, Ro, Co, k, h, wd, mode, s);
    default: return run<T, 0>(x, w, out, B, r, c, Ro, Co, k, h, wd, mode, s);
  }
}

}  // namespace

extern "C" int corr2d_valid_f32(const float* x, const float* w, float* out,
                                long long B, long long R, long long C,
                                long long K, long long H, long long W,
                                int mode, void* stream) {
  return launch(x, w, out, B, R, C, K, H, W, mode, stream);
}

extern "C" int corr2d_valid_f64(const double* x, const double* w,
                                double* out, long long B, long long R,
                                long long C, long long K, long long H,
                                long long W, int mode, void* stream) {
  return launch(x, w, out, B, R, C, K, H, W, mode, stream);
}
